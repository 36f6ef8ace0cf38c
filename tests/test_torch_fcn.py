"""FCN-8s on VGG16 as ``chip_smoke.py`` builds it (``fcn8s_symbol``,
after MXNet's ``get_fcn8s_symbol``), held to ``mxtpu`` on the CPU at a
sixteenth of its width.

Both packages build the symbol from the same function: the same
arguments, the same inferred shapes at 64x64 and at the published
500x500 (where each Crop's window lies inside its map); the three
upsampling weights start with the Bilinear initializer's kernel from each
class to itself, as the source starts them. From the same weights
and the same image, the first forward and backward agree: the per-pixel
softmax and every weight's gradient within ``TOL`` of each tensor's
largest value (the dropout layers at p=0: the packages draw their masks
from different generators). The synthetic data has the structure the
card's run learns from, and the FLOPs counted from the layers' shapes
are the sum of the layers' own.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-4
DIV = 16


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", str(ROOT / "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


@pytest.mark.parametrize("hw", [cs.FCN_CHECK_HW, cs.FCN_HW])
def test_symbol_and_shapes_match(hw):
    syms = {pkg: cs.fcn8s_symbol(pkg, width_div=DIV) for pkg in (mt, mx)}
    assert syms[mt].list_arguments() == syms[mx].list_arguments()
    shapes = {pkg: s.infer_shape(data=(1, 3, hw, hw))
              for pkg, s in syms.items()}
    assert shapes[mt][0] == shapes[mx][0]
    assert shapes[mt][1] == shapes[mx][1] == [(1, cs.FCN_CLASSES, hw, hw)]
    text = cs.fcn8s_crop_check(syms[mt], hw)
    assert text.count(" at ") == 3


def test_full_width_layers_and_flops():
    """The published widths: 134,489,759 weights, fc6 a 7x7x512x4096
    convolution, the crops inside their maps at 500x500; the step's FLOPs
    three passes of the layers' multiply-adds (two for conv1_1)."""
    sym = cs.fcn8s_symbol(mt)
    args, _, _ = sym.infer_shape(data=(1, 3, 500, 500))
    n = sum(int(np.prod(s)) for s, name in zip(args, sym.list_arguments())
            if name not in ("data", "softmax_label"))
    assert n == 134489759
    layers = cs.fcn8s_layers(sym, cs.FCN_HW)
    by = {l[0]: l for l in layers}
    assert by["fc6"][3] == (4096, 512, 7, 7)
    assert by["bigscore"][3] == (21, 21, 16, 16)
    fwd, step = cs.fcn8s_flops(layers)
    macs = {l[0]: (np.prod(l[4]) * np.prod(l[3][1:]) if l[1] == "Convolution"
                   else np.prod(l[2]) * np.prod(l[3][1:])) for l in layers}
    assert fwd == 2 * sum(macs.values())
    assert step == 3 * fwd - 2 * macs["conv1_1"]
    cs.fcn8s_crop_check(sym, cs.FCN_HW)


def test_upsampling_weights_are_bilinear_by_class():
    """The upsampling weights start with Bilinear's kernel from each class
    to itself (mxtpu's Bilinear gives each channel pair that kernel) and
    zeros between classes."""
    args = cs.fcn8s_init(mt, cs.fcn8s_symbol(mt, width_div=DIV),
                         cs.FCN_CHECK_HW, 0)
    for k in cs.FCN_UPSAMPLE:
        w = args[k]
        full = mx.nd.zeros(w.shape)
        mx.init.Bilinear()(mx.init.InitDesc(k), full)
        eye = np.eye(w.shape[0], dtype=bool)[:, :, None, None]
        np.testing.assert_allclose(w, np.where(eye, full.asnumpy(), 0),
                                   rtol=0, atol=1e-7)


def test_first_forward_backward_matches_mxtpu():
    x, y = cs.fcn8s_data(1, cs.FCN_CHECK_HW, 3)
    sym_t = cs.fcn8s_symbol(mt, width_div=DIV, dropout=0.0)
    args = cs.fcn8s_init(mt, sym_t, cs.FCN_CHECK_HW, 0)
    got = {}
    for pkg, sym in ((mt, sym_t),
                     (mx, cs.fcn8s_symbol(mx, width_div=DIV, dropout=0.0))):
        ex = sym.simple_bind(pkg.cpu(), data=x.shape, softmax_label=y.shape)
        for k, v in ex.arg_dict.items():
            v[:] = {"data": x, "softmax_label": y}.get(k, args.get(k))
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        got[pkg] = dict({k: g.asnumpy() for k, g in ex.grad_dict.items()
                         if g is not None and k in args}, softmax=out)
    assert sorted(got[mt]) == sorted(got[mx])
    for k, want in got[mx].items():
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got[mt][k] - want).max()) / scale
        assert err <= TOL, (k, err)


def test_synthetic_data():
    x, y = cs.fcn8s_data(4, 96, 0)
    assert x.shape == (4, 3, 96, 96) and y.shape == (4, 96, 96)
    labels = set(np.unique(y).tolist())
    assert 0 in labels and cs.FCN_IGNORE in labels and len(labels) >= 3
    # a shape's pixels take its class's colour: within a class, close
    palette = {}
    for i in range(4):
        for c in set(np.unique(y[i]).tolist()) - {0, cs.FCN_IGNORE}:
            mean = x[i][:, y[i] == c].mean(axis=1)
            if c in palette:
                np.testing.assert_allclose(mean, palette[c], atol=0.05)
            palette[c] = mean
    np.testing.assert_array_equal(cs.fcn8s_data(4, 96, 0)[1], y)
