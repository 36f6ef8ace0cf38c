"""``chip_smoke.py``'s DeepSpeech 2 (``ds2_symbol``: two convolutions with
BatchNorm and ReLU, a bidirectional FusedRNNCell GRU stack, a per-frame
FullyConnected and ``ctc_loss``) at a small size in both packages: 2 GRU
layers of 16, 21 bins, the buckets 20 and 30 frames, batch 2, from the
same weights (``ds2_init``) and the same synthetic utterances
(``ds2_utterances`` through the mirrored bucket iterator): the loss and
every gradient of a training step against ``mxtpu``'s executor, and one
checkpoint written by the port and loaded by ``mxtpu``.

Tolerances: the loss 1e-5 relative; each gradient within 1e-5 of its
largest entry (float32 in both packages, sums in another order); the
checkpoint's arrays exactly.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
WIDTHS = dict(bins=21, hidden=16, layers=2)
BUCKETS, BATCH = (20, 30), 2


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", str(ROOT / "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _batch(pkg, bucket):
    feats, labels = cs.ds2_utterances(BATCH, bucket, bucket,
                                      bins=WIDTHS["bins"])
    it = cs.speech_iter(pkg, feats, labels, BATCH, (bucket,), WIDTHS["bins"],
                        cs.DS2_LABEL)
    b = it.next()
    return b.data[0].asnumpy(), b.label[0].asnumpy()


def _step(pkg, bucket, weights, aux, data, label):
    """A training forward and backward of the bucket's symbol: (loss,
    {name: gradient}, the symbol)."""
    sym = cs.ds2_symbol(pkg, bucket, **WIDTHS)
    ex = sym.simple_bind(ctx=pkg.cpu(), grad_req="write", data=data.shape,
                         label=label.shape)
    for k, v in weights.items():
        ex.arg_dict[k][:] = v
    for k, v in aux.items():
        ex.aux_dict[k][:] = v
    ex.arg_dict["data"][:] = data
    ex.arg_dict["label"][:] = label
    if pkg is mx:
        # mxtpu's speculated step: forward and backward in one jitted
        # program, compiled once rather than a forward and a step apart
        ex._speculate = True
    loss = ex.forward(is_train=True)[0].asnumpy()
    ex.backward()
    return float(loss.mean()), {k: g.asnumpy() for k, g in
                                ex.grad_dict.items() if k in weights}


def _weights(bucket):
    with mt.cpu():
        args, auxs = cs.ds2_shapes(mt, bucket, BATCH, **WIDTHS)
    aux = {k: (np.ones if k.endswith("var") else np.zeros)(s, np.float32)
           for k, s in auxs.items()}
    return cs.ds2_init(args, 3), aux


@pytest.mark.parametrize("bucket", BUCKETS)
def test_step_matches_mxtpu(bucket):
    """One training step of the small DeepSpeech 2 in both packages: the
    CTC loss and every weight's gradient (the GRU blob, the convolutions,
    BatchNorm's gamma and beta, the output layer)."""
    w, aux = _weights(bucket)
    with mt.cpu():
        data, label = _batch(mt, bucket)
        got, g_got = _step(mt, bucket, w, aux, data, label)
    want, g_want = _step(mx, bucket, w, aux, data, label)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert sorted(g_got) == sorted(g_want) and len(g_got) == 9
    for k, g in g_want.items():
        np.testing.assert_allclose(g_got[k], g, rtol=0, err_msg=k,
                                   atol=1e-5 * np.abs(g).max())
    assert cs.ds2_frames(bucket) == (bucket - 1) // 2 + 1


def test_checkpoint_both_packages(tmp_path):
    """A checkpoint the port writes (symbol JSON and weights) loads in
    mxtpu under the same names, and its step gives the port's loss."""
    bucket = BUCKETS[0]
    w, aux = _weights(bucket)
    with mt.cpu():
        data, label = _batch(mt, bucket)
        got, _ = _step(mt, bucket, w, aux, data, label)
        sym = cs.ds2_symbol(mt, bucket, **WIDTHS)
        mt.model.save_checkpoint(str(tmp_path / "ds2"), 1, sym,
                                 {k: mt.nd.array(v) for k, v in w.items()},
                                 {k: mt.nd.array(v) for k, v in aux.items()})
    sym_m, args_m, aux_m = mx.model.load_checkpoint(str(tmp_path / "ds2"), 1)
    assert sorted(args_m) == sorted(w) and sorted(aux_m) == sorted(aux)
    for k, v in w.items():
        np.testing.assert_array_equal(args_m[k].asnumpy(), v)
    ex = sym_m.simple_bind(ctx=mx.cpu(), grad_req="null", data=data.shape,
                           label=label.shape)
    ex.copy_params_from(args_m, aux_m)
    loss = ex.forward(is_train=True, data=mx.nd.array(data),
                      label=mx.nd.array(label))[0].asnumpy()
    np.testing.assert_allclose(float(loss.mean()), got, rtol=1e-5)
