"""The port's initializers of ROADMAP A4 against mxtpu's, on the CPU, and
chip_smoke.py's mirror of fit.py's --initializer table and metric list.

The deterministic rules are held by value (LSTMBias, Load, Mixed's
dispatch, MSRAPrelu's parameters and scale); the drawn ones by their
properties, since the two packages draw from different generators:
Orthogonal's rows (or columns) orthonormal within 1e-5 after its scale,
MSRAPrelu's sample deviation within 5 standard errors of its formula in
both packages.
"""
import argparse
import importlib.util
import pathlib

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke", ROOT / "chip_smoke.py")


def _draw(pkg, init, name, shape):
    arr = pkg.nd.zeros(shape, ctx=pkg.cpu())
    init(pkg.init.InitDesc(name) if hasattr(pkg.init, "InitDesc") else name,
         arr)
    return arr.asnumpy()


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(6, 10), (10, 6), (8, 3, 2, 2)])
def test_orthogonal_is_orthonormal_after_its_scale(rand_type, shape):
    """q = w / scale: q q^T = I for rows <= columns, q^T q = I else,
    within 1e-5, in both packages."""
    for pkg in (mt, mx):
        mt.random.seed(0)
        w = _draw(pkg, pkg.init.Orthogonal(scale=1.7, rand_type=rand_type),
                  "fc_weight", shape)
        q = w.reshape(shape[0], -1) / 1.7
        gram = q @ q.T if q.shape[0] <= q.shape[1] else q.T @ q
        np.testing.assert_allclose(gram, np.eye(gram.shape[0]), atol=1e-5)


def test_msra_prelu_scale_and_parameters():
    """MSRAPrelu is Xavier(gaussian, factor_type, 2 / (1 + slope^2)): the
    same dumps() and magnitude in both packages, and draws whose deviation
    lies within 5 standard errors of the formula's (fit.py's table)."""
    for slope, factor in ((0.25, "avg"), (0.0, "in")):
        got = mt.init.MSRAPrelu(factor_type=factor, slope=slope)
        want = mx.init.MSRAPrelu(factor_type=factor, slope=slope)
        assert got.dumps() == want.dumps()
        assert (got.rnd_type, got.factor_type, got.magnitude) == \
            (want.rnd_type, want.factor_type, want.magnitude)
    shape = (64, 32, 3, 3)
    for pkg in (mt, mx):
        mt.random.seed(1)
        w = _draw(pkg, pkg.init.MSRAPrelu(), "conv_weight", shape)
        n, worst = cs.msra_scale_check({"conv_weight": w})
        assert n == 1 and worst <= cs.FF_SCALE_SE


def test_lstm_bias_by_value():
    """Through a variable's __init__ attribute, as a symbol gives it."""
    for pkg in (mt, mx):
        init = pkg.init.LSTMBias(forget_bias=2.5)
        desc = pkg.init.InitDesc("lstm_i2h_bias",
                                 {"__init__": init.dumps()})
        b = pkg.nd.zeros((12,), ctx=pkg.cpu())
        pkg.init.Uniform()(desc, b)
        np.testing.assert_array_equal(b.asnumpy(),
                                      [0] * 3 + [2.5] * 3 + [0] * 6)


def test_load_and_mixed_by_value():
    """Load takes arg:/aux: keys without their prefix and falls back to
    its default initializer; Mixed picks the first matching pattern;
    both raise where mxtpu raises."""
    rng = np.random.RandomState(0)
    src = {"arg:fc_weight": rng.standard_normal((3, 4)).astype(np.float32),
           "aux:bn_moving_mean": np.arange(4, dtype=np.float32)}
    out = {}
    for pkg in (mt, mx):
        load = pkg.init.Load({k: pkg.nd.array(v, ctx=pkg.cpu())
                              for k, v in src.items()},
                             default_init=pkg.init.Constant(0.5))
        got = {n: _draw(pkg, load, n, s) for n, s in (
            ("fc_weight", (3, 4)), ("bn_moving_mean", (4,)),
            ("fc_bias", (3,)))}
        with pytest.raises(ValueError):
            _draw(pkg, load, "fc_weight", (4, 3))
        with pytest.raises(ValueError):
            _draw(pkg, pkg.init.Load({}), "w", (2,))
        mixed = pkg.init.Mixed([".*bias", ".*"],
                               [pkg.init.One(), pkg.init.Constant(3.0)])
        got["mixed bias"] = _draw(pkg, mixed, "fc_bias", (2,))
        got["mixed weight"] = _draw(pkg, mixed, "fc_weight", (2, 2))
        with pytest.raises(ValueError):
            _draw(pkg, pkg.init.Mixed(["a.*"], [pkg.init.One()]), "b", (1,))
        out[pkg.__name__] = got
    for k, v in out["mxtpu"].items():
        np.testing.assert_array_equal(out["mxtpu_torch"][k], v, err_msg=k)
    # the default initializer's bias rule (zero), not its weight value
    np.testing.assert_array_equal(out["mxtpu_torch"]["fc_bias"], [0.0] * 3)
    np.testing.assert_array_equal(out["mxtpu_torch"]["fc_weight"],
                                  src["arg:fc_weight"])


def _fit_module():
    spec = importlib.util.spec_from_file_location(
        "fit", str(ROOT / "example/image-classification/common/fit.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["default", "xavier", "msra", "orthogonal",
                                  "normal", "uniform", "one", "zero"])
def test_fit_initializer_table_mirrors_fit_py(name):
    """chip_smoke.fit_initializer against fit.py's own
    _select_initializer: the same class and dumps() for every name of its
    table (any name raised AttributeError in the port before A4)."""
    fit = _fit_module()
    want = fit._select_initializer(argparse.Namespace(initializer=name,
                                                      network="resnet"))
    got = cs.fit_initializer(mt, name, "resnet")
    assert type(got).__name__ == type(want).__name__
    assert got.dumps() == want.dumps()


@pytest.mark.parametrize("top_k,loss", [(0, ""), (5, "ce,nll"),
                                        (3, "nll, bogus")])
def test_fit_metrics_mirror_fit_py(top_k, loss):
    fit = _fit_module()
    want = fit._eval_metrics(argparse.Namespace(top_k=top_k, loss=loss))
    got = cs.fit_metrics(mt, top_k, loss)
    assert [m.get_config() for m in got] == [m.get_config() for m in want]
