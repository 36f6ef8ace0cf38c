"""Gluon ResNet-18 v1 (BASELINE.json config 3) on the CPU, the port
against mxtpu: ``chip_smoke.py``'s ``gluon_resnet_run`` (example/gluon/
mnist.py's loop: ``autograd.record``, ``backward``, ``Trainer.step`` with
fit.py's SGD, over a DataLoader of an ArrayDataset) in either package from
the same weights (the port's Xavier draws, handed to mxtpu as arrays).

- A thumbnail ResNet-18 v1 (3x32x32, batch 4, 10 classes) and one with
  the ImageNet stem (7x7 convolution and max pool, at 64 px, batch 2):
  one Trainer step, the port eager and hybridized against mxtpu.
- The port's hybridized steps against its eager ones.
- ``save_params`` files cross both ways.

Tolerances, as tests/test_torch_resnet.py: these networks' float32
gradients jump where a ReLU's input lies within rounding of 0, so after a
step each weight is held to STEP_SHARE of the largest distance a weight of
its parameter moved, plus ATOL; the moving statistics come from the
forward alone: AUX_TOL of 1 + |value|; the step's loss: LOSS_TOL. The
port's hybridized steps evaluate the same ops on the same inputs as its
eager ones: HYB_TOL.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
STEP_SHARE = 0.5
ATOL = 1e-5
AUX_TOL = 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
HYB_TOL = dict(rtol=0, atol=1e-6)
NETS = {
    # name: (image shape, batch, thumbnail)
    "thumbnail": ((3, 32, 32), 4, True),
    "imagenet_stem": ((3, 64, 64), 2, False),
}


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", str(ROOT / "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def setup(smoke, net):
    shape, batch, thumb = NETS[net]
    data = smoke.gluon_images(0, batch, shape, 10)
    w0 = smoke.gluon_weights(mt, smoke.gluon_resnet18(mt, 10, thumb), 0,
                             data[0][:1])
    return data, w0, batch, thumb


def run(smoke, pkg, w0, data, batch, thumb, hybridize, steps=1):
    with pkg.cpu():
        r = smoke.gluon_resnet_run(pkg, w0, data, pkg.cpu(), batch,
                                   hybridize, steps, classes=10,
                                   thumbnail=thumb)
        return smoke.gluon_values(r.net), r.loss_values(), r


@pytest.fixture(scope="module")
def mxtpu_steps(smoke):
    """mxtpu's one step of each net (computed once: mxtpu's eager CPU step
    is the slow part of this file)."""
    out = {}
    for net in NETS:
        data, w0, batch, thumb = setup(smoke, net)
        out[net] = run(smoke, mx, w0, data, batch, thumb, False)[:2]
    return out


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("net", sorted(NETS))
def test_one_trainer_step_matches_mxtpu(smoke, mxtpu_steps, net,
                                        hybridize):
    data, w0, batch, thumb = setup(smoke, net)
    got, g_loss, r = run(smoke, mt, w0, data, batch, thumb, hybridize)
    want, w_loss = mxtpu_steps[net]
    assert sorted(got) == sorted(want) == sorted(w0)
    aux = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(aux) == 2 * sum(k.endswith("gamma") for k in want) > 0
    for k in sorted(want):
        if k in aux:
            np.testing.assert_allclose(got[k], want[k], rtol=AUX_TOL,
                                       atol=AUX_TOL, err_msg=k)
            continue
        step = float(np.abs(want[k] - w0[k]).max())
        diff = float(np.abs(got[k] - want[k]).max())
        assert diff <= STEP_SHARE * step + ATOL, (k, diff, step)
    np.testing.assert_allclose(g_loss, w_loss, **LOSS_TOL)
    if hybridize:
        assert r.net.cache_stats() == {"programs": 1, "compiles": 1,
                                       "hits": 0, "captures": 0,
                                       "replays": 0, "uncaptured": 0,
                                       "fallbacks": 0}


def test_hybridized_steps_equal_eager_steps(smoke):
    """Three steps: the hybridized program (one compile, then hits) gives
    the eager steps' weights, moving statistics and losses."""
    data, w0, batch, thumb = setup(smoke, "thumbnail")
    data = smoke.gluon_images(1, 3 * batch, (3, 32, 32), 10)
    hyb = run(smoke, mt, w0, data, batch, thumb, True, steps=3)
    eager = run(smoke, mt, w0, data, batch, thumb, False, steps=3)
    for k in sorted(eager[0]):
        np.testing.assert_allclose(hyb[0][k], eager[0][k], err_msg=k,
                                   **HYB_TOL)
    np.testing.assert_allclose(hyb[1], eager[1], **HYB_TOL)
    stats = hyb[2].net.cache_stats()
    assert (stats["programs"], stats["compiles"], stats["hits"]) == (1, 1, 2)


def test_save_params_cross_both_ways(smoke, tmp_path):
    data, w0, batch, thumb = setup(smoke, "thumbnail")
    x = data[0]
    mfile, tfile = str(tmp_path / "m.params"), str(tmp_path / "t.params")
    m = smoke.gluon_load(mx, smoke.gluon_resnet18(mx, 10, thumb), w0,
                         mx.cpu())
    y_m = m(mx.nd.array(x)).asnumpy()
    m.save_params(mfile)
    with mt.cpu():
        t = smoke.gluon_resnet18(mt, 10, thumb)
        t.load_params(mfile, ctx=mt.cpu())
        np.testing.assert_allclose(t(mt.nd.array(x)).asnumpy(), y_m,
                                   rtol=1e-5, atol=1e-5)
        t.collect_params()[smoke.GL_PREFIX + "dense0_bias"].set_data(
            mt.nd.ones((10,)))
        y_t = t(mt.nd.array(x)).asnumpy()
        t.save_params(tfile)
    m2 = smoke.gluon_resnet18(mx, 10, thumb)
    m2.load_params(tfile)
    np.testing.assert_allclose(m2(mx.nd.array(x)).asnumpy(), y_t,
                               rtol=1e-5, atol=1e-5)
