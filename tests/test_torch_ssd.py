"""SSD (BASELINE.json config 5) on the CPU, the port against mxtpu:
``chip_smoke.py``'s ``ssd_toy_main`` (example/ssd/train_ssd_toy.py's main,
line for line) and ``ssd300_vgg16`` (SSD-300 on VGG16-reduced, MXNet SSD's
published config) with its loss (``ssd_targets`` + ``ssd_loss``), built in
either package from the same weights (the port's Xavier draws, carried to
mxtpu by ``gluon_load``).

Tolerances: the toy's per-step (class, box) losses of its first 3 steps
within TOY_STEP_TOL (float32 sums in other orders; Adam moves a weight by
about lr whatever its gradient's size, so the losses, not the weights, are
held), its 4 epochs' losses within 1% (EPOCH_RTOL). SSD-300 at 1/8 width:
the forward's outputs within FWD_TOL of the largest, the targets' classes
exactly, the two losses within LOSS_TOL, and after one SGD step each
weight within STEP_SHARE of its parameter's step plus ATOL (the
networks' float32 gradients jump where a ReLU's input lies within
rounding of 0, as in tests/test_torch_resnet.py).
"""
import importlib.util
import pathlib

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOY_STEP_TOL = dict(rtol=1e-4, atol=1e-6)
EPOCH_RTOL = 0.01
FWD_TOL = 1e-4
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
STEP_SHARE, ATOL = 0.5, 1e-6
WIDTH_DIV, BATCH = 8, 2


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", str(ROOT / "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the toy ------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy_runs(smoke):
    num_anchors = len(smoke.SSD_TOY_SIZES) + len(smoke.SSD_TOY_RATIOS) - 1
    w0 = smoke.gluon_weights(mt, smoke.toy_ssd(mt, num_anchors), 0,
                             smoke.toy_sample(), init=mt.init.Xavier())
    return {pkg.__name__: smoke.ssd_toy_main(pkg, pkg.cpu(), w0)
            for pkg in (mt, mx)}, w0


def test_toy_first_steps_match_mxtpu(toy_runs):
    runs, _ = toy_runs
    got = runs["mxtpu_torch"]["steps"][:3]
    want = runs["mxtpu"]["steps"][:3]
    np.testing.assert_allclose(got, want, **TOY_STEP_TOL)


def test_toy_epochs_match_mxtpu_and_learn(toy_runs):
    runs, _ = toy_runs
    got, want = runs["mxtpu_torch"]["epochs"], runs["mxtpu"]["epochs"]
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, rtol=EPOCH_RTOL)
    assert got[-1][0] < got[0][0] and got[-1][1] < got[0][1]


def test_toy_decode_matches_mxtpu(toy_runs):
    """The decoded image: 320 rows of (class, score, box), the same rows
    kept, scores and boxes within 1% (the weights after 16 Adam steps)."""
    runs, _ = toy_runs
    got, want = runs["mxtpu_torch"]["det"], runs["mxtpu"]["det"]
    assert got.shape == want.shape == (1, 320, 6)
    assert np.isfinite(got).all()
    top = got[0, 0]
    assert top[0] == 0 and top[1] > 0.5
    np.testing.assert_allclose(got[0, :5], want[0, :5], rtol=EPOCH_RTOL,
                               atol=1e-3)


def test_toy_weights_cross_packages(smoke, toy_runs):
    """ToySSD built in mxtpu and given the port's weights (BatchNorm's
    moving statistics too) predicts as the port does."""
    _, w0 = toy_runs
    x = smoke.toy_sample()
    outs = {}
    for pkg in (mt, mx):
        net = smoke.toy_ssd(pkg, 5)
        net.initialize(pkg.init.Xavier(), ctx=pkg.cpu())
        net(pkg.nd.array(x, ctx=pkg.cpu()))
        smoke.gluon_load(pkg, net, w0, pkg.cpu())
        assert sorted(net.collect_params().keys()) == sorted(w0)
        outs[pkg.__name__] = [o.asnumpy() for o in net(
            pkg.nd.array(x, ctx=pkg.cpu()))]
    for g, w in zip(outs["mxtpu_torch"], outs["mxtpu"]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


# -- SSD-300 ------------------------------------------------------------------

def test_ssd300_shapes_follow_the_published_config(smoke):
    assert smoke.ssd300_feature_hw(300) == [38, 19, 10, 5, 3, 1]
    for pkg in (mt, mx):
        anchors = smoke.ssd300_anchors(pkg, pkg.cpu())
        assert anchors.shape == (1, 8732, 4)
    np.testing.assert_allclose(
        smoke.ssd300_anchors(mt, mt.cpu()).asnumpy(),
        smoke.ssd300_anchors(mx, mx.cpu()).asnumpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def ssd300(smoke):
    """SSD-300 at 1/8 width from the port's Xavier(gaussian, out, 2) draws
    at 300x300, and a batch of two records' images and labels."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-2, 2, (BATCH, 3, 300, 300)).astype(np.float32)
    label = np.full((BATCH, 3, 5), -1.0, np.float32)
    label[0, :2] = [[3, 0.1, 0.2, 0.5, 0.6], [17, 0.55, 0.5, 0.95, 0.8]]
    label[1, :1] = [[0, 0.3, 0.3, 0.45, 0.5]]
    net = smoke.ssd300_vgg16(mt, width_div=WIDTH_DIV)
    w0 = smoke.gluon_weights(mt, net, 0, x[:1], init=smoke.ssd300_xavier(mt))
    assert w0["ssd300_relu4_3_scale"].shape == (1, 64, 1, 1)
    assert (w0["ssd300_relu4_3_scale"] == 20).all()
    return w0, x, label


def _ssd300_step(smoke, pkg, w0, x, label, hybridize=False):
    """Forward, targets, loss, backward and one SGD step (SSD_OPT) in
    ``pkg`` on the CPU. Returns (class preds, box preds, cls_target, the
    two losses, the weights after the step, the net)."""
    cpu = pkg.cpu()
    with cpu:
        net = smoke.gluon_load(pkg, smoke.ssd300_vgg16(pkg,
                                                       width_div=WIDTH_DIV),
                               w0, cpu)
        if hybridize:
            net.hybridize()
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    dict(smoke.SSD_OPT))
        anchors = smoke.ssd300_anchors(pkg, cpu)
        xs, ys = pkg.nd.array(x, ctx=cpu), pkg.nd.array(label, ctx=cpu)
        with pkg.autograd.record():
            cls_preds, box_preds = net(xs)
            targets = smoke.ssd_targets(pkg, anchors, ys, cls_preds)
            lc, lb = smoke.ssd_loss(pkg, cls_preds, box_preds, targets)
            loss = lc + lb
        loss.backward()
        trainer.step(1)
        return (cls_preds.asnumpy(), box_preds.asnumpy(),
                targets[2].asnumpy(), (float(lc.asscalar()),
                                       float(lb.asscalar())),
                smoke.gluon_values(net), net)


@pytest.fixture(scope="module")
def ssd300_steps(smoke, ssd300):
    w0, x, label = ssd300
    return {pkg.__name__: _ssd300_step(smoke, pkg, w0, x, label)
            for pkg in (mt, mx)}


def test_ssd300_forward_and_targets_match_mxtpu(ssd300_steps):
    got, want = ssd300_steps["mxtpu_torch"], ssd300_steps["mxtpu"]
    assert got[0].shape == (BATCH, 21, 8732)
    assert got[1].shape == (BATCH, 8732 * 4)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=FWD_TOL,
                                   atol=FWD_TOL * np.abs(w).max())
    np.testing.assert_array_equal(got[2], want[2])
    assert (got[2] > 0).sum() >= 3 and (got[2] == 0).sum() > 0


def test_ssd300_loss_and_sgd_step_match_mxtpu(smoke, ssd300, ssd300_steps):
    w0 = ssd300[0]
    got, want = ssd300_steps["mxtpu_torch"], ssd300_steps["mxtpu"]
    np.testing.assert_allclose(got[3], want[3], **LOSS_TOL)
    assert all(np.isfinite(got[3])) and got[3][0] > 1.0
    for k in sorted(w0):
        step = float(np.abs(want[4][k] - w0[k]).max())
        diff = float(np.abs(got[4][k] - want[4][k]).max())
        assert diff <= STEP_SHARE * step + ATOL, (k, diff, step)
    assert not np.array_equal(got[4]["ssd300_relu4_3_scale"],
                              w0["ssd300_relu4_3_scale"])


def test_ssd300_hybridized_step_matches_eager(smoke, ssd300, ssd300_steps):
    """The port's hybridized block (one traced program) gives the eager
    block's outputs, losses and step."""
    w0, x, label = ssd300
    got = _ssd300_step(smoke, mt, w0, x, label, hybridize=True)
    want = ssd300_steps["mxtpu_torch"]
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    for k in w0:
        np.testing.assert_allclose(got[4][k], want[4][k], rtol=0,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("model", ["toy", "ssd300"])
def test_mxtpu_built_nets_load_into_the_port(smoke, ssd300, ssd300_steps,
                                             model):
    """ToySSD (initialized by mxtpu's own Xavier draws) and SSD-300 (as
    mxtpu's SGD step left it, the L2Normalization scale included) load
    into the port through ParameterDict.load_dict, mxtpu's arrays as they
    are, and the port's block then gives mxtpu's outputs."""
    if model == "toy":
        x = smoke.toy_sample()
        mx_net = smoke.toy_ssd(mx, 5)
        smoke.gluon_weights(mx, mx_net, 3, x, init=mx.init.Xavier())
        mt_net = smoke.toy_ssd(mt, 5)
    else:
        x = ssd300[1]
        mx_net = ssd300_steps["mxtpu"][5]
        mt_net = smoke.ssd300_vgg16(mt, width_div=WIDTH_DIV)
    mt_net.collect_params().load_dict(
        {k: v.data() for k, v in mx_net.collect_params().items()},
        ctx=mt.cpu())
    with mt.cpu():
        got = [o.asnumpy() for o in mt_net(mt.nd.array(x, ctx=mt.cpu()))]
    want = [o.asnumpy() for o in mx_net(mx.nd.array(x))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=FWD_TOL,
                                   atol=FWD_TOL * np.abs(w).max())
