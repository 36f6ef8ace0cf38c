"""Multi-output graphs on the CPU, the port against mxtpu: ``Group``,
``get_internals``, ``MakeLoss``, ``identity`` and ``one_hot``; the
``Group`` JSON both ways; ``chip_smoke.py``'s mirrors of
example/python-howto/multiple_outputs.py, the multitask net of
example/multi-task/multitask_mnist.py (its first Module steps) and the
R-CNN toy of example/rcnn/train_rcnn_toy.py (its first RPN steps, then
Proposal and ROIPooling on the trained outputs), in both packages from
the same weights.

Tolerances: ops against ``jax.vjp`` of mxtpu's op within OP_TOL (the same
float32 arithmetic); the multiple_outputs executor's outputs and
gradients within OP_TOL; the first steps' losses within STEP_TOL (float32
sums in other orders; Adam moves a weight by about lr whatever its
gradient's size, so the losses and not the weights are held); Proposal's
rois: the same boxes in the same order (the batch index column exactly),
their corners within OP_TOL (the decode's exp rounds by an ulp
differently in torch and XLA); ROIPooling's pooled features within
OP_TOL.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.module.fused import _fused_eligible as mx_eligible
from mxtpu.ops.registry import get_op as jax_op
from mxtpu_torch.module.fused import _fused_eligible as mt_eligible

ROOT = pathlib.Path(__file__).resolve().parent.parent
OP_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", str(ROOT / "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- Group and get_internals --------------------------------------------------

RPN_SHAPES = dict(data=(8, 1, 32, 32), rpn_cls_label=(8, 64),
                  bbox_target=(8, 4, 8, 8), bbox_weight=(8, 4, 8, 8))


def test_rpn_group_lists_and_shapes_match_mxtpu(smoke):
    """The R-CNN toy's RPN Group: outputs, arguments, aux states and
    inferred shapes as mxtpu's; get_internals() names every node's every
    output as mxtpu does, in its order, and ["feat_output"] resolves to
    the same sub-graph."""
    got, want = smoke.rcnn_rpn_symbol(mt), smoke.rcnn_rpn_symbol(mx)
    for sym_got, sym_want in ((got, want),
                              (got.get_internals(), want.get_internals()),
                              (got.get_internals()["feat_output"],
                               want.get_internals()["feat_output"])):
        assert sym_got.list_outputs() == sym_want.list_outputs()
        assert sym_got.list_arguments() == sym_want.list_arguments()
        assert sym_got.list_auxiliary_states() == \
            sym_want.list_auxiliary_states()
        shapes = {k: v for k, v in RPN_SHAPES.items()
                  if k in sym_want.list_arguments()}
        assert sym_got.infer_shape(**shapes) == \
            tuple(sym_want.infer_shape(**shapes))
    assert got.list_outputs() == ["rpn_cls_output", "rpn_bbox_loss_output",
                                  "blockgrad0_output"]
    assert len(got) == 3


@pytest.mark.parametrize("src,dst", [(mx, mt), (mt, mx)],
                         ids=["mxtpu-to-port", "port-to-mxtpu"])
def test_group_json_loads_both_ways(smoke, src, dst):
    """A Group saved as JSON by either package loads in the other with
    the same outputs, arguments and shapes, and the loaded port graph
    evaluates as the original."""
    sym = smoke.rcnn_rpn_symbol(src)
    loaded = dst.sym.load_json(sym.tojson())
    assert loaded.list_outputs() == sym.list_outputs()
    assert loaded.list_arguments() == sym.list_arguments()
    assert tuple(loaded.infer_shape(**RPN_SHAPES)) == \
        tuple(sym.infer_shape(**RPN_SHAPES))


# -- MakeLoss, identity, one_hot ---------------------------------------------

MAKE_LOSS_CASES = [dict(), dict(grad_scale=2.5),
                   dict(normalization="batch"),
                   dict(normalization="batch", grad_scale=0.5),
                   dict(normalization="valid", valid_thresh=0.3)]


@pytest.mark.parametrize("kw", MAKE_LOSS_CASES,
                         ids=lambda kw: ",".join("%s=%s" % i
                                                 for i in kw.items()) or "default")
def test_make_loss_matches_mxtpu_vjp(kw):
    """MakeLoss as mxtpu defines it: the identity forward, the backward
    grad_scale everywhere (over the batch under normalization="batch"),
    whatever the head gradient; valid_thresh and "valid" change nothing."""
    rng = np.random.RandomState(0)
    x = rng.randn(4, 3, 2).astype(np.float32)
    head = rng.randn(4, 3, 2).astype(np.float32)
    out, vjp = jax.vjp(lambda v: jax_op("MakeLoss").fn(v, **kw),
                       jnp.asarray(x))
    (want,) = vjp(jnp.asarray(head))
    with mt.cpu():
        a = mt.nd.array(x)
        a.attach_grad()
        with mt.autograd.record():
            y = mt.nd.MakeLoss(a, **kw)
        y.backward(mt.nd.array(head))
    np.testing.assert_allclose(y.asnumpy(), np.asarray(out), **OP_TOL)
    np.testing.assert_allclose(a.grad.asnumpy(), np.asarray(want), **OP_TOL)


@pytest.mark.parametrize("name", ["identity", "_copy", "copy"])
def test_identity_matches_mxtpu(name):
    """identity and its aliases: the value, a copy (the input's later
    change does not show), and the head gradient passed through."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    head = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    out, vjp = jax.vjp(jax_op(name).fn, jnp.asarray(x))
    with mt.cpu():
        a = mt.nd.array(x)
        a.attach_grad()
        with mt.autograd.record():
            y = getattr(mt.nd, name)(a)
        y.backward(mt.nd.array(head))
        assert y.data.data_ptr() != a.data.data_ptr()
    np.testing.assert_array_equal(y.asnumpy(), np.asarray(out))
    np.testing.assert_array_equal(a.grad.asnumpy(),
                                  np.asarray(vjp(jnp.asarray(head))[0]))


@pytest.mark.parametrize("kw", [
    dict(depth=4), dict(depth=5, on_value=2.0, off_value=-1.0),
    dict(depth=3, dtype="int32"), dict(depth=4, on_value=7, dtype="int32"),
    dict(depth=2, dtype="float16")], ids=lambda kw: "-".join(
        "%s" % v for v in kw.values()))
def test_one_hot_matches_mxtpu(kw):
    """one_hot with on/off values and dtypes; an index outside [0, depth)
    (negative, too large, fractional) gives a row of off_value, as
    jax.nn.one_hot does in mxtpu."""
    idx = np.array([[0, 1, 3], [-1, 4, 2.7]], np.float32)
    want = mx.nd.one_hot(mx.nd.array(idx), **kw).asnumpy()
    with mt.cpu():
        got = mt.nd.one_hot(mt.nd.array(idx), **kw).asnumpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_one_hot_is_not_differentiated():
    with mt.cpu():
        idx = mt.nd.array([0.0, 2.0])
        idx.attach_grad()
        with mt.autograd.record():
            y = mt.nd.one_hot(idx, depth=3) * 2
        y.backward()
        np.testing.assert_array_equal(idx.grad.asnumpy(), [0.0, 0.0])


# -- the examples ---------------------------------------------------------------

def test_multiple_outputs_matches_mxtpu(smoke):
    """multiple_outputs.py's checks in both packages, the outputs equal,
    and a backward with the implicit head gradients: ones into fc's and
    relu's outputs, nothing through BlockGrad."""
    runs = {}
    for pkg in (mt, mx):
        ex, names, outs = smoke.multiple_outputs_main(pkg, pkg.cpu())
        ex.forward(is_train=True)
        ex.backward()
        runs[pkg] = (names, outs,
                     {k: v.asnumpy() for k, v in ex.grad_dict.items()})
    assert runs[mt][0] == runs[mx][0]
    for g, w in zip(runs[mt][1], runs[mx][1]):
        np.testing.assert_allclose(g, w, **OP_TOL)
    assert sorted(runs[mt][2]) == sorted(runs[mx][2])
    for k in runs[mx][2]:
        np.testing.assert_allclose(runs[mt][2][k], runs[mx][2][k], **OP_TOL)


@pytest.fixture(scope="module")
def multitask_p0(smoke):
    return smoke.multitask_init_params(mt, 0)


def test_multitask_first_steps_match_mxtpu(smoke, multitask_p0):
    """The multitask net's first 3 Module steps (two labels, two
    SoftmaxOutput heads, Adam 1e-3) from the same weights: each step's
    cross-entropy of both heads, the port's fused step and mxtpu's."""
    got = smoke.multitask_first_steps(mt, mt.cpu(), multitask_p0)
    want = smoke.multitask_first_steps(mx, mx.cpu(), multitask_p0)
    np.testing.assert_allclose(got, want, **STEP_TOL)


def test_multitask_fused_eligibility_matches_mxtpu(smoke):
    """Where mxtpu engages its fused step on the two-head graph, the port
    does too, with one signature captured and every batch's outputs
    reaching MultiAccuracy (no device rule: read on the host)."""
    modes = []
    for pkg in (mt, mx):
        train, _ = smoke.multitask_iters(pkg, n_train=256)
        mod = smoke.multitask_module(pkg, pkg.cpu())
        mod.bind(train.provide_data, train.provide_label)
        mod.init_params()
        mod.init_optimizer(optimizer="adam")
        modes.append((mt_eligible if pkg is mt else mx_eligible)(mod)[0])
        if pkg is mt:
            metric = smoke.multi_accuracy(mt)
            metric.reset()
            for batch in train:
                mod.forward_backward(batch)
                mod.update()
                mod.update_metric(metric, batch.label)
            assert mod._fused is not None
            assert mod._fused._group.stats["steps"] == 2
            assert metric.num_inst == [256, 256]
    assert modes == ["local", "local"]


@pytest.fixture(scope="module")
def rcnn_runs(smoke):
    """The R-CNN toy's first 3 RPN steps in both packages from the port's
    Xavier draws, then the stage-2 products of each."""
    with mt.cpu():
        mt.random.seed(0)
        exe = smoke.rcnn_rpn_symbol(mt).simple_bind(mt.cpu(), **RPN_SHAPES)
        init = mt.init.Xavier()
        weights = {}
        for name, arr in exe.arg_dict.items():
            if name not in smoke.RCNN_INPUTS:
                init(mt.init.InitDesc(name), arr)
                weights[name] = arr.asnumpy()
    return {pkg.__name__: smoke.rcnn_toy_main(pkg, pkg.cpu(), weights,
                                              max_steps=3)
            for pkg in (mt, mx)}


def test_rcnn_first_rpn_steps_match_mxtpu(rcnn_runs):
    got, want = rcnn_runs["mxtpu_torch"], rcnn_runs["mxtpu"]
    assert len(got["steps"]) == 3
    np.testing.assert_allclose(got["steps"], want["steps"], **STEP_TOL)
    np.testing.assert_allclose(got["probs"], want["probs"], rtol=1e-4,
                               atol=1e-5)


def test_rcnn_proposal_and_roi_pooling_match_mxtpu(smoke, rcnn_runs):
    """Proposal (its NMS the plain loop on the CPU) and ROIPooling on the
    port's trained RPN outputs and features: mxtpu's ops on the same
    inputs give the same rois and pooled features."""
    run = rcnn_runs["mxtpu_torch"]
    cls_prob = run["probs"].reshape(8, 2, smoke.RCNN_FEAT, smoke.RCNN_FEAT)
    want_rois = mx.nd.Proposal(mx.nd.array(cls_prob),
                               mx.nd.array(run["bbox_pred"]),
                               mx.nd.array(run["im_info"]),
                               **smoke.RCNN_PROPOSAL).asnumpy()
    np.testing.assert_array_equal(run["rois"][:, 0], want_rois[:, 0])
    np.testing.assert_allclose(run["rois"], want_rois, **OP_TOL)
    want_pooled = mx.nd.ROIPooling(
        mx.nd.array(run["feat"]), mx.nd.array(run["rois"]),
        pooled_size=(4, 4), spatial_scale=1.0 / smoke.RCNN_STRIDE).asnumpy()
    np.testing.assert_allclose(run["pooled"], want_pooled, **OP_TOL)
