"""The detection and vision ops of the PyTorch port (``mxtpu_torch/ops/
vision.py``) and the shape, elementwise and normalization ops the SSD path
adds, held to ``mxtpu`` on the CPU.

Each op gets the same numpy-seeded inputs in both packages, through the
registry's functions: the forward, and where ``mxtpu`` differentiates the
op the vector-Jacobian product of a seeded cotangent, torch's autograd
against ``jax.vjp``. Floats within 1e-5 of each value or of the largest
(XLA and torch sum in other orders); integer-valued outputs (MultiBoxTarget's
classes and masks, MultiBoxDetection's class ids, the rows' order)
exactly. Inputs include the cases where the two could part: tied scores
(the sorts are stable), two boxes force-matching one anchor (the later box
wins, as JAX's scatter does on the CPU), padding rows, an image of padding
only, a score equal to the threshold, ``nms_topk`` and ``force_suppress``.
The NMS kernel's plain version runs here; the kernel itself runs on the
card only (``chip_smoke.py`` holds it against the plain version).
"""
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.ops.registry import get_op as jax_op
from mxtpu_torch.ops import vision
from mxtpu_torch.ops.registry import get_op as torch_op
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5
# ops held to mxtpu's eager call (as nd.* runs them) rather than to one jit
# program: under jit XLA fuses PSROIPooling's floor(k * bin + y1) into a
# multiply-add on the CPU, which moves a bin's edge by a rounding
EAGER_OPS = {"_contrib_PSROIPooling"}


@pytest.fixture(scope="module")
def sweep():
    """tests/test_op_sweep.py's SPECS (inputs and params per op)."""
    spec = importlib.util.spec_from_file_location(
        "op_sweep_specs", str(ROOT / "tests" / "test_op_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(
        got, want, rtol=TOL,
        atol=TOL * max(1.0, float(np.abs(want).max()) if want.size else 1.0),
        err_msg=err_msg)


def _outs(r):
    return list(r) if isinstance(r, (tuple, list)) else [r]


def run_both(name, arrays, params, grad_args=()):
    """(port outputs, mxtpu outputs, port grads, mxtpu grads) of op
    ``name`` on ``arrays`` (numpy), the grads of sum(head * output) with
    respect to the arrays at ``grad_args``."""
    t_in = [torch.from_numpy(np.array(a)) for a in arrays]
    for i in grad_args:
        t_in[i].requires_grad_()
    got = _outs(torch_op(name).fn(*t_in, **params))
    # one compiled program a call (mxtpu's eager dispatch compiles op by op)
    j_fn = functools.partial(jax_op(name).fn, **params)
    if name not in EAGER_OPS:
        j_fn = jax.jit(j_fn)
    want = _outs(j_fn(*[jnp.asarray(a) for a in arrays]))
    assert len(got) == len(want)
    if not grad_args:
        return ([g.detach().numpy() for g in got], [np.asarray(w)
                                                     for w in want], [], [])
    rng = np.random.RandomState(9)
    heads = [rng.standard_normal(w.shape).astype(np.float32) for w in want]

    def f(*xs):
        full = [jnp.asarray(a) for a in arrays]
        for i, x in zip(grad_args, xs):
            full[i] = x
        return j_fn(*full)

    _w, vjp = jax.vjp(f, *[jnp.asarray(arrays[i]) for i in grad_args])
    cot = heads[0] if len(heads) == 1 else tuple(heads)
    want_g = vjp(jnp.asarray(cot) if len(heads) == 1 else
                 tuple(jnp.asarray(h) for h in cot))
    live = [(g, torch.from_numpy(h)) for g, h in zip(got, heads)
            if g.requires_grad]
    got_g = torch.autograd.grad(
        [g for g, _ in live], [t_in[i] for i in grad_args],
        [h for _, h in live], allow_unused=True) if live else \
        [None] * len(grad_args)
    got_g = [np.zeros(arrays[i].shape, np.float32) if g is None else
             g.numpy() for i, g in zip(grad_args, got_g)]
    return ([g.detach().numpy() for g in got], [np.asarray(w) for w in want],
            got_g, [np.asarray(g) for g in want_g])


def check(name, arrays, params, grad_args=(), exact=()):
    """The port's op against mxtpu's: outputs at ``exact`` bit for bit,
    the others and every gradient within TOL. Returns the port's outputs
    and mxtpu's."""
    got, want, got_g, want_g = run_both(name, arrays, params, grad_args)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (name, i, g.shape, w.shape)
        if i in exact:
            np.testing.assert_array_equal(g, w, err_msg="%s output %d"
                                          % (name, i))
        else:
            _close(g, w, "%s output %d" % (name, i))
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        _close(g, w, "%s gradient %d" % (name, i))
    return got, want


def u(r, *shape, lo=-1.0, hi=1.0):
    return r.uniform(lo, hi, shape).astype(np.float32)


def softmax(x, axis):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def boxes(r, *lead, lo=0.0, hi=1.0, min_side=0.02):
    """Random corner boxes [..., 4] inside [lo, hi]."""
    a = r.uniform(lo, hi, lead + (2,))
    b = r.uniform(lo, hi, lead + (2,))
    mins, maxs = np.minimum(a, b), np.maximum(a, b) + min_side
    return np.concatenate([mins, maxs], -1).astype(np.float32)


# -- the sweep's SPECS ------------------------------------------------------

SWEEP_OPS = {
    # name: indices of the inputs that get a gradient (None: every one)
    "transpose": (0,), "slice_axis": (0,), "clip": (0,), "smooth_l1": (0,),
    "L2Normalization": (0,), "BlockGrad": (0,),
    "ROIPooling": (0,), "_contrib_PSROIPooling": (0,),
    "BilinearSampler": (0, 1), "GridGenerator": (0,),
    "SpatialTransformer": (0, 1), "Correlation": (0, 1),
    "SequenceLast": (0,), "SequenceMask": (0,), "SequenceReverse": (0,),
    "_contrib_MultiBoxPrior": (), "_contrib_MultiBoxTarget": (),
    "_contrib_MultiBoxDetection": (), "_contrib_Proposal": (),
    "_contrib_MultiProposal": (),
}
EXACT = {"_contrib_MultiBoxTarget": (1, 2),
         "_contrib_MultiBoxDetection": ()}


@pytest.mark.parametrize("name", sorted(SWEEP_OPS))
def test_op_sweep_specs_match_mxtpu(sweep, name):
    spec = sweep.SPECS[name]
    arrays = [a.asnumpy() if hasattr(a, "asnumpy") else a
              for a in spec.args(np.random.RandomState(sweep._seed(name)))]
    check(name, arrays, dict(spec.params), SWEEP_OPS[name],
          EXACT.get(name, ()))


def test_blockgrad_gives_no_gradient():
    x = torch.ones(3, requires_grad=True)
    y = torch_op("BlockGrad").fn(x) * 2 + x
    y.sum().backward()
    assert x.grad.tolist() == [1.0, 1.0, 1.0]
    assert torch_op("stop_gradient") is torch_op("BlockGrad")


# -- the shape, elementwise and normalization ops ---------------------------

def _small_op_cases():
    r = np.random.RandomState(3)
    x = u(r, 2, 5, 3, 4)
    return {
        "transpose_default": ("transpose", [x], {}),
        "transpose_nhwc": ("transpose", [x], {"axes": (0, 2, 3, 1)}),
        "slice_axis_neg": ("slice_axis", [x], {"axis": -1, "begin": -3,
                                               "end": None}),
        "slice_axis_mid": ("slice_axis", [x], {"axis": 1, "begin": 1,
                                               "end": 4}),
        "clip_bounds_hit": ("clip", [np.array([-2.0, -0.5, 0.0, 0.5, 3.0],
                                              np.float32)],
                            {"a_min": -0.5, "a_max": 0.5}),
        "clip_low_only": ("clip", [x], {"a_min": 0.1}),
        "smooth_l1_scalar3": ("smooth_l1", [u(r, 4, 6, lo=-0.3, hi=0.3)],
                              {"scalar": 3.0}),
        "l2norm_instance": ("L2Normalization", [x], {"mode": "instance"}),
        "l2norm_channel": ("L2Normalization", [x], {"mode": "channel"}),
        "l2norm_spatial": ("L2Normalization", [x], {"mode": "spatial",
                                                    "eps": 1e-6}),
    }


@pytest.mark.parametrize("case", sorted(_small_op_cases()))
def test_shape_and_elementwise_ops_match_mxtpu(case):
    name, arrays, params = _small_op_cases()[case]
    check(name, arrays, params, (0,))


# -- ROI pooling, sampling, correlation, sequences --------------------------

def _vision_cases():
    r = np.random.RandomState(5)
    data = u(r, 2, 3, 9, 11)
    rois = np.array([[0, 1.2, 0.7, 7.9, 6.3], [1, 0, 0, 10, 8],
                     [1, 4, 4, 4, 4], [0, 6.6, 2.2, 9.5, 8.8]], np.float32)
    grid = u(r, 2, 2, 6, 7, lo=-1.2, hi=1.2)
    theta = np.array([[0.9, 0.2, 0.1, -0.15, 1.1, -0.05],
                      [1.2, -0.1, 0.0, 0.1, 0.8, 0.2]], np.float32)
    seq = u(r, 5, 3, 4)
    lens = np.array([2, 5, 1], np.float32)
    return {
        "roi_scale_half": ("ROIPooling", [data, rois * [1, 2, 2, 2, 2]],
                           {"pooled_size": (3, 2), "spatial_scale": 0.5},
                           (0,)),
        "roi_int_size": ("ROIPooling", [data, rois], {"pooled_size": 2},
                         (0,)),
        "psroi_group": ("_contrib_PSROIPooling",
                        [u(r, 2, 2 * 9, 8, 8), rois[:, :5] * 0.8],
                        {"output_dim": 2, "pooled_size": 3, "group_size": 3,
                         "spatial_scale": 1.0}, (0,)),
        "psroi_pooled_over_group": ("_contrib_PSROIPooling",
                                    [u(r, 1, 3 * 4, 8, 8),
                                     np.array([[0, 1, 2, 6, 7]], np.float32)],
                                    {"output_dim": 3, "pooled_size": 4,
                                     "group_size": 2, "spatial_scale": 0.9},
                                    (0,)),
        "bilinear_outside": ("BilinearSampler", [data, grid], {}, (0, 1)),
        "grid_affine": ("GridGenerator", [theta],
                        {"transform_type": "affine", "target_shape": (5, 6)},
                        (0,)),
        "grid_warp": ("GridGenerator", [u(r, 2, 2, 4, 5, lo=-2, hi=2)],
                      {"transform_type": "warp"}, (0,)),
        "spatial_transformer": ("SpatialTransformer", [data, theta],
                                {"target_shape": (7, 5)}, (0, 1)),
        "correlation_k3_d2": ("Correlation", [u(r, 2, 3, 8, 9),
                                              u(r, 2, 3, 8, 9)],
                              {"kernel_size": 3, "max_displacement": 2,
                               "pad_size": 2}, (0, 1)),
        "correlation_abs_strided": ("Correlation", [u(r, 1, 2, 9, 9),
                                                    u(r, 1, 2, 9, 9)],
                                    {"kernel_size": 1, "max_displacement": 2,
                                     "stride1": 2, "stride2": 2,
                                     "pad_size": 1, "is_multiply": False},
                                    (0, 1)),
        "correlation_k2": ("Correlation", [u(r, 1, 2, 7, 7),
                                           u(r, 1, 2, 7, 7)],
                           {"kernel_size": 2, "max_displacement": 1,
                            "pad_size": 1}, (0, 1)),
        "seq_last_plain": ("SequenceLast", [seq], {}, (0,)),
        "seq_last_axis1": ("SequenceLast", [seq.transpose(1, 0, 2).copy(),
                                            lens],
                           {"use_sequence_length": True, "axis": 1}, (0,)),
        "seq_mask_axis1": ("SequenceMask", [seq.transpose(1, 0, 2).copy(),
                                            lens],
                           {"use_sequence_length": True, "axis": 1,
                            "value": 7.0}, (0,)),
        "seq_mask_plain": ("SequenceMask", [seq, lens], {}, (0,)),
        "seq_reverse_plain": ("SequenceReverse", [seq], {}, (0,)),
        "seq_reverse_axis1": ("SequenceReverse",
                              [seq.transpose(1, 0, 2).copy(), lens],
                              {"use_sequence_length": True, "axis": 1},
                              (0,)),
    }


@pytest.mark.parametrize("case", sorted(_vision_cases()))
def test_vision_ops_and_gradients_match_mxtpu(case):
    name, arrays, params, grad_args = _vision_cases()[case]
    check(name, arrays, params, grad_args)


# -- MultiBoxPrior ----------------------------------------------------------

@pytest.mark.parametrize("params, hw", [
    ({"sizes": (0.2, 0.3, 0.45), "ratios": (1.0, 2.0, 0.5)}, (5, 5)),
    ({"sizes": (0.1, 0.141), "ratios": (1, 2, 0.5, 3, 1.0 / 3),
      "steps": (8 / 300, 8 / 300)}, (38, 38)),
    ({"sizes": 0.7, "ratios": (2.0,), "clip": True,
      "offsets": (0.25, 0.75)}, (3, 7)),
    ({"sizes": (0.9, 0.3), "ratios": 1.0, "steps": (0.2, 0.1)}, (4, 6)),
])
def test_multibox_prior_matches_mxtpu(params, hw):
    (got,), _ = check("_contrib_MultiBoxPrior",
                      [np.zeros((2, 3) + hw, np.float32)], params)
    sizes = params["sizes"] if isinstance(params["sizes"], tuple) else (1,)
    ratios = params["ratios"] if isinstance(params["ratios"], tuple) else (1,)
    assert got.shape == (1, hw[0] * hw[1] * (len(sizes) + len(ratios) - 1),
                         4)


# -- MultiBoxTarget ---------------------------------------------------------

def _anchors(hw=(6, 6), sizes=(0.2, 0.35), ratios=(1.0, 2.0, 0.5)):
    return torch_op("_contrib_MultiBoxPrior").fn(
        torch.zeros((1, 1) + hw), sizes=sizes, ratios=ratios).numpy()


def _labels(r, b, g, classes=4, pad_from=None):
    lab = np.full((b, g, 5), -1.0, np.float32)
    for i in range(b):
        n = g if pad_from is None else pad_from[i]
        lab[i, :n, 0] = r.randint(0, classes, n)
        lab[i, :n, 1:] = boxes(r, n, lo=0.05, hi=0.8, min_side=0.1)
    return lab


MINING = {"negative_mining_ratio": 3.0, "negative_mining_thresh": 0.5,
          "overlap_threshold": 0.5, "ignore_label": -1.0}


@pytest.mark.parametrize("mining", [False, True])
def test_multibox_target_matches_mxtpu(mining):
    r = np.random.RandomState(11)
    anchors = _anchors()
    a = anchors.shape[1]
    label = _labels(r, 3, 4, pad_from=[4, 2, 1])
    preds = u(r, 3, 5, a)
    params = dict(MINING) if mining else {}
    (bt, bm, ct), _ = check("_contrib_MultiBoxTarget",
                            [anchors, label, preds], params, exact=(1, 2))
    assert (ct >= 1).any() and (ct == 0).any()
    if mining:
        assert (ct == -1).any()


def test_multibox_target_mining_ties_keep_index_order():
    """Every candidate scores alike: the kept negatives are the first ones
    by index, as a stable sort ranks them."""
    r = np.random.RandomState(12)
    anchors = _anchors((4, 4))
    a = anchors.shape[1]
    label = _labels(r, 2, 2)
    preds = np.zeros((2, 3, a), np.float32)
    preds[:, 1:, ::3] = 0.25                   # groups of exact ties
    (_bt, _bm, ct), _ = check("_contrib_MultiBoxTarget",
                              [anchors, label, preds], dict(MINING),
                              exact=(1, 2))
    for i in range(2):
        neg = np.where(ct[i] == 0)[0]
        assert len(neg) > 0


def test_multibox_target_duplicate_match_later_box_wins():
    """Two boxes (and a padding row with the same corners) share one best
    anchor: the later real box takes it, the padding row never does."""
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                         [0.0, 0.5, 0.5, 1.0], [0.6, 0.0, 0.9, 0.2]]],
                       np.float32)
    label = np.array([[[1, 0.05, 0.05, 0.4, 0.4],
                       [2, 0.02, 0.06, 0.44, 0.41],
                       [-1, 0.05, 0.05, 0.4, 0.4],
                       [3, 0.55, 0.5, 0.95, 0.9]]], np.float32)
    preds = np.zeros((1, 4, 4), np.float32)
    (bt, _bm, ct), _ = check("_contrib_MultiBoxTarget",
                             [anchors, label, preds],
                             {"overlap_threshold": 0.99}, exact=(1, 2))
    assert ct[0].tolist() == [3.0, 4.0, 0.0, 0.0]
    # anchor 0 regresses to the second box, the later of the two
    assert bt[0, 0] != 0


@pytest.mark.parametrize("mining", [False, True])
def test_multibox_target_all_padding_image(mining):
    """An image whose rows are all -1: no anchor matches; background
    everywhere, or ignore everywhere under mining (no positive to scale
    the negatives)."""
    r = np.random.RandomState(13)
    anchors = _anchors((3, 3))
    label = _labels(r, 2, 3, pad_from=[0, 2])
    preds = u(r, 2, 3, anchors.shape[1])
    (bt, bm, ct), _ = check("_contrib_MultiBoxTarget",
                            [anchors, label, preds],
                            dict(MINING) if mining else {}, exact=(1, 2))
    assert not bm[0].any() and not bt[0].any()
    assert set(ct[0].tolist()) == ({-1.0} if mining else {0.0})


# -- MultiBoxDetection and its NMS ------------------------------------------

def _detection_inputs(r, b=2, classes=4, hw=(5, 5), zero_share=0.5):
    """Softmax probabilities with many exact zeros among the classes (so
    many rows tie at score 0 after the threshold), loc offsets and
    anchors."""
    anchors = _anchors(hw, sizes=(0.3, 0.5), ratios=(1.0, 2.0))
    a = anchors.shape[1]
    probs = softmax(u(r, b, classes, a, lo=-3, hi=3), 1)
    drop = r.uniform(size=(b, 1, a)) < zero_share
    probs[:, 1:] = np.where(drop, 0.0, probs[:, 1:])
    loc = u(r, b, a * 4, lo=-0.5, hi=0.5)
    return probs, loc, anchors


@pytest.mark.parametrize("params", [
    {},
    {"nms_threshold": 0.3, "threshold": 0.05},
    {"force_suppress": True, "nms_threshold": 0.4},
    {"nms_topk": 7},
    {"nms_topk": 400, "force_suppress": True},
    {"background_id": 1, "clip": False},
    {"variances": (0.2, 0.2, 0.1, 0.1), "nms_threshold": 0.6},
], ids=["default", "low_nms", "force", "topk7", "topk400_force",
        "background1", "variances"])
def test_multibox_detection_matches_mxtpu(params):
    r = np.random.RandomState(21)
    probs, loc, anchors = _detection_inputs(r)
    (got,), (want,) = check("_contrib_MultiBoxDetection",
                            [probs, loc, anchors], params)
    np.testing.assert_array_equal(got[..., 0], want[..., 0])
    np.testing.assert_array_equal(got[..., 1], want[..., 1])
    assert (got[..., 0] == -1).any() and (got[..., 0] >= 0).any()
    if params.get("nms_topk"):
        assert (got[:, params["nms_topk"]:, 0] == -1).all()


def test_multibox_detection_threshold_is_strict():
    """A score equal to ``threshold`` is dropped; one just above stays."""
    above = np.nextafter(np.float32(0.5), np.float32(1))
    probs = np.array([[[0.5, 1 - above, 0.1], [0.5, above, 0.9]]],
                     np.float32)
    anchors = np.array([[[0.0, 0.0, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9],
                         [0.1, 0.5, 0.3, 0.9]]], np.float32)
    loc = np.zeros((1, 12), np.float32)
    (got,), _ = check("_contrib_MultiBoxDetection", [probs, loc, anchors],
                      {"threshold": 0.5})
    assert got[0, :, 0].tolist() == [0.0, 0.0, -1.0]
    assert got[0, :, 1].tolist() == [np.float32(0.9), above, 0.0]


def test_multibox_detection_class_ids_skip_background():
    """With background 1, class 0 stays 0 and class 2 becomes 1."""
    probs = np.array([[[0.7, 0.1], [0.2, 0.2], [0.1, 0.7]]], np.float32)
    anchors = np.array([[[0.0, 0.0, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9]]],
                       np.float32)
    (got,), _ = check("_contrib_MultiBoxDetection",
                      [probs, np.zeros((1, 8), np.float32), anchors],
                      {"background_id": 1})
    assert sorted(got[0, :, 0].tolist()) == [0.0, 1.0]


def test_nms_plain_matches_mxtpus_fori_loop():
    """Chosen boxes through the loop: the decode leaves the anchors as
    they are (loc 0), the scores fix the order. Chains where a
    suppressed box would have suppressed another, two classes, and a
    dead row that must not suppress."""
    anchors = np.array([[[0.10, 0.10, 0.50, 0.50],
                         [0.12, 0.12, 0.52, 0.52],
                         [0.14, 0.10, 0.54, 0.50],
                         [0.30, 0.30, 0.70, 0.70],
                         [0.11, 0.11, 0.49, 0.51],
                         [0.60, 0.60, 0.90, 0.90],
                         [0.61, 0.60, 0.90, 0.91]]], np.float32)
    score = np.array([0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3], np.float32)
    cls = np.array([1, 1, 2, 1, 2, 1, 2])
    probs = np.zeros((1, 3, 7), np.float32)
    probs[0, cls, np.arange(7)] = score
    probs[0, 0] = 1 - score
    for params in ({"nms_threshold": 0.5}, {"nms_threshold": 0.5,
                                            "force_suppress": True},
                   {"nms_threshold": 0.2}, {"nms_topk": 3}):
        (got,), (want,) = check(
            "_contrib_MultiBoxDetection",
            [probs, np.zeros((1, 28), np.float32), anchors], params)
        np.testing.assert_array_equal(got, want)
    # the plain loop on its own, on a batch of shuffled rows
    r = np.random.RandomState(2)
    bx = torch.from_numpy(boxes(r, 3, 40, min_side=0.15))
    cl = torch.from_numpy(r.randint(-1, 3, (3, 40)).astype(np.float32))
    out = vision.multibox_nms_plain(bx, cl, 0.45, False, 40)
    assert ((out == cl) | (out == -1)).all()
    assert (out == -1).sum() > (cl == -1).sum()


def test_nms_routes_cpu_to_plain_and_never_builds_the_iou_matrix(
        monkeypatch):
    calls = []
    real = vision.multibox_nms_plain

    def counted(*a):
        calls.append(a[0].shape)
        return real(*a)

    def no_matrix(*a):
        raise AssertionError("an A x A IoU matrix was built")

    monkeypatch.setattr(vision, "multibox_nms_plain", counted)
    monkeypatch.setattr(vision, "_box_iou", no_matrix)
    r = np.random.RandomState(4)
    probs, loc, anchors = _detection_inputs(r)
    out = mt.nd.contrib.MultiBoxDetection(
        mt.nd.array(probs, ctx=mt.cpu()), mt.nd.array(loc, ctx=mt.cpu()),
        mt.nd.array(anchors, ctx=mt.cpu()))
    assert out.shape == (2, anchors.shape[1], 6)
    assert calls == [(2, anchors.shape[1], 4)]
    assert vision.LAUNCHES["multibox_nms"] == 0


def test_nms_kernel_entry_refuses_what_it_cannot_launch():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    another device does not fall back to the plain loop."""
    bx = torch.zeros((1, 4, 4), device="meta")
    cl = torch.zeros((1, 4), device="meta")
    with pytest.raises(ValueError):
        vision.multibox_nms(bx, cl, 0.5, False, 4)
    assert vision.multibox_nms_smem(8732) == (16 + 8736 + 34928 + 16 * 8732,
                                              True)
    assert vision.multibox_nms_smem(20000) == (16 + 20000 + 80000, False)


@pytest.mark.parametrize("output_score", [False, True])
def test_proposal_matches_mxtpu(output_score):
    r = np.random.RandomState(8)
    na, h, w = 6, 5, 6
    cls_prob = softmax(u(r, 2, 2, na, h, w, lo=-2, hi=2), 1).reshape(
        2, 2 * na, h, w)
    bbox = u(r, 2, 4 * na, h, w, lo=-0.3, hi=0.3)
    im_info = np.array([[80, 96, 1.0], [70, 90, 0.5]], np.float32)
    params = {"rpn_pre_nms_top_n": 50, "rpn_post_nms_top_n": 12,
              "threshold": 0.6, "rpn_min_size": 4, "scales": (2, 4),
              "ratios": (0.5, 1, 2), "feature_stride": 16,
              "output_score": output_score}
    got, _ = check("_contrib_Proposal", [cls_prob, bbox, im_info], params)
    assert got[0].shape == (24, 5)
    check("_contrib_MultiProposal", [cls_prob, bbox, im_info], params)


# -- the contrib namespaces -------------------------------------------------

def test_contrib_namespaces_resolve_as_mxtpus():
    for name in ("MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
                 "Proposal", "MultiProposal", "PSROIPooling",
                 "flash_attention"):
        want = mx.ops.registry.get_op("_contrib_" + name).name
        assert torch_op("_contrib_" + name).name == want
        assert callable(getattr(mt.nd.contrib, name))
        assert callable(getattr(mt.sym.contrib, name))
    # a plain op resolves too, as mxtpu's namespace falls back to it
    assert mt.nd.contrib.transpose(mt.nd.zeros((2, 3), ctx=mt.cpu())
                                   ).shape == (3, 2)
    with pytest.raises(AttributeError):
        mt.nd.contrib.NoSuchOp
    with pytest.raises(AttributeError):
        mt.sym.contrib.NoSuchOp
    for alias in ("MultiBoxPrior", "multibox_prior", "_contrib_MultiBoxPrior"):
        assert torch_op(alias) is torch_op("_contrib_MultiBoxPrior")
        assert mx.ops.registry.get_op(alias) is not None


def test_contrib_symbol_evaluates_as_nd():
    """sym.contrib.MultiBoxTarget in a graph gives nd.contrib's outputs,
    and its JSON loads in mxtpu and evaluates the same there."""
    r = np.random.RandomState(31)
    anchors = _anchors((3, 3))
    label = _labels(r, 2, 2)
    preds = u(r, 2, 3, anchors.shape[1])
    S = mt.sym
    out = S.contrib.MultiBoxTarget(S.var("anchor"), S.var("label"),
                                   S.var("pred"), negative_mining_ratio=3.0)
    feed = {"anchor": anchors, "label": label, "pred": preds}
    got, _aux = S.eval_graph(out._outputs, {k: torch.from_numpy(v)
                                            for k, v in feed.items()})
    want = mt.nd.contrib.MultiBoxTarget(
        *[mt.nd.array(feed[k], ctx=mt.cpu()) for k in ("anchor", "label",
                                                        "pred")],
        negative_mining_ratio=3.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.asnumpy())
    jsym = mx.sym.load_json(out.tojson())
    exe = jsym.bind(mx.cpu(), {k: mx.nd.array(v) for k, v in feed.items()})
    for g, w in zip(exe.forward(), want):
        np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
