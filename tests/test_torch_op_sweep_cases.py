"""The cases of the ops ported with the op sweep that its specs do not
reach, held to ``mxtpu`` on the CPU; and the two places where the port
follows MXNet and not ``mxtpu``, pinned at exact points.

``CASES`` run each op's registry function in both packages on the same
numpy-seeded inputs: the outputs, and the vector-Jacobian product of a
seeded cotangent (torch's autograd against ``jax.vjp``), within
``TOL`` of each value or of the largest. They cover Deconvolution's
``target_shape`` (and its refusal of one too big), 1-d and 3-d, ``adj``,
``dilate`` and ``num_group``; UpSampling with several inputs; ``topk``,
``sort`` and ``argsort`` with ties; ``scatter_nd`` with a duplicate
index; ``pad``'s reflect and edge modes on 5-d data; Crop's
``center_crop`` and ``crop_like``; ``slice`` with negative steps;
``take``'s clip and wrap; ``norm`` at 0; ``dot`` on N-d arrays and with
transposes; the loss heads' options.

``CARD_SWEEP``, the table of inputs ``chip_smoke.py`` runs every
registered op on the card with, has a row for each op the port
registers, and each row runs on the CPU.

Documented differences (ROADMAP Queue C): ``round`` rounds half away
from zero (MXNet's rule and the sweep's own reference; ``mxtpu``'s
``jnp.round`` rounds half to even), ``gamma`` is the signed Gamma
function (``mxtpu``'s ``exp(gammaln(x))`` is its absolute value),
UpSampling's ``multi_input_mode="sum"`` sums (``mxtpu`` concatenates),
and a grouped Deconvolution computes each group (``mxtpu``'s raises).
"""
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.ops.registry import get_op as jax_op
from mxtpu_torch.ops.registry import get_op as torch_op
from torch_threads import torch_threads_shared  # noqa: F401

TOL = 1e-5


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _outs(r):
    return list(r) if isinstance(r, (tuple, list)) else [r]


def run_both(name, arrays, params, grad_args=(), seed=0):
    """(port outputs, mxtpu outputs, port grads, mxtpu grads) of op
    ``name`` on ``arrays``: the grads of sum(cotangent * output) with
    respect to the arrays at ``grad_args``."""
    t_in = [torch.from_numpy(np.array(a)) for a in arrays]
    for i in grad_args:
        t_in[i].requires_grad_()
    got = _outs(torch_op(name).fn(*t_in, **params))
    j_in = [jnp.asarray(a) for a in arrays]

    def f(*diff):
        full = list(j_in)
        for i, d in zip(grad_args, diff):
            full[i] = d
        return tuple(_outs(jax_op(name).fn(*full, **params)))

    want, vjp = jax.vjp(f, *[j_in[i] for i in grad_args])
    assert len(got) == len(want)
    got_np = [g.detach().numpy() for g in got]
    want_np = [np.asarray(w) for w in want]
    if not grad_args:
        return got_np, want_np, [], []
    r = np.random.RandomState(seed)
    cots = [r.normal(0, 1, w.shape).astype(np.float32) for w in want_np]
    loss = sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cots))
    tg = torch.autograd.grad(loss, [t_in[i] for i in grad_args],
                             allow_unused=True)
    tg = [np.zeros(arrays[i].shape, np.float32) if g is None else g.numpy()
          for i, g in zip(grad_args, tg)]
    jg = [np.asarray(g) for g in vjp(tuple(jnp.asarray(c) for c in cots))]
    return got_np, want_np, tg, jg


def close(got, want, msg=""):
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=TOL,
                               atol=TOL * scale, err_msg=msg)


def u(r, *shape):
    return r.uniform(-1, 1, shape).astype(np.float32)


def ties(r, *shape):
    """Values from a set of 3, so most rows hold ties."""
    return r.choice([-0.5, 0.25, 1.0], shape).astype(np.float32)


# (id, op, inputs from a RandomState, params, args to differentiate)
CASES = [
    ("deconv_target_shape", "Deconvolution",
     lambda r: [u(r, 2, 3, 5, 4), u(r, 3, 4, 3, 3)],
     dict(kernel=(3, 3), stride=(2, 2), num_filter=4,
          target_shape=(10, 8)), (0, 1)),
    ("deconv_target_shape_odd", "Deconvolution",
     lambda r: [u(r, 1, 2, 4, 4), u(r, 2, 3, 4, 4)],
     dict(kernel=(4, 4), stride=(2, 2), num_filter=3,
          target_shape=(9, 7)), (0, 1)),
    ("deconv_adj_dilate_bias", "Deconvolution",
     lambda r: [u(r, 2, 4, 5, 6), u(r, 4, 3, 3, 2), u(r, 3)],
     dict(kernel=(3, 2), stride=(3, 2), dilate=(2, 1), pad=(1, 0),
          adj=(2, 1), num_filter=3, no_bias=False), (0, 1, 2)),
    ("deconv_adj_past_pad", "Deconvolution",
     lambda r: [u(r, 1, 2, 4, 4), u(r, 2, 2, 3, 3)],
     dict(kernel=(3, 3), stride=(1, 1), adj=(1, 1), num_filter=2),
     (0, 1)),
    ("deconv_1d", "Deconvolution",
     lambda r: [u(r, 2, 3, 7), u(r, 3, 2, 4)],
     dict(kernel=(4,), stride=(2,), pad=(1,), num_filter=2), (0, 1)),
    ("deconv_3d", "Deconvolution",
     lambda r: [u(r, 1, 2, 3, 4, 3), u(r, 2, 3, 2, 3, 2)],
     dict(kernel=(2, 3, 2), stride=(2, 1, 2), pad=(0, 1, 0), adj=(1, 0, 1),
          num_filter=3), (0, 1)),
    ("deconv_fcn_bigscore", "Deconvolution",
     lambda r: [u(r, 1, 3, 4, 4), u(r, 3, 3, 16, 16)],
     dict(kernel=(16, 16), stride=(8, 8), adj=(7, 7), num_filter=3),
     (0, 1)),
    ("upsampling_concat", "UpSampling",
     lambda r: [u(r, 2, 2, 3, 3), u(r, 2, 3, 3, 3)],
     dict(scale=2, sample_type="nearest", num_args=2), (0, 1)),
    ("upsampling_bilinear", "UpSampling",
     lambda r: [u(r, 1, 2, 4, 5), u(r, 2, 1, 4, 4)],
     dict(scale=2, sample_type="bilinear", num_args=2, num_filter=2), (0,)),
    ("topk_ties_indices", "topk", lambda r: [ties(r, 4, 9)],
     dict(k=4, ret_typ="indices"), ()),
    ("topk_ties_both_ascend", "topk", lambda r: [ties(r, 4, 9)],
     dict(k=3, ret_typ="both", is_ascend=True), ()),
    ("topk_ties_mask_axis0", "topk", lambda r: [ties(r, 7, 3)],
     dict(k=2, ret_typ="mask", axis=0), ()),
    ("topk_ties_value_int", "topk", lambda r: [ties(r, 3, 8)],
     dict(k=5, ret_typ="value", dtype="int32"), ()),
    ("sort_ties_desc", "sort", lambda r: [ties(r, 3, 8)],
     dict(is_ascend=False), (0,)),
    ("sort_ties_axis0", "sort", lambda r: [ties(r, 6, 3)], dict(axis=0),
     (0,)),
    ("argsort_ties_desc", "argsort", lambda r: [ties(r, 3, 8)],
     dict(is_ascend=False), ()),
    ("argsort_ties_asc", "argsort", lambda r: [ties(r, 3, 8)], dict(), ()),
    ("scatter_nd_duplicates", "scatter_nd",
     lambda r: [u(r, 5, 2), np.array([[1, 3, 1, 0, 1], [2, 0, 2, 2, -1]],
                                     np.int32)],
     dict(shape=(4, 3, 2)), (0,)),
    ("gather_nd_negative", "gather_nd",
     lambda r: [u(r, 4, 5, 2), np.array([[0, -1, 2], [4, 1, -2]], np.int32)],
     dict(), (0,)),
    ("pad_reflect_5d", "pad", lambda r: [u(r, 1, 2, 3, 4, 5)],
     dict(mode="reflect", pad_width=(0, 0, 0, 0, 2, 1, 1, 3, 2, 2)), (0,)),
    ("pad_edge_5d", "pad", lambda r: [u(r, 2, 1, 3, 2, 4)],
     dict(mode="edge", pad_width=(0, 0, 0, 0, 1, 2, 3, 0, 0, 2)), (0,)),
    ("pad_constant_5d", "pad", lambda r: [u(r, 1, 2, 2, 3, 2)],
     dict(mode="constant", pad_width=(0, 0, 1, 0, 0, 2, 1, 1, 2, 0),
          constant_value=-2.0), (0,)),
    ("crop_center", "Crop", lambda r: [u(r, 2, 3, 9, 8)],
     dict(h_w=(4, 5), center_crop=True), (0,)),
    ("crop_like_offset", "Crop", lambda r: [u(r, 1, 2, 7, 9), u(r, 1, 5, 3, 4)],
     dict(offset=(2, 5)), (0,)),
    ("crop_like_center", "Crop", lambda r: [u(r, 1, 2, 10, 7), u(r, 1, 1, 5, 4)],
     dict(center_crop=True), (0,)),
    ("slice_negative_step", "slice", lambda r: [u(r, 6, 7, 3)],
     dict(begin=(None, 5, 0), end=(None, 0, 3), step=(-2, -1, 2)), (0,)),
    ("slice_none_bounds", "slice", lambda r: [u(r, 5, 6)],
     dict(begin=(1, None), end=(None, -1)), (0,)),
    ("take_clip", "take",
     lambda r: [u(r, 4, 3), np.array([[0, 5], [-2, 3]], np.int32)],
     dict(axis=0, mode="clip"), (0,)),
    ("take_wrap_axis1", "take",
     lambda r: [u(r, 3, 4), np.array([5, -1, 2, 9], np.int32)],
     dict(axis=1, mode="wrap"), (0,)),
    ("norm_l1_keepdims", "norm", lambda r: [u(r, 3, 4, 2)],
     dict(ord=1, axis=(0, 2), keepdims=True), (0,)),
    ("norm_all", "norm", lambda r: [u(r, 3, 4)], dict(), (0,)),
    ("dot_nd", "dot", lambda r: [u(r, 2, 3, 4), u(r, 4, 5, 2)], dict(),
     (0, 1)),
    ("dot_transposed", "dot", lambda r: [u(r, 4, 3), u(r, 5, 4)],
     dict(transpose_a=True, transpose_b=True), (0, 1)),
    ("dot_vectors", "dot", lambda r: [u(r, 6), u(r, 6)], dict(), (0, 1)),
    ("batch_dot_transposed", "batch_dot",
     lambda r: [u(r, 3, 4, 2), u(r, 3, 5, 4)],
     dict(transpose_a=True, transpose_b=True), (0, 1)),
    ("softmax_activation_channel", "SoftmaxActivation",
     lambda r: [u(r, 2, 3, 2, 2)], dict(mode="channel"), (0,)),
    ("layer_norm_axis1", "LayerNorm",
     lambda r: [u(r, 2, 3, 4), u(r, 3), u(r, 3)], dict(axis=1), (0, 1, 2)),
    ("svm_linear", "SVMOutput",
     lambda r: [u(r, 5, 4), np.array([0, 3, 1, 2, 3], np.float32)],
     dict(use_linear=True, margin=0.5, regularization_coefficient=2.0),
     (0, 1)),
    ("svm_squared", "SVMOutput",
     lambda r: [u(r, 5, 4), np.array([2, 0, 1, 3, 3], np.float32)],
     dict(margin=1.5, regularization_coefficient=0.5), (0, 1)),
    ("logistic_grad_scale", "LogisticRegressionOutput",
     lambda r: [u(r, 3, 2, 2), u(r, 3, 4)], dict(grad_scale=3.0), (0, 1)),
    ("mae_grad_scale", "MAERegressionOutput",
     lambda r: [u(r, 4, 3), u(r, 4, 3)], dict(grad_scale=0.5), (0, 1)),
    ("depth_to_space_3", "depth_to_space", lambda r: [u(r, 2, 18, 2, 3)],
     dict(block_size=3), (0,)),
    ("diag_3d", "diag", lambda r: [u(r, 3, 4, 2)], dict(k=1), (0,)),
    ("diag_vector", "diag", lambda r: [u(r, 4)], dict(k=-1), (0,)),
    ("repeat_flat", "repeat", lambda r: [u(r, 2, 3)], dict(repeats=3),
     (0,)),
    ("squeeze_all", "squeeze", lambda r: [u(r, 1, 3, 1, 2)], dict(), (0,)),
    ("broadcast_axes_tuple", "broadcast_axis", lambda r: [u(r, 1, 3, 1)],
     dict(axis=(0, 2), size=(2, 4)), (0,)),
    ("broadcast_to_keep", "broadcast_to", lambda r: [u(r, 2, 1)],
     dict(shape=(0, 3)), (0,)),
    ("add_n_four", "add_n", lambda r: [u(r, 2, 3) for _ in range(4)], dict(),
     (0, 1, 2, 3)),
    ("hypot_broadcast", "broadcast_hypot",
     lambda r: [u(r, 3, 1), u(r, 1, 4)], dict(), (0, 1)),
    # A9's dense ops: the options their specs leave out
    ("deform_groups_dilate_bias", "_contrib_DeformableConvolution",
     lambda r: [u(r, 2, 4, 7, 6), 1.5 * u(r, 2, 36, 7, 4), u(r, 6, 2, 3, 3),
                u(r, 6)],
     dict(kernel=(3, 3), num_filter=6, pad=(2, 1), dilate=(2, 2),
          stride=(1, 1), num_group=2, num_deformable_group=2), (0, 1, 2, 3)),
    ("deform_stride", "_contrib_DeformableConvolution",
     lambda r: [u(r, 1, 3, 8, 8), 2.5 * u(r, 1, 8, 4, 4), u(r, 2, 3, 2, 2)],
     dict(kernel=(2, 2), num_filter=2, stride=(2, 2), no_bias=True),
     (0, 1, 2)),
    ("deform_psroi_trans", "_contrib_DeformablePSROIPooling",
     lambda r: [u(r, 2, 8, 7, 7),
                np.array([[0, 0.5, 1.0, 5.5, 6.0], [1, 2.0, 0.0, 6.5, 4.5],
                          [1, -1.0, 3.0, 3.0, 9.0]], np.float32),
                u(r, 3, 8)],
     dict(output_dim=2, pooled_size=2, group_size=2, part_size=2,
          sample_per_part=3, trans_std=0.2, spatial_scale=0.9), (0, 2)),
    ("box_iou_center", "_contrib_box_iou",
     lambda r: [np.abs(u(r, 2, 5, 4)) + 0.1, np.abs(u(r, 2, 3, 4)) + 0.1],
     dict(format="center"), ()),
    ("box_nms_topk_force", "_contrib_box_nms",
     lambda r: [CS._box_rows(r, 30)], dict(overlap_thresh=0.2, topk=8,
                                           valid_thresh=0.2, id_index=0,
                                           force_suppress=True), ()),
    ("box_nms_no_ids_center", "_contrib_box_nms",
     lambda r: [np.stack([CS._box_rows(r, 20)[0][:, 1:],
                          CS._box_rows(r, 20)[0][:, 1:]])[None]],
     dict(overlap_thresh=0.3, coord_start=1, score_index=0,
          in_format="center", out_format="corner"), ()),
    ("box_nms_out_center", "_contrib_box_nms",
     lambda r: [CS._box_rows(r, 16)],
     dict(overlap_thresh=0.4, id_index=0, out_format="center"), ()),
    ("bipartite_ascend_topk", "_contrib_bipartite_matching",
     lambda r: [u(r, 3, 5, 4)], dict(threshold=0.5, is_ascend=True,
                                      topk=3), ()),
    ("linalg_trsm_right_upper_t", "linalg_trsm",
     lambda r: [CS._lower(r, 3).T.copy(), u(r, 2, 3)],
     dict(transpose=True, rightside=True, lower=False, alpha=2.0), (0, 1)),
    ("linalg_trmm_right_t_batch", "linalg_trmm",
     lambda r: [np.stack([CS._lower(r, 3)] * 2), u(r, 2, 4, 3)],
     dict(transpose=True, rightside=True, alpha=0.5), (0, 1)),
    ("linalg_gemm_t_batch", "linalg_gemm",
     lambda r: [u(r, 2, 4, 3), u(r, 2, 5, 4), u(r, 2, 3, 5)],
     dict(transpose_a=True, transpose_b=True, alpha=0.5, beta=2.0),
     (0, 1, 2)),
    ("linalg_syrk_t", "linalg_syrk", lambda r: [u(r, 3, 4)],
     dict(transpose=True, alpha=3.0), (0,)),
    ("linalg_potri_batch", "linalg_potri",
     lambda r: [np.stack([np.linalg.cholesky(CS._spd(r, 3))] * 2)
                .astype(np.float32)], dict(), (0,)),
    ("linalg_sumlogdiag_batch", "linalg_sumlogdiag",
     lambda r: [np.stack([CS._spd(r, 3), CS._spd(r, 3)])], dict(), (0,)),
    ("khatri_rao_three", "khatri_rao",
     lambda r: [u(r, 2, 3), u(r, 4, 3), u(r, 2, 3)], dict(), (0, 1, 2)),
    ("quantize_int8", "_contrib_quantize",
     lambda r: [u(r, 3, 4), np.array([-0.8, -1.2], np.float32),
                np.array([0.9, 0.7], np.float32)], dict(out_type="int8"),
     ()),
    ("dequantize_int8", "_contrib_dequantize",
     lambda r: [r.randint(-127, 128, (3, 4)).astype(np.int8),
                np.array([-2.0], np.float32), np.array([1.5], np.float32)],
     dict(), ()),
    ("fft_batch", "_contrib_fft", lambda r: [u(r, 2, 3, 6)], dict(), (0,)),
    ("ifft_batch", "_contrib_ifft", lambda r: [u(r, 3, 12)], dict(), (0,)),
    ("softmax_ce_3d", "softmax_cross_entropy",
     lambda r: [u(r, 2, 3, 4), r.randint(0, 4, (2, 3)).astype(np.float32)],
     dict(), (0,)),
    ("image_to_tensor_batch", "_image_to_tensor",
     lambda r: [r.randint(0, 256, (2, 4, 5, 3)).astype(np.uint8)], dict(),
     ()),
    ("image_normalize_batch", "_image_normalize",
     lambda r: [u(r, 2, 3, 4, 5)],
     dict(mean=(0.1, 0.2, 0.3), std=(0.5, 0.6, 0.7)), (0,)),
    ("kl_sparse_reg", "IdentityAttachKLSparseReg",
     lambda r: [u(r, 4, 5)], dict(sparseness_target=0.2, penalty=0.5),
     (0,)),
    ("adagrad_clip_wd", "adagrad_update",
     lambda r: [u(r, 3, 4), 5 * u(r, 3, 4), np.abs(u(r, 3, 4))],
     dict(lr=0.1, wd=0.1, rescale_grad=0.5, clip_gradient=1.0), ()),
    ("adam_clip_rescale", "adam_update",
     lambda r: [u(r, 3, 4), 5 * u(r, 3, 4), u(r, 3, 4), np.abs(u(r, 3, 4))],
     dict(lr=0.1, wd=0.1, rescale_grad=0.5, clip_gradient=0.8), ()),
    ("rmsprop_clip_weights", "rmsprop_update",
     lambda r: [2 * u(r, 3, 4), u(r, 3, 4), np.abs(u(r, 3, 4))],
     dict(lr=0.5, clip_weights=0.6, clip_gradient=0.3), ()),
    ("signum_wd_lh", "signum_update",
     lambda r: [u(r, 3, 4), u(r, 3, 4), u(r, 3, 4)],
     dict(lr=0.1, momentum=0.5, wd=0.1, wd_lh=0.2), ()),
    ("ftrl_wd", "ftrl_update",
     lambda r: [u(r, 3, 4), u(r, 3, 4), u(r, 3, 4), np.abs(u(r, 3, 4))],
     dict(lr=0.2, lamda1=0.3, beta=0.5, wd=0.1), ()),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_case(case):
    _, name, make, params, grad_args = case
    arrays = make(np.random.RandomState(len(case[0])))
    got, want, tg, jg = run_both(name, arrays, params, grad_args)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        close(g, w, "%s output %d" % (case[0], i))
    for i, g, w in zip(grad_args, tg, jg):
        close(g, w, "%s d/d(arg%d)" % (case[0], i))


def test_grouped_deconvolution():
    """num_group > 1: each group's channels through its slice of the
    weight, as mxtpu's ungrouped op computes them group by group (mxtpu's
    own grouped path splits the swapped weight on the wrong axis and
    raises, ROADMAP Queue C)."""
    r = np.random.RandomState(5)
    x, w, b = u(r, 2, 4, 5, 6), u(r, 4, 3, 3, 2), u(r, 6)
    params = dict(kernel=(3, 2), stride=(3, 2), dilate=(2, 1), pad=(1, 0),
                  adj=(2, 1), num_filter=6, num_group=2, no_bias=False)
    got = torch_op("Deconvolution").fn(
        *[torch.from_numpy(v) for v in (x, w, b)], **params).numpy()
    one = dict(params, num_filter=3, num_group=1)
    want = np.concatenate([np.asarray(jax_op("Deconvolution").fn(
        jnp.asarray(x[:, 2 * g:2 * g + 2]), jnp.asarray(w[2 * g:2 * g + 2]),
        jnp.asarray(b[3 * g:3 * g + 3]), **one)) for g in range(2)], axis=1)
    close(got, want)
    with pytest.raises(ValueError):
        jax_op("Deconvolution").fn(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), **params)


def test_deconvolution_too_big_target_raises():
    x = np.zeros((1, 1, 3, 3), np.float32)
    w = np.zeros((1, 1, 3, 3), np.float32)
    params = dict(kernel=(3, 3), stride=(2, 2), num_filter=1,
                  target_shape=(8, 7))
    for fn, arr in ((torch_op("Deconvolution").fn, torch.from_numpy),
                    (jax_op("Deconvolution").fn, jnp.asarray)):
        with pytest.raises(ValueError, match="too big target shape"):
            fn(arr(x), arr(w), **params)


def test_crop_outside_its_map_raises():
    with pytest.raises(ValueError, match="does not fit"):
        torch_op("Crop").fn(torch.zeros(1, 1, 5, 5), offset=(2, 0),
                            h_w=(4, 4))


def test_round_half_away_from_zero():
    """MXNet's round at the halves; mxtpu's jnp.round rounds them to
    even. Elsewhere the two agree."""
    x = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.49999997, 2.4, -3.7],
                 np.float32)
    got = torch_op("round").fn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        got, [1, -1, 2, -2, 3, -3, 0, 2, -4])
    want = np.asarray(jax_op("round").fn(jnp.asarray(x)))
    np.testing.assert_array_equal(want, [0, -0, 2, -2, 2, -2, 0, 2, -4])
    np.testing.assert_array_equal(got[6:], want[6:])
    # and as the sweep's own reference rounds the halves (its float sum
    # would round 0.49999997 up)
    np.testing.assert_array_equal(got[:6], np.floor(np.abs(x[:6]) + 0.5)
                                  * np.sign(x[:6]))


def test_gamma_is_signed():
    """MXNet's gamma (tgamma) is negative where Gamma is; mxtpu's
    exp(gammaln(x)) is |Gamma(x)|. They agree where Gamma > 0."""
    x = np.array([-0.5, -2.5, -1.5, 0.5, 3.0], np.float32)
    got = torch_op("gamma").fn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, [math.gamma(v) for v in x], rtol=1e-5)
    assert got[0] < 0 and got[1] < 0 and got[2] > 0
    want = np.asarray(jax_op("gamma").fn(jnp.asarray(x)))
    np.testing.assert_allclose(want, np.abs(got), rtol=1e-5)
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-5)


def test_upsampling_sum_mode():
    """multi_input_mode="sum" adds the upsampled inputs (MXNet's rule;
    mxtpu concatenates them in either mode); an input of another size is
    upsampled by its own factor to the first's output size."""
    r = np.random.RandomState(3)
    a, b, c = u(r, 1, 2, 3, 3), u(r, 1, 2, 3, 3), u(r, 1, 2, 6, 6)
    up = torch_op("UpSampling").fn
    got = up(*[torch.from_numpy(v) for v in (a, b, c)], scale=2,
             num_args=3, multi_input_mode="sum").numpy()
    rep = lambda v, s: v.repeat(s, axis=2).repeat(s, axis=3)  # noqa: E731
    np.testing.assert_allclose(got, rep(a, 2) + rep(b, 2) + c, rtol=1e-6)
    cat = up(*[torch.from_numpy(v) for v in (a, c)], scale=2,
             num_args=2).numpy()
    np.testing.assert_array_equal(cat, np.concatenate([rep(a, 2), c], 1))


def test_depth_to_space_is_dcr():
    """DCR order, which torch's pixel_shuffle (CRD) does not give."""
    x = torch.arange(2 * 8 * 2 * 2, dtype=torch.float32).reshape(2, 8, 2, 2)
    got = torch_op("depth_to_space").fn(x, block_size=2)
    assert not torch.equal(got, torch.nn.functional.pixel_shuffle(x, 2))
    back = torch_op("space_to_depth").fn(got, block_size=2)
    assert torch.equal(back, x)


def test_norm_gradient_at_zero():
    """sqrt(sum(x^2))'s gradient at x = 0 is NaN in both packages."""
    x = np.zeros((2, 3), np.float32)
    _, _, tg, jg = run_both("norm", [x], dict(axis=1), (0,))
    assert np.isnan(tg[0]).all() and np.isnan(jg[0]).all()


def test_shape_array_int64():
    """shape_array and size_array give int64 (MXNet's dtype; mxtpu's
    int32 is JAX's widest without x64), the same values."""
    x = torch.zeros(3, 4, 5)
    sa = torch_op("shape_array").fn(x)
    assert sa.dtype == torch.int64 and sa.tolist() == [3, 4, 5]
    assert torch_op("size_array").fn(x).tolist() == [60]
    assert not torch_op("shape_array").differentiable


def test_bilinear_initializer_matches_mxtpu():
    shape = (3, 2, 16, 16)
    a = mt.nd.zeros(shape, ctx=mt.cpu())
    mt.init.Bilinear()(mt.init.InitDesc("up_weight"), a)
    b = mx.nd.zeros(shape)
    mx.init.Bilinear()(mx.init.InitDesc("up_weight"), b)
    np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=0, atol=1e-7)


def test_symbols_of_the_new_ops():
    """The symbol layer: Deconvolution makes a weight and no bias by
    default, Crop takes a second data input and makes no variable for it,
    the regression and SVM heads make ``<name>_label``, and shapes infer
    as mxtpu infers them."""
    for pkg in (mt, mx):
        data, like = pkg.sym.var("data"), pkg.sym.var("like")
        d = pkg.sym.Deconvolution(data, kernel=(4, 4), stride=(2, 2),
                                  num_filter=3, name="up")
        c = pkg.sym.Crop(d, like, offset=(1, 1), name="crop")
        h = pkg.sym.LogisticRegressionOutput(pkg.sym.flatten(c), name="out")
        s = pkg.sym.SVMOutput(pkg.sym.flatten(c), name="svm")
        n = pkg.sym.LayerNorm(c, name="ln")
        assert h.list_arguments() == ["data", "up_weight", "like",
                                      "out_label"], pkg
        assert s.list_arguments()[-1] == "svm_label"
        assert n.list_arguments()[-2:] == ["ln_gamma", "ln_beta"]
        args, outs, _ = h.infer_shape(data=(2, 5, 4, 4), like=(2, 1, 7, 6))
        assert dict(zip(h.list_arguments(), args)) == {
            "data": (2, 5, 4, 4), "up_weight": (5, 3, 4, 4),
            "like": (2, 1, 7, 6), "out_label": (2, 126)}, pkg
        assert outs == [(2, 126)]
        b = pkg.sym.Deconvolution(data, kernel=(2, 2), num_filter=3,
                                  no_bias=False, name="b")
        assert b.list_arguments() == ["data", "b_weight", "b_bias"]


def test_card_sweep_table_covers_the_registry():
    """chip_smoke.py's table of inputs for the sweep on the card has one
    row for every op the port registers, and no other."""
    from mxtpu_torch.ops.registry import _REGISTRY
    names = {op.name for op in _REGISTRY.values()}
    assert set(CS.CARD_SWEEP) == names, sorted(set(CS.CARD_SWEEP) ^ names)


@pytest.mark.parametrize("name", sorted(CS.CARD_SWEEP))
def test_card_sweep_row(name):
    """Each row runs through mt.nd on cpu(), forward and (where the op is
    differentiable) backward, with finite floats, the same twice (the
    card's run compares gpu(0) with this)."""
    CS.sweep_register(mt)
    outs, grads = CS.sweep_row(mt, name, mt.cpu())
    again = CS.sweep_row(mt, name, mt.cpu())
    assert outs and len(again[0]) == len(outs)
    for got, want in zip(outs + grads, again[0] + again[1]):
        assert CS.sweep_close(got, want) is None
        if got.dtype.kind == "f":
            assert np.isfinite(got).all() or name in ("norm",)
    if torch_op(name).differentiable and any(
            a.dtype.kind == "f" for a in CS.CARD_SWEEP[name][0](
                np.random.RandomState(0)) if isinstance(a, np.ndarray)):
        # a gradient that is zero by design: the rest must carry one
        assert grads and (any(np.abs(g).sum() > 0 for g in grads) or name
                          in ("BlockGrad", "zeros_like", "ones_like")), name
