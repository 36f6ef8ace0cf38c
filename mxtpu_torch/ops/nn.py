"""Neural-network ops of the PyTorch port.

Counterpart of the main-path ops of ``mxtpu/ops/nn.py``:
FullyConnected, Convolution, Pooling, Activation, LeakyReLU, softmax,
log_softmax, Embedding, Dropout, BatchNorm and SoftmaxOutput, whose
backward is ``mxtpu``'s (a ``torch.autograd.Function`` in place of its
``custom_vjp``); L2Normalization and BlockGrad, which SSD uses; MakeLoss
and identity, which multi-output graphs use; Deconvolution and
UpSampling, which fully convolutional nets use; SoftmaxActivation,
LayerNorm, InstanceNorm and LRN; the other loss heads with
``mxtpu``'s own backward (the three regression outputs, SVMOutput); and
``cached_attention`` (the decode primitive of generation, ALiBi
included) and ``moe_ffn``, which the char LM and the MoE transformer use.
None of them is a Pallas kernel in ``mxtpu`` (XLA lowers them there), so
here they are PyTorch's own calls: ``torch.matmul`` / ``torch.bmm``,
``index_select``, ``F.conv*d`` / ``F.conv_transpose*d`` /
``F.max_pool*d`` / ``F.avg_pool*d`` (cuDNN on the card) and
``torch.native_batch_norm``, the same call on the CPU and the card.
"""
from __future__ import annotations

import math
import threading

import torch
import torch.nn.functional as F

from .registry import draw, register


@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


def _tuple(v, n):
    """A per-spatial-dim parameter as an n-tuple (``mxtpu``'s ``_pair``)."""
    if isinstance(v, int):
        return (v,) * n
    v = tuple(v)
    return v if v else (1,) * n


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", aliases=("convolution",))
def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                workspace=1024, cudnn_tune=None, cudnn_off=False,
                layout=None):
    """N-d convolution over NC(D)(H)W data; the weight is (num_filter,
    C/num_group, *kernel), as in ``mxtpu``."""
    nsp = data.dim() - 2
    stride = _tuple(stride, nsp) if stride else (1,) * nsp
    dilate = _tuple(dilate, nsp) if dilate else (1,) * nsp
    pad = _tuple(pad, nsp) if pad else (0,) * nsp
    b = bias if bias is not None and not no_bias else None
    return _CONV[nsp](data, weight, b, stride, pad, dilate, num_group)


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def deconv_geometry(in_spatial, kernel, stride, dilate, pad, adj,
                    target_shape):
    """(pad, adj) of a Deconvolution: as given, unless a non-zero
    ``target_shape`` overrides both, solved from out = (in - 1) s - 2 p +
    k_eff + adj with adj in {0, 1} as ``mxtpu`` (after MXNet's InferPad)
    solves it; a target larger than the zero-pad output raises."""
    nsp = len(in_spatial)
    if not (target_shape and any(_tuple(target_shape, nsp))):
        return pad, adj
    target_shape = _tuple(target_shape, nsp)
    pads, adjs = [], []
    for i in range(nsp):
        k_eff = (kernel[i] - 1) * dilate[i] + 1
        full = (in_spatial[i] - 1) * stride[i] + k_eff
        excess = full - target_shape[i]
        if excess < 0:
            raise ValueError(
                "too big target shape: target_shape[%d]=%d exceeds the "
                "maximum achievable output %d for input %d, stride %d, "
                "kernel %d, dilate %d" % (i, target_shape[i], full,
                                          in_spatial[i], stride[i],
                                          kernel[i], dilate[i]))
        p = (excess + 1) // 2
        pads.append(p)
        adjs.append(2 * p - excess)
    return tuple(pads), tuple(adjs)


@register("Deconvolution", aliases=("deconvolution",))
def deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), target_shape=(), num_filter=0, num_group=1,
                  no_bias=True, workspace=512, cudnn_tune=None,
                  cudnn_off=False, layout=None):
    """Transposed N-d convolution (1-, 2- or 3-d) over NC(D)(H)W data.
    The weight is (C_in, num_filter/num_group, *kernel), as in MXNet and
    ``mxtpu``, which is ``F.conv_transpose*d``'s layout; the output is
    (in - 1) s - 2 p + (k - 1) d + 1 + adj a spatial dim. The bias counts
    only with ``no_bias=False`` (MXNet's default is bias-less). Where
    torch refuses ``adj`` (not below the stride or the dilation), the
    full transposed convolution is cut to the window, with zeros past
    its end, as ``mxtpu``'s padded correlation gives them."""
    nsp = data.dim() - 2
    stride = _tuple(stride, nsp) if stride else (1,) * nsp
    dilate = _tuple(dilate, nsp) if dilate else (1,) * nsp
    pad = _tuple(pad, nsp) if pad else (0,) * nsp
    adj = _tuple(adj, nsp) if adj else (0,) * nsp
    kernel = _tuple(kernel, nsp) if kernel else tuple(weight.shape[2:])
    pad, adj = deconv_geometry(tuple(data.shape[2:]), kernel, stride,
                               dilate, pad, adj, target_shape)
    b = bias if bias is not None and not no_bias else None
    if all(a < max(s, d) for a, s, d in zip(adj, stride, dilate)):
        return _CONV_T[nsp](data, weight, b, stride, pad, adj, num_group,
                            dilate)
    out = _CONV_T[nsp](data, weight, b, stride, 0, 0, num_group, dilate)
    for i in range(nsp):
        size = out.shape[2 + i] - 2 * pad[i] + adj[i]
        keep = min(size, out.shape[2 + i] - pad[i])
        out = out.narrow(2 + i, pad[i], keep)
        if keep < size:
            shape = list(out.shape)
            shape[2 + i] = size - keep
            fill = torch.zeros(shape, dtype=out.dtype, device=out.device)
            if b is not None:
                fill = fill + b.reshape((1, -1) + (1,) * nsp)
            out = torch.cat([out, fill], dim=2 + i)
    return out


def _pool_sum(x, kernel, stride):
    """Sum over each window of padded ``x`` (no further padding)."""
    if len(kernel) == 1:        # avg_pool1d has no divisor_override
        return F.avg_pool2d(x.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                            divisor_override=1).squeeze(-2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@register("Pooling", aliases=("pooling",))
def pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
            pad=(), pooling_convention="valid", cudnn_off=False,
            count_include_pad=True):
    """Max, average or sum pooling with ``mxtpu``'s window rules: the
    edges padded explicitly (-inf for max, 0 otherwise), ``full``
    padding the high edge so that the windows cover the input (ceil
    mode), and ``avg`` dividing by the window size, or by the real
    elements in it when ``count_include_pad`` is off."""
    nsp = data.dim() - 2
    if global_pool:
        kernel = tuple(data.shape[2:])
        stride = (1,) * nsp
        pad = (0,) * nsp
    else:
        kernel = _tuple(kernel, nsp)
        stride = _tuple(stride, nsp) if stride else (1,) * nsp
        pad = _tuple(pad, nsp) if pad else (0,) * nsp
    edges = []                  # (low, high) a spatial dim
    for i in range(nsp):
        high = pad[i]
        if pooling_convention == "full":
            size = data.shape[2 + i] + 2 * pad[i]
            out = -(-(size - kernel[i]) // stride[i]) + 1
            high += max((out - 1) * stride[i] + kernel[i] - size, 0)
        edges.append((pad[i], high))
    flat = [p for lo_hi in reversed(edges) for p in lo_hi]  # F.pad order
    padded = any(flat)
    if pool_type == "max":
        fill = -math.inf if data.is_floating_point()             else torch.iinfo(data.dtype).min
        x = F.pad(data, flat, value=fill) if padded else data
        return _MAX_POOL[nsp](x, kernel, stride)
    if pool_type not in ("avg", "sum"):
        raise ValueError("unknown pool_type %r" % pool_type)
    summed = _pool_sum(F.pad(data, flat) if padded else data, kernel,
                       stride)
    if pool_type == "sum":
        return summed
    if count_include_pad:
        return summed / math.prod(kernel)
    ones = torch.ones_like(data)
    return summed / _pool_sum(F.pad(ones, flat) if padded else ones, kernel,
                              stride)


def relu(data):
    """max(data, 0) with ``jnp.maximum``'s gradient: g where data > 0, g/2
    where data == 0 (torch.maximum splits a tie as JAX does)."""
    return torch.maximum(data, data.new_zeros(()))


@register("Activation", aliases=("activation",))
def activation(data, act_type="relu"):
    if act_type == "relu":
        return relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return torch.logaddexp(data, torch.zeros_like(data))
    if act_type == "softsign":
        return data / (1 + torch.abs(data))
    raise ValueError("unknown act_type %r" % act_type)


@register("LeakyReLU", needs_train_flag=True, stateful=True)
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, _training=False):
    """``mxtpu``'s LeakyReLU family: leaky, elu, selu, prelu (``gamma`` a
    slope a channel, axis 1) and rrelu (a slope drawn from U[lower,
    upper) an element in training, their mean otherwise)."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(data >= 0, data,
                                   alpha * torch.expm1(data))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.where(data >= 0, data, g * data)
    if act_type == "rrelu":
        if _training:
            u = draw(lambda gen: torch.empty(
                data.shape, device=gen.device).uniform_(
                    lower_bound, upper_bound, generator=gen))
            return torch.where(data >= 0, data,
                               u.to(device=data.device, dtype=data.dtype)
                               * data)
        return torch.where(data >= 0, data,
                           (lower_bound + upper_bound) / 2.0 * data)
    raise ValueError("unknown act_type %r" % act_type)


@register("softmax")
def softmax(data, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


@register("SoftmaxActivation")
def softmax_activation(data, mode="instance"):
    """Softmax over the channels (``channel``) or over all but the batch
    axis (``instance``)."""
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


@register("LayerNorm")
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """(x - mean) / sqrt(var + eps) * gamma + beta over ``axis``, with the
    biased variance, computed in float32 and returned in the data's
    dtype, as ``mxtpu`` computes it."""
    f = torch.promote_types(data.dtype, torch.float32)
    x = data.to(f)
    axis = axis % data.dim()
    mean = x.mean(dim=axis, keepdim=True)
    var = x.var(dim=axis, unbiased=False, keepdim=True)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    out = (x - mean) * torch.rsqrt(var + eps)
    out = out * gamma.to(f).reshape(shape) + beta.to(f).reshape(shape)
    return out.to(data.dtype)


@register("InstanceNorm")
def instance_norm(data, gamma, beta, eps=1e-3):
    """Each sample's channel normalised over its spatial axes (biased
    variance), then scaled by gamma and shifted by beta a channel."""
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = data.var(dim=red, unbiased=False, keepdim=True)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return (data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


@register("LRN")
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalisation across channels: x / (knorm + alpha
    / nsize * sum of x^2 over the nsize channels around) ^ beta."""
    sq = torch.square(data)
    half = nsize // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    window = torch.zeros_like(sq)
    for i in range(nsize):
        window = window + padded.narrow(1, i, data.shape[1])
    return data * torch.pow(knorm + alpha * window / nsize, -beta)


@register("UpSampling")
def upsampling(*args, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=512):
    """Nearest: each input repeated up to the first input's size times
    ``scale`` (an input of another size by its own factor, as MXNet
    does), then concatenated over the channels, or summed with
    ``multi_input_mode="sum"`` (``mxtpu`` concatenates in either mode).
    Bilinear: the data resized by ``scale`` with linear interpolation
    (half-pixel centres), as ``mxtpu``'s ``jax.image.resize`` does; the
    weight input is accepted and, as there, not used."""
    data = args[0]
    if sample_type == "nearest":
        oh, ow = data.shape[2] * scale, data.shape[3] * scale
        outs = [torch.repeat_interleave(torch.repeat_interleave(
            a, oh // a.shape[2], dim=2), ow // a.shape[3], dim=3)
            for a in args]
        if len(outs) == 1:
            return outs[0]
        if multi_input_mode == "sum":
            out = outs[0]
            for o in outs[1:]:
                out = out + o
            return out
        return torch.cat(outs, dim=1)
    return F.interpolate(data, scale_factor=scale, mode="bilinear",
                         align_corners=False)


def _take_fill(dtype):
    """``jnp.take``'s fill value for an index out of range: NaN for a
    floating table, the most negative value for a signed one, the largest
    for an unsigned one."""
    if dtype.is_floating_point:
        return float("nan")
    info = torch.iinfo(dtype)
    return info.min if info.min < 0 else info.max


@register("Embedding")
def embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    """Rows of ``weight`` as ``jnp.take`` picks them: a negative id counts
    from the end once, and an id still outside [0, rows) gives a row of
    ``_take_fill`` (no gradient) instead of raising, so no device-side
    assert can end the card's context."""
    rows = weight.shape[0]
    idx = data.reshape(-1).to(torch.int64)
    idx = torch.where(idx < 0, idx + rows, idx)
    valid = (idx >= 0) & (idx < rows)
    picked = weight.index_select(0, torch.where(valid, idx, 0))
    picked = torch.where(valid[:, None], picked,
                         torch.full((), _take_fill(weight.dtype),
                                    dtype=weight.dtype, device=weight.device))
    return picked.reshape(tuple(data.shape) + (weight.shape[1],))


@register("Dropout", stateful=True, needs_train_flag=True)
def dropout(data, p=0.5, mode="training", axes=(), _training=False):
    """Inverted dropout (``mxtpu``'s Dropout): in training, or always
    with ``mode="always"``, each element kept with probability 1 - p and
    scaled by 1 / (1 - p), one draw a mask element (``axes`` broadcast
    the mask) from the step's generator; otherwise the identity."""
    if p == 0.0 or (not _training and mode != "always"):
        return data
    shape = list(data.shape)
    for ax in axes:
        shape[ax] = 1
    keep = 1.0 - p
    mask = draw(lambda gen: torch.rand(
        shape, generator=gen, device=gen.device)).to(data.device) < keep
    return torch.where(mask, data / keep, torch.zeros_like(data))


class _BatchNormTrain(torch.autograd.Function):
    """Batch normalisation over dim 1 with the batch's statistics:
    ``(out, mean, invstd)``, invstd = 1/sqrt(biased var + eps), by
    ``torch.native_batch_norm`` (no running statistics). Its backward is
    ``native_batch_norm_backward`` for ``out``, plus what ``mean`` and
    ``invstd`` pass back to the data when they are used downstream
    (``output_mean_var``): ``mxtpu`` differentiates them as ``jnp.mean``
    and ``jnp.var`` are differentiated."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        out, mean, invstd = torch.native_batch_norm(x, gamma, beta, None,
                                                    None, True, 0.0, eps)
        ctx.save_for_backward(x, gamma, mean, invstd)
        ctx.eps = eps
        ctx.set_materialize_grads(False)
        return out, mean, invstd

    @staticmethod
    def backward(ctx, g_out, g_mean, g_invstd):
        x, gamma, mean, invstd = ctx.saved_tensors
        need = ctx.needs_input_grad
        dx = dgamma = dbeta = None
        if g_out is not None:
            dx, dgamma, dbeta = torch.ops.aten.native_batch_norm_backward(
                g_out, x, gamma, None, None, mean, invstd, True, ctx.eps,
                [need[0], need[1], need[2]])
        if need[0] and (g_mean is not None or g_invstd is not None):
            shape = (1, -1) + (1,) * (x.dim() - 2)
            m = x.numel() // x.shape[1]
            extra = torch.zeros_like(x) if dx is None else dx
            if g_mean is not None:
                extra = extra + (g_mean / m).reshape(shape)
            if g_invstd is not None:
                # d invstd / d x = -invstd^3 (x - mean) / m
                extra = extra - (g_invstd * invstd.pow(3) / m).reshape(
                    shape) * (x - mean.reshape(shape))
            dx = extra
        if g_out is None:
            dgamma = torch.zeros_like(gamma) if need[1] else None
            dbeta = torch.zeros_like(gamma) if need[2] else None
        return dx, dgamma, dbeta, None


def _bn_outputs(params):
    return 3 if params.get("output_mean_var") else 1


@register("BatchNorm", aliases=("batch_norm", "BatchNorm_v1"),
          num_outputs=5, user_outputs=_bn_outputs, aux_update={3: 3, 4: 4},
          needs_train_flag=True)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               _training=False):
    """``mxtpu``'s BatchNorm: ``(out, mean, invstd, new moving mean, new
    moving var)``. In training (unless ``use_global_stats``) it
    normalises with the batch's mean and biased variance and blends them
    into the moving statistics as ``old * momentum + batch * (1 -
    momentum)``; otherwise it normalises with the moving statistics,
    which stay. Statistics and arithmetic run in float32 for any input
    dtype, and ``out`` keeps the input's. ``fix_gamma`` uses ones for
    gamma (whose gradient is then zero); ``axis`` is the channel axis.
    The moving statistics are computed here, not by torch, whose running
    variance is the unbiased one, blended the other way round."""
    axis = axis % data.dim()
    # float32 at least (float64 stays: mxtpu has no float64 arrays)
    f = torch.promote_types(data.dtype, torch.float32)
    x32 = torch.movedim(data.to(f), axis, 1)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    g, b = g.to(f), beta.to(f)
    if _training and not use_global_stats:
        out, mean, invstd = _BatchNormTrain.apply(x32, g, b, float(eps))
        var = invstd.pow(-2) - eps      # the biased batch variance
        new_mm = (moving_mean.to(f) * momentum
                  + mean * (1 - momentum)).to(moving_mean.dtype)
        new_mv = (moving_var.to(f) * momentum
                  + var * (1 - momentum)).to(moving_var.dtype)
    else:
        # the moving statistics enter detached: their gradients are zero,
        # as in mxtpu, which never differentiates an aux input, and
        # F.batch_norm refuses running statistics that require a gradient
        mm, mv = moving_mean.detach(), moving_var.detach()
        mean, new_mm, new_mv = mm, moving_mean, moving_var
        invstd = torch.rsqrt(mv.to(f) + eps)
        out = F.batch_norm(x32, mm.to(f), mv.to(f), g, b, False, 0.0, eps)
    out = torch.movedim(out, 1, axis).to(data.dtype)
    return out, mean, invstd, new_mm, new_mv


def _one_hot(label, n, dtype):
    """``jax.nn.one_hot``: a label outside [0, n) gives a zero row."""
    return (label[..., None] == torch.arange(n, device=label.device)) \
        .to(dtype)


# The loss scale of the step being traced (the fused step's
# MXTPU_AMP_LOSS_SCALE). The loss heads below ignore their head gradient,
# so a scale put into the heads' cotangent never reaches their inputs:
# each multiplies its gradient by the scale in force at its forward
# instead, while an output that honours its head gradient gets the scale
# through the cotangent.
_LOSS_SCALE = threading.local()


class loss_scale:
    """Within it, the loss heads' gradients are multiplied by ``scale``."""

    def __init__(self, scale):
        self.scale = float(scale)

    def __enter__(self):
        self.old = getattr(_LOSS_SCALE, "value", 1.0)
        _LOSS_SCALE.value = self.scale

    def __exit__(self, *exc):
        _LOSS_SCALE.value = self.old


def _head_scale():
    return getattr(_LOSS_SCALE, "value", 1.0)


def _softmax_output_grad(out, label, g, grad_scale, ignore_label,
                         multi_output, use_ignore, preserve_shape,
                         normalization, out_grad, smooth_alpha):
    """The gradient of SoftmaxOutput with respect to its data, as the
    backward of ``mxtpu/ops/nn.py``'s ``_make_softmax_output`` computes
    it: softmax - onehot(label), smoothed, masked, normalized and scaled;
    the head gradient ``g`` counts only under ``out_grad``
    (``preserve_shape`` only picks the forward's axis)."""
    if multi_output:
        # data (B, C, ...), label (B, ...)
        C = out.shape[1]
        onehot = torch.movedim(_one_hot(label.to(torch.int32), C, out.dtype),
                               -1, 1)
        grad = out - onehot
        if smooth_alpha:
            grad = grad + smooth_alpha * (onehot - 1.0 / C)
        if use_ignore:
            mask = (label != ignore_label).to(out.dtype)
            grad = grad * mask.unsqueeze(1)
        valid = (label != ignore_label).sum() if use_ignore \
            else label.numel()
    else:
        C = out.shape[-1]
        flat = out.reshape(out.shape[0], -1)
        onehot = _one_hot(label.reshape(-1).to(torch.int32), flat.shape[-1],
                          out.dtype)
        grad = (flat - onehot).reshape(out.shape)
        if smooth_alpha:
            grad = grad + smooth_alpha * (onehot.reshape(out.shape) - 1.0 / C)
        if use_ignore:
            mask = (label != ignore_label).to(out.dtype).reshape(
                (-1,) + (1,) * (out.dim() - 1))
            grad = grad * mask
        valid = (label != ignore_label).sum() if use_ignore \
            else label.shape[0]
    if normalization == "valid":
        grad = grad / torch.as_tensor(valid, device=out.device).clamp(
            min=1).to(out.dtype)
    elif normalization == "batch":
        grad = grad / out.shape[0]
    grad = grad * grad_scale
    if out_grad:
        grad = grad * g
    return grad.to(out.dtype)


class _SoftmaxOutput(torch.autograd.Function):
    """Softmax forward; the backward of :func:`_softmax_output_grad`.
    The label gets a zero gradient."""

    @staticmethod
    def forward(ctx, data, label, opts):
        if opts["multi_output"]:
            out = torch.softmax(data, dim=1)
        elif opts["preserve_shape"]:
            out = torch.softmax(data, dim=-1)
        else:
            out = torch.softmax(data.reshape(data.shape[0], -1),
                                dim=-1).reshape(data.shape)
        ctx.save_for_backward(out, label)
        # under out_grad the head gradient carries the loss scale
        ctx.opts = opts if opts["out_grad"] else dict(
            opts, grad_scale=opts["grad_scale"] * _head_scale())
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return _softmax_output_grad(out, label, g, **ctx.opts), dlabel, None


@register("SoftmaxOutput", aliases=("Softmax",))
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax forward; backward is d(CE)/d(data) directly, ignoring the
    head gradient unless ``out_grad`` (``mxtpu``'s semantics, after
    src/operator/softmax_output-inl.h)."""
    opts = dict(grad_scale=float(grad_scale), ignore_label=float(ignore_label),
                multi_output=bool(multi_output), use_ignore=bool(use_ignore),
                preserve_shape=bool(preserve_shape),
                normalization=str(normalization), out_grad=bool(out_grad),
                smooth_alpha=float(smooth_alpha))
    return _SoftmaxOutput.apply(data, label, opts)


class _RegressionOutput(torch.autograd.Function):
    """A regression head: the forward ``fwd(data)``; the backward
    ``grad(out, label) * grad_scale / prod(shape[1:])`` whatever the head
    gradient, and zero for the label (``mxtpu``'s ``_regression``)."""

    @staticmethod
    def forward(ctx, data, label, fwd, grad, grad_scale):
        out = fwd(data)
        ctx.save_for_backward(out, label)
        ctx.grad, ctx.grad_scale = grad, grad_scale * _head_scale()
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        num = math.prod(out.shape[1:])
        d = ctx.grad(out, label.reshape(out.shape).to(out.dtype)) \
            * (ctx.grad_scale / num)
        dlabel = torch.zeros_like(label) if ctx.needs_input_grad[1] else None
        return d.to(out.dtype), dlabel, None, None, None


def _regression(name, fwd, grad, doc):
    def op(data, label, grad_scale=1.0):
        return _RegressionOutput.apply(data, label, fwd, grad,
                                       float(grad_scale))
    op.__name__ = name
    op.__doc__ = doc
    register(name)(op)


_regression("LinearRegressionOutput", lambda d: d, lambda o, l: o - l,
            "The identity forward; backward (out - label) / dim.")
_regression("MAERegressionOutput", lambda d: d,
            lambda o, l: torch.sign(o - l),
            "The identity forward; backward sign(out - label) / dim.")
_regression("LogisticRegressionOutput", torch.sigmoid, lambda o, l: o - l,
            "The sigmoid forward; backward (out - label) / dim.")


class _SVMOutput(torch.autograd.Function):
    """The identity forward; the hinge loss's gradient backward, whatever
    the head gradient (``mxtpu``'s ``svm_output``)."""

    @staticmethod
    def forward(ctx, data, label, margin, coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.opts = (margin, coef * _head_scale(), use_linear)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        d, l = ctx.saved_tensors
        margin, coef, use_linear = ctx.opts
        onehot = _one_hot(l.to(torch.int32), d.shape[1], d.dtype)
        score_t = torch.sum(d * onehot, dim=1, keepdim=True)
        slack = d - score_t + margin
        if use_linear:
            grad = torch.where(slack > 0, coef, 0.0).to(d.dtype)
        else:
            grad = torch.where(slack > 0, 2 * coef * slack,
                               torch.zeros_like(slack))
        grad = grad * (1 - onehot) - onehot * torch.sum(
            grad * (1 - onehot), dim=1, keepdim=True)
        dl = torch.zeros_like(l) if ctx.needs_input_grad[1] else None
        return grad.to(d.dtype), dl, None, None, None


@register("SVMOutput")
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """A large-margin head: the forward is the identity; the backward is
    the one-vs-rest hinge loss's gradient for each wrong class whose
    score is within ``margin`` of the true class's (linear with
    ``use_linear``, else squared), scaled by
    ``regularization_coefficient``, and minus their sum at the true
    class."""
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


@register("L2Normalization")
def l2_normalization(data, eps=1e-10, mode="instance"):
    """``data`` over sqrt(sum of squares + eps): over all but the batch
    axis (``instance``), over the channels (``channel``) or over the
    spatial axes (``spatial``)."""
    if mode == "instance":
        red = tuple(range(1, data.dim()))
    elif mode == "channel":
        red = (1,)
    else:
        red = tuple(range(2, data.dim()))
    return data / torch.sqrt(torch.sum(torch.square(data), dim=red,
                                       keepdim=True) + eps)


@register("BlockGrad", aliases=("stop_gradient",))
def block_grad(data):
    """``data``, with no gradient flowing back through it."""
    return data.detach()


class _MakeLoss(torch.autograd.Function):
    """The identity forward; the backward ``grad_scale`` everywhere, over
    the batch size when ``per_batch``, whatever the head gradient."""

    @staticmethod
    def forward(ctx, data, grad_scale, per_batch):
        ctx.grad_scale = grad_scale * _head_scale()
        ctx.per_batch = per_batch
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        grad = torch.full_like(g, ctx.grad_scale)
        if ctx.per_batch:
            grad = grad / g.shape[0]
        return grad, None, None


@register("MakeLoss", aliases=("make_loss",))
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Mark ``data`` as a loss: the forward is the identity, and the
    backward sends ``grad_scale`` to every element, divided by the batch
    size under ``normalization="batch"``, whatever gradient comes from
    above. These are ``mxtpu``'s semantics, which differ from MXNet's:
    MXNet's ``valid_thresh`` and ``normalization="valid"`` (divide by the
    count of elements above the threshold) change nothing here, as they
    change nothing in ``mxtpu``."""
    return _MakeLoss.apply(data, float(grad_scale), normalization == "batch")


@register("identity", aliases=("_copy", "copy"))
def identity(data):
    """A copy of ``data`` (its gradient passes through)."""
    return data.clone()


# ---------------------------------------------------------------------------
# KV-cached causal self-attention, the decode primitive of generation
# (``mxtpu/ops/nn.py`` cached_attention). One op serves training and both
# phases of generation: at pos=0 over zero caches with S >= T it is plain
# causal self-attention; a decode step at pos=p writes row p and attends
# rows s <= p. Rows past a true prompt length hold garbage, but the causal
# mask shows row j only once j <= pos of a later step, and the step at j
# overwrites row j before attending it.
#
# The functional form (training, and every call outside a static_cache
# scope) returns new cache tensors. Inside a static_cache scope, with no
# gradient recorded, the op writes the T new rows into the caches it was
# given and returns those same tensors: the generation programs keep their
# packed K-slot state as static tensors, so a decode step reads the cache
# once and writes T rows instead of copying it.
# ---------------------------------------------------------------------------

class _StaticCache(threading.local):
    def __init__(self):
        self.depth = 0


_STATIC_CACHE = _StaticCache()


class static_cache:
    """Scope in which ``cached_attention`` writes its caches in place."""

    def __enter__(self):
        _STATIC_CACHE.depth += 1
        return self

    def __exit__(self, *a):
        _STATIC_CACHE.depth -= 1


def _flag(v):
    """An op attribute read as ``mxtpu`` reads it: a symbol saved by
    either package stores ``True`` as the string ``"True"``."""
    return bool(v) and str(v).lower() not in ("false", "0")


def _alibi_slopes(heads, dtype, device):
    """ALiBi's slope of head i, ``2^(-8(i+1)/H)`` (Press et al.), made on
    ``device`` in float64 and rounded once, as ``mxtpu`` rounds its Python
    floats: no host-to-device copy, so a CUDA graph can capture it."""
    i = torch.arange(1, heads + 1, dtype=torch.float64, device=device)
    return torch.exp2(-8.0 * i / heads).to(dtype)


@register("cached_attention", num_outputs=3)
def cached_attention(query, key, value, k_cache, v_cache, pos, num_heads=1,
                     alibi=False):
    """query/key/value ``[B, T, D]``; caches ``[B, S, D]``; ``pos [B]``
    (each sample's write offset). Returns ``(out, k_cache_next,
    v_cache_next)``. The T rows are written at ``pos`` clamped into
    ``[0, S - T]``, as ``lax.dynamic_update_slice`` clamps, cast to the
    cache dtype; query row t of sample b attends cache rows ``s <= pos_b
    + t`` (the unclamped position), masked scores set to -1e30 before the
    softmax, scores divided by ``sqrt(hd)`` in the query dtype.
    ``alibi`` subtracts ``2^(-8(i+1)/H) * ((pos + t) - s)`` from head i's
    scores: absolute positions, so a prefill chunk and a decode step see
    the same bias. The write offsets are built on the device from
    ``pos``: no host read."""
    p = pos.to(torch.int32).reshape(-1)
    B, T, D = query.shape
    S = k_cache.shape[1]
    H = int(num_heads)
    hd = D // H
    dev = query.device
    t_idx = torch.arange(T, dtype=torch.int32, device=dev)
    start = torch.clamp(p, 0, max(S - T, 0))
    rows = (start[:, None] + t_idx[None, :]).long()            # [B, T]
    index = rows[:, :, None].expand(B, T, D)
    key_c = key.to(k_cache.dtype)
    value_c = value.to(v_cache.dtype)
    if _STATIC_CACHE.depth and not torch.is_grad_enabled():
        new_k = k_cache.scatter_(1, index, key_c)
        new_v = v_cache.scatter_(1, index, value_c)
    else:
        new_k = k_cache.scatter(1, index, key_c)
        new_v = v_cache.scatter(1, index, value_c)
    kq = new_k.to(query.dtype)
    vq = new_v.to(query.dtype)
    # one product a head over its column slice of the caches: a strided
    # view cuBLAS reads in place, where a heads-first einsum would copy
    # the whole cache into another layout first
    heads = [slice(h * hd, (h + 1) * hd) for h in range(H)]
    scores = torch.stack([torch.bmm(query[:, :, c], kq[:, :, c].transpose(
        1, 2)) for c in heads], dim=1) / torch.full(
        (), float(hd), dtype=query.dtype, device=dev).sqrt()
    s_idx = torch.arange(S, dtype=torch.int32, device=dev)[None, None, :]
    q_abs = p[:, None, None] + t_idx[None, :, None]            # [B, T, 1]
    allowed = s_idx <= q_abs                                   # [B, T, S]
    if _flag(alibi):
        slopes = _alibi_slopes(H, scores.dtype, dev)
        dist = (q_abs - s_idx).to(scores.dtype)                # [B, T, S]
        scores = scores - slopes[None, :, None, None] * dist[:, None]
    scores = torch.where(allowed[:, None, :, :], scores,
                         torch.full((), -1e30, dtype=scores.dtype,
                                    device=dev))
    att = torch.softmax(scores, dim=-1)
    out = torch.cat([torch.bmm(att[:, h], vq[:, :, c])
                     for h, c in enumerate(heads)], dim=-1)
    return out.to(query.dtype), new_k, new_v


@register("moe_ffn", num_outputs=2)
def moe_ffn(data, gate_weight, w1, b1, w2, b2, capacity_factor=1.25,
            num_selected=1):
    """Expert feed-forward over the token dimension (``mxtpu``'s op over
    :func:`mxtpu_torch.parallel.moe.moe_ffn`). ``data [B, T, D]`` (or
    ``[T, D]``); ``gate_weight [D, E]``; ``w1 [E, D, H]``; ``b1 [E, H]``;
    ``w2 [E, H, D]``; ``b2 [E, D]``. Returns ``(y, aux)``: y shaped like
    data, aux the ``(1,)`` Switch load-balancing loss."""
    from ..parallel.moe import moe_ffn as _moe_ffn
    shape = data.shape
    x = data.reshape(-1, shape[-1])
    y, aux = _moe_ffn(x, gate_weight, w1, b1, w2, b2,
                      capacity_factor=float(capacity_factor),
                      num_selected=int(num_selected))
    return y.reshape(shape).to(data.dtype), aux.reshape(1)


@register("ctc_loss", aliases=("CTCLoss", "_contrib_ctc_loss",
                               "_contrib_CTCLoss"))
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """CTC negative log-likelihood a sample, ``(N,)`` in the data's dtype
    (``mxtpu``'s op, ``mxtpu/ops/nn.py:789``): ``data (T, N, C)``
    unnormalised (log_softmax applied here, in float32), ``label (N,
    L)`` padded with 0 (blank "first") or -1 (blank "last"). The lengths
    are read whenever given, whatever the ``use_*`` flags say.

    The log-space forward DP over the extended label (blanks between
    and around the symbols; S = 2L + 1 states) runs as plain torch ops on
    ``(N, S)`` tensors a time step, so a captured step records the loop
    and autograd gives the backward. As in ``mxtpu``: impossible paths
    hold -1e30, not -inf (a label too long for its frames gives a large
    finite loss), ``lse3`` floors its maximum at -1e30, a negative
    index wraps (-1 is the last class or step) and an empty label
    counts its one all-blank path once."""
    T, N, C = data.shape
    L = label.shape[1]
    S = 2 * L + 1
    dev = data.device
    logp = torch.log_softmax(data.float(), dim=2)
    lab = label.to(torch.int64)
    blank = 0 if blank_label == "first" else C - 1
    lab_valid = lab > 0 if blank == 0 else lab >= 0
    lab_len = label_lengths.to(torch.int64) if label_lengths is not None \
        else lab_valid.to(torch.int64).sum(1)
    t_len = data_lengths.to(torch.int64) if data_lengths is not None \
        else torch.full((N,), T, dtype=torch.int64, device=dev)

    # made on the device: a copy from the host would be refused inside a
    # CUDA graph capture
    neg_inf = torch.full((), -1e30, dtype=torch.float32, device=dev)
    s_idx = torch.arange(S, device=dev)
    lab_pos = torch.clamp(torch.div(s_idx - 1, 2, rounding_mode="floor"),
                          min=0)
    ext = torch.where(s_idx[None, :] % 2 == 0,
                      torch.full((), blank, dtype=torch.int64, device=dev),
                      lab[:, lab_pos])                         # (N, S)
    ext = torch.where(ext < 0, ext + C, ext)
    ext_m2 = torch.cat([torch.full((N, 2), -1, dtype=torch.int64,
                                   device=dev), ext[:, :-2]], dim=1)
    allow_skip = (s_idx[None, :] % 2 == 1) & (ext != ext_m2)
    fill1 = neg_inf.expand(N, 1)
    fill2 = neg_inf.expand(N, 2)

    def lse3(a, b, c):
        m = torch.maximum(torch.maximum(a, b), c)
        m = torch.maximum(m, neg_inf)
        return m + torch.log(torch.exp(a - m) + torch.exp(b - m)
                             + torch.exp(c - m))

    # the virtual pre-start state: all mass at s = 0, nothing emitted
    alpha = torch.where(s_idx[None, :] == 0, torch.zeros((), device=dev),
                        neg_inf).expand(N, S)
    emits = torch.gather(logp, 2, ext[None].expand(T, N, S))   # (T, N, S)
    alphas = []
    for t in range(T):
        a2 = torch.cat([fill1, alpha[:, :-1]], dim=1)
        a3 = torch.where(allow_skip,
                         torch.cat([fill2, alpha[:, :-2]], dim=1), neg_inf)
        alpha = emits[t] + lse3(alpha, a2, a3)
        alphas.append(alpha)
    alphas = torch.stack(alphas)                               # (T, N, S)

    t_end = t_len - 1
    t_end = torch.where(t_end < 0, t_end + T, t_end)
    last = alphas.gather(0, t_end[None, :, None].expand(1, N, S))[0]
    end1 = last.gather(1, (2 * lab_len)[:, None])[:, 0]
    end2 = last.gather(1, torch.clamp(2 * lab_len - 1, min=0)[:, None])[:, 0]
    end2 = torch.where(lab_len > 0, end2, neg_inf)
    m = torch.maximum(end1, end2)
    ll = m + torch.log(torch.exp(end1 - m) + torch.exp(end2 - m))
    return (-ll).to(data.dtype)
