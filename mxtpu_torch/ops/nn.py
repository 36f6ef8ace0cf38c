"""Neural-network ops of the PyTorch port.

Counterpart of the main-path ops of ``mxtpu/ops/nn.py``:
FullyConnected, Convolution, Pooling, Activation, LeakyReLU, softmax,
log_softmax, Embedding, Dropout, BatchNorm and SoftmaxOutput, whose
backward is ``mxtpu``'s (a ``torch.autograd.Function`` in place of its
``custom_vjp``); L2Normalization and BlockGrad, which SSD uses; MakeLoss
and identity, which multi-output graphs use; Deconvolution and
UpSampling, which fully convolutional nets use; SoftmaxActivation,
LayerNorm, InstanceNorm and LRN; and the other loss heads with
``mxtpu``'s own backward (the three regression outputs, SVMOutput).
None of them is a Pallas kernel in ``mxtpu`` (XLA lowers them there), so
here they are PyTorch's own calls: ``torch.matmul``, ``index_select``,
``F.conv*d`` / ``F.conv_transpose*d`` / ``F.max_pool*d`` /
``F.avg_pool*d`` (cuDNN on the card) and ``torch.native_batch_norm``,
the same call on the CPU and the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import next_generator, register


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
            gen = next_generator()
            u = torch.empty(data.shape, device=gen.device).uniform_(
                lower_bound, upper_bound, generator=gen)
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
    gen = next_generator()
    mask = torch.rand(shape, generator=gen, device=gen.device) \
        .to(data.device) < keep
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
        ctx.opts = opts
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
        ctx.grad, ctx.grad_scale = grad, grad_scale
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
        ctx.opts = (margin, coef, use_linear)
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
        ctx.grad_scale, ctx.per_batch = grad_scale, per_batch
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
