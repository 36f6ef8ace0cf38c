"""Neural-network ops of the PyTorch port.

Counterpart of the serving-path ops of ``mxtpu/ops/nn.py``:
FullyConnected, Activation, softmax, Embedding and SoftmaxOutput, whose
backward is ``mxtpu``'s (a ``torch.autograd.Function`` in place of its
``custom_vjp``).
None of them is a Pallas kernel in ``mxtpu`` (XLA lowers them there), so
here they are plain PyTorch: ``torch.matmul`` and ``index_select``.
"""
from __future__ import annotations

import torch

from .registry import register


@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


@register("Activation", aliases=("activation",))
def activation(data, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return torch.logaddexp(data, torch.zeros_like(data))
    if act_type == "softsign":
        return data / (1 + torch.abs(data))
    raise ValueError("unknown act_type %r" % act_type)


@register("softmax")
def softmax(data, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.softmax(x, dim=axis)


@register("Embedding")
def embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    idx = data.reshape(-1).to(torch.int64)
    return weight.index_select(0, idx).reshape(
        tuple(data.shape) + (weight.shape[1],))


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
