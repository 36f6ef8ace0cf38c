"""Shape ops of the PyTorch port.

Counterpart of the part of ``mxtpu/ops/shape_ops.py`` that the fused
RNN cell's ``unroll``, the serving graphs, LeNet and
``nd.concatenate`` emit: reshape (with MXNet's special codes), Flatten,
swapaxes, expand_dims, concat, stack, split, zeros_like, ones_like and
the nullary ``_zeros`` creator; ``pick``, which Gluon's
``SoftmaxCrossEntropyLoss`` takes its labels' entries with; and
``transpose`` and ``slice_axis``, which the SSD heads use; ``one_hot``
and ``cast`` (the Gluon vision transforms cast their images).
"""
from __future__ import annotations

import torch

from ..base import canonical_dtype
from .nn import _one_hot, _take_fill
from .registry import register


@register("reshape", aliases=("Reshape",))
def reshape(data, shape=None, reverse=False):
    """MXNet reshape incl. special codes 0 (keep), -1 (infer), -2 (copy
    rest), -3 (merge two), -4 (split). Same rules as mxtpu's reshape."""
    if shape is None:
        return data
    ishape = list(data.shape)
    if reverse:
        ishape = ishape[::-1]
        shape = tuple(shape)[::-1]
    out = []
    i = 0
    shape = list(shape)
    j = 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(ishape[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(ishape[i:])
            i = len(ishape)
        elif s == -3:
            out.append(ishape[i] * ishape[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = ishape[i] // b
            if b == -1:
                b = ishape[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(s)
            if i < len(ishape):
                i += 1
        j += 1
    if reverse:
        out = out[::-1]
    return torch.reshape(data, tuple(out))


@register("flatten", aliases=("Flatten",))
def flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


@register("transpose")
def transpose(data, axes=None):
    """Permute the axes (reverse them when ``axes`` is empty)."""
    if axes is None or tuple(axes) == ():
        axes = tuple(range(data.dim() - 1, -1, -1))
    return data.permute(*axes).contiguous()


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1=0, dim2=0):
    return torch.transpose(data, dim1, dim2).contiguous()


@register("expand_dims")
def expand_dims(data, axis=0):
    return torch.unsqueeze(data, axis)


@register("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    """``data[begin:end]`` along ``axis`` (Python's rules for negative
    and missing bounds)."""
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, end)
    return data[tuple(idx)]


@register("concat", aliases=("Concat",))
def concat(*args, dim=1):
    return torch.cat(args, dim=dim)


@register("stack")
def stack(*args, axis=0):
    return torch.stack(args, dim=axis)


@register("split", aliases=("SliceChannel",), num_outputs=None)
def split(data, num_outputs=2, axis=1, squeeze_axis=False):
    size = data.shape[axis]
    if size % num_outputs:
        raise ValueError("split: axis %d of size %d does not divide into %d"
                         % (axis, size, num_outputs))
    outs = torch.split(data, size // num_outputs, dim=axis)
    if squeeze_axis:
        outs = [torch.squeeze(o, dim=axis) for o in outs]
    return tuple(outs)


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """``data``'s element at ``index`` along ``axis``, as ``mxtpu``'s
    ``jnp.take_along_axis`` picks it: a negative index counts from the
    end once, and one still outside the axis gives NaN (no gradient)
    instead of raising, so no device-side assert can end the card's
    context. (``mode`` is accepted and, as in ``mxtpu``, not used.)"""
    axis = axis % data.dim()
    n = data.shape[axis]
    idx = index.to(torch.int64).unsqueeze(axis)
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = torch.gather(data, axis, torch.where(valid, idx, 0))
    out = torch.where(valid, out, torch.full((), _take_fill(out.dtype),
                                             dtype=out.dtype,
                                             device=out.device))
    return out if keepdims else out.squeeze(axis)


@register("one_hot", differentiable=False)
def one_hot(indices, depth=0, on_value=1.0, off_value=0.0, dtype="float32"):
    """``on_value`` at each index's place along a new last axis of
    ``depth``, ``off_value`` elsewhere; an index outside [0, depth) gives
    a row of ``off_value``, as ``jax.nn.one_hot`` does in ``mxtpu``."""
    oh = _one_hot(indices.to(torch.int32), int(depth), canonical_dtype(dtype))
    return oh * on_value + (1 - oh) * off_value


@register("cast", aliases=("Cast",))
def cast(data, dtype="float32"):
    """``data`` as ``dtype``."""
    return data.to(canonical_dtype(dtype))


@register("_zeros", needs_device=True)
def _zeros_op(shape=(), dtype="float32", _device=None):
    """Nullary zeros creator (symbolic begin_state)."""
    return torch.zeros(tuple(shape), dtype=canonical_dtype(dtype),
                       device=_device)


@register("zeros_like")
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like")
def ones_like(data):
    return torch.ones_like(data)
