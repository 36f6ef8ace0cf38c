"""Shape ops of the PyTorch port.

Counterpart of the part of ``mxtpu/ops/shape_ops.py`` that the fused
RNN cell's ``unroll``, the serving graphs, LeNet and
``nd.concatenate`` emit: reshape (with MXNet's special codes), Flatten,
swapaxes, expand_dims, concat, stack, split, zeros_like, ones_like and
the nullary ``_zeros`` creator; ``pick``, which Gluon's
``SoftmaxCrossEntropyLoss`` takes its labels' entries with; and
``transpose`` and ``slice_axis``, which the SSD heads use; ``one_hot``
and ``cast`` (the Gluon vision transforms cast their images); and the
rest of ``mxtpu``'s shape and index ops: squeeze, slice, slice_like,
take, batch_take, gather_nd, scatter_nd, tile, repeat, pad, reverse, the
broadcasts, ``_index``, shape_array, size_array, diag, depth_to_space,
space_to_depth and ``_ones``.

Indices follow ``mxtpu``'s JAX rules rather than raising, so that no
device-side assert can end the card's context: a negative index counts
from the end once; beyond that a gather clamps (``gather_nd``), fills
(``batch_take``, as ``pick``) or takes ``take``'s clip/wrap mode, and a
scatter drops it (``scatter_nd``, whose duplicates add up).
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


@register("squeeze")
def squeeze(data, axis=None):
    """``data`` without its size-1 axes (only those of ``axis``)."""
    if axis is None:
        return torch.squeeze(data)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),)
    return torch.squeeze(data, dim=ax)


def _strided(data, dim, begin, end, step):
    """``data[begin:end:step]`` along ``dim`` with Python's rules, also
    for a negative step, which torch's slicing refuses."""
    start, stop, st = slice(begin, end, step).indices(data.shape[dim])
    if st > 0:
        return data[(slice(None),) * dim + (slice(start, stop, st),)]
    idx = torch.arange(start, stop, st, device=data.device)
    return torch.index_select(data, dim, idx)


@register("slice", aliases=("crop",))
def slice_op(data, begin=(), end=(), step=()):
    """``data[b0:e0:s0, b1:e1:s1, ...]`` over the leading axes; a None
    bound or step takes Python's default, a step may be negative."""
    step = tuple(step) if step else (None,) * len(begin)
    for i, (b, e) in enumerate(zip(begin, end)):
        s = step[i] if i < len(step) else None
        data = _strided(data, i, b, e, s)
    return data


@register("slice_like")
def slice_like(data, shape_like, axes=()):
    """``data`` cut to ``shape_like``'s sizes along ``axes`` (all shared
    axes by default), from index 0."""
    axes = axes or tuple(range(min(data.dim(), shape_like.dim())))
    idx = [slice(None)] * data.dim()
    for ax in axes:
        idx[ax] = slice(0, shape_like.shape[ax])
    return data[tuple(idx)]


@register("take")
def take(a, indices, axis=0, mode="clip"):
    """Slices of ``a`` along ``axis`` at ``indices`` (cast to int):
    ``clip`` clamps an index into [0, n), anything else wraps it mod n."""
    axis = axis % a.dim()
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    idx = idx.clamp(0, n - 1) if mode == "clip" else torch.remainder(idx, n)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(indices.shape)
                       + tuple(a.shape[axis + 1:]))


@register("batch_take")
def batch_take(a, indices):
    """``a[i, indices[i]]`` for each row i (``pick`` along axis 1)."""
    return pick(a, indices.reshape(-1), axis=1)


def _wrapped(indices, shape):
    """Each row m of an int (M, ...) index tensor with a negative index
    counted from the end of axis m once: the rows and a mask of those in
    range."""
    idx = indices.to(torch.int64)
    sizes = torch.tensor(shape[:idx.shape[0]], device=idx.device).reshape(
        (-1,) + (1,) * (idx.dim() - 1))
    idx = torch.where(idx < 0, idx + sizes, idx)
    return idx, ((idx >= 0) & (idx < sizes)).all(dim=0)


@register("gather_nd")
def gather_nd(data, indices):
    """``data[indices[0], indices[1], ...]``: ``indices`` has the index
    axis first, shape (M, ...); an index outside its axis is clamped, as
    JAX clamps a gather."""
    idx, _ = _wrapped(indices, tuple(data.shape))
    rows = [idx[m].clamp(0, data.shape[m] - 1) for m in range(idx.shape[0])]
    return data[tuple(rows)]


@register("scatter_nd")
def scatter_nd(data, indices, shape=()):
    """Zeros of ``shape`` with ``data`` added at ``indices`` (index axis
    first, as ``gather_nd``): duplicate indices add up, an index outside
    ``shape`` is dropped."""
    shape = tuple(shape)
    idx, ok = _wrapped(indices, shape)
    rows = tuple(torch.where(ok, idx[m], 0) for m in range(idx.shape[0]))
    okb = ok.reshape(tuple(ok.shape) + (1,) * (data.dim() - ok.dim()))
    vals = torch.where(okb, data, torch.zeros_like(data))
    out = torch.zeros(shape, dtype=data.dtype, device=data.device)
    return out.index_put(rows, vals, accumulate=True)


@register("tile")
def tile(data, reps):
    return torch.tile(data, tuple(reps) if isinstance(reps, (list, tuple))
                      else (int(reps),))


@register("repeat")
def repeat(data, repeats=1, axis=None):
    """Each element ``repeats`` times along ``axis`` (of the flattened
    array when None)."""
    if axis is None:
        return torch.repeat_interleave(data.reshape(-1), int(repeats))
    return torch.repeat_interleave(data, int(repeats), dim=axis)


def _pad_index(n, lo, hi, mode, device):
    """Source index of each position of an axis of size ``n`` padded by
    (lo, hi): ``edge`` repeats the end, ``reflect`` mirrors about it
    without repeating it (numpy's and ``jnp.pad``'s modes)."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


@register("pad", aliases=("Pad",))
def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """``data`` padded by ``pad_width``, MXNet's flat (before, after)
    pairs axis by axis from the FIRST axis (``F.pad`` counts from the
    last); ``constant`` fills with ``constant_value``, ``edge`` repeats
    the border, ``reflect`` mirrors it, on any number of axes."""
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    if mode == "constant":
        flat = [p for lo_hi in reversed(pw) for p in lo_hi]
        return torch.nn.functional.pad(data, flat, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError(mode)
    for ax, (lo, hi) in enumerate(pw):
        if lo or hi:
            data = torch.index_select(
                data, ax, _pad_index(data.shape[ax], lo, hi, mode,
                                     data.device))
    return data


@register("reverse", aliases=("flip",))
def reverse(data, axis=0):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),)
    return torch.flip(data, dims=ax)


@register("broadcast_to")
def broadcast_to(data, shape=()):
    """``data`` broadcast to ``shape``; a 0 keeps that axis' size."""
    tgt = tuple(int(s) if s != 0 else data.shape[i]
                for i, s in enumerate(shape))
    return torch.broadcast_to(data, tgt).contiguous()


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    """``data``'s size-1 axes ``axis`` broadcast to ``size``."""
    if isinstance(axis, int):
        axis, size = (axis,), (size,)
    tgt = list(data.shape)
    for a, s in zip(axis, size):
        tgt[a] = s
    return torch.broadcast_to(data, tuple(tgt)).contiguous()


@register("broadcast_like")
def broadcast_like(data, like):
    return torch.broadcast_to(data, tuple(like.shape)).contiguous()


@register("_index")
def _index(data, key=()):
    """Basic indexing, differentiable (``NDArray.__getitem__`` under
    autograd)."""
    return data[key]


@register("shape_array", differentiable=False)
def shape_array(data):
    """The shape as a 1-d int64 array (MXNet's dtype; ``mxtpu``'s is
    int32, JAX's widest without x64)."""
    return torch.tensor(tuple(data.shape), dtype=torch.int64,
                        device=data.device)


@register("size_array", differentiable=False)
def size_array(data):
    """The element count as a 1-element int64 array."""
    return torch.tensor([data.numel()], dtype=torch.int64,
                        device=data.device)


@register("diag")
def diag(data, k=0):
    """A 1-d ``data`` as the k-th diagonal of a matrix; of a 2-d one its
    k-th diagonal; of more axes the k-th diagonal over axes 0 and 1,
    placed last (``jnp.diagonal``)."""
    if data.dim() <= 2:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=0, dim2=1)


@register("depth_to_space")
def depth_to_space(data, block_size):
    """MXNet's DCR order: (b, c, h, w) viewed as (b, bs, bs, c/bs^2, h,
    w) and moved to (b, c/bs^2, h, bs, w, bs). ``pixel_shuffle`` is CRD
    and gives another answer."""
    b, c, h, w = data.shape
    bs = block_size
    x = data.reshape(b, bs, bs, c // (bs * bs), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(b, c // (bs * bs), h * bs, w * bs)


@register("space_to_depth")
def space_to_depth(data, block_size):
    """The inverse of ``depth_to_space``."""
    b, c, h, w = data.shape
    bs = block_size
    x = data.reshape(b, c, h // bs, bs, w // bs, bs)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, c * bs * bs, h // bs, w // bs)


@register("_ones", needs_device=True)
def _ones_op(shape=(), dtype="float32", _device=None):
    """Nullary ones creator."""
    return torch.ones(tuple(shape), dtype=canonical_dtype(dtype),
                      device=_device)
