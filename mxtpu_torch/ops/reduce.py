"""Reductions and orderings of the PyTorch port: sum, mean, prod, max,
min, nansum, nanprod, norm, argmax, argmin, argmax_channel, topk, sort
and argsort.

Counterpart of part of ``mxtpu/ops/reduce.py``, under the same names and
semantics: ``axis`` (an int, a tuple, or None for every axis),
``keepdims``, and ``exclude`` (reduce over every axis *but* ``axis``).
As in ``mxtpu``, an integer sum keeps the input's dtype (torch widens it
to int64), an integer mean is float32, and argmax returns float32
indices. The orderings keep ``mxtpu``'s order among ties: ``topk``
takes the lower index first (``lax.top_k``), and a descending ``sort``
or ``argsort`` is the ascending stable one reversed, as ``mxtpu`` flips
it. ``torch.topk`` is not stable, so all of them go through a stable
``torch.sort``.
"""
from __future__ import annotations

import torch

from ..base import canonical_dtype
from .registry import register


def _axes(data, axis, exclude):
    if axis is None or axis == ():
        return tuple(range(data.dim()))
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (int(axis),)
    ax = tuple(a % data.dim() for a in ax)
    if exclude:
        ax = tuple(i for i in range(data.dim()) if i not in ax)
    return ax


def _reduce(fn, float_only=False):
    def impl(data, axis=None, keepdims=False, exclude=False):
        x = data
        if float_only and not x.is_floating_point():
            x = x.to(torch.float32)
        ax = _axes(x, axis, exclude)
        if not ax:
            return x.clone()
        out = fn(x, dim=ax, keepdim=keepdims)
        return out if out.dtype == x.dtype else out.to(x.dtype)
    return impl


def _prod(x, dim, keepdim):
    """torch.prod over a tuple of axes (it takes one at a time)."""
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _nanprod(x, dim, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim,
                 keepdim)


register("sum", aliases=("sum_axis",))(_reduce(torch.sum))
register("mean")(_reduce(torch.mean, float_only=True))
register("prod")(_reduce(_prod))
register("max", aliases=("max_axis",))(_reduce(torch.amax))
register("min", aliases=("min_axis",))(_reduce(torch.amin))
register("nansum")(_reduce(torch.nansum))
register("nanprod")(_reduce(_nanprod))


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False):
    """The L1 norm for ``ord=1``, else the L2 norm, as sqrt(sum(x^2)):
    its gradient at 0 is NaN, as ``mxtpu``'s is."""
    ax = _axes(data, axis, False)
    if ord == 1:
        return torch.sum(torch.abs(data), dim=ax, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(data), dim=ax,
                                keepdim=keepdims))


@register("argmax", differentiable=False)
def argmax(data, axis=None, keepdims=False):
    out = torch.argmax(data, dim=axis,
                       keepdim=bool(keepdims and axis is not None))
    return out.to(torch.float32)


@register("argmin", differentiable=False)
def argmin(data, axis=None, keepdims=False):
    out = torch.argmin(data, dim=axis,
                       keepdim=bool(keepdims and axis is not None))
    return out.to(torch.float32)


@register("argmax_channel", differentiable=False)
def argmax_channel(data):
    return torch.argmax(data, dim=1).to(torch.float32)


def _ordered(data, axis, descending):
    """Stable sort along ``axis``: (values, int64 indices); ties keep
    their index order."""
    return torch.sort(data, dim=axis, descending=descending, stable=True)


@register("topk", differentiable=False, num_outputs=2)
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The k largest (smallest with ``is_ascend``) along ``axis``: their
    indices as ``dtype`` (float32 by default, as in MXNet), their values,
    both, or a 0/1 mask of them in the data's dtype."""
    axis = axis % data.dim()
    vals, idx = _ordered(data, axis, not is_ascend)
    vals, idx = vals.narrow(axis, 0, k), idx.narrow(axis, 0, k)
    idxf = idx.to(canonical_dtype(dtype))
    if ret_typ == "indices":
        return idxf
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idxf
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(
            axis, idx, torch.ones_like(vals))
    raise ValueError("unknown ret_typ %r" % ret_typ)


@register("sort")
def sort(data, axis=-1, is_ascend=True):
    out = _ordered(data, axis, False)[0]
    return out if is_ascend else torch.flip(out, dims=(axis,))


@register("argsort", differentiable=False)
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    out = _ordered(data, axis, False)[1]
    if not is_ascend:
        out = torch.flip(out, dims=(axis,))
    return out.to(canonical_dtype(dtype))
