"""Reductions of the PyTorch port: sum, mean, max, min and argmax.

Counterpart of part of ``mxtpu/ops/reduce.py``, under the same names and
semantics: ``axis`` (an int, a tuple, or None for every axis),
``keepdims``, and ``exclude`` (reduce over every axis *but* ``axis``).
As in ``mxtpu``, an integer sum keeps the input's dtype (torch widens it
to int64), an integer mean is float32, and argmax returns float32
indices.
"""
from __future__ import annotations

import torch

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


register("sum", aliases=("sum_axis",))(_reduce(torch.sum))
register("mean")(_reduce(torch.mean, float_only=True))
register("max", aliases=("max_axis",))(_reduce(torch.amax))
register("min", aliases=("min_axis",))(_reduce(torch.amin))


@register("argmax", differentiable=False)
def argmax(data, axis=None, keepdims=False):
    out = torch.argmax(data, dim=axis,
                       keepdim=bool(keepdims and axis is not None))
    return out.to(torch.float32)
