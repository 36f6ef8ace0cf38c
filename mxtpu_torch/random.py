"""Random numbers of the PyTorch port (``mxtpu/random.py``'s ``seed``,
``uniform`` and ``normal``).

Every draw comes from the generator of :mod:`.ops.registry`
(:func:`~mxtpu_torch.ops.registry.next_generator`: the innermost
``rng_scope``, else this thread's default), a CPU ``torch.Generator``,
and is then moved to the context. So one seed gives the same numbers on
the card and on the CPU, and a card run can start where a CPU run does.
The numbers differ from ``jax.random``'s: the packages share the rule of
each draw, not its bits.
"""
from __future__ import annotations

import torch

from .base import canonical_dtype
from .context import current_context
from .ndarray import NDArray
from .ops.registry import next_generator, set_global_seed

__all__ = ["seed", "uniform", "normal"]


def seed(seed_state):
    """Seed the default generator of this thread."""
    set_global_seed(int(seed_state))


def _shape(shape):
    if shape is None:
        return (1,)
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _place(t, dtype, ctx, out):
    """``t`` (f32 on the CPU) as ``dtype`` on ``ctx``, or written into
    ``out`` (which keeps its context)."""
    if out is not None:
        out._set_data(t.to(device=out.data.device, dtype=out.dtype))
        return out
    ctx = ctx or current_context()
    return NDArray(t.to(device=ctx.torch_device(),
                        dtype=canonical_dtype(dtype)), ctx)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None):
    """Samples of U[low, high)."""
    t = torch.empty(_shape(shape)).uniform_(low, high,
                                            generator=next_generator())
    return _place(t, dtype, ctx, out)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None):
    """Samples of N(loc, scale^2)."""
    t = torch.randn(_shape(shape), generator=next_generator()) * scale + loc
    return _place(t, dtype, ctx, out)
