"""``dot`` and ``batch_dot`` of the PyTorch port.

Counterpart of the first two ops of ``mxtpu/ops/linalg_ops.py``; the
``linalg_*`` family and ``khatri_rao`` are not ported yet. ``mxtpu``
computes both with ``jnp`` outside any Pallas kernel, so here they are
``torch.tensordot`` / ``torch.matmul`` (cuBLAS on the card).
"""
from __future__ import annotations

import torch

from .registry import register


def _t(x):
    """``x`` with its last two axes swapped (a 1-d array as it is)."""
    return x.transpose(-1, -2) if x.dim() >= 2 else x


@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet's dot: the last axis of ``lhs`` contracted with the first of
    ``rhs`` (``tensordot``), after swapping each one's last two axes
    where asked; two vectors give their inner product."""
    a = _t(lhs) if transpose_a else lhs
    b = _t(rhs) if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """A matrix product for each leading index: (B, n, k) x (B, k, m)."""
    a = _t(lhs) if transpose_a else lhs
    b = _t(rhs) if transpose_b else rhs
    return torch.matmul(a, b)
