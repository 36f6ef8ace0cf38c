"""Attention on local shards: the one-device core of
``mxtpu/parallel/ring_attention.py``.

:func:`local_attention` keeps the JAX function's arguments and rules:
``impl="flash"`` runs the flash-attention kernels
(:mod:`mxtpu_torch.ops.flash_attention`), ``"xla"`` the plain
einsum+softmax path, and ``"auto"`` picks flash for CUDA tensors whose
sequences are long enough to tile (Tq, Tk >= 128) and carry no ALiBi
bias, as the JAX package picks it on the TPU. The flash path takes
float32, bfloat16 and float16 at every head dim up to 128 (the kernel
wrapper fits them to the kernels); on the card a head dim above 128 or
another dtype raises there, where ``mxtpu`` computes (a known
difference). ``alibi=True`` subtracts
the per-head distance bias, which the kernels do not carry, so it forces
the dense path.

``ring_attention``, ``ring_attention_sharded`` and ``ulysses_attention``
pass K/V blocks between devices of a mesh; they come with the port of
the mesh layer (ROADMAP Queue A, mesh parallelism). On one device the
ring has one step, and its flash route is one flash call: what
:func:`local_attention` does.
"""
from __future__ import annotations

import torch

__all__ = ["local_attention"]

_IMPLS = ("auto", "flash", "xla")


def _alibi_slopes(h, dtype=torch.float32, device=None):
    """Per-head ALiBi slopes ``2^(-8(i+1)/H)`` (Press et al.)."""
    return torch.tensor([2.0 ** (-8.0 * (i + 1) / h) for i in range(h)],
                        dtype=dtype, device=device)


def local_attention(q, k, v, causal=False, scale=None, q_offset=0,
                    k_offset=0, impl="auto", alibi=False):
    """Softmax attention on local shards. q, k, v: [B, H, T, D].

    ``q_offset``/``k_offset`` give the global positions of the local rows
    for causal masking under sequence sharding. ``impl``: "flash" runs
    the flash-attention kernels, "xla" the plain einsum+softmax path,
    "auto" flash on the card for Tq, Tk >= 128. ``alibi=True`` subtracts
    the per-head linear distance bias from the scores and forces the
    plain path."""
    if impl not in _IMPLS:
        raise ValueError("local_attention: impl must be one of %s, got %r"
                         % (_IMPLS, impl))
    if impl == "auto":
        impl = ("flash" if q.device.type == "cuda" and not alibi
                and q.shape[2] >= 128 and k.shape[2] >= 128 else "xla")
    if impl == "flash" and not alibi:
        from ..ops.flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               q_offset=q_offset, k_offset=k_offset)
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / torch.sqrt(torch.tensor(float(d))).to(q.dtype)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    qi = q_offset + torch.arange(q.shape[2], device=q.device)
    ki = k_offset + torch.arange(k.shape[2], device=q.device)
    if alibi:
        dist = (qi[:, None] - ki[None, :]).to(s.dtype)
        s = s - _alibi_slopes(q.shape[1], s.dtype, s.device)[None, :, None,
                                                             None] \
            * dist[None, None]
    if causal:
        mask = qi[:, None] >= ki[None, :]
        s = torch.where(mask[None, None], s, torch.finfo(s.dtype).min)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)
