"""Mixture-of-Experts with capacity-based dispatch: the one-device core of
``mxtpu/parallel/moe.py``.

:func:`moe_dispatch` and :func:`moe_ffn` keep the JAX functions'
arithmetic step for step: the capacity ``max(1, ceil(t/e*cf) *
num_selected)``, each token's slot in its expert from a float cumsum, the
first index among equal probabilities (``torch.argmax`` returns the first
maximum, as ``jnp.argmax`` does), the gate value carried into the combine
tensor so that the gate is differentiable, and the Switch load-balancing
loss. Dispatch and combine are the dense einsums of Mesh-TF, as in
``mxtpu``; on the card they are cuBLAS products. ``expert_sharding_rules``
places the experts on a mesh axis and comes with the port of the mesh
layer.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["moe_capacity", "moe_dispatch", "moe_ffn"]


def moe_capacity(tokens, experts, capacity_factor, num_selected):
    """Slots an expert takes: ``max(1, ceil(t/e*cf) * num_selected)``."""
    return max(1, int(math.ceil(tokens / experts * capacity_factor))
               * num_selected)


def moe_dispatch(gate_logits, capacity, num_selected=1):
    """Dispatch and combine tensors for capacity-C routing.

    gate_logits ``[T, E]``. Returns ``(dispatch [T, E, C]`` one-hot,
    ``combine [T, E, C]`` gate-weighted, ``aux_loss`` scalar)."""
    t, e = gate_logits.shape
    probs = torch.softmax(gate_logits, dim=-1)
    dt = probs.dtype
    dispatch = torch.zeros((t, e, capacity), dtype=dt, device=probs.device)
    combine = torch.zeros_like(dispatch)
    remaining = probs
    fill = torch.zeros((e,), dtype=torch.int32, device=probs.device)
    for _ in range(num_selected):
        idx = torch.argmax(remaining, dim=-1)                    # [T]
        onehot = F.one_hot(idx, e).to(dt)                        # [T, E]
        # position of each token within its expert's capacity
        pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot       # [T, E]
        pos = pos + fill[None, :].to(dt) * onehot
        keep = (pos < capacity) & (onehot > 0)
        pos_i = torch.clamp(pos.to(torch.int32), 0, capacity - 1)
        cap_onehot = F.one_hot(pos_i.long(), capacity).to(dt)    # [T, E, C]
        sel = keep.to(dt)[..., None] * cap_onehot
        dispatch = dispatch + sel
        gate = (remaining * onehot).sum(-1)                      # [T]
        combine = combine + sel * gate[:, None, None]
        fill = fill + keep.sum(0).to(torch.int32)
        remaining = remaining * (1.0 - onehot)
    # Switch load-balancing loss: E * sum_e fraction_tokens_e * mean_prob_e
    top1 = F.one_hot(torch.argmax(probs, dim=-1), e).to(dt)
    frac = top1.mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = e * torch.sum(frac * mean_prob)
    return dispatch, combine, aux


def moe_ffn(x, gate_w, w1, b1, w2, b2, capacity_factor=1.25,
            num_selected=1):
    """Expert feed-forward layer. x ``[T, D]``; gate_w ``[D, E]``; w1
    ``[E, D, H]``; b1 ``[E, H]``; w2 ``[E, H, D]``; b2 ``[E, D]``.
    Returns ``(y [T, D], aux_loss)``."""
    t = x.shape[0]
    e = gate_w.shape[1]
    capacity = moe_capacity(t, e, capacity_factor, num_selected)
    logits = x @ gate_w
    dispatch, combine, aux = moe_dispatch(logits, capacity, num_selected)
    expert_in = torch.einsum("tec,td->ecd", dispatch, x)
    h = torch.relu(torch.einsum("ecd,edh->ech", expert_in, w1)
                   + b1[:, None, :])
    out_e = torch.einsum("ech,ehd->ecd", h, w2) + b2[:, None, :]
    y = torch.einsum("tec,ecd->td", combine, out_e)
    return y, aux
