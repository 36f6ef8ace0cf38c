"""Fused RNN op of the PyTorch port.

Counterpart of ``mxtpu/ops/rnn.py``: one op runs a multi-layer,
optionally bidirectional RNN/LSTM/GRU over a sequence, with all weights
packed into one flat parameter vector in the cuDNN layout that
:func:`rnn_blob_blocks` defines. Gate orders: LSTM [i, f, g, o], GRU
[r, z, n].

The input projection of each direction is hoisted out of the time loop
into one ``torch.matmul`` over all steps; the LSTM and GRU recurrences
then run in :mod:`.rnn_scan`, which launches the CUDA kernels on a CUDA
tensor and the plain loop on a CPU tensor. The vanilla rnn_tanh /
rnn_relu modes have no kernel in either package and loop in PyTorch.
"""
from __future__ import annotations

import torch

from .registry import register, next_generator
from .rnn_scan import gru_scan, lstm_scan

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_blob_blocks(mode, input_size, state_size, num_layers, num_dir):
    """The flat cudnn-layout blob: all weights (layer-major, direction
    within layer), then all biases. Per-(layer, direction) block offsets
    and shapes, identical to ``mxtpu.ops.rnn.rnn_blob_blocks``."""
    G = _GATES[mode]
    H = state_size
    blocks = []
    off = 0
    for layer in range(num_layers):
        isz = input_size if layer == 0 else H * num_dir
        for d in range(num_dir):
            blocks.append({"layer": layer, "dir": d,
                           "wi": (off, (G * H, isz)),
                           "wh": (off + G * H * isz, (G * H, H))})
            off += G * H * isz + G * H * H
    i = 0
    for layer in range(num_layers):
        for d in range(num_dir):
            blocks[i]["bi"] = (off, (G * H,))
            blocks[i]["bh"] = (off + G * H, (G * H,))
            off += 2 * G * H
            i += 1
    return blocks, off


def _unpack_params(params, mode, input_size, state_size, num_layers,
                   num_dir):
    """Slice the flat cudnn-layout vector per rnn_blob_blocks."""
    blocks, _ = rnn_blob_blocks(mode, input_size, state_size, num_layers,
                                num_dir)
    weights, biases = [], []
    for b in blocks:
        (wi_off, wi_shape), (wh_off, wh_shape) = b["wi"], b["wh"]
        wi = params[wi_off:wi_off + wi_shape[0] * wi_shape[1]] \
            .reshape(wi_shape)
        wh = params[wh_off:wh_off + wh_shape[0] * wh_shape[1]] \
            .reshape(wh_shape)
        weights.append((wi, wh))
        (bi_off, bi_shape), (bh_off, bh_shape) = b["bi"], b["bh"]
        biases.append((params[bi_off:bi_off + bi_shape[0]],
                       params[bh_off:bh_off + bh_shape[0]]))
    return weights, biases


def rnn_param_size(mode, input_size, state_size, num_layers, bidirectional):
    _, size = rnn_blob_blocks(mode, input_size, state_size, num_layers,
                              2 if bidirectional else 1)
    return size


def _vanilla_loop(x_proj, h0, wh, bh, mode):
    act = torch.tanh if mode == "rnn_tanh" else torch.relu
    wh_t = wh.t()
    h = h0
    ys = []
    for t in range(x_proj.shape[0]):
        h = act(x_proj[t] + h @ wh_t + bh)
        ys.append(h)
    return torch.stack(ys), h


def _run_direction(xs, h0, c0, wi, wh, bi, bh, mode, reverse):
    """xs: (T, N, I); returns (T, N, H), hT, cT."""
    H = h0.shape[-1]
    # the input projection of every step in one matmul
    x_proj = torch.matmul(xs, wi.t()) + bi             # (T, N, G*H)
    if reverse:
        x_proj = torch.flip(x_proj, dims=(0,))
    if mode == "gru":
        # fold the r/z recurrent bias into the projection; the candidate
        # gate keeps its own, since it sees r * (h @ Whn + bhn)
        xp = torch.cat([x_proj[..., :2 * H] + bh[:2 * H],
                        x_proj[..., 2 * H:]], dim=-1)
        ys, hT = gru_scan(xp, h0, wh[:2 * H].t().contiguous(),
                          wh[2 * H:].t().contiguous(), bh[2 * H:].contiguous())
        cT = hT
    elif mode == "lstm":
        ys, hT, cT = lstm_scan((x_proj + bh).contiguous(), h0.contiguous(),
                               c0.contiguous(), wh.t().contiguous())
    else:
        ys, hT = _vanilla_loop(x_proj, h0, wh, bh, mode)
        cT = c0
    if reverse:
        ys = torch.flip(ys, dims=(0,))
    return ys, hT, cT


@register("RNN", aliases=("rnn",), stateful=True, needs_train_flag=True)
def rnn(data, parameters, state, state_cell=None, state_size=0,
        num_layers=1, bidirectional=False, mode="lstm", p=0.0,
        state_outputs=False, lstm_state_clip_min=None,
        lstm_state_clip_max=None, _training=False):
    """data: (T, N, I); state: (L*D, N, H); returns output (T, N, D*H)
    plus final states when state_outputs (same contract as mxtpu's RNN)."""
    T, N, I = data.shape
    H = state_size
    D = 2 if bidirectional else 1
    L = num_layers
    weights, biases = _unpack_params(parameters, mode, I, H, L, D)
    if state_cell is None:
        state_cell = torch.zeros_like(state)
    x = data
    h_finals, c_finals = [], []
    for layer in range(L):
        outs = []
        for d in range(D):
            idx = layer * D + d
            wi, wh = weights[idx]
            bi, bh = biases[idx]
            ys, hT, cT = _run_direction(
                x, state[idx], state_cell[idx], wi, wh, bi, bh, mode,
                reverse=(d == 1))
            outs.append(ys)
            h_finals.append(hT)
            c_finals.append(cT)
        x = outs[0] if D == 1 else torch.cat(outs, dim=-1)
        if p > 0.0 and _training and layer != L - 1:
            gen = next_generator()
            keep = torch.rand(x.shape, generator=gen, device=gen.device) \
                .to(x.device) < 1.0 - p
            x = torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    h_out = torch.stack(h_finals, dim=0)
    if mode == "lstm":
        c_out = torch.stack(c_finals, dim=0)
        if lstm_state_clip_min is not None:
            c_out = torch.clamp(c_out, lstm_state_clip_min,
                                lstm_state_clip_max)
        if state_outputs:
            return x, h_out, c_out
        return x
    if state_outputs:
        return x, h_out
    return x
