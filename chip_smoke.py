#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mxtpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. the card: its name, and name and power limit from nvidia-smi;
2. build the hand-written kernels from mxtpu_torch/csrc with nvcc, one
   process per source, all at once;
3. hold each kernel against its plain PyTorch version on the card: the
   LSTM/GRU time loops at the serving slice's shapes (T=32, H=200,
   N in {1, 32}; float32 and bfloat16), and the three flash-attention
   kernels (forward with lse, dQ, dK/dV) at the training slice's shape
   (B=8, H=4, T=256, D=16, f32, causal), at the JAX package's own check
   shape (B=1, H=8, T=8192, D in {64, 128}, bf16, causal), on shard
   offsets that leave rows fully masked, and on lengths that are not a
   multiple of the tile;
4. serving: a bucketed LSTM language model at the published widths of
   example/rnn/lstm_bucketing.py (vocab 10,000, embed 200, hidden 200,
   2 layers, 32 tokens), with weights drawn from --seed, checkpointed and
   served by InferenceEngine on cuda:0; every answer is checked against
   the same checkpoint served on the CPU (the plain path), and the LSTM
   kernel must have been launched once per layer per request;
5. the same model with mode="gru", which drives the GRU kernel;
6. training: the causal attention LM of
   example/long-context/ring_attention_lm.py (vocab 32, dim 64, 4 heads,
   sequence 256, batch 8, f32) trained on cuda:0 with the example's Adam
   for its 300 steps from --seed; attention goes through
   mxtpu_torch.parallel.local_attention, which picks the flash kernels.
   It must learn the copy task (nll < 0.5 ln 32), launch each flash
   kernel once per step, and match its first 3 steps run on the CPU (the
   plain path) in loss and parameters;
7. the op entry: mt.nd.flash_attention on the card launches the kernel;
8. timings: each kernel, its plain version and the PyTorch library call
   computing the same function (cuDNN RNNs; scaled_dot_product_attention),
   beside the least time the card could take; the serving slice's
   requests/s and tokens scored/s at bucket 32; the training slice's ms
   per step, tokens/s and where a step's device time goes;
9. one JSON line naming every kernel with its launches and error;
10. the last line: {"ok": true, "device": {...}}.

It needs one card and the repository around it; without either it
exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

VOCAB, EMBED, HIDDEN, LAYERS, SEQ = 10000, 200, 200, 2, 32
BUCKETS = (1, 2, 4, 8, 16, 32)
REQUEST_ROWS = (1, 3, 8, 17, 32, 5, 2, 32)
GRU_REQUEST_ROWS = (4, 32, 9)

# Kernel vs plain version on the same card and inputs. float32: both
# carry h and c in f32 and differ only in the order of the 200-term dot
# products, so after 32 steps the drift stays far below 1e-4. bfloat16:
# the carry is f32 in both, but each step's h is rounded to bf16 for ys;
# a last-bit difference in f32 can flip that rounding by one bf16 ulp
# (2**-8 at |h| < 1), and cT (|c| can pass 1) by one ulp of its own
# magnitude. Allow four ulps.
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=4 * 2.0 ** -8, rtol=4 * 2.0 ** -8)
# The served LM, card vs CPU, float32 softmax outputs (each <= 1): the
# matmuls (TF32 off) and the recurrence differ in summation order only.
SERVE_TOL = dict(atol=1e-6, rtol=1e-3)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, float32 outside the
# tensor cores (where these kernels compute), and the dense bf16
# tensor-core rate that bf16 attention is bounded against
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12

# The training slice: example/long-context/ring_attention_lm.py at its
# own widths, trained with its Adam recipe.
LM_VOCAB, LM_DIM, LM_HEADS, LM_SEQ, LM_PERIOD = 32, 64, 4, 256, 16
LM_BATCH, LM_STEPS, LM_LR = 8, 300, 3e-3
LM_PARAMS = {"emb": (LM_VOCAB, LM_DIM), "pos": (LM_SEQ, LM_DIM),
             "wq": (LM_DIM, LM_DIM), "wk": (LM_DIM, LM_DIM),
             "wv": (LM_DIM, LM_DIM), "wo": (LM_DIM, LM_DIM),
             "head": (LM_DIM, LM_VOCAB)}
# Flash kernels vs their plain versions on the card. float32: both sum
# the same f32 products in another order (the plain one through cuBLAS
# with TF32 off); measured differences stay below 2e-6 at |x| < 10. bf16:
# both compute in f32 from the same bf16 inputs and round each output
# once, so a last-bit f32 difference can flip that rounding by one bf16
# ulp, at most 2^-7 of the value; lse is f32 either way.
FLASH_F32_TOL = dict(atol=1e-5, rtol=1e-5)
FLASH_BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -7)
# The LM's first steps, card (kernels) vs CPU (plain versions): f32 sums
# in another order inside attention and the products around it. Adam
# moves each weight by about lr a step whatever the gradient's size, so
# where a gradient is near 0 a last-bit difference moves the weight by
# far more than its own size: the CPU's flash and dense attention routes,
# which differ only in such sums, end 3 steps 4.1e-6 apart.
LM_TOL = dict(atol=3e-5, rtol=1e-5)


def fail(msg):
    print("chip_smoke: FAILED: %s" % msg, file=sys.stderr)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail("nvidia-smi: %s" % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=50, warmup=5):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time(fn, calls, per=1):
    """Device busy ms, kernel launches and the top kernels (ms) per unit
    of work, from torch.profiler over ``calls`` calls of ``fn`` that do
    ``per`` units each."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    n = calls * per
    busy = sum(e.self_device_time_total for e in events) / n / 1e3
    launches = sum(e.count for e in events) / n
    top = ", ".join("%s %.4f" % (e.key[:48], e.self_device_time_total / n
                                 / 1e3) for e in events[:8])
    return busy, "%.0f kernel launches; %s" % (launches, top)


def max_err(got, want):
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def check_close(name, got, want, tol):
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail("%s output %d: %s %s vs plain %s %s"
                 % (name, i, tuple(g.shape), g.dtype, tuple(w.shape),
                    w.dtype))
        if not torch.allclose(g.float(), w.float(), **tol):
            fail("%s output %d differs from the plain version by %g (%s)"
                 % (name, i, float((g.float() - w.float()).abs().max()),
                    tol))


# ---------------------------------------------------------------------------
# kernel inputs at the slice's shapes
# ---------------------------------------------------------------------------

def lstm_args(rng, N, dtype, dev):
    import torch
    H = HIDDEN
    arrays = [rng.standard_normal((SEQ, N, 4 * H)),
              rng.standard_normal((N, H)) * 0.5,
              rng.standard_normal((N, H)) * 0.5,
              rng.standard_normal((H, 4 * H)) * 0.07]
    return [torch.from_numpy(a.astype(np.float32)).to(dev).to(dtype)
            for a in arrays]


def gru_args(rng, N, dtype, dev):
    import torch
    H = HIDDEN
    arrays = [rng.standard_normal((SEQ, N, 3 * H)),
              rng.standard_normal((N, H)) * 0.5,
              rng.standard_normal((H, 2 * H)) * 0.07,
              rng.standard_normal((H, H)) * 0.07,
              rng.standard_normal((H,)) * 0.1]
    return [torch.from_numpy(a.astype(np.float32)).to(dev).to(dtype)
            for a in arrays]


def cudnn_lstm(xp, h0, c0, wh_t):
    """torch.nn.LSTM (cuDNN) set up to compute lstm_scan's function:
    identity input weights feed x_proj straight into the gates."""
    import torch
    G, H = xp.shape[-1], h0.shape[-1]
    m = torch.nn.LSTM(G, H).to(xp.device)
    with torch.no_grad():
        m.weight_ih_l0.copy_(torch.eye(G, device=xp.device))
        m.weight_hh_l0.copy_(wh_t.t())
        m.bias_ih_l0.zero_()
        m.bias_hh_l0.zero_()
    h0, c0 = h0[None], c0[None]

    def call():
        with torch.no_grad():
            ys, (hT, cT) = m(xp, (h0, c0))
        return ys, hT[0], cT[0]
    return call


def cudnn_gru(xp, h0, whrz_t, whn_t, bhn):
    """torch.nn.GRU (cuDNN) set up to compute gru_scan's function; the
    r/z recurrent bias is already folded into x_proj."""
    import torch
    G, H = xp.shape[-1], h0.shape[-1]
    m = torch.nn.GRU(G, H).to(xp.device)
    with torch.no_grad():
        m.weight_ih_l0.copy_(torch.eye(G, device=xp.device))
        m.weight_hh_l0.copy_(torch.cat([whrz_t.t(), whn_t.t()], 0))
        m.bias_ih_l0.zero_()
        m.bias_hh_l0.copy_(torch.cat([bhn.new_zeros(2 * H), bhn]))
    h0 = h0[None]

    def call():
        with torch.no_grad():
            ys, hT = m(xp, h0)
        return ys, hT[0]
    return call


def bound(kind, N, itemsize=4):
    """Least time (ms) for one call at (T=SEQ, N, H=HIDDEN): each input
    read once and each output written once at the HBM rate, against the
    h.Wh products and the gate math at the float32 rate."""
    T, H = SEQ, HIDDEN
    if kind == "lstm":
        elems = T * N * 4 * H + H * 4 * H + 2 * N * H + T * N * H + 2 * N * H
        flops = T * (2 * N * H * 4 * H + 10 * N * H)
    else:
        elems = (T * N * 3 * H + H * 2 * H + H * H + H + N * H
                 + T * N * H + N * H)
        flops = T * (2 * N * H * 3 * H + 12 * N * H)
    t_bytes = elems * itemsize / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------

def lm_symbol(mt, mode):
    data = mt.sym.var("data")
    embed = mt.sym.Embedding(data, input_dim=VOCAB, output_dim=EMBED,
                             name="embed")
    cell = mt.rnn.FusedRNNCell(HIDDEN, num_layers=LAYERS, mode=mode,
                               prefix="lstm_")
    outputs, _ = cell.unroll(SEQ, inputs=embed, layout="NTC",
                             merge_outputs=True)
    pred = mt.sym.FullyConnected(outputs, num_hidden=VOCAB, flatten=False,
                                 name="pred")
    return mt.sym.softmax(pred, axis=-1, name="softmax")


def write_checkpoint(mt, mode, seed, prefix):
    sym = lm_symbol(mt, mode)
    args, _, _ = sym.infer_shape(data=(1, SEQ))
    rng = np.random.RandomState(seed)
    params = {n: (rng.uniform(-0.1, 0.1, s)).astype(np.float32)
              for n, s in zip(sym.list_arguments(), args) if n != "data"}
    arg_params, aux_params = mt.model.params_from_numpy(params, {},
                                                        ctx=mt.cpu())
    mt.model.save_checkpoint(prefix, 0, sym, arg_params, aux_params)


def serve(mt, rnn_scan, mode, seed, rows_list, workdir):
    """Serve the LM on cuda:0 and on the CPU from one checkpoint; returns
    (engine on the card, launches per kernel during the card's run)."""
    prefix = os.path.join(workdir, "lm-%s" % mode)
    write_checkpoint(mt, mode, seed, prefix)
    kw = dict(data_shapes={"data": (SEQ,)}, buckets=BUCKETS)
    gpu = mt.serving.InferenceEngine.from_checkpoint(prefix, 0,
                                                     ctx=mt.gpu(0), **kw)
    if gpu.stats()["compiles"] != len(BUCKETS):
        fail("warm() prepared %d programs for %d buckets"
             % (gpu.stats()["compiles"], len(BUCKETS)))
    rng = np.random.RandomState(seed + 1)
    requests = [rng.randint(0, VOCAB, (r, SEQ)).astype(np.float32)
                for r in rows_list]
    rnn_scan.reset_launches()
    answers = [gpu.predict([req]) for req in requests]
    launches = dict(rnn_scan.LAUNCHES)
    stats = gpu.stats()
    if stats["compiles"] != len(BUCKETS) or stats["hits"] != len(requests):
        fail("program cache moved while serving: %s" % stats)
    cpu = mt.serving.InferenceEngine.from_checkpoint(prefix, 0,
                                                     ctx=mt.cpu(), **kw)
    worst = 0.0
    for req, got in zip(requests, answers):
        want = cpu.predict([req])
        out, ref = got[0], want[0]
        if out.shape != (req.shape[0], SEQ, VOCAB) or \
                not np.isfinite(out).all():
            fail("%s LM answer has shape %s or non-finite values"
                 % (mode, out.shape))
        if not np.allclose(out.sum(-1), 1.0, atol=1e-4):
            fail("%s LM rows are not distributions" % mode)
        if not np.allclose(out, ref, **SERVE_TOL):
            fail("%s LM on the card differs from the CPU by %g"
                 % (mode, float(np.abs(out - ref).max())))
        worst = max(worst, float(np.abs(out - ref).max()))
    print("slice %s: %d requests (rows %s) served on %s, max |card - cpu| "
          "= %.3g, launches %s, cache %s"
          % (mode, len(requests), list(rows_list), gpu.device, worst,
             launches, {k: stats[k] for k in ("compiles", "hits")}))
    return gpu, launches


# ---------------------------------------------------------------------------
# the training slice: the causal attention LM
# ---------------------------------------------------------------------------

def lm_init_params(seed):
    """The example's init_params: every weight N(0, 0.1^2), f32."""
    rng = np.random.RandomState(seed)
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for k, s in LM_PARAMS.items()}


def lm_batch(rng, bsz):
    """The example's batch: a random head of PERIOD tokens repeated, so
    token t equals token t - PERIOD; (bsz, SEQ + 1) int64."""
    head = rng.randint(0, LM_VOCAB, (bsz, LM_PERIOD))
    reps = (LM_SEQ + 1 + LM_PERIOD - 1) // LM_PERIOD
    return np.tile(head, (1, reps))[:, :LM_SEQ + 1].astype(np.int64)


def lm_logits(params, tokens, impl="auto"):
    """The example's model: tokens (B, T) -> logits (B, T, V); attention
    through mxtpu_torch.parallel.local_attention (causal)."""
    from mxtpu_torch.parallel import local_attention
    x = params["emb"][tokens] + params["pos"][:tokens.shape[1]]
    b, t, d = x.shape

    def heads(h):                                 # [B, T, D] -> [B, H, T, dh]
        return h.reshape(b, t, LM_HEADS, d // LM_HEADS).transpose(1, 2)

    q, k, v = (heads(x @ params[w]) for w in ("wq", "wk", "wv"))
    o = local_attention(q, k, v, causal=True, impl=impl)
    o = o.transpose(1, 2).reshape(b, t, d)
    x = x + o @ params["wo"]
    return x @ params["head"]


def lm_loss(params, tokens, impl="auto"):
    """The example's loss_fn: mean next-token nll over positions >= PERIOD."""
    import torch
    logits = lm_logits(params, tokens[:, :-1], impl)
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    mask = (torch.arange(targets.shape[1], device=targets.device)
            >= LM_PERIOD).to(logp.dtype)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    return (nll * mask).sum() / (mask.sum() * targets.shape[0])


def lm_step(params, m, v, tokens, t, lr=LM_LR, impl="auto"):
    """One step of the example's hand-written Adam: returns the new
    (params, m, v) and the loss before the update."""
    import torch
    leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss = lm_loss(leaves, tokens, impl)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    b1, b2, eps = 0.9, 0.999, 1e-8
    new_p, new_m, new_v = {}, {}, {}
    with torch.no_grad():
        for (k, p), g in zip(leaves.items(), grads):
            new_m[k] = b1 * m[k] + (1 - b1) * g
            new_v[k] = b2 * v[k] + (1 - b2) * g * g
            mh = new_m[k] / (1 - b1 ** t)
            vh = new_v[k] / (1 - b2 ** t)
            new_p[k] = p - lr * mh / (torch.sqrt(vh) + eps)
    return new_p, new_m, new_v, loss.detach()


def lm_train(params, batches, dev, impl="auto"):
    """Adam from ``params`` (numpy) over ``batches`` (token tensors on
    ``dev``); returns the params after the last update and the losses,
    one per step, as tensors on ``dev``."""
    import torch
    p = {k: torch.from_numpy(a).to(dev) for k, a in params.items()}
    m = {k: torch.zeros_like(a) for k, a in p.items()}
    v = {k: torch.zeros_like(a) for k, a in p.items()}
    losses = []
    for i, tokens in enumerate(batches):
        p, m, v, loss = lm_step(p, m, v, tokens, i + 1, impl=impl)
        losses.append(loss)
    return p, torch.stack(losses)


# ---------------------------------------------------------------------------
# flash attention: kernels vs plain versions, bounds
# ---------------------------------------------------------------------------

def flash_inputs(rng, B, H, Tq, Tk, D, dtype, dev, q_off=0, k_off=0):
    """Flattened q (BH, Tq, D), k/v (BH, Tk, D), the offs vector, and a
    cotangent dO with a random dlse folded into delta (from the plain
    forward), as the backward kernels receive them."""
    import torch
    from mxtpu_torch.ops import flash_attention as fa

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev).to(dtype)
    q, k, v = t(B * H, Tq, D), t(B * H, Tk, D), t(B * H, Tk, D)
    offs = torch.tensor([q_off, k_off, Tk, 1.0 / np.sqrt(D)],
                        dtype=torch.float32, device=dev)
    do = t(B * H, Tq, D)
    o, lse = fa.flash_fwd_plain(q, k, v, offs, True)
    dlse = t(B * H, Tq).float()
    delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    return dict(q=q, k=k, v=v, offs=offs, do=do, lse=lse, delta=delta)


def flash_calls(fa, a):
    """{kernel: (kernel call, plain call)} on the inputs of flash_inputs."""
    q, k, v, offs = a["q"], a["k"], a["v"], a["offs"]
    bw = (q, k, v, a["do"], a["lse"], a["delta"], offs, True)
    return {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, offs, True),
                      lambda: fa.flash_fwd_plain(q, k, v, offs, True)),
        "flash_bwd_dq": (lambda: (fa.flash_bwd_dq(*bw),),
                         lambda: (fa.flash_bwd_dq_plain(*bw),)),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bw),
                          lambda: fa.flash_bwd_dkv_plain(*bw)),
    }


def live_pairs(Tq, Tk, q_off=0, k_off=0):
    """(query, key) pairs a causal kernel must score."""
    i = np.arange(Tq)
    return int(np.clip(q_off + i - k_off + 1, 0, Tk).sum())


def flash_bound(name, BH, Tq, Tk, D, itemsize):
    """Least time (ms) for one causal call: inputs read once and outputs
    written once at the HBM rate, against the products on the live pairs
    (forward 4D flops a pair: S and PV; dQ 6D: S, dP, dS.K; dK/dV 8D: S,
    dP, P^T.dO, dS^T.Q) at the f32 rate for f32 inputs and the dense
    bf16 tensor-core rate for bf16."""
    qd, kd = BH * Tq * D * itemsize, BH * Tk * D * itemsize
    rows = BH * Tq * 4                      # one f32 per query row
    if name == "flash_fwd":
        nbytes, per_pair = qd + 2 * kd + qd + rows, 4 * D
    elif name == "flash_bwd_dq":
        nbytes, per_pair = 2 * qd + 2 * kd + 2 * rows + qd, 6 * D
    else:
        nbytes, per_pair = 2 * qd + 2 * kd + 2 * rows + 2 * kd, 8 * D
    flops = BH * live_pairs(Tq, Tk) * per_pair
    peak = PEAK_F32_FLOPS if itemsize == 4 else PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_flash(fa, rng, dev, B, H, Tq, Tk, D, dtype, tol, q_off=0,
                k_off=0):
    """Each flash kernel against its plain version on one input; returns
    {kernel: max abs error}."""
    import torch
    a = flash_inputs(rng, B, H, Tq, Tk, D, dtype, dev, q_off, k_off)
    label = "B=%d H=%d Tq=%d Tk=%d D=%d %s q_off=%d k_off=%d" % (
        B, H, Tq, Tk, D, dtype, q_off, k_off)
    errs = {}
    for name, (kernel, plain) in flash_calls(fa, a).items():
        got = kernel()
        torch.cuda.synchronize()
        want = plain()
        if not all(bool(torch.isfinite(g.float()).all()) for g in got):
            fail("%s %s: non-finite output" % (name, label))
        check_close("%s %s" % (name, label), got, want, tol)
        errs[name] = max_err(got, want)
    print("check flash %s: max err %s (tolerance %s)"
          % (label, {k: "%.3g" % e for k, e in errs.items()}, tol))
    return errs, a


def sdpa_calls(a, B, H):
    """scaled_dot_product_attention (is_causal) on the same q, k, v as
    [B, H, T, D]: a forward call and a forward+backward call."""
    import torch
    import torch.nn.functional as F
    q, k, v = (a[n].reshape(B, H, *a[n].shape[1:]).detach().clone()
               .requires_grad_() for n in ("q", "k", "v"))
    do = a["do"].reshape(B, H, *a["do"].shape[1:])

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    def fwd_bwd():
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return torch.autograd.grad(out, (q, k, v), do)
    return fwd, fwd_bwd


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs one card")
    sys.path.insert(0, ROOT)
    try:
        import mxtpu_torch as mt
        from mxtpu_torch import _build
        from mxtpu_torch.ops import rnn_scan
        from mxtpu_torch.ops import flash_attention as fa
    except ImportError as e:
        fail("the mxtpu_torch package is not beside this script (%s)" % e)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.time()

    # 1. the card
    card = card_line()
    print("device: %s | nvidia-smi: %s" % (torch.cuda.get_device_name(0),
                                           card))
    print("torch %s, CUDA %s" % (torch.__version__, torch.version.cuda))

    # 2. build
    t0 = time.time()
    _build.build_all()
    print("kernels built in %.1f s into %s" % (time.time() - t0,
                                                _build.build_dir()))
    for name in _build.SOURCES:
        for line in _build.build_log.get(name, "").splitlines():
            if "entry function" in line or "registers" in line or \
                    "spill stores" in line:
                print("  ptxas %s: %s" % (name, line.strip()))

    # 3. kernels against their plain versions
    rng = np.random.RandomState(args.seed)
    errs = {"lstm_scan": 0.0, "gru_scan": 0.0}
    for N in (1, 32):
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            a = lstm_args(rng, N, dtype, dev)
            got = rnn_scan.lstm_scan(*a)
            torch.cuda.synchronize()
            want = rnn_scan.lstm_scan_reference(*a)
            check_close("lstm_scan N=%d %s" % (N, dtype), got, want, tol)
            g = gru_args(rng, N, dtype, dev)
            got_g = rnn_scan.gru_scan(*g)
            torch.cuda.synchronize()
            want_g = rnn_scan.gru_scan_reference(*g)
            check_close("gru_scan N=%d %s" % (N, dtype), got_g, want_g, tol)
            e_l, e_g = max_err(got, want), max_err(got_g, want_g)
            print("check N=%d %s: lstm_scan max err %.3g, gru_scan max err "
                  "%.3g (tolerance %s)" % (N, dtype, e_l, e_g, tol))
            if dtype == torch.float32:
                errs["lstm_scan"] = max(errs["lstm_scan"], e_l)
                errs["gru_scan"] = max(errs["gru_scan"], e_g)
    # flash attention: the training slice's shape, the JAX package's check
    # shape, shard offsets that leave rows 0..63 fully masked (and a
    # partly visible key block), and lengths off the 64-row tile
    slice_shape = (LM_BATCH, LM_HEADS, LM_SEQ, LM_SEQ, LM_DIM // LM_HEADS)
    flash_errs, slice_in = check_flash(fa, rng, dev, *slice_shape,
                                       torch.float32, FLASH_F32_TOL)
    errs.update(flash_errs)
    long_in = {}
    for D in (64, 128):
        _e, long_in[D] = check_flash(fa, rng, dev, 1, 8, 8192, 8192, D,
                                     torch.bfloat16, FLASH_BF16_TOL)
    _e, masked = check_flash(fa, rng, dev, 1, 2, 128, 128, 32,
                             torch.float32, FLASH_F32_TOL, q_off=0, k_off=64)
    o, lse = fa.flash_fwd(masked["q"], masked["k"], masked["v"],
                          masked["offs"], True)
    if o[:, :64].abs().max() != 0 or not bool((lse[:, :64] == -1e30).all()):
        fail("fully-masked rows must give O = 0 and lse = -1e30")
    check_flash(fa, rng, dev, 1, 2, 128, 200, 64, torch.float32,
                FLASH_F32_TOL, q_off=150, k_off=20)
    check_flash(fa, rng, dev, 2, 3, 100, 72, 32, torch.float32,
                FLASH_F32_TOL)

    # 4.-5. serving: the LSTM LM, then its GRU variant
    workdir = os.path.join(_build.build_dir(), "smoke")
    os.makedirs(workdir, exist_ok=True)
    engine, launches = serve(mt, rnn_scan, "lstm", args.seed, REQUEST_ROWS,
                             workdir)
    if launches["lstm_scan"] != LAYERS * len(REQUEST_ROWS):
        fail("lstm_scan launched %d times for %d requests of a %d-layer LM"
             % (launches["lstm_scan"], len(REQUEST_ROWS), LAYERS))
    _gru_engine, gru_launches = serve(mt, rnn_scan, "gru", args.seed,
                                      GRU_REQUEST_ROWS, workdir)
    if gru_launches["gru_scan"] != LAYERS * len(GRU_REQUEST_ROWS):
        fail("gru_scan launched %d times for %d requests of a %d-layer LM"
             % (gru_launches["gru_scan"], len(GRU_REQUEST_ROWS), LAYERS))
    path_launches = {"lstm_scan": launches["lstm_scan"],
                     "gru_scan": gru_launches["gru_scan"]}

    # 6. training: the attention LM, 300 steps on the card
    params0 = lm_init_params(args.seed)
    batch_rng = np.random.RandomState(args.seed + 3)
    batches = [lm_batch(batch_rng, LM_BATCH) for _ in range(LM_STEPS)]
    cpu = torch.device("cpu")
    cpu_p, cpu_losses = lm_train(
        params0, [torch.from_numpy(b) for b in batches[:3]], cpu,
        impl="flash")
    gpu_batches = [torch.from_numpy(b).to(dev) for b in batches]
    gpu_p3, gpu_losses3 = lm_train(params0, gpu_batches[:3], dev)
    check_close("LM losses of steps 1-3, card vs CPU", [gpu_losses3.cpu()],
                [cpu_losses], LM_TOL)
    check_close("LM params after 3 steps, card vs CPU",
                [gpu_p3[k].cpu() for k in LM_PARAMS],
                [cpu_p[k] for k in LM_PARAMS], LM_TOL)
    lm_err = max(max_err([gpu_losses3.cpu()], [cpu_losses]),
                 max_err([gpu_p3[k].cpu() for k in LM_PARAMS],
                         [cpu_p[k] for k in LM_PARAMS]))
    print("slice train: steps 1-3 on the card vs the CPU (plain path): "
          "losses %s vs %s, max |card - cpu| over losses and params %.3g"
          % (["%.6f" % x for x in gpu_losses3.tolist()],
             ["%.6f" % x for x in cpu_losses.tolist()], lm_err))
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _p, losses = lm_train(params0, gpu_batches, dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    flash_launches = {k: fa.LAUNCHES[k] for k in
                      ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    losses = losses.cpu().numpy()
    path_launches.update(flash_launches)
    for name, n in flash_launches.items():
        if n != LM_STEPS:
            fail("%s launched %d times in %d training steps, want one a "
                 "step" % (name, n, LM_STEPS))
    if not np.isfinite(losses).all() or \
            losses[-1] >= 0.5 * np.log(LM_VOCAB):
        fail("the LM did not learn to copy: final nll %.4f (limit %.4f)"
             % (losses[-1], 0.5 * np.log(LM_VOCAB)))
    print("slice train: %d steps on %s in %.2f s, nll %s -> final %.4f "
          "(limit 0.5 ln %d = %.4f), launches %s"
          % (LM_STEPS, dev, train_s, ", ".join(
              "%d: %.4f" % (i, losses[i]) for i in range(0, LM_STEPS, 50)),
             losses[-1], LM_VOCAB, 0.5 * np.log(LM_VOCAB), flash_launches))

    # 7. the op entry: nd.flash_attention on the card
    q, k, v = (mt.nd.array(rng.standard_normal((2, 4, 128, 32)).astype(
        np.float32), ctx=mt.gpu(0)) for _ in range(3))
    fa.reset_launches()
    out = mt.nd.flash_attention(q, k, v, causal=True)
    if fa.LAUNCHES["flash_fwd"] != 1:
        fail("nd.flash_attention on the card launched flash_fwd %d times"
             % fa.LAUNCHES["flash_fwd"])
    want = fa.flash_attention_reference(q.data, k.data, v.data, causal=True)
    check_close("nd.flash_attention", [out.data], [want], FLASH_F32_TOL)
    print("op entry: nd.flash_attention on %s launched flash_fwd once, max "
          "|out - reference| %.3g" % (out.context,
                                       max_err([out.data], [want])))

    # 8. timings at the main paths' shapes
    N = BUCKETS[-1]
    kernels = []
    for name, make_args, plain, library, kind, replaces in (
            ("lstm_scan", lstm_args, rnn_scan.lstm_scan_reference,
             cudnn_lstm, "lstm", "mxtpu/ops/pallas_rnn.py:64"),
            ("gru_scan", gru_args, rnn_scan.gru_scan_reference,
             cudnn_gru, "gru", "mxtpu/ops/pallas_rnn.py:128")):
        a = make_args(rng, N, torch.float32, dev)
        kernel = getattr(rnn_scan, name)
        lib_call = library(*a)
        lib_err = max_err(lib_call(), plain(*a))
        ms = cuda_ms(lambda: kernel(*a))
        plain_ms = cuda_ms(lambda: plain(*a), iters=10)
        lib_ms = cuda_ms(lib_call)
        ms2 = cuda_ms(lambda: kernel(*a))
        bound_ms, bound_by = bound(kind, N)
        print("time %s T=%d N=%d H=%d f32: kernel %.4f ms (again %.4f), "
              "plain %.4f ms, cuDNN %.4f ms (max |cuDNN - plain| %.3g), "
              "bound %.5f ms (%s), %d launches per request | %s"
              % (name, SEQ, N, HIDDEN, ms, ms2, plain_ms, lib_ms, lib_err,
                 bound_ms, bound_by, LAYERS, card))
        kernels.append({
            "name": name, "route": "cuda",
            "source": "mxtpu_torch/csrc/rnn_scan.cu",
            "replaces": replaces, "launches": path_launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})

    # flash kernels: the training slice's shape (the JSON line) and the
    # JAX package's 8k check shape; SDPA's backward is timed as
    # forward+backward less forward and stands for dQ and dK/dV together
    replaces = {"flash_fwd": "mxtpu/ops/pallas_attention.py:142",
                "flash_bwd_dq": "mxtpu/ops/pallas_attention.py:236",
                "flash_bwd_dkv": "mxtpu/ops/pallas_attention.py:255"}
    for label, a, (B, H, T, D), iters in (
            ("slice", slice_in, (LM_BATCH, LM_HEADS, LM_SEQ,
                                 LM_DIM // LM_HEADS), 50),
            ("8k d64", long_in[64], (1, 8, 8192, 64), 10),
            ("8k d128", long_in[128], (1, 8, 8192, 128), 10)):
        itemsize = a["q"].element_size()
        sdpa_fwd, sdpa_fwd_bwd = sdpa_calls(a, B, H)
        lib_fwd = cuda_ms(sdpa_fwd, iters=iters)
        lib_bwd = cuda_ms(sdpa_fwd_bwd, iters=iters) - lib_fwd
        for name, (kernel, plain) in flash_calls(fa, a).items():
            ms = cuda_ms(kernel, iters=iters)
            plain_ms = cuda_ms(plain, iters=max(3, iters // 5))
            ms2 = cuda_ms(kernel, iters=iters)
            lib_ms = lib_fwd if name == "flash_fwd" else lib_bwd
            bound_ms, bound_by = flash_bound(name, B * H, T, T, D, itemsize)
            print("time %s %s B=%d H=%d T=%d D=%d %s causal: kernel %.4f ms "
                  "(again %.4f), plain %.4f ms, SDPA %s %.4f ms, bound "
                  "%.5f ms (%s), %.1f%% of bound | %s"
                  % (name, label, B, H, T, D, a["q"].dtype, ms, ms2,
                     plain_ms, "fwd" if name == "flash_fwd" else
                     "bwd (dQ+dK/dV)", lib_ms, bound_ms, bound_by,
                     100 * bound_ms / ms, card))
            if label == "slice":
                kernels.append({
                    "name": name, "route": "cuda",
                    "source": "mxtpu_torch/csrc/flash_attention.cu",
                    "replaces": replaces[name],
                    "launches": path_launches[name],
                    "max_abs_err": errs[name], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": lib_ms})

    # the serving slice's throughput at bucket 32, host clock around whole
    # requests
    req = np.random.RandomState(args.seed + 2).randint(
        0, VOCAB, (N, SEQ)).astype(np.float32)
    for _ in range(3):
        engine.predict([req])
    torch.cuda.synchronize()
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        engine.predict([req])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print("slice lstm bucket %d: %.2f requests/s, %.0f tokens scored/s "
          "(%.3f ms per request, numpy in and out) | %s"
          % (N, reps / dt, reps * N * SEQ / dt, dt / reps * 1e3, card))
    # where a request's time goes: the graph forward alone (tensors in and
    # out on the card), and the copy of its output to the host
    program = engine.program(N)
    params, aux, _version = engine._resolve_store(None)
    data = (torch.from_numpy(req).to(dev),)
    forward_ms = cuda_ms(lambda: program(data, params, aux), iters=reps)
    out = program(data, params, aux)[0]
    copy_ms = cuda_ms(lambda: out.cpu(), iters=reps)
    print("slice lstm bucket %d breakdown: graph forward %.3f ms, output "
          "copy to host (%.1f MB) %.3f ms, kernels %.3f ms (2 x lstm_scan) "
          "| %s" % (N, forward_ms, out.numel() * 4 / 1e6, copy_ms,
                    LAYERS * kernels[0]["ms"], card))
    busy, top = device_time(lambda: program(data, params, aux), 5)
    print("slice lstm bucket %d forward on the card: %.3f ms busy of %.3f "
          "ms; top kernels (ms per forward): %s"
          % (N, busy, forward_ms, top))

    # the training slice: ms per step and tokens/s (host clock around
    # whole steps ending in a synchronize), and where a step's device
    # time goes
    step_ms = train_s / LM_STEPS * 1e3
    print("slice train: %.3f ms per step over %d steps, %.0f tokens/s "
          "(batch %d x %d tokens) | %s"
          % (step_ms, LM_STEPS, LM_STEPS * LM_BATCH * LM_SEQ / train_s,
             LM_BATCH, LM_SEQ, card))
    few = gpu_batches[:10]
    busy, top = device_time(lambda: lm_train(params0, few, dev), 1,
                            per=len(few))
    print("slice train step on the card: %.3f ms busy of %.3f ms per step; "
          "per step: %s" % (busy, step_ms, top))
    print("total %.1f s" % (time.time() - t_start))

    # 9.-10. the result lines
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
