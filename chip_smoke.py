#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mxtpu_torch) on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. the card: its name, and name and power limit from nvidia-smi;
2. build the hand-written kernels from mxtpu_torch/csrc with nvcc;
3. hold each kernel against its plain PyTorch version on the card at the
   slice's shapes (T=32, H=200, N in {1, 32}; float32 and bfloat16);
4. the slice: a bucketed LSTM language model at the published widths of
   example/rnn/lstm_bucketing.py (vocab 10,000, embed 200, hidden 200,
   2 layers, 32 tokens), with weights drawn from --seed, checkpointed and
   served by InferenceEngine on cuda:0; every answer is checked against
   the same checkpoint served on the CPU (the plain path), and the LSTM
   kernel must have been launched once per layer per request;
5. the same model with mode="gru", which drives the GRU kernel;
6. timings: each kernel, its plain version and the cuDNN call computing
   the same function, beside the least time the card could take; the
   slice's requests/s and tokens scored/s at bucket 32;
7. one JSON line naming every kernel with its launches and error;
8. the last line: {"ok": true, "device": {...}}.

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

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and float32 outside
# the tensor cores, which is where these kernels compute
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12


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
    for line in _build.build_log.get("rnn_scan", "").splitlines():
        if "registers" in line:
            print("  ptxas: %s" % line.strip())

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

    # 4.-5. the slice: the LSTM LM, then its GRU variant
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

    # 6. timings at the main path's shapes (bucket 32, float32)
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

    # the slice's throughput at bucket 32, host clock around whole requests
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
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            program(data, params, aux)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in events) / 5 / 1e3
    print("slice lstm bucket %d forward on the card: %.3f ms busy of %.3f "
          "ms; top kernels (ms per forward): %s"
          % (N, busy, forward_ms, ", ".join(
              "%s %.3f" % (e.key[:40], e.self_device_time_total / 5 / 1e3)
              for e in events[:6])))
    print("total %.1f s" % (time.time() - t_start))

    # 7.-8. the result lines
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
