"""LSTM and GRU time loops: CUDA kernels and their plain versions.

Counterpart of ``mxtpu/ops/pallas_rnn.py``. :func:`lstm_scan` and
:func:`gru_scan` take the same arguments and return the same outputs as
the JAX functions of that name. On a CUDA tensor they launch the
hand-written kernels of ``csrc/rnn_scan.cu`` (built by ``_build.py``) or
raise; on a CPU tensor they run the plain PyTorch versions
:func:`lstm_scan_reference` / :func:`gru_scan_reference`, which mirror
``_scan_reference`` / ``_gru_scan_reference`` of the JAX package: carry
and gate math in f32, outputs cast back to the inputs' dtypes. On a
``meta`` tensor (shape inference) they return empty outputs of the
right shapes.

Gradients. On the CPU autograd differentiates the plain loop. On the
card, when grad mode is on and an input requires grad, the kernel runs
under :class:`_LstmScan` / :class:`_GruScan`, the counterparts of the JAX
``custom_vjp``s (``_vjp_fwd``/``_vjp_bwd``, ``_gru_vjp_fwd``/
``_gru_vjp_bwd``): the forward launches the kernel and saves its inputs,
the backward recomputes through the plain version on the same device and
differentiates that. The plain loop on the card is the reference's own
backward, which recomputes through ``lax.scan`` and has no Pallas kernel;
it does not stand in for the forward kernel, and it matches the kernel's
precision (f32 carry and gates, outputs cast back), so bf16 gradients
belong to the forward that ran. Without grad (serving runs under
``torch.inference_mode``) the wrappers launch the kernel directly.

Launch plan. :func:`scan_plan` is a pure function of the problem's
sizes and dtypes that fixes how the kernels of ``csrc/rnn_scan.cu`` cut
it: a thread-block cluster of ``cluster`` CTAs (8, or 16) owns ``rows``
batch rows, each CTA a slice of the hidden units (:func:`unit_slice`)
with their gate columns, 8 lanes a unit; the CTA's weight slice is ``"resident"`` in shared memory when it fits at
either cluster size, else ``"streamed"`` from global memory each step.
The wrapper refuses only a problem no plan takes (H above 2,048).

``LAUNCHES`` counts kernel launches per kernel; :func:`reset_launches`
zeroes it. Only a launch bumps it: a call recorded into a CUDA graph
capture launches nothing (the graph's node runs at each replay, which
its owner counts).
"""
from __future__ import annotations

import ctypes
from collections import namedtuple

import torch

__all__ = ["lstm_scan", "gru_scan", "lstm_scan_reference",
           "gru_scan_reference", "scan_plan", "unit_slice", "ScanPlan",
           "max_active_clusters", "LAUNCHES", "reset_launches"]

LAUNCHES = {"lstm_scan": 0, "gru_scan": 0}

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------

def lstm_scan_reference(x_proj, h0, c0, wh_t):
    """x_proj (T, N, 4H) gates [i, f, g, o], h0/c0 (N, H), wh_t (H, 4H).
    Returns ys (T, N, H) in x_proj's dtype, hT/cT in h0/c0's dtypes."""
    H = h0.shape[-1]
    wh32 = wh_t.float()
    h, c = h0.float(), c0.float()
    ys = []
    for t in range(x_proj.shape[0]):
        gates = x_proj[t].float() + h @ wh32
        i = torch.sigmoid(gates[:, 0 * H:1 * H])
        f = torch.sigmoid(gates[:, 1 * H:2 * H])
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:4 * H])
        c = f * c + i * g
        h = o * torch.tanh(c)
        ys.append(h.to(x_proj.dtype))
    ys = torch.stack(ys) if ys else x_proj.new_empty((0,) + tuple(h0.shape))
    return ys, h.to(h0.dtype), c.to(c0.dtype)


def gru_scan_reference(x_proj, h0, whrz_t, whn_t, bhn):
    """x_proj (T, N, 3H) gates [r, z, n] with the r/z recurrent bias
    folded in, h0 (N, H), whrz_t (H, 2H), whn_t (H, H), bhn (H,).
    Returns ys (T, N, H) in x_proj's dtype and hT in h0's dtype."""
    H = h0.shape[-1]
    whrz32, whn32, bhn32 = whrz_t.float(), whn_t.float(), bhn.float()
    h = h0.float()
    ys = []
    for t in range(x_proj.shape[0]):
        xp = x_proj[t].float()
        rz = torch.sigmoid(xp[:, :2 * H] + h @ whrz32)
        r, z = rz[:, :H], rz[:, H:]
        n = torch.tanh(xp[:, 2 * H:] + r * (h @ whn32 + bhn32))
        h = (1 - z) * n + z * h
        ys.append(h.to(x_proj.dtype))
    ys = torch.stack(ys) if ys else x_proj.new_empty((0,) + tuple(h0.shape))
    return ys, h.to(h0.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, tensors, shapes, dtypes, device):
    for (arg, t), shape, dtype in zip(tensors, shapes, dtypes):
        if t.device != device:
            raise ValueError("%s: %s is on %s, x_proj on %s"
                             % (name, arg, t.device, device))
        if tuple(t.shape) != tuple(shape):
            raise ValueError("%s: %s has shape %s, want %s"
                             % (name, arg, tuple(t.shape), tuple(shape)))
        if t.dtype != dtype:
            raise TypeError("%s: %s is %s, want %s"
                            % (name, arg, t.dtype, dtype))
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (name, arg))


def _check_dtypes(name, x_dtype, s_dtype):
    for d in (x_dtype, s_dtype):
        if d not in _KERNEL_DTYPES:
            raise TypeError("%s: the CUDA kernel takes float32 or bfloat16, "
                            "got %s" % (name, d))


# ---------------------------------------------------------------------------
# launch plan
# ---------------------------------------------------------------------------

# clusters of 8 and of 16 CTAs an H100 SXM (132 SMs) holds at one CTA an
# SM (cudaOccupancyMaxActiveClusters): a GPC hosts whole clusters, so
# fewer than 132 // C
CLUSTERS_AT_ONCE = {8: 15, 16: 7}
SMEM_LIMIT = 232448        # shared memory a block may use (227 KB)
MAX_THREADS = 1024
MAX_ROWS = 4               # batch rows a cluster (the kernel's template)
# (mode, cluster size) in the order tried: a resident slice first, at the
# portable size 8, then 16; streamed at 16 (half the weight a CTA reads
# each step), then 8
_CANDIDATES = (("resident", 8), ("resident", 16), ("streamed", 16),
               ("streamed", 8))

SPLIT = 8                  # lanes a unit (the kernel's SPLIT)
MAX_UNITS = MAX_THREADS // SPLIT

ScanPlan = namedtuple("ScanPlan", "cluster rows mode threads smem "
                                  "col_stride clusters")
ScanPlan.__doc__ = """How one lstm_scan/gru_scan launch cuts its problem:
cluster CTAs a cluster, rows batch rows a cluster, mode "resident" (the
weight slice in shared memory) or "streamed", threads and smem (bytes) a
CTA, col_stride the resident slice's padded column count, clusters in
the grid."""


def unit_slice(rank, H, C):
    """(first unit, units) of CTA ``rank`` of ``C``: the first H % C
    CTAs take one unit more (the kernel's ``unit_slice``)."""
    base, extra = divmod(H, C)
    return rank * base + min(rank, extra), base + (rank < extra)


def scan_plan(kind, T, N, H, x_dtype, s_dtype):
    """The launch plan (:class:`ScanPlan`) of ``kind`` ("lstm" or "gru")
    at sizes (T, N, H) and dtypes of x_proj/weights and of the state.
    A cluster takes ceil(N / CLUSTERS_AT_ONCE[cluster]) rows, at most 4,
    so that up to N = 60 every CTA has an SM of its own (at N = 32: 11
    clusters of 3 rows, 88 SMs). A unit owns SPLIT = 8 lanes and
    4 column slots (the GRU's fourth carries x_proj's n part), so a CTA
    takes at most 128 units. The resident slice is laid out
    [k/4][column][k%4] in x's dtype with an odd column count, so the 8
    lanes of a unit, which read 8 k-quads of one column, hit distinct
    banks; h takes 2 (step parity) x rows x H floats. Raises ValueError
    where no plan fits."""
    if kind not in ("lstm", "gru"):
        raise ValueError("scan_plan: kind %r, want 'lstm' or 'gru'" % kind)
    if T < 1 or N < 1 or H < 1:
        raise ValueError("%s_scan: empty problem T=%d N=%d H=%d"
                         % (kind, T, N, H))
    elem = torch.empty((), dtype=x_dtype).element_size()
    hq = -(-H // 4)
    per_warp = 32 // SPLIT
    for mode, C in _CANDIDATES:
        units = -(-H // C)
        if units > MAX_UNITS:
            continue
        warps = -(-units // per_warp)
        rows = min(MAX_ROWS, -(-N // CLUSTERS_AT_ONCE[C]))
        col_stride = 4 * per_warp * warps + 1
        smem = 16 + 2 * rows * 4 * hq * 4    # 2 mbarriers, h by parity
        if mode == "resident":
            smem += hq * col_stride * 4 * elem
        if smem <= SMEM_LIMIT:
            return ScanPlan(C, rows, mode, 32 * warps, smem, col_stride,
                            -(-N // rows))
    raise ValueError("%s_scan: H=%d exceeds the kernel (at most %d units a "
                     "CTA of a 16-CTA cluster: H <= %d)"
                     % (kind, H, MAX_UNITS, 16 * MAX_UNITS))


def _plan_args(plan):
    return (plan.cluster, plan.rows, int(plan.mode == "resident"),
            plan.col_stride, plan.threads, plan.smem)


def _check_sizes(name, T, N, H, x_dtype, s_dtype):
    """The plan of a launch; raises on what the kernel cannot take."""
    return scan_plan(name.split("_")[0], T, N, H, x_dtype, s_dtype)


def max_active_clusters(name, plan, N, x_dtype, s_dtype):
    """``cudaOccupancyMaxActiveClusters`` of the kernel ``name`` launched
    by ``plan`` over N rows: how many of its clusters the card holds at
    once."""
    from .._build import load
    out = ctypes.c_int(0)
    _raise_on(name, load("rnn_scan").mx_rnn_max_active_clusters(
        int(name == "gru_scan"), N, int(x_dtype == torch.bfloat16),
        int(s_dtype == torch.bfloat16), *_plan_args(plan),
        ctypes.byref(out)))
    return out.value


def _raise_on(name, err):
    if err != 0:
        raise RuntimeError("%s: CUDA kernel launch failed with cudaError %d"
                           % (name, err))


def _lstm_cuda(x_proj, h0, c0, wh_t):
    from .._build import load
    T, N, G = x_proj.shape
    H = h0.shape[-1]
    dev = x_proj.device
    if G != 4 * H:
        raise ValueError("lstm_scan: x_proj has %d gate columns, want 4H=%d"
                         % (G, 4 * H))
    xd, sd = x_proj.dtype, h0.dtype
    _check_dtypes("lstm_scan", xd, sd)
    plan = _check_sizes("lstm_scan", T, N, H, xd, sd)
    _check("lstm_scan", [("x_proj", x_proj), ("wh_t", wh_t), ("h0", h0),
                         ("c0", c0)],
           [(T, N, G), (H, G), (N, H), (N, H)], [xd, xd, sd, sd], dev)
    ys = torch.empty((T, N, H), dtype=xd, device=dev)
    hT = torch.empty((N, H), dtype=sd, device=dev)
    cT = torch.empty((N, H), dtype=sd, device=dev)
    lib = load("rnn_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mx_lstm_scan(
            x_proj.data_ptr(), wh_t.data_ptr(), h0.data_ptr(),
            c0.data_ptr(), ys.data_ptr(), hT.data_ptr(), cT.data_ptr(),
            T, N, H, int(xd == torch.bfloat16), int(sd == torch.bfloat16),
            *_plan_args(plan), stream)
    _raise_on("lstm_scan", err)
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["lstm_scan"] += 1
    return ys, hT, cT


def _gru_cuda(x_proj, h0, whrz_t, whn_t, bhn):
    from .._build import load
    T, N, G = x_proj.shape
    H = h0.shape[-1]
    dev = x_proj.device
    if G != 3 * H:
        raise ValueError("gru_scan: x_proj has %d gate columns, want 3H=%d"
                         % (G, 3 * H))
    xd, sd = x_proj.dtype, h0.dtype
    _check_dtypes("gru_scan", xd, sd)
    plan = _check_sizes("gru_scan", T, N, H, xd, sd)
    _check("gru_scan", [("x_proj", x_proj), ("whrz_t", whrz_t),
                        ("whn_t", whn_t), ("bhn", bhn), ("h0", h0)],
           [(T, N, G), (H, 2 * H), (H, H), (H,), (N, H)],
           [xd, xd, xd, xd, sd], dev)
    ys = torch.empty((T, N, H), dtype=xd, device=dev)
    hT = torch.empty((N, H), dtype=sd, device=dev)
    lib = load("rnn_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mx_gru_scan(
            x_proj.data_ptr(), whrz_t.data_ptr(), whn_t.data_ptr(),
            bhn.data_ptr(), h0.data_ptr(), ys.data_ptr(), hT.data_ptr(),
            T, N, H, int(xd == torch.bfloat16), int(sd == torch.bfloat16),
            *_plan_args(plan), stream)
    _raise_on("gru_scan", err)
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES["gru_scan"] += 1
    return ys, hT


def _recompute_vjp(reference, inputs, cots):
    """Gradients of ``reference`` at ``inputs`` under the cotangents
    ``cots`` (None: that output is unused, as zeros), recomputed on the
    inputs' device; each in its input's dtype."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        outs = reference(*leaves)
    used = [(o, c.to(o.dtype)) for o, c in zip(outs, cots) if c is not None]
    if not used:
        return (None,) * len(inputs)
    grads = torch.autograd.grad([o for o, _ in used], leaves,
                                [c for _, c in used])
    return tuple(g.to(t.dtype) for t, g in zip(inputs, grads))


class _LstmScan(torch.autograd.Function):
    """The LSTM kernel with the JAX package's backward (``_vjp_fwd`` /
    ``_vjp_bwd``): recompute through :func:`lstm_scan_reference`."""

    @staticmethod
    def forward(ctx, x_proj, h0, c0, wh_t):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x_proj, h0, c0, wh_t)
        return _lstm_cuda(x_proj, h0, c0, wh_t)

    @staticmethod
    def backward(ctx, dys, dhT, dcT):
        return _recompute_vjp(lstm_scan_reference, ctx.saved_tensors,
                              (dys, dhT, dcT))


class _GruScan(torch.autograd.Function):
    """The GRU kernel with the JAX package's backward (``_gru_vjp_fwd`` /
    ``_gru_vjp_bwd``): recompute through :func:`gru_scan_reference`."""

    @staticmethod
    def forward(ctx, x_proj, h0, whrz_t, whn_t, bhn):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x_proj, h0, whrz_t, whn_t, bhn)
        return _gru_cuda(x_proj, h0, whrz_t, whn_t, bhn)

    @staticmethod
    def backward(ctx, dys, dhT):
        return _recompute_vjp(gru_scan_reference, ctx.saved_tensors,
                              (dys, dhT))


def _wants_grad(args):
    return torch.is_grad_enabled() and any(t.requires_grad for t in args)


def _lstm_on_card(x_proj, h0, c0, wh_t):
    """lstm_scan's CUDA branch: the kernel, under :class:`_LstmScan`
    when autograd will ask for gradients."""
    if _wants_grad((x_proj, h0, c0, wh_t)):
        return _LstmScan.apply(x_proj, h0, c0, wh_t)
    return _lstm_cuda(x_proj, h0, c0, wh_t)


def _gru_on_card(x_proj, h0, whrz_t, whn_t, bhn):
    """gru_scan's CUDA branch: the kernel, under :class:`_GruScan` when
    autograd will ask for gradients."""
    if _wants_grad((x_proj, h0, whrz_t, whn_t, bhn)):
        return _GruScan.apply(x_proj, h0, whrz_t, whn_t, bhn)
    return _gru_cuda(x_proj, h0, whrz_t, whn_t, bhn)


def lstm_scan(x_proj, h0, c0, wh_t):
    """Fused LSTM over time (``mxtpu.ops.pallas_rnn.lstm_scan``).
    x_proj: (T, N, 4H) pre-projected inputs with biases, h0/c0: (N, H),
    wh_t: (H, 4H) transposed recurrent weights, gate order [i, f, g, o].
    Returns (ys (T, N, H), hT, cT); differentiable in every input."""
    kind = x_proj.device.type
    if kind == "cuda":
        return _lstm_on_card(x_proj, h0, c0, wh_t)
    if kind == "cpu":
        return lstm_scan_reference(x_proj, h0, c0, wh_t)
    if kind == "meta":
        T, N, _ = x_proj.shape
        return (x_proj.new_empty((T, N, h0.shape[-1])), torch.empty_like(h0),
                torch.empty_like(c0))
    raise ValueError("lstm_scan: no path for device %s" % x_proj.device)


def gru_scan(x_proj, h0, whrz_t, whn_t, bhn):
    """Fused GRU over time (``mxtpu.ops.pallas_rnn.gru_scan``).
    x_proj: (T, N, 3H) pre-projected inputs (x @ Wx + bi, with the r/z
    recurrent bias folded in), gate order [r, z, n]; h0: (N, H);
    whrz_t: (H, 2H); whn_t: (H, H); bhn: (H,). Returns (ys, hT);
    differentiable in every input."""
    kind = x_proj.device.type
    if kind == "cuda":
        return _gru_on_card(x_proj, h0, whrz_t, whn_t, bhn)
    if kind == "cpu":
        return gru_scan_reference(x_proj, h0, whrz_t, whn_t, bhn)
    if kind == "meta":
        T, N, _ = x_proj.shape
        return x_proj.new_empty((T, N, h0.shape[-1])), torch.empty_like(h0)
    raise ValueError("gru_scan: no path for device %s" % x_proj.device)
