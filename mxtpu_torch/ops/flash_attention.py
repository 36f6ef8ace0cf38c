"""Flash attention, forward and backward: CUDA kernels and their plain
versions.

Counterpart of ``mxtpu/ops/pallas_attention.py``, with the same public
functions, arguments and ``[B, H, T, D]`` layout:
:func:`flash_attention`, :func:`flash_attention_with_lse` and
:func:`flash_attention_reference`. A ``torch.autograd.Function`` takes
the place of the JAX ``custom_vjp``: its forward runs the forward kernel,
its backward folds the lse cotangent into ``delta = rowsum(dO*O) - dlse``
(plain torch, as the JAX package computes it outside its kernels) and
runs the dQ and dK/dV kernels.

On a CUDA tensor each of the three launches a hand-written kernel
(built by ``_build.py``) or raises; the wrapper picks the kernel from
the dtype before the launch:

- bfloat16, head dim 16, 32, 64 or 128: all three run on tensor cores
  (wgmma, tiles brought in by TMA), ``csrc/flash_attention_sm90.cu``;
- float32, head dim 16, 32, 64 or 128: all three run on the CUDA cores,
  ``csrc/flash_attention.cu`` (f32 does not go through the tensor cores:
  TF32 would not hold the plain versions' 1e-5).

:func:`flash_attention` fits the other problems that ``mxtpu``'s
Pallas kernels take to these kernels before the launch (:func:`_fit`): a
head dim below 128 is zero-padded to the next of 16, 32, 64 or 128 (the
scale stays that of the true head dim, and O and the gradients are
sliced back), float16 runs the float32 kernels on widened copies (the
Pallas kernels compute in f32 too, and O is rounded back to float16),
and a tensor whose base is off a 16-byte boundary is copied into fresh
storage. A head dim above 128, or any other dtype, raises before a
launch: a known difference from ``mxtpu``. The bf16 kernels
round P and dS to bf16 before P.V, dS.K, P^T.dO and dS^T.Q, as the TPU's
one-pass bf16 dot does; :func:`flash_fwd_bf16p_plain`,
:func:`flash_bwd_dq_bf16p_plain` and :func:`flash_bwd_dkv_bf16p_plain`
model that rounding (tests and ``chip_smoke.py`` use them; no path does).
On a CPU tensor each runs its plain PyTorch version (:func:`flash_fwd_plain`,
:func:`flash_bwd_dq_plain`, :func:`flash_bwd_dkv_plain`), which computes
what the Pallas kernel computes: the same masks, a fully-masked row gives
O = 0 and lse = ``_NEG``, outputs in the inputs' dtypes and lse in f32.
On a ``meta`` tensor (shape inference) the forward returns empty outputs
of the right shapes.

The kernels mask rows and keys past T themselves, so nothing is padded
to a tile multiple; ``block_q``/``block_k`` stay in the signatures for
the JAX package's callers and do not change the result (the CUDA kernels
pick their own tiles, 32 or 64 rows, whatever they ask).

``LAUNCHES`` counts kernel launches per kernel (``flash_fwd``,
``flash_bwd_dq`` and ``flash_bwd_dkv`` for the f32 kernels,
``flash_fwd_sm90``, ``flash_bwd_dq_sm90`` and ``flash_bwd_dkv_sm90`` for
the bf16 ones); :func:`reset_launches` zeroes it. Only a launch bumps
it.
"""
from __future__ import annotations

import math

import torch

__all__ = ["flash_attention", "flash_attention_with_lse",
           "flash_attention_reference", "flash_fwd_plain",
           "flash_bwd_dq_plain", "flash_bwd_dkv_plain",
           "flash_fwd_bf16p_plain", "flash_bwd_dq_bf16p_plain",
           "flash_bwd_dkv_bf16p_plain", "LAUNCHES", "reset_launches"]

_NEG = -1e30  # large-negative instead of finfo.min: exp() underflows to 0
              # without inf - inf = nan hazards in the running-max rescale

LAUNCHES = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "flash_fwd_sm90": 0, "flash_bwd_dq_sm90": 0,
            "flash_bwd_dkv_sm90": 0}

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_HEAD_DIMS = (16, 32, 64, 128)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the reference the kernels are held to).
# Layout as the kernels see it: q (BH, Tq, D), k/v (BH, Tk, D), lse and
# delta (BH, Tq) f32, offs = [q_offset, k_offset, kv_len, scale] f32.
# ---------------------------------------------------------------------------

def _mask(offs, tq, tk, causal, device):
    """Live (query, key) pairs as the Pallas kernels' ``tile_mask``."""
    q_off, k_off, kv_len = (offs[i].to(torch.int32) for i in range(3))
    kj = torch.arange(tk, device=device)
    mask = (kj < kv_len)[None, :].expand(tq, tk)
    if causal:
        qi = q_off + torch.arange(tq, device=device)
        mask = mask & (qi[:, None] >= (k_off + kj)[None, :])
    return mask


def _fwd_plain(q, k, v, offs, causal, p_bf16):
    mask = _mask(offs, q.shape[1], k.shape[1], causal, q.device)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * offs[3]
    s = torch.where(mask, s, _NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    pv = p.to(torch.bfloat16).float() if p_bf16 else p
    o = torch.matmul(pv, v.float()) / l_safe
    lse = torch.where(l == 0.0, _NEG, m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def flash_fwd_plain(q, k, v, offs, causal):
    """What ``fwd_kernel`` computes: (o (BH, Tq, D) in q's dtype,
    lse (BH, Tq) f32)."""
    return _fwd_plain(q, k, v, offs, causal, False)


def _probs_and_ds(q, k, v, dout, lse, delta, offs, causal):
    mask = _mask(offs, q.shape[1], k.shape[1], causal, q.device)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * offs[3]
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(dout.float(), v.float().transpose(1, 2))
    return p, p * (dp - delta[..., None]) * offs[3]


def flash_bwd_dq_plain(q, k, v, dout, lse, delta, offs, causal):
    """What ``bwd_dq_kernel`` computes: dQ in q's dtype."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, offs, causal)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_fwd_bf16p_plain(q, k, v, offs, causal):
    """:func:`flash_fwd_plain` with P rounded to bf16 before P.V (the sum
    l stays f32), as the bf16 kernels and the TPU's one-pass dot compute
    it. A model of the rounding for tests and ``chip_smoke.py``."""
    return _fwd_plain(q, k, v, offs, causal, True)


def flash_bwd_dq_bf16p_plain(q, k, v, dout, lse, delta, offs, causal):
    """:func:`flash_bwd_dq_plain` with dS rounded to bf16 before dS.K, as
    the bf16 kernel computes it; for tests and ``chip_smoke.py``."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, delta, offs, causal)
    return torch.matmul(ds.to(torch.bfloat16).float(), k.float()).to(q.dtype)


def _dkv_plain(q, k, v, dout, lse, delta, offs, causal, bf16):
    p, ds = _probs_and_ds(q, k, v, dout, lse, delta, offs, causal)
    if bf16:
        p, ds = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    dv = torch.matmul(p.transpose(1, 2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dkv_plain(q, k, v, dout, lse, delta, offs, causal):
    """What ``bwd_dkv_kernel`` computes: (dK, dV) in k's and v's dtypes."""
    return _dkv_plain(q, k, v, dout, lse, delta, offs, causal, False)


def flash_bwd_dkv_bf16p_plain(q, k, v, dout, lse, delta, offs, causal):
    """:func:`flash_bwd_dkv_plain` with P^T and dS^T rounded to bf16
    before P^T.dO and dS^T.Q, as the bf16 kernel computes them; for tests
    and ``chip_smoke.py``."""
    return _dkv_plain(q, k, v, dout, lse, delta, offs, causal, True)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, tensors, shapes, dtypes, device):
    for (arg, t), shape, dtype in zip(tensors, shapes, dtypes):
        if t.device != device:
            raise ValueError("%s: %s is on %s, q on %s"
                             % (name, arg, t.device, device))
        if tuple(t.shape) != tuple(shape):
            raise ValueError("%s: %s has shape %s, want %s"
                             % (name, arg, tuple(t.shape), tuple(shape)))
        if t.dtype != dtype:
            raise TypeError("%s: %s is %s, want %s"
                            % (name, arg, t.dtype, dtype))
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (name, arg))


def _check_problem(name, q, k, v):
    """Raise where the kernels do not take attention over q (BH, Tq, D),
    k and v (BH, Tk, D): they take float32 or bfloat16 alike, head dim 16,
    32, 64 or 128, nothing empty. :func:`flash_attention_with_lse` fits
    other head dims up to 128 and float16 to that first (:func:`_fit`)."""
    d = q.shape[-1]
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError("%s: the CUDA kernel takes float32 or bfloat16, got "
                        "%s" % (name, q.dtype))
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("%s: k and v must have q's dtype %s, got %s and %s"
                        % (name, q.dtype, k.dtype, v.dtype))
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError("%s: the CUDA kernel takes head dims %s, got %d"
                         % (name, _KERNEL_HEAD_DIMS, d))
    if k.shape[-1] != d or v.shape != k.shape:
        raise ValueError("%s: k and v must share q's head dim and each "
                         "other's shape, got q %s, k %s, v %s"
                         % (name, tuple(q.shape), tuple(k.shape),
                            tuple(v.shape)))
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("%s: empty problem: q %s, k %s"
                         % (name, tuple(q.shape), tuple(k.shape)))
    return q.shape[0], q.shape[1], k.shape[1], d


_ERR_NO_ENCODER, _ERR_ENCODE = 10000, 10001   # csrc/flash_attention_sm90.cu


def _raise_on(name, err):
    if err == _ERR_NO_ENCODER:
        raise RuntimeError("%s: libcuda has no cuTensorMapEncodeTiled"
                           % name)
    if err >= _ERR_ENCODE:
        raise RuntimeError("%s: cuTensorMapEncodeTiled failed with CUresult "
                           "%d" % (name, err - _ERR_ENCODE))
    if err != 0:
        raise RuntimeError("%s: CUDA kernel launch failed with cudaError %d"
                           % (name, err))


def _sm90(name, tensors):
    """True when the bf16 kernels of ``csrc/flash_attention_sm90.cu`` take
    the problem: bf16 inputs (every head dim the wrapper accepts); f32
    goes to ``csrc/flash_attention.cu``. Their tensor maps need 16-byte
    aligned bases."""
    if tensors[0].dtype != torch.bfloat16:
        return False
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("%s: the bf16 kernel needs 16-byte aligned "
                             "tensors" % name)
    return True


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _fwd_cuda(q, k, v, offs, causal):
    from .._build import load
    bh, tq, tk, d = _check_problem("flash_fwd", q, k, v)
    dev, dt = q.device, q.dtype
    _check("flash_fwd", [("q", q), ("k", k), ("v", v), ("offs", offs)],
           [(bh, tq, d), (bh, tk, d), (bh, tk, d), (4,)],
           [dt, dt, dt, torch.float32], dev)
    o = torch.empty((bh, tq, d), dtype=dt, device=dev)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=dev)
    if _sm90("flash_fwd", (q, k, v)):
        lib = load("flash_attention_sm90")
        with torch.cuda.device(dev):
            err = lib.mx_flash_fwd_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), offs.data_ptr(),
                o.data_ptr(), lse.data_ptr(), bh, tq, tk, d, int(causal),
                _stream(dev))
        _raise_on("flash_fwd_sm90", err)
        LAUNCHES["flash_fwd_sm90"] += 1
        return o, lse
    lib = load("flash_attention")
    with torch.cuda.device(dev):
        err = lib.mx_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), offs.data_ptr(),
            o.data_ptr(), lse.data_ptr(), bh, tq, tk, d, int(causal),
            int(dt == torch.bfloat16), _stream(dev))
    _raise_on("flash_fwd", err)
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def _bwd_args(name, q, k, v, dout, lse, delta, offs):
    bh, tq, tk, d = _check_problem(name, q, k, v)
    dt = q.dtype
    _check(name, [("q", q), ("k", k), ("v", v), ("dout", dout), ("lse", lse),
                  ("delta", delta), ("offs", offs)],
           [(bh, tq, d), (bh, tk, d), (bh, tk, d), (bh, tq, d), (bh, tq),
            (bh, tq), (4,)],
           [dt, dt, dt, dt, torch.float32, torch.float32, torch.float32],
           q.device)
    return bh, tq, tk, d


def _bwd_dq_cuda(q, k, v, dout, lse, delta, offs, causal):
    from .._build import load
    bh, tq, tk, d = _bwd_args("flash_bwd_dq", q, k, v, dout, lse, delta, offs)
    dev = q.device
    dq = torch.empty_like(q)
    if _sm90("flash_bwd_dq", (q, k, v, dout)):
        lib = load("flash_attention_sm90")
        with torch.cuda.device(dev):
            err = lib.mx_flash_bwd_dq_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), offs.data_ptr(),
                dq.data_ptr(), bh, tq, tk, d, int(causal), _stream(dev))
        _raise_on("flash_bwd_dq_sm90", err)
        LAUNCHES["flash_bwd_dq_sm90"] += 1
        return dq
    lib = load("flash_attention")
    with torch.cuda.device(dev):
        err = lib.mx_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), offs.data_ptr(), dq.data_ptr(),
            bh, tq, tk, d, int(causal), int(q.dtype == torch.bfloat16),
            _stream(dev))
    _raise_on("flash_bwd_dq", err)
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _bwd_dkv_cuda(q, k, v, dout, lse, delta, offs, causal):
    from .._build import load
    bh, tq, tk, d = _bwd_args("flash_bwd_dkv", q, k, v, dout, lse, delta,
                              offs)
    dev = q.device
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if _sm90("flash_bwd_dkv", (q, k, v, dout)):
        lib = load("flash_attention_sm90")
        with torch.cuda.device(dev):
            err = lib.mx_flash_bwd_dkv_sm90(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), offs.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), bh, tq, tk, d, int(causal),
                _stream(dev))
        _raise_on("flash_bwd_dkv_sm90", err)
        LAUNCHES["flash_bwd_dkv_sm90"] += 1
        return dk, dv
    lib = load("flash_attention")
    with torch.cuda.device(dev):
        err = lib.mx_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), offs.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), bh, tq, tk, d, int(causal),
            int(q.dtype == torch.bfloat16), _stream(dev))
    _raise_on("flash_bwd_dkv", err)
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


def _route(name, t):
    kind = t.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError("%s: no path for device %s" % (name, t.device))
    return kind == "cuda"


def flash_fwd(q, k, v, offs, causal):
    """Forward kernel on a CUDA tensor, its plain version on a CPU one."""
    if _route("flash_fwd", q):
        return _fwd_cuda(q, k, v, offs, causal)
    return flash_fwd_plain(q, k, v, offs, causal)


def flash_bwd_dq(q, k, v, dout, lse, delta, offs, causal):
    if _route("flash_bwd_dq", q):
        return _bwd_dq_cuda(q, k, v, dout, lse, delta, offs, causal)
    return flash_bwd_dq_plain(q, k, v, dout, lse, delta, offs, causal)


def flash_bwd_dkv(q, k, v, dout, lse, delta, offs, causal):
    if _route("flash_bwd_dkv", q):
        return _bwd_dkv_cuda(q, k, v, dout, lse, delta, offs, causal)
    return flash_bwd_dkv_plain(q, k, v, dout, lse, delta, offs, causal)


class _FlashWithLse(torch.autograd.Function):
    """(o, lse) of flattened q (BH, Tq, D), k/v (BH, Tk, D); offs gets no
    gradient. A missing cotangent (lse unused, say) reaches backward as
    zeros: autograd materializes it."""

    @staticmethod
    def forward(ctx, q, k, v, offs, causal):
        o, lse = flash_fwd(q, k, v, offs, causal)
        ctx.save_for_backward(q, k, v, offs, o, lse)
        ctx.causal = causal
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, offs, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        # fold the lse cotangent into delta: ds = p*(dp - (delta - dlse))
        delta = ((do.float() * o.float()).sum(-1) - dlse.float()).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, offs, ctx.causal)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, offs, ctx.causal)
        return dq, dk, dv, None, None


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _offs(q_offset, k_offset, tk, scale, device):
    """The 4-float device vector the kernels read, built without a host
    sync: offsets may be ints or 0-d tensors already on the device."""
    vals = (q_offset, k_offset, tk, scale)
    if not any(isinstance(x, torch.Tensor) for x in vals):
        return torch.tensor([float(x) for x in vals], dtype=torch.float32,
                            device=device)
    return torch.stack([
        x.to(device=device, dtype=torch.float32).reshape(())
        if isinstance(x, torch.Tensor)
        else torch.tensor(float(x), dtype=torch.float32, device=device)
        for x in vals])


def _prep(q, tk, scale, q_offset, k_offset):
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if isinstance(scale, torch.Tensor):
        # A tensor scale is folded into Q (s = (q*scale).k) so its gradient
        # flows through ordinary autograd of the multiply: the Function
        # gives offs no gradient, which would drop d(loss)/d(scale).
        q = q * scale.to(q.dtype)
        scale = 1.0
    return q, _offs(q_offset, k_offset, tk, float(scale), q.device)


def _fit(x):
    """x [B, H, T, D] as the kernels take it: float16 widened to float32,
    the head dim zero-padded to the next of ``_KERNEL_HEAD_DIMS`` (one
    above 128 stays, for the wrappers to refuse), flattened to
    (BH, T, D'), its base 16-byte aligned (the bf16 kernels' tensor maps
    need that; a contiguous view can sit off it)."""
    b, h, t, d = x.shape
    if x.dtype == torch.float16:
        x = x.float()
    dk = next((n for n in _KERNEL_HEAD_DIMS if n >= d), d)
    if dk != d:
        x = torch.nn.functional.pad(x, (0, dk - d))
    x = x.contiguous().reshape(b * h, t, dk)
    return x.clone() if x.data_ptr() % 16 else x


def flash_attention_with_lse(q, k, v, causal=False, scale=None, q_offset=0,
                             k_offset=0, block_q=512, block_k=1024):
    """Like :func:`flash_attention` but also returns the per-row
    log-sum-exp ``lse`` [B, H, T] (float32; ``-1e30`` for fully-masked
    rows). Partial results over disjoint K/V shards combine exactly via
    ``lse' = logaddexp(lse1, lse2); o' = o1*exp(lse1 - lse') +
    o2*exp(lse2 - lse')``. Both outputs are differentiable."""
    if q.device.type == "meta":
        return torch.empty_like(q), q.new_empty(q.shape[:3],
                                                dtype=torch.float32)
    q, offs = _prep(q, k.shape[2], scale, q_offset, k_offset)
    b, h, tq, d = q.shape
    o, lse = _FlashWithLse.apply(_fit(q), _fit(k), _fit(v), offs,
                                 bool(causal))
    return (o[..., :d].to(q.dtype).reshape(b, h, tq, d),
            lse.reshape(b, h, tq))


def flash_attention(q, k, v, causal=False, scale=None, q_offset=0,
                    k_offset=0, block_q=512, block_k=1024):
    """Flash attention. q, k, v: [B, H, T, D].

    ``q_offset``/``k_offset`` are the global sequence positions of the
    first local Q/K row (ints or 0-d tensors, read on the device), so
    causal masks stay right when T is a shard of a longer sequence.
    ``scale`` (default 1/sqrt(D)) may be a tensor, whose gradient flows.
    Differentiable: the backward recomputes the probabilities from the
    saved lse, flash-attention-2 style. On a CUDA tensor it runs the
    kernels (float32, bfloat16 or float16, head dims up to 128; the module
    docstring says which kernel takes which, and how a head dim or dtype
    they lack is fitted to them); on a CPU tensor their plain versions,
    fitted alike."""
    return flash_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                    q_offset=q_offset, k_offset=k_offset,
                                    block_q=block_q, block_k=block_k)[0]


def flash_attention_reference(q, k, v, causal=False, scale=None,
                              q_offset=0, k_offset=0):
    """Plain softmax attention, as ``mxtpu``'s reference: a fully-masked
    row gets the mean of v (the softmax of a constant row), where the
    kernels give 0."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = q_offset + torch.arange(q.shape[2], device=q.device)
        ki = k_offset + torch.arange(k.shape[2], device=q.device)
        s = torch.where((qi[:, None] >= ki[None, :])[None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
