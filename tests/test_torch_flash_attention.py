"""The port's flash attention (mxtpu_torch/ops/flash_attention.py) against
mxtpu's Pallas kernels (interpret mode on the CPU, as
tests/test_pallas_attention.py runs them) and its XLA reference, on the
same seeded inputs: every case of that file, values and gradients.

On the CPU the wrappers run their plain PyTorch versions; the CUDA
kernels are held against those same plain versions on the card by
chip_smoke.py.

Tolerances: float32 2e-5 on values and 3e-5 on gradients, as the JAX
file holds its kernels to its reference (sums in another order). bf16 is
compared in the working type: both sides compute in f32 from the same
bf16 inputs and round each output once, so a last-bit f32 difference can
flip one bf16 rounding, at most 2^-7 of the value. The bf16 kernels on
the card (forward, dQ, dK/dV) also round P and dS to bf16 before their
products; their model (flash_*_bf16p_plain) is held here to the allowance
that chip_smoke.py derives for them (SM90_*) and then holds them to.
"""
import importlib
import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mxtpu.ops import pallas_attention as jfa
from mxtpu_torch.ops import flash_attention as fa
from torch_threads import torch_threads_shared  # noqa: F401

F32_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=3e-5, rtol=3e-5)
BF16_TOL = dict(atol=2.0 ** -8, rtol=2.0 ** -7)
BLOCKS = dict(block_q=64, block_k=64)


def _arrays(shapes, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _torch(arrays, dtype=torch.float32, grad=False):
    return [torch.from_numpy(a).to(dtype).requires_grad_(grad)
            for a in arrays]


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, tol):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np32(got), _np32(want), **tol)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,causal,seed", [
    ((2, 3, 128, 64), False, 0),       # test_forward_matches_reference
    ((1, 2, 128, 32), True, 7),        # test_forward_causal
    ((1, 2, 256, 32), True, 3),        # test_forward_multi_block
], ids=["non_causal", "causal", "multi_block"])
def test_forward_matches_mxtpu(shape, causal, seed):
    a = _arrays([shape] * 3, seed)
    want = jfa.flash_attention(*_jax(a), causal=causal, **BLOCKS)
    ref = jfa.flash_attention_reference(*_jax(a), causal=causal)
    got = fa.flash_attention(*_torch(a), causal=causal, **BLOCKS)
    _close(got, want, F32_TOL)
    _close(got, ref, F32_TOL)
    _close(fa.flash_attention_reference(*_torch(a), causal=causal), ref,
           F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_unpadded_lengths(causal):
    # T not a multiple of the block: mxtpu pads and masks, the port masks
    a = _arrays([(1, 2, 100, 32), (1, 2, 72, 32), (1, 2, 72, 32)], 1)
    want = jfa.flash_attention(*_jax(a), causal=causal, **BLOCKS)
    got = fa.flash_attention(*_torch(a), causal=causal, **BLOCKS)
    _close(got, want, F32_TOL)
    _close(got, jfa.flash_attention_reference(*_jax(a), causal=causal),
           F32_TOL)


@pytest.mark.parametrize("q_offset,k_offset", [(64, 0), (0, 32), (0, 64)],
                         ids=["visible", "partly_masked", "fully_masked"])
def test_sequence_shard_offsets(q_offset, k_offset):
    a = _arrays([(1, 1, 64, 32)] * 3, 11)
    kw = dict(causal=True, q_offset=q_offset, k_offset=k_offset, **BLOCKS)
    o_want, lse_want = jfa.flash_attention_with_lse(*_jax(a), **kw)
    o, lse = fa.flash_attention_with_lse(*_torch(a), **kw)
    _close(o, o_want, F32_TOL)
    _close(lse, lse_want, F32_TOL)
    assert torch.isfinite(o).all()
    if k_offset == 64:
        # fully-masked rows: O = 0 and lse = -1e30, as the kernel gives
        # (the reference would give the mean of v)
        assert float(o.abs().max()) == 0.0
        assert bool((lse == fa._NEG).all())
    else:
        # rows that see at least one key match the reference
        seen = slice(max(0, k_offset - q_offset), None)
        ref = jfa.flash_attention_reference(
            *_jax(a), causal=True, q_offset=q_offset, k_offset=k_offset)
        _close(o[:, :, seen], ref[:, :, seen], F32_TOL)


@pytest.mark.parametrize("k_offset", [0, 64])
def test_offset_gradients_match_mxtpu(k_offset):
    """Shard offsets through the backward, fully-masked rows included:
    no NaN, and the interpreter's gradients."""
    a = _arrays([(1, 1, 64, 32)] * 3, 13)
    kw = dict(causal=True, q_offset=64 - k_offset, k_offset=k_offset,
              **BLOCKS)
    want = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(
        jfa.flash_attention(q, k, v, **kw))), argnums=(0, 1, 2))(*_jax(a))
    t = _torch(a, grad=True)
    torch.sin(fa.flash_attention(*t, **kw)).sum().backward()
    for x, w in zip(t, want):
        assert torch.isfinite(x.grad).all()
        _close(x.grad, w, GRAD_TOL)


def test_tensor_offsets():
    # offsets as 0-d tensors (traced values in JAX) read on the device
    a = _arrays([(1, 1, 64, 32)] * 3, 5)
    want = jax.jit(lambda qo: jfa.flash_attention(
        *_jax(a), causal=True, q_offset=qo, k_offset=0, **BLOCKS))(
            jnp.int32(64))
    got = fa.flash_attention(*_torch(a), causal=True,
                             q_offset=torch.tensor(64), k_offset=0, **BLOCKS)
    _close(got, want, F32_TOL)
    _close(got, jfa.flash_attention_reference(*_jax(a), causal=True,
                                              q_offset=64), F32_TOL)


def test_bf16_inputs():
    a = _arrays([(1, 2, 128, 64)] * 3, 0)
    want = jfa.flash_attention(*_jax(a, jnp.bfloat16), **BLOCKS)
    got = fa.flash_attention(*_torch(a, torch.bfloat16), **BLOCKS)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)
    # and against the f32 reference, as the JAX file checks
    ref = jfa.flash_attention_reference(*_jax(a, jnp.bfloat16))
    np.testing.assert_allclose(_np32(got), _np32(ref), atol=3e-2, rtol=3e-2)


def test_bf16_gradients_keep_dtypes():
    a = _arrays([(1, 1, 64, 32)] * 3, 3)
    want = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, causal=True, **BLOCKS).astype(jnp.float32) ** 2),
        argnums=(0, 1, 2))(*_jax(a, jnp.bfloat16))
    t = _torch(a, torch.bfloat16, grad=True)
    o, lse = fa.flash_attention_with_lse(*t, causal=True, **BLOCKS)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    (o.float() ** 2).sum().backward()
    for x, w in zip(t, want):
        assert x.grad.dtype == torch.bfloat16
        _close(x.grad, w, BF16_TOL)


def test_with_lse_matches_logsumexp():
    a = _arrays([(1, 2, 128, 32)] * 3, 61)
    o, lse = fa.flash_attention_with_lse(*_torch(a), **BLOCKS)
    q, k = _jax(a)[:2]
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / q.shape[-1] ** 0.5
    _close(lse, jax.scipy.special.logsumexp(s, axis=-1), F32_TOL)
    _o, lse_want = jfa.flash_attention_with_lse(*_jax(a), **BLOCKS)
    _close(lse, lse_want, F32_TOL)


def test_lse_merge_rule():
    # attention over [K1; K2] == lse-merge of attention over K1 and K2
    q, k, v = _torch(_arrays([(1, 1, 64, 32), (1, 1, 128, 32),
                              (1, 1, 128, 32)], 71))
    o1, l1 = fa.flash_attention_with_lse(q, k[:, :, :64], v[:, :, :64])
    o2, l2 = fa.flash_attention_with_lse(q, k[:, :, 64:], v[:, :, 64:])
    lm = torch.logaddexp(l1, l2)
    om = (o1 * torch.exp(l1 - lm)[..., None]
          + o2 * torch.exp(l2 - lm)[..., None])
    full = jfa.flash_attention_reference(*_jax([q.numpy(), k.numpy(),
                                                v.numpy()]))
    _close(om, full, F32_TOL)


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_mxtpu(causal):
    a = _arrays([(1, 2, 128, 32)] * 3, 21)

    def loss_jax(fn):
        return jax.grad(lambda q, k, v: jnp.sum(jnp.sin(fn(q, k, v))),
                        argnums=(0, 1, 2))(*_jax(a))
    g_flash = loss_jax(lambda *x: jfa.flash_attention(*x, causal=causal,
                                                      **BLOCKS))
    g_ref = loss_jax(lambda *x: jfa.flash_attention_reference(
        *x, causal=causal))
    t = _torch(a, grad=True)
    torch.sin(fa.flash_attention(*t, causal=causal, **BLOCKS)).sum() \
        .backward()
    for x, w, r in zip(t, g_flash, g_ref):
        _close(x.grad, w, GRAD_TOL)
        _close(x.grad, r, GRAD_TOL)


def test_gradients_unpadded():
    a = _arrays([(1, 1, 96, 32), (1, 1, 80, 32), (1, 1, 80, 32)], 31)
    want = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention(
        q, k, v, causal=True, **BLOCKS) ** 2), argnums=(0, 1, 2))(*_jax(a))
    t = _torch(a, grad=True)
    (fa.flash_attention(*t, causal=True, **BLOCKS) ** 2).sum().backward()
    for x, w in zip(t, want):
        _close(x.grad, w, GRAD_TOL)


def test_with_lse_gradients():
    # dlse enters the backward through delta
    a = _arrays([(1, 1, 64, 16)] * 3, 81)

    def loss_jax(q, k, v):
        o, lse = jfa.flash_attention_with_lse(q, k, v, **BLOCKS)
        return jnp.sum(o ** 2) + jnp.sum(jnp.sin(lse))
    want = jax.grad(loss_jax, argnums=(0, 1, 2))(*_jax(a))
    t = _torch(a, grad=True)
    o, lse = fa.flash_attention_with_lse(*t, **BLOCKS)
    ((o ** 2).sum() + torch.sin(lse).sum()).backward()
    for x, w in zip(t, want):
        _close(x.grad, w, GRAD_TOL)


def test_lse_alone_is_differentiable():
    # only lse used: the o cotangent is zero and dlse carries everything
    q, k, v = _torch(_arrays([(1, 1, 64, 16)] * 3, 83), grad=True)
    _o, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
    lse.sum().backward()
    want = jax.grad(lambda q, k, v: jnp.sum(jfa.flash_attention_with_lse(
        q, k, v, causal=True, **BLOCKS)[1]), argnums=(0, 1))(
            *_jax([q.detach().numpy(), k.detach().numpy(),
                   v.detach().numpy()]))
    _close(q.grad, want[0], GRAD_TOL)
    _close(k.grad, want[1], GRAD_TOL)
    assert float(v.grad.abs().max()) == 0.0


def test_tensor_scale():
    a = _arrays([(1, 1, 64, 32)] * 3, 91)
    want = jax.jit(lambda s: jfa.flash_attention(*_jax(a), scale=s,
                                                 **BLOCKS))(jnp.float32(0.1))
    got = fa.flash_attention(*_torch(a), scale=torch.tensor(0.1), **BLOCKS)
    _close(got, want, F32_TOL)
    _close(got, jfa.flash_attention_reference(*_jax(a), scale=0.1), F32_TOL)


def test_tensor_scale_gradient():
    # a learnable attention temperature must receive a real gradient
    a = _arrays([(1, 1, 64, 16)] * 3, 101)
    q, k, v = _jax(a)
    g_flash = jax.grad(lambda s: jnp.sum(jfa.flash_attention(
        q, k, v, scale=s, **BLOCKS) ** 2))(jnp.float32(0.2))
    g_ref = jax.grad(lambda s: jnp.sum(jfa.flash_attention_reference(
        q, k, v, scale=s) ** 2))(jnp.float32(0.2))
    s = torch.tensor(0.2, requires_grad=True)
    (fa.flash_attention(*_torch(a), scale=s, **BLOCKS) ** 2).sum().backward()
    assert float(s.grad.abs()) > 0
    np.testing.assert_allclose(float(s.grad), float(g_flash), rtol=1e-4)
    np.testing.assert_allclose(float(s.grad), float(g_ref), rtol=1e-4)


# ---------------------------------------------------------------------------
# the plain versions of the three kernels, the counters and the checks
# ---------------------------------------------------------------------------

def test_plain_kernels_match_mxtpu_kernels():
    """flash_fwd_plain / flash_bwd_dq_plain / flash_bwd_dkv_plain against
    the Pallas kernels themselves (interpreted), on the flattened layout
    with a nonzero dlse and a shard offset."""
    fwd, bwd = jfa._kernels()
    q, k, v, do = _arrays([(2, 64, 32), (2, 64, 32), (2, 64, 32),
                           (2, 64, 32)], 111)
    dlse = _arrays([(2, 64)], 112)[0]
    offs = np.array([32, 16, 64, 1 / np.sqrt(32)], np.float32)
    jq, jk, jv, jdo = _jax([q, k, v, do])
    o_want, lse_want = fwd(jq, jk, jv, jnp.asarray(offs), True, 64, 64)
    dq_want, dk_want, dv_want = bwd(
        jq, jk, jv, o_want, lse_want, jdo, jnp.asarray(dlse)[..., None],
        jnp.asarray(offs), True, 64, 64)
    tq, tk, tv, tdo = _torch([q, k, v, do])
    toffs = torch.from_numpy(offs)
    o, lse = fa.flash_fwd_plain(tq, tk, tv, toffs, True)
    _close(o, o_want, F32_TOL)
    _close(lse, lse_want[..., 0], F32_TOL)
    delta = (tdo * o).sum(-1) - torch.from_numpy(dlse)
    _close(fa.flash_bwd_dq_plain(tq, tk, tv, tdo, lse, delta, toffs, True),
           dq_want, GRAD_TOL)
    dk, dv = fa.flash_bwd_dkv_plain(tq, tk, tv, tdo, lse, delta, toffs, True)
    _close(dk, dk_want, GRAD_TOL)
    _close(dv, dv_want, GRAD_TOL)


def test_cpu_path_counts_no_launch():
    fa.reset_launches()
    q, k, v = _torch(_arrays([(1, 1, 16, 16)] * 3, 0), grad=True)
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    assert fa.LAUNCHES == {"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0, "flash_fwd_sm90": 0,
                           "flash_bwd_dq_sm90": 0, "flash_bwd_dkv_sm90": 0}


def test_meta_tensors_give_output_shapes():
    meta = torch.device("meta")
    q = torch.empty(2, 3, 10, 16, device=meta)
    k = torch.empty(2, 3, 7, 16, device=meta)
    o, lse = fa.flash_attention_with_lse(q, k, k, causal=True)
    assert o.shape == (2, 3, 10, 16) and lse.shape == (2, 3, 10)
    assert lse.dtype == torch.float32


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguity", "device"])
def test_kernel_argument_checks_raise(bad):
    """The checks the CUDA wrapper runs before a launch refuse what the
    kernel does not take."""
    k = torch.zeros(2, 8, 16)
    dev = torch.device("cpu")
    if bad == "shape":
        k, want = torch.zeros(2, 9, 16), ValueError
    elif bad == "dtype":
        k, want = torch.zeros(2, 8, 16, dtype=torch.float64), TypeError
    elif bad == "contiguity":
        k, want = torch.zeros(2, 16, 8).transpose(1, 2), ValueError
    else:
        dev, want = torch.device("meta"), ValueError
    with pytest.raises(want):
        fa._check("flash_fwd", [("k", k)], [(2, 8, 16)], [torch.float32],
                  dev)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.float16, 32, TypeError), (torch.float32, 48, ValueError),
    (torch.float32, 256, ValueError)])
def test_unsupported_kernel_problem_raises(dtype, d, want):
    q = torch.zeros(1, 8, d, dtype=dtype)
    with pytest.raises(want):
        fa._check_problem("flash_fwd", q, q, q)


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        fa.flash_fwd(*[torch.empty(1, 8, 16, device="meta")] * 3,
                     torch.empty(4, device="meta"), True)


# ---------------------------------------------------------------------------
# the bf16 kernels: their route, and the rounding of P and dS
# ---------------------------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  str(ROOT / "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bf16_rounding_within_sm90_allowance(smoke):
    """P and dS rounded to bf16 before their products (what the bf16
    kernels compute) against mxtpu's Pallas kernels at bf16 (interpreted:
    f32 P and dS, as the CPU runs an f32 dot) and against the f32 plain
    versions, at T=256, D=64, causal, with shard offsets that leave rows
    0-31 fully masked and keys 224-255 seen by no query: within the
    allowance chip_smoke.py holds the kernels to."""
    bh, t, d = 2, 256, 64
    q, k, v, do = _arrays([(bh, t, d)] * 4, 121)
    dlse = _arrays([(bh, t)], 122)[0]
    offs = np.array([32, 64, t, 1 / np.sqrt(d)], np.float32)
    fwd, bwd = jfa._kernels()
    jq, jk, jv, jdo = _jax([q, k, v, do], jnp.bfloat16)
    o_j, lse_j = fwd(jq, jk, jv, jnp.asarray(offs), True, 64, 64)
    dq_j, dk_j, dv_j = bwd(jq, jk, jv, o_j, lse_j, jdo,
                           jnp.asarray(dlse)[..., None], jnp.asarray(offs),
                           True, 64, 64)
    tq, tk, tv, tdo = _torch([q, k, v, do], torch.bfloat16)
    toffs = torch.from_numpy(offs)
    o_jax, lse_jax, dq_jax, dk_jax, dv_jax = (
        torch.from_numpy(np.array(_np32(x)))
        for x in (o_j, lse_j[..., 0], dq_j, dk_j, dv_j))
    o_jax, dq_jax, dk_jax, dv_jax = (
        x.to(torch.bfloat16) for x in (o_jax, dq_jax, dk_jax, dv_jax))
    # the backward from the JAX forward's own O and lse, as the kernels
    # get them from theirs
    delta = (tdo.float() * o_jax.float()).sum(-1) - torch.from_numpy(dlse)
    bw = (tq, tk, tv, tdo, lse_jax, delta, toffs, True)
    o_m, lse_m = fa.flash_fwd_bf16p_plain(tq, tk, tv, toffs, True)
    dq_m = fa.flash_bwd_dq_bf16p_plain(*bw)
    dkv_m = fa.flash_bwd_dkv_bf16p_plain(*bw)
    o_p, lse_p = fa.flash_fwd_plain(tq, tk, tv, toffs, True)
    dq_p = fa.flash_bwd_dq_plain(*bw)
    dkv_p = fa.flash_bwd_dkv_plain(*bw)
    allowance = smoke.sm90_allowance(fa, dict(q=tq, k=tk, v=tv, offs=toffs,
                                              do=tdo, lse=lse_jax,
                                              delta=delta))
    for o_ref, lse_ref, dq_ref, dkv_ref in (
            (o_jax, lse_jax, dq_jax, (dk_jax, dv_jax)),
            (o_p, lse_p, dq_p, dkv_p)):
        _close(lse_m, lse_ref, smoke.SM90_LSE_TOL)
        assert smoke.sm90_excess("flash_fwd_sm90", (o_m, lse_m),
                                 (o_ref, lse_ref), allowance) <= 1.0
        assert smoke.sm90_excess("flash_bwd_dq_sm90", (dq_m,), (dq_ref,),
                                 allowance) <= 1.0
        assert smoke.sm90_excess("flash_bwd_dkv_sm90", dkv_m, dkv_ref,
                                 allowance) <= 1.0
    # the rounding is real, and fully-masked rows and unseen keys stay
    # exact
    assert bool((o_m != o_p).any()) and bool((dq_m != dq_p).any())
    assert all(bool((m != p).any()) for m, p in zip(dkv_m, dkv_p))
    assert float(o_m[:, :32].float().abs().max()) == 0.0
    assert bool((lse_m[:, :32] == fa._NEG).all())
    assert float(dq_m[:, :32].float().abs().max()) == 0.0
    for x in dkv_m:
        assert float(x[:, 224:].float().abs().max()) == 0.0
        assert float(x[:, :224].float().abs().max()) > 0.0


@pytest.mark.parametrize("tq,tk,d,q_offset,k_offset", [
    (100, 72, 32, 0, 0),       # ragged: neither length a tile multiple
    (128, 128, 16, 0, 64),     # rows 0-63 fully masked, keys 64+ unseen
    (96, 192, 128, 64, 0),     # a shard; keys 160+ past its last row
], ids=["ragged", "fully_masked_d16", "shard_d128"])
def test_bf16_dkv_rounding_within_sm90_allowance(smoke, tq, tk, d, q_offset,
                                                 k_offset):
    """The bf16 dK/dV rounding model against the gradients of mxtpu's
    flash attention at bf16 (its Pallas kernels, interpreted, behind its
    custom_vjp, which pads ragged lengths) and against the f32 plain
    version, within the allowance; unseen keys get exactly 0."""
    q, do = _arrays([(1, 2, tq, d)] * 2, 131)
    k, v = _arrays([(1, 2, tk, d)] * 2, 132)
    kw = dict(causal=True, q_offset=q_offset, k_offset=k_offset, **BLOCKS)
    jq, jk, jv, jdo = _jax([q, k, v, do], jnp.bfloat16)
    o_j, lse_j = jfa.flash_attention_with_lse(jq, jk, jv, **kw)
    _o, vjp = jax.vjp(lambda *x: jfa.flash_attention(*x, **kw), jq, jk, jv)
    _dq, dk_j, dv_j = vjp(jdo)

    def flat(x, dtype=torch.bfloat16):
        x = torch.from_numpy(np.array(_np32(x)))
        return x.reshape(2, *x.shape[2:]).to(dtype)
    tq_, tk_, tv_, tdo_ = (flat(x) for x in (q, k, v, do))
    o_jax, dk_jax, dv_jax = flat(o_j), flat(dk_j), flat(dv_j)
    lse_jax = flat(lse_j, torch.float32)
    offs = torch.tensor([q_offset, k_offset, tk, 1 / np.sqrt(d)],
                        dtype=torch.float32)
    delta = (tdo_.float() * o_jax.float()).sum(-1)
    bw = (tq_, tk_, tv_, tdo_, lse_jax, delta, offs, True)
    dkv_m = fa.flash_bwd_dkv_bf16p_plain(*bw)
    dkv_p = fa.flash_bwd_dkv_plain(*bw)
    allowance = smoke.sm90_allowance(fa, dict(q=tq_, k=tk_, v=tv_,
                                              offs=offs, do=tdo_,
                                              lse=lse_jax, delta=delta))
    for ref in ((dk_jax, dv_jax), dkv_p):
        assert smoke.sm90_excess("flash_bwd_dkv_sm90", dkv_m, ref,
                                 allowance) <= 1.0
    for x in dkv_m:
        assert x.dtype == torch.bfloat16 and torch.isfinite(x.float()).all()
    # keys that no query sees: k_offset + j > q_offset + tq - 1
    unseen = max(0, q_offset + tq - k_offset)
    for x in (*dkv_m, dk_jax, dv_jax):
        tail = x[:, unseen:].float()
        assert tail.numel() == 0 or float(tail.abs().max()) == 0.0


def test_sm90_allowance_catches_a_dropped_key(smoke):
    """The allowance is tight enough to see a wrong mask: dropping one
    live key from the keys a row sees leaves the allowance, for O and for
    dK/dV."""
    q, k, v = _torch(_arrays([(1, 128, 64)] * 3, 123), torch.bfloat16)
    offs = torch.tensor([0.0, 0.0, 128.0, 0.125])
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, offs, True)
    short = torch.tensor([0.0, 0.0, 127.0, 0.125])   # key 127 dropped
    o_bad, _ = fa.flash_fwd_bf16p_plain(q, k, v, short, True)
    delta = torch.zeros(1, 128)
    a = dict(q=q, k=k, v=v, offs=offs, do=q, lse=lse_p, delta=delta)
    allowance = smoke.sm90_allowance(fa, a)
    assert smoke.sm90_excess("flash_fwd_sm90", (o_bad, lse_p),
                             (o_p, lse_p), allowance) > 1.0
    dkv_p = fa.flash_bwd_dkv_plain(q, k, v, q, lse_p, delta, offs, True)
    dkv_bad = fa.flash_bwd_dkv_bf16p_plain(q, k, v, q, lse_p, delta, short,
                                           True)
    assert smoke.sm90_excess("flash_bwd_dkv_sm90", dkv_bad, dkv_p,
                             allowance) > 1.0
    # and the rounding alone stays within it
    dkv_m = fa.flash_bwd_dkv_bf16p_plain(q, k, v, q, lse_p, delta, offs,
                                         True)
    assert smoke.sm90_excess("flash_bwd_dkv_sm90", dkv_m, dkv_p,
                             allowance) <= 1.0


@pytest.mark.parametrize("dtype,sm90", [(torch.bfloat16, True),
                                        (torch.float32, False)])
def test_kernel_route_follows_dtype(dtype, sm90):
    """bf16 goes to the wgmma/TMA kernels (forward, dQ and dK/dV) at
    every head dim the wrapper takes; f32 stays on the CUDA-core
    kernels."""
    for d in fa._KERNEL_HEAD_DIMS:
        q = torch.zeros(2, 64, d, dtype=dtype)
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert fa._sm90(name, (q, q, q, q)) is sm90


def test_sm90_route_refuses_misaligned_tensors():
    # a tensor map needs a 16-byte aligned base
    q = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 64, 64)
    assert q.is_contiguous() and q.data_ptr() % 16
    ok = torch.zeros(1, 64, 64, dtype=torch.bfloat16)
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        with pytest.raises(ValueError, match=name):
            fa._sm90(name, (q, q, q, q))
        with pytest.raises(ValueError, match=name):
            fa._sm90(name, (ok, ok, ok, q))


@pytest.mark.parametrize("err,words", [
    (10000, "cuTensorMapEncodeTiled"), (10001 + 1, "CUresult 1"),
    (700, "cudaError 700")])
def test_launch_errors_raise(err, words):
    for name in ("flash_fwd_sm90", "flash_bwd_dq_sm90",
                 "flash_bwd_dkv_sm90"):
        with pytest.raises(RuntimeError, match=name + ".*" + words):
            fa._raise_on(name, err)
        fa._raise_on(name, 0)


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("q_offset,k_offset", [(0, 0), (0, 64), (32, 16)],
                         ids=["causal", "fully_masked", "shard"])
def test_key_split_merge_matches_plain(groups, q_offset, k_offset):
    """The merge the f32 forward uses at D = 16 and 32, where S groups of
    lanes score keys j = s (mod S) with their own running max, sum and
    accumulator: m* = max m_s, l = sum l_s e^(m_s - m*), acc likewise.
    Written out in torch, it gives the plain forward, fully-masked rows
    (O = 0, lse = -1e30) included."""
    q, k, v = _torch(_arrays([(2, 96, 16)] * 3, 141))
    offs = torch.tensor([q_offset, k_offset, 96.0, 0.25])
    mask = fa._mask(offs, 96, 96, True, q.device)
    s = torch.where(mask, torch.matmul(q, k.transpose(1, 2)) * 0.25, fa._NEG)
    parts = []
    for g in range(groups):
        sg, mg = s[..., g::groups], mask[:, g::groups]
        m = sg.amax(-1, keepdim=True)
        p = torch.where(mg, torch.exp(sg - m), 0.0)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.matmul(p, v[:, g::groups])))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [torch.exp(m - m_all) for m, _, _ in parts]
    l = sum(wi * li for wi, (_, li, _) in zip(w, parts))
    acc = sum(wi * ai for wi, (_, _, ai) in zip(w, parts))
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = acc / l_safe
    lse = torch.where(l == 0.0, fa._NEG, m_all + torch.log(l_safe))[..., 0]
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, offs, True)
    _close(o, o_p, F32_TOL)
    _close(lse, lse_p, F32_TOL)
    if k_offset == 64:
        assert float(o[:, :64].abs().max()) == 0.0
        assert bool((lse[:, :64] == fa._NEG).all())


@pytest.mark.parametrize("groups", [2, 4])
@pytest.mark.parametrize("q_offset,k_offset", [(0, 0), (0, 64), (32, 16)],
                         ids=["causal", "fully_masked", "shard"])
def test_backward_split_matches_plain(groups, q_offset, k_offset):
    """The split the f32 dQ and dK/dV kernels use at D = 16 and 32: S
    groups of lanes take keys j = s (mod S) of a Q row (queries i = s
    (mod S) of a key row), and their partial dQ (dK, dV) just add up,
    since p = exp(s scale - lse) needs no running max. Written out in
    torch on Tq != Tk, both off the 32-row tile, it gives the plain
    backward and mxtpu's gradients (jax.grad through its Pallas kernels in
    interpret mode), fully-masked rows and unseen keys included."""
    tq, tk, d = 80, 100, 16
    a = _arrays([(1, 2, tq, d), (1, 2, tk, d), (1, 2, tk, d), (1, 2, tq, d)],
                151)
    kw = dict(causal=True, q_offset=q_offset, k_offset=k_offset, **BLOCKS)
    w = jnp.asarray(a[3])
    want = jax.grad(lambda q, k, v: jnp.sum(
        jfa.flash_attention(q, k, v, **kw) * w), argnums=(0, 1, 2))(
            *_jax(a[:3]))
    q, k, v, do = (x[0] for x in _torch(a))          # (BH, T, D)
    offs = torch.tensor([q_offset, k_offset, tk, d ** -0.5])
    o, lse = fa.flash_fwd_plain(q, k, v, offs, True)
    delta = (do * o).sum(-1)
    mask = fa._mask(offs, tq, tk, True, q.device)
    s = torch.matmul(q, k.transpose(1, 2)) * offs[3]
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (torch.matmul(do, v.transpose(1, 2)) - delta[..., None]) \
        * offs[3]
    dq = sum(torch.matmul(ds[..., g::groups], k[:, g::groups])
             for g in range(groups))
    dk = sum(torch.matmul(ds[:, g::groups].transpose(1, 2), q[:, g::groups])
             for g in range(groups))
    dv = sum(torch.matmul(p[:, g::groups].transpose(1, 2), do[:, g::groups])
             for g in range(groups))
    bw = (q, k, v, do, lse, delta, offs, True)
    _close(dq, fa.flash_bwd_dq_plain(*bw), F32_TOL)
    for got, plain in zip((dk, dv), fa.flash_bwd_dkv_plain(*bw)):
        _close(got, plain, F32_TOL)
    for got, ref in zip((dq, dk, dv), want):
        _close(got[None], ref, GRAD_TOL)
    if k_offset == 64:
        # query i sees key j only where i >= 64 + j: rows 0..63 see none,
        # and keys 16.. are seen by no query
        assert float(dq[:, :64].abs().max()) == 0.0
        assert float(dk[:, 16:].abs().max()) == 0.0
        assert float(dv[:, 16:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# problems the kernels lack, fitted to them by the wrapper: other head
# dims up to 128 (zero-padded), float16 (widened to f32), bases off a
# 16-byte boundary (copied); beyond that the wrappers raise
# ---------------------------------------------------------------------------

def _qkv(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dtype) for _ in range(4)]


def _misaligned(x):
    """x's values in a contiguous view whose base is 2 bytes off a 16-byte
    boundary."""
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype)[1:]
    assert flat.data_ptr() % 16
    return flat.view(x.shape).copy_(x)


# one rounding of each output in the working type, against f32 sums in
# another order: 2^-8 of the value in bf16, 2^-11 in float16, with room
# for the gradients' larger values
_FIT_TOL = {torch.float32: GRAD_TOL,
            torch.bfloat16: dict(atol=2.0 ** -6, rtol=2.0 ** -6),
            torch.float16: dict(atol=2.0 ** -9, rtol=2.0 ** -9)}


@pytest.mark.parametrize("d,dtype,misaligned,kernel_d,kernel_dtype", [
    (80, torch.float32, False, 128, torch.float32),
    (96, torch.float32, False, 128, torch.float32),
    (8, torch.float32, False, 16, torch.float32),
    (48, torch.bfloat16, False, 64, torch.bfloat16),
    (64, torch.float16, False, 64, torch.float32),
    (80, torch.float16, False, 128, torch.float32),
    (64, torch.bfloat16, True, 64, torch.bfloat16),
    (16, torch.bfloat16, False, 16, torch.bfloat16),
    (128, torch.float32, False, 128, torch.float32),
], ids=["d80", "d96", "d8", "bf16_d48", "float16", "float16_d80",
        "bf16_misaligned", "bf16_d16", "f32_d128"])
def test_flash_fits_problems_the_kernels_lack(monkeypatch, d, dtype,
                                              misaligned, kernel_d,
                                              kernel_dtype):
    """local_attention(impl="flash") (what "auto" picks on the card for
    T >= 128 without ALiBi) hands the kernel wrappers a problem they take
    and gives mxtpu's Pallas kernels' values and gradients."""
    seen = []

    def spy(fn):
        def call(q, k, v, *rest):
            fa._check_problem(fn.__name__, q, k, v)
            seen.append((fn.__name__, q.shape[-1], q.dtype,
                         max(t.data_ptr() % 16 for t in (q, k, v) + rest[:1])))
            return fn(q, k, v, *rest)
        return call
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        monkeypatch.setattr(fa, name, spy(getattr(fa, name)))
    tra = importlib.import_module("mxtpu_torch.parallel.ring_attention")
    q, k, v, do = _qkv((1, 2, 128, d), dtype)
    if misaligned:
        q, k = _misaligned(q), _misaligned(k)
    args = [t.requires_grad_() for t in (q, k, v)]
    o = tra.local_attention(*args, causal=True, impl="flash")
    grads = torch.autograd.grad(o, args, do)
    assert seen == [(n, kernel_d, kernel_dtype, 0) for n in
                    ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")]
    for got, x in zip((o,) + grads, (q, q, k, v)):
        assert got.dtype == dtype and got.shape == x.shape

    jq, jk, jv, jdo = (jnp.asarray(t.detach().float().numpy())
                       for t in (q, k, v, do))
    want, vjp = jax.vjp(lambda *a: jfa.flash_attention(*a, causal=True),
                        jq, jk, jv)
    for got, w in zip((o,) + grads, (want,) + vjp(jdo)):
        _close(got, w, _FIT_TOL[dtype])


@pytest.mark.parametrize("bad", ["d256", "float64", "mixed", "empty"])
def test_kernel_wrappers_refuse_what_cannot_be_fitted(bad):
    """A head dim above 128, a dtype other than f32/bf16/f16, mixed dtypes
    and an empty problem reach the kernel wrappers unfitted, and they
    raise there (on the card, before a launch)."""
    shape, dtype = (1, 2, 128, 64), torch.float32
    if bad == "d256":
        shape = (1, 2, 128, 256)
    elif bad == "float64":
        dtype = torch.float64
    elif bad == "empty":
        shape = (1, 2, 0, 64)
    q, k, v, _ = _qkv(shape, dtype)
    if bad == "mixed":
        k = k.to(torch.bfloat16)
    fitted = [fa._fit(t) for t in (q, k, v)]
    want = TypeError if bad in ("float64", "mixed") else ValueError
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        with pytest.raises(want, match=name):
            fa._check_problem(name, *fitted)
