"""``cached_attention`` and ``moe_ffn`` of the PyTorch port held to
``mxtpu``'s registry functions on the CPU: the forward outputs and the
gradients (``jax.vjp`` against torch's autograd) on seeded numpy inputs.

The cases: the training window (pos 0, T = S), a prefill chunk T < S at a
different pos for each sample, a decode step T = 1 near the end of the
cache and past S - T (the write clamps into [0, S - T] as
``lax.dynamic_update_slice`` clamps, while the mask keeps the unclamped
position), ALiBi on and off, H in {1, 2, 4}; the attribute spelled as a
saved symbol spells it; the in-place form the generation programs use
(``static_cache``) against the functional one. ``moe_ffn``: top-1 and
top-2, a capacity that holds every token and one that drops tokens.

Tolerances: float32 throughout; the two packages sum the same products
in another order, so outputs agree within 1e-5 and gradients within 1e-5
of the largest gradient (scores pass through a softmax over at most 16
rows; the MoE's einsums over 8-wide rows).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxtpu.ops.nn as jnn
import mxtpu_torch as mt
import mxtpu_torch.ops.nn as tnn
from mxtpu_torch.parallel.moe import moe_capacity, moe_dispatch
from torch_threads import torch_threads_shared  # noqa: F401

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = 1e-5

# (B, T, S, H, pos): each case once with ALiBi off and once on
CASES = {
    "train window": (2, 8, 8, 2, [0, 0]),
    "prefill per-sample pos": (3, 4, 12, 4, [0, 3, 8]),
    "decode at S - 1 and past it (clamp)": (3, 1, 6, 1, [5, 6, 11]),
    "chunk past S - T (clamp)": (2, 3, 8, 4, [4, 7]),
}


def _inputs(B, T, S, D, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, D).astype(np.float32) for _ in range(3))
    kc, vc = (rng.randn(B, S, D).astype(np.float32) for _ in range(2))
    return [q, k, v, kc, vc]


def _jax_vjp(fn, arrs, cots):
    """mxtpu's outputs and ``jax.vjp`` gradients of ``fn``, under one
    ``jax.jit`` (one compile, where eager JAX compiles op by op)."""
    def both(xs, cs):
        out, vjp = jax.vjp(fn, *xs)
        return out, vjp(tuple(cs))
    return jax.jit(both)(tuple(map(jnp.asarray, arrs)),
                         tuple(map(jnp.asarray, cots)))


def _compare(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg="%s %d" % (what, i))


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cached_attention_forward_and_grad(case, alibi):
    B, T, S, H, pos = CASES[case]
    D = 4 * H
    arrs = _inputs(B, T, S, D, seed=len(case) + alibi)
    p = np.asarray(pos, np.float32)
    rng = np.random.RandomState(7)
    cots = [rng.randn(B, T, D).astype(np.float32),
            rng.randn(B, S, D).astype(np.float32),
            rng.randn(B, S, D).astype(np.float32)]

    def jf(*xs):
        return jnn.cached_attention(*xs, jnp.asarray(p), num_heads=H,
                                    alibi=alibi)
    want, want_g = _jax_vjp(jf, arrs, cots)

    xs = [torch.tensor(a, requires_grad=True) for a in arrs]
    got = tnn.cached_attention(*xs, torch.tensor(p), num_heads=H,
                               alibi=alibi)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   **FWD_TOL)
    torch.autograd.backward(list(got), [torch.tensor(c) for c in cots])
    _compare([x.grad.numpy() for x in xs], want_g, case)


def test_cached_attention_clamps_the_write():
    """A decode at pos >= S writes row S - 1 (the clamp), and the mask,
    which keeps the unclamped position, lets it attend every row."""
    B, T, S, D = 1, 1, 5, 4
    arrs = _inputs(B, T, S, D, seed=3)
    out, kn, vn = tnn.cached_attention(*map(torch.tensor, arrs),
                                       torch.tensor([7.0]), num_heads=1)
    np.testing.assert_array_equal(kn[0, S - 1].numpy(), arrs[1][0, 0])
    np.testing.assert_array_equal(kn[0, :S - 1].numpy(), arrs[3][0, :S - 1])
    np.testing.assert_array_equal(vn[0, S - 1].numpy(), arrs[2][0, 0])
    want = jnn.cached_attention(*map(jnp.asarray, arrs),
                                jnp.asarray([7], jnp.int32), num_heads=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(want[0]), **FWD_TOL)


@pytest.mark.parametrize("spelled", ["True", "False", True, 0])
def test_alibi_attribute_as_saved(spelled):
    """A symbol saved by mxtpu stores the flag as the string "True" (or
    "False"): both packages read it the same way."""
    arrs = _inputs(1, 4, 4, 8, seed=5)
    got = tnn.cached_attention(*map(torch.tensor, arrs), torch.zeros(1),
                               num_heads=2, alibi=spelled)[0]
    want = jnn.cached_attention(*map(jnp.asarray, arrs), jnp.zeros(1),
                                num_heads=2, alibi=spelled)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_static_cache_writes_in_place():
    """Inside static_cache, with no gradient, the op writes the new rows
    into the caches it was given and returns them: the same values as
    the functional form, in the same storage."""
    arrs = _inputs(2, 1, 6, 8, seed=9)
    pos = torch.tensor([2.0, 5.0])
    want = tnn.cached_attention(*map(torch.tensor, arrs), pos, num_heads=2,
                                alibi=True)
    kc, vc = torch.tensor(arrs[3]), torch.tensor(arrs[4])
    ptr = (kc.data_ptr(), vc.data_ptr())
    with torch.no_grad(), tnn.static_cache():
        got = tnn.cached_attention(*map(torch.tensor, arrs[:3]), kc, vc, pos,
                                   num_heads=2, alibi=True)
    assert got[1] is kc and got[2] is vc
    assert (kc.data_ptr(), vc.data_ptr()) == ptr
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # with a gradient recorded the functional form runs, even in the scope
    q = torch.tensor(arrs[0], requires_grad=True)
    with tnn.static_cache():
        out = tnn.cached_attention(q, *map(torch.tensor, arrs[1:]), pos,
                                   num_heads=2)
    assert out[1].data_ptr() != torch.tensor(arrs[3]).data_ptr()


def test_symbol_registration_and_shapes():
    """Both ops are registered under mxtpu's names with its output counts;
    their shape hints fill ``pos`` from the query, one cache from the
    other, and the expert stacks from ``w1``."""
    op = mt.ops.registry.get_op("cached_attention")
    assert op.num_outputs == 3
    assert mt.ops.registry.get_op("moe_ffn").num_outputs == 2
    x = mt.sym.Variable("x")
    pos = mt.sym.Variable("pos", shape=(0,), dtype="int32")
    kc = mt.sym.Variable("kc", shape=(0, 10, 8))
    vc = mt.sym.Variable("vc")
    att = mt.sym.cached_attention(x, x, x, kc, vc, pos, num_heads=2,
                                  name="att")
    args, outs, _x = att.infer_shape(x=(2, 3, 8), kc=(2, 10, 8))
    assert dict(zip(att.list_arguments(), args)) == {
        "x": (2, 3, 8), "kc": (2, 10, 8), "vc": (2, 10, 8), "pos": (2,)}
    assert outs == [(2, 3, 8), (2, 10, 8), (2, 10, 8)]
    w1 = mt.sym.Variable("w1", shape=(4, 8, 6))
    moe = mt.sym.moe_ffn(x, *(mt.sym.Variable(n) for n in ("g",)), w1,
                         *(mt.sym.Variable(n) for n in ("b1", "w2", "b2")),
                         name="moe")
    args, outs, _x = moe.infer_shape(x=(2, 3, 8))
    assert dict(zip(moe.list_arguments(), args)) == {
        "x": (2, 3, 8), "g": (8, 4), "w1": (4, 8, 6), "b1": (4, 6),
        "w2": (4, 6, 8), "b2": (4, 8)}
    assert outs == [(2, 3, 8), (1,)]


MOE_CASES = {
    "top-1, room for all": (1, 2.0),
    "top-1, drops tokens": (1, 0.5),
    "top-2, drops tokens": (2, 0.75),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_forward_and_grad(case):
    top, cf = MOE_CASES[case]
    rng = np.random.RandomState(len(case))
    D, E, F = 8, 4, 6
    arrs = [rng.randn(2, 16, D).astype(np.float32),
            rng.randn(D, E).astype(np.float32),
            (rng.randn(E, D, F) * 0.3).astype(np.float32),
            (rng.randn(E, F) * 0.1).astype(np.float32),
            (rng.randn(E, F, D) * 0.3).astype(np.float32),
            (rng.randn(E, D) * 0.1).astype(np.float32)]
    cots = [rng.randn(2, 16, D).astype(np.float32),
            np.ones(1, np.float32)]

    def jf(*xs):
        return jnn.moe_ffn(*xs, capacity_factor=cf, num_selected=top)
    want, want_g = _jax_vjp(jf, arrs, cots)
    xs = [torch.tensor(a, requires_grad=True) for a in arrs]
    got = tnn.moe_ffn(*xs, capacity_factor=cf, num_selected=top)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   **FWD_TOL)
    torch.autograd.backward(list(got), [torch.tensor(c) for c in cots])
    _compare([x.grad.numpy() for x in xs], want_g, case)


def test_moe_dispatch_routes_as_mxtpu():
    """The dispatch and combine tensors equal mxtpu's: the capacity
    max(1, ceil(t/e*cf) * k), the float cumsum positions, the first
    index among equal probabilities (ties made on purpose), the tokens
    past an expert's capacity dropped."""
    from mxtpu.parallel.moe import moe_dispatch as jdispatch
    rng = np.random.RandomState(4)
    logits = rng.randn(24, 4).astype(np.float32)
    logits[::3] = 0.5                      # four equal probabilities
    for top, cf in ((1, 1.0), (2, 0.5), (1, 0.1)):
        C = moe_capacity(24, 4, cf, top)
        assert C == max(1, int(np.ceil(24 / 4 * cf)) * top)
        got = moe_dispatch(torch.tensor(logits), C, top)
        want = jdispatch(jnp.asarray(logits), C, top)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   **FWD_TOL)
        np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)
        kept = got[0].numpy().sum()
        assert kept <= 4 * C
