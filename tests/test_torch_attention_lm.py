"""The attention slice: mxtpu_torch.parallel.local_attention, the
_contrib_flash_attention op through nd and sym, and the causal LM of
example/long-context/ring_attention_lm.py at full width (vocab 32, dim
64, 4 heads, sequence 256, batch 8), held against mxtpu on the same
weights and tokens.

The port's LM is the one chip_smoke.py trains on the card (defined there
once); here it runs on the CPU, where flash attention runs its plain
versions, against jax.value_and_grad of the example's loss_fn over a
one-device mesh (ring attention with one step).

mxtpu's side runs under one ``jax.jit`` a case (its Pallas flash kernels
in interpret mode then compile once instead of dispatching each op), and
under pytest-xdist the file shares the cores among the workers
(``torch_threads``).

Tolerances: attention values 2e-5 and gradients 3e-5, as
tests/test_pallas_attention.py; the LM's loss 1e-5 relative and its
gradients 1e-5 absolute (|g| <= 0.1, f32 sums of 2,048 positions in
another order); Adam's weights 3e-5, because an update of size lr
whatever the gradient turns a last-bit difference in a near-zero
gradient into a visible one.
"""
import functools
import importlib
import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401
from mxtpu.parallel import MeshContext

jra = importlib.import_module("mxtpu.parallel.ring_attention")
tra = importlib.import_module("mxtpu_torch.parallel.ring_attention")

ROOT = pathlib.Path(__file__).resolve().parent.parent
F32_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=3e-5, rtol=3e-5)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke", ROOT / "chip_smoke.py")


@pytest.fixture(scope="module")
def example():
    return _load("ring_attention_lm",
                 ROOT / "example" / "long-context" / "ring_attention_lm.py")


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _close(got, want, tol):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


# ---------------------------------------------------------------------------
# local_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("causal", [False, True])
def test_local_attention_matches_mxtpu(impl, causal):
    a = _qkv((1, 2, 128, 32), 41)
    want = jax.jit(functools.partial(jra.local_attention, causal=causal,
                                     impl=impl))(*map(jnp.asarray, a))
    got = tra.local_attention(*map(torch.from_numpy, a), causal=causal,
                              impl=impl)
    _close(got, want, F32_TOL)


def test_local_attention_offsets_and_gradients():
    a = _qkv((1, 2, 128, 16), 43)
    kw = dict(causal=True, q_offset=128, k_offset=64)

    def jloss(impl):
        return jax.jit(jax.grad(lambda q, k, v: jnp.sum(jra.local_attention(
            q, k, v, impl=impl, **kw) ** 2), argnums=(0, 1, 2)))(
                *map(jnp.asarray, a))
    for impl in ("flash", "xla"):
        t = [torch.from_numpy(x).requires_grad_() for x in a]
        (tra.local_attention(*t, impl=impl, **kw) ** 2).sum().backward()
        for x, w in zip(t, jloss(impl)):
            _close(x.grad, w, GRAD_TOL)


def test_local_attention_alibi_forces_the_dense_path():
    a = _qkv((1, 4, 128, 16), 45)
    want = jax.jit(functools.partial(
        jra.local_attention, causal=True, impl="flash", alibi=True))(
            *map(jnp.asarray, a))
    got = tra.local_attention(*map(torch.from_numpy, a), causal=True,
                              impl="flash", alibi=True)
    _close(got, want, F32_TOL)
    np.testing.assert_allclose(tra._alibi_slopes(4).numpy(),
                               np.asarray(jra._alibi_slopes(4)))


def test_auto_picks_the_dense_path_on_the_cpu():
    """'auto' takes flash only for CUDA tensors (the JAX rule with the
    card in place of the TPU); on the CPU it is the dense path."""
    q, k, v = map(torch.from_numpy, _qkv((1, 1, 128, 16), 47))
    auto = tra.local_attention(q, k, v, causal=True)
    assert torch.equal(auto, tra.local_attention(q, k, v, causal=True,
                                                 impl="xla"))


def test_unknown_impl_raises():
    q = torch.zeros(1, 1, 4, 16)
    with pytest.raises(ValueError):
        tra.local_attention(q, q, q, impl="pallas")


# ---------------------------------------------------------------------------
# the op: _contrib_flash_attention through nd and sym
# ---------------------------------------------------------------------------

def test_registered_as_op():
    for name in ("_contrib_flash_attention", "flash_attention"):
        assert mt.ops.get_op(name) is mt.ops.get_op(
            "_contrib_flash_attention")
        assert mx.ops.get_op(name) is not None


def test_nd_flash_attention_matches_mxtpu():
    a = _qkv((1, 2, 64, 32), 51)
    want = mx.nd.flash_attention(*[mx.nd.array(x) for x in a], causal=True)
    got = mt.nd.flash_attention(*[mt.nd.array(x, ctx=mt.cpu()) for x in a],
                                causal=True)
    assert got.context == mt.cpu()
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **F32_TOL)


def test_sym_flash_attention_matches_mxtpu():
    a = _qkv((1, 2, 64, 32), 53)
    outs = []
    for pkg, wrap in ((mx, jnp.asarray), (mt, torch.from_numpy)):
        q, k, v = (pkg.sym.var(n) for n in "qkv")
        att = pkg.sym.flash_attention(q, k, v, causal=True, q_offset=8,
                                      name="att")
        assert att.list_arguments() == ["q", "k", "v"]
        feed = {n: wrap(x) for n, x in zip("qkv", a)}
        (out,), _aux = pkg.symbol.eval_graph(att._outputs, feed)
        outs.append(np.asarray(out))
    np.testing.assert_allclose(outs[1], outs[0], **F32_TOL)


# ---------------------------------------------------------------------------
# the slice: the causal LM at full width
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lm_case(example):
    """The example's weights (its init_params from PRNGKey(0)) as numpy,
    one batch of its copy task as numpy tokens, and JAX's loss and
    gradients over a one-device mesh (one jitted program)."""
    params = {k: np.array(v) for k, v in
              example.init_params(jax.random.PRNGKey(0)).items()}
    rng = np.random.RandomState(7)
    head = rng.randint(0, example.VOCAB, (8, example.PERIOD))
    tokens = np.tile(head, (1, 17))[:, :example.SEQ + 1].astype(np.int32)
    mesh = MeshContext(jax.devices()[:1], seq=1)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: example.loss_fn(p, t, mesh)))(
            {k: jnp.asarray(v) for k, v in params.items()},
            jnp.asarray(tokens))
    return params, tokens, mesh, float(loss), \
        {k: np.array(g) for k, g in grads.items()}


def test_lm_widths_match_the_example(smoke, example):
    assert (smoke.LM_VOCAB, smoke.LM_DIM, smoke.LM_HEADS, smoke.LM_SEQ,
            smoke.LM_PERIOD) == (example.VOCAB, example.DIM, example.HEADS,
                                 example.SEQ, example.PERIOD)
    assert {k: v.shape for k, v in smoke.lm_init_params(0).items()} == \
        {k: tuple(v.shape) for k, v in
         example.init_params(jax.random.PRNGKey(0)).items()}
    tokens = smoke.lm_batch(np.random.RandomState(0), 8)
    assert tokens.shape == (8, example.SEQ + 1)
    assert (tokens[:, example.PERIOD:] == tokens[:, :-example.PERIOD]).all()


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_lm_loss_and_gradients_match_mxtpu(smoke, lm_case, impl):
    params, tokens, _mesh, want_loss, want_grads = lm_case
    leaves = {k: torch.from_numpy(v).requires_grad_()
              for k, v in params.items()}
    loss = smoke.lm_loss(leaves, torch.from_numpy(tokens).long(), impl=impl)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    for k, g in want_grads.items():
        np.testing.assert_allclose(leaves[k].grad.numpy(), g, atol=1e-5,
                                   rtol=1e-4, err_msg=k)


def test_lm_adam_steps_match_mxtpu(smoke, example, lm_case):
    """Three steps of the example's Adam (its ``step``, written out here:
    the example defines it inside main) against the port's lm_train."""
    params, tokens, mesh, _loss, _grads = lm_case
    rng = np.random.RandomState(9)
    batches = [smoke.lm_batch(rng, 8) for _ in range(3)]

    @jax.jit
    def step(params, m, v, tokens, t, lr):
        loss, grads = jax.value_and_grad(example.loss_fn)(params, tokens,
                                                          mesh)
        b1, b2, eps = 0.9, 0.999, 1e-8
        m = jax.tree.map(lambda a, g: b1 * a + (1 - b1) * g, m, grads)
        v = jax.tree.map(lambda a, g: b2 * a + (1 - b2) * g * g, v, grads)
        mh = jax.tree.map(lambda a: a / (1 - b1 ** t), m)
        vh = jax.tree.map(lambda a: a / (1 - b2 ** t), v)
        params = jax.tree.map(
            lambda p, a, b: p - lr * a / (jnp.sqrt(b) + eps),
            params, mh, vh)
        return params, m, v, loss

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jm = jax.tree.map(jnp.zeros_like, jp)
    jv = jax.tree.map(jnp.zeros_like, jp)
    want_losses = []
    for i, b in enumerate(batches):
        jp, jm, jv, loss = step(jp, jm, jv, jnp.asarray(b.astype(np.int32)),
                                jnp.float32(i + 1), smoke.LM_LR)
        want_losses.append(float(loss))
    got, losses = smoke.lm_train(params, [torch.from_numpy(b) for b in
                                          batches], torch.device("cpu"),
                                 impl="flash")
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jp[k]),
                                   atol=3e-5, rtol=1e-5, err_msg=k)


def test_lm_learns_the_copy_task_with_the_smoke_recipe(smoke):
    """What chip_smoke.py demands on the card, on the CPU's plain path:
    from --seed 0, the example's 300 Adam steps reach nll < 0.5 ln 32."""
    rng = np.random.RandomState(3)
    batches = [torch.from_numpy(smoke.lm_batch(rng, smoke.LM_BATCH))
               for _ in range(smoke.LM_STEPS)]
    _p, losses = smoke.lm_train(smoke.lm_init_params(0), batches,
                                torch.device("cpu"), impl="flash")
    assert torch.isfinite(losses).all()
    assert float(losses[-1]) < 0.5 * np.log(smoke.LM_VOCAB)
