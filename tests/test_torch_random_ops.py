"""The port's random ops (``ops/random_ops.py``) on the CPU: every
distribution's moments (the op sweep spec's checks at more draws), the
``sample_*`` shapes, the same numbers from one seed through ``nd``,
``sym`` and a hybridized block, and a rematerialized forward replaying
its draws through ``draw_tape``.

The numbers are torch's, not ``jax.random``'s: the packages share each
distribution, not its bits, so nothing here compares values with
``mxtpu``.
"""
import math

import numpy as np
import pytest

import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

N = 40000


def moments(x, mean, std, tol=0.05):
    x = np.asarray(x, np.float64)
    assert abs(x.mean() - mean) < tol * max(1.0, abs(mean) + std), \
        (x.mean(), mean)
    assert abs(x.std() - std) < tol * max(1.0, std), (x.std(), std)


RANDOM = [
    ("random_uniform", {"low": -1.0, "high": 3.0}, 1.0, 4 / math.sqrt(12)),
    ("random_normal", {"loc": 2.0, "scale": 3.0}, 2.0, 3.0),
    ("random_exponential", {"lam": 2.0}, 0.5, 0.5),
    ("random_gamma", {"alpha": 3.0, "beta": 2.0}, 6.0, math.sqrt(12.0)),
    ("random_gamma", {"alpha": 0.5, "beta": 1.0}, 0.5, math.sqrt(0.5)),
    ("random_poisson", {"lam": 4.0}, 4.0, 2.0),
    ("random_negative_binomial", {"k": 3, "p": 0.5}, 3.0, math.sqrt(6.0)),
    ("random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5},
     2.0, 2.0),
    ("random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.0},
     2.0, math.sqrt(2.0)),
    ("random_randint", {"low": 2, "high": 8}, 4.5, math.sqrt(35 / 12.0)),
]


@pytest.mark.parametrize("name, params, mean, std", RANDOM,
                         ids=["%s-%d" % (r[0], i) for i, r in
                              enumerate(RANDOM)])
def test_random_moments(name, params, mean, std):
    mt.random.seed(7)
    with mt.cpu():
        out = getattr(mt.nd, name)(shape=(N,), **params)
    want = np.int32 if name == "random_randint" else np.float32
    assert out.shape == (N,) and out.dtype == want
    moments(out.asnumpy(), mean, std)


SAMPLE = [
    ("sample_uniform", [[0.0, 10.0], [1.0, 20.0]],
     [(0.5, 1 / math.sqrt(12)), (15.0, 10 / math.sqrt(12))]),
    ("sample_normal", [[0.0, 5.0], [1.0, 2.0]], [(0.0, 1.0), (5.0, 2.0)]),
    ("sample_gamma", [[2.0, 9.0], [3.0, 0.5]],
     [(6.0, math.sqrt(18.0)), (4.5, 1.5)]),
    ("sample_exponential", [[2.0, 0.5]], [(0.5, 0.5), (2.0, 2.0)]),
    ("sample_poisson", [[4.0, 9.0]], [(4.0, 2.0), (9.0, 3.0)]),
    ("sample_negative_binomial", [[3.0, 2.0], [0.5, 0.25]],
     [(3.0, math.sqrt(6.0)), (6.0, math.sqrt(24.0))]),
    ("sample_generalized_negative_binomial", [[2.0, 3.0], [0.5, 0.0]],
     [(2.0, 2.0), (3.0, math.sqrt(3.0))]),
]


@pytest.mark.parametrize("name, params, stats", SAMPLE,
                         ids=[s[0] for s in SAMPLE])
def test_sample_moments(name, params, stats):
    """A ``shape`` of draws for each entry of the parameter arrays."""
    mt.random.seed(8)
    with mt.cpu():
        args = [mt.nd.array(np.array(p, np.float32)) for p in params]
        out = getattr(mt.nd, name)(*args, shape=(N,))
    assert out.shape == (2, N)
    for row, (mean, std) in zip(out.asnumpy(), stats):
        moments(row, mean, std)
    with mt.cpu():
        grid = [mt.nd.array(np.full((2, 3), p[0], np.float32))
                for p in params]
        assert getattr(mt.nd, name)(*grid, shape=(4, 5)).shape == \
            (2, 3, 4, 5)
        assert getattr(mt.nd, name)(*grid).shape == (2, 3)


def test_multinomial():
    probs = np.array([[0.7, 0.2, 0.1], [0.05, 0.05, 0.9]], np.float32)
    mt.random.seed(9)
    with mt.cpu():
        data = mt.nd.array(probs)
        draws, logp = mt.nd.sample_multinomial(data, shape=(N,),
                                               get_prob=True)
        one = mt.nd.sample_multinomial(data)
    d = draws.asnumpy()
    assert d.shape == (2, N) and draws.dtype == np.int32
    assert one.shape == (2,)
    for row, p in zip(d, probs):
        np.testing.assert_allclose(np.bincount(row, minlength=3) / N, p,
                                   atol=0.01)
    np.testing.assert_allclose(
        logp.asnumpy(), np.log(probs)[np.arange(2)[:, None], d], rtol=1e-5)


def test_shuffle():
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    mt.random.seed(10)
    with mt.cpu():
        out = mt.nd.shuffle(mt.nd.array(x)).asnumpy()
    assert not np.array_equal(out, x)
    np.testing.assert_array_equal(out[np.argsort(out[:, 0])], x)


def _nd_draws():
    return [mt.nd.random_normal(loc=1.0, scale=2.0, shape=(3, 4)).asnumpy(),
            mt.nd.random_gamma(alpha=2.0, shape=(5,)).asnumpy()]


def test_one_seed_through_nd_sym_and_a_hybridized_block():
    """The same seed gives the same numbers whichever way the op is
    reached: ``nd`` and, on the CPU, a hybridized block draw from the
    framework's generator (``mx.random.seed``); an executor from its own,
    seeded by one draw of numpy's global RNG at bind, as ``mxtpu`` draws
    its key, so ``nd`` in that generator's scope draws what it draws."""
    import torch
    from mxtpu_torch.ops.registry import rng_scope
    with mt.cpu():
        mt.random.seed(11)
        want = _nd_draws()
        s = mt.sym.Group([
            mt.sym.random_normal(loc=1.0, scale=2.0, shape=(3, 4)),
            mt.sym.random_gamma(alpha=2.0, shape=(5,))])
        np.random.seed(11)
        got_sym = [o.asnumpy() for o in s.bind(mt.cpu(), {}).forward()]
        np.random.seed(11)
        with rng_scope(torch.Generator().manual_seed(
                int(np.random.randint(0, 2 ** 31 - 1)))):
            want_sym = _nd_draws()
        for g, w in zip(got_sym, want_sym):
            np.testing.assert_array_equal(g, w)

        class Draws(mt.gluon.HybridBlock):
            def hybrid_forward(self, F, x):
                return [x + F.random_normal(loc=1.0, scale=2.0,
                                            shape=(3, 4)),
                        F.random_gamma(alpha=2.0, shape=(5,))]
        block = Draws()
        block.hybridize()
        mt.random.seed(11)
        got_block = [o.asnumpy() for o in block(mt.nd.zeros((3, 4)))]
    for g, w in zip(got_block, want):
        np.testing.assert_array_equal(g, w)


def test_explicit_generator_is_honoured():
    """A draw in an rng_scope takes that generator's numbers (gamma and
    Poisson too), and leaves the default generator alone."""
    import torch
    from mxtpu_torch.ops.registry import rng_scope

    def draws():
        with mt.cpu():
            return [mt.nd.random_gamma(alpha=0.7, shape=(6,)).asnumpy(),
                    mt.nd.random_poisson(lam=3.0, shape=(6,)).asnumpy(),
                    mt.nd.random_negative_binomial(k=2, p=0.3,
                                                   shape=(6,)).asnumpy()]
    mt.random.seed(12)
    with rng_scope(torch.Generator().manual_seed(5)):
        a = draws()
    after_a = draws()
    mt.random.seed(12)
    with rng_scope(torch.Generator().manual_seed(5)):
        b = draws()
    for x, y in zip(a + after_a, b + draws()):
        np.testing.assert_array_equal(x, y)


def test_remat_replays_the_draws():
    """A hybridized block with remat recomputes its forward in the
    backward with the draws the forward made: the gradient of x * eps is
    the eps the output shows."""
    class Noisy(mt.gluon.HybridBlock):
        def hybrid_forward(self, F, x):
            return x * F.random_normal(loc=0.0, scale=1.0, shape=(4, 5))
    with mt.cpu():
        for remat in (True, False):
            block = Noisy()
            block.hybridize(remat=remat)
            x = mt.nd.ones((4, 5))
            x.attach_grad()
            mt.random.seed(13)
            with mt.autograd.record():
                y = block(x)
            y.backward()
            np.testing.assert_array_equal(x.grad.asnumpy(), y.asnumpy())
