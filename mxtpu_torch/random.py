"""Random numbers of the PyTorch port (``mxtpu/random.py``): ``seed`` and
the samplers ``uniform``, ``normal``, ``gamma``, ``exponential``,
``poisson``, ``negative_binomial``, ``generalized_negative_binomial``,
``multinomial``, ``shuffle`` and ``randint``, over the registry's
``random_*`` / ``sample_multinomial`` / ``shuffle`` ops
(:mod:`.ops.random_ops`).

Every draw comes from the generator of :mod:`.ops.registry`
(:func:`~mxtpu_torch.ops.registry.next_generator`: the innermost
``rng_scope``, else this thread's default), a CPU ``torch.Generator``,
and is then moved to the context. So one seed gives the same numbers on
the card and on the CPU, and a card run can start where a CPU run does.
The numbers differ from ``jax.random``'s: the packages share the rule of
each draw, not its bits. A sampler's ``ctx`` is where its array goes
(the current context by default); ``out`` takes the draw in its own
dtype and context.
"""
from __future__ import annotations

from .ops.registry import set_global_seed
from . import ndarray as nd

__all__ = ["seed", "uniform", "normal", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle", "randint"]


def seed(seed_state):
    """Seed the default generator of this thread."""
    set_global_seed(int(seed_state))


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None):
    """Samples of U[low, high)."""
    return nd.random_uniform(low=low, high=high, shape=shape or (1,),
                             dtype=dtype, ctx=ctx, out=out)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None):
    """Samples of N(loc, scale^2)."""
    return nd.random_normal(loc=loc, scale=scale, shape=shape or (1,),
                            dtype=dtype, ctx=ctx, out=out)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None):
    """Samples of Gamma(alpha) scaled by beta."""
    return nd.random_gamma(alpha=alpha, beta=beta, shape=shape or (1,),
                           dtype=dtype, ctx=ctx, out=out)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None):
    """Samples of the exponential distribution of mean ``scale``."""
    return nd.random_exponential(lam=1.0 / scale, shape=shape or (1,),
                                 dtype=dtype, ctx=ctx, out=out)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None):
    """Samples of Poisson(lam)."""
    return nd.random_poisson(lam=lam, shape=shape or (1,), dtype=dtype,
                             ctx=ctx, out=out)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None):
    """Failures before the k-th success at success rate p."""
    return nd.random_negative_binomial(k=k, p=p, shape=shape or (1,),
                                       dtype=dtype, ctx=ctx, out=out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None, out=None):
    """Samples of mean mu and dispersion alpha."""
    return nd.random_generalized_negative_binomial(
        mu=mu, alpha=alpha, shape=shape or (1,), dtype=dtype, ctx=ctx,
        out=out)


def multinomial(data, shape=None, get_prob=False, dtype="int32", out=None):
    """Category draws from the probabilities of ``data``'s last axis."""
    return nd.sample_multinomial(data, shape=shape, get_prob=get_prob,
                                 dtype=dtype, out=out)


def shuffle(data, out=None):
    """``data``'s rows in a random order."""
    return nd.shuffle(data, out=out)


def randint(low, high, shape=None, dtype="int32", ctx=None, out=None):
    """Integers drawn uniformly from [low, high)."""
    return nd.random_randint(low=low, high=high, shape=shape or (1,),
                             dtype=dtype, ctx=ctx, out=out)
