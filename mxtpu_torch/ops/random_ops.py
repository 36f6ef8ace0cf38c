"""Random sampling ops of the PyTorch port.

Counterpart of ``mxtpu/ops/random_ops.py``: ``random_*`` (one
distribution, a ``shape``), ``sample_*`` (a ``shape`` of draws for each
entry of the parameter arrays, appended to their shape), multinomial and
``shuffle``. Every draw goes through :func:`.registry.draw` on
:func:`.registry.next_generator`, never a torch draw of its own: eagerly
that generator is this thread's CPU generator (or the innermost
``rng_scope``'s), so one seed gives the same numbers on the card and on
the CPU and the draw is then copied to the device; inside a hybridized
block's captured program it is the block's CUDA generator, registered
with the graph, so each replay draws anew; a rematerialized forward gets
its recorded draws back from ``draw_tape``. The numbers differ from
``jax.random``'s: the packages share each distribution, not its bits.

Gamma draws are ``torch._standard_gamma`` (Marsaglia-Tsang), Poisson
draws ``torch.poisson``; the negative binomials are their Gamma-Poisson
mixtures, as in ``mxtpu`` and MXNet's samplers.
"""
from __future__ import annotations

import math

import torch

from ..base import canonical_dtype
from .registry import draw, register

__all__ = []


def _shape(shape):
    if shape is None:
        return ()
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _meta(device):
    """True where shape inference runs the op on ``meta`` tensors: it
    then gives an empty tensor of the draw's shape and draws nothing."""
    return device is not None and torch.device(device).type == "meta"


def _uniform(shape, low, high):
    return lambda gen: torch.empty(shape, device=gen.device).uniform_(
        low, high, generator=gen)


def _normal(shape):
    return lambda gen: torch.randn(shape, generator=gen, device=gen.device)


def _exponential(shape):
    return lambda gen: torch.empty(shape, device=gen.device).exponential_(
        1.0, generator=gen)


def _on(value, gen):
    """``value`` (a tensor, or a ``(shape, number)`` pair to fill) as a
    float32 tensor on the generator's device."""
    if isinstance(value, torch.Tensor):
        return value.to(device=gen.device, dtype=torch.float32)
    shape, number = value
    return torch.full(shape, float(number), device=gen.device)


def _gamma(alpha):
    """Gamma(alpha, 1) draws (``alpha`` as :func:`_on` takes it)."""
    return lambda gen: torch._standard_gamma(_on(alpha, gen), generator=gen)


def _poisson(rate):
    return lambda gen: torch.poisson(_on(rate, gen), generator=gen)


def _gamma_poisson(shape_, scale, device):
    """Poisson(Gamma(shape_, 1) * scale): the negative binomials'
    mixture, two draws."""
    g = draw(_gamma(shape_)).to(device) * scale
    return draw(_poisson(g)).to(device)


@register("random_uniform", stateful=True, differentiable=False,
          needs_device=True, aliases=("_random_uniform", "uniform"))
def random_uniform(low=0.0, high=1.0, shape=None, dtype="float32",
                   _device=None):
    """Samples of U[low, high)."""
    if _meta(_device):
        return torch.empty(_shape(shape), dtype=canonical_dtype(dtype),
                           device=_device)
    t = draw(_uniform(_shape(shape), low, high))
    return t.to(device=_device, dtype=canonical_dtype(dtype))


@register("random_normal", stateful=True, differentiable=False,
          needs_device=True, aliases=("_random_normal", "normal"))
def random_normal(loc=0.0, scale=1.0, shape=None, dtype="float32",
                  _device=None):
    """Samples of N(loc, scale^2)."""
    if _meta(_device):
        return torch.empty(_shape(shape), dtype=canonical_dtype(dtype),
                           device=_device)
    t = draw(_normal(_shape(shape))).to(_device) * scale + loc
    return t.to(canonical_dtype(dtype))


@register("random_gamma", stateful=True, differentiable=False,
          needs_device=True, aliases=("_random_gamma",))
def random_gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32",
                 _device=None):
    """Samples of Gamma(alpha) scaled by beta (mean alpha * beta)."""
    if _meta(_device):
        return torch.empty(_shape(shape), dtype=canonical_dtype(dtype),
                           device=_device)
    g = draw(_gamma((_shape(shape), alpha)))
    return (g.to(_device) * beta).to(canonical_dtype(dtype))


@register("random_exponential", stateful=True, differentiable=False,
          needs_device=True, aliases=("_random_exponential",))
def random_exponential(lam=1.0, shape=None, dtype="float32", _device=None):
    """Samples of the exponential distribution of rate lam."""
    if _meta(_device):
        return torch.empty(_shape(shape), dtype=canonical_dtype(dtype),
                           device=_device)
    e = draw(_exponential(_shape(shape))).to(_device) / lam
    return e.to(canonical_dtype(dtype))


@register("random_poisson", stateful=True, differentiable=False,
          needs_device=True, aliases=("_random_poisson",))
def random_poisson(lam=1.0, shape=None, dtype="float32", _device=None):
    """Samples of Poisson(lam)."""
    if _meta(_device):
        return torch.empty(_shape(shape), dtype=canonical_dtype(dtype),
                           device=_device)
    p = draw(_poisson((_shape(shape), lam)))
    return p.to(device=_device, dtype=canonical_dtype(dtype))


@register("random_negative_binomial", stateful=True, differentiable=False,
          needs_device=True, aliases=("_random_negative_binomial",))
def random_negative_binomial(k=1, p=1.0, shape=None, dtype="float32",
                             _device=None):
    """Failures before the k-th success at success rate p:
    Poisson(Gamma(k) * (1 - p) / p)."""
    if _meta(_device):
        return torch.empty(_shape(shape), dtype=canonical_dtype(dtype),
                           device=_device)
    out = _gamma_poisson((_shape(shape), k), (1 - p) / p, _device)
    return out.to(canonical_dtype(dtype))


@register("random_generalized_negative_binomial", stateful=True,
          differentiable=False, needs_device=True,
          aliases=("_random_generalized_negative_binomial",))
def random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                         dtype="float32", _device=None):
    """Mean mu, dispersion alpha: Poisson(Gamma(1/alpha) * alpha * mu);
    alpha = 0 is Poisson(mu)."""
    if _meta(_device):
        return torch.empty(_shape(shape), dtype=canonical_dtype(dtype),
                           device=_device)
    s = _shape(shape)
    if alpha == 0.0:
        out = draw(_poisson((s, mu))).to(_device)
    else:
        out = _gamma_poisson((s, 1.0 / alpha), alpha * mu, _device)
    return out.to(canonical_dtype(dtype))


@register("random_randint", stateful=True, differentiable=False,
          needs_device=True, aliases=("_random_randint", "randint"))
def random_randint(low=0, high=1, shape=None, dtype="int32", _device=None):
    """Integers drawn uniformly from [low, high)."""
    if _meta(_device):
        return torch.empty(_shape(shape), dtype=canonical_dtype(dtype),
                           device=_device)
    t = draw(lambda gen: torch.randint(int(low), int(high), _shape(shape),
                                       generator=gen, device=gen.device))
    return t.to(device=_device, dtype=canonical_dtype(dtype))


# ---------------------------------------------------------------------------
# sample_*: a shape of draws for each entry of the parameter arrays
# ---------------------------------------------------------------------------

def _per_entry(param, s):
    """``param`` with ``len(s)`` axes of 1 appended (broadcasts against
    the draws of shape ``param.shape + s``)."""
    return param.reshape(tuple(param.shape) + (1,) * len(s))


def _spread(param, s):
    """``param`` broadcast to ``param.shape + s``, as float32."""
    return _per_entry(param, s).expand(tuple(param.shape) + s).to(
        torch.float32)


def _cast(out, dtype):
    return out if dtype is None else out.to(canonical_dtype(dtype))


def _meta_draws(param, s, dtype):
    """The draws' empty tensor on ``meta`` (shape inference), in
    ``dtype`` (None: the parameter's)."""
    return torch.empty(tuple(param.shape) + s, device=param.device,
                       dtype=param.dtype if dtype is None
                       else canonical_dtype(dtype))


@register("sample_uniform", stateful=True, differentiable=False)
def sample_uniform(low, high, shape=None, dtype=None):
    """U[low[i], high[i]) draws of ``shape`` for each entry i."""
    s = _shape(shape)
    if _meta(low.device):
        return _meta_draws(low, s, dtype)
    u = draw(_uniform(tuple(low.shape) + s, 0.0, 1.0)).to(low)
    lo, hi = _per_entry(low, s), _per_entry(high, s)
    return _cast(lo + u * (hi - lo), dtype)


@register("sample_normal", stateful=True, differentiable=False)
def sample_normal(mu, sigma, shape=None, dtype=None):
    """N(mu[i], sigma[i]^2) draws of ``shape`` for each entry i."""
    s = _shape(shape)
    if _meta(mu.device):
        return _meta_draws(mu, s, dtype)
    n = draw(_normal(tuple(mu.shape) + s)).to(mu)
    return _cast(_per_entry(mu, s) + _per_entry(sigma, s) * n, dtype)


@register("sample_gamma", stateful=True, differentiable=False)
def sample_gamma(alpha, beta, shape=None, dtype=None):
    """Gamma(alpha[i]) * beta[i] draws of ``shape`` for each entry i."""
    s = _shape(shape)
    if _meta(alpha.device):
        return _meta_draws(alpha, s, dtype)
    g = draw(_gamma(_spread(alpha, s))).to(alpha.device)
    return _cast(g * _per_entry(beta, s), dtype)


@register("sample_exponential", stateful=True, differentiable=False,
          aliases=("_sample_exponential",))
def sample_exponential(lam, shape=None, dtype=None):
    """Exponential draws of rate lam[i], ``shape`` for each entry i."""
    s = _shape(shape)
    if _meta(lam.device):
        return _meta_draws(lam, s, dtype)
    e = draw(_exponential(tuple(lam.shape) + s)).to(lam)
    return _cast(e / _per_entry(lam, s), dtype)


@register("sample_poisson", stateful=True, differentiable=False,
          aliases=("_sample_poisson",))
def sample_poisson(lam, shape=None, dtype="float32"):
    """Poisson(lam[i]) draws of ``shape`` for each entry i."""
    s = _shape(shape)
    if _meta(lam.device):
        return _meta_draws(lam, s, dtype)
    p = draw(_poisson(_spread(lam, s)))
    return p.to(device=lam.device, dtype=canonical_dtype(dtype))


@register("sample_negative_binomial", stateful=True, differentiable=False,
          aliases=("_sample_negative_binomial",))
def sample_negative_binomial(k, p, shape=None, dtype="float32"):
    """Negative binomial draws of (k[i], p[i]), ``shape`` for each i."""
    s = _shape(shape)
    if _meta(k.device):
        return _meta_draws(k, s, dtype)
    pp = _spread(p, s)
    out = _gamma_poisson(_spread(k, s), (1 - pp) / pp, k.device)
    return out.to(canonical_dtype(dtype))


@register("sample_generalized_negative_binomial", stateful=True,
          differentiable=False,
          aliases=("_sample_generalized_negative_binomial",))
def sample_generalized_negative_binomial(mu, alpha, shape=None,
                                         dtype="float32"):
    """Generalized negative binomial draws of (mu[i], alpha[i]); an
    alpha of 0 gives Poisson(mu) (the Gamma's shape floored at 1e-8
    there, as in ``mxtpu``)."""
    s = _shape(shape)
    if _meta(mu.device):
        return _meta_draws(mu, s, dtype)
    m, a = _spread(mu, s), _spread(alpha, s)
    safe = torch.clamp(a, min=1e-8)
    g = draw(_gamma(1.0 / safe)).to(mu.device) * safe * m
    lam = torch.where(a > 0, g, m)
    out = draw(_poisson(lam)).to(mu.device)
    return out.to(canonical_dtype(dtype))


@register("sample_multinomial", stateful=True, differentiable=False,
          aliases=("_sample_multinomial", "multinomial"))
def sample_multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """Category draws from the probabilities of ``data``'s last axis:
    ``shape`` of them for each row (one, of no axis, without a shape);
    with ``get_prob`` also each draw's log-probability."""
    s = _shape(shape)
    lead = tuple(data.shape[:-1])
    if _meta(data.device):
        out = torch.empty(lead + s, dtype=canonical_dtype(dtype),
                          device=data.device)
        return (out, torch.empty(out.shape, dtype=data.dtype,
                                 device=data.device)) if get_prob else out
    n = max(math.prod(s), 1)
    k = data.shape[-1]
    rows = data.reshape(-1, k).to(torch.float32)
    idx = draw(lambda gen: torch.multinomial(
        rows.to(gen.device), n, replacement=True, generator=gen))
    idx = idx.to(data.device)
    out = idx.reshape(lead + s).to(canonical_dtype(dtype))
    if not get_prob:
        return out
    logp = torch.log_softmax(torch.log(torch.clamp(rows, min=1e-37)), -1)
    lp = torch.gather(logp, 1, idx).reshape(lead + s)
    return out, lp.to(data.dtype)


@register("shuffle", stateful=True, differentiable=False,
          aliases=("_shuffle",))
def shuffle(data):
    """``data``'s rows (first axis) in a random order."""
    if _meta(data.device):
        return torch.empty_like(data)
    perm = draw(lambda gen: torch.randperm(data.shape[0], generator=gen,
                                           device=gen.device))
    return data[perm.to(data.device)]
