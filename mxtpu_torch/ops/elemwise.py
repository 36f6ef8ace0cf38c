"""Elementwise ops of the PyTorch port: the broadcast arithmetic and
comparison families, their tensor-scalar forms, and the unary math that
NDArray arithmetic and custom ops call; ``clip`` and ``smooth_l1``.

Counterpart of part of ``mxtpu/ops/elemwise.py``, under the same registry
names and aliases. None of them is a Pallas kernel in ``mxtpu``; here
they are plain PyTorch. Dtypes follow ``mxtpu``: a Python number beside
an array takes the array's dtype where it fits (``int32 * 2`` stays
int32, ``int32 * 1.5`` is float32, as JAX's weak types and torch's
scalar promotion agree), comparisons return 0/1 in the input's dtype,
and the ``_*_scalar`` ops take their scalar as a float, as ``mxtpu``'s do.
"""
from __future__ import annotations

import torch

from .nn import relu
from .registry import register


def _number_first(fn):
    """``fn(a, b)`` for a Python number ``a``: made a 0-d tensor of the
    promoted dtype on ``b``'s device (a fill on the device, no copy from
    the host)."""
    def g(a, b):
        if not isinstance(a, torch.Tensor):
            a = torch.full((), a, dtype=torch.result_type(b, a),
                           device=b.device)
        return fn(a, b)
    return g


def _commutes(fn):
    """torch.add/mul take the tensor first; a number may come first."""
    return lambda a, b: fn(b, a) if not isinstance(a, torch.Tensor) \
        else fn(a, b)


_BINARY = {
    "broadcast_add": (_commutes(torch.add),
                      ("elemwise_add", "_plus", "_add", "add_n_pair",
                       "broadcast_plus")),
    "broadcast_sub": (lambda a, b: torch.rsub(b, a)
                      if not isinstance(a, torch.Tensor) else torch.sub(a, b),
                      ("elemwise_sub", "_minus", "_sub", "broadcast_minus")),
    "broadcast_mul": (_commutes(torch.mul), ("elemwise_mul", "_mul")),
    "broadcast_div": (_number_first(torch.div), ("elemwise_div", "_div")),
    "broadcast_mod": (_number_first(torch.remainder), ("_mod",)),
    "broadcast_power": (torch.pow, ("_power", "pow")),
    "broadcast_maximum": (_number_first(torch.maximum),
                          ("_maximum", "maximum")),
    "broadcast_minimum": (_number_first(torch.minimum),
                          ("_minimum", "minimum")),
}

for _n, (_f, _aliases) in _BINARY.items():
    register(_n, aliases=_aliases)(_f)


def _as_input_dtype(out, like):
    """0/1 comparison results in ``like``'s dtype (float32 for a bool
    input), as ``mxtpu``'s comparisons return them."""
    d = like.dtype if isinstance(like, torch.Tensor) else torch.float32
    return out.to(torch.float32 if d == torch.bool else d)


for _n, _f in [
    ("equal", torch.eq), ("not_equal", torch.ne),
    ("greater", torch.gt), ("greater_equal", torch.ge),
    ("lesser", torch.lt), ("lesser_equal", torch.le),
    ("logical_and", torch.logical_and), ("logical_or", torch.logical_or),
    ("logical_xor", torch.logical_xor),
]:
    def _mk(f):
        def g(a, b):
            return _as_input_dtype(_number_first(f)(a, b), a)
        return g
    register("broadcast_" + _n, differentiable=False,
             aliases=("_" + _n, _n))(_mk(_f))


def _full_like_scalar(x, s):
    return torch.full((), s, dtype=torch.result_type(x, s), device=x.device)


_SCALAR_OPS = {
    "_plus_scalar": ("_PlusScalar", torch.add),
    "_minus_scalar": ("_MinusScalar", torch.sub),
    "_rminus_scalar": ("_RMinusScalar", torch.rsub),
    "_mul_scalar": ("_MulScalar", torch.mul),
    "_div_scalar": ("_DivScalar", torch.div),
    "_rdiv_scalar": ("_RDivScalar",
                     lambda x, s: torch.div(_full_like_scalar(x, s), x)),
    "_mod_scalar": ("_ModScalar", torch.remainder),
    # the scalar as a 0-d tensor: torch differentiates remainder(tensor,
    # tensor) by x as -floor(s / x), jnp.mod's gradient, and a Python
    # number first has no derivative
    "_rmod_scalar": ("_RModScalar",
                     lambda x, s: torch.remainder(_full_like_scalar(x, s), x)),
    "_power_scalar": ("_PowerScalar", torch.pow),
    "_rpower_scalar": ("_RPowerScalar", lambda x, s: torch.pow(s, x)),
    "_maximum_scalar": ("_MaximumScalar", lambda x, s: torch.maximum(
        x, _full_like_scalar(x, s))),
    "_minimum_scalar": ("_MinimumScalar", lambda x, s: torch.minimum(
        x, _full_like_scalar(x, s))),
}

for _n, (_camel, _f) in _SCALAR_OPS.items():
    def _mk_scalar(f):
        def g(data, scalar=1.0):
            return f(data, float(scalar))
        return g
    register(_n, aliases=(_camel,))(_mk_scalar(_f))

for _n, (_camel, _f) in {
    "_equal_scalar": ("_EqualScalar", torch.eq),
    "_not_equal_scalar": ("_NotEqualScalar", torch.ne),
    "_greater_scalar": ("_GreaterScalar", torch.gt),
    "_greater_equal_scalar": ("_GreaterEqualScalar", torch.ge),
    "_lesser_scalar": ("_LesserScalar", torch.lt),
    "_lesser_equal_scalar": ("_LesserEqualScalar", torch.le),
}.items():
    def _mk_scalar_logic(f):
        def g(data, scalar=1.0):
            return _as_input_dtype(f(data, float(scalar)), data)
        return g
    register(_n, differentiable=False, aliases=(_camel,))(
        _mk_scalar_logic(_f))


_UNARY = {
    "negative": torch.neg,
    "abs": torch.abs,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "square": torch.square,
    "relu": relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
}

for _n, _f in _UNARY.items():
    register(_n, aliases={"negative": ("_neg",),
                          "abs": ("_abs",)}.get(_n, ()))(_f)


@register("where")
def where(condition, x, y):
    """``x`` where ``condition`` is non-zero, else ``y``."""
    return torch.where(condition.to(torch.bool), x, y)


@register("clip")
def clip(data, a_min=None, a_max=None):
    """``data`` clipped to [a_min, a_max], as ``jnp.clip`` composes it
    (a maximum, then a minimum): at a bound the gradient halves, as
    ``jnp.maximum``'s and torch's ``maximum`` split a tie."""
    if a_min is not None:
        data = torch.maximum(data, _full_like_scalar(data, a_min))
    if a_max is not None:
        data = torch.minimum(data, _full_like_scalar(data, a_max))
    return data


@register("smooth_l1")
def smooth_l1(data, scalar=1.0):
    """0.5 s^2 x^2 where |x| < 1/s^2, else |x| - 0.5/s^2."""
    s2 = scalar * scalar
    absd = torch.abs(data)
    return torch.where(absd < 1.0 / s2, 0.5 * s2 * data * data,
                       absd - 0.5 / s2)
