"""Elementwise ops of the PyTorch port: the broadcast arithmetic and
comparison families (with ``arctan2`` and ``hypot``), their tensor-scalar
forms, the unary math family of ``mxtpu``'s ``_UNARY``, ``add_n``,
``clip`` and ``smooth_l1``.

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
    "broadcast_hypot": (_number_first(torch.hypot), ("_hypot",)),
    "arctan2": (_number_first(torch.atan2), ()),
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
    "_hypot_scalar": ("_HypotScalar", lambda x, s: torch.hypot(
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
    "_logical_and_scalar": ("_LogicalAndScalar", torch.logical_and),
    "_logical_or_scalar": ("_LogicalOrScalar", torch.logical_or),
    "_logical_xor_scalar": ("_LogicalXorScalar", torch.logical_xor),
}.items():
    def _mk_scalar_logic(f):
        def g(data, scalar=1.0):
            return _as_input_dtype(f(data, _full_like_scalar(
                data, float(scalar))), data)
        return g
    register(_n, differentiable=False, aliases=(_camel,))(
        _mk_scalar_logic(_f))


def _round_half_away(x):
    """MXNet's ``round`` (C's ``roundf``): half away from zero, where
    ``mxtpu``'s ``jnp.round`` rounds half to even. ``x - trunc(x)`` is
    exact, so no sum rounds a value below one half up."""
    if not x.is_floating_point():
        return x.clone()
    t = torch.trunc(x)
    return torch.where(torch.abs(x - t) >= 0.5, t + torch.sign(x), t)


def _gamma(x):
    """MXNet's ``gamma`` (C's ``tgamma``): the signed Gamma function.
    ``mxtpu``'s ``exp(gammaln(x))`` is |Gamma(x)|, which differs where
    Gamma is negative: x < 0 with an odd floor."""
    mag = torch.exp(torch.lgamma(x))
    odd = torch.remainder(torch.floor(x), 2.0) == 1.0
    return torch.where((x < 0) & odd, -mag, mag)


def _cbrt(x):
    """The real cube root (torch has no ``cbrt``): its gradient is
    ``jnp.cbrt``'s, 1 / (3 cbrt(x)^2)."""
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


_UNARY = {
    "negative": torch.neg,
    "abs": torch.abs,
    "sign": torch.sign,
    "round": _round_half_away,
    "rint": torch.round,                # half to even, as jnp.rint
    "ceil": torch.ceil,
    "floor": torch.floor,
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "reciprocal": lambda x: 1.0 / x,
    "erf": torch.erf,
    "gamma": _gamma,
    "gammaln": torch.lgamma,
    "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "relu": relu,
    "softrelu": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "logical_not": lambda x: _as_input_dtype(x == 0, x),
}

# piecewise-constant ops: no gradient, as in mxtpu
_STEP = ("sign", "round", "rint", "ceil", "floor", "trunc", "fix",
         "logical_not")



def _one_input(fn):
    """``fn`` as a function of one named input, ``data``: the symbol
    frontend reads an op's inputs from its signature, which torch's
    builtins do not have."""
    def op(data):
        return fn(data)
    op.__name__ = getattr(fn, "__name__", "unary")
    return op


for _n, _f in _UNARY.items():
    register(_n, differentiable=_n not in _STEP,
             aliases={"negative": ("_neg",),
                      "abs": ("_abs",)}.get(_n, ()))(_one_input(_f))


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


@register("add_n", aliases=("ElementWiseSum", "_element_wise_sum"))
def add_n(*args):
    """The sum of N arrays, added left to right."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out
