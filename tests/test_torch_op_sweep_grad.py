"""The op sweep's gradients: for every spec whose op the PyTorch port
registers and ``mxtpu`` differentiates, the port's torch gradient
against ``jax.vjp`` of ``mxtpu``'s op on the same inputs.

The inputs are the spec's, drawn from ``RandomState(_seed(name) + 1)``
as ``tests/test_op_sweep.py``'s gradient test draws them, and the
cotangent of each float output is one seeded normal draw. Both packages'
registry functions are called directly, with ``_training=False`` for the
ops that take the flag (the stochastic ones are then deterministic).
The arguments differentiated are the spec's ``grad_args``, else every
float array. The loss heads (SoftmaxOutput, the regression outputs,
SVMOutput, MakeLoss), whose specs skip the finite-difference check, are
held here too: their backward is ``mxtpu``'s custom rule, not the
derivative of their forward. A gradient that torch leaves undefined (no
path, as BlockGrad's) counts as zeros, as JAX gives it.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxtpu.ops import registry as jax_registry
from mxtpu_torch.ops import registry as torch_registry
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
# gradients in float32: the two packages order their sums differently
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, str(ROOT / "tests" / (name + ".py")))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


GATE = _load("test_torch_op_sweep")
SPECS, _seed = GATE.SPECS, GATE._seed


def _grad_cases():
    out = []
    for name in GATE.ported_specs():
        op = jax_registry.get_op(name)
        if op.differentiable and not op.stateful:
            out.append(name)
    return out


def _float_args(spec, args):
    if spec.grad_args is not None:
        return list(spec.grad_args)
    return [i for i, a in enumerate(args)
            if isinstance(a, np.ndarray) and a.dtype.kind == "f"]


@pytest.mark.parametrize("name", _grad_cases())
def test_gradient(name):
    """d(sum of cotangent * output) / d(input): torch against jax.vjp."""
    spec = SPECS[name]
    r = np.random.RandomState(_seed(name) + 1)
    args = spec.args(r)
    idx = _float_args(spec, args)
    if not idx:
        pytest.skip("no float array inputs to differentiate")
    params = dict(spec.params)
    jop, top = jax_registry.get_op(name), torch_registry.get_op(name)
    if jop.needs_train_flag:
        params["_training"] = False

    def jax_fn(*diff):
        full = list(args)
        for i, d in zip(idx, diff):
            full[i] = d
        full = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
                for a in full]
        out = jop.fn(*full, **params)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    outs, vjp = jax.vjp(jax_fn, *[jnp.asarray(args[i]) for i in idx])
    cots = [r.normal(0, 1, o.shape).astype(o.dtype)
            if jnp.issubdtype(o.dtype, jnp.floating) else None
            for o in outs]
    want = vjp(tuple(jnp.asarray(c) if c is not None
                     else np.zeros(o.shape, jax.dtypes.float0)
                     for c, o in zip(cots, outs)))

    t_args = [torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray)
              else a for a in args]
    for i in idx:
        t_args[i].requires_grad_()
    got_out = top.fn(*t_args, **params)
    got_out = list(got_out) if isinstance(got_out, (tuple, list)) \
        else [got_out]
    assert len(got_out) == len(outs), (len(got_out), len(outs))
    flip = GATE.SIGN_FREE.get(name)
    if flip is not None:
        # the port's rows that are mxtpu's negated take the cotangent
        # negated, so the two losses are one function of the input
        sign = np.sign((got_out[flip].detach().numpy()
                        * np.asarray(outs[flip])).sum(-1, keepdims=True))
        cots[flip] = (cots[flip] * sign).astype(cots[flip].dtype)
    loss = sum((o * torch.from_numpy(c)).sum()
               for o, c in zip(got_out, cots)
               if c is not None and o.requires_grad)
    grads = torch.autograd.grad(loss, [t_args[i] for i in idx],
                                allow_unused=True) \
        if isinstance(loss, torch.Tensor) else [None] * len(idx)
    for i, g, w in zip(idx, grads, want):
        g = np.zeros(args[i].shape, np.float32) if g is None \
            else g.numpy()
        np.testing.assert_allclose(
            g.astype(np.float64), np.asarray(w).astype(np.float64),
            err_msg="%s d/d(arg%d)" % (name, i), **GRAD_TOL)

