"""The port's BatchNorm against mxtpu's, on the CPU, on the same seeded
inputs: the op's 5 outputs (out, mean, invstd, new moving mean, new
moving var) and the gradients of data, gamma and beta against
``jax.vjp`` of ``mxtpu``'s op; then the symbol level (the outputs a
symbol shows, the aux states, shape inference, JSON both ways) and the
executor writing the moving statistics back.

Tolerances. float32: both sides reduce up to 120 values a channel in
another order and normalise in f32, so an output or a statistic agrees
within a few ulp; the gradients sum the same 120 terms with
cancellation, so they agree within 1e-5 of the largest gradient
(F32_TOL). bfloat16: the statistics and arithmetic run in f32 on the same
f32 copy of the input, and the output and the data gradient are rounded
to bf16 once; a last-bit difference in f32 can flip that rounding by one
bf16 ulp, 2^-7 of the value (BF16_TOL).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu.ops.registry import get_op as jax_op
from mxtpu_torch.ops.registry import get_op as torch_op

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-5)
NAMES = ("out", "mean", "invstd", "moving_mean", "moving_var")


def _inputs(axis, seed=0):
    rng = np.random.RandomState(seed)
    shape = (4, 3, 5, 6) if axis == 1 else (4, 5, 6, 3)
    data = (0.5 + 2.0 * rng.randn(*shape)).astype(np.float32)
    c = (3,)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.randn(*c).astype(np.float32)
    mm = rng.randn(*c).astype(np.float32)
    mv = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return data, gamma, beta, mm, mv


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol, name):
    got, want = _to_numpy(got), _to_numpy(want)
    assert got.shape == want.shape, name
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=tol["rtol"],
                               atol=tol["atol"] * scale, err_msg=name)


CASES = [
    # (training, fix_gamma, use_global_stats, output_mean_var, axis, dtype)
    (True, True, False, False, 1, "float32"),
    (True, False, False, False, 1, "float32"),
    (True, False, False, True, 1, "float32"),
    (True, True, False, True, -1, "float32"),
    (True, False, False, False, -1, "float32"),
    (True, False, True, False, 1, "float32"),
    (True, True, True, True, -1, "float32"),
    (False, False, False, False, 1, "float32"),
    (False, True, False, True, 1, "float32"),
    (False, False, False, False, -1, "float32"),
    (True, False, False, False, 1, "bfloat16"),
    (True, True, False, True, -1, "bfloat16"),
    (False, False, False, False, 1, "bfloat16"),
    (True, False, True, False, -1, "bfloat16"),
]


def _case_id(case):
    training, fix_gamma, ugs, omv, axis, dtype = case
    return "%s-%s%s%s-axis%d-%s" % (
        "train" if training else "infer",
        "fixgamma" if fix_gamma else "gamma",
        "-globalstats" if ugs else "", "-meanvar" if omv else "", axis,
        dtype)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_batchnorm_op_matches_mxtpu(case):
    """All 5 outputs, and the gradients of data, gamma and beta from
    cotangents on the outputs a symbol shows (out; also mean and invstd
    under output_mean_var), against jax.vjp of mxtpu's op."""
    training, fix_gamma, ugs, omv, axis, dtype = case
    data, gamma, beta, mm, mv = _inputs(axis)
    params = dict(eps=2e-5 if axis == 1 else 1e-3, momentum=0.9,
                  fix_gamma=fix_gamma, use_global_stats=ugs,
                  output_mean_var=omv, axis=axis, _training=training)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rng = np.random.RandomState(1)
    shown = 3 if omv else 1
    jref = jax_op("BatchNorm")
    want_outs = jref.fn(jnp.asarray(data, jdt), jnp.asarray(gamma),
                        jnp.asarray(beta), jnp.asarray(mm), jnp.asarray(mv),
                        **params)
    cots = [rng.randn(*np.shape(o)).astype(np.float32)
            for o in want_outs[:shown]]

    def head(x, g, b):
        outs = jref.fn(x, g, b, jnp.asarray(mm), jnp.asarray(mv), **params)
        return tuple(outs[:shown])
    _, vjp = jax.vjp(head, jnp.asarray(data, jdt), jnp.asarray(gamma),
                     jnp.asarray(beta))
    want_grads = vjp(tuple(jnp.asarray(c, o.dtype)
                           for c, o in zip(cots, want_outs)))

    leaves = [torch.tensor(data).to(tdt).requires_grad_(),
              torch.tensor(gamma).requires_grad_(),
              torch.tensor(beta).requires_grad_()]
    got_outs = torch_op("BatchNorm").fn(*leaves, torch.tensor(mm),
                                        torch.tensor(mv), **params)
    assert len(got_outs) == 5
    for name, g, w in zip(NAMES, got_outs, want_outs):
        assert g.dtype == (tdt if name == "out" else torch.float32), name
        _close(g, w, tol if name == "out" else F32_TOL, name)
    heads = [(o, torch.tensor(c).to(o.dtype))
             for c, o in zip(cots, got_outs) if o.requires_grad]
    grads = torch.autograd.grad([o for o, _ in heads], leaves,
                                [c for _, c in heads], allow_unused=True)
    for name, g, w in zip(("data", "gamma", "beta"), grads, want_grads):
        g = torch.zeros_like(leaves[1]) if g is None else g
        _close(g, w, tol if name == "data" else F32_TOL, "d" + name)
    if fix_gamma:
        assert grads[1] is None or not grads[1].abs().any()


def _bn_net(pkg, **kw):
    with pkg.name.NameManager():
        x = pkg.sym.var("data")
        bn = pkg.sym.BatchNorm(x, name="bn", **kw)
        if kw.get("output_mean_var"):
            return bn
        return pkg.sym.Activation(bn, act_type="relu", name="relu")


@pytest.mark.parametrize("kw", [{}, {"output_mean_var": True},
                                {"axis": -1, "fix_gamma": False}],
                         ids=["default", "meanvar", "nhwc"])
def test_batchnorm_symbol_matches_mxtpu(kw):
    """What a symbol shows: 1 output (3 under output_mean_var) of a node
    with 5, so Activation(bn) binds to the normalised output; the aux
    states and the inferred shapes equal mxtpu's."""
    shape = (2, 3, 4, 5) if kw.get("axis", 1) == 1 else (2, 4, 5, 3)
    got, want = _bn_net(mt, **kw), _bn_net(mx, **kw)
    assert got.list_outputs() == want.list_outputs()
    assert len(got.list_outputs()) == (3 if kw.get("output_mean_var") else 1)
    assert got.list_arguments() == want.list_arguments()
    assert got.list_auxiliary_states() == want.list_auxiliary_states() == \
        ["bn_moving_mean", "bn_moving_var"]
    assert got.infer_shape(data=shape) == want.infer_shape(data=shape)
    assert len(got.infer_type(data=np.float32)[2]) == 2


@pytest.mark.parametrize("src,dst", [(mx, mt), (mt, mx)],
                         ids=["mxtpu_to_port", "port_to_mxtpu"])
def test_batchnorm_json_loads_both_ways(src, dst):
    """A BatchNorm graph saved by either package loads in the other with
    the same outputs, arguments, aux states and shapes, and evaluates
    the same (inference, moving statistics)."""
    net = _bn_net(src, fix_gamma=False, eps=2e-5)
    loaded = dst.sym.load_json(net.tojson())
    assert loaded.list_outputs() == net.list_outputs()
    assert loaded.list_arguments() == net.list_arguments()
    assert loaded.list_auxiliary_states() == net.list_auxiliary_states()
    assert loaded.infer_shape(data=(2, 3, 4, 5)) == \
        net.infer_shape(data=(2, 3, 4, 5))
    data, gamma, beta, mm, mv = _inputs(1)
    data = data[:2, :, :4, :5]
    outs = []
    for pkg, sym in ((src, net), (dst, loaded)):
        args = {"data": data, "bn_gamma": gamma, "bn_beta": beta}
        aux = {"bn_moving_mean": mm, "bn_moving_var": mv}
        ex = sym.bind(pkg.cpu(), {k: pkg.nd.array(v, ctx=pkg.cpu())
                                  for k, v in args.items()},
                      aux_states={k: pkg.nd.array(v, ctx=pkg.cpu())
                                  for k, v in aux.items()})
        outs.append(ex.forward(is_train=False)[0].asnumpy())
    _close(outs[0], outs[1], F32_TOL, "out")


def test_executor_writes_the_moving_statistics():
    """A training forward writes the blended statistics into the bound
    aux arrays, as mxtpu's executor does; an inference forward leaves
    them; backward gives mxtpu's gradients."""
    data, gamma, beta, mm, mv = _inputs(1)
    got = {}
    for pkg in (mt, mx):
        net = _bn_net(pkg, fix_gamma=False, momentum=0.8)
        ex = net.simple_bind(pkg.cpu(), data=data.shape)
        ex.copy_params_from(
            {"bn_gamma": pkg.nd.array(gamma, ctx=pkg.cpu()),
             "bn_beta": pkg.nd.array(beta, ctx=pkg.cpu())},
            {"bn_moving_mean": pkg.nd.array(mm, ctx=pkg.cpu()),
             "bn_moving_var": pkg.nd.array(mv, ctx=pkg.cpu())})
        ex.forward(is_train=False, data=pkg.nd.array(data, ctx=pkg.cpu()))
        before = [ex.aux_dict[n].asnumpy() for n in ("bn_moving_mean",
                                                     "bn_moving_var")]
        np.testing.assert_array_equal(before[0], mm)
        np.testing.assert_array_equal(before[1], mv)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        got[pkg] = [out] + [ex.aux_dict[n].asnumpy()
                            for n in ("bn_moving_mean", "bn_moving_var")] \
            + [ex.grad_dict[n].asnumpy()
               for n in ("data", "bn_gamma", "bn_beta")]
    for i, (g, w) in enumerate(zip(got[mt], got[mx])):
        _close(g, w, F32_TOL, "value %d" % i)
    assert not np.allclose(got[mt][1], mm)


@pytest.mark.parametrize("training", [True, False],
                         ids=["record-train", "record-predict"])
def test_global_stats_gradients_match_mxtpu(training):
    """C13: nd.BatchNorm with ``use_global_stats=True`` and all five
    inputs ``attach_grad()``ed, under record() in training and outside
    it: the moving statistics get zero gradients, as mxtpu's autograd
    gives them (it never differentiates an aux input), and data, gamma
    and beta get ``jax.vjp``'s of mxtpu's op. The port raised "not
    differentiable with respect to argument 'running_mean'"."""
    rng = np.random.RandomState(3)
    vals = [rng.randn(2, 3, 4).astype(np.float32),
            rng.uniform(0.5, 1.5, 3).astype(np.float32),
            rng.randn(3).astype(np.float32),
            rng.randn(3).astype(np.float32),
            rng.uniform(0.5, 2.0, 3).astype(np.float32)]
    head = rng.randn(2, 3, 4).astype(np.float32)
    kw = dict(use_global_stats=True, fix_gamma=False)

    def run(pkg):
        arrs = [pkg.nd.array(v) for v in vals]
        for a in arrs:
            a.attach_grad()
        with pkg.autograd.record(train_mode=training):
            y = pkg.nd.BatchNorm(*arrs, **kw)
        y.backward(pkg.nd.array(head))
        return [y.asnumpy()] + [a.grad.asnumpy() for a in arrs]
    with mt.cpu():
        got = run(mt)
    want = run(mx)
    fn = jax_op("BatchNorm").fn
    out, vjp = jax.vjp(
        lambda d, g, b: fn(d, g, b, jnp.asarray(vals[3]),
                           jnp.asarray(vals[4]), _training=training,
                           **kw)[0], *[jnp.asarray(v) for v in vals[:3]])
    ref = [out] + list(vjp(jnp.asarray(head)))
    for i, name in enumerate(("out", "data", "gamma", "beta")):
        _close(got[i], ref[i], F32_TOL, name)
        _close(got[i], want[i], F32_TOL, name)
    for i, name in ((4, "moving_mean"), (5, "moving_var")):
        np.testing.assert_array_equal(got[i], np.zeros(3, np.float32), name)
        np.testing.assert_array_equal(want[i], np.zeros(3, np.float32), name)
