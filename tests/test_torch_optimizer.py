"""The port's optimizers, Updater, local KVStore and LR schedulers
against mxtpu's, on the CPU.

Each case updates the same three parameters from the same gradients in
both packages, through an Updater (slot indices, as Module's own updater)
or a local KVStore with set_optimizer (named keys, as update_on_kvstore),
and compares every weight and state after 1 and 3 steps. Both compute in
float32 with the same operations in the same order (mxtpu through its
jnp ops, the port through torch's); tolerance 1e-6 relative and absolute
for weights and states of magnitude about 1. The constructor keywords
that fit.py passes (``multi_precision``) or that Gluon's Trainer passes
(``param_dict``) are held the same way, and SGD's weight decay, which
skips gamma and beta (their ``wd_mult`` is 0), eagerly and through the
functional step that the captured train step runs.
"""
import types

import jax.numpy as jnp
import numpy as np
import torch
import pytest

import mxtpu as mx
import mxtpu_torch as mt

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"fc_weight": (6, 5), "fc_bias": (6,), "bn_gamma": (6,)}
NAMES = sorted(SHAPES)

CASES = {
    "sgd": ("sgd", dict(learning_rate=0.1)),
    "sgd_momentum_wd_rescale": ("sgd", dict(learning_rate=0.1,
                                            momentum=0.9, wd=1e-2,
                                            rescale_grad=1.0 / 32)),
    "sgd_clip": ("sgd", dict(learning_rate=0.5, momentum=0.9,
                             clip_gradient=0.3)),
    "sgd_factor_scheduler": ("sgd", dict(learning_rate=0.2, momentum=0.5,
                                         scheduler=(1, 0.5))),
    "adam": ("adam", dict(learning_rate=0.01)),
    "adam_wd_clip_rescale": ("adam", dict(learning_rate=0.02, wd=1e-2,
                                          clip_gradient=0.5,
                                          rescale_grad=0.25)),
    # fit.py's keywords: on float32 weights multi_precision changes nothing
    "sgd_fit_keywords": ("sgd", dict(learning_rate=0.1, momentum=0.9,
                                     wd=1e-4, multi_precision=True)),
    # param_dict's multipliers beat the symbol's and the names' rule
    "sgd_param_dict": ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-2,
                                   param_dict={0: (3.0, 0.0), 2: (0.5, 2.0)})),
    "adam_param_dict": ("adam", dict(learning_rate=0.01, wd=1e-2,
                                     param_dict={1: (2.0, 1.0)})),
}


def _sym(pkg):
    """A graph whose variables carry lr / wd multipliers, for the
    optimizer's sym= argument."""
    w = pkg.sym.var("fc_weight", lr_mult=2.0, wd_mult=0.5)
    b = pkg.sym.var("fc_bias", lr_mult=0.5)
    g = pkg.sym.var("bn_gamma")
    x = pkg.sym.var("data")
    return pkg.sym.FullyConnected(x, weight=w, bias=b, num_hidden=6) * g


def _make(pkg, name, kw, idx2name):
    kw = dict(kw)
    sched = kw.pop("scheduler", None)
    if sched is not None:
        kw["lr_scheduler"] = pkg.lr_scheduler.FactorScheduler(*sched)
    if "param_dict" in kw:      # what a Gluon Parameter carries
        kw["param_dict"] = {i: types.SimpleNamespace(lr_mult=lr, wd_mult=wd)
                            for i, (lr, wd) in kw["param_dict"].items()}
    return pkg.optimizer.create(name, sym=_sym(pkg), param_idx2name=idx2name,
                                **kw)


def _data(steps):
    rng = np.random.RandomState(11)
    w = {n: rng.standard_normal(s).astype(np.float32)
         for n, s in SHAPES.items()}
    g = [{n: rng.standard_normal(s).astype(np.float32)
          for n, s in SHAPES.items()} for _ in range(steps)]
    return w, g


def _state_arrays(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [a for s in state for a in _state_arrays(s)]
    return [state.asnumpy()]


def _run_updater(pkg, name, kw, steps):
    """Weights and states after each step, updating through an Updater
    indexed by slot."""
    ctx = {"ctx": pkg.cpu()}
    w0, grads = _data(steps)
    opt = _make(pkg, name, kw, dict(enumerate(NAMES)))
    updater = pkg.optimizer.get_updater(opt)
    weights = {n: pkg.nd.array(w0[n], **ctx) for n in NAMES}
    trace = []
    for g in grads:
        for i, n in enumerate(NAMES):
            updater(i, pkg.nd.array(g[n], **ctx), weights[n])
        trace.append(({n: weights[n].asnumpy() for n in NAMES},
                      {i: _state_arrays(updater.states[i])
                       for i in range(len(NAMES))}))
    return trace, opt


def _run_kvstore(pkg, name, kw, steps):
    """Weights after each step through a local KVStore holding the
    optimizer (pushes of two gradients a key, summed), pulled back."""
    ctx = {"ctx": pkg.cpu()}
    w0, grads = _data(steps)
    kv = pkg.kv.create("local")
    kv.set_optimizer(_make(pkg, name, kw, dict(enumerate(NAMES))))
    outs = {}
    for n in NAMES:
        kv.init(n, pkg.nd.array(w0[n], **ctx))
        outs[n] = pkg.nd.zeros(SHAPES[n], **ctx)
        kv.pull(n, out=outs[n])
    trace = []
    for g in grads:
        for n in NAMES:
            half = pkg.nd.array(g[n] * 0.5, **ctx)
            kv.push(n, [half, half.copy()])
            kv.pull(n, out=outs[n])
        trace.append({n: outs[n].asnumpy() for n in NAMES})
    return trace


@pytest.mark.parametrize("case", sorted(CASES))
def test_updater_matches_mxtpu(case):
    name, kw = CASES[case]
    want, want_opt = _run_updater(mx, name, kw, 3)
    got, got_opt = _run_updater(mt, name, kw, 3)
    assert got_opt.lr_mult == want_opt.lr_mult
    assert got_opt.wd_mult == want_opt.wd_mult
    for step in (0, 2):                     # after 1 and after 3 steps
        (gw, gs), (ww, ws) = got[step], want[step]
        for n in NAMES:
            np.testing.assert_allclose(gw[n], ww[n], **TOL,
                                       err_msg="%s %s" % (case, n))
        for i in ws:
            assert len(gs[i]) == len(ws[i])
            for a, b in zip(gs[i], ws[i]):
                np.testing.assert_allclose(a, b, **TOL)
    assert got_opt.num_update == want_opt.num_update == 3
    assert got_opt.learning_rate == pytest.approx(want_opt.learning_rate)


@pytest.mark.parametrize("case", ["sgd_momentum_wd_rescale",
                                  "adam_wd_clip_rescale"])
def test_kvstore_with_optimizer_matches_mxtpu(case):
    name, kw = CASES[case]
    want = _run_kvstore(mx, name, kw, 3)
    got = _run_kvstore(mt, name, kw, 3)
    for step in (0, 2):
        for n in NAMES:
            np.testing.assert_allclose(got[step][n], want[step][n], **TOL)


def test_updater_states_round_trip():
    """get_states / set_states resume the momentum exactly."""
    name, kw = CASES["sgd_momentum_wd_rescale"]
    w0, grads = _data(3)
    ctx = mt.cpu()

    def fresh():
        return {n: mt.nd.array(w0[n], ctx=ctx) for n in NAMES}

    def step(updater, weights, g):
        for i, n in enumerate(NAMES):
            updater(i, mt.nd.array(g[n], ctx=ctx), weights[n])

    whole = mt.optimizer.get_updater(_make(mt, name, kw, {}))
    w_whole = fresh()
    for g in grads:
        step(whole, w_whole, g)
    first = mt.optimizer.get_updater(_make(mt, name, kw, {}))
    w_split = fresh()
    for g in grads[:2]:
        step(first, w_split, g)
    blob = first.get_states(dump_optimizer=True)
    second = mt.optimizer.get_updater(_make(mt, name, kw, {}))
    second.set_states(blob)
    step(second, w_split, grads[2])
    for n in NAMES:
        np.testing.assert_array_equal(w_split[n].asnumpy(),
                                      w_whole[n].asnumpy())


def test_kvstore_without_updater_sums_and_identity():
    kv = mt.kv.create("local")
    assert (kv.type, kv.rank, kv.num_workers) == ("local", 0, 1)
    a = mt.nd.array(np.ones((2, 3), np.float32), ctx=mt.cpu())
    kv.init("k", a)
    with pytest.raises(ValueError):
        kv.init("k", a)
    kv.push("k", [a, a * 2])
    out = [mt.nd.zeros((2, 3), ctx=mt.cpu()) for _ in range(2)]
    kv.pull("k", out=out)
    for o in out:
        np.testing.assert_array_equal(o.asnumpy(), np.full((2, 3), 3.0))
    out[0][:] = 7.0                         # a pulled array is a copy
    kv.pull("k", out=out[1])
    np.testing.assert_array_equal(out[1].asnumpy(), np.full((2, 3), 3.0))
    with pytest.raises(ValueError):
        mt.kv.create("dist_sync")


@pytest.mark.parametrize("make", [
    lambda p: p.lr_scheduler.FactorScheduler(step=3, factor=0.5,
                                             stop_factor_lr=1e-3),
    lambda p: p.lr_scheduler.MultiFactorScheduler(step=[2, 5, 9],
                                                  factor=0.3),
    lambda p: p.lr_scheduler.PolyScheduler(max_update=12, base_lr=0.2,
                                           pwr=2)])
def test_lr_schedulers_match_mxtpu(make):
    got, want = make(mt), make(mx)
    got.base_lr = want.base_lr = 0.2
    for t in range(1, 16):
        assert got(t) == want(t)
    assert got.state_dict() == want.state_dict()


def test_multi_precision_keeps_float32_master_weights():
    """float16 weights under multi_precision: the state is (float32
    master, momentum), the update runs on the master and the weight takes
    its value rounded, as in mxtpu; without it, the state is the momentum
    alone, in float16."""
    w0, grads = _data(3)
    got = {}
    for pkg in (mt, mx):
        for mp in (True, False):
            opt = pkg.optimizer.create("sgd", learning_rate=0.1,
                                       momentum=0.9, wd=1e-4,
                                       multi_precision=mp,
                                       param_idx2name=dict(enumerate(NAMES)))
            updater = pkg.optimizer.get_updater(opt)
            weights = {n: pkg.nd.array(w0[n], ctx=pkg.cpu(),
                                       dtype="float16") for n in NAMES}
            for g in grads:
                for i, n in enumerate(NAMES):
                    updater(i, pkg.nd.array(g[n], ctx=pkg.cpu(),
                                            dtype="float16"), weights[n])
            got[pkg, mp] = ([weights[n].asnumpy() for n in NAMES],
                            [_state_arrays(updater.states[i])
                             for i in range(len(NAMES))])
    for mp in (True, False):
        (gw, gs), (ww, ws) = got[mt, mp], got[mx, mp]
        for a, b in zip(gw, ww):
            assert a.dtype == b.dtype == np.float16
            np.testing.assert_allclose(a.astype(np.float32),
                                       b.astype(np.float32), rtol=1e-3,
                                       atol=1e-3)
        for a, b in zip(gs, ws):
            assert [x.dtype for x in a] == [x.dtype for x in b] == \
                ([np.float32, np.float32] if mp else [np.float16])
            for x, y in zip(a, b):
                np.testing.assert_allclose(x, y, **(TOL if mp else dict(
                    rtol=1e-3, atol=1e-3)))


WD_NAMES = ("conv0_weight", "bn0_gamma", "bn0_beta", "fc1_bias")


@pytest.mark.parametrize("path", ["eager", "functional"])
def test_sgd_weight_decay_skips_gamma_and_beta(path):
    """One step of fit.py's SGD (lr 0.1, momentum 0.9, wd 1e-4,
    multi_precision) on a conv weight, a BatchNorm's gamma and beta and a
    bias: gamma and beta decay at wd_mult 0, the others at wd. The port's
    Updater (eager) or functional_optimizer_step (the captured step's,
    with t and lr as device scalars) against mxtpu's, and against the
    rule written out."""
    rng = np.random.RandomState(5)
    w0 = {n: rng.standard_normal((4, 3)).astype(np.float32)
          for n in WD_NAMES}
    g0 = {n: rng.standard_normal((4, 3)).astype(np.float32)
          for n in WD_NAMES}
    kw = dict(learning_rate=0.1, momentum=0.9, wd=1e-4,
              multi_precision=True, param_idx2name=dict(enumerate(WD_NAMES)))
    got, want = {}, {}
    for pkg, out in ((mt, got), (mx, want)):
        opt = pkg.optimizer.create("sgd", **kw)
        assert opt.wd_mult == {"bn0_gamma": 0.0, "bn0_beta": 0.0}
        for i, n in enumerate(WD_NAMES):
            if path == "eager" or pkg is mx:
                w = pkg.nd.array(w0[n], ctx=pkg.cpu())
                updater = pkg.optimizer.get_updater(opt)
                updater(i, pkg.nd.array(g0[n], ctx=pkg.cpu()), w)
                out[n] = w.asnumpy()
            else:
                w = torch.tensor(w0[n])
                state = mt.optimizer.state_to_tree(
                    opt.create_state_multi_precision(
                        i, mt.nd.array(w0[n], ctx=mt.cpu())))
                mt.optimizer.functional_optimizer_step(
                    opt, i, w, torch.tensor(g0[n]), state,
                    torch.tensor(1, dtype=torch.int32),
                    torch.tensor(0.1, dtype=torch.float32))
                out[n] = w.numpy()
    if path == "functional":        # mxtpu's own functional step
        opt = mx.optimizer.create("sgd", **kw)
        for i, n in enumerate(WD_NAMES):
            state = mx.optimizer.state_to_tree(
                opt.create_state_multi_precision(i, mx.nd.array(w0[n])))
            w, _ = mx.optimizer.functional_optimizer_step(
                opt, i, jnp.asarray(w0[n]), jnp.asarray(g0[n]), state,
                jnp.asarray(1, jnp.int32), jnp.asarray(0.1, jnp.float32))
            np.testing.assert_allclose(np.asarray(w), want[n], **TOL)
    for n in WD_NAMES:
        wd = 0.0 if n.startswith("bn0_") else 1e-4
        rule = w0[n] - 0.1 * (g0[n] + wd * w0[n])
        np.testing.assert_allclose(got[n], want[n], **TOL, err_msg=n)
        np.testing.assert_allclose(got[n], rule, **TOL, err_msg=n)
