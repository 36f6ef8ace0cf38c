"""The port's optimizers, Updater, local KVStore and LR schedulers
against mxtpu's, on the CPU.

Each case updates the same three parameters from the same gradients in
both packages, through an Updater (slot indices, as Module's own updater)
or a local KVStore with set_optimizer (named keys, as update_on_kvstore),
and compares every weight and state after 1 and 3 steps. Both compute in
float32 with the same operations in the same order (mxtpu through its
jnp ops, the port through torch's); tolerance 1e-6 relative and absolute
for weights and states of magnitude about 1.
"""
import numpy as np
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
