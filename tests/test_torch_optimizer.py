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
functional step that the captured train step runs. Every optimizer of
``mxtpu``'s registry has a case; through ``functional_optimizer_step``
each runs with no host read of ``t`` or ``lr``, no tensor made from
Python values after its first step (a copy from the host, which a capture
refuses) and no Python state on the optimizer that changes from step to
step (what a captured graph would freeze), and gives the eager update's
weights and states. SGLD's noise
is held by its band (mean and deviation of (w' - rule) / sqrt(lr)) in
both packages, and its noise-free part by value.
"""
import types

from torch.overrides import TorchFunctionMode
import jax.numpy as jnp
import numpy as np
import torch
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

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
# the other optimizers of mxtpu's registry, each with the momentum, wd,
# clip and rescale it takes (SGLD draws noise: test_sgld_* below)
COMMON = dict(wd=1e-2, clip_gradient=0.8, rescale_grad=0.5)
CASES.update({
    "signum": ("signum", dict(learning_rate=0.01, momentum=0.9, wd_lh=1e-3,
                              **COMMON)),
    "signsgd": ("signum", dict(learning_rate=0.01, momentum=0.0, **COMMON)),
    "ftml": ("ftml", dict(learning_rate=0.01, **COMMON)),
    "lbsgd_linear": ("lbsgd", dict(learning_rate=0.1, momentum=0.9,
                                   warmup_epochs=1, updates_per_epoch=4,
                                   batch_scale=4, **COMMON)),
    "lbsgd_power2": ("lbsgd", dict(learning_rate=0.1, warmup_epochs=1,
                                   updates_per_epoch=3,
                                   warmup_strategy="power2", batch_scale=3,
                                   **COMMON)),
    "lbsgd_sqrt": ("lbsgd", dict(learning_rate=0.1, momentum=0.5,
                                 warmup_epochs=2, updates_per_epoch=2,
                                 warmup_strategy="sqrt", batch_scale=2,
                                 begin_epoch=1, **COMMON)),
    "lbsgd_lars": ("lbsgd", dict(learning_rate=0.1, momentum=0.9,
                                 warmup_strategy="lars", **COMMON)),
    "dcasgd": ("dcasgd", dict(learning_rate=0.1, momentum=0.9, **COMMON)),
    "dcasgd_no_momentum": ("dcasgd", dict(learning_rate=0.1, lamda=0.1,
                                          **COMMON)),
    "nag": ("nag", dict(learning_rate=0.1, momentum=0.9, **COMMON)),
    "nag_factor_scheduler": ("nag", dict(learning_rate=0.2, momentum=0.5,
                                         scheduler=(1, 0.5))),
    "ccsgd": ("ccsgd", dict(learning_rate=0.1, momentum=0.9, **COMMON)),
    "adagrad": ("adagrad", dict(learning_rate=0.1, eps=1e-6, **COMMON)),
    "rmsprop": ("rmsprop", dict(learning_rate=0.01, clip_weights=1.5,
                                **COMMON)),
    "rmsprop_centered": ("rmsprop", dict(learning_rate=0.01, centered=True,
                                         **COMMON)),
    "adadelta": ("adadelta", dict(rho=0.9, epsilon=1e-4, **COMMON)),
    "ftrl": ("ftrl", dict(learning_rate=0.1, lamda1=0.05, beta=1.5,
                          **COMMON)),
    "adamax": ("adamax", dict(learning_rate=0.01, **COMMON)),
    "nadam": ("nadam", dict(learning_rate=0.01, **COMMON)),
    "nadam_fit_keywords": ("nadam", dict(learning_rate=0.01, wd=1e-4,
                                         multi_precision=True)),
    "test": ("test", dict(rescale_grad=0.5)),
})


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
    # Test counts no update
    assert got_opt.num_update == want_opt.num_update == \
        (0 if name == "test" else 3)
    assert got_opt.learning_rate == pytest.approx(want_opt.learning_rate)
    if name == "nadam":     # one product a parameter an update
        assert got_opt.m_schedule == pytest.approx(want_opt.m_schedule,
                                                   rel=1e-12)


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


class NoHostRead(TorchFunctionMode):
    """Raise on any read of a tensor's value into Python (inside a
    captured step such a value would be frozen into the graph) and, with
    ``strict``, on any tensor made from Python values (a copy from the
    host, which a capture refuses: only a first, uncaptured step may make
    the state it keeps)."""

    BANNED = {torch.Tensor.item, torch.Tensor.__bool__,
              torch.Tensor.__float__, torch.Tensor.__int__,
              torch.Tensor.__index__, torch.Tensor.tolist,
              torch.Tensor.numpy}
    FROM_HOST = {torch.tensor, torch.as_tensor, torch.Tensor.new_tensor}

    def __init__(self, strict=False):
        super().__init__()
        self.strict = strict

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.BANNED or (self.strict and func in self.FROM_HOST):
            raise AssertionError("host read or copy: %s" % func)
        return func(*args, **(kwargs or {}))


def _host_state(opt):
    """The optimizer's Python scalars, and which tensor each tensor
    attribute is: a captured step replays on the tensors it saw, so
    neither may change from step to step."""
    return {k: v if isinstance(v, (bool, int, float)) else id(v)
            for k, v in vars(opt).items()
            if isinstance(v, (bool, int, float, torch.Tensor))}


def _run_functional(name, kw, steps, generator=None):
    """The port's weights and states after each step through
    functional_optimizer_step, as the fused step drives it: t advanced
    on the device before the step's updates, lr written when the schedule
    moves."""
    w0, grads = _data(steps)
    opt = _make(mt, name, kw, dict(enumerate(NAMES)))
    weights = {n: torch.tensor(w0[n]) for n in NAMES}
    states = [mt.optimizer.state_to_tree(opt.create_state_multi_precision(
        i, mt.nd.array(w0[n], ctx=mt.cpu()))) for i, n in enumerate(NAMES)]
    t = torch.tensor(0, dtype=torch.int32)
    lr = torch.tensor(0.0)
    trace, frozen = [], None
    for step, g in enumerate(grads, 1):
        sched = opt.lr_scheduler
        lr.fill_(sched(step) if sched is not None else opt.lr)
        t.add_(1)
        scope = mt.ops.registry.rng_scope(generator) \
            if generator is not None else NoHostRead()
        grads = {n: torch.tensor(g[n]) for n in NAMES}
        with scope, NoHostRead(strict=step > 1):
            for i, n in enumerate(NAMES):
                mt.optimizer.functional_optimizer_step(
                    opt, i, weights[n], grads[n], states[i], t, lr)
        if frozen is None:
            frozen = _host_state(opt)
        assert _host_state(opt) == frozen, "host state moved"
        trace.append(({n: weights[n].numpy().copy() for n in NAMES},
                      {i: [x.numpy().copy() for x in
                           mt.module.fused._leaves(
                               mt.optimizer.tree_to_state(states[i]))]
                       for i in range(len(NAMES))}))
    return trace, opt


@pytest.mark.parametrize("case", sorted(CASES))
def test_functional_step_matches_eager(case):
    """The captured step's update against the port's eager Updater,
    within TOL after 1 and 3 steps; Nadam's m_schedule a device scalar
    equal to the eager product."""
    name, kw = CASES[case]
    want, want_opt = _run_updater(mt, name, kw, 3)
    got, got_opt = _run_functional(name, kw, 3)
    for step in (0, 2):
        (gw, gs), (ww, ws) = got[step], want[step]
        for n in NAMES:
            np.testing.assert_allclose(gw[n], ww[n], **TOL,
                                       err_msg="%s %s" % (case, n))
        for i in ws:
            assert len(gs[i]) == len(ws[i])
            for a, b in zip(gs[i], ws[i]):
                np.testing.assert_allclose(a, b, **TOL)
    if name == "nadam":
        assert isinstance(got_opt.m_schedule, torch.Tensor)
        assert float(got_opt.m_schedule) == pytest.approx(
            want_opt.m_schedule, rel=1e-12)


SGLD_KW = dict(learning_rate=0.01, wd=1e-2, clip_gradient=0.8,
               rescale_grad=0.5)
SGLD_SHAPES = {"fc_weight": (100, 100), "fc_bias": (100,)}


def _sgld_rule(w, g):
    """SGLD's step without its noise, in float32 as both compute it."""
    lr, wd = np.float32(SGLD_KW["learning_rate"]), np.float32(SGLD_KW["wd"])
    g = np.clip(g * np.float32(SGLD_KW["rescale_grad"]), -0.8, 0.8)
    return w - lr / np.float32(2) * (g + wd * w)


def test_sgld_noise_free_part_and_band():
    """Three SGLD steps of two parameters in both packages: each step's
    noise, (w' - rule(w)) / sqrt(lr), has mean within 0.05 of 0 and
    deviation within 0.05 of 1 over the 10,100 entries (5 and 7 standard
    errors); the port's noise is the generator's own draw, so its
    noise-free part equals the rule within TOL."""
    rng = np.random.RandomState(3)
    names = sorted(SGLD_SHAPES)
    w0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in SGLD_SHAPES.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32)
              for n, s in SGLD_SHAPES.items()} for _ in range(3)]
    scale = np.sqrt(SGLD_KW["learning_rate"])
    for pkg in (mt, mx):
        opt = pkg.optimizer.create("sgld", **SGLD_KW)
        updater = pkg.optimizer.get_updater(opt)
        weights = {n: pkg.nd.array(w0[n], ctx=pkg.cpu()) for n in names}
        gen = torch.Generator().manual_seed(7)
        for g in grads:
            before = {n: weights[n].asnumpy() for n in names}
            noise = []
            for i, n in enumerate(names):
                draw = torch.Generator().set_state(gen.get_state())
                if pkg is mt:
                    with mt.ops.registry.rng_scope(gen):
                        updater(i, pkg.nd.array(g[n], ctx=pkg.cpu()),
                                weights[n])
                else:
                    updater(i, pkg.nd.array(g[n]), weights[n])
                rest = weights[n].asnumpy() - _sgld_rule(before[n], g[n])
                if pkg is mt:
                    mine = torch.randn(SGLD_SHAPES[n], generator=draw)
                    np.testing.assert_allclose(
                        rest, mine.numpy() * np.float32(scale), **TOL)
                noise.append(rest.ravel() / scale)
            noise = np.concatenate(noise)
            assert abs(noise.mean()) < 0.05, (pkg.__name__, noise.mean())
            assert abs(noise.std() - 1.0) < 0.05, (pkg.__name__,
                                                   noise.std())


def test_sgld_functional_draws_the_step_generator():
    """Through functional_optimizer_step SGLD draws from the generator
    in scope (the captured step's), the numbers the eager update draws
    from a generator in the same state."""
    eager = {}
    w0, grads = _data(3)
    opt = _make(mt, "sgld", SGLD_KW, dict(enumerate(NAMES)))
    updater = mt.optimizer.get_updater(opt)
    gen = torch.Generator().manual_seed(5)
    weights = {n: mt.nd.array(w0[n], ctx=mt.cpu()) for n in NAMES}
    with mt.ops.registry.rng_scope(gen):
        for g in grads:
            for i, n in enumerate(NAMES):
                updater(i, mt.nd.array(g[n], ctx=mt.cpu()), weights[n])
    eager = {n: weights[n].asnumpy() for n in NAMES}
    got, _ = _run_functional("sgld", SGLD_KW, 3,
                             generator=torch.Generator().manual_seed(5))
    for n in NAMES:
        np.testing.assert_allclose(got[2][0][n], eager[n], **TOL)
