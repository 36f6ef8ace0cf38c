"""The port's fused Module train step against mxtpu's, on the CPU.

mxtpu's fused step (mxtpu/module/fused.py) runs forward, backward, the
whole update and the metric's device (sum, count) as one jitted program a
batch signature; the port's (mxtpu_torch/module/fused.py) runs the same
step as one function over the executor's tensors, captured in a CUDA graph
on the card and run as it is on the CPU, as here. Models: the toy MLP of
tests/test_module_fused.py, and chip_smoke.py's custom-softmax MLP and
LeNet (the custom_softmax.py and train_mnist.py --network lenet networks)
at FIT_SAMPLES samples, whose last batch is padded.

Tolerances: a fused fit against mxtpu's fused fit from the same weights
and batches within FIT_TOL, tests/test_torch_module.py's band for one
eager epoch (the same float32 sums in another order, scaled down by
lr / batch into the weights; Adam's folded rate is computed in float32 on
both sides, its power function one ulp apart), except for the few
weights where the two packages' eager fits are already further apart
(APART, fixed limits); the port's fused fit against its eager fit within
the band tests/test_module_fused.py holds mxtpu's two paths to (rtol
5e-4, atol 1e-5), except for a few weights of Adam on the custom-softmax
MLP (ADAM_RATE, fixed limits). Counts (program-cache and trainer stats,
numpy's global RNG state, eligibility outcomes and their reasons) and the
metric read at the end of a fit with a padded last batch are equal.
"""
import importlib.util
import pathlib
import warnings

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu_torch.base import CaptureRefused
from mxtpu_torch.module import fused as mt_fused

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIT_TOL = dict(rtol=1e-5, atol=1e-6)
BAND = dict(rtol=5e-4, atol=1e-5)
FIT_SAMPLES = 300           # a padded last batch at 64 and at 128
OPTIMIZERS = {
    "sgd": {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4},
    "adam": {"learning_rate": 0.01},
}
# Where the two packages' eager fits already differ past FIT_TOL after two
# epochs, in a few weights, the fused fits may differ past FIT_TOL in at
# most ``beyond`` weights, by at most ``limit``; all others are held to
# FIT_TOL. The causes: LeNet with SGD, the convolutions sum in another
# order, and ten momentum steps carry it into a few conv2 weights (within
# FIT_TOL everywhere for one epoch, ``horizon``, which is checked too);
# Adam divides each step by sqrt(v) + 1e-8, so that where a gradient nearly
# cancels its float32 rounding moves the weight by up to
# lr (1 - beta1) / 1e-8 = 1e5 times the rounding, from the first step on
# (one step of LeNet: 1.3e-5), so Adam has no horizon. Readings of the
# port's fused fit against mxtpu's on the CPU (and of the two eager fits):
# MLP / Adam 77 of 101,770 weights past FIT_TOL, at most 6.5e-6 (eager 79,
# 6.4e-6); LeNet / SGD 8 of 431,080, 1.6e-6 (eager 8, 1.6e-6); LeNet / Adam
# 1,191 of 431,080, 1.1e-4 (eager 1,108, 1.1e-4). The limits hold about
# three times the readings.
APART = {("mlp", "adam"): dict(beyond=250, limit=2e-5, horizon=None),
         ("lenet", "sgd"): dict(beyond=25, limit=5e-6, horizon=1),
         ("lenet", "adam"): dict(beyond=3600, limit=3e-4, horizon=None)}
# Adam's rate, eager and fused: the eager update folds t into the rate on
# the host (1 - beta2**t in float64, then float32), the fused step on the
# device in float32, where 1 - 0.999**t keeps a relative error of 1.3e-5 at
# t = 1; Adam's amplification above carries it into a few of the MLP's
# weights (mxtpu's own fused and eager fits differ as much: 4 weights past
# BAND, 3.7e-5). Reading of the port's two fits: 4 of 101,770 weights past
# BAND, at most 3.7e-5; the limits hold about three times that.
ADAM_RATE = {("mlp", "adam"): dict(beyond=12, limit=1.2e-4)}
# the functional update against the eager one after five Adam steps of lr
# <= 0.02 with that 1.3e-5 relative error in the rate at t = 1
RATE_TOL = dict(rtol=1e-6, atol=1e-6)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    mod = _load("chip_smoke", ROOT / "chip_smoke.py")
    mod.cs_register(mt)
    # registers the example's numpy op as op_type "softmax" in mxtpu
    _load("custom_softmax",
          ROOT / "example" / "numpy-ops" / "custom_softmax.py")
    return mod


@pytest.fixture(autouse=True)
def fused_on(monkeypatch):
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "1")
    monkeypatch.delenv("MXTPU_METRIC_READBACK", raising=False)


def _toy_problem(n=128, dim=20, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, dim).astype("float32")
    w = rng.randn(dim, classes).astype("float32")
    y = (x @ w).argmax(axis=1).astype("float32")
    return x, y


def _toy_symbol(pkg, classes=4):
    data = pkg.sym.var("data")
    net = pkg.sym.FullyConnected(data, num_hidden=32, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu", name="relu1")
    net = pkg.sym.FullyConnected(net, num_hidden=classes, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _toy_params():
    rng = np.random.RandomState(1)
    return {"fc1_weight": rng.uniform(-0.3, 0.3, (32, 20)),
            "fc1_bias": np.zeros(32), "fc2_weight":
            rng.uniform(-0.3, 0.3, (4, 32)), "fc2_bias": np.zeros(4)}


def _problem(smoke, model):
    """(symbol maker, x, y, batch, initial weights {name: numpy})."""
    if model == "toy":
        x, y = _toy_problem()
        params = _toy_params()
        return _toy_symbol, x, y, 32, {k: v.astype(np.float32)
                                       for k, v in params.items()}
    if model == "mlp":
        x, y = smoke.cs_data()
        return (smoke.cs_symbol, x[:FIT_SAMPLES], y[:FIT_SAMPLES],
                smoke.CS_BATCH, smoke.cs_init_params(0))
    x, y, _, _ = smoke.lenet_data()
    return (smoke.lenet_symbol, x[:FIT_SAMPLES], y[:FIT_SAMPLES],
            smoke.LENET_BATCH, smoke.lenet_init_params(mt, 0))


def _fit(pkg, smoke, model, optimizer="sgd", opt_params=None, epochs=2,
         eval_metric="acc", **fit_kw):
    """``model`` trained ``epochs`` epochs by Module.fit on the CPU of
    ``pkg`` from the same weights and shuffled batches; the module."""
    make, x, y, batch, params = _problem(smoke, model)
    np.random.seed(7)
    train = pkg.io.NDArrayIter(x, y, batch, shuffle=True,
                               label_name="softmax_label")
    mod = pkg.mod.Module(make(pkg), context=pkg.cpu())
    mod.fit(train, optimizer=optimizer,
            optimizer_params=dict(opt_params or OPTIMIZERS[optimizer]),
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in params.items()},
            num_epoch=epochs, eval_metric=eval_metric, **fit_kw)
    return mod


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _assert_params(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)


def _assert_mostly(got, want, tol, beyond, limit):
    """``got`` within ``tol`` of ``want`` in all but at most ``beyond``
    weights, and every weight within ``limit``."""
    assert sorted(got) == sorted(want)
    past, worst = 0, 0.0
    for k in want:
        d = np.abs(got[k] - want[k])
        past += int((d > tol["atol"] + tol["rtol"] * np.abs(want[k])).sum())
        worst = max(worst, float(d.max()))
    assert past <= beyond and worst <= limit, (past, worst)


def _common_stats(port, ref):
    """The port's trainer stats on mxtpu's keys (the port adds
    ``fallbacks``)."""
    return {k: port[k] for k in ref}


# -- whole fits ----------------------------------------------------------------

@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
@pytest.mark.parametrize("model", ["toy", "mlp", "lenet"])
def test_fused_fit_matches_mxtpu(smoke, monkeypatch, model, optimizer):
    """Parameters, program-cache and trainer stats and numpy's global RNG
    state after two fused epochs, both packages."""
    got = _fit(mt, smoke, model, optimizer)
    got_rng = np.random.get_state()[1].copy()
    want = _fit(mx, smoke, model, optimizer)
    want_rng = np.random.get_state()[1].copy()
    assert got._fused is not None and want._fused is not None
    apart = APART.get((model, optimizer))
    if apart is None:
        _assert_params(_params(got), _params(want), FIT_TOL)
    else:
        _assert_mostly(_params(got), _params(want), FIT_TOL,
                       apart["beyond"], apart["limit"])
        if apart["horizon"]:
            _assert_params(
                *[_params(_fit(pkg, smoke, model, optimizer,
                               epochs=apart["horizon"])) for pkg in (mt, mx)],
                FIT_TOL)
    assert got._fused._cache.stats() == want._fused._cache.stats()
    port_stats = got._fused._group.stats
    assert _common_stats(port_stats, want._fused._group.stats) == \
        want._fused._group.stats
    assert port_stats["fallbacks"] == 0
    np.testing.assert_array_equal(got_rng, want_rng)


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
@pytest.mark.parametrize("model", ["toy", "mlp", "lenet"])
def test_fused_fit_matches_eager_fit(smoke, monkeypatch, model, optimizer):
    fused = _fit(mt, smoke, model, optimizer)
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "0")
    eager = _fit(mt, smoke, model, optimizer)
    assert fused._fused is not None and eager._fused is None
    rate = ADAM_RATE.get((model, optimizer))
    if rate is None:
        _assert_params(_params(fused), _params(eager), BAND)
    else:
        _assert_mostly(_params(fused), _params(eager), BAND, **rate)


@pytest.mark.parametrize("metric", ["acc", "ce"])
def test_device_metric_matches_mxtpu(smoke, metric):
    """The metric that the fused step accumulated on the device, read at
    the end, equals mxtpu's, and drains as often."""
    got_m, want_m = mt.metric.create(metric), mx.metric.create(metric)
    got = _fit(mt, smoke, "toy", eval_metric=got_m)
    want = _fit(mx, smoke, "toy", eval_metric=want_m)
    assert got_m.get()[0] == want_m.get()[0]
    np.testing.assert_allclose(got_m.get()[1], want_m.get()[1], rtol=1e-6)
    assert _common_stats(got._fused._group.stats,
                         want._fused._group.stats) == \
        want._fused._group.stats


@pytest.mark.parametrize("metric", ["acc", "ce"])
@pytest.mark.parametrize("model", ["mlp", "lenet"])
def test_padded_metric_matches_mxtpu(smoke, model, metric):
    """An epoch whose last batch is padded (FIT_SAMPLES at 64 and at 128):
    the metric the fused step accumulated on the device, read at the end,
    counts the padded batch as mxtpu's does."""
    got_m, want_m = mt.metric.create(metric), mx.metric.create(metric)
    got = _fit(mt, smoke, model, epochs=1, eval_metric=got_m)
    want = _fit(mx, smoke, model, epochs=1, eval_metric=want_m)
    assert got._fused._group.metric_fn is not None
    assert got_m.num_inst == want_m.num_inst
    assert got_m.get()[0] == want_m.get()[0]
    np.testing.assert_allclose(got_m.get()[1], want_m.get()[1], rtol=1e-6)
    assert got._fused._cache.stats() == want._fused._cache.stats()


def test_metric_readback_interval_matches_mxtpu(smoke, monkeypatch):
    monkeypatch.setenv("MXTPU_METRIC_READBACK", "3")
    got = _fit(mt, smoke, "toy")
    want = _fit(mx, smoke, "toy")
    assert got._fused._group.readback_every == 3
    assert _common_stats(got._fused._group.stats,
                         want._fused._group.stats) == \
        want._fused._group.stats


def test_composite_metric_stays_on_the_host(smoke):
    """A composite metric has no device rule in either package: the step
    runs without it, and the host path feeds it."""
    got_m = mt.metric.create(["acc", "ce"])
    want_m = mx.metric.create(["acc", "ce"])
    got = _fit(mt, smoke, "toy", eval_metric=got_m)
    want = _fit(mx, smoke, "toy", eval_metric=want_m)
    assert got._fused._group.metric_fn is None
    assert got._fused._cache.stats() == want._fused._cache.stats()
    assert got_m.get()[0] == want_m.get()[0]
    np.testing.assert_allclose(got_m.get()[1], want_m.get()[1], rtol=1e-6)


@pytest.mark.parametrize("optimizer", sorted(OPTIMIZERS))
def test_lr_schedule_moves_inside_the_fused_step(smoke, optimizer):
    """A FactorScheduler halving lr every 3 updates (mid-epoch: 4 batches
    an epoch) moves the rate the fused step reads, as in mxtpu."""
    def run(pkg):
        params = dict(OPTIMIZERS[optimizer])
        params["lr_scheduler"] = pkg.lr_scheduler.FactorScheduler(3, 0.5)
        return _fit(pkg, smoke, "toy", optimizer, params, epochs=3)
    got, want = run(mt), run(mx)
    assert got._fused is not None
    assert got._optimizer.num_update == want._optimizer.num_update == 12
    assert got._fused._group.lr_host == pytest.approx(
        want._optimizer.learning_rate)
    _assert_params(_params(got), _params(want), FIT_TOL)


@pytest.mark.parametrize("src,dst", [(mt, mx), (mx, mt)],
                         ids=["port-to-mxtpu", "mxtpu-to-port"])
def test_optimizer_states_cross_packages(smoke, tmp_path, src, dst):
    """Momentum saved by one package's fused fit loads into the other's
    module, which trains on fused and ends where the saving one does."""
    x, y = _toy_problem()
    w0 = {k: v.astype(np.float32) for k, v in _toy_params().items()}
    opt = OPTIMIZERS["sgd"]

    def module(pkg, params):
        mod = pkg.mod.Module(_toy_symbol(pkg), context=pkg.cpu())
        mod.bind([("data", (32, 20))], [("softmax_label", (32,))])
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                    for k, v in params.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params=opt)
        return mod

    def epoch(pkg, mod):
        it = pkg.io.NDArrayIter(x, y, 32, label_name="softmax_label")
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
        return mod

    first = epoch(src, module(src, w0))
    fname = str(tmp_path / "opt.states")
    first.save_optimizer_states(fname)
    mid = _params(first)
    want = _params(epoch(src, first))
    moved = module(dst, mid)
    moved.load_optimizer_states(fname)
    epoch(dst, moved)
    assert moved._fused is not None
    assert moved._fused._group.stats["steps"] == 4
    _assert_params(_params(moved), want, FIT_TOL)


def test_get_outputs_after_a_fused_step(smoke):
    """get_outputs() returns the step's outputs (the forward before the
    update), as mxtpu's fused step publishes them."""
    x, y = _toy_problem()
    w0 = {k: v.astype(np.float32) for k, v in _toy_params().items()}
    outs = {}
    for pkg in (mt, mx):
        mod = pkg.mod.Module(_toy_symbol(pkg), context=pkg.cpu())
        mod.bind([("data", (32, 20))], [("softmax_label", (32,))])
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                    for k, v in w0.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=OPTIMIZERS["sgd"])
        batch = pkg.io.DataBatch([pkg.nd.array(x[:32], ctx=pkg.cpu())],
                                 [pkg.nd.array(y[:32], ctx=pkg.cpu())])
        mod.forward_backward(batch)
        mod.update()
        assert mod._fused is not None
        outs[pkg] = mod.get_outputs()[0].asnumpy()
    assert outs[mt].shape == (32, 4)
    h = np.maximum(x[:32] @ w0["fc1_weight"].T + w0["fc1_bias"], 0)
    z = h @ w0["fc2_weight"].T + w0["fc2_bias"]
    e = np.exp(z - z.max(1, keepdims=True))
    np.testing.assert_allclose(outs[mt], e / e.sum(1, keepdims=True),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[mt], outs[mx], rtol=1e-5, atol=1e-6)


# -- rebinds: the program is keyed on the signature ---------------------------

def _rebind_probe(pkg, probe):
    """The fused toy MLP from the same weights through rebinds: ``eval``
    fits 4 epochs of 32-row batches scored on 16-row batches each epoch;
    ``alternate`` steps 12 batches of 32 and 16 rows in turn. Returns
    (module, params)."""
    x, y = _toy_problem()
    w0 = {k: pkg.nd.array(v.astype(np.float32), ctx=pkg.cpu())
          for k, v in _toy_params().items()}
    mod = pkg.mod.Module(_toy_symbol(pkg), context=pkg.cpu())
    if probe == "eval":
        train = pkg.io.NDArrayIter(x, y, 32, label_name="softmax_label")
        val = pkg.io.NDArrayIter(x[:64], y[:64], 16,
                                 label_name="softmax_label")
        mod.fit(train, eval_data=val, optimizer="sgd",
                optimizer_params=OPTIMIZERS["sgd"], arg_params=w0,
                num_epoch=4, eval_metric="acc")
    else:
        mod.bind([("data", (32, 20))], [("softmax_label", (32,))])
        mod.init_params(arg_params=w0)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params=OPTIMIZERS["sgd"])
        metric = pkg.metric.create("acc")
        for i in range(12):
            rows = slice(0, 32) if i % 2 == 0 else slice(32, 48)
            batch = pkg.io.DataBatch([pkg.nd.array(x[rows], ctx=pkg.cpu())],
                                     [pkg.nd.array(y[rows], ctx=pkg.cpu())])
            mod.forward_backward(batch)
            mod.update()
            mod.update_metric(metric, batch.label)
    return mod, _params(mod)


@pytest.mark.parametrize("probe,compiles,hits", [("eval", 2, 14),
                                                 ("alternate", 3, 9)])
def test_rebinds_hit_the_signatures_program(probe, compiles, hits):
    """A rebind to a signature seen before (fit's scoring at another batch
    size, or batches whose size alternates) finds its program: mxtpu's
    compiles, hits and entries, and its weights. The executors of each
    signature work on one set of parameter arrays, so a rebind copies
    none."""
    got, got_params = _rebind_probe(mt, probe)
    want, want_params = _rebind_probe(mx, probe)
    stats = got._fused._cache.stats()
    assert stats == want._fused._cache.stats()
    assert (stats["compiles"], stats["hits"]) == (compiles, hits)
    assert stats["programs"] == len(got._fused._cache.entries()) == compiles
    _assert_params(got_params, want_params, FIT_TOL)
    group = got._exec_group
    assert len(group._bound) == 2
    first, second = (execs[0] for execs in group._bound.values())
    for name in ("fc1_weight", "fc2_bias"):
        assert first.arg_dict[name] is second.arg_dict[name]
        assert first.arg_dict[name] is got._fused._group.param_store[name]


# -- eligibility ---------------------------------------------------------------

class _PortMonitor:
    """The port has no Monitor class; this one installs a callback as
    Monitor.install does."""

    def __init__(self):
        self.seen = []

    def install(self, exe):
        exe.set_monitor_callback(lambda name, arr: self.seen.append(name))


def _eligibility_case(pkg, case, monkeypatch):
    """Bind, init and train one batch of the toy MLP under ``case``:
    (engaged after the batch, the reason it is not)."""
    if case == "fused_env_off":
        monkeypatch.setenv("MXTPU_MODULE_FUSED", "0")
    x, y = _toy_problem()
    mod = pkg.mod.Module(_toy_symbol(pkg), context=pkg.cpu())
    bind_kw = {"for_training": case != "for_training_false",
               "inputs_need_grad": case == "inputs_need_grad",
               "grad_req": "add" if case == "grad_req_add" else "write"}
    mod.bind([("data", (32, 20))], [("softmax_label", (32,))], **bind_kw)
    mod.init_params(pkg.init.Xavier())
    kv = pkg.kv.create("local") if case == "kvstore_object" else "local"
    mod.init_optimizer(kvstore=kv, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05})
    reason = getattr(mod, "_fused_fallback_logged", None)
    if case == "monitor":
        mod.install_monitor(_PortMonitor() if pkg is mt
                            else pkg.monitor.Monitor(1))
    if case == "custom_updater":
        def updater(index, grad, weight):
            weight[:] = weight - 0.01 * grad
        mod._updater = updater
    if not bind_kw["for_training"]:
        return mod._fused is not None, reason
    batch = pkg.io.DataBatch([pkg.nd.array(x[:32], ctx=pkg.cpu())],
                             [pkg.nd.array(y[:32], ctx=pkg.cpu())])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mod.forward_backward(batch)
        mod.update()
        mod.forward_backward(batch)
        mod.update()
    said = [str(w.message) for w in caught
            if "fused train step disabled" in str(w.message)]
    assert len(said) <= 1, said          # warned once
    return mod._fused is not None, reason or (said[0] if said else None)


@pytest.mark.parametrize("case", [
    "engaged", "kvstore_object", "monitor", "custom_updater",
    "for_training_false", "inputs_need_grad", "grad_req_add",
    "fused_env_off"])
def test_eligibility_matches_mxtpu(smoke, monkeypatch, case):
    got = _eligibility_case(mt, case, monkeypatch)
    want = _eligibility_case(mx, case, monkeypatch)
    assert got == want
    assert got[0] == (case == "engaged")


def test_eligibility_reasons_are_mxtpus():
    """The port's predicate and mxtpu's give the same reason for the
    same module state, including the ones no public call reaches."""
    from mxtpu.module import fused as mx_fused

    class Fake:
        _context = [None]
        for_training = True
        inputs_need_grad = False
        _state_names = []
        _grad_req = "write"
        _kvstore = None

        class _exec_group:
            execs = [type("E", (), {"arg_dict": {}, "grad_dict": {}})()]

    for attr, value in (("_context", [None, None]), ("_state_names", ["s"]),
                        ("_grad_req", "null")):
        fake = Fake()
        setattr(fake, attr, value)
        fake._updater = object()
        assert mt_fused._fused_eligible(fake) == \
            mx_fused._fused_eligible(fake)


# -- the card's own fallback, rehearsed --------------------------------------

def _as_on_card(monkeypatch, capture):
    """Run the trainer's card path on the CPU: warm-ups call the step,
    and ``capture(trainer, entry)`` stands for the capture."""
    monkeypatch.setattr(mt_fused.FusedModuleTrainer, "_on_card",
                        lambda self: True)
    monkeypatch.setattr(mt_fused.FusedModuleTrainer, "_warm_up",
                        lambda self, entry: entry.call())
    monkeypatch.setattr(mt_fused.FusedModuleTrainer, "_capture", capture)


def test_refused_capture_falls_back_once(smoke, monkeypatch):
    """On the card a custom op that reads the card refuses the capture at
    a signature's second step. Simulated here: the trainer warns once,
    counts the fallback, hands the metric what the fused steps added, and
    the fit trains on eagerly, that batch included, to the eager fit's
    weights and metric."""
    def refuse(self, entry):
        raise CaptureRefused("softmax_host", "host read while capturing")

    _as_on_card(monkeypatch, refuse)
    got_m = mt.metric.create("acc")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = _fit(mt, smoke, "toy", eval_metric=got_m)
    said = [str(w.message) for w in caught
            if "fused train step disabled" in str(w.message)]
    assert len(said) == 1 and "softmax_host" in said[0]
    assert got._fused is None
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "0")
    want_m = mt.metric.create("acc")
    want = _fit(mt, smoke, "toy", eval_metric=want_m)
    _assert_params(_params(got), _params(want), BAND)
    assert got_m.get() == want_m.get()
    assert got_m.num_inst == want_m.num_inst == 128


def test_capture_fault_raises(smoke, monkeypatch):
    """A capture that fails for any reason but a refused host read
    raises out of Module.fit: no fallback, no warning."""
    def fault(self, entry):
        raise RuntimeError("CUDA error: too many resources requested "
                           "for launch")

    _as_on_card(monkeypatch, fault)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with pytest.raises(RuntimeError, match="too many resources"):
            _fit(mt, smoke, "toy")
    assert not [w for w in caught
                if "fused train step disabled" in str(w.message)]


@pytest.mark.parametrize("error,refused", [
    (RuntimeError("Cannot copy between CPU and CUDA tensors during CUDA "
                  "graph capture unless the CPU tensor is pinned."), True),
    (RuntimeError("CUDA error: operation not permitted when stream is "
                  "capturing\nSearch for `cudaErrorStreamCaptureUnsupported'"
                  " in https://docs.nvidia.com/cuda"), True),
    (RuntimeError("CUDA error: operation failed due to a previous error "
                  "during capture\nSearch for "
                  "`cudaErrorStreamCaptureInvalidated'"), True),
    (RuntimeError("Attempt to increase offset for a CUDA generator not in "
                  "capture mode."), False),
    (RuntimeError("cuLaunchKernel failed: CUDA_ERROR_INVALID_VALUE"), False),
    (ValueError("a fault of the op's own"), False),
], ids=["host-copy", "host-wait", "invalidated", "generator", "launch",
        "value"])
def test_custom_op_refusal_is_only_a_host_read(monkeypatch, error, refused):
    """A custom op's body that fails while a capture is under way raises
    CaptureRefused only for torch's or CUDA's refusal of a host read;
    every other error is raised as it is (simulated: the body raises the
    error torch gives on the card)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    spec = type("Spec", (), {"device": torch.device("cuda"),
                             "op_type": "softmax_host"})()

    def body():
        raise error

    with pytest.raises(CaptureRefused if refused else type(error)) as info:
        mt.operator._Spec._run_body(spec, body)
    if refused:
        assert info.value.op == "softmax_host"
        assert info.value.__cause__ is error
    else:
        assert info.value is error


def _rnn_symbol(pkg, batch, hidden):
    """A 2-layer LSTM with dropout between the layers over (N, T, I)
    inputs, a class a step: the RNN op draws its dropout masks in the
    train step."""
    data = pkg.sym.var("data")
    seq = pkg.sym.swapaxes(data, dim1=0, dim2=1)
    params = pkg.sym.var("lstm_parameters", init=pkg.init.Uniform(0.1))
    state, cell = [pkg.sym.var(name, shape=(2, batch, hidden),
                               init=pkg.init.Zero())
                   for name in ("lstm_state", "lstm_state_cell")]
    out = pkg.sym.RNN(seq, parameters=params, state=state, state_cell=cell,
                      state_size=hidden, num_layers=2, mode="lstm", p=0.5,
                      name="lstm")
    flat = pkg.sym.reshape(pkg.sym.swapaxes(out, dim1=0, dim2=1),
                           shape=(-3, 0))
    logits = pkg.sym.FullyConnected(flat, num_hidden=4, name="fc")
    label = pkg.sym.reshape(pkg.sym.var("softmax_label"), shape=(-1,))
    return pkg.sym.SoftmaxOutput(logits, label, name="softmax")


def test_rnn_dropout_draws_from_the_step_generator(smoke):
    """A stateful op (the RNN's dropout) in the fused step draws from the
    step's generator, as mxtpu's draws from the step's key: the fit
    engages and trains, and with lr 0 two steps on one batch differ only
    by their dropout masks."""
    n, t, i, h = 8, 5, 3, 16
    rng = np.random.RandomState(0)
    x = rng.standard_normal((4 * n, t, i)).astype(np.float32)
    y = rng.randint(0, 4, (4 * n, t)).astype(np.float32)
    np.random.seed(7)
    mt.random.seed(7)
    it = mt.io.NDArrayIter(x, y, n, label_name="softmax_label")
    mod = mt.mod.Module(_rnn_symbol(mt, n, h), context=mt.cpu())
    mod.fit(it, optimizer="sgd", optimizer_params={"learning_rate": 0.1},
            initializer=mt.init.Xavier(), num_epoch=2, eval_metric="acc")
    trainer = mod._fused
    assert trainer is not None
    assert trainer._group.stats["steps"] == 8
    assert trainer._group.stats["fallbacks"] == 0
    assert all(np.isfinite(v).all() for v in _params(mod).values())
    mod._optimizer.lr = 0.0
    before = _params(mod)
    batch = next(iter(it))
    outs = []
    for _ in range(2):
        mod.forward_backward(batch)
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy().copy())
    _assert_params(_params(mod), before, dict(rtol=0, atol=0))
    assert not np.array_equal(outs[0], outs[1])


# -- the functional optimizer --------------------------------------------------

@pytest.mark.parametrize("name,params", [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
             "rescale_grad": 0.5, "clip_gradient": 0.3}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-3}),
    ("adam", {"learning_rate": 0.02, "beta1": 0.8, "rescale_grad": 0.25,
              "clip_gradient": 0.5}),
])
def test_functional_step_matches_mxtpu(name, params):
    """functional_optimizer_step with t and lr as 0-dim tensors, five
    steps (t advancing as the fused step advances it), against mxtpu's
    functional_optimizer_step with jnp scalars and against the port's
    eager update."""
    import jax.numpy as jnp
    from mxtpu.optimizer import functional_optimizer_step as mx_step
    rng = np.random.RandomState(3)
    w0 = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32)
             for _ in range(5)]
    lr = params["learning_rate"]
    # port, functional
    opt = mt.optimizer.create(name, **params)
    w = torch.tensor(w0)
    state = mt.optimizer.state_to_tree(opt.create_state(0, mt.nd.array(w0, ctx=mt.cpu())))
    t = torch.tensor(0, dtype=torch.int32)
    lr_t = torch.tensor(lr, dtype=torch.float32)
    for g in grads:
        t.add_(1)
        mt.optimizer.functional_optimizer_step(opt, 0, w, torch.tensor(g),
                                               state, t, lr_t)
    assert opt.num_update == 0 and not opt._index_update_count
    # mxtpu, functional
    mopt = mx.optimizer.create(name, **params)
    mw = jnp.asarray(w0)
    mstate = mx.optimizer.state_to_tree(
        mopt.create_state(0, mx.nd.array(w0)))
    for i, g in enumerate(grads):
        mw, mstate = mx_step(mopt, 0, mw, jnp.asarray(g), mstate,
                             jnp.asarray(i + 1, jnp.int32),
                             jnp.asarray(lr, jnp.float32))
    # port, eager
    eopt = mt.optimizer.create(name, **params)
    upd = mt.optimizer.get_updater(eopt)
    ew = mt.nd.array(w0, ctx=mt.cpu())
    for g in grads:
        upd(0, mt.nd.array(g, ctx=mt.cpu()), ew)
    np.testing.assert_allclose(w.numpy(), np.asarray(mw), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(w.numpy(), ew.asnumpy(), **RATE_TOL)
