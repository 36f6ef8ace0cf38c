"""MXTPU_AMP=bf16 in the port's fused Module step (mxtpu_torch/module/fused.py,
Executor.make_fused_train_step) on the CPU, against its own float32 step
and against mxtpu's AMP step from the same weights.

The local cases of tests/test_module_amp.py on the port: the parity band
of a bf16 fit against the float32 fit (sgd, adam: mxtpu's _BANDS), float32
masters and optimizer states, the checkpoint round trip, the loss-scale
overflow skip (every tensor the step writes bitwise unchanged, no host
read inside the step), BatchNorm's statistics in float32, the ineligible
module's one log line and an unknown mode; and one case of the port's
own: an Embedding's token ids stay float32 under AMP (mxtpu casts them to
bfloat16, which rounds an id above 256 to another row). Then the port
against mxtpu:

- the first step of the MLP and the BN MLP (SGD, lr 1: the step is the
  gradient): each parameter's step within FIRST_ULPS units of bfloat16's
  roundoff U = 2^-8 of the largest step entry of its layer. The two
  packages round to bfloat16 at the same ops (a matmul accumulates in
  float32 and rounds once; BatchNorm computes in float32), but XLA fuses
  elementwise chains and keeps float32 between them where PyTorch rounds
  after each op. A bias's gradient is a sum over the batch that cancels
  (fc1's before BatchNorm is rounding alone: BatchNorm takes out its
  mean), so it is held on its layer's scale. Readings: 0.36-1.42 U.
- three steps (SGD, momentum 0.9, lr 0.1): the weights within
  STEPS_SHARE of how far mxtpu's run moved them (norms over all weights;
  readings 0.16-0.20%).
- a two-bucket LSTM LM through the RNN op: the port's plain loop
  (float32 carry, bfloat16 outputs) against mxtpu's Pallas kernel in
  interpret mode, which rounds where the kernel does (mxtpu's CPU scan
  would promote to float32 at the float32 zero state): the weights after
  an epoch within FIT_SHARE of the move (reading 0.74%), the perplexity
  within PPL_RTOL (reading 6e-4).
- the first AMP step of a ResNet-8 (chip_smoke's resnet_symbol at
  3x16x16, batch 8, random weights, SGD) against the float32 step from
  the same weights, in each package: its size within chip_smoke's
  AMP_MOVE_TOL of float32's, and its direction no more than
  AMP_DIR_SPREAD times as far off float32's as the float32 step taken
  from weights bfloat16's rounding (U/2) apart is (at random
  initialisation much of the step is noise at that scale): the bands
  chip_smoke holds ResNet-50's first step to on the card. A half-size
  step falls outside them.
- MXTPU_AMP_LOSS_SCALE keeps the step: a power-of-two loss scale is
  exact in bfloat16, so the loss-scaled AMP steps equal the unscaled
  ones bitwise for every loss head (SoftmaxOutput, the regression
  outputs, SVMOutput and MakeLoss ignore their head gradient and take
  the scale themselves). mxtpu scales only the head cotangent, which
  these heads drop, so its steps under a scale S come out S times
  smaller (a documented difference).
- train_imagenet.py --dtype float16's ResNet (Cast in, Cast out): the
  port infers float16 for the convolutions' and FullyConnected's weights
  through the Cast, and float32 for BatchNorm's, as MXNet's InferType
  does; mxtpu's infer_type gives float32 to every weight, and its
  simple_bind then fails (its convolution refuses float16 data with
  float32 weights). The port's multi-precision SGD keeps a float32 master
  a float16 weight, the weight its master rounded, fused and eager.
"""
import logging

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu_torch import fault
from mxtpu_torch.module import fused as mt_fused
from mxtpu_torch.optimizer import state_to_tree
from test_torch_optimizer import NoHostRead
from torch_threads import torch_threads_shared  # noqa: F401

U = 2.0 ** -8
FIRST_ULPS = 4
STEPS_SHARE = 0.01
FIT_SHARE = 0.03
PPL_RTOL = 3e-3
# mxtpu's own bands of a bf16 fit against the float32 fit
_BANDS = {"sgd": dict(rtol=0.1, atol=0.02),
          "adam": dict(rtol=0.25, atol=0.06)}


@pytest.fixture(autouse=True)
def own_names():
    """Each case names its blocks and symbols in scopes of its own and
    leaves both packages' name counters as it found them: later files
    build the same nets in both packages and compare the names."""
    import mxtpu.gluon.block as mx_block
    import mxtpu_torch.gluon.block as mt_block
    saved = [(d, dict(d)) for d in (mx_block._NAME_COUNTERS,
                                    mt_block._NAME_COUNTERS)]
    with mx.name.NameManager(), mt.name.NameManager():
        yield
    for counters, old in saved:
        counters.clear()
        counters.update(old)


@pytest.fixture(autouse=True)
def env(monkeypatch):
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "1")
    monkeypatch.delenv("MXTPU_AMP_LOSS_SCALE", raising=False)
    monkeypatch.delenv("MXTPU_METRIC_READBACK", raising=False)
    fault.uninstall()
    yield
    fault.uninstall()


def _toy_problem(n=192, seed=5, classes=4):
    r = np.random.RandomState(seed)
    y = (r.rand(n) * classes).astype("f")
    x = r.rand(n, 16).astype("f") * 0.1
    for i in range(n):
        x[i, int(y[i]) * 4:int(y[i]) * 4 + 4] += 1.0
    return x, y


def _mlp(pkg, bn=False, classes=4):
    data = pkg.sym.var("data")
    net = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    if bn:
        net = pkg.sym.BatchNorm(net, name="bn1", fix_gamma=False)
    net = pkg.sym.Activation(net, act_type="relu", name="relu1")
    net = pkg.sym.FullyConnected(net, num_hidden=classes, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def _weights(bn=False, seed=1):
    r = np.random.RandomState(seed)
    w = {"fc1_weight": r.uniform(-0.3, 0.3, (16, 16)),
         "fc1_bias": r.uniform(-0.1, 0.1, 16),
         "fc2_weight": r.uniform(-0.3, 0.3, (4, 16)),
         "fc2_bias": np.zeros(4)}
    if bn:
        w.update(bn1_gamma=r.uniform(0.8, 1.2, 16),
                 bn1_beta=r.uniform(-0.1, 0.1, 16))
    return {k: v.astype(np.float32) for k, v in w.items()}


def _fit(pkg, monkeypatch, amp, optimizer="sgd", opt_params=None,
         epochs=3, bn=False, weights=None):
    """One Module.fit; returns (module, {name: numpy})."""
    monkeypatch.setenv("MXTPU_AMP", amp)
    np.random.seed(7)
    pkg.random.seed(7)
    x, y = _toy_problem()
    it = pkg.io.NDArrayIter(x, y, batch_size=32, shuffle=True,
                            label_name="softmax_label")
    mod = pkg.mod.Module(_mlp(pkg, bn), context=pkg.cpu())
    kw = {}
    if weights is not None:
        kw["arg_params"] = {k: pkg.nd.array(v, ctx=pkg.cpu())
                            for k, v in weights.items()}
    mod.fit(it, optimizer=optimizer,
            optimizer_params=opt_params or {"learning_rate": 0.1,
                                            "momentum": 0.9},
            num_epoch=epochs, eval_metric="acc", **kw)
    args, _ = mod.get_params()
    return mod, {k: v.asnumpy().copy() for k, v in args.items()}


def _tree_leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tree_leaves(x)]
    return []


# -- tests/test_module_amp.py's local cases on the port ------------------------

@pytest.mark.parametrize("optimizer,opt_params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}),
    ("adam", {"learning_rate": 0.01}),
])
def test_amp_local_parity_band(monkeypatch, optimizer, opt_params):
    """The bf16 fused fit lands in the float32 fused fit's neighbourhood,
    with float32 masters and optimizer states in the store throughout."""
    with mt.cpu():
        mod, bf16 = _fit(mt, monkeypatch, "bf16", optimizer,
                         dict(opt_params))
        fs = mod._fused._group
        assert fs.amp == "bf16" and fs.compute_dtype == torch.bfloat16
        for name, arr in fs.param_store.items():
            assert arr._data.dtype == torch.float32, name
        for slot, st in fs.updater.states.items():
            for leaf in _tree_leaves(state_to_tree(st)):
                assert leaf.dtype == torch.float32, slot
        mod32, f32 = _fit(mt, monkeypatch, "", optimizer, dict(opt_params))
        assert mod32._fused._group.amp is None
    for k in bf16:
        assert np.isfinite(bf16[k]).all(), k
        np.testing.assert_allclose(bf16[k], f32[k], err_msg=k,
                                   **_BANDS[optimizer])


def test_amp_master_weight_checkpoint_roundtrip(monkeypatch, tmp_path):
    """save_checkpoint writes the float32 masters; a load continues AMP
    training fused."""
    with mt.cpu():
        mod, params = _fit(mt, monkeypatch, "bf16", "adam",
                           {"learning_rate": 0.01})
        prefix = str(tmp_path / "amp")
        mod.save_checkpoint(prefix, 1, save_optimizer_states=True)
        loaded = mt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                    context=mt.cpu())
        x, y = _toy_problem()
        it = mt.io.NDArrayIter(x, y, batch_size=32,
                               label_name="softmax_label")
        loaded.bind(it.provide_data, it.provide_label)
        loaded.init_optimizer(optimizer="adam",
                              optimizer_params={"learning_rate": 0.01})
        args, _ = loaded.get_params()
        for k, v in args.items():
            assert v.data.dtype == torch.float32, k
            np.testing.assert_array_equal(v.asnumpy(), params[k], err_msg=k)
        assert loaded._fused is not None and \
            loaded._fused._group.amp == "bf16"
        batch = mt.io.DataBatch([mt.nd.array(x[:32])],
                                [mt.nd.array(y[:32])])
        loaded.forward_backward(batch)
        loaded.update()
        args2, _ = loaded.get_params()
    assert any(not np.array_equal(args2[k].asnumpy(), params[k])
               for k in params)


@pytest.mark.parametrize("bn", [False, True], ids=["mlp", "bn_mlp"])
def test_amp_loss_scale_overflow_skip_nan_grad_fault_row(monkeypatch, bn):
    """kind=nan_grad at module.step under MXTPU_AMP_LOSS_SCALE: the
    poisoned step leaves every tensor the step writes (weights, states,
    aux, t, the metric) bitwise as it was, with no host read inside the
    step; amp_overflow_skips() counts it; the next good batch trains."""
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setenv("MXTPU_AMP_LOSS_SCALE", "1024")
    calls = []
    real_call = mt_fused._Step.call

    def guarded(self):
        calls.append(self)
        with NoHostRead(strict=len(calls) > 2):
            return real_call(self)
    monkeypatch.setattr(mt_fused._Step, "call", guarded)
    with mt.cpu():
        x, y = _toy_problem()
        it = mt.io.NDArrayIter(x, y, batch_size=32,
                               label_name="softmax_label")
        mod = mt.mod.Module(_mlp(mt, bn), context=mt.cpu())
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(mt.initializer.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9})
        fs = mod._fused._group
        assert fs.loss_scale == 1024.0
        metric = mt.metric.create("acc")
        batches = list(it)

        def step(b):
            mod.forward_backward(b)
            mod.update()
            mod.update_metric(metric, b.label)

        def snap():
            out = {"w:" + k: a._data.clone()
                   for k, a in fs.param_store.items()}
            out.update(("a:" + k, a._data.clone())
                       for k, a in fs.aux_store.items())
            for slot, st in fs.states.items():
                out.update(("s:%d:%d" % (slot, i), t.clone())
                           for i, t in enumerate(
                               _tree_leaves(state_to_tree(st))))
            out["t"] = fs.t_dev.clone()
            out["metric"] = fs.metric_acc.clone()
            return out
        with fault.inject("kind=nan_grad,point=module.step,nth=4") as inj:
            for b in batches[:3]:
                step(b)
            before = snap()
            step(batches[0])                       # step 4: poisoned
            assert inj.stats()[0][4] == 1, "the nan_grad never fired"
        after = snap()
        assert sorted(after) == sorted(before)
        for k in before:
            assert torch.equal(before[k], after[k]), k
        assert fs.amp_overflow_skips() == 1
        step(batches[1])
        resumed = snap()
    assert any(not torch.equal(after[k], resumed[k]) for k in after
               if k.startswith("w:"))
    for k, v in resumed.items():
        assert torch.isfinite(v.float()).all(), k
    assert len(calls) == 5


def test_amp_bn_running_stats_stay_fp32(monkeypatch):
    """BatchNorm's moving statistics stay float32 in the store and move
    inside the step, with bfloat16 gamma and beta in the graph."""
    with mt.cpu():
        mod, _ = _fit(mt, monkeypatch, "bf16", bn=True)
        fs = mod._fused._group
        assert fs.amp == "bf16"
        exec_ = mod._exec_group.execs[0]
        for name, arr in exec_.aux_dict.items():
            assert arr._data.dtype == torch.float32, name
            host = arr.asnumpy()
            assert np.isfinite(host).all(), name
            if name.endswith("moving_mean"):
                assert not np.array_equal(host, np.zeros(16, np.float32))
        for name in ("bn1_gamma", "bn1_beta"):
            assert exec_.arg_dict[name]._data.dtype == torch.float32


def test_amp_ineligible_params_log_once_keep_fp32_fused(monkeypatch,
                                                        caplog):
    """A float16 parameter: AMP stays off with one named debug line, and
    the float32 fused step still engages."""
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    with mt.cpu():
        x, y = _toy_problem()
        it = mt.io.NDArrayIter(x, y, batch_size=32,
                               label_name="softmax_label")
        mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(mt.initializer.Xavier())
        exec_ = mod._exec_group.execs[0]
        exec_.arg_dict["fc1_weight"]._data = \
            exec_.arg_dict["fc1_weight"]._data.to(torch.float16)
        with caplog.at_level(logging.DEBUG):
            mod.init_optimizer(optimizer="sgd",
                               optimizer_params={"learning_rate": 0.05})
    assert mod._fused is not None
    assert mod._fused._group.amp is None
    msgs = [r.message for r in caplog.records
            if "AMP mode not engaged" in r.message]
    assert len(msgs) == 1, msgs
    assert "fc1_weight" in msgs[0] and "float16" in msgs[0]


def test_amp_rejects_unknown_mode(monkeypatch):
    monkeypatch.setenv("MXTPU_AMP", "fp8")
    with pytest.raises(ValueError, match="MXTPU_AMP"):
        mt_fused.amp_mode()


@pytest.mark.parametrize("value,want", [("", None), ("off", None),
                                        ("0", None), ("bf16", "bf16"),
                                        ("BFloat16", "bf16")])
def test_amp_mode_words(monkeypatch, value, want):
    monkeypatch.setenv("MXTPU_AMP", value)
    assert mt_fused.amp_mode() == want


def test_amp_eager_path_stays_float32(monkeypatch):
    """With the fused step off, MXTPU_AMP changes nothing: the eager step
    is float32, bitwise the run without it."""
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "0")
    with mt.cpu():
        mod, amp = _fit(mt, monkeypatch, "bf16", epochs=1,
                        weights=_weights())
        assert mod._fused is None
        _, plain = _fit(mt, monkeypatch, "", epochs=1, weights=_weights())
    for k in plain:
        np.testing.assert_array_equal(amp[k], plain[k], err_msg=k)


# -- against mxtpu from the same weights ---------------------------------------

def _first_steps(pkg, monkeypatch, bn, steps, opt_params):
    """``steps`` AMP fused steps over the unshuffled batches from
    _weights(bn): {name: numpy}."""
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    x, y = _toy_problem()
    it = pkg.io.NDArrayIter(x, y, batch_size=32, label_name="softmax_label")
    mod = pkg.mod.Module(_mlp(pkg, bn), context=pkg.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in _weights(bn).items()},
                    allow_missing=True)
    mod.init_optimizer(optimizer="sgd", optimizer_params=opt_params)
    assert mod._fused._group.amp == "bf16"
    for _, b in zip(range(steps), it):
        mod.forward_backward(b)
        mod.update()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("bn", [False, True], ids=["mlp", "bn_mlp"])
def test_amp_first_step_matches_mxtpu(monkeypatch, bn):
    w0 = _weights(bn)
    with mt.cpu():
        got = _first_steps(mt, monkeypatch, bn, 1, {"learning_rate": 1.0})
    want = _first_steps(mx, monkeypatch, bn, 1, {"learning_rate": 1.0})
    for k in w0:
        layer = k.split("_")[0]
        scale = max(np.abs(want[n] - w0[n]).max() for n in w0
                    if n.split("_")[0] == layer)
        err = np.abs(got[k] - want[k]).max()
        assert err <= FIRST_ULPS * U * scale, (k, err / (U * scale))


@pytest.mark.parametrize("bn", [False, True], ids=["mlp", "bn_mlp"])
def test_amp_first_steps_match_mxtpu(monkeypatch, bn):
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    w0 = _weights(bn)
    with mt.cpu():
        got = _first_steps(mt, monkeypatch, bn, 3, opt)
    want = _first_steps(mx, monkeypatch, bn, 3, opt)
    apart = sum(float(np.square(got[k] - want[k]).sum()) for k in w0)
    moved = sum(float(np.square(want[k] - w0[k]).sum()) for k in w0)
    assert (apart / moved) ** 0.5 <= STEPS_SHARE, (apart / moved) ** 0.5


def _lm_fit(pkg, sentences, weights=None):
    """chip_smoke's lstm_bucketing_fit at vocabulary 16, hidden 8, batch
    8, buckets 4/8, one epoch of SGD."""
    import chip_smoke
    return chip_smoke.lstm_bucketing_fit(
        pkg, sentences, 16, True, num_epoch=1, num_hidden=8, num_embed=8,
        num_layers=2, batch_size=8, buckets=(4, 8), lr=0.1,
        arg_params=weights, optimizer="sgd")


def test_amp_bucketed_lm_matches_mxtpu(monkeypatch):
    """Two buckets of the LSTM LM through the RNN op under AMP: the port's
    plain loop (lstm_scan on a CPU tensor) against mxtpu's Pallas kernel
    in interpret mode, from the same weights; each bucket's fused step
    engages AMP."""
    import sys
    sys.path.insert(0, __import__("os").path.dirname(
        __import__("os").path.dirname(__file__)))
    import chip_smoke
    from mxtpu.ops import rnn as mx_rnn
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setattr(mx_rnn, "USE_PALLAS_RNN", True)
    sentences, _ = chip_smoke.synthetic_corpus(n=64, vocab=16)
    corpus = [s[:4] if len(s) <= 16 else s[:8] for s in sentences]
    with mt.cpu():
        init, _it, _p = _lm_fit(mt, corpus)
    w0 = {k: v.asnumpy() for k, v in init.get_params()[0].items()}
    with mt.cpu():
        got_mod, _it, got_ppl = _lm_fit(mt, corpus, w0)
    want_mod, _it, want_ppl = _lm_fit(mx, corpus, w0)
    for key, sub in got_mod._buckets.items():
        assert sub._fused is not None and sub._fused._group.amp == "bf16"
    got = {k: v.asnumpy() for k, v in got_mod.get_params()[0].items()}
    want = {k: v.asnumpy() for k, v in want_mod.get_params()[0].items()}
    apart = sum(float(np.square(got[k] - want[k]).sum()) for k in w0)
    moved = sum(float(np.square(want[k] - w0[k]).sum()) for k in w0)
    assert (apart / moved) ** 0.5 <= FIT_SHARE, (apart / moved) ** 0.5
    np.testing.assert_allclose(got_ppl, want_ppl, rtol=PPL_RTOL)


def _f16_resnet(pkg):
    import chip_smoke
    return chip_smoke.resnet_symbol(pkg, 20, "3,28,28", 10, dtype="float16")


def test_float16_resnet_types_and_masters(monkeypatch):
    """--dtype float16's ResNet: the port's inferred types against MXNet's
    rule and mxtpu's; multi-precision SGD's float32 masters, fused and
    eager."""
    import chip_smoke
    monkeypatch.delenv("MXTPU_AMP", raising=False)
    port = _f16_resnet(mt)
    arg_t, out_t, aux_t = port.infer_type(data="float16")
    names = port.list_arguments()
    for n, t in zip(names, arg_t):
        if n == "data":
            assert t == np.float16
        elif n.startswith(("bn", "stage")) and \
                n.endswith(("_gamma", "_beta")):
            assert t == np.float32, (n, t)
        elif n.endswith(("_weight", "_bias")):
            assert t == np.float16, (n, t)
        else:                                   # the label, after the Cast
            assert t == np.float32, (n, t)
    assert all(t == np.float32 for t in aux_t)
    assert out_t == [np.float32]
    ref_t, _, _ = _f16_resnet(mx).infer_type(data="float16")
    assert [str(t) for t in ref_t] == \
        ["float16" if n == "data" else "float32" for n in names]
    with pytest.raises(TypeError, match="same dtypes"):
        _f16_resnet(mx).simple_bind(mx.cpu(), data=(2, 3, 28, 28))
    for fused in ("1", "0"):
        monkeypatch.setenv("MXTPU_MODULE_FUSED", fused)
        with mt.cpu():
            np.random.seed(0)
            mt.random.seed(0)
            train = chip_smoke.synthetic_data_iter(
                mt, 10, (4, 3, 28, 28), 3, dtype="float16")
            mod = chip_smoke.fit_call(
                mt, _f16_resnet(mt), train, None, "local", 1, 0.1, None,
                0.9, 1e-4, 4, 20, context=mt.cpu())
        assert (mod._fused is not None) == (fused == "1")
        exec_ = mod._exec_group.execs[0]
        states = mod._updater.states
        halves = 0
        for i, name in enumerate(mod._exec_group.param_names):
            w = exec_.arg_dict[name]._data
            want_t = dict(zip(names, arg_t))[name]
            assert w.dtype == (torch.float16 if want_t == np.float16
                               else torch.float32), name
            if w.dtype == torch.float16:
                master = states[i][0]._data
                assert master.dtype == torch.float32
                assert torch.equal(master.half(), w), name
                assert torch.isfinite(master).all()
                halves += 1
        assert halves == sum(t == np.float16 for n, t in zip(names, arg_t)
                             if n != "data") > 0


def test_amp_keeps_token_ids_exact(monkeypatch):
    """An Embedding's token ids stay float32 under AMP: bfloat16 holds
    integers exactly only up to 256, and a rounded id would look up
    another row (mxtpu casts them). One SGD step moves exactly the rows
    of the batch's ids."""
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    ids = np.array([[999, 513, 257], [3, 600, 999]], np.float32)
    with mt.cpu():
        data = mt.sym.var("data")
        net = mt.sym.Embedding(data, input_dim=1000, output_dim=4,
                               name="embed")
        net = mt.sym.FullyConnected(mt.sym.Flatten(net, name="flat"),
                                    num_hidden=3, name="fc")
        sym = mt.sym.SoftmaxOutput(net, name="softmax")
        mod = mt.mod.Module(sym, context=mt.cpu())
        mod.bind([("data", ids.shape)], [("softmax_label", (2,))])
        mod.init_params(mt.init.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 1.0})
        assert mod._fused._group.amp == "bf16"
        before = mod.get_params()[0]["embed_weight"].asnumpy()
        mod.forward_backward(mt.io.DataBatch(
            [mt.nd.array(ids)], [mt.nd.array(np.array([0, 2], "f"))]))
        mod.update()
        after = mod.get_params()[0]["embed_weight"].asnumpy()
    moved = np.nonzero(np.abs(after - before).sum(1))[0]
    assert sorted(moved) == sorted(set(ids.astype(int).ravel()))


def _head(pkg, kind, classes=4):
    """The MLP of ``_mlp`` with another loss head."""
    data = pkg.sym.var("data")
    net = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu", name="relu1")
    net = pkg.sym.FullyConnected(net, num_hidden=classes, name="fc2")
    label = pkg.sym.var("softmax_label")
    if kind == "regression":
        return pkg.sym.LinearRegressionOutput(
            net, pkg.sym.one_hot(label, depth=classes), name="softmax")
    if kind == "svm":
        return pkg.sym.SVMOutput(net, label, name="softmax")
    if kind == "make_loss":
        return pkg.sym.MakeLoss(pkg.sym.mean(pkg.sym.square(net)),
                                name="softmax")
    return pkg.sym.SoftmaxOutput(net, label, name="softmax")


def _scaled_steps(pkg, monkeypatch, kind, scale, steps=3):
    """``steps`` AMP fused SGD steps of ``_head(kind)`` from _weights()
    under MXTPU_AMP_LOSS_SCALE=``scale``: {name: numpy}."""
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setenv("MXTPU_AMP_LOSS_SCALE", str(scale))
    x, y = _toy_problem()
    it = pkg.io.NDArrayIter(x, y, batch_size=32, label_name="softmax_label")
    mod = pkg.mod.Module(_head(pkg, kind), context=pkg.cpu(),
                         label_names=() if kind == "make_loss"
                         else ("softmax_label",))
    mod.bind(it.provide_data, it.provide_label if kind != "make_loss"
             else None)
    mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in _weights().items()},
                    allow_missing=True)
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    assert mod._fused._group.amp == "bf16"
    for _, b in zip(range(steps), it):
        mod.forward_backward(b)
        mod.update()
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("kind", ["softmax", "regression", "svm",
                                  "make_loss"])
def test_amp_loss_scale_keeps_the_step(monkeypatch, kind):
    with mt.cpu():
        plain = _scaled_steps(mt, monkeypatch, kind, 0)
        scaled = _scaled_steps(mt, monkeypatch, kind, 1024)
    w0 = _weights()
    assert all(not np.array_equal(plain[k], w0[k]) for k in w0)
    for k in plain:
        np.testing.assert_array_equal(scaled[k], plain[k], err_msg=k)


def test_mxtpu_loss_scale_shrinks_a_softmax_step(monkeypatch):
    """The documented difference: mxtpu's SoftmaxOutput drops the scaled
    head cotangent, and the unscaling divides its first step by S (its
    norm within 1% of 1/S of the unscaled step's: the weights round the
    small step to float32)."""
    import chip_smoke
    w0 = _weights()
    plain = _scaled_steps(mx, monkeypatch, "softmax", 0, steps=1)
    scaled = _scaled_steps(mx, monkeypatch, "softmax", 1024, steps=1)
    ratio, cos = chip_smoke.step_size_and_cosine(scaled, plain, w0)
    assert abs(ratio * 1024 - 1) <= 0.01 and cos >= 0.99, (ratio, cos)


def _resnet_first_step(pkg, monkeypatch, amp, args, aux):
    """The first fused SGD step of chip_smoke's ResNet-8 (3x16x16, 10
    classes, batch 8; train_imagenet.py's fit call) from the given
    weights: {name: numpy}."""
    import chip_smoke
    monkeypatch.setenv("MXTPU_AMP", "bf16" if amp else "")
    first = chip_smoke.FirstStepWeights()
    with pkg.cpu():
        np.random.seed(0)
        pkg.random.seed(0)
        chip_smoke.imagenet_fit(
            pkg, chip_smoke.resnet_symbol(pkg, 8, "3,16,16", 10), 8, 8,
            1, "3,16,16", 10, context=pkg.cpu(), kvstore="local",
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in args.items()},
            aux_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in aux.items()},
            batch_end_callback=[first])
    return first.w


def test_amp_first_resnet_step_size_and_direction(monkeypatch):
    import chip_smoke
    with mt.cpu():
        np.random.seed(0)
        mt.random.seed(0)
        init, _ = chip_smoke.imagenet_fit(
            mt, chip_smoke.resnet_symbol(mt, 8, "3,16,16", 10), 8, 8, 0,
            "3,16,16", 10, context=mt.cpu(), kvstore="local")
    args, aux = (chip_smoke.module_params(init),
                 chip_smoke.module_aux(init))
    apart = chip_smoke.bf16_apart(args, 0)
    ref = _resnet_first_step(mt, monkeypatch, False, apart, aux)
    spread = None
    for pkg in (mt, mx):
        f32 = _resnet_first_step(pkg, monkeypatch, False, args, aux)
        amp = _resnet_first_step(pkg, monkeypatch, True, args, aux)
        if spread is None:
            spread = chip_smoke.noise_to_signal(chip_smoke.step_size_and_cosine(
                ref, f32, args, got_start=apart)[1])
        ratio, cos = chip_smoke.step_size_and_cosine(amp, f32, args)
        assert abs(ratio - 1) <= chip_smoke.AMP_MOVE_TOL, (pkg, ratio)
        assert chip_smoke.noise_to_signal(cos) <= \
            chip_smoke.AMP_DIR_SPREAD * spread, (pkg, cos, spread)
        half = {k: (args[k] + v) / 2 for k, v in amp.items()}
        ratio = chip_smoke.step_size_and_cosine(half, f32, args)[0]
        assert not abs(ratio - 1) <= chip_smoke.AMP_MOVE_TOL, ratio
