"""The rest of the port's Module layer (ROADMAP A18) against mxtpu's, on
the CPU: SequentialModule, PythonLossModule in upstream MXNet's
python_loss.py chain, Monitor (alone and through fit), get_states /
set_states, ProgressBar and LogValidationMetricsCallback, and
chip_smoke.py's mirrors of the three examples these open.

Weights are drawn once with numpy and given to both packages. Tolerance
1e-5 relative and absolute: float32 GEMMs of at most 784 products summed
in another order, over at most 40 SGD steps of small networks. Where
mxtpu's code stops (PythonLossModule.update_metric raises
NotImplementedError once the module takes labels; the executor group's
get_states returns an empty list an executor and set_states does
nothing), the port follows upstream MXNet and the test says so.
"""
import importlib.util
import logging
import pathlib

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", str(ROOT / "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _weights(shapes, seed=0, scale=0.3):
    rng = np.random.RandomState(seed)
    return {k: rng.uniform(-scale, scale, s).astype(np.float32)
            for k, s in sorted(shapes.items())}


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("op", ["log", "exp", "sqrt", "tanh", "sigmoid",
                                "abs", "square", "negative"])
def test_symbol_unary_ops_of_torch_builtins(op):
    """Symbols of the unary ops that torch implements as builtins (whose
    signature inspect cannot read): forward and gradient against mxtpu's
    (a fault found by the python_loss.py mirror: sym.log raised)."""
    x = np.linspace(0.2, 1.7, 6, dtype=np.float32).reshape(2, 3)
    out = {}
    for pkg in (mt, mx):
        y = getattr(pkg.sym, op)(pkg.sym.var("x") * 1.0)
        assert y.list_arguments() == ["x"]
        ex = y.simple_bind(pkg.cpu(), x=x.shape)
        ex.arg_dict["x"][:] = x
        fwd = ex.forward(is_train=True)[0].asnumpy()
        ex.backward(pkg.nd.array(np.ones_like(x), ctx=pkg.cpu()))
        out[pkg.__name__] = (fwd, ex.grad_dict["x"].asnumpy())
    for g, w in zip(out["mxtpu_torch"], out["mxtpu"]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


SEQ_SHAPES = {"feat_fc_weight": (32, 32), "feat_fc_bias": (32,),
              "head_fc_weight": (4, 32), "head_fc_bias": (4,)}


def test_sequential_module_fit_matches_mxtpu():
    """sequential_module.py's main (auto_wiring, take_labels, the
    backward chain through the second module's input gradients) from the
    same weights: the weights after its 4 epochs and its score."""
    w0 = _weights(SEQ_SHAPES)
    got_score, got = cs.sequential_main(mt, mt.cpu(), arg_params=w0)
    want_score, want = cs.sequential_main(mx, mx.cpu(), arg_params=w0)
    assert got_score == want_score
    g, w = _params(got), _params(want)
    assert sorted(g) == sorted(w) == sorted(SEQ_SHAPES)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)
    # the later module needs its inputs' gradients; the first does not
    first, second = got._modules
    assert not first.inputs_need_grad and second.inputs_need_grad
    assert first._fused is not None and second._fused is None
    assert got.data_names == ["data"] and got.output_names == \
        ["softmax_output"]
    assert got.get_states() == []


PL_SHAPES = {"fc1_weight": (128, 784), "fc1_bias": (128,),
             "fc2_weight": (64, 128), "fc2_bias": (64,),
             "fc3_weight": (10, 64), "fc3_bias": (10,)}


def test_python_loss_chain_matches_mxtpu():
    """Upstream python_loss.py's chain (Module + PythonLossModule with
    mc_hinge_grad, take_labels, auto_wiring) from the same weights: the
    MLP's weights after 8 steps. The loss module's update_metric feeds the
    metric its labels and scores, as upstream's does (mxtpu's raises
    NotImplementedError)."""
    w0 = _weights(PL_SHAPES, seed=1, scale=0.05)
    got, it = cs.python_loss_chain(mt, mt.cpu(), arg_params=w0, steps=8)
    want, _ = cs.python_loss_chain(mx, mx.cpu(), arg_params=w0, steps=8)
    g, w = _params(got), _params(want)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **TOL)
    loss = got._modules[1]
    assert loss.output_names == ["pyloss_output"]
    grads = loss.get_input_grads()[0]
    assert isinstance(grads, mt.nd.NDArray) and grads.context == mt.cpu()
    batch = it.next()
    got.forward(batch, is_train=True)
    metric = mt.metric.Accuracy()
    got.update_metric(metric, batch.label)
    scores = got.get_outputs()[0].asnumpy()
    # the digits' labels are class + a fraction; the metric truncates
    hits = (scores.argmax(1) ==
            batch.label[0].asnumpy().astype(np.int32)).sum()
    assert metric.get() == ("accuracy", hits / len(scores))
    want.forward(mx.io.DataBatch([mx.nd.array(batch.data[0].asnumpy())],
                                 [mx.nd.array(batch.label[0].asnumpy())]),
                 is_train=True)
    with pytest.raises(NotImplementedError):
        want.update_metric(mx.metric.Accuracy(),
                           [mx.nd.array(batch.label[0].asnumpy())])


def test_python_loss_chain_fit_learns_on_the_cpu():
    """The chain through fit (eval_metric "acc" read by the loss module's
    update_metric): 3 epochs over 1,000 digits learn them."""
    old = cs.PL_SAMPLES
    cs.PL_SAMPLES = 1000
    try:
        with mt.cpu():
            chain, train = cs.python_loss_chain(
                mt, mt.cpu(), arg_params=_weights(PL_SHAPES, 2, 0.05),
                num_epoch=3)
        acc = dict(chain.score(train, mt.metric.Accuracy()))["accuracy"]
    finally:
        cs.PL_SAMPLES = old
    assert acc > 0.9


def test_python_loss_example_main():
    """python_loss.py's main on the CPU meets its asserts; its numpy
    route (weights from RandomState(0)) gives mxtpu's losses."""
    with mt.cpu():
        got = cs.python_loss_main(mt, mt.cpu())
    want = cs.python_loss_main(mx, mx.cpu())
    assert got[0] < 0.4
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-5)


def _triples(seen):
    return sorted((n, k, float(v)) for n, k, v in seen)


def test_monitor_stats_match_mxtpu():
    """monitor_weights.py's main from the same weights: the same (step,
    name) pairs, the statistics within 1e-5 relative."""
    w0 = _weights({"fc_weight": (4, 8), "fc_bias": (4,)}, seed=3)
    got = _triples(cs.monitor_weights_main(mt, mt.cpu(), arg_params=w0))
    want = _triples(cs.monitor_weights_main(mx, mx.cpu(), arg_params=w0))
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                               rtol=1e-5)


def test_fit_with_monitor_logs_and_trains_as_mxtpu(caplog):
    """Module.fit(monitor=...): the monitor installed after bind, a
    window every `interval` batches logged by toc_print, the fused step
    stepping aside; weights after an epoch equal mxtpu's."""
    rng = np.random.RandomState(4)
    x = rng.rand(64, 8).astype(np.float32)
    y = rng.randint(0, 4, 64).astype(np.float32)
    w0 = _weights({"fc_weight": (4, 8), "fc_bias": (4,)}, seed=5)
    out, logs = {}, {}
    for pkg in (mt, mx):
        sym = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            pkg.sym.var("data"), num_hidden=4, name="fc"), name="softmax")
        mod = pkg.mod.Module(sym, context=pkg.cpu())
        it = pkg.io.NDArrayIter(x, y, batch_size=16)
        mon = pkg.monitor.Monitor(2, pattern="fc.*", sort=True)
        caplog.clear()
        with caplog.at_level(logging.INFO):
            mod.fit(it, num_epoch=1, monitor=mon,
                    arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                for k, v in w0.items()},
                    optimizer_params={"learning_rate": 0.1})
        logs[pkg.__name__] = [r.getMessage().split()[:3] for r in
                              caplog.records
                              if r.getMessage().startswith("Batch:")]
        out[pkg.__name__] = _params(mod)
        if pkg is mt:
            assert mod._fused is None
    assert logs["mxtpu_torch"] == logs["mxtpu"]
    assert [m[2] for m in logs["mxtpu"]] == \
        ["fc_bias", "fc_weight"] * 2
    for k in w0:
        np.testing.assert_allclose(out["mxtpu_torch"][k], out["mxtpu"][k],
                                   **TOL)


def test_states_of_a_module_with_state_inputs():
    """get_states / set_states on a Module with state_names (upstream
    MXNet's semantics): one list of arrays a state; set_states by value
    or by arrays feeds the forward, which equals mxtpu's executor fed the
    same state. BaseModule.get_states is empty."""
    x = np.arange(6, dtype=np.float32).reshape(2, 3) / 6
    w0 = _weights({"fc_weight": (2, 3), "fc_bias": (2,)}, seed=6)
    outs = {}
    for pkg in (mt, mx):
        sym = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=2,
                                     name="fc") + pkg.sym.var("state",
                                                              shape=(2, 2))
        mod = pkg.mod.Module(sym, data_names=("data",), label_names=None,
                             state_names=("state",), context=pkg.cpu())
        mod.bind([("data", (2, 3))], for_training=False)
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                    for k, v in w0.items()})
        batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())])
        if pkg is mt:
            mod.set_states(value=0.5)
            (states,) = mod.get_states(merge_multi_context=False)
            np.testing.assert_array_equal(states[0].asnumpy(),
                                          np.full((2, 2), 0.5))
            mod.forward(batch, is_train=False)
            by_value = mod.get_outputs()[0].asnumpy()
            mod.set_states(states=[[mt.nd.array(np.full((2, 2), 0.5),
                                                ctx=mt.cpu())]])
            with pytest.raises(ValueError):
                mod.get_states()
            with pytest.raises(ValueError):
                mod.set_states()
        else:
            assert mod.get_states(merge_multi_context=False) == [[]]
            mod._exec_group.execs[0].arg_dict["state"][:] = 0.5
        mod.forward(batch, is_train=False)
        outs[pkg.__name__] = mod.get_outputs()[0].asnumpy()
    np.testing.assert_allclose(outs["mxtpu_torch"], outs["mxtpu"], **TOL)
    np.testing.assert_allclose(by_value, outs["mxtpu"], **TOL)


def test_progress_bar_and_validation_log_match_mxtpu(capsys, caplog):
    metric = {}
    for pkg in (mt, mx):
        m = pkg.metric.Accuracy()
        m.update([pkg.nd.array([0, 1, 1, 0], ctx=pkg.cpu())],
                 [pkg.nd.array(np.eye(2)[[0, 1, 0, 0]], ctx=pkg.cpu())])
        metric[pkg.__name__] = m
    out = {}
    for pkg in (mt, mx):
        capsys.readouterr()
        caplog.clear()
        param = pkg.model.BatchEndParam(epoch=2, nbatch=7,
                                        eval_metric=metric[pkg.__name__],
                                        locals=None)
        pkg.callback.ProgressBar(total=20, length=30)(param)
        with caplog.at_level(logging.INFO):
            pkg.callback.LogValidationMetricsCallback()(param)
        out[pkg.__name__] = (capsys.readouterr().out,
                             [r.getMessage() for r in caplog.records])
    assert out["mxtpu_torch"] == out["mxtpu"]
    assert out["mxtpu"][1] == ["Epoch[2] Validation-accuracy=0.750000"]
