"""The custom-op slice as a whole, at full width: the MLP of
example/numpy-ops/custom_softmax.py (784 -> 128 relu -> 10, batch 128)
with its softmax-with-loss head as a custom op.

mxtpu runs the example's own numpy op (registered by loading the
example); the port runs the head that chip_smoke.py trains on the card
(cs_* there), on its CPU route, where the op calls the plain versions of
its two CUDA C kernels. From the same weights and batches: the outputs
and the FC gradients agree within 1e-5 (f32 GEMMs of 784 and 128 terms
summed in another order), 3 momentum-SGD steps leave weights within 1e-5
of mxtpu's SGD, the port's InferenceEngine on cpu() answers as
eval_graph does, and 64 steps reach the example's train accuracy.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    mod = _load("chip_smoke", ROOT / "chip_smoke.py")
    mod.cs_register(mt)
    return mod


@pytest.fixture(scope="module")
def example():
    # registers the example's numpy op as op_type "softmax" in mxtpu
    return _load("custom_softmax",
                 ROOT / "example" / "numpy-ops" / "custom_softmax.py")


@pytest.fixture(scope="module")
def data(smoke):
    return smoke.cs_data()


def _mxtpu_step(sym, params, x, y):
    """Forward (training) and backward of the example's net in mxtpu;
    returns (output, grads) as numpy."""
    exe = sym.simple_bind(mx.cpu(), data=x.shape, softmax_label=y.shape)
    for k, v in params.items():
        exe.arg_dict[k][:] = v
    out = exe.forward(is_train=True, data=mx.nd.array(x),
                      softmax_label=mx.nd.array(y))[0].asnumpy()
    exe.backward()
    return out, {k: exe.grad_dict[k].asnumpy() for k in params}


def test_data_and_symbol_match_the_example(smoke, example, data):
    x, y = data
    assert x.shape == (2048, 784) and x.dtype == np.float32
    assert y.shape == (2048,) and set(np.unique(y)) == set(range(10))
    sym, jsym = smoke.cs_symbol(mt), smoke.cs_symbol(mx)
    assert sym.list_arguments() == jsym.list_arguments()
    assert sym.infer_shape(data=(128, 784), softmax_label=(128,)) == \
        jsym.infer_shape(data=(128, 784), softmax_label=(128,))
    # the port's hint also infers the label from the data alone
    args, outs, _ = sym.infer_shape(data=(128, 784))
    assert dict(zip(sym.list_arguments(), args))["softmax_label"] == (128,)
    assert outs == [(128, 10)]


def test_head_plain_versions_match_the_numpy_op(smoke, example):
    rng = np.random.RandomState(3)
    x = (rng.randn(128, 10) * 3).astype(np.float32)
    label = rng.randint(0, 10, 128).astype(np.float32)
    op = example.Softmax()
    out = [mx.nd.zeros((128, 10))]
    op.forward(True, ["write"], [mx.nd.array(x)], out, [])
    y = smoke.cs_softmax_fwd_plain(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), out[0].asnumpy(), rtol=1e-6,
                               atol=1e-7)
    grad = [mx.nd.zeros((128, 10))]
    op.backward(["write"], [], [mx.nd.array(x), mx.nd.array(label)], out,
                grad, [])
    dx = smoke.cs_softmax_bwd_plain(torch.tensor(out[0].asnumpy()),
                                    torch.from_numpy(label))
    np.testing.assert_array_equal(dx.numpy(), grad[0].asnumpy())


def test_outputs_and_gradients_match_mxtpu(smoke, example, data):
    x_all, y_all = data
    params = smoke.cs_init_params(0)
    idx = smoke.cs_batches(0)[0]
    x, y = x_all[idx], y_all[idx]
    want_out, want_g = _mxtpu_step(smoke.cs_symbol(mx), params, x, y)
    sym = smoke.cs_symbol(mt)
    ps = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in params.items()}
    for p in ps.values():
        p.attach_grad()
    with mt.autograd.record():
        feed = {k: p.data for k, p in ps.items()}
        feed.update(data=torch.from_numpy(x),
                    softmax_label=torch.from_numpy(y))
        outs, _ = mt.sym.eval_graph(sym._outputs, feed, training=True)
    mt.autograd.backward([mt.nd.NDArray(outs[0])])
    np.testing.assert_allclose(outs[0].detach().numpy(), want_out, **TOL)
    for k in params:
        np.testing.assert_allclose(ps[k].grad.asnumpy(), want_g[k], **TOL,
                                   err_msg=k)


def test_three_sgd_steps_match_mxtpu(smoke, example, data):
    x_all, y_all = data
    params0 = smoke.cs_init_params(1)
    batches = smoke.cs_batches(1)[:3]
    opt = mx.optimizer.SGD(learning_rate=smoke.CS_LR,
                           momentum=smoke.CS_MOMENTUM,
                           rescale_grad=1.0 / smoke.CS_BATCH)
    jsym = smoke.cs_symbol(mx)
    ref = {k: v.copy() for k, v in params0.items()}
    moms = {k: np.zeros_like(v) for k, v in params0.items()}
    names = sorted(ref)
    for idx in batches:
        _, grads = _mxtpu_step(jsym, ref, x_all[idx], y_all[idx])
        for i, k in enumerate(names):
            ref[k] = opt.update_host(i, ref[k], grads[k], moms[k])
    xs = mt.nd.array(x_all, ctx=mt.cpu())
    ys = mt.nd.array(y_all, ctx=mt.cpu())
    got, losses = smoke.cs_train(mt, params0, xs, ys, batches)
    assert losses.shape == (3,) and torch.isfinite(losses).all()
    for k in names:
        np.testing.assert_allclose(got[k].asnumpy(), ref[k], **TOL,
                                   err_msg=k)


def test_trains_to_the_examples_accuracy(smoke, data):
    x_all, y_all = data
    xs = mt.nd.array(x_all, ctx=mt.cpu())
    ys = mt.nd.array(y_all, ctx=mt.cpu())
    batches = smoke.cs_batches(0)
    assert len(batches) == smoke.CS_STEPS == 64
    params, losses = smoke.cs_train(mt, smoke.cs_init_params(0), xs, ys,
                                    batches)
    assert losses[-1] < losses[0]
    assert smoke.cs_accuracy(mt, params, xs, y_all) > 0.9


def test_engine_on_cpu_answers_as_eval_graph(smoke, data):
    x_all, _ = data
    params = {k: mt.nd.array(v, ctx=mt.cpu())
              for k, v in smoke.cs_init_params(2).items()}
    sym = smoke.cs_symbol(mt)
    eng = mt.serving.InferenceEngine(sym, params, {}, {"data": (784,)},
                                     buckets=smoke.CS_BUCKETS, ctx=mt.cpu())
    assert eng.stats()["compiles"] == len(smoke.CS_BUCKETS)
    for rows in (1, 5, 128):
        got = eng.predict([x_all[:rows]])[0]
        feed = {k: p.data for k, p in params.items()}
        feed.update(data=torch.from_numpy(x_all[:rows]),
                    softmax_label=torch.zeros(rows))
        with torch.no_grad():
            want = mt.sym.eval_graph(sym._outputs, feed)[0][0].numpy()
        assert got.shape == (rows, 10)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-5)
    assert eng.stats()["compiles"] == len(smoke.CS_BUCKETS)
