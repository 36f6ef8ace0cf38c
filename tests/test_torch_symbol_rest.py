"""The rest of the port's graph layer (ROADMAP A3) against mxtpu: partial
shape inference with 0 ("unknown") extents, ``Symbol.eval``, ``grad``,
``get_children``, ``list_attr``, ``list_inputs``, ``sym.zeros`` /
``sym.ones``, ``Executor.debug_str``, the top-level aliases, symbol JSON
crossing both ways with equal shape inference, and ``autograd.Function``
and ``autograd.get_symbol``.
"""
import json

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401


def conv(pkg):
    return pkg.sym.Convolution(pkg.sym.Variable("data"), kernel=(3, 3),
                               num_filter=8)


def lenet(pkg):
    """train_mnist.py's LeNet."""
    s = pkg.sym
    x = s.Variable("data")
    for nf in (20, 50):
        x = s.Convolution(x, kernel=(5, 5), num_filter=nf)
        x = s.Activation(x, act_type="tanh")
        x = s.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2))
    x = s.Flatten(x)
    x = s.FullyConnected(x, num_hidden=500)
    x = s.Activation(x, act_type="tanh")
    x = s.FullyConnected(x, num_hidden=10)
    return s.SoftmaxOutput(x, name="softmax")


@pytest.mark.parametrize("call", ["infer_shape", "infer_shape_partial"])
def test_conv_with_unknown_extents(call):
    """A 0 spatial extent passes through Convolution as 0 (mxtpu's
    answer), from either call."""
    want = ([(2, 3, 0, 0), (8, 3, 3, 3), (8,)], [(2, 8, 0, 0)], [])
    assert getattr(conv(mx), call)(data=(2, 3, 0, 0)) == want
    assert getattr(conv(mt), call)(data=(2, 3, 0, 0)) == want


@pytest.mark.parametrize("call", ["infer_shape", "infer_shape_partial"])
def test_lenet_with_an_unknown_width(call):
    """LeNet at width 0: the first FC's weight (500, 0), the output (4,
    10), every other shape known, as mxtpu gives them."""
    got = getattr(lenet(mt), call)(data=(4, 1, 28, 0))
    want = getattr(lenet(mx), call)(data=(4, 1, 28, 0))
    assert got == want
    assert got[0][5] == (500, 0) and got[1] == [(4, 10)]


@pytest.mark.parametrize("call", ["infer_shape", "infer_shape_partial"])
def test_zero_batch_through_fc_raises(call):
    for pkg in (mx, mt):
        fc = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=10)
        with pytest.raises(Exception):
            getattr(fc, call)(data=(0, 100))


def test_deferred_init_with_unknown_extents():
    """Gluon's deferred initialization runs this path: a Conv2D whose
    input channels are unknown learns them at its first call."""
    with mt.cpu():
        net = mt.gluon.nn.Conv2D(4, kernel_size=3, in_channels=0)
        net.initialize()
        out = net(mt.nd.ones((1, 3, 5, 5)))
    assert out.shape == (1, 4, 3, 3)
    assert net.weight.shape == (4, 3, 3, 3)


def test_eval_and_grad():
    x = np.arange(6, dtype=np.float32).reshape(2, 3) - 2
    for pkg in (mx, mt):
        s = pkg.sym.relu(pkg.sym.Variable("a")) * 2.0
        with pkg.cpu():
            out = s.eval(ctx=pkg.cpu(), a=pkg.nd.array(x))
        np.testing.assert_array_equal(out[0].asnumpy(),
                                      np.maximum(x, 0) * 2)
        with pytest.raises(NotImplementedError):
            s.grad(["a"])


def test_children_attrs_inputs():
    for pkg in (mx, mt):
        s = pkg.sym
        with pkg.AttrScope(ctx_group="dev1"):
            a = s.Variable("a", lr_mult=2.0)
        b = s.Variable("b")
        c = s.elemwise_add(a, b, name="c")
        bn = s.BatchNorm(c, name="bn")
        kids = c.get_children()
        assert kids.list_outputs() == ["a", "b"] or \
            [n.split("_output")[0] for n in kids.list_outputs()] == ["a",
                                                                    "b"]
        assert a.get_children() is None
        assert a.list_attr()["ctx_group"] == "dev1"
        assert a.list_attr()["__lr_mult__"] in ("2.0", 2.0)
        assert set(bn.list_attr(recursive=True)) == set(bn.attr_dict())
        assert bn.list_inputs() == bn.list_arguments() + \
            bn.list_auxiliary_states()
        assert bn.list_inputs()[-2:] == ["bn_moving_mean", "bn_moving_var"]
    for fn in ("zeros", "ones"):
        for pkg in (mx, mt):
            with pytest.raises(NotImplementedError):
                getattr(pkg.sym, fn)((2, 3))


def test_debug_str_and_aliases():
    assert mt.AttrScope is mt.attribute.AttrScope
    assert mt.Symbol is mt.symbol.Symbol
    assert mt.Executor is mt.executor.Executor
    net = lenet(mt)
    with mt.cpu():
        ex = net.simple_bind(mt.cpu(), data=(2, 1, 28, 28))
    assert isinstance(ex, mt.Executor)
    assert json.loads(ex.debug_str()) == json.loads(net.tojson())
    jex = lenet(mx).simple_bind(mx.cpu(), data=(2, 1, 28, 28))
    assert [n["op"] for n in json.loads(ex.debug_str())["nodes"]] == \
        [n["op"] for n in json.loads(jex.debug_str())["nodes"]]


SHAPES = [dict(data=(4, 1, 28, 28)), dict(data=(4, 1, 28, 0)),
          dict(data=(2, 1, 0, 28))]


@pytest.mark.parametrize("writer", ["mxtpu", "port"])
def test_json_crosses_with_equal_shapes(writer):
    """LeNet and the convolution saved by either package load in the
    other with the same infer_shape and infer_shape_partial, unknown
    extents included."""
    src, dst = (mx, mt) if writer == "mxtpu" else (mt, mx)
    for build in (lenet, conv):
        sym = build(src)
        back = dst.sym.load_json(sym.tojson())
        assert back.list_arguments() == sym.list_arguments()
        for shapes in SHAPES:
            for call in ("infer_shape", "infer_shape_partial"):
                assert getattr(back, call)(**shapes) == \
                    getattr(sym, call)(**shapes), (build, shapes, call)


def sigmoid_function(pkg):
    """MXNet's autograd.Function example: sigmoid with its own
    backward."""
    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = pkg.nd.sigmoid(x)
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)
    return Sigmoid()


def _function_case(pkg):
    x = pkg.nd.array(np.array([0.5, -1.0, 2.0], np.float32))
    x.attach_grad()
    f = sigmoid_function(pkg)
    with pkg.autograd.record():
        y = f(x) * 3.0
    y.backward()
    plain = f(pkg.nd.array(np.array([0.25], np.float32)))
    return [y.asnumpy(), x.grad.asnumpy(), plain.asnumpy()]


def test_autograd_function():
    with mt.cpu():
        got = _function_case(mt)
    want = _function_case(mx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)


def test_autograd_function_two_outputs_and_int_input():
    class Split(mt.autograd.Function):
        def forward(self, x, idx):
            return x * 2, x + idx.astype("float32")

        def backward(self, da, db):
            return da * 2 + db, None
    with mt.cpu():
        x = mt.nd.array([1.0, 2.0])
        x.attach_grad()
        idx = mt.nd.array([3, 4], dtype="int32")
        with mt.autograd.record():
            a, b = Split()(x, idx)
            loss = mt.nd.sum(a * b)
        loss.backward()
        # d/dx sum(2x (x + i)) = 4x + 2i
        np.testing.assert_allclose(x.grad.asnumpy(), [10.0, 16.0])


def _symbol_case(pkg):
    x = pkg.nd.array(np.array([1.0, -2.0, 3.0], np.float32))
    w = pkg.nd.array(np.array([0.5, 0.25, 0.5], np.float32))
    d = pkg.nd.array(np.array([[3.0, 1.0, 2.0]], np.float32))
    with pkg.autograd.record():
        y = pkg.nd.relu(x * w) + 2.0
        fc = pkg.nd.FullyConnected(data=pkg.nd.reshape(x, shape=(1, 3)),
                                   weight=pkg.nd.reshape(w, shape=(1, 3)),
                                   num_hidden=1, no_bias=True)
        vals = pkg.nd.topk(d, k=2, ret_typ="value")
    out = []
    for res, feeds in ((y, (x, w)), (fc, (x, w)), (vals, (d,))):
        s = pkg.autograd.get_symbol(res)
        args = s.list_arguments()
        assert len(args) == len(feeds) and args[0] == "var0"
        ex = s.bind(pkg.cpu(), {a: f.copy() for a, f in zip(args, feeds)})
        out.append(ex.forward()[0].asnumpy())
        out.append(np.array([len(json.loads(s.tojson())["nodes"])]))
    return out


def test_get_symbol():
    """The recorded calls come back as a graph mxtpu's would be: the
    same free variables, node count and values; a named array input
    (FullyConnected's weight=) takes its place in the signature."""
    with mt.cpu():
        got = _symbol_case(mt)
    want = _symbol_case(mx)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_get_symbol_refuses_a_function_and_keeps_no_record_unrecorded():
    with mt.cpu():
        x = mt.nd.array([0.5])
        with mt.autograd.record():
            y = sigmoid_function(mt)(x) + 1.0
        with pytest.raises(ValueError):
            mt.autograd.get_symbol(y)
        z = mt.nd.relu(x) + 1.0          # not recording: no record kept
        assert z._entry is None
        s = mt.autograd.get_symbol(z)
        assert s.list_arguments() == ["var0"]
