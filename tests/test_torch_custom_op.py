"""Custom ops of the port, case for case with tests/test_custom_op.py,
held against mxtpu on the same inputs.

The same user ops (numpy bodies, written once for either package) are
registered in both packages; each case runs them through the port on
the CPU and through mxtpu, and compares. Tolerances: outputs 1e-6
(identical numpy arithmetic, f32); gradients through autograd 1e-5 (the
builtin softmax's gradient is summed in another order).
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt

TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _register(pkg, prefix):
    nd = pkg.nd

    class MySoftmax(pkg.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], nd.array(y))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            g = out_grad[0].asnumpy()
            dx = y * (g - (g * y).sum(axis=1, keepdims=True))
            self.assign(in_grad[0], req[0], nd.array(dx))

    @pkg.operator.register(prefix + "mysoftmax")
    class MySoftmaxProp(pkg.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0]], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            CONTEXTS.append(ctx)
            return MySoftmax()

    class MyScale2(pkg.operator.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], nd.array(x * self.scale))
            self.assign(out_data[1], req[1], nd.array(x + self.scale))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            g = out_grad[0].asnumpy() * self.scale + out_grad[1].asnumpy()
            self.assign(in_grad[0], req[0], nd.array(g))

    @pkg.operator.register(prefix + "myscale2")
    class MyScale2Prop(pkg.operator.CustomOpProp):
        def __init__(self, scale="2.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def list_outputs(self):
            return ["scaled", "shifted"]

        def infer_shape(self, in_shape):
            return [in_shape[0]], [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return MyScale2(self.scale)

    class Stateful(pkg.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.mask = (x > 0).astype(np.float32)
            self.assign(out_data[0], req[0], nd.array(x * self.mask))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            g = out_grad[0].asnumpy()
            self.assign(in_grad[0], req[0], nd.array(g * self.mask))

    @pkg.operator.register(prefix + "statefulrelu")
    class StatefulProp(pkg.operator.CustomOpProp):
        def infer_shape(self, in_shape):
            return [in_shape[0]], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return Stateful()

    class IndexOut(pkg.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], nd.array(
                np.argmax(x, axis=1).astype(np.int32)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], nd.zeros(in_data[0].shape))

    @pkg.operator.register(prefix + "myargmax")
    class IndexOutProp(pkg.operator.CustomOpProp):
        def infer_shape(self, in_shape):
            return [in_shape[0]], [[in_shape[0][0]]], []

        def infer_type(self, in_type):
            return in_type, [np.int32], []

        def create_operator(self, ctx, shapes, dtypes):
            return IndexOut()

    @pkg.operator.register(prefix + "withaux")
    class AuxProp(pkg.operator.CustomOpProp):
        def list_auxiliary_states(self):
            return ["moving"]


CONTEXTS = []
P = "torchparity_"
_register(mx, P)
_register(mt, P)


@pytest.fixture(autouse=True)
def _on_cpu():
    with mt.cpu():
        yield


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def test_custom_forward_matches_builtin_and_mxtpu():
    x = _x(0, (4, 5))
    got = mt.nd.Custom(mt.nd.array(x), op_type=P + "mysoftmax")
    want = mx.nd.Custom(mx.nd.array(x), op_type=P + "mysoftmax")
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)
    np.testing.assert_allclose(got.asnumpy(),
                               mt.nd.softmax(mt.nd.array(x)).asnumpy(),
                               rtol=1e-5, atol=1e-6)
    assert got.context == mt.cpu()


def _custom_grad(pkg, x, op_type):
    xa = pkg.nd.array(x)
    xa.attach_grad()
    with pkg.autograd.record():
        y = pkg.nd.Custom(xa, op_type=op_type)
        loss = pkg.nd.sum(y * y)
    loss.backward()
    return xa.grad.asnumpy()


def test_custom_backward_through_autograd():
    x = _x(1, (3, 4))
    got = _custom_grad(mt, x, P + "mysoftmax")
    np.testing.assert_allclose(got, _custom_grad(mx, x, P + "mysoftmax"),
                               **GRAD_TOL)
    x2 = mt.nd.array(x)
    x2.attach_grad()
    with mt.autograd.record():
        y2 = mt.nd.softmax(x2)
        loss2 = mt.nd.sum(y2 * y2)
    loss2.backward()
    np.testing.assert_allclose(got, x2.grad.asnumpy(), **GRAD_TOL)


def test_custom_multi_output_with_params():
    x = _x(2, (2, 3))
    a, b = mt.nd.Custom(mt.nd.array(x), op_type=P + "myscale2", scale=3.0)
    ja, jb = mx.nd.Custom(mx.nd.array(x), op_type=P + "myscale2", scale=3.0)
    np.testing.assert_allclose(a.asnumpy(), ja.asnumpy(), **TOL)
    np.testing.assert_allclose(b.asnumpy(), jb.asnumpy(), **TOL)
    np.testing.assert_allclose(a.asnumpy(), x * 3.0, **TOL)
    # gradients of both outputs come back through the user's backward
    xa = mt.nd.array(x)
    xa.attach_grad()
    with mt.autograd.record():
        a, b = mt.nd.Custom(xa, op_type=P + "myscale2", scale=3.0)
        loss = mt.nd.sum(a) + mt.nd.sum(b * 2.0)
    loss.backward()
    np.testing.assert_allclose(xa.grad.asnumpy(),
                               np.full_like(x, 3.0 + 2.0), **TOL)


def test_custom_symbolic_through_eval_graph():
    data = mt.sym.var("data")
    out = mt.sym.Custom(data, op_type=P + "mysoftmax", name="cs")
    out = mt.sym.sum(out * out)
    jdata = mx.sym.var("data")
    jout = mx.sym.Custom(jdata, op_type=P + "mysoftmax", name="cs")
    jout = mx.sym.sum(jout * jout)
    assert out.infer_shape(data=(4, 6)) == jout.infer_shape(data=(4, 6))
    assert out.list_arguments() == jout.list_arguments()
    x = _x(3, (4, 6))
    exe = jout.simple_bind(mx.cpu(), data=(4, 6))
    want = exe.forward(is_train=True, data=mx.nd.array(x))[0].asnumpy()
    exe.backward()
    want_g = exe.grad_dict["data"].asnumpy()
    xa = mt.nd.array(x)
    xa.attach_grad()
    with mt.autograd.record():
        outs, _ = mt.sym.eval_graph(out._outputs, {"data": xa.data},
                                    training=True)
        res = mt.nd.NDArray(outs[0])
    mt.autograd.backward([res])
    np.testing.assert_allclose(res.asnumpy(), want, rtol=1e-5)
    np.testing.assert_allclose(xa.grad.asnumpy(), want_g, **GRAD_TOL)


def test_custom_symbol_json_loads_in_mxtpu():
    data = mt.sym.var("data")
    a = mt.sym.Custom(data, op_type=P + "myscale2", scale=4.0, name="s2")
    assert a.list_outputs() == ["s2_output0", "s2_output1"]
    back = mx.sym.load_json(a.tojson())
    assert back.list_outputs() == a.list_outputs()
    assert back.list_arguments() == a.list_arguments()
    again = mt.sym.load_json(back.tojson())
    assert again.list_outputs() == a.list_outputs()


def test_custom_op_shares_instance_between_fwd_bwd():
    x = _x(4, (3, 3))
    got = _custom_grad_sum(mt, x)
    np.testing.assert_allclose(got, _custom_grad_sum(mx, x), **TOL)
    np.testing.assert_allclose(got, (x > 0).astype(np.float32), **TOL)


def _custom_grad_sum(pkg, x):
    xa = pkg.nd.array(x)
    xa.attach_grad()
    with pkg.autograd.record():
        y = pkg.nd.Custom(xa, op_type=P + "statefulrelu")
        loss = pkg.nd.sum(y)
    loss.backward()
    return xa.grad.asnumpy()


def test_custom_op_honors_infer_type():
    x = _x(5, (4, 6))
    got = mt.nd.Custom(mt.nd.array(x), op_type=P + "myargmax")
    want = mx.nd.Custom(mx.nd.array(x), op_type=P + "myargmax")
    assert got.dtype == torch.int32
    assert got.asnumpy().dtype == want.asnumpy().dtype == np.int32
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_create_operator_gets_the_inputs_context():
    """The port's one deliberate difference: the Context of the inputs,
    where mxtpu passes the string "cpu"."""
    CONTEXTS.clear()
    mt.nd.Custom(mt.nd.array(_x(6, (2, 7))), op_type=P + "mysoftmax")
    mx.nd.Custom(mx.nd.array(_x(6, (2, 7))), op_type=P + "mysoftmax")
    assert CONTEXTS == [mt.cpu(), "cpu"]
    assert isinstance(CONTEXTS[0], mt.Context)


def test_aux_states_and_unknown_op_raise():
    with pytest.raises(NotImplementedError):
        mt.nd.Custom(mt.nd.array(_x(7, (2, 2))), op_type=P + "withaux")
    with pytest.raises(mt.MXNetError):
        mt.nd.Custom(mt.nd.array(_x(7, (2, 2))), op_type="never_registered")


def test_assign_honours_req():
    op = mt.operator.CustomOp()
    dst = mt.nd.array([1.0, 2.0])
    op.assign(dst, "null", mt.nd.array([5.0, 5.0]))
    np.testing.assert_array_equal(dst.asnumpy(), [1.0, 2.0])
    op.assign(dst, "add", np.array([1.0, 1.0], np.float32))
    np.testing.assert_array_equal(dst.asnumpy(), [2.0, 3.0])
    op.assign(dst, "write", mt.nd.array([7.0, 8.0]))
    np.testing.assert_array_equal(dst.asnumpy(), [7.0, 8.0])
    with pytest.raises(ValueError):
        op.assign(dst, "bogus", dst)


def _legacy_square(pkg):
    nd = pkg.nd

    class Square(pkg.operator.NDArrayOp):
        def forward(self, in_data, out_data):
            out_data[0][:] = nd.square(in_data[0])

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][:] = 2 * in_data[0] * out_grad[0]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0]]
    return Square()


def test_ndarray_op_get_symbol():
    x = np.array([1.0, 2.0, -3.0], np.float32)
    s = _legacy_square(mx).get_symbol(mx.sym.var("data"), name="sq")
    exe = s.simple_bind(mx.cpu(), grad_req="write", data=(3,))
    want = exe.forward(is_train=True, data=x)[0].asnumpy()
    exe.backward(out_grads=mx.nd.ones((3,)))
    want_g = exe.grad_dict["data"].asnumpy()
    ts = _legacy_square(mt).get_symbol(mt.sym.var("data"), name="sq")
    assert ts.list_arguments() == s.list_arguments() == ["data"]
    xa = mt.nd.array(x)
    xa.attach_grad()
    with mt.autograd.record():
        outs, _ = mt.sym.eval_graph(ts._outputs, {"data": xa.data},
                                    training=True)
    mt.autograd.backward([mt.nd.NDArray(outs[0])])
    np.testing.assert_allclose(outs[0].detach().numpy(), want, **TOL)
    np.testing.assert_allclose(xa.grad.asnumpy(), want_g, **TOL)
    np.testing.assert_allclose(xa.grad.asnumpy(), 2 * x, **TOL)
    assert issubclass(mt.operator.NativeOp, mt.operator.NDArrayOp)


def test_symbol_arithmetic_matches_mxtpu():
    av = _x(8, (3, 4))
    bv = np.abs(_x(9, (3, 4))) + 0.5

    def build(pkg):
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        return ((2 * a - b / 4) * b + 1 - (-a)) / (1 + b) + (a ** 2) \
            - 3 / b + 0.5 * (a - 2)

    jexe = build(mx).simple_bind(mx.cpu(), a=(3, 4), b=(3, 4))
    want = jexe.forward(a=mx.nd.array(av), b=mx.nd.array(bv))[0].asnumpy()
    s = build(mt)
    assert s.list_arguments() == ["a", "b"]
    got, _ = mt.sym.eval_graph(s._outputs, {"a": torch.from_numpy(av),
                                            "b": torch.from_numpy(bv)})
    np.testing.assert_allclose(got[0].numpy(), want, rtol=1e-6, atol=1e-6)
    assert s.infer_shape(a=(3, 4), b=(3, 4))[1] == [(3, 4)]
