"""The port's NDArray surface, autograd and engine controls, against
mxtpu on the same inputs; cases drawn from tests/test_ndarray.py and
tests/test_autograd.py.

Each case is one function of the package (``pkg`` is mxtpu or
mxtpu_torch) that returns numpy values; both packages run it, the port
inside ``with cpu():``, and the values, dtypes included, must agree.
Tolerance: exact for what both compute the same way, 1e-6 for float32
arithmetic that may round in another order (reductions, exp, log).
"""
import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt

TOL = dict(rtol=1e-6, atol=1e-6)


def both(case):
    with mt.cpu():
        got = case(mt)
    want = case(mx)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, **TOL)
    return got


def test_creation():
    def case(pkg):
        nd = pkg.nd
        return [nd.array([[1, 2], [3, 4]]).asnumpy(),
                nd.zeros((3, 4)).asnumpy(),
                nd.ones((2,), dtype="int32").asnumpy(),
                nd.full((2, 2), 7.0).asnumpy(),
                nd.arange(0, 10, 2).asnumpy(),
                nd.arange(2, repeat=2).asnumpy(),
                nd.arange(0, 5, dtype="int32").asnumpy(),
                nd.array(np.arange(3, dtype=np.int64)).asnumpy(),
                nd.array(np.ones(2, np.float64)).asnumpy(),
                nd.concatenate([nd.ones((2, 3)), nd.zeros((2, 3))],
                               axis=1).asnumpy(),
                np.asarray(nd.empty((2, 3)).shape)]
    both(case)
    with mt.cpu():
        a = mt.nd.ones((2, 3))
        assert a.context == mt.cpu() and a.ndim == 2 and a.size == 6


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_arithmetic(dtype):
    def case(pkg):
        nd = pkg.nd
        a = nd.array(np.array([[1, 2], [3, 4]]), dtype=dtype)
        b = nd.array(np.array([[10, 20], [30, 40]]), dtype=dtype)
        out = [a + b, b - a, a * 2, 2 * a, a * 1.5, 1 / a, a / 2, a ** 2,
               2 ** a, -a, a % 3, 7 % a, 10 - a, abs(-a), a + 0.5]
        a += b
        out.append(a)
        c = nd.array(np.array([1.0, 4.0]))
        c *= 3
        c -= 1
        c /= 2
        out.append(c)
        return [o.asnumpy() for o in out]
    both(case)


def test_comparison_returns_numeric():
    def case(pkg):
        a = pkg.nd.array([1.0, 2.0, 3.0])
        b = pkg.nd.array([2.0, 2.0, 2.0])
        i = pkg.nd.array(np.array([1, 2, 3], np.int32))
        return [(a == b).asnumpy(), (a != b).asnumpy(), (a > b).asnumpy(),
                (a >= b).asnumpy(), (a < 2).asnumpy(), (a <= 2).asnumpy(),
                (i == 2).asnumpy(), (2 < a).asnumpy()]
    both(case)


def test_indexing_copies_like_mxtpu():
    def case(pkg):
        a = pkg.nd.array(np.arange(12).reshape(3, 4).astype("f"))
        row = a[1]
        part = a[1:3]
        col = a[:, 2]
        a[0] = 99.0
        a[1:3] = 0.0
        a[2, 1:3] = pkg.nd.array([5.0, 6.0])
        taken = a[pkg.nd.array([0, 2])]
        b = a.copy()
        b[0, 0] = -1.0
        return [row.asnumpy(), part.asnumpy(), col.asnumpy(), a.asnumpy(),
                taken.asnumpy(), b.asnumpy()]
    both(case)


def test_reshape_and_methods():
    def case(pkg):
        a = pkg.nd.array(np.arange(24).astype("f"))
        b = a.reshape(2, 3, 4)
        return [np.asarray(b.shape), np.asarray(b.reshape((-1,)).shape),
                np.asarray(b.reshape(0, -1).shape),
                np.asarray(b.reshape(shape=(4, -1)).shape),
                np.asarray(a.sum().asscalar()), b.sum(axis=1).asnumpy(),
                b.exp().asnumpy()]
    both(case)


@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_reductions(op):
    def case(pkg):
        nd = pkg.nd
        a = nd.array(np.random.RandomState(0).randn(2, 3, 4).astype("f"))
        i = nd.array(np.arange(24).reshape(2, 3, 4).astype(np.int32))
        f = getattr(nd, op)
        return [f(a).asnumpy(), f(a, axis=1).asnumpy(),
                f(a, axis=(0, 2), keepdims=True).asnumpy(),
                f(a, axis=1, exclude=True).asnumpy(),
                f(a, axis=-1).asnumpy(), f(i, axis=2).asnumpy()]
    both(case)


def test_argmax_and_unary():
    def case(pkg):
        nd = pkg.nd
        a = nd.array(np.random.RandomState(1).rand(3, 5).astype("f") + 0.1)
        i = nd.array(np.array([1, 4, 9], np.int32))
        return [nd.argmax(a, axis=1).asnumpy(),
                nd.argmax(a, axis=0, keepdims=True).asnumpy(),
                nd.exp(a).asnumpy(), nd.log(a).asnumpy(),
                nd.sqrt(a).asnumpy(), nd.square(a).asnumpy(),
                nd.negative(a).asnumpy(), nd.abs(-a).asnumpy(),
                nd.sqrt(i).asnumpy(), nd.square(i).asnumpy(),
                nd.relu(a - 0.5).asnumpy(), nd.sigmoid(a).asnumpy(),
                nd.tanh(a).asnumpy()]
    both(case)


def test_broadcast_and_scalar_ops_by_name():
    def case(pkg):
        nd = pkg.nd
        a = nd.array(np.array([[1.0, -2.0, 3.0]]))
        b = nd.array(np.array([[2.0], [-1.0]]))
        out = [nd.broadcast_add(a, b), nd.broadcast_sub(a, b),
               nd.broadcast_mul(a, b), nd.broadcast_div(a, b),
               nd.broadcast_maximum(a, b), nd.broadcast_minimum(a, b),
               nd.broadcast_power(nd.abs(a), b), nd.broadcast_mod(a, b),
               nd.broadcast_greater(a, b), nd.broadcast_lesser_equal(a, b),
               nd.broadcast_not_equal(a, b)]
        for name in ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
                     "_mul_scalar", "_div_scalar", "_rdiv_scalar",
                     "_mod_scalar", "_rmod_scalar", "_maximum_scalar",
                     "_minimum_scalar", "_greater_scalar",
                     "_lesser_equal_scalar", "_equal_scalar"):
            out.append(getattr(nd, name)(a, scalar=2.0))
        out.append(nd._power_scalar(nd.abs(a), scalar=2.0))
        out.append(nd._rpower_scalar(a, scalar=2.0))
        return [o.asnumpy() for o in out]
    both(case)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation(act):
    def case(pkg):
        x = pkg.nd.array(np.linspace(-4, 4, 9).astype("f"))
        return [pkg.nd.Activation(x, act_type=act).asnumpy()]
    both(case)


def test_copies_and_contexts():
    def case(pkg):
        a = pkg.nd.array([1.0, 2.0])
        b = a.as_in_context(pkg.cpu(0))
        c = pkg.nd.zeros((2,), dtype="int32")
        a.copyto(c)                       # c takes a's value and dtype
        d = a.copyto(pkg.cpu(0))
        e = a.astype("int32")
        a[0] = 5.0                        # no other array sees it
        return [b.asnumpy(), c.asnumpy(), d.asnumpy(), e.asnumpy(),
                a.asnumpy(), np.asarray(a.asscalar() if a.size == 1 else 0)]
    both(case)
    with mt.cpu():
        a = mt.nd.array([3.5])
        assert a.as_in_context(mt.cpu()) is a
        a.wait_to_read()
        assert a.asscalar() == pytest.approx(3.5)
        mt.nd.waitall()


def test_simple_grad():
    def case(pkg):
        x = pkg.nd.array([1.0, 2.0, 3.0])
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * x).sum()
        y.backward()
        return [x.grad.asnumpy(), y.asnumpy()]
    both(case)


def test_chain_and_broadcast():
    xv = np.random.RandomState(2).randn(3, 4).astype("f")
    wv = np.random.RandomState(3).randn(5, 4).astype("f")

    def case(pkg):
        x, w = pkg.nd.array(xv), pkg.nd.array(wv)
        x.attach_grad()
        w.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.FullyConnected(data=x, weight=w, num_hidden=5,
                                      no_bias=True)
            z = pkg.nd.relu(y).sum()
        z.backward()
        return [w.grad.asnumpy(), x.grad.asnumpy()]
    both(case)


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_grad_req(req):
    def case(pkg):
        x = pkg.nd.array([1.0, 2.0])
        x.attach_grad(grad_req=req)
        for _ in range(3):
            with pkg.autograd.record():
                y = (x * x).sum()
            y.backward()
        return [x.grad.asnumpy()]
    both(case)


def test_not_recording_outside_scope_and_detach():
    def case(pkg):
        x = pkg.nd.array([1.0])
        x.attach_grad()
        y = x * 2                  # not recorded
        with pkg.autograd.record():
            z = x * 3
            w = (x * 3).detach() * 2
        z.backward()
        g1 = x.grad.asnumpy().copy()
        w.backward()              # nothing recorded reaches x
        return [y.asnumpy(), g1, x.grad.asnumpy()]
    both(case)


def test_autograd_grad_function_and_head_grads():
    def case(pkg):
        ag = pkg.autograd
        x = pkg.nd.array([1.0, 2.0])
        with ag.record():
            y = (x * x * x).sum()
        g = ag.grad(y, x)
        v = pkg.nd.array([1.0, 2.0])
        v.attach_grad()
        with ag.record():
            u = v * 2
            t = u * 3
        t.backward(pkg.nd.array([1.0, 10.0]), retain_graph=True)
        first = v.grad.asnumpy().copy()
        ag.backward([t], head_grads=[pkg.nd.array([1.0, 1.0])])
        return [g.asnumpy(), first, v.grad.asnumpy()]
    both(case)


def test_inplace_update_of_a_variable():
    def case(pkg):
        w = pkg.nd.array([1.0, -1.0])
        w.attach_grad()
        for _ in range(2):
            with pkg.autograd.record():
                loss = (w * w).sum()
            loss.backward()
            w -= 0.25 * w.grad           # SGD outside record()
        return [w.asnumpy(), w.grad.asnumpy()]
    both(case)


def test_scopes_and_flags():
    def case(pkg):
        ag = pkg.autograd
        seen = [ag.is_training(), ag.is_recording()]
        with ag.record():
            seen += [ag.is_training(), ag.is_recording()]
            with ag.pause():
                seen += [ag.is_training(), ag.is_recording()]
        with ag.record(train_mode=False):
            seen += [ag.is_training(), ag.is_recording()]
        with ag.train_mode():
            seen += [ag.is_training(), ag.is_recording()]
            with ag.predict_mode():
                seen.append(ag.is_training())
        seen += [ag.set_training(True), ag.set_training(False),
                 ag.set_recording(True), ag.set_recording(False)]
        return [np.asarray(seen)]
    both(case)


def test_mark_variables():
    def case(pkg):
        x = pkg.nd.array([1.0, 2.0])
        gx = pkg.nd.zeros((2,))
        pkg.autograd.mark_variables([x], [gx], "add")
        for _ in range(2):
            with pkg.autograd.record():
                y = (x * 4).sum()
            y.backward()
        return [gx.asnumpy(), x.grad.asnumpy()]
    both(case)


def test_engine_controls():
    def case(pkg):
        eng = pkg.engine
        before = eng.engine_type()
        try:
            eng.set_engine_type("NaiveEngine")
            sync = eng.is_synchronous()
            typ = eng.engine_type()
            x = pkg.nd.array([1.0, 2.0]) * 3     # ops wait when synchronous
            prev = eng.set_bulk_size(7)
            with eng.bulk(3):
                inner = eng.set_bulk_size(3)
            after = eng.set_bulk_size(prev)
            eng.waitall()
        finally:
            eng.set_engine_type(before)
        return [np.asarray([sync, typ == "NaiveEngine", inner == 3,
                            after == 7, eng.is_synchronous()]),
                x.asnumpy()]
    both(case)
    with pytest.raises(ValueError):
        mt.engine.set_engine_type("FancyEngine")


# ---------------------------------------------------------------------------
# SoftmaxOutput's backward: softmax - onehot(label), not torch's derivative
# of the softmax, with each option of mxtpu's custom_vjp
# ---------------------------------------------------------------------------

def test_softmax_output_backward_is_softmax_minus_onehot():
    def case(pkg):
        x = pkg.nd.array([[1, 2, 3], [0.5, -1, 2]])
        x.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd.SoftmaxOutput(x, pkg.nd.array([2, 0]))
        y.backward()
        return [y.asnumpy(), x.grad.asnumpy()]
    _, grad = both(case)
    assert np.abs(grad).max() > 0.8


SOFTMAX_OUTPUT_CASES = {
    "default": ((4, 5), {}),
    "grad_scale": ((4, 5), dict(grad_scale=2.5)),
    "normalization_null": ((4, 5), dict(normalization="null")),
    "normalization_batch": ((4, 5), dict(normalization="batch")),
    "normalization_valid": ((4, 5), dict(normalization="valid")),
    "normalization_valid_ignored": ((4, 5), dict(
        normalization="valid", use_ignore=True, ignore_label=1.0)),
    "valid_all_ignored": ((4, 5), dict(normalization="valid",
                                        use_ignore=True, ignore_label=-1.0)),
    "use_ignore": ((4, 5), dict(use_ignore=True, ignore_label=1.0)),
    "smooth_alpha": ((4, 5), dict(smooth_alpha=0.1)),
    "multi_output": ((2, 3, 4), dict(multi_output=True)),
    "multi_output_ignore_valid": ((2, 3, 4), dict(
        multi_output=True, use_ignore=True, ignore_label=0.0,
        normalization="valid", smooth_alpha=0.2)),
    "preserve_shape": ((4, 5), dict(preserve_shape=True)),
    "flattened_3d": ((2, 3, 4), {}),
    "out_grad": ((4, 5), dict(out_grad=True, grad_scale=0.5)),
}


def _softmax_output_inputs(shape, kw, seed):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    lab_shape = (shape[0],) + shape[2:] if kw.get("multi_output") \
        else (shape[0],)
    classes = shape[1] if kw.get("multi_output") else shape[-1]
    label = rng.randint(0, classes, lab_shape).astype(np.float32)
    if kw.get("ignore_label") == -1.0:
        label[:] = -1.0
    head = rng.standard_normal(shape).astype(np.float32)
    return x, label, head


@pytest.mark.parametrize("name", sorted(SOFTMAX_OUTPUT_CASES))
def test_softmax_output_options_match_mxtpu_vjp(name):
    """Output and gradients through nd.SoftmaxOutput under autograd, with
    a head gradient that only ``out_grad`` lets through, against jax.vjp
    of mxtpu's op; the label's gradient is zero."""
    import jax
    import jax.numpy as jnp
    import torch
    from mxtpu.ops import nn as jnn
    shape, kw = SOFTMAX_OUTPUT_CASES[name]
    x, label, head = _softmax_output_inputs(shape, kw, seed=len(name))
    out, vjp = jax.vjp(lambda d, l: jnn.softmax_output(d, l, **kw),
                       jnp.asarray(x), jnp.asarray(label))
    dx_want, dlabel_want = vjp(jnp.asarray(head))
    with mt.cpu():
        a, lab = mt.nd.array(x), mt.nd.array(label)
        a.attach_grad()
        lab.attach_grad()
        with mt.autograd.record():
            y = mt.nd.SoftmaxOutput(a, lab, **kw)
        y.backward(mt.nd.array(head))
    np.testing.assert_allclose(y.asnumpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(a.grad.asnumpy(), np.asarray(dx_want), **TOL)
    assert not np.asarray(dlabel_want).any()
    assert not lab.grad.asnumpy().any()
    assert a.grad.data.dtype == torch.float32


def test_softmax_output_through_eval_graph_matches_mxtpu():
    """The graph evaluator reaches the registered op itself, so a symbol's
    SoftmaxOutput head ignores the head gradient under autograd too."""
    import jax
    import jax.numpy as jnp
    import torch
    from mxtpu.ops import nn as jnn
    from mxtpu_torch.ops import get_op, nn as tnn
    assert get_op("SoftmaxOutput").fn is tnn.softmax_output
    kw = dict(use_ignore=True, ignore_label=2.0, normalization="valid",
              grad_scale=1.5)
    x, label, head = _softmax_output_inputs((6, 4), kw, seed=11)
    _, vjp = jax.vjp(lambda d: jnn.softmax_output(d, jnp.asarray(label),
                                                  **kw), jnp.asarray(x))
    want, = vjp(jnp.asarray(head))
    net = mt.sym.SoftmaxOutput(mt.sym.var("data"), mt.sym.var("label"),
                               name="softmax", **kw)
    with mt.cpu():
        a = mt.nd.array(x)
        a.attach_grad()
        with mt.autograd.record():
            outs, _ = mt.sym.eval_graph(net._outputs, {
                "data": a.data, "label": torch.from_numpy(label)},
                training=True)
            y = mt.nd.NDArray(outs[0])
        mt.autograd.backward([y], head_grads=[mt.nd.array(head)])
    np.testing.assert_allclose(a.grad.asnumpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("op", ["Activation", "relu"])
def test_relu_gradient_splits_a_tie_as_mxtpu(op):
    """ReLU's gradient is g where x > 0, 0 where x < 0 and g / 2 at x = 0,
    as jax.vjp of mxtpu's op (jnp.maximum) gives it: through
    nd.Activation(act_type="relu"), nd.relu and a symbol's graph."""
    import jax
    import jax.numpy as jnp
    from mxtpu.ops import get_op as mx_get_op
    x = np.array([-1.0, 0.0, 2.0, 0.0, -0.5], np.float32)
    head = np.array([1.0, 2.0, 3.0, -4.0, 5.0], np.float32)
    kw = {"act_type": "relu"} if op == "Activation" else {}
    out, vjp = jax.vjp(lambda d: mx_get_op(op).fn(d, **kw), jnp.asarray(x))
    want, = vjp(jnp.asarray(head))
    np.testing.assert_array_equal(np.asarray(want), [0, 1, 3, -2, 0])
    with mt.cpu():
        a = mt.nd.array(x)
        a.attach_grad()
        with mt.autograd.record():
            y = getattr(mt.nd, op)(a, **kw)
        y.backward(mt.nd.array(head))
        np.testing.assert_array_equal(y.asnumpy(), np.asarray(out))
        np.testing.assert_array_equal(a.grad.asnumpy(), np.asarray(want))
        net = getattr(mt.sym, op)(mt.sym.var("data"), **kw)
        exe = net.simple_bind(ctx=mt.cpu(), data=x.shape)
        exe.forward(is_train=True, data=mt.nd.array(x))
        exe.backward(out_grads=[mt.nd.array(head)])
        np.testing.assert_array_equal(exe.grad_dict["data"].asnumpy(),
                                      np.asarray(want))


@pytest.mark.parametrize("ids", [[1, 5], [-1, 2], [3, -5, 0, 4],
                                 [[0, 9], [-4, 2]]],
                         ids=["past_end", "negative", "mixed", "2d"])
def test_embedding_out_of_range_ids_match_mxtpu(ids):
    """An id outside [0, rows): jnp.take's rule. A negative id counts from
    the end once; an id still outside gives a row of NaN, and no error
    (on the card, no device-side assert). Its row gets no gradient."""
    import jax
    import jax.numpy as jnp
    from mxtpu.ops import nn as jnn
    w = np.arange(12, dtype=np.float32).reshape(4, 3) / 10
    data = np.asarray(ids, np.float32)
    head = np.random.RandomState(1).standard_normal(
        data.shape + (3,)).astype(np.float32)
    want = mx.nd.Embedding(mx.nd.array(data), mx.nd.array(w), input_dim=4,
                           output_dim=3).asnumpy()
    _, vjp = jax.vjp(lambda t: jnn.embedding(jnp.asarray(data), t,
                                             input_dim=4, output_dim=3),
                     jnp.asarray(w))
    dw_want, = vjp(jnp.asarray(np.nan_to_num(head)))
    with mt.cpu():
        weight = mt.nd.array(w)
        weight.attach_grad()
        with mt.autograd.record():
            got = mt.nd.Embedding(mt.nd.array(data), weight, input_dim=4,
                                  output_dim=3)
        got.backward(mt.nd.array(head))
        np.testing.assert_array_equal(got.asnumpy(), want)
        np.testing.assert_allclose(weight.grad.asnumpy(),
                                   np.asarray(dw_want), **TOL)


@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_writes_its_moving_statistics_back(training):
    """C10: eager nd.BatchNorm under record() writes its new moving
    statistics into the moving_mean / moving_var arrays, as mxtpu's
    invoke writes aux outputs back (in training; in inference they stay).
    The port writes them in place, detached: the tensors keep their
    storage, and no graph hangs on them."""
    x = np.random.RandomState(0).randn(4, 3, 2, 2).astype(np.float32)
    ptrs = []

    def case(pkg):
        nd = pkg.nd
        a = nd.array(x)
        g, b = nd.array([1.0, 2.0, 0.5]), nd.array([0.1, 0.0, -0.2])
        mm, mv = nd.zeros((3,)), nd.ones((3,))
        if pkg is mt:
            ptrs.append((mm.data.data_ptr(), mv.data.data_ptr()))
        with pkg.autograd.record(train_mode=training):
            out = nd.BatchNorm(a, g, b, mm, mv, fix_gamma=False)
        if pkg is mt:
            ptrs.append((mm.data.data_ptr(), mv.data.data_ptr()))
            assert not mm.data.requires_grad and not mv.data.requires_grad
        return [out.asnumpy(), mm.asnumpy(), mv.asnumpy()]
    got = both(case)
    assert ptrs[0] == ptrs[1]
    moved = float(np.abs(got[1]).sum() + np.abs(got[2] - 1).sum())
    assert (moved > 0) == training


@pytest.mark.parametrize("output_mean_var", [False, True])
def test_batchnorm_returns_its_shown_outputs(output_mean_var):
    """C11: nd.BatchNorm returns the op's user_outputs: one NDArray, or
    three (out, mean, invstd) under output_mean_var, as mxtpu's."""
    x = np.random.RandomState(1).randn(5, 2, 3).astype(np.float32)
    shapes = []

    def case(pkg):
        nd = pkg.nd
        out = nd.BatchNorm(nd.array(x), nd.ones((2,)), nd.zeros((2,)),
                           nd.zeros((2,)), nd.ones((2,)),
                           output_mean_var=output_mean_var)
        outs = out if output_mean_var else [out]
        shapes.append([type(out).__name__, len(outs)])
        return [o.asnumpy() for o in outs]
    both(case)
    want = ["list", 3] if output_mean_var else ["NDArray", 1]
    assert shapes == [want, want]


RMOD_X = [[0.7, 0.8, 0.9],
          np.random.RandomState(5).uniform(0.3, 3.0, 6).tolist(),
          (-np.random.RandomState(6).uniform(0.3, 3.0, 6)).tolist()]


@pytest.mark.parametrize("form", ["op", "operator"])
@pytest.mark.parametrize("xs", RMOD_X, ids=["fixed", "positive", "negative"])
def test_rmod_scalar_gradient_matches_jax_vjp(xs, form):
    """C12: ``nd._rmod_scalar(x, scalar=2.0)`` (and ``2.0 % x``) under
    record() gives ``jnp.mod(2.0, x)``'s value and its ``jax.vjp``
    gradient in x, -floor(2 / x) times the head gradient, where torch
    has no derivative for a number's remainder by a tensor."""
    import jax
    import jax.numpy as jnp
    x = np.asarray(xs, np.float32)
    head = np.random.RandomState(7).uniform(0.5, 1.5, x.shape) \
        .astype(np.float32)
    want, vjp = jax.vjp(lambda v: jnp.mod(2.0, v), jnp.asarray(x))
    (dx_want,) = vjp(jnp.asarray(head))

    def case(pkg):
        a = pkg.nd.array(x)
        a.attach_grad()
        with pkg.autograd.record():
            y = pkg.nd._rmod_scalar(a, scalar=2.0) if form == "op" \
                else 2.0 % a
        y.backward(pkg.nd.array(head))
        return [y.asnumpy(), a.grad.asnumpy()]
    got = both(case)
    np.testing.assert_allclose(got[0], np.asarray(want), **TOL)
    np.testing.assert_allclose(got[1], np.asarray(dx_want), **TOL)
    if xs == RMOD_X[0]:
        np.testing.assert_array_equal(got[1] / head, [-2.0, -2.0, -2.0])
