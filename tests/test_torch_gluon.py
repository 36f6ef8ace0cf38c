"""The port's Gluon against mxtpu's, on the CPU: the cases of
tests/test_gluon.py that the port covers, each run in both packages on the
same seeded numpy inputs and the same weights (carried from mxtpu into the
port by ``ParameterDict.load_dict``, or across through ``save_params``
files), the port inside ``with mt.cpu():``.

Tolerance: float32 ops 1e-5 (TOL): both packages compute the same
functions in float32 with sums in another order. Shapes, parameter names,
counts and the port's own program counts exactly.
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        np.testing.assert_allclose(g, w, **tol)


def carry(mblock, tblock):
    """The port's block takes mxtpu's block's weights (same names)."""
    params = {k: v.data().asnumpy()
              for k, v in mblock.collect_params().items()}
    tblock.collect_params().load_dict(params, ctx=mt.cpu())
    return params


def both(build, inputs, init=None):
    """Build ``build(pkg)`` in both packages, initialize mxtpu's (one
    forward finishes deferred shapes), carry its weights to the port's.
    Returns (mxtpu block, port block)."""
    m = build(mx)
    m.initialize(init(mx) if init else None)
    m(*[mx.nd.array(a) for a in inputs])
    with mt.cpu():
        t = build(mt)
        t.initialize(init(mt) if init else None, ctx=mt.cpu())
        t(*[mt.nd.array(a) for a in inputs])
    carry(m, t)
    return m, t


def forward_backward(pkg, block, inputs, label=None, loss=None):
    """Outputs, and under record the parameters' and the first input's
    gradients after backward of sum(outputs) (or of ``loss``)."""
    ctx = pkg.cpu()
    xs = [pkg.nd.array(a, ctx=ctx) for a in inputs]
    xs[0].attach_grad()
    with pkg.autograd.record():
        out = block(*xs)
        head = loss(out, pkg.nd.array(label, ctx=ctx)) if loss else out
    head.backward()
    grads = [p.grad().asnumpy() for p in block.collect_params().values()
             if p.grad_req != "null"]
    return [out.asnumpy(), xs[0].grad.asnumpy()] + grads


def run_both(fn):
    """``fn(pkg)`` in mxtpu and in the port (under ``mt.cpu()``)."""
    with mt.cpu():
        got = fn(mt)
    return got, fn(mx)


# -- parameters --------------------------------------------------------------

def test_parameter():
    for pkg in (mx, mt):
        with pkg.cpu():
            p = pkg.gluon.Parameter("weight", shape=(10, 10))
            p.initialize(init="xavier", ctx=pkg.cpu())
            assert p.data().shape == (10, 10)
            assert p.grad().shape == (10, 10)
            assert p.list_data()[0] is p.data()
            assert p.list_ctx() == [pkg.cpu()]
    with mt.cpu():
        p = mt.gluon.Parameter("weight", shape=(10, 10))
        with pytest.raises(RuntimeError):
            p.data()
        d = mt.gluon.Parameter("w", shape=(3, 0), allow_deferred_init=True)
        d.initialize(ctx=mt.cpu())
        with pytest.raises(mt.gluon.DeferredInitializationError):
            d.data()
        with pytest.raises(ValueError):
            mt.gluon.Parameter("w", shape=(3, 0)).initialize(ctx=mt.cpu())


def test_parameter_set_data_cast_grad_req():
    """set_data before and after initialize, zero_grad in place, cast,
    grad_req changes: each change of storage bumps the version a
    hybridized block reads."""
    with mt.cpu():
        p = mt.gluon.Parameter("w", shape=(2, 3))
        p.set_data(np.arange(6, dtype=np.float32).reshape(2, 3))
        v0 = p._version
        grad = p.grad().data
        p.grad().data.fill_(1.0)
        p.zero_grad()
        assert p.grad().data is grad and float(grad.abs().sum()) == 0
        p.set_data(mt.nd.ones((2, 3)))
        np.testing.assert_array_equal(p.data().asnumpy(), np.ones((2, 3)))
        assert p._version > v0 and p.data().data.requires_grad
        with pytest.raises(ValueError):
            p.set_data(mt.nd.ones((3, 2)))
        v1 = p._version
        p.grad_req = "null"
        assert p._version > v1
        with pytest.raises(RuntimeError):
            p.grad()
        p.grad_req = "add"
        assert p.grad().shape == (2, 3)
        p.cast("float64")
        assert p.data().dtype == mt.nd.array([1.0]).data.double().dtype


def test_paramdict(tmp_path):
    fname = str(tmp_path / "pd.params")
    for pkg in (mx, mt):
        with pkg.cpu():
            params = pkg.gluon.ParameterDict("net_")
            params.get("weight", shape=(10, 10))
            assert list(params.keys()) == ["net_weight"]
            params.initialize(ctx=pkg.cpu())
            params.save(fname)
            params.load(fname, pkg.cpu())
    # a file either package saves loads in the other
    m = mx.gluon.ParameterDict("net_")
    m.get("weight", shape=(10, 10))
    m.initialize()
    m.save(fname)
    with mt.cpu():
        t = mt.gluon.ParameterDict("net_")
        t.get("weight", shape=(10, 10))
        t.load(fname, mt.cpu())
        np.testing.assert_array_equal(t["net_weight"].data().asnumpy(),
                                      m["net_weight"].data().asnumpy())
        t["net_weight"].set_data(mt.nd.ones((10, 10)))
        t.save(fname)
        assert t.get_constant("c", np.arange(3)).grad_req == "null"
    m.load(fname)
    np.testing.assert_array_equal(m["net_weight"].data().asnumpy(),
                                  np.ones((10, 10)))


def test_load_dict_checks_names():
    with mt.cpu():
        pd = mt.gluon.ParameterDict("a_")
        pd.get("w", shape=(2,))
        with pytest.raises(IOError):
            pd.load_dict({})
        with pytest.raises(IOError):
            pd.load_dict({"a_w": np.ones(2), "a_x": np.ones(2)})
        pd.load_dict({"a_w": np.ones(2), "a_x": np.ones(2)},
                     ignore_extra=True)
        pd.load_dict({"w": np.full(2, 3.0)}, restore_prefix="a_")
        np.testing.assert_array_equal(pd["a_w"].data().asnumpy(), [3, 3])


# -- blocks ------------------------------------------------------------------

def test_dense():
    def build(pkg):
        return pkg.gluon.nn.Dense(128, activation="tanh", in_units=10,
                                  flatten=False, prefix="test_dense_")
    x = np.random.RandomState(0).rand(2, 3, 10).astype(np.float32)
    m, t = both(build, [x])
    assert list(t.collect_params().keys()) == \
        ["test_dense_weight", "test_dense_bias"]
    with mt.cpu():
        got = forward_backward(mt, t, [x])
    close(got, forward_backward(mx, m, [x]))

    def build2(pkg):
        return pkg.gluon.nn.Dense(64, activation="relu", prefix="fc_")
    x2 = np.random.RandomState(1).rand(17, 2, 15).astype(np.float32)
    m2, t2 = both(build2, [x2])
    assert t2.weight.shape == (64, 30)
    with mt.cpu():
        got = forward_backward(mt, t2, [x2])
    close(got, forward_backward(mx, m2, [x2]))


def mlp(pkg, prefix="mlp_", out=8):
    net = pkg.gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(pkg.gluon.nn.Dense(32, activation="relu"))
        net.add(pkg.gluon.nn.Dense(out))
    return net


def test_hybrid_eager_consistency():
    x = np.random.RandomState(0).rand(4, 16).astype(np.float32)
    m, t = both(mlp, [x])
    want = m(mx.nd.array(x)).asnumpy()
    with mt.cpu():
        eager = t(mt.nd.array(x)).asnumpy()
        t.hybridize()
        hybrid = t(mt.nd.array(x)).asnumpy()
        assert t.cache_stats()["compiles"] == 1
    close([eager, hybrid], [want, want])
    np.testing.assert_array_equal(eager, hybrid)


@pytest.mark.parametrize("hybridize", [False, True])
def test_hybrid_backward_matches_eager(hybridize):
    rs = np.random.RandomState(0)
    x = rs.rand(8, 10).astype(np.float32)
    label = rs.randint(0, 4, (8,)).astype(np.float32)
    m, t = both(lambda pkg: mlp(pkg, out=4), [x])
    want = forward_backward(mx, m, [x], label,
                            mx.gluon.loss.SoftmaxCrossEntropyLoss())
    with mt.cpu():
        if hybridize:
            t.hybridize()
        got = forward_backward(mt, t, [x], label,
                               mt.gluon.loss.SoftmaxCrossEntropyLoss())
    close(got, want)


def test_hybridized_grad_req_add_accumulates():
    """Two backward passes through a hybridized block with grad_req='add'
    sum their gradients, as two eager ones do; zero_grad clears them."""
    rs = np.random.RandomState(3)
    xs = [rs.rand(4, 6).astype(np.float32) for _ in range(2)]
    grads = {}
    with mt.cpu():
        for hyb in (False, True):
            net = mlp(mt, prefix="acc_", out=3)
            net.initialize(mt.init.One(), ctx=mt.cpu())
            net.collect_params().setattr("grad_req", "add")
            if hyb:
                net.hybridize()
            for x in xs:
                with mt.autograd.record():
                    y = net(mt.nd.array(x))
                y.backward()
            grads[hyb] = [p.grad().asnumpy().copy()
                          for p in net.collect_params().values()]
            net.collect_params().zero_grad()
            assert all(float(np.abs(p.grad().asnumpy()).sum()) == 0
                       for p in net.collect_params().values())
    m = mlp(mx, prefix="acc_", out=3)
    m.initialize(mx.init.One())
    for p in m.collect_params().values():
        p.grad_req = "add"
    for x in xs:
        with mx.autograd.record():
            y = m(mx.nd.array(x))
        y.backward()
    want = [p.grad().asnumpy() for p in m.collect_params().values()]
    close(grads[False], want)
    close(grads[True], want)


def test_hybridized_grad_does_not_write_grads():
    """autograd.grad through a hybridized block returns the gradient and
    leaves the parameters' grad arrays as they were, as in mxtpu."""
    x = np.random.RandomState(4).rand(3, 5).astype(np.float32)
    with mt.cpu():
        net = mlp(mt, prefix="g_", out=2)
        net.initialize(mt.init.One(), ctx=mt.cpu())
        net.collect_params().setattr("grad_req", "add")
        net.hybridize()
        xa = mt.nd.array(x)
        xa.attach_grad()
        with mt.autograd.record():
            y = net(xa)
        gx = mt.autograd.grad(y, [xa])[0]
        assert all(float(np.abs(p.grad().asnumpy()).sum()) == 0
                   for p in net.collect_params().values())
        with mt.autograd.record():
            y2 = net(xa)
        y2.backward()
        np.testing.assert_allclose(gx.asnumpy(), xa.grad.asnumpy(), **TOL)


def test_batchnorm_running_stats():
    x = np.random.RandomState(0).normal(2.0, 3.0, (16, 4, 5, 5)) \
        .astype(np.float32)

    def run(pkg, hybridize):
        layer = pkg.gluon.nn.BatchNorm(in_channels=4, prefix="bn_")
        layer.initialize(ctx=pkg.cpu())
        if hybridize:
            layer.hybridize()
        xa = pkg.nd.array(x, ctx=pkg.cpu())
        with pkg.autograd.record():
            y = layer(xa)
        y1, y2 = layer(xa).asnumpy(), layer(xa).asnumpy()
        np.testing.assert_array_equal(y1, y2)
        return [y.asnumpy(), layer.running_mean.data().asnumpy(),
                layer.running_var.data().asnumpy(), y1]
    want = run(mx, False)
    assert np.abs(want[1]).sum() > 0
    for hyb in (False, True):
        with mt.cpu():
            got = run(mt, hyb)
        close(got, want)


def test_dropout_modes():
    for hyb in (False, True):
        with mt.cpu():
            layer = mt.gluon.nn.Dropout(0.5)
            layer.initialize(ctx=mt.cpu())
            if hyb:
                layer.hybridize()
            x = mt.nd.ones((100, 100))
            np.testing.assert_allclose(layer(x).asnumpy(), x.asnumpy())
            with mt.autograd.record():
                y = layer(x)
            frac_zero = (y.asnumpy() == 0).mean()
            assert 0.3 < frac_zero < 0.7
            kept = y.asnumpy()[y.asnumpy() != 0]
            np.testing.assert_allclose(kept, 2.0)


def test_trainer_convergence():
    w_true = np.array([[1.0, -2.0, 3.0, 0.5]], dtype=np.float32)
    xs = [np.random.RandomState(i).rand(16, 4).astype(np.float32)
          for i in range(200)]

    def train(pkg):
        net = pkg.gluon.nn.Dense(1, in_units=4, use_bias=False,
                                 prefix="dense_")
        net.initialize(pkg.init.Zero(), ctx=pkg.cpu())
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.5})
        loss_fn = pkg.gluon.loss.L2Loss()
        for x in xs:
            xa = pkg.nd.array(x, ctx=pkg.cpu())
            ya = pkg.nd.array(x @ w_true.T, ctx=pkg.cpu())
            with pkg.autograd.record():
                loss = loss_fn(net(xa), ya)
            loss.backward()
            trainer.step(16)
        return [net.weight.data().asnumpy()]
    got, want = run_both(train)
    close(got, want, dict(rtol=1e-4, atol=1e-5))
    np.testing.assert_allclose(got[0], w_true, atol=1e-2)


def test_trainer_states_and_learning_rate(tmp_path):
    with mt.cpu():
        net = mt.gluon.nn.Dense(2, in_units=3, prefix="d_")
        net.initialize(ctx=mt.cpu())
        tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1, "momentum": 0.9})
        with mt.autograd.record():
            y = net(mt.nd.ones((2, 3)))
        y.backward()
        tr.step(2)
        assert tr.learning_rate == 0.1
        tr.set_learning_rate(0.05)
        assert tr.learning_rate == 0.05
        fname = str(tmp_path / "t.states")
        tr.save_states(fname)
        mom = tr._updaters[0].states[0].asnumpy()
        tr2 = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9})
        tr2.load_states(fname)
        np.testing.assert_array_equal(
            tr2._updaters[0].states[0].asnumpy(), mom)


def test_save_load_params_both_ways(tmp_path):
    def build(pkg):
        net = pkg.gluon.nn.HybridSequential(prefix="model_")
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(8, in_units=4))
            net.add(pkg.gluon.nn.Dense(2, in_units=8))
        return net
    x = np.ones((1, 4), np.float32)
    mfile, tfile = str(tmp_path / "m.params"), str(tmp_path / "t.params")
    m = build(mx)
    m.initialize()
    y0 = m(mx.nd.array(x)).asnumpy()
    m.save_params(mfile)
    with mt.cpu():
        t = build(mt)
        t.load_params(mfile, ctx=mt.cpu())
        np.testing.assert_allclose(t(mt.nd.array(x)).asnumpy(), y0,
                                   rtol=1e-6)
        t2 = build(mt)
        t2.initialize(ctx=mt.cpu())
        y1 = t2(mt.nd.array(x)).asnumpy()
        t2.save_params(tfile)
    m2 = build(mx)
    m2.load_params(tfile)
    np.testing.assert_allclose(m2(mx.nd.array(x)).asnumpy(), y1, rtol=1e-6)


LOSSES = {
    # name: (constructor kwargs, label kind)
    "L2Loss": ({}, "dense"),
    "L1Loss": ({}, "dense"),
    "SigmoidBinaryCrossEntropyLoss": ({}, "binary"),
    "SigmoidBCELoss-from_sigmoid": ({"from_sigmoid": True}, "binary"),
    "SoftmaxCrossEntropyLoss": ({}, "sparse"),
    "SoftmaxCELoss-dense": ({"sparse_label": False}, "dist"),
    "SoftmaxCrossEntropyLoss-axis1": ({"axis": 1}, "sparse1"),
    "KLDivLoss": ({"from_logits": False}, "dist"),
    "HuberLoss": ({"rho": 0.7}, "dense"),
    "HingeLoss": ({}, "signed"),
    "SquaredHingeLoss": ({}, "signed"),
    "LogisticLoss": ({}, "signed"),
    "LogisticLoss-binary": ({"label_format": "binary"}, "binary"),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
@pytest.mark.parametrize("weighted", [False, True])
def test_losses(name, weighted):
    kwargs, kind = LOSSES[name]
    cls = name.split("-")[0]
    rs = np.random.RandomState(len(name))
    pred = rs.randn(6, 5).astype(np.float32)
    if "from_sigmoid" in kwargs:
        pred = 1 / (1 + np.exp(-pred))
    label = {"dense": lambda: rs.randn(6, 5),
             "binary": lambda: rs.randint(0, 2, (6, 5)),
             "signed": lambda: rs.choice([-1.0, 1.0], (6, 5)),
             "sparse": lambda: rs.randint(0, 5, (6,)),
             "sparse1": lambda: rs.randint(0, 6, (5,)),
             "dist": lambda: rs.dirichlet(np.ones(5), 6)}[kind]() \
        .astype(np.float32)
    if kind == "sparse1":
        pred = pred.T.copy()
    weight = rs.rand(pred.shape[0], 1).astype(np.float32)

    def case(pkg):
        loss = getattr(pkg.gluon.loss, cls)(**kwargs)
        p = pkg.nd.array(pred, ctx=pkg.cpu())
        p.attach_grad()
        args = [p, pkg.nd.array(label, ctx=pkg.cpu())]
        if weighted:
            args.append(pkg.nd.array(weight, ctx=pkg.cpu()))
        with pkg.autograd.record():
            out = loss(*args)
        out.backward()
        return [out.asnumpy(), p.grad.asnumpy()]
    got, want = run_both(case)
    close(got, want)


def test_triplet_loss_and_manual_values():
    rs = np.random.RandomState(0)
    a, b, c = (rs.randn(4, 3).astype(np.float32) for _ in range(3))
    got, want = run_both(lambda pkg: [pkg.gluon.loss.TripletLoss()(
        *[pkg.nd.array(v, ctx=pkg.cpu()) for v in (a, b, c)]).asnumpy()])
    close(got, want)
    pred = np.array([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]], np.float32)
    with mt.cpu():
        loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()(
            mt.nd.array(pred), mt.nd.array([2, 1])).asnumpy()
    lse = np.log(np.exp(pred).sum(1))
    np.testing.assert_allclose(loss, [lse[0] - pred[0, 2],
                                      lse[1] - pred[1, 1]], rtol=1e-5)


CONVS = {
    "Conv1D": (lambda nn: nn.Conv1D(8, 3), (2, 3, 16)),
    "Conv2D": (lambda nn: nn.Conv2D(8, 3, padding=1), (2, 3, 16, 16)),
    "Conv2D-strided-grouped": (lambda nn: nn.Conv2D(
        6, (3, 2), strides=2, padding=(1, 0), groups=3, activation="relu"),
        (2, 3, 9, 8)),
    "Conv2D-nobias-dilated": (lambda nn: nn.Conv2D(
        4, 3, dilation=2, use_bias=False), (1, 2, 9, 9)),
    "Conv3D": (lambda nn: nn.Conv3D(4, 2), (1, 2, 5, 5, 5)),
    "MaxPool1D": (lambda nn: nn.MaxPool1D(2), (2, 3, 9)),
    "MaxPool2D": (lambda nn: nn.MaxPool2D(2), (2, 3, 16, 16)),
    "MaxPool2D-ceil": (lambda nn: nn.MaxPool2D(3, 2, 1, ceil_mode=True),
                       (2, 3, 10, 10)),
    "MaxPool3D": (lambda nn: nn.MaxPool3D(2), (1, 2, 4, 4, 4)),
    "AvgPool1D": (lambda nn: nn.AvgPool1D(3, 2, 1), (2, 3, 9)),
    "AvgPool2D": (lambda nn: nn.AvgPool2D(3, 1, 1,
                                          count_include_pad=False),
                  (2, 3, 7, 7)),
    "AvgPool3D": (lambda nn: nn.AvgPool3D(2), (1, 2, 4, 4, 4)),
    "GlobalMaxPool1D": (lambda nn: nn.GlobalMaxPool1D(), (2, 3, 9)),
    "GlobalMaxPool2D": (lambda nn: nn.GlobalMaxPool2D(), (2, 3, 6, 7)),
    "GlobalAvgPool2D": (lambda nn: nn.GlobalAvgPool2D(), (2, 3, 16, 16)),
    "GlobalAvgPool3D": (lambda nn: nn.GlobalAvgPool3D(), (1, 2, 3, 4, 5)),
}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_conv_layers(name):
    make, shape = CONVS[name]
    x = np.random.RandomState(len(name)).rand(*shape).astype(np.float32)
    m, t = both(lambda pkg: make(pkg.gluon.nn), [x])
    with mt.cpu():
        got = forward_backward(mt, t, [x])
        t.hybridize()
        hyb = forward_backward(mt, t, [x])
    want = forward_backward(mx, m, [x])
    close(got, want)
    close(hyb, want)


ACTIVATIONS = {
    "relu": lambda nn: nn.Activation("relu"),
    "softrelu": lambda nn: nn.Activation("softrelu"),
    "LeakyReLU": lambda nn: nn.LeakyReLU(0.1),
    "PReLU": lambda nn: nn.PReLU(),
    "ELU": lambda nn: nn.ELU(0.7),
    "SELU": lambda nn: nn.SELU(),
    "Swish": lambda nn: nn.Swish(1.5),
    "Flatten": lambda nn: nn.Flatten(),
    "HybridLambda": lambda nn: nn.HybridLambda("tanh"),
    "Lambda": lambda nn: nn.Lambda(lambda x: x * 2),
}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_activations(name):
    x = np.random.RandomState(0).randn(3, 4, 2).astype(np.float32)
    m, t = both(lambda pkg: ACTIVATIONS[name](pkg.gluon.nn), [x])
    with mt.cpu():
        got = forward_backward(mt, t, [x])
    close(got, forward_backward(mx, m, [x]))


def test_model_zoo_smoke():
    """resnet18_v1 (thumbnail) and mobilenet0.25 forward as mxtpu's do from
    the same weights; every family constructs with mxtpu's parameter
    names."""
    for name, shape, kw in (("resnet18_v1", (1, 3, 32, 32),
                             {"classes": 10, "thumbnail": True}),
                            ("mobilenet0.25", (1, 3, 32, 32),
                             {"classes": 7})):
        x = np.random.RandomState(1).rand(*shape).astype(np.float32)
        m, t = both(lambda pkg: pkg.gluon.model_zoo.vision.get_model(
            name, prefix="zoo_", **kw), [x])
        with mt.cpu():
            got = t(mt.nd.array(x)).asnumpy()
        close([got], [m(mx.nd.array(x)).asnumpy()])
    for name in ("resnet50_v2", "densenet121", "squeezenet1.0",
                 "inceptionv3", "alexnet"):
        with mt.cpu():
            t = mt.gluon.model_zoo.vision.get_model(name, prefix="z_")
        m = mx.gluon.model_zoo.vision.get_model(name, prefix="z_")
        assert list(t.collect_params().keys()) == \
            list(m.collect_params().keys()), name
    with pytest.raises(ValueError):
        mt.gluon.model_zoo.vision.get_model("resnet19_v1")


@pytest.mark.parametrize("name,hw", [("resnet18_v2", 32),
                                     ("vgg11_bn", 32)])
def test_model_zoo_families_forward(name, hw):
    x = np.random.RandomState(2).rand(1, 3, hw, hw).astype(np.float32)
    m, t = both(lambda pkg: pkg.gluon.model_zoo.vision.get_model(
        name, classes=5, prefix="fam_"), [x])
    with mt.cpu():
        got = t(mt.nd.array(x)).asnumpy()
    close([got], [m(mx.nd.array(x)).asnumpy()], dict(rtol=1e-4, atol=1e-5))


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader(workers):
    rs = np.random.RandomState(0)
    X = rs.rand(37, 5).astype(np.float32)
    y = np.arange(37).astype(np.float32)
    ids = np.arange(37) * 3            # int64: int32 batches, as nd.array

    def batches(pkg, **kw):
        np.random.seed(7)
        ds = pkg.gluon.data.ArrayDataset(X, y, ids)
        loader = pkg.gluon.data.DataLoader(ds, batch_size=8,
                                           num_workers=workers, **kw)
        return [[a.asnumpy() for a in b] for b in loader], len(loader)
    for kw in ({}, {"shuffle": True}, {"last_batch": "discard"},
               {"last_batch": "rollover"}):
        with mt.cpu():
            got, n = batches(mt, **kw)
        want, wn = batches(mx, **kw)
        assert n == wn and len(got) == len(want)
        for g, w in zip(got, want):
            assert [a.dtype for a in g] == [a.dtype for a in w] == \
                [np.float32, np.float32, np.int32]
            close(g, w, dict(rtol=0, atol=0))
    with mt.cpu():
        ds = mt.gluon.data.ArrayDataset(X, y).transform_first(
            lambda a: a * 2)
        assert np.allclose(ds[3][0], X[3] * 2) and ds[3][1] == 3
        first = mt.gluon.data.SimpleDataset(list(range(5))).transform(
            lambda v: v + 1, lazy=False)
        assert [first[i] for i in range(5)] == [1, 2, 3, 4, 5]
        nds = mt.gluon.data.ArrayDataset(mt.nd.array(X), y)
        assert len(nds) == 37
        assert next(iter(mt.gluon.data.DataLoader(nds, 4)))[0].shape == \
            (4, 5)


def test_split_and_load():
    def case(pkg):
        data = pkg.nd.arange(0, 80, ctx=pkg.cpu()).reshape((8, 10))
        s0 = pkg.gluon.utils.split_data(data, 4)
        s1 = pkg.gluon.utils.split_data(data, 2, batch_axis=1)
        s2 = pkg.gluon.utils.split_data(data, 3, even_split=False)
        loaded = pkg.gluon.utils.split_and_load(data.asnumpy(), [pkg.cpu()])
        return [s.asnumpy() for s in s0 + s1 + s2 + loaded]
    got, want = run_both(case)
    close(got, want, dict(rtol=0, atol=0))
    with pytest.raises(ValueError):
        with mt.cpu():
            mt.gluon.utils.split_data(mt.nd.ones((5, 2)), 2)


def test_clip_global_norm():
    def case(pkg):
        x1 = pkg.nd.ones((3,), ctx=pkg.cpu()) * 3.0
        x2 = pkg.nd.ones((4,), ctx=pkg.cpu()) * 4.0
        norm = pkg.gluon.utils.clip_global_norm([x1, x2], 1.0)
        return [np.float32(norm), x1.asnumpy(), x2.asnumpy()]
    got, want = run_both(case)
    close(got, want)
    np.testing.assert_allclose(
        np.sqrt((got[1] ** 2).sum() + (got[2] ** 2).sum()), 1.0, rtol=1e-3)
    with pytest.raises(RuntimeError):
        mt.gluon.utils.download("http://example.invalid/x")


def test_symbol_block_and_export(tmp_path):
    x = np.random.RandomState(0).rand(2, 3).astype(np.float32)

    def build(pkg):
        data = pkg.sym.var("data")
        out = pkg.sym.FullyConnected(data, name="fc1", num_hidden=6)
        out = pkg.sym.Activation(out, act_type="relu")
        return pkg.gluon.SymbolBlock(out, data)
    m, t = both(build, [x])
    assert list(t.collect_params().keys()) == ["fc1_weight", "fc1_bias"]
    with mt.cpu():
        got = forward_backward(mt, t, [x])
        # mxtpu's SymbolBlock evaluates its graph off the tape (no
        # gradient reaches its inputs or weights); the port's records it,
        # and its gradients are those of the same Dense layer
        dense = mt.gluon.nn.Dense(6, activation="relu", in_units=3,
                                  prefix="fc1_")
        dense.initialize(ctx=mt.cpu())
        dense.collect_params().load_dict(
            {k: v.data() for k, v in t.collect_params().items()})
        close(got, forward_backward(mt, dense, [x]))
    close(got[:1], [m(mx.nd.array(x)).asnumpy()])
    # a hybridized net exported by the port loads in a port SymbolBlock
    # and in mxtpu's
    with mt.cpu():
        net = mlp(mt, prefix="ex_")
        net.add(mt.gluon.nn.BatchNorm())
        net.initialize(ctx=mt.cpu())
        net.hybridize()
        y = net(mt.nd.array(x)).asnumpy()
        path = str(tmp_path / "net")
        net.export(path)
        block = mt.gluon.SymbolBlock.imports(path + "-symbol.json", "data",
                                             path + "-0000.params",
                                             ctx=mt.cpu())
        np.testing.assert_allclose(block(mt.nd.array(x)).asnumpy(), y,
                                   **TOL)
    # (mxtpu's SymbolBlock feeds no aux states, so it imports a net
    # without BatchNorm)
    with mt.cpu():
        net = mlp(mt, prefix="ex2_")
        net.initialize(ctx=mt.cpu())
        net.hybridize()
        y = net(mt.nd.array(x)).asnumpy()
        net.export(path, epoch=1)
    mblock = mx.gluon.SymbolBlock.imports(path + "-symbol.json", "data",
                                          path + "-0001.params")
    np.testing.assert_allclose(mblock(mx.nd.array(x)).asnumpy(), y, **TOL)


def test_embedding_block():
    idx = np.array([1, 2, 3], np.float32)

    def case(pkg):
        layer = pkg.gluon.nn.Embedding(10, 4, prefix="emb_")
        layer.initialize(pkg.init.Uniform(), ctx=pkg.cpu())
        return layer
    m = case(mx)
    m(mx.nd.array(idx))
    with mt.cpu():
        t = case(mt)
        carry(m, t)

    def grads(pkg, layer):
        with pkg.autograd.record():
            out = layer(pkg.nd.array(idx, ctx=pkg.cpu())).sum()
        out.backward()
        return [out.asnumpy(), layer.weight.grad().asnumpy()]
    with mt.cpu():
        got = grads(mt, t)
    want = grads(mx, m)
    close(got, want)
    g = got[1]
    assert np.abs(g[1:4]).sum() > 0 and np.abs(g[5:]).sum() == 0


def test_hybridize_shape_change_and_invalidation():
    """A program a signature (shape, train flag, input grad); set_data,
    cast and hybridize() drop the programs; hybridize(active=False) is
    eager; the counts accumulate."""
    with mt.cpu():
        net = mt.gluon.nn.Dense(4, in_units=3, prefix="d_")
        net.initialize(ctx=mt.cpu())
        net.hybridize()
        assert net(mt.nd.ones((2, 3))).shape == (2, 4)
        assert net(mt.nd.ones((5, 3))).shape == (5, 4)
        assert net(mt.nd.ones((5, 3))).shape == (5, 4)
        with mt.autograd.record():
            net(mt.nd.ones((5, 3)))
        with mt.autograd.train_mode():
            net(mt.nd.ones((5, 3)))
        s = net.cache_stats()
        assert (s["programs"], s["compiles"], s["hits"]) == (4, 4, 1)
        net.weight.set_data(mt.nd.zeros((4, 3)))
        y = net(mt.nd.ones((2, 3))).asnumpy()
        np.testing.assert_allclose(y, np.broadcast_to(
            net.bias.data().asnumpy(), (2, 4)))
        s = net.cache_stats()
        assert (s["programs"], s["compiles"]) == (1, 5)
        net.hybridize(active=False)
        net(mt.nd.ones((2, 3)))
        assert net.cache_stats()["compiles"] == 5
        net.hybridize()
        net.cast("float64")
        out = net(mt.nd.ones((2, 3), dtype="float64"))
        assert out.dtype == net.weight.data().dtype
        # remat is ported: hybridize(remat=True) drops the programs too,
        # and the rebuilt one under record() rematerializes
        net.hybridize(remat=True)
        assert net.cache_stats()["programs"] == 0
        with mt.autograd.record():
            net(mt.nd.ones((2, 3), dtype="float64"))
        assert [p.remat for p in net.programs()] == [True]


def test_refused_capture_runs_uncaptured_and_warns_once():
    """Where the card refuses a signature's capture (a custom op whose
    body reads the card: CaptureRefused), the program warns once, counts
    a fallback and runs that signature uncaptured from then on; its
    results are the eager ones. (Simulated on the CPU: the program is made
    to take the card's path and its capture to refuse.)"""
    rs = np.random.RandomState(6)
    x, label = rs.rand(4, 5).astype(np.float32), np.array([0., 1, 2, 1])
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()

    def steps(net, n):
        got = []
        for _ in range(n):
            with mt.autograd.record():
                loss = loss_fn(net(mt.nd.array(x)), mt.nd.array(label))
            loss.backward()
            got.append([loss.asnumpy()] + [
                p.grad().asnumpy() for p in net.collect_params().values()])
        return got

    def refuse(tensors):
        raise mt.base.CaptureRefused("softmax_host", "a host read")
    with mt.cpu():
        nets = {}
        for hyb in (False, True):
            nets[hyb] = mlp(mt, prefix="ref_", out=3)
            nets[hyb].initialize(mt.init.One(), ctx=mt.cpu())
        eager = steps(nets[False], 3)
        net = nets[True]
        net.hybridize()
        got = steps(net, 1)
        prog = net.programs()[0]
        prog.device = torch.device("cuda")
        prog._capture = refuse
        with pytest.warns(UserWarning, match="a host read"):
            got += steps(net, 2)
        assert net.cache_stats()["fallbacks"] == 1
        assert net.cache_stats()["captures"] == 0
    for a, b in zip(got, eager):
        close(a, b, dict(rtol=0, atol=0))


class _Replayable:
    def __init__(self, fn):
        self.replay = fn


def emulate_capture(prog):
    """A stand-in on the CPU for a program's capture on the card. As the
    card's graphs do, the 'forward graph' evaluates the static inputs
    into the static outputs and keeps one set of activations, and the
    'backward graph' differentiates whatever activations the last forward
    replay left, into static gradients."""
    def capture(tensors):
        params = lambda: [p.data().data for p in prog.params]   # noqa: E731
        prog.static_in = [t.detach().clone() for t in tensors[:prog.n_in]]
        acts = dict(zip(("outs", "leaves"),
                        prog._evaluate(prog.static_in + params())))
        prog.static_out = [o.detach().clone() for o in acts["outs"]]
        prog.static_gout = [torch.zeros_like(o) if o.requires_grad
                            else None for o in acts["outs"]]
        grads = [torch.zeros_like(leaf) if leaf.requires_grad else None
                 for leaf in acts["leaves"]]

        def forward():
            acts["outs"], acts["leaves"] = prog._evaluate(
                prog.static_in + params())
            for s, o in zip(prog.static_out, acts["outs"]):
                s.copy_(o.detach())

        def backward():
            got = prog._grads(acts["outs"], acts["leaves"], prog.static_gout)
            for s, g in zip(grads, got):
                if s is not None:
                    s.copy_(g) if g is not None else s.zero_()
        prog.fwd = _Replayable(forward)
        prog.bwd = (_Replayable(backward), grads)
        prog.captures += 1
        prog.device = torch.device("cpu")
    prog.device = torch.device("cuda")
    prog._capture = capture


@pytest.mark.parametrize("case", ["shared_weights", "retained_graph"])
def test_busy_captured_program_runs_uncaptured(case):
    """A captured program's graphs hold one set of activations. A call
    made while the backward of the replayed call before it may still run
    evaluates the traced graph uncaptured, and is counted: a shared-weight
    net called three times under one record() (a triplet loss), or a
    call after a backward that kept its graph, before that graph's second
    backward. Gradients, outputs and updated weights equal the eager
    block's (TOL). (The capture is emulated on the CPU: emulate_capture.)"""
    rs = np.random.RandomState(9)
    xs = [rs.rand(4, 5).astype(np.float32) for _ in range(3)]

    def steps(net, n):
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.1})
        a, p, q = [mt.nd.array(x) for x in xs]
        got = []
        for _ in range(n):
            if case == "shared_weights":
                with mt.autograd.record():
                    ya, yp, yq = net(a), net(p), net(q)
                    loss = ((ya - yp) ** 2).sum() - ((ya - yq) ** 2).sum()
                loss.backward()
                outs = [ya, yp, yq]
            else:
                with mt.autograd.record():
                    ya = net(a)
                    loss = (ya ** 2).sum()
                loss.backward(retain_graph=True)
                with mt.autograd.record():
                    yp = net(p)
                loss.backward()
                outs = [ya, yp]
            got.append([o.asnumpy() for o in outs] + [
                g.grad().asnumpy() for g in net.collect_params().values()])
            trainer.step(4)
        return got + [[g.data().asnumpy()
                       for g in net.collect_params().values()]]

    with mt.cpu():
        mt.random.seed(0)
        nets = {}
        for hyb in (False, True):
            nets[hyb] = mlp(mt, prefix="busy_", out=3)
            nets[hyb].initialize(mt.init.Xavier(), ctx=mt.cpu())
            nets[hyb](mt.nd.array(xs[0]))
        nets[True].collect_params().load_dict(
            {k: v.data().asnumpy()
             for k, v in nets[False].collect_params().items()},
            ctx=mt.cpu())
        eager = steps(nets[False], 3)
        net = nets[True]
        net.hybridize()
        got = steps(net, 1)[:-1]
        prog = net.programs()[0]
        emulate_capture(prog)
        got += steps(net, 2)[:-1]
        stats = net.cache_stats()
    calls = 3 if case == "shared_weights" else 2
    # the second step captures and replays its first call, the third
    # replays its first; every other call of theirs finds the graphs busy
    assert (stats["captures"], stats["replays"], stats["uncaptured"]) == \
        (1, 2, 2 * (calls - 1)), stats
    got.append([g.data().asnumpy() for g in net.collect_params().values()])
    for g, w in zip(got, eager):
        close(g, w)


def test_hybridized_nested_outputs_and_deferred_init():
    """A hybridized block returning a nest of outputs, with deferred
    shapes inferred at its first call, as mxtpu's."""
    def build(pkg):
        class Net(pkg.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.a = pkg.gluon.nn.Dense(3)
                    self.b = pkg.gluon.nn.Dense(2)

            def hybrid_forward(self, F, x, y):
                h = self.a(x)
                return h, [self.b(h) + y, F.relu(h)]
        return Net(prefix="two_")
    rs = np.random.RandomState(5)
    x, y = rs.rand(4, 6).astype(np.float32), rs.rand(4, 2).astype(np.float32)
    m, t = both(build, [x, y])
    want = m(mx.nd.array(x), mx.nd.array(y))
    with mt.cpu():
        t.hybridize()
        got = t(mt.nd.array(x), mt.nd.array(y))
        assert isinstance(got, (list, tuple)) and isinstance(got[1], list)
        flat = [got[0].asnumpy()] + [g.asnumpy() for g in got[1]]
    close(flat, [want[0].asnumpy()] + [w.asnumpy() for w in want[1]])


def test_block_hooks_collect_select_summary(capsys):
    with mt.cpu():
        net = mlp(mt, prefix="h_")
        net.initialize(ctx=mt.cpu())
        seen = []
        net.register_forward_pre_hook(lambda b, a: seen.append("pre"))
        net.register_forward_hook(lambda b, a, o: seen.append(o.shape))
        net(mt.nd.ones((2, 5)))
        assert seen == ["pre", (2, 8)]
        assert list(net.collect_params(".*bias").keys()) == \
            ["h_dense0_bias", "h_dense1_bias"]
        net.summary()
        assert "Total params: %d" % (32 * 5 + 32 + 8 * 32 + 8) in \
            capsys.readouterr().out
        assert len(net) == 2 and isinstance(net[1], mt.gluon.nn.Dense)
        seq = mt.gluon.nn.Sequential(prefix="s_")
        seq.add(mt.gluon.nn.Dense(2, in_units=3))
        seq.initialize(ctx=mt.cpu())
        assert seq(mt.nd.ones((1, 3))).shape == (1, 2)
