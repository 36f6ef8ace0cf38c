"""The port's Module.fit path against mxtpu's, on the CPU: initializers,
the LeNet ops (Convolution, Pooling, Flatten), the Executor, Module.fit
of both examples (chip_smoke.py's mlp_fit and lenet_fit, the calls of
example/numpy-ops/custom_softmax.py and of
example/image-classification/train_mnist.py --network lenet) and
checkpoints crossing between the packages.

Tolerances: the ops and a forward / backward agree within 1e-5 of a
value or of the largest value compared (float32 sums of up to 800
products in another order: an element whose terms cancel keeps an error
relative to the terms, not to itself); one
epoch of Module.fit from the same weights and batches within 1e-6 of a
weight (SGD moves weights by lr / batch times the gradients, so the sums'
reordering reaches the weights scaled down; measured 3e-8); a checkpoint
crosses bit for bit.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIT_TOL = dict(rtol=1e-5, atol=1e-6)
FIT_SAMPLES = 300           # a padded last batch at 64 and at 128


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
def sweep():
    # the SPECS of tests/test_op_sweep.py (inputs and params per op)
    return _load("op_sweep_specs", ROOT / "tests" / "test_op_sweep.py")


def _close(got, want, **kw):
    """Within 1e-5 of each value or of the largest one."""
    np.testing.assert_allclose(
        got, want, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(want).max())),
        **kw)


def _cpu_arrays(pkg, arrays):
    return [pkg.nd.array(a, ctx=pkg.cpu()) for a in arrays]


# -- initializers ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(20, 1, 5, 5), (50, 20, 5, 5),
                                   (500, 800), (10, 500)])
def test_xavier_follows_mxtpus_rule(shape):
    """LeNet's conv and FC weights: the bound by fan and hw_scale, draws
    that stay within it and reach it (uniform) or have it as deviation
    (gaussian), as mxtpu's draws do."""
    hw = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
    fan_in, fan_out = shape[1] * hw, shape[0] * hw
    ref = mx.nd.zeros(shape)
    mx.init.Xavier()("w_weight", ref)
    ref = ref.asnumpy()
    mt.random.seed(1)
    for factor_type, factor in (("avg", (fan_in + fan_out) / 2),
                                ("in", fan_in), ("out", fan_out)):
        bound = np.sqrt(3.0 / factor)
        for rnd in ("uniform", "gaussian"):
            init = mt.init.Xavier(rnd_type=rnd, factor_type=factor_type)
            assert init.scale("w", shape) == pytest.approx(bound,
                                                           rel=1e-12)
            arr = mt.nd.zeros(shape, ctx=mt.cpu())
            init("w_weight", arr)
            w = arr.asnumpy()
            if rnd == "gaussian":
                assert w.std() == pytest.approx(bound, rel=0.15)
                continue
            draws = (w, ref) if factor_type == "avg" else (w,)
            for x in draws:     # within the bound, and reaching it
                assert np.abs(x).max() <= bound
                assert np.abs(x).max() > 0.9 * bound


def test_uniform_normal_and_name_dispatch():
    mt.random.seed(3)
    big = mt.nd.zeros((400, 100), ctx=mt.cpu())
    mt.init.Uniform(0.07)("fc_weight", big)
    w = big.asnumpy()
    assert w.shape == (400, 100) and np.abs(w).max() <= 0.07
    assert abs(w.mean()) < 0.002 and np.abs(w).max() > 0.069
    mt.init.Normal(0.5)("fc_weight", big)
    assert big.asnumpy().std() == pytest.approx(0.5, rel=0.02)
    rules = {"fc_bias": 0.0, "bn_gamma": 1.0, "bn_beta": 0.0,
             "bn_moving_mean": 0.0, "bn_moving_var": 1.0}
    for name, value in rules.items():
        arr = mt.nd.full((3,), 9.0, ctx=mt.cpu())
        mt.init.Xavier()(name, arr)
        assert (arr.asnumpy() == value).all(), name
    with pytest.raises(ValueError):
        mt.init.Xavier()("mystery", mt.nd.zeros((3,), ctx=mt.cpu()))
    with pytest.raises(ValueError):
        mt.init.Xavier()("vec_weight", mt.nd.zeros((3,), ctx=mt.cpu()))
    # a variable's own init attribute wins over the name rule
    sym = mt.sym.var("w_weight", init=mt.init.Constant(2.5))
    desc = mt.init.InitDesc("w_weight", sym.attr_dict()["w_weight"])
    arr = mt.nd.zeros((2, 2), ctx=mt.cpu())
    mt.init.Uniform()(desc, arr)
    assert (arr.asnumpy() == 2.5).all()


def test_one_seed_gives_the_same_draws():
    def draw():
        mt.random.seed(11)
        arr = mt.nd.zeros((4, 5), ctx=mt.cpu())
        mt.init.Xavier()("x_weight", arr)
        return (arr.asnumpy(),
                mt.random.uniform(-1, 1, (3,), ctx=mt.cpu()).asnumpy(),
                mt.random.normal(0, 2, (3,), ctx=mt.cpu()).asnumpy())
    first, again = draw(), draw()
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    assert (np.abs(first[1]) <= 1).all()


# -- ops ---------------------------------------------------------------------

def _conv_case(rng, x, w, b, **params):
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in (x, w) + ((b,) if b else ())]
    return "Convolution", arrays, params


def _pool_case(rng, x, **params):
    return "Pooling", [rng.standard_normal(x).astype(np.float32)], params


def _op_cases():
    rng = np.random.RandomState(5)
    lenet_pool = dict(pool_type="max", kernel=(2, 2), stride=(2, 2))
    return {
        "lenet_conv1": _conv_case(rng, (4, 1, 28, 28), (20, 1, 5, 5), (20,),
                                  kernel=(5, 5), num_filter=20),
        "lenet_conv2": _conv_case(rng, (4, 20, 12, 12), (50, 20, 5, 5),
                                  (50,), kernel=(5, 5), num_filter=50),
        "conv_group_dilate_nobias": _conv_case(
            rng, (2, 4, 9, 9), (6, 2, 3, 3), None, kernel=(3, 3),
            num_filter=6, num_group=2, dilate=(2, 2), no_bias=True),
        "conv1d_pad": _conv_case(rng, (2, 3, 9), (4, 3, 3), (4,),
                                 kernel=(3,), num_filter=4, pad=(1,)),
        "lenet_pool1": _pool_case(rng, (4, 20, 24, 24), **lenet_pool),
        "lenet_pool2": _pool_case(rng, (4, 50, 8, 8), **lenet_pool),
        "max_overlap_ties": ("Pooling", [np.array(
            [[[[1, 1, 0, 2], [1, 0, 2, 2], [3, 3, 3, 0], [3, 3, 0, 0]]]],
            np.float32)], dict(pool_type="max", kernel=(2, 2))),
        "max_full_pad": _pool_case(rng, (2, 3, 7, 7), pool_type="max",
                                   kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                   pooling_convention="full"),
        "avg_full": _pool_case(rng, (2, 3, 8, 8), pool_type="avg",
                               kernel=(3, 3), stride=(2, 2),
                               pooling_convention="full"),
        "avg_pad_include": _pool_case(rng, (2, 3, 7, 7), pool_type="avg",
                                      kernel=(3, 3), stride=(2, 2),
                                      pad=(1, 1)),
        "avg_pad_exclude": _pool_case(rng, (2, 3, 7, 7), pool_type="avg",
                                      kernel=(3, 3), stride=(2, 2),
                                      pad=(1, 1), count_include_pad=False),
        "sum": _pool_case(rng, (2, 3, 6, 6), pool_type="sum",
                          kernel=(2, 3), stride=(2, 1)),
        "global_avg": _pool_case(rng, (2, 5, 6, 6), pool_type="avg",
                                 global_pool=True, kernel=(1, 1)),
        "max1d": _pool_case(rng, (2, 3, 11), pool_type="max", kernel=(3,),
                            stride=(2,)),
        "flatten": ("Flatten", [rng.standard_normal((4, 50, 4, 4))
                                .astype(np.float32)], {}),
    }


def _op_grads(pkg, name, arrays, params, head):
    """(output, gradients of sum(head * output)) through ``pkg``'s
    imperative autograd."""
    xs = _cpu_arrays(pkg, arrays)
    for x in xs:
        x.attach_grad()
    with pkg.autograd.record():
        out = getattr(pkg.nd, name)(*xs, **params)
    out.backward(pkg.nd.array(head(out.shape), ctx=pkg.cpu()))
    return out.asnumpy(), [x.grad.asnumpy() for x in xs]


def _check_op(name, arrays, params):
    rng = np.random.RandomState(9)
    cache = {}

    def head(shape):
        if shape not in cache:
            cache[shape] = rng.standard_normal(shape).astype(np.float32)
        return cache[shape]
    got, got_g = _op_grads(mt, name, arrays, params, head)
    want, want_g = _op_grads(mx, name, arrays, params, head)
    assert got.shape == want.shape
    _close(got, want)
    for g, w in zip(got_g, want_g):
        _close(g, w)


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_lenet_ops_match_mxtpu(case):
    _check_op(*_op_cases()[case])


@pytest.mark.parametrize("name", ["Convolution", "Pooling"])
def test_op_sweep_specs_match_mxtpu(sweep, name):
    spec = sweep.SPECS[name]
    arrays = spec.args(np.random.RandomState(sweep._seed(name)))
    _check_op(name, arrays, spec.params)


def test_convolution_shape_hint_and_no_bias():
    net = mt.sym.Convolution(mt.sym.var("data"), kernel=(3, 3),
                             num_filter=8, num_group=2, name="c")
    args, outs, _ = net.infer_shape(data=(2, 4, 9, 9))
    assert dict(zip(net.list_arguments(), args)) == {
        "data": (2, 4, 9, 9), "c_weight": (8, 2, 3, 3), "c_bias": (8,)}
    assert outs == [(2, 8, 7, 7)]
    bare = mt.sym.Convolution(mt.sym.var("data"), kernel=(3, 3),
                              num_filter=8, no_bias=True, name="c")
    assert bare.list_arguments() == ["data", "c_weight"]


# -- executor ----------------------------------------------------------------

def _executor_run(pkg, sym, params, feed, grad_req="write", times=1):
    exe = sym.simple_bind(pkg.cpu(), grad_req=grad_req,
                          **{k: v.shape for k, v in feed.items()})
    for k, v in params.items():
        exe.arg_dict[k][:] = v
    for _ in range(times):
        outs = exe.forward(is_train=True, **{
            k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in feed.items()})
        exe.backward()
    return ([o.asnumpy() for o in outs],
            {k: exe.grad_dict[k].asnumpy() for k in params})


@pytest.mark.parametrize("model", ["lenet", "mlp"])
@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_executor_forward_backward_matches_mxtpu(smoke, example, model,
                                                 grad_req):
    rng = np.random.RandomState(2)
    if model == "lenet":
        tr_x, tr_y, _, _ = smoke.lenet_data()
        feed = {"data": tr_x[:16], "softmax_label": tr_y[:16]}
        params = smoke.lenet_init_params(mt, 0)
        make = smoke.lenet_symbol
    else:
        x_all, y_all = smoke.cs_data()
        feed = {"data": x_all[:32], "softmax_label": y_all[:32]}
        params = smoke.cs_init_params(0)
        params = {k: v + 0.01 * rng.standard_normal(v.shape).astype(
            np.float32) for k, v in params.items()}
        make = smoke.cs_symbol
    times = 2 if grad_req == "add" else 1
    got = _executor_run(mt, make(mt), params, feed, grad_req, times)
    want = _executor_run(mx, make(mx), params, feed, grad_req, times)
    _close(got[0][0], want[0][0])
    for k in params:
        _close(got[1][k], want[1][k], err_msg=k)


def test_executor_head_gradients_and_recomputed_backward():
    rng = np.random.RandomState(4)
    x = rng.standard_normal((5, 6)).astype(np.float32)
    w = rng.standard_normal((3, 6)).astype(np.float32)
    g = rng.standard_normal((5, 3)).astype(np.float32)
    res = {}
    for pkg in (mt, mx):
        net = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=3,
                                     no_bias=True, name="fc")
        exe = net.simple_bind(pkg.cpu(), data=(5, 6))
        exe.arg_dict["fc_weight"][:] = w
        exe.forward(is_train=True, data=pkg.nd.array(x, ctx=pkg.cpu()))
        exe.backward(out_grads=[pkg.nd.array(g, ctx=pkg.cpu())])
        res[pkg] = exe.grad_dict["fc_weight"].asnumpy()
        # after an inference forward, backward recomputes the training one
        exe.forward(is_train=False)
        exe.backward(out_grads=[pkg.nd.array(g, ctx=pkg.cpu())])
        _close(exe.grad_dict["fc_weight"].asnumpy(), res[pkg])
    _close(res[mt], g.T @ x)
    _close(res[mt], res[mx])


def test_executor_bind_copy_params_and_reshape():
    rng = np.random.RandomState(6)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    w = rng.standard_normal((3, 6)).astype(np.float32)
    net = mt.sym.FullyConnected(mt.sym.var("data"), num_hidden=3,
                                no_bias=True, name="fc")
    grad = mt.nd.zeros((3, 6), ctx=mt.cpu())
    exe = net.bind(mt.cpu(), [mt.nd.array(x, ctx=mt.cpu()),
                              mt.nd.zeros((3, 6), ctx=mt.cpu())],
                   args_grad=[None, grad])
    exe.copy_params_from({"fc_weight": mt.nd.array(w, ctx=mt.cpu())})
    out = exe.forward(is_train=True)[0]
    _close(out.asnumpy(), x @ w.T)
    exe.backward()
    _close(grad.asnumpy(), np.ones((4, 3), np.float32).T @ x)  # in place
    with pytest.raises(ValueError):
        exe.copy_params_from({"nope": grad})
    wider = exe.reshape(data=(7, 6))
    assert wider.arg_dict["fc_weight"] is exe.arg_dict["fc_weight"]
    assert wider.arg_dict["data"].shape == (7, 6)
    assert wider.output_shapes == [(7, 3)]
    assert mt.sym.var("a").infer_type(a="float16")[0] == \
        [np.dtype("float16")]


# -- Module.fit ----------------------------------------------------------------

def _fit_both(smoke, model):
    """One epoch of the example's fit in each package on the CPU from the
    same weights and batch order: (params, score) per package."""
    out = {}
    for pkg in (mt, mx):
        if model == "lenet":
            tr_x, tr_y, va_x, va_y = smoke.lenet_data()
            data = (tr_x[:FIT_SAMPLES], tr_y[:FIT_SAMPLES], va_x[:100],
                    va_y[:100])
            np.random.seed(8)
            mod, train, val = smoke.lenet_fit(
                pkg, data, pkg.cpu(), smoke.lenet_init_params(mt, 0), 1)
        else:
            x_all, y_all = smoke.cs_data()
            mod, train = smoke.mlp_fit(pkg, x_all[:FIT_SAMPLES],
                                       y_all[:FIT_SAMPLES], pkg.cpu(),
                                       smoke.cs_init_params(0), 1)
            val = train
        score = dict(mod.score(val, "acc"))["accuracy"]
        pred = mod.predict(val).asnumpy()
        out[pkg] = (smoke.module_params(mod), score, pred, mod)
    return out


@pytest.mark.parametrize("model", ["lenet", "mlp"])
def test_module_fit_one_epoch_matches_mxtpu(smoke, example, model):
    runs = _fit_both(smoke, model)
    got, want = runs[mt], runs[mx]
    assert sorted(got[0]) == sorted(want[0])
    for k in want[0]:
        np.testing.assert_allclose(got[0][k], want[0][k], **FIT_TOL,
                                   err_msg=k)
    assert got[1] == want[1]
    assert got[2].shape == want[2].shape      # predict drops padding rows
    _close(got[2], want[2])
    mod = got[3]
    assert mod._context == [mt.cpu()]
    assert mod._update_on_kvstore == (model == "lenet")


def test_checkpoints_cross_load_both_ways(smoke, tmp_path):
    tr_x, tr_y, va_x, va_y = smoke.lenet_data()
    data = (tr_x[:128], tr_y[:128], va_x[:100], va_y[:100])
    params0 = smoke.lenet_init_params(mt, 1)
    scores = {}
    for src, dst in ((mt, mx), (mx, mt)):
        np.random.seed(2)
        mod, _, val = smoke.lenet_fit(src, data, src.cpu(), params0, 1,
                                      validate=False)
        prefix = str(tmp_path / src.__name__)
        mod.save_checkpoint(prefix, 3)
        loaded = dst.mod.Module.load(prefix, 3, context=dst.cpu())
        dst_val = dst.io.NDArrayIter(data[2], data[3], smoke.LENET_BATCH)
        loaded.bind(dst_val.provide_data, dst_val.provide_label,
                    for_training=False)
        saved = smoke.module_params(mod)
        for k, v in smoke.module_params(loaded).items():
            np.testing.assert_array_equal(v, saved[k])
        scores[src] = (dict(mod.score(val, "acc"))["accuracy"],
                       dict(loaded.score(dst_val, "acc"))["accuracy"])
        assert scores[src][0] == scores[src][1]
    # and mxtpu's get_params, as numpy, sets the port's Module
    mxmod = mx.mod.Module.load(str(tmp_path / "mxtpu"), 3,
                               context=mx.cpu())
    mxmod.bind([("data", (64, 1, 28, 28))], [("softmax_label", (64,))])
    port = mt.mod.Module(smoke.lenet_symbol(mt), context=mt.cpu())
    port.bind([("data", (64, 1, 28, 28))], [("softmax_label", (64,))])
    args, auxs = mt.model.params_from_numpy(*mxmod.get_params(),
                                            ctx=mt.cpu())
    port.init_params(arg_params=args, aux_params=auxs)
    for k, v in smoke.module_params(port).items():
        np.testing.assert_array_equal(v, mxmod.get_params()[0][k].asnumpy())


def test_module_optimizer_states_resume(smoke, tmp_path):
    """An MLP trained 2 epochs equals one trained 1 epoch, checkpointed
    with its optimizer states, loaded and trained 1 more."""
    x_all, y_all = smoke.cs_data()
    x, y = x_all[:256], y_all[:256]
    whole, _ = smoke.mlp_fit(mt, x, y, mt.cpu(), smoke.cs_init_params(3), 2,
                             shuffle=False)
    half, _ = smoke.mlp_fit(mt, x, y, mt.cpu(), smoke.cs_init_params(3), 1,
                            shuffle=False)
    prefix = str(tmp_path / "mlp")
    half.save_checkpoint(prefix, 1, save_optimizer_states=True)
    resumed = mt.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                 context=mt.cpu())
    it = mt.io.NDArrayIter(x, y, smoke.CS_BATCH)
    resumed.fit(it, optimizer="sgd",
                optimizer_params={"learning_rate": smoke.CS_LR,
                                  "momentum": smoke.CS_MOMENTUM},
                begin_epoch=1, num_epoch=2)
    want = smoke.module_params(whole)
    for k, v in smoke.module_params(resumed).items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-7)


def test_module_defaults_to_gpu0(smoke):
    mod = mt.mod.Module(smoke.cs_symbol(mt))
    assert mod._context == [mt.gpu(0)]
    if torch.cuda.is_available():
        return
    with pytest.raises(mt.MXTPUError, match="needs a CUDA device"):
        mod.bind([("data", (4, 784))], [("softmax_label", (4,))])
