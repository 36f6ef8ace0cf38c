"""The ResNet slice on the CPU: example/image-classification's networks and
its Module.fit call (train_imagenet.py --benchmark 1 through common/fit.py,
mirrored by chip_smoke.py's ``resnet_symbol``, ``inception_bn_symbol`` and
``imagenet_fit``), in the port against mxtpu.

- The mirrors build, in mxtpu, the JSON of the example's own
  ``get_symbol``s, and in the port the same JSON; both packages list the
  same aux states and infer the same shapes.
- ``imagenet_fit`` in either package, from the same weights (the port's
  Xavier draws, handed to mxtpu as arrays and to the port through
  ``params_from_numpy``), eager (fit.py's kvstore object) and fused
  (``kvstore="local"``): a CIFAR-style ResNet-20 (bottleneck, n=2) at
  3x28x28 as train_cifar10.py builds it, an ImageNet-style ResNet-18 just
  above 64 px (the 7x7 stem and the max pool), and Inception-BN on its
  224 path (the smallest input that path takes is 205 px;
  tests/test_torch_inception_bn.py, a file of its own for its run time).
- Checkpoints with aux states cross both ways.

Tolerances. These networks' float32 gradients are discontinuous in the
forward's rounding: a ReLU whose input lies within rounding of 0 flips
its mask, and one element of a small batch is a large share of a
channel's gradient. Measured here: the port's own float32 gradients of
Inception-BN (batch 2) move by up to 13% of a parameter's largest
gradient when only the CPU's thread count changes (one mask of 34,496
flipped in block 5b); mxtpu's float32 ResNet-20 gradients lie up to 1.8%
of a parameter's largest gradient from a float64 run of the same graph
(test_float32_gradients_against_float64 below). So the weights after
the steps are held, parameter by parameter, to STEP_SHARE of the largest
distance a weight of that parameter moved, plus ATOL for the conv biases
that feed a BatchNorm (their exact gradient is 0: they move by rounding
alone, below 1e-6 in these runs). The moving statistics after one step
depend on the forward alone, which is well conditioned: AUX_TOL. The
training metric, an argmax count, is equal.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
SYMBOLS = ROOT / "example" / "image-classification" / "symbols"
# the share of a parameter's largest step that two float32 runs may differ
# by (the largest reading: 0.36 of bn_data_gamma's step, ResNet-20, 3 steps)
STEP_SHARE = 0.5
ATOL = 1e-5
# moving statistics after one step, relative to 1 + |value| (readings up
# to 1.9e-6, Inception-BN)
AUX_TOL = 1e-5
NETS = {
    # name: (symbol function, image shape, batch, steps)
    "resnet20_cifar": (lambda smoke, p: smoke.resnet_symbol(
        p, 20, "3,28,28", 10), "3,28,28", 8, 3),
    "resnet18_imagenet": (lambda smoke, p: smoke.resnet_symbol(
        p, 18, "3,68,68", 10), "3,68,68", 4, 3),
    "inception_bn": (lambda smoke, p: smoke.inception_bn_symbol(
        p, 10, "3,224,224"), "3,224,224", 2, 1),
}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke", ROOT / "chip_smoke.py")


@pytest.mark.parametrize("net,args", [
    ("resnet", dict(num_layers=50, image_shape="3,224,224",
                    num_classes=1000)),
    ("resnet", dict(num_layers=20, image_shape="3,28,28", num_classes=10)),
    ("resnet", dict(num_layers=18, image_shape="3,68,68", num_classes=10)),
    ("inception_bn", dict(image_shape="3,224,224", num_classes=1000)),
], ids=["resnet50_224", "resnet20_28", "resnet18_68", "inception_bn_224"])
def test_mirrors_build_the_examples_symbols(smoke, net, args):
    """The mirror's JSON in mxtpu and in the port is the example's
    get_symbol JSON; the two packages list the same arguments and aux
    states (ResNet-50: 51 BatchNorms, 102 aux states) and infer the same
    shapes."""
    example = _load("example_" + net, SYMBOLS / (net + ".py"))
    with mx.name.NameManager():
        want = example.get_symbol(**args)
    if net == "resnet":
        mirror = [smoke.resnet_symbol(p, args["num_layers"],
                                      args["image_shape"],
                                      args["num_classes"]) for p in (mx, mt)]
    else:
        mirror = [smoke.inception_bn_symbol(p, args["num_classes"],
                                            args["image_shape"])
                  for p in (mx, mt)]
    assert mirror[0].tojson() == want.tojson()
    assert mirror[1].tojson() == want.tojson()
    assert mirror[1].list_arguments() == want.list_arguments()
    assert mirror[1].list_auxiliary_states() == want.list_auxiliary_states()
    if args.get("num_layers") == 50:
        assert len(want.list_auxiliary_states()) == 102
    c, h, w = (int(x) for x in args["image_shape"].split(","))
    assert mirror[1].infer_shape(data=(2, c, h, w)) == \
        want.infer_shape(data=(2, c, h, w))


def _initial(smoke, net):
    """The port's Module draws (fit.py's Xavier) for ``net``: {name:
    numpy} for the arguments and the aux states."""
    build, shape, batch, _ = NETS[net]
    dims = tuple(int(x) for x in shape.split(","))
    mt.random.seed(3)
    mod = mt.mod.Module(build(smoke, mt), context=mt.cpu())
    mod.bind([("data", (batch,) + dims)], [("softmax_label", (batch,))])
    mod.init_params(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    args, auxs = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()})


def _fit(smoke, pkg, net, kvstore, args0, aux0):
    build, shape, batch, steps = NETS[net]
    np.random.seed(1)
    if pkg is mt:
        args, auxs = mt.model.params_from_numpy(args0, aux0, ctx=mt.cpu())
        args = {k: v.asnumpy() for k, v in args.items()}
        auxs = {k: v.asnumpy() for k, v in auxs.items()}
    else:
        args, auxs = args0, aux0
    metric = []
    mod, _ = smoke.imagenet_fit(
        pkg, build(smoke, pkg), batch, batch * steps, 1, shape, 10,
        context=pkg.cpu(), kvstore=kvstore, arg_params=args,
        aux_params=auxs, data_ctx=pkg.cpu(),
        batch_end_callback=[lambda p: metric.append(
            p.eval_metric.get_name_value())])
    return mod, smoke.module_params(mod), smoke.module_aux(mod), metric


def check_fit(smoke, net, path):
    """imagenet_fit's first steps of ``net`` in both packages from the
    same weights: every weight, the moving statistics and the training
    metric; fused runs on both sides take the fused step, eager ones the
    kvstore's (tests/test_torch_inception_bn.py runs it on Inception-BN)."""
    args0, aux0 = _initial(smoke, net)
    kv = "local" if path == "fused" else None
    got_mod, got, got_aux, got_metric = _fit(smoke, mt, net, kv, args0, aux0)
    want_mod, want, want_aux, want_metric = _fit(smoke, mx, net, kv, args0,
                                                 aux0)
    for mod in (got_mod, want_mod):
        assert (mod._fused is not None) == (path == "fused")
    assert sorted(got) == sorted(want) == sorted(args0)
    for k in want:
        step = float(np.abs(want[k] - args0[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=STEP_SHARE * step + ATOL, err_msg=k)
    assert sorted(got_aux) == sorted(want_aux) == sorted(aux0)
    steps = NETS[net][3]
    for k in want_aux:
        moved = float(np.abs(want_aux[k] - aux0[k]).max())
        assert moved > 0, k
        tol = AUX_TOL if steps == 1 else STEP_SHARE * moved
        np.testing.assert_allclose(got_aux[k], want_aux[k], rtol=AUX_TOL,
                                   atol=tol, err_msg=k)
    assert got_metric == want_metric


@pytest.mark.parametrize("path", ["eager", "fused"])
@pytest.mark.parametrize("net", ["resnet18_imagenet", "resnet20_cifar"])
def test_imagenet_fit_matches_mxtpu(smoke, net, path):
    check_fit(smoke, net, path)


def test_float32_gradients_against_float64(smoke):
    """The float32 gap behind STEP_SHARE, measured on ResNet-20's first
    forward/backward: the port's float32 gradients and mxtpu's against the
    port's float64 run of the same graph (BatchNorm computes in float64 for
    float64 input; mxtpu has no float64 arrays). Readings: the port within
    7.3e-6 of each parameter's largest float64 gradient, mxtpu within
    1.8e-2."""
    build, shape, batch, _ = NETS["resnet20_cifar"]
    dims = (batch,) + tuple(int(x) for x in shape.split(","))
    rng = np.random.RandomState(0)
    data = rng.uniform(-1, 1, dims)
    label = rng.randint(0, 10, (batch,)).astype(np.float64)
    grads = {}
    for pkg, dt in ((mt, "float64"), (mt, "float32"), (mx, "float32")):
        sym = build(smoke, pkg)
        ex = sym.simple_bind(pkg.cpu(), data=dims, softmax_label=(batch,),
                             type_dict={n: dt for n in sym.list_arguments()})
        r = np.random.RandomState(1)
        for n in sorted(ex.arg_dict):
            v = data if n == "data" else label if n == "softmax_label" \
                else 0.1 * r.randn(*ex.arg_dict[n].shape)
            ex.arg_dict[n][:] = pkg.nd.array(v.astype(dt), ctx=pkg.cpu(),
                                             dtype=dt)
        for n in sorted(ex.aux_dict):
            ex.aux_dict[n][:] = pkg.nd.array(
                (r.rand(*ex.aux_dict[n].shape) + 0.5).astype(np.float32),
                ctx=pkg.cpu())
        ex.forward(is_train=True)
        ex.backward()
        grads[pkg, dt] = {n: g.asnumpy().astype(np.float64)
                          for n, g in ex.grad_dict.items()
                          if g is not None and n != "softmax_label"}
    exact = grads[mt, "float64"]

    def gap(got):
        return max(float(np.abs(got[n] - exact[n]).max()
                         / np.abs(exact[n]).max()) for n in exact)
    assert gap(grads[mt, "float32"]) < 1e-4
    assert gap(grads[mx, "float32"]) < 0.1


def test_checkpoints_with_aux_cross_both_ways(smoke, tmp_path):
    """A trained ResNet-20's checkpoint (arg: and aux: entries) saved by
    either package loads into the other's Module, bit for bit, and both
    predict the same with the moving statistics."""
    args0, aux0 = _initial(smoke, "resnet20_cifar")
    _, shape, batch, _ = NETS["resnet20_cifar"]
    dims = (batch,) + tuple(int(x) for x in shape.split(","))
    x = np.random.RandomState(4).uniform(-1, 1, dims).astype(np.float32)
    for src, dst in ((mt, mx), (mx, mt)):
        mod = _fit(smoke, src, "resnet20_cifar", "local", args0, aux0)[0]
        prefix = str(tmp_path / src.__name__)
        mod.save_checkpoint(prefix, 1)
        loaded = dst.mod.Module.load(prefix, 1, context=dst.cpu())
        loaded.bind([("data", dims)], [("softmax_label", (batch,))],
                    for_training=False)
        saved_args, saved_aux = mod.get_params()
        got_args, got_aux = loaded.get_params()
        for saved, got in ((saved_args, got_args), (saved_aux, got_aux)):
            assert sorted(saved) == sorted(got)
            for k in saved:
                np.testing.assert_array_equal(got[k].asnumpy(),
                                              saved[k].asnumpy())
        assert any(not np.array_equal(saved_aux[k].asnumpy(), aux0[k])
                   for k in aux0)
        outs = []
        for pkg, m in ((src, mod), (dst, loaded)):
            it = pkg.io.NDArrayIter(x, np.zeros(batch, np.float32), batch)
            outs.append(m.predict(it).asnumpy())
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    # and mxtpu's get_params, as numpy, sets the port's Module
    mxmod = mx.mod.Module.load(str(tmp_path / "mxtpu"), 1, context=mx.cpu())
    mxmod.bind([("data", dims)], [("softmax_label", (batch,))],
               for_training=False)
    port = mt.mod.Module(smoke.resnet_symbol(mt, 20, shape, 10),
                         context=mt.cpu())
    port.bind([("data", dims)], [("softmax_label", (batch,))],
              for_training=False)
    args, auxs = mt.model.params_from_numpy(*mxmod.get_params(),
                                            ctx=mt.cpu())
    port.init_params(arg_params=args, aux_params=auxs)
    for k, v in port.get_params()[1].items():
        np.testing.assert_array_equal(v.asnumpy(),
                                      mxmod.get_params()[1][k].asnumpy())
        np.testing.assert_array_equal(
            port._exec_group.execs[0].aux_dict[k].asnumpy(), v.asnumpy())
