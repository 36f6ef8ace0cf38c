"""The CIFAR records slice on the CPU: train_cifar10.py's fit call through
ImageRecordIter (mirrored by chip_smoke.py's ``cifar_args``,
``make_synthetic_recfile``, ``get_rec_iter`` and ``cifar_fit``: the
example imports mxtpu), in the port against mxtpu.

- The mirrors are the example's: ``cifar_args()`` is the namespace
  train_cifar10.py parses with no command line, ``get_rec_iter`` builds
  the two ImageRecordIters with common/data.py's keywords, and
  ``make_synthetic_recfile`` writes common/data.py's bytes in either
  package.
- ``cifar_fit`` in either package from the same numpy weights (the
  port's Xavier draws, given to both as arrays), ResNet-20 at 3x28x28,
  batch 8, 64 synthetic records read by 2 decode processes each (the
  pool path, whose batches are equal across the packages), eager
  (fit.py's kvstore object) and fused (kvstore="local"): after the first
  step every weight lies within STEP_SHARE of the largest distance a
  weight of its parameter moved, plus ATOL (tests/test_torch_resnet.py's
  limits and readings). The moving variances lie within AUX_TOL of
  themselves; the moving means within MEAN_TOL of their channel's spread
  (the square root of its moving variance), not of themselves: the
  records' channel means sit near 0 beside values up to 100, so a batch
  mean summed in float32 cancels. bn_data's moving mean in mxtpu lies
  7.3e-5 from the port's relative to itself, 9.2e-6 of its channel's
  spread; a float32 sum of the 6,272 values a channel holds may be off by
  6,272 x 2^-24 = 3.7e-4 of the sum of their magnitudes.
- After the fit's epoch, each package's validation outputs (the forward
  score() runs) equal exactly an eager inference Module's given the
  weights and moving statistics read from the fitted module, and mxtpu
  given the port's weights gives the port's outputs within VAL_TOL of a
  probability (two float32 inference forwards, XLA's and torch's, over
  20 layers). The two packages' own outputs after the epoch are not
  compared: float32 gradients jump with a flipped ReLU mask
  (tests/test_torch_resnet.py), so their weights part step by step.
"""
import argparse
import importlib
import importlib.util
import logging
import pathlib
import runpy
import sys

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLE = ROOT / "example" / "image-classification"
STEP_SHARE = 0.5
ATOL = 1e-5
AUX_TOL = 1e-5
# a moving mean after one step, as a share of its channel's spread
# (readings up to 9.2e-6, bn_data, whose batch mean cancels)
MEAN_TOL = 1e-4
# softmax outputs of the two packages' inference forwards from the same
# weights after the fit
VAL_TOL = 1e-5
LAYERS, SHAPE, BATCH, RECORDS = 20, "3,28,28", 8, 64


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  str(ROOT / "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def example(monkeypatch):
    """The example's common/data.py and common/fit.py, imported as the
    script imports them; sys.path, sys.modules and the root logger are
    restored after."""
    monkeypatch.syspath_prepend(str(EXAMPLE))
    monkeypatch.syspath_prepend(str(ROOT))
    before = set(sys.modules)
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    data = importlib.import_module("common.data")
    fit = importlib.import_module("common.fit")
    yield data, fit
    root.setLevel(level)
    root.handlers[:] = handlers
    for name in set(sys.modules) - before:
        if name.split(".")[0] in ("common", "symbols"):
            del sys.modules[name]


def test_mirrors_match_the_example(smoke, example, monkeypatch, tmp_path):
    data, fit = example
    seen = {}
    monkeypatch.setattr(fit, "fit", lambda args, net, loader: seen.update(
        args=args, net=net, loader=loader))
    monkeypatch.setattr(sys, "argv", ["train_cifar10.py"])
    runpy.run_path(str(EXAMPLE / "train_cifar10.py"), run_name="__main__")
    assert seen["loader"] is data.get_rec_iter
    assert vars(smoke.cifar_args()) == vars(seen["args"])
    # the script builds its net in the process's name scope, so compare
    # what does not hang on it: the arguments, aux states and shapes
    mirror = smoke.resnet_symbol(mx, 110, "3,28,28", 10)
    assert seen["net"].list_arguments() == mirror.list_arguments()
    assert seen["net"].list_auxiliary_states() == \
        mirror.list_auxiliary_states()
    assert len(mirror.list_auxiliary_states()) == 2 * (1 + 3 * 12 * 3 + 1)
    assert seen["net"].infer_shape(data=(2, 3, 28, 28)) == \
        mirror.infer_shape(data=(2, 3, 28, 28))

    # get_rec_iter: the same keywords for both iterators
    calls = {"example": [], "mirror": []}
    monkeypatch.setattr(data.mx.io, "ImageRecordIter",
                        lambda **kw: calls["example"].append(kw) or kw)
    fake = argparse.Namespace(io=argparse.Namespace(
        ImageRecordIter=lambda **kw: calls["mirror"].append(kw) or kw))
    args = smoke.cifar_args(data_train="t.rec", data_val="v.rec")
    data.get_rec_iter(args)
    smoke.get_rec_iter(fake, args)
    assert len(calls["example"]) == 2
    assert calls["mirror"] == calls["example"]

    # the synthetic records, byte for byte, from either package
    paths = {k: str(tmp_path / (k + ".rec"))
             for k in ("example", "mxtpu", "port")}
    data.make_synthetic_recfile(paths["example"], 30, 28, 10, seed=1)
    for k, pkg in (("mxtpu", mx), ("port", mt)):
        smoke.make_synthetic_recfile(pkg, paths[k], 30, 28, 10, seed=1)
    blobs = {k: pathlib.Path(p).read_bytes() for k, p in paths.items()}
    assert blobs["mxtpu"] == blobs["port"] == blobs["example"]


def _initial(smoke):
    """The port's Module draws (fit.py's Xavier) for ResNet-20: {name:
    numpy} arguments and aux states."""
    dims = (BATCH,) + tuple(int(x) for x in SHAPE.split(","))
    mt.random.seed(3)
    mod = mt.mod.Module(smoke.resnet_symbol(mt, LAYERS, SHAPE, 10),
                        context=mt.cpu())
    mod.bind([("data", dims)], [("softmax_label", (BATCH,))])
    mod.init_params(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2))
    args, auxs = mod.get_params()
    return ({k: v.asnumpy() for k, v in args.items()},
            {k: v.asnumpy() for k, v in auxs.items()})


@pytest.fixture(scope="module")
def records(smoke, tmp_path_factory):
    """train_cifar10.py's --synthetic records at RECORDS, batch BATCH."""
    root = str(tmp_path_factory.mktemp("cifar"))
    args = smoke.cifar_args(synthetic=RECORDS, batch_size=BATCH)
    return smoke.cifar_synthetic(mt, args, root)


def _outputs(mod, batches):
    """``mod``'s softmax on each batch, the forward score() runs."""
    outs = []
    for batch in batches:
        mod.forward(batch, is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    return np.concatenate(outs)


def _inference(smoke, pkg, params, batches):
    """An eager Module of ``pkg`` bound for inference and given
    ``params`` ({name: numpy} arguments, aux states): its softmax on
    ``batches`` ((data, label) numpy pairs)."""
    mod = pkg.mod.Module(smoke.resnet_symbol(pkg, LAYERS, SHAPE, 10),
                         context=pkg.cpu())
    mod.bind([("data", batches[0][0].shape)],
             [("softmax_label", batches[0][1].shape)], for_training=False)
    mod.set_params(*(smoke.host_params(pkg, p) for p in params))
    return _outputs(mod, [pkg.io.DataBatch(
        data=[pkg.nd.array(x, ctx=pkg.cpu())],
        label=[pkg.nd.array(y, ctx=pkg.cpu())], pad=0) for x, y in batches])


@pytest.fixture(scope="module", params=["eager", "fused"])
def fitted(request, smoke, records):
    """One epoch of ``cifar_fit`` (RECORDS / BATCH steps) in each package
    from the same weights: {package: the weights and moving statistics
    after the first step and after the fit, the validation batches
    ((data, label) numpy) and the fitted module's outputs on them}, and
    the starting weights."""
    path = request.param
    args0, aux0 = _initial(smoke)
    out = {}
    for name, pkg in (("mxtpu", mx), ("port", mt)):
        args = smoke.cifar_args(
            num_layers=LAYERS, batch_size=BATCH, num_epochs=1,
            num_examples=RECORDS, synthetic=RECORDS, data_nthreads=2,
            data_train=records[0], data_val=records[1])
        first = []

        def keep(param, mod_of=lambda p: p.locals["self"]):
            if param.nbatch == 0:
                mod = mod_of(param)
                first.append((smoke.module_params(mod),
                              smoke.module_aux(mod)))
        np.random.seed(1)
        mod, train, val = smoke.cifar_fit(
            pkg, args, smoke.resnet_symbol(pkg, LAYERS, SHAPE, 10),
            context=pkg.cpu(), kvstore=None if path == "eager" else "local",
            arg_params=args0, aux_params=aux0, batch_end_callback=[keep])
        try:
            assert type(train._prefetch).__name__ == "_FastRecordIter"
            assert (mod._fused is not None) == (path == "fused")
            val.reset()
            batches = list(val)
            outputs = _outputs(mod, batches)
        finally:
            train.close()
            val.close()
        out[name] = dict(
            first=first[0],
            final=(smoke.module_params(mod), smoke.module_aux(mod)),
            batches=[(b.data[0].asnumpy(), b.label[0].asnumpy())
                     for b in batches],
            outputs=outputs)
    return args0, aux0, out


def test_one_step_matches_mxtpu(fitted):
    args0, aux0, out = fitted
    (got, got_aux), (want, want_aux) = out["port"]["first"], \
        out["mxtpu"]["first"]
    assert sorted(got) == sorted(want) == sorted(args0)
    for k in want:
        step = float(np.abs(want[k] - args0[k]).max())
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=STEP_SHARE * step + ATOL, err_msg=k)
    assert sorted(got_aux) == sorted(want_aux) == sorted(aux0)
    for k in want_aux:
        assert float(np.abs(want_aux[k] - aux0[k]).max()) > 0, k
        if k.endswith("_moving_mean"):
            spread = np.sqrt(want_aux[k[:-len("mean")] + "var"])
            share = np.abs(got_aux[k] - want_aux[k]) / spread
            assert share.max() <= MEAN_TOL, (k, share.max())
        else:
            np.testing.assert_allclose(got_aux[k], want_aux[k],
                                       rtol=AUX_TOL, atol=0, err_msg=k)


def test_validation_after_fit_matches_mxtpu(smoke, fitted):
    """After the fit, each package's validation outputs equal, exactly,
    those of an eager inference Module given the weights and moving
    statistics read from the fitted module (a parameter or moving
    statistic that the eval forward read from a stale copy would differ),
    and mxtpu given the port's weights gives the port's outputs within
    VAL_TOL; the two packages' validation batches are equal."""
    _args0, _aux0, out = fitted
    for a, b in zip(out["port"]["batches"], out["mxtpu"]["batches"]):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for name, pkg in (("mxtpu", mx), ("port", mt)):
        run = out[name]
        np.testing.assert_array_equal(
            _inference(smoke, pkg, run["final"], run["batches"]),
            run["outputs"], err_msg=name)
    port = out["port"]
    np.testing.assert_allclose(
        _inference(smoke, mx, port["final"], port["batches"]),
        port["outputs"], rtol=0, atol=VAL_TOL)
