"""The five examples the op sweep's ops open, as ``chip_smoke.py`` mirrors
them (the examples import ``mxtpu``): ``fcn_toy.py`` (Deconvolution,
Crop), ``svm_mnist.py`` (SVMOutput), ``nce_lm.py`` (batch_dot),
``neural_style_toy.py`` (dot) and ``train_ndsb2.py``
(LogisticRegressionOutput, through FeedForward, CSVIter and
``metric.np``).

Each mirror's main runs on the port's CPU to the example's own asserts.
Each one's first steps run in both packages from the same weights (drawn
by the port, carried to ``mxtpu``) and the same batches: the weights
after FIT_STEPS steps (the losses and image for the two Gluon loops)
within ``TOL``. ``train_ndsb2``'s net has a training-mode Dropout, whose
masks the two packages draw from different generators, so it is held on
an inference forward instead.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-5)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", str(ROOT / "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


@pytest.mark.parametrize("example", ["fcn_toy", "svm_mnist", "nce_lm",
                                     "neural_style_toy", "train_ndsb2"])
def test_main_on_the_cpu(example, tmp_path):
    """The mirror's main on the port's cpu() meets the example's asserts
    (each fails the run through chip_smoke.fail otherwise)."""
    cpu = mt.cpu()
    with cpu:
        if example == "fcn_toy":
            assert cs.fcn_toy_main(mt, cpu) > 0.93
        elif example == "svm_mnist":
            assert min(cs.svm_mnist_main(mt, cpu).values()) > 0.9
        elif example == "nce_lm":
            assert cs.nce_lm_main(mt, cpu)[1] > 0.9
        elif example == "neural_style_toy":
            losses, _ = cs.neural_style_main(mt, cpu)
            assert losses[-1] < 0.4 * losses[0]
        else:
            crps, base = cs.ndsb2_main(mt, cpu, str(tmp_path))
            assert crps < 0.6 * base


def _module_first_steps(build, it_fn, init, opt, opt_params,
                        label_names=("softmax_label",)):
    with mt.name.NameManager():
        sym_t = build(mt)
    args, auxs = cs.module_init(mt, sym_t, it_fn(mt), init(mt),
                                label_names=label_names)
    got = cs.module_steps(mt, mt.cpu(), sym_t, it_fn(mt), args, auxs, opt,
                          opt_params, label_names=label_names)
    with mx.name.NameManager():
        sym_j = build(mx)
    want = cs.module_steps(mx, mx.cpu(), sym_j, it_fn(mx), args, auxs, opt,
                           opt_params, label_names=label_names)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


def test_fcn_toy_first_steps():
    x, y = cs.fcn_toy_data(96)

    def it(pkg):
        np.random.seed(0)
        return pkg.io.NDArrayIter(x, y, batch_size=8, shuffle=True,
                                  label_name="softmax_label")
    _module_first_steps(cs.fcn_toy_symbol, it, lambda p: p.init.Xavier(),
                        "adam", {"learning_rate": 0.01})


@pytest.mark.parametrize("use_linear,lr", [(False, 1e-3), (True, 1e-2)])
def test_svm_mnist_first_steps(use_linear, lr):
    x, y = cs.svm_digits(512)

    def it(pkg):
        np.random.seed(0)
        return pkg.io.NDArrayIter(x, y, 128, shuffle=True,
                                  label_name="svm_label")
    _module_first_steps(lambda p: cs.svm_symbol(p, use_linear), it,
                        lambda p: p.init.Uniform(0.01), "sgd",
                        {"learning_rate": lr, "momentum": 0.9, "wd": 1e-4},
                        label_names=("svm_label",))


def test_nce_lm_first_steps():
    with mt.cpu():
        _, _, w0 = cs.nce_lm_main(mt, mt.cpu(), steps=0)
        got = cs.nce_lm_main(mt, mt.cpu(), steps=cs.FIT_STEPS, weights=w0)
    want = cs.nce_lm_main(mx, mx.cpu(), steps=cs.FIT_STEPS, weights=w0)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], err_msg=k, **TOL)


def test_neural_style_first_steps():
    with mt.cpu():
        f1, f2 = cs.style_extractor(mt, mt.cpu())
        f2(f1(mt.nd.zeros((1, 3, cs.STYLE_HW, cs.STYLE_HW))))
        weights = [p.data().asnumpy() for f in (f1, f2)
                   for p in f.collect_params().values()]
        got = cs.neural_style_main(mt, mt.cpu(), steps=cs.FIT_STEPS,
                                   weights=weights)
    want = cs.neural_style_main(mx, mx.cpu(), steps=cs.FIT_STEPS,
                                weights=weights)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)


def test_ndsb2_forward(tmp_path):
    data, volumes = cs.ndsb2_stacks(8, np.random.RandomState(7))
    data_csv, label_csv = cs.ndsb2_write_csvs(str(tmp_path), data, volumes)
    outs, args = {}, None
    for pkg in (mt, mx):
        it = pkg.io.CSVIter(data_csv=data_csv,
                            data_shape=(cs.NDSB_FRAMES, cs.NDSB_IMG,
                                        cs.NDSB_IMG),
                            label_csv=label_csv, label_shape=(cs.NDSB_BINS,),
                            batch_size=8)
        with pkg.name.NameManager():
            sym = cs.ndsb2_lenet(pkg)
        if args is None:
            args, auxs = cs.module_init(mt, sym, it, mt.init.Uniform(0.01))
        mod = pkg.mod.Module(sym, context=pkg.cpu())
        mod.bind(it.provide_data, it.provide_label, for_training=False)
        mod.init_params(arg_params=cs.host_params(pkg, args),
                        aux_params=cs.host_params(pkg, auxs))
        mod.forward(it.next(), is_train=False)
        outs[pkg] = mod.get_outputs()[0].asnumpy()
    np.testing.assert_allclose(outs[mt], outs[mx], **TOL)
