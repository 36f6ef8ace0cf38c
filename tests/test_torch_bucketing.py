"""The bucketed LSTM LM of example/rnn/lstm_bucketing.py trained through
the port's BucketingModule.fit against mxtpu's, on the CPU.

The fit is chip_smoke.py's ``lstm_bucketing_fit`` (the example's main,
line for line, in either package) at a small size: vocabulary 16, embed
16, hidden 32, 2 layers, batch 8, buckets 4 and 8, Adam at 0.01, the
fused-cell model (FusedRNNCell, the RNN op) and the unfused one
(LSTMCells). Both packages start from the same weights and draw the same
batches (Python's and numpy's generators seeded alike). Tolerances: the
first FIT_STEPS steps within FIT_TOL (tests/test_torch_module.py's band
for float32 sums in another order); each epoch's perplexity within
PPL_RTOL. Counts (each bucket's ProgramCache, the fused group's stats,
numpy's global RNG state) are equal. Also here: BucketSentenceIter's
batches and order, Perplexity, the shared parameter store across
buckets (tests/test_module_fused.py's bucketing case, ported), and the
artifacts that cross between the packages (a GRUCell JSON of mxtpu's,
with its ``_scalar_1.0`` constant, among them).
"""
import importlib.util
import pathlib
import random

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIT_TOL = dict(rtol=1e-5, atol=1e-6)
FIT_STEPS = 3
# Adam divides each step by sqrt(v) + 1e-8, so where a gradient nearly
# cancels, its float32 rounding moves the weight by up to
# lr (1 - beta1) / 1e-8 = 1e5 times that rounding, from the first step on
# (tests/test_torch_module_fused.py's APART): mxtpu's own fused and eager
# steps already end FIT_STEPS steps apart past FIT_TOL in a weight or two
# (up to 4.6e-6). Readings of the port against mxtpu over FIT_STEPS steps
# of the example's Adam: fused cell 3 of 15,632 weights past FIT_TOL, at
# most 8.2e-6; LSTMCells 5, 1.0e-5; the limits hold three times that.
# With SGD (no division) every weight stays within FIT_TOL (largest
# reading at the example's full widths, 668,864 weights: 7.8e-8).
ADAM_APART = dict(beyond=15, limit=3e-5)
FIRST_STEPS = {"adam": 0.01, "sgd": 0.1}
# perplexity is exp of a mean of float32 log-probabilities: the weights'
# FIT_TOL-sized differences move it far less than this
PPL_RTOL = 0.01
EPOCHS = 3
SMALL = dict(num_hidden=32, num_embed=16, num_layers=2, batch_size=8,
             buckets=(4, 8))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def fused_on(monkeypatch):
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "1")
    monkeypatch.delenv("MXTPU_METRIC_READBACK", raising=False)


def _corpus(smoke):
    """The example's synthetic sentences at vocabulary 16, cut to the
    small buckets (4 and 8 tokens)."""
    sentences, vocab = smoke.synthetic_corpus(n=120, vocab=16)
    return [s[:4] if len(s) <= 16 else s[:8] for s in sentences], vocab


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def _initial(smoke, sentences, vocab, fused):
    """The port's initial weights for the model ({name: numpy})."""
    with mt.cpu():
        mod, _, _ = smoke.lstm_bucketing_fit(mt, sentences, vocab, fused,
                                             num_epoch=0, **SMALL)
    return _params(mod)


def _fit(pkg, smoke, sentences, vocab, fused, params, epochs, **kw):
    with pkg.cpu():
        return smoke.lstm_bucketing_fit(pkg, sentences, vocab, fused,
                                        num_epoch=epochs, arg_params=params,
                                        **dict(SMALL, **kw))


def _assert_params(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)


# -- the iterator and the metric ----------------------------------------------

@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_mxtpu(smoke, layout):
    """The same batches (data, next-token labels, bucket keys, shapes) in
    the same order over two epochs, from the same seeds; the port's
    batches lie on the context current when the iterator was made."""
    sentences, _ = _corpus(smoke)
    epochs = {}
    for pkg in (mt, mx):
        random.seed(4)
        np.random.seed(4)
        with pkg.cpu():
            it = pkg.rnn.BucketSentenceIter(sentences, 8, buckets=[4, 8],
                                            invalid_label=0, layout=layout)
        assert it.default_bucket_key == 8
        assert [tuple(d.shape) for d in it.provide_data] == [(8, 8)]
        seen = []
        for _ in range(2):
            for batch in it:
                if pkg is mt:
                    assert batch.data[0].context == mt.cpu()
                seen.append((batch.bucket_key, batch.data[0].asnumpy(),
                             batch.label[0].asnumpy(),
                             tuple(batch.provide_data[0].shape),
                             tuple(batch.provide_label[0].shape)))
            it.reset()
        epochs[pkg] = seen
    assert len(epochs[mt]) == len(epochs[mx]) > 10
    for got, want in zip(epochs[mt], epochs[mx]):
        assert got[0] == want[0] and got[3:] == want[3:]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("ignore_label", [0, None])
def test_perplexity_matches_mxtpu(ignore_label):
    """Perplexity after several batches, with and without ignored labels,
    equal to mxtpu's (the picked values go to the host once a batch)."""
    rng = np.random.RandomState(2)
    metrics = [pkg.metric.Perplexity(ignore_label=ignore_label)
               for pkg in (mt, mx)]
    for _ in range(4):
        logits = rng.standard_normal((24, 11))
        probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)) \
            .astype(np.float32)
        labels = rng.randint(0, 11, (3, 8)).astype(np.float32)
        for pkg, m in zip((mt, mx), metrics):
            m.update([pkg.nd.array(labels, ctx=pkg.cpu())],
                     [pkg.nd.array(probs, ctx=pkg.cpu())])
    got, want = (m.get() for m in metrics)
    assert got[0] == want[0] == "perplexity"
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    assert metrics[0].num_inst == metrics[1].num_inst == 4
    with pytest.raises(ValueError, match="shape mismatch"):
        metrics[0].update([mt.nd.array(np.zeros(5), ctx=mt.cpu())],
                          [mt.nd.array(np.ones((4, 3)), ctx=mt.cpu())])


# -- the example's fit ----------------------------------------------------------

def _assert_mostly(got, want, tol, beyond, limit):
    """``got`` within ``tol`` of ``want`` in all but at most ``beyond``
    weights, and every weight within ``limit``."""
    assert sorted(got) == sorted(want)
    past, worst = 0, 0.0
    for k in want:
        d = np.abs(got[k] - want[k])
        past += int((d > tol["atol"] + tol["rtol"] * np.abs(want[k])).sum())
        worst = max(worst, float(d.max()))
    assert past <= beyond and worst <= limit, (past, worst)


@pytest.mark.parametrize("optimizer", sorted(FIRST_STEPS))
@pytest.mark.parametrize("fused_step", [True, False],
                         ids=["fused_step", "eager_step"])
@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused_cell", "lstm_cells"])
def test_first_steps_match_mxtpu(smoke, monkeypatch, fused, fused_step,
                                 optimizer):
    """FIT_STEPS steps of the example's fit, both packages, from the same
    weights: within FIT_TOL (with Adam, all but ADAM_APART's few)."""
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "1" if fused_step else "0")
    sentences, vocab = _corpus(smoke)
    few = smoke.bucket_sentences(sentences, SMALL["buckets"], 8,
                                 FIT_STEPS * SMALL["batch_size"])
    params = _initial(smoke, sentences, vocab, fused)
    # every sentence in bucket 8: one bucket (an empty one has no array)
    got, want = (_params(_fit(pkg, smoke, few, vocab, fused, params, 1,
                              buckets=(8,), optimizer=optimizer,
                              lr=FIRST_STEPS[optimizer])[0])
                 for pkg in (mt, mx))
    if optimizer == "sgd":
        _assert_params(got, want, FIT_TOL)
    else:
        _assert_mostly(got, want, FIT_TOL, **ADAM_APART)


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused_cell", "lstm_cells"])
def test_fit_matches_mxtpu(smoke, fused):
    """EPOCHS epochs: each epoch's perplexity within PPL_RTOL, falling;
    one compile a bucket and every later step a hit, in each bucket's
    ProgramCache and in the group's stats, as in mxtpu; numpy's global
    RNG left alike."""
    sentences, vocab = _corpus(smoke)
    params = _initial(smoke, sentences, vocab, fused)
    runs = {}
    for pkg in (mt, mx):
        mod, _, ppl = _fit(pkg, smoke, sentences, vocab, fused, params,
                           EPOCHS)
        runs[pkg] = (mod, ppl, np.random.get_state()[1].copy())
    (got, got_ppl, got_rng), (want, want_ppl, want_rng) = runs[mt], runs[mx]
    np.testing.assert_allclose(got_ppl, want_ppl, rtol=PPL_RTOL)
    assert got_ppl[-1] < 0.9 * got_ppl[0]
    stats = {pkg: {k: b._fused._cache.stats()
                   for k, b in runs[pkg][0]._buckets.items()}
             for pkg in (mt, mx)}
    assert stats[mt] == stats[mx]
    assert all(s["compiles"] == 1 and s["programs"] == 1
               for s in stats[mt].values())
    group = got._buckets[8]._fused._group.stats
    want_group = want._buckets[8]._fused._group.stats
    assert {k: group[k] for k in want_group} == want_group
    assert group["compiles"] == 2 and group["fallbacks"] == 0
    np.testing.assert_array_equal(got_rng, want_rng)


# -- the shared store -----------------------------------------------------------

def _sum_lm(pkg):
    """tests/test_module_fused.py's bucketing model: (B, L, D) summed
    over L, two FullyConnected layers, a softmax head."""
    def sym_gen(bucket_key):
        data = pkg.sym.var("data")
        net = pkg.sym.sum(data, axis=1)
        net = pkg.sym.FullyConnected(net, num_hidden=16, name="fc1")
        net = pkg.sym.Activation(net, act_type="relu", name="relu1")
        net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
        net = pkg.sym.SoftmaxOutput(net, name="softmax")
        return net, ("data",), ("softmax_label",)
    return sym_gen


def _switching(pkg, fused_step, monkeypatch):
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "1" if fused_step else "0")
    np.random.seed(3)
    pkg.random.seed(3)
    mod = pkg.mod.BucketingModule(_sum_lm(pkg), default_bucket_key=10,
                                  context=pkg.cpu())
    mod.bind([("data", (8, 10, 6))], [("softmax_label", (8,))])
    mod.init_params(pkg.init.Xavier())
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05})
    rng = np.random.RandomState(0)

    def batch_for(key):
        x = rng.randn(8, key, 6).astype("float32")
        y = rng.randint(0, 4, 8).astype("float32")
        return pkg.io.DataBatch(
            [pkg.nd.array(x, ctx=pkg.cpu())],
            [pkg.nd.array(y, ctx=pkg.cpu())], bucket_key=key,
            provide_data=[("data", (8, key, 6))],
            provide_label=[("softmax_label", (8,))])
    return mod, batch_for


@pytest.mark.parametrize("fused_step", [True, False],
                         ids=["fused_step", "eager_step"])
def test_buckets_share_one_store(monkeypatch, fused_step):
    """After each bucket's first batch, switches compile nothing more and
    copy no parameter: the same NDArrays (the same tensors) back every
    bucket, fused or eager; training still moves them."""
    from mxtpu_torch.module import module as mt_module
    mod, batch_for = _switching(mt, fused_step, monkeypatch)
    metric = mt.metric.create("acc")
    for key in (10, 20, 10, 20):
        b = batch_for(key)
        mod.forward_backward(b)
        mod.update()
        mod.update_metric(metric, b.label)
    metric.get()
    m10, m20 = mod._buckets[10], mod._buckets[20]
    e10, e20 = m10._exec_group.execs[0], m20._exec_group.execs[0]
    for name in ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"):
        assert e10.arg_dict[name] is e20.arg_dict[name], name
        assert e10.arg_dict[name].data is e20.arg_dict[name].data, name
    for (p10, x10), (p20, x20) in zip(m10._exec_group._stores,
                                      m20._exec_group._stores):
        assert p10.keys() == p20.keys() and x10.keys() == x20.keys()
        assert all(p10[n] is p20[n] for n in p10)
        assert all(x10[n] is x20[n] for n in x10)
    if fused_step:
        fs = m10._fused._group
        assert m20._fused._group is fs
        assert fs.param_store["fc1_weight"] is e20.arg_dict["fc1_weight"]
        compiles, drains = fs.stats["compiles"], fs.stats["metric_drains"]
    else:
        assert m10._fused is None and m20._fused is None

    def refuse(*a, **k):
        raise AssertionError("a bucket switch copied the parameters")
    monkeypatch.setattr(mt_module.Module, "set_params", refuse)
    monkeypatch.setattr(mt_module.Module, "get_params", refuse)
    before = e10.arg_dict["fc1_weight"].asnumpy()
    for key in (20, 10, 20, 10, 20, 10):
        b = batch_for(key)
        mod.forward_backward(b)
        mod.update()
        mod.update_metric(metric, b.label)
    if fused_step:
        assert fs.stats["compiles"] == compiles
        assert fs.stats["metric_drains"] == drains
    after = e10.arg_dict["fc1_weight"].asnumpy()
    assert np.abs(after - before).max() > 0
    assert np.isfinite(after).all()


def _flat_lm(pkg):
    """A bucketing model whose parameter's shape follows the bucket: the
    (B, L, D) data flattened into one FullyConnected."""
    def sym_gen(bucket_key):
        net = pkg.sym.Flatten(pkg.sym.var("data"))
        net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc1")
        return (pkg.sym.SoftmaxOutput(net, name="softmax"), ("data",),
                ("softmax_label",))
    return sym_gen


@pytest.mark.parametrize("fused_step", [True, False],
                         ids=["fused_step", "eager_step"])
def test_bucket_whose_parameter_follows_the_bucket_raises(monkeypatch,
                                                          fused_step):
    """A bucket that cannot share the store fails in both packages:
    mxtpu at the step (its weights do not fit the data), the port at the
    bucket's bind, naming the parameter."""
    monkeypatch.setenv("MXTPU_MODULE_FUSED", "1" if fused_step else "0")
    for pkg, error, match in ((mx, TypeError, "dot_general"),
                              (mt, ValueError, "'fc1_weight' has shape "
                               r"\(4, 120\) for these inputs, \(4, 60\)")):
        mod = pkg.mod.BucketingModule(_flat_lm(pkg), default_bucket_key=10,
                                      context=pkg.cpu())
        mod.bind([("data", (8, 10, 6))], [("softmax_label", (8,))])
        mod.init_params(pkg.init.Xavier())
        mod.init_optimizer(optimizer="sgd")
        batch = pkg.io.DataBatch(
            [pkg.nd.array(np.ones((8, 20, 6), "float32"), ctx=pkg.cpu())],
            [pkg.nd.array(np.zeros(8, "float32"), ctx=pkg.cpu())],
            bucket_key=20, provide_data=[("data", (8, 20, 6))],
            provide_label=[("softmax_label", (8,))])
        with pytest.raises(error, match=match):
            mod.forward_backward(batch)
            mod.update()


@pytest.mark.parametrize("fused_step", [True, False],
                         ids=["fused_step", "eager_step"])
def test_switching_matches_mxtpu(monkeypatch, fused_step):
    """The same switches in mxtpu, where an eager switch copies through
    the host: the weights within FIT_TOL, the compiles alike."""
    out = {}
    for pkg in (mt, mx):
        mod, batch_for = _switching(pkg, fused_step, monkeypatch)
        mod.set_params(*[{k: pkg.nd.array(v, ctx=pkg.cpu())
                          for k, v in table.items()}
                         for table in _switch_start()])
        metric = pkg.metric.create("acc")
        for key in (10, 20, 10, 20, 20, 10, 10, 20):
            b = batch_for(key)
            mod.forward_backward(b)
            mod.update()
            mod.update_metric(metric, b.label)
        out[pkg] = (_params(mod), metric.get(),
                    mod._buckets[20]._fused._group.stats["compiles"]
                    if fused_step else None)
    _assert_params(out[mt][0], out[mx][0], FIT_TOL)
    assert out[mt][1][0] == out[mx][1][0]
    np.testing.assert_allclose(out[mt][1][1], out[mx][1][1], rtol=1e-6)
    assert out[mt][2] == out[mx][2]


def _switch_start():
    rng = np.random.RandomState(9)
    return ({"fc1_weight": rng.uniform(-0.3, 0.3, (16, 6)).astype("f4"),
             "fc1_bias": np.zeros(16, "f4"),
             "fc2_weight": rng.uniform(-0.3, 0.3, (4, 16)).astype("f4"),
             "fc2_bias": np.zeros(4, "f4")}, {})


# -- artifacts across the packages ----------------------------------------------

def _lm_symbol(pkg, smoke, fused, mode="lstm", seq_len=8):
    """The example's sym_gen(seq_len) at the small widths, built through a
    BucketingModule of lstm_bucketing_fit (never fitted)."""
    sentences, vocab = _corpus(smoke)
    with pkg.cpu():
        mod, _, _ = smoke.lstm_bucketing_fit(
            pkg, sentences, vocab, fused, mode=mode, num_epoch=0, **SMALL)
    return mod._sym_gen(seq_len)[0], mod


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused_cell", "lstm_cells"])
def test_lm_symbol_json_crosses(smoke, fused):
    """The LM's symbol JSON saved by either package loads in the other,
    with the same arguments and inferred shapes, and computes the same
    outputs from the same weights."""
    syms = {pkg: _lm_symbol(pkg, smoke, fused)[0] for pkg in (mt, mx)}
    shapes = {"data": (8, 8), "softmax_label": (8, 8)}
    rng = np.random.RandomState(1)
    args = None
    for src, dst in ((mt, mx), (mx, mt)):
        loaded = dst.sym.load_json(syms[src].tojson())
        assert loaded.list_arguments() == syms[dst].list_arguments()
        got_shapes = loaded.infer_shape(**shapes)[0]
        assert [tuple(s) for s in got_shapes] == \
            [tuple(s) for s in syms[dst].infer_shape(**shapes)[0]]
        if args is None:
            args = {n: (rng.randint(1, 16, s) if n in shapes else
                        rng.uniform(-0.2, 0.2, s)).astype(np.float32)
                    for n, s in zip(loaded.list_arguments(), got_shapes)}
        outs = []
        for pkg, sym in ((dst, loaded), (dst, syms[dst])):
            exe = sym.simple_bind(ctx=pkg.cpu(), grad_req="null",
                                  **{k: v.shape for k, v in args.items()})
            outs.append(exe.forward(**{k: pkg.nd.array(v, ctx=pkg.cpu())
                                       for k, v in args.items()})[0]
                        .asnumpy())
        np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-7)


def test_gru_cell_json_with_a_number_stays_one_way():
    """ROADMAP A3, closed (the name is kept from when the test pinned the
    fault): GRUCell's ``1.0 - update`` is a ``_rminus_scalar`` node in
    the port's JSON, which mxtpu loads, and a ``_scalar_1.0`` constant
    in mxtpu's, which the port now loads as that number: not an
    argument, the same inferred shapes, and the same outputs from the
    same weights in both packages."""
    def gru(pkg):
        with pkg.name.NameManager():
            out, _ = pkg.rnn.GRUCell(4, prefix="gru_").unroll(
                2, inputs=pkg.sym.var("data"), merge_outputs=True)
        return out
    ported = mx.sym.load_json(gru(mt).tojson())
    assert ported.infer_shape(data=(3, 2, 5))[1] == [(3, 2, 4)]
    want = gru(mx)
    from_mxtpu = mt.sym.load_json(want.tojson())
    assert "_scalar_1.0" in want.tojson()
    assert from_mxtpu.list_arguments() == want.list_arguments()
    shapes = from_mxtpu.infer_shape(data=(3, 2, 5))
    assert shapes == want.infer_shape(data=(3, 2, 5))
    assert shapes[1] == [(3, 2, 4)]
    rng = np.random.RandomState(0)
    args = {n: rng.uniform(-1, 1, s).astype(np.float32)
            for n, s in zip(want.list_arguments(), shapes[0])}
    outs = []
    for pkg, sym in ((mt, from_mxtpu), (mx, want)):
        exe = sym.simple_bind(ctx=pkg.cpu(), grad_req="null",
                              data=(3, 2, 5))
        outs.append(exe.forward(**{k: pkg.nd.array(v, ctx=pkg.cpu())
                                   for k, v in args.items()})[0].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-7)
    assert mx.sym.load_json(from_mxtpu.tojson()).list_arguments() == \
        want.list_arguments()


@pytest.mark.parametrize("fused", [True, False],
                         ids=["fused_cell", "lstm_cells"])
def test_trained_weights_cross(smoke, fused):
    """An mxtpu bucketing LM's get_params() (the fused blob or the
    lstm_l%d_* weights) loads into the port through params_from_numpy
    and set_params, and the port's into mxtpu: the two modules then give
    the same outputs on a batch of each bucket."""
    sentences, vocab = _corpus(smoke)
    mods = {pkg: _lm_symbol(pkg, smoke, fused)[1] for pkg in (mt, mx)}
    rng = np.random.RandomState(2)
    for src, dst in ((mx, mt), (mt, mx)):
        args, auxs = mods[src].get_params()
        if dst is mt:
            args, auxs = mt.model.params_from_numpy(args, auxs, ctx=mt.cpu())
        else:
            args = {k: mx.nd.array(v.asnumpy()) for k, v in args.items()}
            auxs = {k: mx.nd.array(v.asnumpy()) for k, v in auxs.items()}
        mods[dst].set_params(args, auxs)
        for key in SMALL["buckets"]:
            x = rng.randint(1, vocab, (8, key)).astype(np.float32)
            outs = []
            for pkg in (src, dst):
                batch = pkg.io.DataBatch(
                    [pkg.nd.array(x, ctx=pkg.cpu())],
                    [pkg.nd.array(x, ctx=pkg.cpu())], bucket_key=key,
                    provide_data=[("data", (8, key))],
                    provide_label=[("softmax_label", (8, key))])
                mods[pkg].forward(batch, is_train=False)
                outs.append(mods[pkg].get_outputs()[0].asnumpy())
            np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5,
                                       atol=1e-7)
