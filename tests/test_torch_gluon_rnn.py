"""The port's Gluon RNN layers and the Gluon word LM against mxtpu's, on
the CPU.

- ``gluon.rnn.LSTM`` / ``GRU`` / ``RNN`` layers (1-2 layers, TNC and NTC,
  bidirectional, with and without begin states) from the same weights:
  outputs, final states and every gradient within TOL.
- The LM of example/gluon/word_language_model.py (``chip_smoke.py``'s
  ``gluon_rnn_model`` / ``gluon_lm_train``: an eager Block with an
  Embedding, the fused LSTM or GRU layer and a Dense decoder; Adam with
  ``clip_gradient``; SoftmaxCrossEntropyLoss over ``reshape((-3, 0))``) at
  the example's widths, 2 steps in either package from the same weights:
  each step's loss within TOL; the weights within SPREAD times what the
  port's own run moves them from weights one ulp apart (Adam divides by
  the root of the squared gradient, so a rounding-size gradient moves its
  weight by a whole step: float32 runs part by a share of their move, as
  PR 11's and chip_smoke.py's RN_SPREAD checks hold them), plus ATOL of
  the move.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-5, atol=1e-5)
# readings: apart 9.5e-7 / 7.9e-7 of the move, the port's own one-ulp
# spread 2.1e-6 / 2.4e-6 (LSTM / GRU)
SPREAD, ATOL = 2.0, 1e-6


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", str(ROOT / "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LAYERS = {
    # name: (constructor, layout, with begin states)
    "lstm": (lambda r: r.LSTM(8, input_size=5), "TNC", False),
    "lstm2-states": (lambda r: r.LSTM(8, num_layers=2, input_size=5),
                     "TNC", True),
    "lstm-ntc-bidir": (lambda r: r.LSTM(6, layout="NTC", input_size=5,
                                        bidirectional=True), "NTC", True),
    "gru": (lambda r: r.GRU(8, input_size=5), "TNC", False),
    "gru2-bidir-states": (lambda r: r.GRU(4, num_layers=2, input_size=5,
                                          bidirectional=True), "TNC", True),
    "rnn-tanh": (lambda r: r.RNN(7, activation="tanh", input_size=5),
                 "TNC", True),
    "lstm-deferred": (lambda r: r.LSTM(8), "TNC", False),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_rnn_layer_matches_mxtpu(name):
    make, layout, with_states = LAYERS[name]
    T, N, C = 6, 3, 5
    shape = (T, N, C) if layout == "TNC" else (N, T, C)
    x = np.random.RandomState(len(name)).rand(*shape).astype(np.float32)

    def case(pkg, weights=None):
        ctx = pkg.cpu()
        layer = make(pkg.gluon.rnn)
        layer.initialize(ctx=ctx)
        xa = pkg.nd.array(x, ctx=ctx)
        if weights is None:
            layer(xa)            # deferred shapes
            weights = {k: v.data().asnumpy()
                       for k, v in layer.collect_params().items()}
        else:
            params = layer.collect_params()
            layer(xa)
            for k in params.keys():
                params[k].set_data(pkg.nd.array(weights[k], ctx=ctx))
        xa.attach_grad()
        with pkg.autograd.record():
            if with_states:
                states = layer.begin_state(N, ctx=ctx)
                out, new = layer(xa, states)
                head = out.sum() + sum((s * s).sum() for s in new)
            else:
                out = layer(xa)
                new = []
                head = out.sum()
        head.backward()
        return ([out.asnumpy()] + [s.asnumpy() for s in new]
                + [xa.grad.asnumpy()]
                + [p.grad().asnumpy()
                   for p in layer.collect_params().values()]), weights
    want, weights = case(mx)
    with mt.cpu():
        got, _ = case(mt, weights)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_word_lm_two_steps_match_mxtpu(smoke, mode):
    vocab, embed, hidden, layers, bptt, batch = smoke.GL_LM_EXAMPLE
    rng = np.random.RandomState(0)
    data = smoke.lm_batchify(smoke.markov_corpus(bptt * batch * 3, vocab,
                                                 rng), batch)
    w0 = smoke.gluon_weights(
        mt, smoke.gluon_rnn_model(mt, vocab, embed, hidden, layers, mode),
        0, np.zeros((1, 1), np.float32), init=mt.init.Xavier())

    def run(pkg, weights):
        with pkg.cpu():
            model = smoke.gluon_load(pkg, smoke.gluon_rnn_model(
                pkg, vocab, embed, hidden, layers, mode), weights, pkg.cpu())
            _, losses = smoke.gluon_lm_train(pkg, model, data, pkg.cpu(),
                                             bptt, batch, steps=2)
            return smoke.gluon_values(model), losses
    got, want = run(mt, w0), run(mx, w0)
    ulp = run(mt, smoke.ulp_apart(w0, 0))
    assert sorted(got[0]) == sorted(want[0]) == sorted(w0)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    apart = smoke.norm_share(got[0], want[0], w0)
    spread = smoke.norm_share(ulp[0], got[0], w0)
    assert apart <= SPREAD * spread + ATOL, (apart, spread)
    # the embedding rows no token of the two steps used stay put
    emb = "rnnmodel0_embedding0_weight"
    used = np.unique(np.concatenate([data[:bptt], data[bptt:2 * bptt]]))
    unused = np.setdiff1d(np.arange(vocab), used)
    np.testing.assert_array_equal(got[0][emb][unused], w0[emb][unused])


def test_word_lm_layer_names_and_states(smoke):
    """The model's parameter names equal mxtpu's; begin_state makes zero
    states on the given context."""
    with mt.cpu():
        t = smoke.gluon_rnn_model(mt, 50, 8, 8, 2, "lstm")
        states = t.lstm.begin_state(4, ctx=mt.cpu())
    m = smoke.gluon_rnn_model(mx, 50, 8, 8, 2, "lstm")
    assert list(t.collect_params().keys()) == list(m.collect_params().keys())
    assert [s.shape for s in states] == [(2, 4, 8), (2, 4, 8)]
    assert all(float(np.abs(s.asnumpy()).sum()) == 0 for s in states)
    assert states[0].context == mt.cpu()
