"""RNN checkpoints (mx.rnn.save_rnn_checkpoint / load_rnn_checkpoint /
do_rnn_checkpoint, ROADMAP A18) against mxtpu's, and the GRU and
bidirectional cases of tests/test_rnn_variants.py through the port's RNN
op, on the CPU.

A FusedRNNCell's checkpoint holds its weights unpacked into per-gate
arrays, so one file serves the fused cell and the LSTMCells it unfuses
into, in either package: files cross both ways and pack to the same
blob. chip_smoke.py's checkpoint phase runs here at a small size
(vocabulary 40, embed and hidden 12, batch 8, buckets 8 and 16, 64
sentences): the last checkpoint scores
the same batches unfused as the fused module (float32 sums in another
order: 1e-5 relative), and a run resumed at epoch 1 from its checkpoint
and optimizer states ends where the run never stopped ends (the same
operations on the same batches: 1e-6).
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401
from mxtpu.ops import rnn as jrnn
from mxtpu_torch.ops import rnn as trnn

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _load("chip_smoke", ROOT / "chip_smoke.py")
variants = _load("rnn_variants", ROOT / "tests" / "test_rnn_variants.py")

VOCAB, H = 16, 8


def _fused_args(seed=0):
    rng = np.random.RandomState(seed)
    size = jrnn.rnn_param_size("lstm", H, H, cs.BL_LAYERS, False)
    return {"lstm_parameters": rng.uniform(-0.5, 0.5, size).astype("f"),
            "embed_weight": rng.uniform(-0.5, 0.5, (VOCAB, H)).astype("f"),
            "pred_weight": rng.uniform(-0.5, 0.5, (VOCAB, H)).astype("f"),
            "pred_bias": rng.uniform(-0.5, 0.5, VOCAB).astype("f")}


@pytest.fixture(autouse=True)
def _on_the_cpu():
    with mt.cpu():
        yield


@pytest.mark.parametrize("saver,loader", [(mt, mx), (mx, mt)])
def test_checkpoint_files_cross_both_ways(tmp_path, saver, loader):
    """A FusedRNNCell's checkpoint saved by one package loads in the
    other: the same unpacked names in the file, the same packed blob back
    (and the same per-gate arrays for the unfused LSTMCells)."""
    args = _fused_args()
    prefix = str(tmp_path / "lm")
    sym = cs.lstm_sym_gen(saver, VOCAB, True, num_hidden=H, num_embed=H)(4)[0]
    saver.rnn.save_rnn_checkpoint(
        cs.lstm_rnn_cell(saver, True, num_hidden=H), prefix, 3, sym,
        {k: saver.nd.array(v, ctx=saver.cpu()) for k, v in args.items()},
        {})
    raw = loader.nd.load("%s-0003.params" % prefix)
    assert "arg:lstm_parameters" not in raw
    assert "arg:lstm_l1_h2h_f_weight" in raw
    _s, got, _a = loader.rnn.load_rnn_checkpoint(
        cs.lstm_rnn_cell(loader, True, num_hidden=H), prefix, 3)
    for k, v in args.items():
        np.testing.assert_array_equal(got[k].asnumpy(), v, err_msg=k)
    _s, per_gate, _a = loader.rnn.load_rnn_checkpoint(
        cs.lstm_rnn_cell(loader, False, num_hidden=H), prefix, 3)
    _s, want, _a = saver.rnn.load_rnn_checkpoint(
        cs.lstm_rnn_cell(saver, False, num_hidden=H), prefix, 3)
    assert sorted(per_gate) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(per_gate[k].asnumpy(),
                                      want[k].asnumpy(), err_msg=k)


def test_do_rnn_checkpoint_period(tmp_path):
    saved = []
    cell = cs.lstm_rnn_cell(mt, True, num_hidden=H)
    args = {k: mt.nd.array(v, ctx=mt.cpu()) for k, v in _fused_args().items()}
    sym = cs.lstm_sym_gen(mt, VOCAB, True, num_hidden=H, num_embed=H)(4)[0]
    cb = mt.rnn.do_rnn_checkpoint(cell, str(tmp_path / "p"), period=2)
    for epoch in range(5):
        cb(epoch, sym, args, {})
    saved = sorted(p.name for p in tmp_path.glob("p-*.params"))
    assert saved == ["p-0002.params", "p-0004.params"]


@pytest.fixture(scope="module")
def small_phase(tmp_path_factory):
    """chip_smoke.py's checkpoint phase at a small size on the CPU: the
    fit, the scores and the resumed run."""
    saved = {k: getattr(cs, k) for k in ("RC_VOCAB", "BL_HIDDEN",
                                         "BL_EMBED", "BL_BATCH",
                                         "BL_BUCKETS")}
    cs.RC_VOCAB, cs.BL_HIDDEN, cs.BL_EMBED, cs.BL_BATCH = 40, 12, 12, 8
    cs.BL_BUCKETS = (8, 16)
    cpu = mt.cpu()
    prefix = str(tmp_path_factory.mktemp("rnn_ckpt") / "lm")
    try:
        corpus, _ = cs.synthetic_corpus(200, cs.RC_VOCAB, 0)
        sentences = [x for x in corpus if len(x) <= 16][:64]
        with cpu:
            mod, train = cs.rnn_ckpt_fit(mt, sentences, prefix, ctx=cpu)
            final = cs.module_params(mod)
            # a Context entered again inside its own scope would leave
            # itself the default on leaving (mxtpu's rule): a fresh cpu()
            scores = cs.rnn_ckpt_scores(mt, mod, sentences, prefix,
                                        mt.cpu())
            start, resumed = cs.rnn_ckpt_resume(mt, sentences, prefix, cpu)
        yield dict(final=final, scores=scores, start=start, resumed=resumed,
                   steps=len(train.inner.idx), prefix=prefix)
    finally:
        for k, v in saved.items():
            setattr(cs, k, v)


def test_fused_checkpoint_scores_equally_unfused(small_phase):
    fused, unfused, n, _launches = small_phase["scores"]
    assert n >= 8
    assert unfused == pytest.approx(fused, rel=1e-5)
    for epoch in range(1, cs.RC_EPOCHS + 1):
        for ext in ("params", "states"):
            assert pathlib.Path("%s-%04d.%s" % (small_phase["prefix"], epoch,
                                                ext)).exists()


def test_resumed_run_ends_where_the_uninterrupted_one_ends(small_phase):
    final, resumed = small_phase["final"], small_phase["resumed"]
    start = small_phase["start"]
    assert sorted(final) == sorted(resumed) == sorted(start)
    for k in final:
        assert np.abs(final[k] - start[k]).max() > 0     # it trained on
        np.testing.assert_allclose(resumed[k], final[k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def _port_rnn(data, params, state, cell, mode, L, D, H_, **kw):
    args = [torch.from_numpy(a) for a in (data, params, state)]
    if mode == "lstm":
        args.append(torch.from_numpy(cell))
    return trnn.rnn(*args, state_size=H_, num_layers=L,
                    bidirectional=(D == 2), mode=mode, state_outputs=True,
                    **kw)


GRID = [("gru", L, D) for L in (1, 2, 3) for D in (1, 2)] + \
    [(m, L, 2) for m in ("rnn_relu", "rnn_tanh", "lstm") for L in (1, 2, 3)]


@pytest.mark.parametrize("mode,L,D", GRID)
def test_rnn_variants_forward_grid(mode, L, D):
    """test_rnn_variants.py's forward grid, its GRU and bidirectional
    cases, through the port's op against that file's numpy oracle (its
    tolerance)."""
    H_ = 4
    data, params, state, cell = variants._mk(mode, L, D, seed=11 * L + D)
    outs = _port_rnn(data, params, state, cell, mode, L, D, H_)
    ref = variants._np_rnn(data, params, state,
                           np.zeros_like(cell) if mode != "lstm" else cell,
                           mode, L, D, H_)
    for got, want in zip(outs, ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("mode,D", [("gru", 1), ("gru", 2), ("lstm", 2),
                                    ("rnn_tanh", 2)])
def test_rnn_variants_gradients(mode, D):
    """The gradient grid's GRU and bidirectional cases (2 layers): the
    port's autograd gradients of the summed output against mxtpu's
    executor backward, every input (data, blob, states)."""
    L, H_, T, N, I = 2, 3, 3, 2, 2
    data, params, state, cell = variants._mk(mode, L, D, T=T, N=N, I=I,
                                             H=H_, seed=5 + D)
    names = ["a0", "a1", "a2"] + (["a3"] if mode == "lstm" else [])
    values = [data, params, state] + ([cell] if mode == "lstm" else [])
    sym = mx.sym.RNN(*[mx.sym.var(n) for n in names], state_size=H_,
                     num_layers=L, bidirectional=(D == 2), mode=mode)
    ex = sym.simple_bind(ctx=mx.cpu(), grad_req="write",
                         **{n: v.shape for n, v in zip(names, values)})
    for n, v in zip(names, values):
        ex.arg_dict[n][:] = v
    out = ex.forward(is_train=True)[0]
    ex.backward(mx.nd.ones(out.shape))
    leaves = [torch.from_numpy(v).requires_grad_() for v in values]
    y = trnn.rnn(*leaves, state_size=H_, num_layers=L,
                 bidirectional=(D == 2), mode=mode)
    y = y[0] if isinstance(y, tuple) else y
    y.sum().backward()
    for n, leaf in zip(names, leaves):
        np.testing.assert_allclose(leaf.grad.numpy(),
                                   ex.grad_dict[n].asnumpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_gru_state_carry_between_calls():
    """T steps in one call equal two T/2 calls with the first's final
    state feeding the second (test_rnn_variants.py's state carry, GRU)."""
    mode, L, D, H_ = "gru", 2, 1, 4
    data, params, state, cell = variants._mk(mode, L, D, T=6, seed=3)
    full = _port_rnn(data, params, state, cell, mode, L, D, H_)
    first = _port_rnn(data[:3], params, state, cell, mode, L, D, H_)
    second = _port_rnn(data[3:], params, first[1].numpy(), cell, mode, L, D,
                       H_)
    joined = torch.cat([first[0], second[0]])
    np.testing.assert_allclose(joined.numpy(), full[0].numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(second[1].numpy(), full[1].numpy(),
                               rtol=1e-5, atol=1e-6)
