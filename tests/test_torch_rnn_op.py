"""The port's fused RNN op (mxtpu_torch/ops/rnn.py) against mxtpu's RNN op
on the same seeded inputs: every mode, one and two layers, both
directions, final states, cell clipping, and the cuDNN blob layout."""
import numpy as np
import pytest
import torch

import mxtpu as mx
from mxtpu.ops import rnn as jrnn
from mxtpu_torch.ops import rnn as trnn
from torch_threads import torch_threads_shared  # noqa: F401

# f32 over at most 2 layers x 5 steps of width 4-6: summation order only
TOL = dict(atol=1e-5, rtol=1e-5)
T, N, I, H = 5, 3, 6, 4


def _case(mode, layers, bidirectional, seed=7):
    rng = np.random.RandomState(seed)
    D = 2 if bidirectional else 1
    psize = jrnn.rnn_param_size(mode, I, H, layers, bidirectional)
    return dict(
        x=rng.standard_normal((T, N, I)).astype(np.float32),
        params=(rng.standard_normal(psize) * 0.3).astype(np.float32),
        h0=(rng.standard_normal((layers * D, N, H)) * 0.5).astype(np.float32),
        c0=(rng.standard_normal((layers * D, N, H)) * 0.5).astype(np.float32))


def _run_both(mode, layers, bidirectional, **kw):
    c = _case(mode, layers, bidirectional)
    cell = [c["c0"]] if mode == "lstm" else []
    common = dict(state_size=H, num_layers=layers, mode=mode,
                  bidirectional=bidirectional, **kw)
    want = mx.nd.RNN(*[mx.nd.array(a) for a in
                       [c["x"], c["params"], c["h0"]] + cell], **common)
    got = trnn.rnn(*[torch.from_numpy(a) for a in
                     [c["x"], c["params"], c["h0"]] + cell], **common)
    want = want if isinstance(want, (list, tuple)) else [want]
    got = got if isinstance(got, tuple) else (got,)
    return [w.asnumpy() for w in want], [g.numpy() for g in got]


def _assert_close(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
@pytest.mark.parametrize("layers,bidirectional",
                         [(1, False), (2, False), (2, True)])
def test_rnn_op_matches_mxtpu(mode, layers, bidirectional):
    _assert_close(*_run_both(mode, layers, bidirectional,
                             state_outputs=True))


@pytest.mark.parametrize("mode", ["lstm", "rnn_relu"])
def test_rnn_op_output_only(mode):
    want, got = _run_both(mode, 2, True, state_outputs=False)
    assert len(got) == 1
    _assert_close(want, got)


def test_lstm_state_clip_matches_mxtpu():
    _assert_close(*_run_both("lstm", 2, False, state_outputs=True,
                             lstm_state_clip_min=-0.2,
                             lstm_state_clip_max=0.2))


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_op_matches_mxtpu_pallas_path(mode):
    """The JAX side through its interpreted Pallas kernels."""
    try:
        jrnn.USE_PALLAS_RNN = True
        want, got = _run_both(mode, 2, True, state_outputs=True)
    finally:
        jrnn.USE_PALLAS_RNN = None
    _assert_close(want, got)


def test_dropout_only_in_training():
    c = _case("lstm", 2, False)
    args = [torch.from_numpy(c[k]) for k in ("x", "params", "h0", "c0")]
    kw = dict(state_size=H, num_layers=2, mode="lstm")
    plain = trnn.rnn(*args, **kw)
    inference = trnn.rnn(*args, p=0.5, _training=False, **kw)
    assert torch.equal(plain, inference)
    trained = trnn.rnn(*args, p=0.5, _training=True, **kw)
    assert not torch.equal(plain, trained)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh"])
@pytest.mark.parametrize("layers,dirs", [(1, 1), (2, 2), (3, 1)])
def test_blob_blocks_equal_mxtpu(mode, layers, dirs):
    assert trnn.rnn_blob_blocks(mode, 7, 5, layers, dirs) == \
        jrnn.rnn_blob_blocks(mode, 7, 5, layers, dirs)
    assert trnn.rnn_param_size(mode, 7, 5, layers, dirs == 2) == \
        jrnn.rnn_param_size(mode, 7, 5, layers, dirs == 2)


@pytest.mark.parametrize("mode,layers,bidirectional",
                         [("lstm", 2, False), ("gru", 1, True)])
def test_fused_cell_unpack_and_pack_match_mxtpu(mode, layers, bidirectional):
    import mxtpu_torch as mt
    psize = jrnn.rnn_param_size(mode, I, H, layers, bidirectional)
    blob = np.random.RandomState(3).standard_normal(psize).astype(np.float32)
    jcell = mx.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                bidirectional=bidirectional, prefix="x_")
    tcell = mt.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                bidirectional=bidirectional, prefix="x_")
    want = jcell.unpack_weights({"x_parameters": mx.nd.array(blob)})
    got = tcell.unpack_weights({"x_parameters": mt.nd.array(blob,
                                                            ctx=mt.cpu())})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())
    packed = tcell.pack_weights(got)
    assert list(packed) == ["x_parameters"]
    np.testing.assert_array_equal(packed["x_parameters"].asnumpy(), blob)
