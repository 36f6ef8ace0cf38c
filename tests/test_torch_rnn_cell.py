"""The port's symbolic RNN cells (mxtpu_torch/rnn/rnn_cell.py) and the ops
they emit against mxtpu's, on the CPU.

Each cell is unrolled in both packages over the same numpy-seeded inputs
and weights, bound by an executor, run forward in training mode and
differentiated under the same head gradients: outputs and every
argument's gradient within TOL (float32, 5 steps of width 32: the sums
of the gate products in another order). mxtpu's fused RNN op runs on the
CPU through its plain scan, as its own tests run it. The cells whose
training forward draws random masks (DropoutCell, ZoneoutCell) are
compared in inference, where both packages' masks are ones. The fused
cell's parameter blob: FusedRNN draws its blocks in mxtpu's order
(a counting initializer gives the same blob in both), the default Xavier
blob has mxtpu's bounds, zero biases and the forget bias, and
unpack_weights / pack_weights / unfuse() agree with mxtpu and with the
fused cell.
"""
import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt

TOL = dict(atol=1e-5, rtol=1e-5)
T, N, C, H = 5, 8, 16, 32


def _sequential(pkg):
    stack = pkg.rnn.SequentialRNNCell()
    stack.add(pkg.rnn.LSTMCell(H, prefix="l0_"))
    stack.add(pkg.rnn.GRUCell(H, prefix="l1_"))
    return stack


def _dropout_stack(pkg):
    stack = pkg.rnn.SequentialRNNCell()
    stack.add(pkg.rnn.LSTMCell(H, prefix="l0_"))
    stack.add(pkg.rnn.DropoutCell(0.5, prefix="drop_"))
    stack.add(pkg.rnn.LSTMCell(H, prefix="l1_"))
    return stack


# name: (cell maker, input width, layout, trained)
CELLS = {
    "rnn_tanh": (lambda pkg: pkg.rnn.RNNCell(H, activation="tanh"), C,
                 "NTC", True),
    "rnn_relu": (lambda pkg: pkg.rnn.RNNCell(H, activation="relu"), C,
                 "NTC", True),
    "lstm": (lambda pkg: pkg.rnn.LSTMCell(H, prefix="lstm_"), C, "NTC",
             True),
    "gru": (lambda pkg: pkg.rnn.GRUCell(H, prefix="gru_"), C, "NTC", True),
    "sequential": (_sequential, C, "NTC", True),
    "bidirectional": (lambda pkg: pkg.rnn.BidirectionalCell(
        pkg.rnn.LSTMCell(H, prefix="l_"), pkg.rnn.LSTMCell(H, prefix="r_")),
        C, "NTC", True),
    "residual": (lambda pkg: pkg.rnn.ResidualCell(
        pkg.rnn.GRUCell(H, prefix="gru_")), H, "NTC", True),
    "fused_lstm": (lambda pkg: pkg.rnn.FusedRNNCell(
        H, num_layers=2, mode="lstm", prefix="lstm_"), C, "NTC", True),
    "fused_gru_bi": (lambda pkg: pkg.rnn.FusedRNNCell(
        H, num_layers=1, mode="gru", bidirectional=True, prefix="gru_"), C,
        "NTC", True),
    "dropout_stack": (_dropout_stack, C, "NTC", False),
    "zoneout": (lambda pkg: pkg.rnn.ZoneoutCell(
        pkg.rnn.LSTMCell(H, prefix="lstm_"), zoneout_outputs=0.3,
        zoneout_states=0.3), C, "NTC", False),
}


def _unrolled(pkg, name):
    make, width, layout, _ = CELLS[name]
    with pkg.name.NameManager():
        cell = make(pkg)
        outputs, _ = cell.unroll(T, inputs=pkg.sym.var("data"),
                                 layout=layout, merge_outputs=True)
    shape = (N, T, width) if layout == "NTC" else (T, N, width)
    return outputs, shape


def _inputs(name, seed=3):
    """{arg: numpy} drawn from the port's inferred shapes, and the head
    gradient."""
    sym, shape = _unrolled(mt, name)
    arg_shapes, out_shapes, _ = sym.infer_shape(data=shape)
    rng = np.random.RandomState(seed)
    args = {n: (rng.standard_normal(s) * (1.0 if n == "data" else 0.3))
            .astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    cot = rng.standard_normal(out_shapes[0]).astype(np.float32)
    return args, cot


def _run(pkg, name, args, cot, training):
    sym, _ = _unrolled(pkg, name)
    exe = sym.simple_bind(ctx=pkg.cpu(), grad_req="write",
                          **{k: v.shape for k, v in args.items()})
    out = exe.forward(is_train=training,
                      **{k: pkg.nd.array(v, ctx=pkg.cpu())
                         for k, v in args.items()})[0].asnumpy()
    if not training:
        return out, {}
    exe.backward(out_grads=[pkg.nd.array(cot, ctx=pkg.cpu())])
    return out, {k: exe.grad_dict[k].asnumpy() for k in args}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_unroll_matches_mxtpu(name):
    """Same argument names in the same order, the same outputs and the
    same gradient of every argument."""
    args, cot = _inputs(name)
    assert _unrolled(mt, name)[0].list_arguments() == \
        _unrolled(mx, name)[0].list_arguments()
    trained = CELLS[name][3]
    got, got_grads = _run(mt, name, args, cot, trained)
    want, want_grads = _run(mx, name, args, cot, trained)
    np.testing.assert_allclose(got, want, **TOL)
    assert sorted(got_grads) == sorted(want_grads)
    for k in want_grads:
        np.testing.assert_allclose(got_grads[k], want_grads[k], **TOL,
                                   err_msg=k)


def test_begin_state_func_and_names():
    """begin_state(func=) calls func with each state's name and shape, as
    mxtpu's does; the default states are named alike in both."""
    for pkg in (mt, mx):
        cell = pkg.rnn.LSTMCell(H, prefix="lstm_")
        seen = []

        def func(name, shape=(), **kw):
            seen.append((name, tuple(shape), kw))
            return pkg.sym.var(name)
        states = cell.begin_state(func=func, dtype="float32")
        assert seen == [("lstm_begin_state_0", (0, H), {"dtype": "float32"}),
                        ("lstm_begin_state_1", (0, H), {"dtype": "float32"})]
        assert [s.name for s in states] == ["lstm_begin_state_0",
                                            "lstm_begin_state_1"]
    names = [[s.name for s in pkg.rnn.GRUCell(H, prefix="g_").begin_state()]
             for pkg in (mt, mx)]
    assert names[0] == names[1]


def test_modified_base_cell_refuses_begin_state():
    cell = mt.rnn.LSTMCell(H, prefix="lstm_")
    mt.rnn.ZoneoutCell(cell, zoneout_outputs=0.5)
    with pytest.raises(RuntimeError, match="modifier"):
        cell.begin_state()
    with pytest.raises(TypeError, match="zoneout"):
        mt.rnn.ZoneoutCell(mt.rnn.FusedRNNCell(H))


# -- weights: per-gate views, the fused blob ----------------------------------

@pytest.mark.parametrize("mode,layers,bidirectional", [
    ("lstm", 2, False), ("gru", 1, True), ("rnn_tanh", 2, False)])
def test_fused_unpack_pack_round_trip(mode, layers, bidirectional):
    """unpack_weights names and slices the blob as mxtpu's does, and
    pack_weights puts it back bit for bit."""
    from mxtpu_torch.ops.rnn import rnn_param_size
    size = rnn_param_size(mode, C, H, layers, bidirectional)
    blob = np.random.RandomState(5).standard_normal(size).astype(np.float32)
    cells = [pkg.rnn.FusedRNNCell(H, num_layers=layers, mode=mode,
                                  bidirectional=bidirectional,
                                  prefix="%s_" % mode) for pkg in (mt, mx)]
    got = cells[0].unpack_weights({"%s_parameters" % mode:
                                   mt.nd.array(blob, ctx=mt.cpu())})
    want = cells[1].unpack_weights({"%s_parameters" % mode:
                                    mx.nd.array(blob)})
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())
    packed = cells[0].pack_weights(got)
    assert list(packed) == ["%s_parameters" % mode]
    np.testing.assert_array_equal(packed["%s_parameters" % mode].asnumpy(),
                                  blob)


def test_cell_unpack_pack_round_trip():
    """An unfused cell's per-gate views and their concatenation, both
    packages alike."""
    rng = np.random.RandomState(6)
    full = {"lstm_i2h_weight": rng.standard_normal((4 * H, C)),
            "lstm_i2h_bias": rng.standard_normal(4 * H),
            "lstm_h2h_weight": rng.standard_normal((4 * H, H)),
            "lstm_h2h_bias": rng.standard_normal(4 * H)}
    full = {k: v.astype(np.float32) for k, v in full.items()}
    out = {}
    for pkg in (mt, mx):
        cell = pkg.rnn.LSTMCell(H, prefix="lstm_")
        kw = {"ctx": pkg.cpu()}
        gates = cell.unpack_weights({k: pkg.nd.array(v, **kw)
                                     for k, v in full.items()})
        out[pkg] = {k: v.asnumpy() for k, v in gates.items()}
        back = cell.pack_weights(gates)
        for k, v in full.items():
            np.testing.assert_array_equal(back[k].asnumpy(), v)
    assert sorted(out[mt]) == sorted(out[mx])
    for k in out[mx]:
        np.testing.assert_array_equal(out[mt][k], out[mx][k])


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_unfuse_matches_the_fused_cell(mode):
    """unfuse()'s stack of LSTMCells / GRUCells, given the blob through
    unpack_weights and the stack's pack_weights, computes what the fused
    cell computes, in the port and in mxtpu."""
    fused = mt.rnn.FusedRNNCell(H, num_layers=2, mode=mode, prefix="f_")
    with mt.name.NameManager():
        fsym, _ = fused.unroll(T, inputs=mt.sym.var("data"),
                               merge_outputs=True)
    stack = fused.unfuse()
    with mt.name.NameManager():
        usym, _ = stack.unroll(T, inputs=mt.sym.var("data"),
                               merge_outputs=True)
    arg_shapes, _, _ = fsym.infer_shape(data=(N, T, C))
    rng = np.random.RandomState(8)
    args = {n: (rng.standard_normal(s) * 0.3).astype(np.float32)
            for n, s in zip(fsym.list_arguments(), arg_shapes)}
    blob = {"f_parameters": mt.nd.array(args["f_parameters"], ctx=mt.cpu())}
    unfused = stack.pack_weights(fused.unpack_weights(blob))
    outs = []
    for sym, weights in ((fsym, blob), (usym, unfused)):
        feed = {"data": mt.nd.array(args["data"], ctx=mt.cpu())}
        feed.update(weights)
        exe = sym.simple_bind(ctx=mt.cpu(), grad_req="null",
                              **{k: v.shape for k, v in feed.items()})
        outs.append(exe.forward(**feed)[0].asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], **TOL)
    assert [type(c).__name__ for c in stack._cells] == \
        [type(c).__name__ for c in mx.rnn.FusedRNNCell(
            H, num_layers=2, mode=mode, prefix="f_").unfuse()._cells]


class _Count:
    """An initializer that fills block k with k + arange / 1000, so that
    the blob shows which block went where."""

    def __init__(self):
        self.calls = 0

    def fill(self, arr):
        self.calls += 1
        n = int(np.prod(arr.shape))
        arr[:] = (self.calls + np.arange(n) / 1000.0).reshape(
            arr.shape).astype(np.float32)


class _PortCount(mt.init.Initializer, _Count):
    def __init__(self):
        mt.init.Initializer.__init__(self)
        _Count.__init__(self)

    def _init_weight(self, name, arr):
        self.fill(arr)


class _MxCount(mx.init.Initializer, _Count):
    def __init__(self):
        mx.init.Initializer.__init__(self)
        _Count.__init__(self)

    def _init_weight(self, name, arr):
        self.fill(arr)


@pytest.mark.parametrize("mode,layers,bidirectional,forget_bias", [
    ("lstm", 2, False, 1.0), ("lstm", 1, True, 2.5), ("gru", 2, True, 1.0),
    ("rnn_relu", 2, False, 1.0)])
def test_fused_rnn_init_draws_in_mxtpus_order(mode, layers, bidirectional,
                                              forget_bias):
    """FusedRNN hands the blocks to its initializer in mxtpu's order and
    lays out the biases alike (zero, the LSTM forget gate's at
    forget_bias / 2 in each of its two bias vectors)."""
    from mxtpu_torch.ops.rnn import rnn_param_size
    size = rnn_param_size(mode, C, H, layers, bidirectional)
    blobs = []
    for pkg, init in ((mt, _PortCount()), (mx, _MxCount())):
        fused = pkg.init.FusedRNN(init, H, layers, mode, bidirectional,
                                  forget_bias)
        arr = pkg.nd.zeros((size,), ctx=pkg.cpu())
        fused(pkg.init.InitDesc("x_parameters"), arr)
        blobs.append(arr.asnumpy())
    np.testing.assert_array_equal(blobs[0], blobs[1])
    from mxtpu_torch.ops.rnn import rnn_blob_blocks
    blocks, _ = rnn_blob_blocks(mode, C, H, layers,
                                2 if bidirectional else 1)
    biases = blobs[0][blocks[0]["bi"][0]:]
    if mode == "lstm":
        assert (biases == forget_bias / 2.0).sum() == \
            2 * layers * (2 if bidirectional else 1) * H
    assert (biases != 0).sum() == (biases == forget_bias / 2.0).sum()


def _fused_lm(pkg, vocab=24, layers=2):
    with pkg.name.NameManager():
        data = pkg.sym.var("data")
        embed = pkg.sym.Embedding(data, input_dim=vocab, output_dim=C,
                                  name="embed")
        cell = pkg.rnn.FusedRNNCell(H, num_layers=layers, mode="lstm",
                                    prefix="lstm_")
        outputs, _ = cell.unroll(T, inputs=embed, merge_outputs=True)
        pred = pkg.sym.FullyConnected(
            pkg.sym.Reshape(outputs, shape=(-1, H)), num_hidden=vocab,
            name="pred")
        label = pkg.sym.Reshape(pkg.sym.var("softmax_label"), shape=(-1,))
        return pkg.sym.SoftmaxOutput(pred, label, name="softmax")


def test_fused_lm_init_params_is_mxtpus_blob():
    """A FusedRNNCell LM bound by Module and given Xavier(): the blob is
    initialized by the cell's FusedRNN (default Xavier(factor_type="in",
    magnitude=2.34) a block) in both packages, with the same biases; each
    weight block within its bound, and its spread within 10% of mxtpu's
    (different generators draw the values)."""
    from mxtpu_torch.ops.rnn import rnn_blob_blocks
    blobs = []
    for pkg in (mt, mx):
        pkg.random.seed(0)
        mod = pkg.mod.Module(_fused_lm(pkg), context=pkg.cpu())
        mod.bind([("data", (N, T))], [("softmax_label", (N, T))])
        mod.init_params(pkg.init.Xavier())
        blobs.append(mod.get_params()[0]["lstm_parameters"].asnumpy())
    assert blobs[0].shape == blobs[1].shape
    blocks, total = rnn_blob_blocks("lstm", C, H, 2, 1)
    assert total == blobs[0].size
    first_bias = blocks[0]["bi"][0]
    np.testing.assert_array_equal(blobs[0][first_bias:],
                                  blobs[1][first_bias:])
    for b in blocks:
        for key in ("wi", "wh"):
            start, (rows, cols) = b[key]
            bound = np.sqrt(2.34 / cols)
            got, want = (blob[start:start + rows * cols] for blob in blobs)
            assert np.abs(got).max() <= bound and np.abs(want).max() <= bound
            assert abs(got.std() / want.std() - 1) < 0.1


# -- the ops the unfused and modifier cells emit ------------------------------

def test_dropout_op_scales_and_keeps_its_rate():
    """Dropout keeps about 1 - p of the elements, scaled by 1 / (1 - p),
    draws anew each call, broadcasts its mask over ``axes``, is the
    identity outside training unless mode="always", and p=0 passes
    through: as mxtpu's Dropout."""
    from mxtpu_torch.ops import nn as tnn
    from mxtpu_torch.ops.registry import rng_scope
    import torch
    x = torch.ones(64, 256)
    with rng_scope(torch.Generator().manual_seed(0)):
        a = tnn.dropout(x, p=0.25, _training=True)
        b = tnn.dropout(x, p=0.25, _training=True)
        c = tnn.dropout(x, p=0.25, axes=(0,), _training=True)
        d = tnn.dropout(x, p=0.25, mode="always")
    scaled = float(np.float32(1.0 / 0.75))
    assert set(a.unique().tolist()) <= {0.0, scaled}
    assert abs(float((a > 0).float().mean()) - 0.75) < 0.02
    assert not torch.equal(a, b)
    assert bool((c == c[:1]).all())
    assert set(d.unique().tolist()) <= {0.0, scaled}
    assert tnn.dropout(x, p=0.25) is x
    assert tnn.dropout(x, p=0.0, _training=True) is x


@pytest.mark.parametrize("op", ["zeros_like", "ones_like", "where"])
def test_cell_ops_match_mxtpu(op):
    rng = np.random.RandomState(4)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    y = rng.standard_normal((3, 5)).astype(np.float32)
    cond = (rng.rand(3, 5) > 0.5).astype(np.float32)
    got, want = [
        (getattr(pkg.nd, op)(pkg.nd.array(cond, ctx=pkg.cpu()),
                             pkg.nd.array(x, ctx=pkg.cpu()),
                             pkg.nd.array(y, ctx=pkg.cpu()))
         if op == "where" else getattr(pkg.nd, op)(
             pkg.nd.array(x, ctx=pkg.cpu()))).asnumpy()
        for pkg in (mt, mx)]
    np.testing.assert_array_equal(got, want)
