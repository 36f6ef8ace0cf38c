"""The Gluon pieces of ROADMAP A8 in the PyTorch port against mxtpu's, on
the CPU: the transposed convolutions and the InstanceNorm / LayerNorm
layers, the recurrent cells (``gluon.rnn``), ``gluon.contrib``'s layers,
cells, sampler and WikiText datasets. Each case is built in both packages
from the same seeded numpy inputs, mxtpu's weights carried into the port
by ``ParameterDict.load_dict`` (the names are the same), the port inside
``with mt.cpu():``.

Tolerance: 1e-5 (TOL) on outputs, states and every gradient: both
packages run the same float32 functions with sums in another order. The
random cells (Dropout, Zoneout, VariationalDropout) draw from another
generator than JAX's: they are held by value at p = 0 and by property at
p > 0 (the share of entries kept, the scale, a locked mask).
"""
import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def close(got, want, what=""):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg="%s %d" % (what, i), **TOL)


def carry(mblock, tblock):
    """mxtpu's block takes the port's block's weights (the same names).
    The port draws them: mxtpu's initializers compile JAX's random
    number code for every new shape, a second or more each, most of
    this file's time; mxtpu's side starts from zeros."""
    params = {k: v.data().asnumpy()
              for k, v in tblock.collect_params().items()}
    mparams = mblock.collect_params()
    assert sorted(params) == sorted(mparams.keys())
    for k, v in params.items():
        mparams[k].set_data(mx.nd.array(v))


def grads(block):
    return [p.grad().asnumpy() for _, p in
            sorted(block.collect_params().items())
            if p.grad_req != "null"]


# -- transposed convolutions and norm layers ---------------------------------

LAYERS = {
    "Conv1DTranspose relu no bias": (lambda nn: nn.Conv1DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, activation="relu",
        use_bias=False), (2, 3, 7)),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(
        6, (3, 2), strides=(2, 1), padding=(1, 0), output_padding=(1, 0),
        in_channels=4), (2, 4, 5, 5)),
    "Conv3DTranspose": (lambda nn: nn.Conv3DTranspose(
        2, 2, strides=2, dilation=1), (1, 3, 2, 3, 3)),
    "InstanceNorm scaled": (lambda nn: nn.InstanceNorm(
        scale=True, epsilon=1e-3, in_channels=3), (2, 3, 6)),
    "LayerNorm": (lambda nn: nn.LayerNorm(), (3, 4, 5)),
    "LayerNorm axis 1": (lambda nn: nn.LayerNorm(axis=1, center=False),
                         (3, 4, 5)),
}


def _layer_fb(pkg, block, x):
    xs = pkg.nd.array(x, ctx=pkg.cpu())
    xs.attach_grad()
    rng = np.random.RandomState(1)
    with pkg.autograd.record():
        out = block(xs)
        head = (out * pkg.nd.array(rng.randn(*out.shape).astype("f"),
                                   ctx=pkg.cpu())).sum()
    head.backward()
    return [out.asnumpy(), xs.grad.asnumpy()] + grads(block)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer(name):
    """Forward and gradients with mxtpu's weights (mxtpu's block
    hybridized), the port's eager and hybridized;
    the weight shape (Deconvolution's (in, out / groups, *k)) and names
    inferred as mxtpu infers them."""
    make, shape = LAYERS[name]
    x = np.random.RandomState(len(name)).randn(*shape).astype(np.float32)
    m = make(mx.gluon.nn)
    m.initialize(mx.init.Zero())
    m.hybridize()   # mxtpu's side as one jitted program
    m(mx.nd.array(x))
    with mt.cpu():
        t = make(mt.gluon.nn)
        t.initialize(mt.init.Xavier(), ctx=mt.cpu())
        t(mt.nd.array(x))
        carry(m, t)
        got = _layer_fb(mt, t, x)
        t.hybridize()
        hyb = _layer_fb(mt, t, x)
    want = _layer_fb(mx, m, x)
    close(got, want, name)
    close(hyb, want, name + " hybridized")


def test_grouped_conv_transpose():
    """``groups``: the weight is (in, out / groups, *k), and the layer is
    torch's grouped transposed convolution with MXNet's ``adj`` as
    ``output_padding`` (mxtpu's grouped Deconvolution raises in JAX's
    convolution, so it is held to torch here)."""
    import torch
    import torch.nn.functional as F
    x = np.random.RandomState(0).randn(2, 4, 5, 5).astype("f")
    with mt.cpu():
        t = mt.gluon.nn.Conv2DTranspose(6, 3, strides=2, padding=1,
                                        output_padding=1, groups=2)
        t.initialize(mt.init.Xavier(), ctx=mt.cpu())
        out = t(mt.nd.array(x)).asnumpy()
        w, b = t.weight.data().data, t.bias.data().data
    assert tuple(w.shape) == (4, 3, 3, 3)
    want = F.conv_transpose2d(torch.tensor(x), w, b, stride=2, padding=1,
                              output_padding=1, groups=2)
    np.testing.assert_allclose(out, want.detach().numpy(), **TOL)


# -- the recurrent cells ------------------------------------------------------

# I == H: the i2h and h2h products share their shapes, so JAX compiles
# each primitive once for both
I, H, N, T = 4, 4, 2, 3


def _stack(rnn, *cells):
    s = rnn.SequentialRNNCell()
    for c in cells:
        s.add(c)
    return s


CELLS = {
    "RNNCell tanh": lambda r: r.RNNCell(H, input_size=I),
    "RNNCell relu": lambda r: r.RNNCell(H, activation="relu", input_size=I),
    "LSTMCell": lambda r: r.LSTMCell(H, input_size=I),
    "GRUCell": lambda r: r.GRUCell(H, input_size=I),
    "SequentialRNNCell": lambda r: _stack(
        r, r.LSTMCell(H, input_size=I), r.GRUCell(H, input_size=H)),
    "ResidualCell": lambda r: r.ResidualCell(r.GRUCell(I, input_size=I)),
    "BidirectionalCell": lambda r: r.BidirectionalCell(
        r.LSTMCell(H, input_size=I, prefix="l_"),
        r.GRUCell(H, input_size=I, prefix="r_")),
    "DropoutCell p=0 stack": lambda r: _stack(
        r, r.RNNCell(H, input_size=I), r.DropoutCell(0.0),
        r.LSTMCell(H, input_size=H)),
    "ZoneoutCell p=0": lambda r: r.ZoneoutCell(r.LSTMCell(H, input_size=I)),
    "LSTMPCell": lambda r: _contrib(r).LSTMPCell(H, 2, input_size=I),
    "VariationalDropoutCell p=0": lambda r: _contrib(
        r).VariationalDropoutCell(r.GRUCell(H, input_size=I)),
}


def _contrib(rnn):
    return (mx if rnn is mx.gluon.rnn else mt).gluon.contrib.rnn


def _unroll(pkg, cell, x, layout, merge):
    """Outputs and states of an unroll under record, then every
    parameter's gradient and the input's after a weighted sum's
    backward."""
    ctx = pkg.cpu()
    xs = pkg.nd.array(x, ctx=ctx)
    xs.attach_grad()
    rng = np.random.RandomState(2)
    # mxtpu sizes default states from a step's axis at the layout's N
    # (the channels under TNC): its states are given there
    begin = cell.begin_state(N, ctx=ctx) if layout == "TNC" else None
    with pkg.autograd.record():
        outs, states = cell.unroll(T, xs, begin_state=begin, layout=layout,
                                   merge_outputs=merge)
        parts = [outs] if merge else list(outs)
        head = None
        for o in parts + list(states):
            w = pkg.nd.array(rng.randn(*o.shape).astype("f"), ctx=ctx)
            term = (o * w).sum()
            head = term if head is None else head + term
    head.backward()
    return [o.asnumpy() for o in parts + list(states)] + \
        [xs.grad.asnumpy()] + grads(cell)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_unroll(name):
    """Each cell's unroll in both packages from mxtpu's weights, in NTC
    merged and in TNC as a list of steps: outputs, states, the input's
    and every weight's gradient; the port's hybridized cell equals its
    eager one."""
    make = CELLS[name]
    m = make(mx.gluon.rnn)
    m.collect_params().initialize(mx.init.Zero())
    with mt.cpu():
        mt.random.seed(0)
        t = make(mt.gluon.rnn)
        t.collect_params().initialize(mt.init.Xavier(), ctx=mt.cpu())
        carry(m, t)
    for layout, merge in (("NTC", True), ("TNC", False)):
        shape = (N, T, I) if layout == "NTC" else (T, N, I)
        x = np.random.RandomState(len(name)).randn(*shape).astype("f")
        with mt.cpu():
            t.hybridize(False)
            got = _unroll(mt, t, x, layout, merge)
            if "Variational" not in name:
                t.hybridize()
                close(_unroll(mt, t, x, layout, merge), got,
                      "%s %s hybridized" % (name, layout))
        close(got, _unroll(mx, m, x, layout, merge), "%s %s" % (name,
                                                                layout))


def test_tnc_default_states():
    """Under TNC the port sizes default states from the batch (mxtpu
    from the channels, which raises here)."""
    x = np.random.RandomState(0).randn(T, N, I).astype("f")
    with mt.cpu():
        for cell in (mt.gluon.rnn.GRUCell(H, input_size=I),
                     _stack(mt.gluon.rnn, mt.gluon.rnn.GRUCell(
                         H, input_size=I))):
            cell.collect_params().initialize(ctx=mt.cpu())
            outs, states = cell.unroll(T, mt.nd.array(x), layout="TNC",
                                       merge_outputs=True)
            assert outs.shape == (T, N, H) and states[0].shape == (N, H)
    m = mx.gluon.rnn.GRUCell(H, input_size=I)
    m.initialize()
    with pytest.raises(TypeError):
        m.unroll(T, mx.nd.array(x), layout="TNC")


def test_cell_names_and_step():
    """Parameter names, state shapes, a single step and the Bidirectional
    cell's refusal to step, as mxtpu's."""
    for pkg in (mx, mt):
        r = pkg.gluon.rnn
        with (mt.cpu() if pkg is mt else mx.cpu()):
            lstm = r.LSTMCell(H, input_size=I, prefix="enc_")
            assert sorted(lstm.collect_params()) == [
                "enc_h2h_bias", "enc_h2h_weight", "enc_i2h_bias",
                "enc_i2h_weight"]
            assert [s["shape"] for s in lstm.state_info(5)] == [(5, H)] * 2
            lstm.initialize()
            out, st = lstm(pkg.nd.ones((2, I)), lstm.begin_state(2))
            assert out.shape == (2, H) and len(st) == 2
            bi = r.BidirectionalCell(r.GRUCell(H, input_size=I),
                                     r.GRUCell(H, input_size=I))
            with pytest.raises(NotImplementedError):
                bi(pkg.nd.ones((2, I)), bi.begin_state(2))
            zc = r.ZoneoutCell(r.GRUCell(H, input_size=I))
            assert zc.prefix.endswith("zoneout_")


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_fused_layer_matches_cell_stack(mode):
    """A hybridized SequentialRNNCell of two cells, given the weights of
    the fused 2-layer layer (``l{i}_*`` into cell ``i``), gives the
    layer's outputs, states and gradients (``mxtpu``'s
    ``test_fused_lstm_matches_cell``, two layers, both gate orders)."""
    r = mt.gluon.rnn
    Layer, Cell = (r.LSTM, r.LSTMCell) if mode == "lstm" else (r.GRU,
                                                               r.GRUCell)
    x = np.random.RandomState(4).randn(5, N, I).astype(np.float32)
    with mt.cpu():
        layer = Layer(H, num_layers=2, input_size=I, prefix="f_")
        layer.initialize(mt.init.Xavier(), ctx=mt.cpu())
        stack = r.SequentialRNNCell()
        stack.add(Cell(H, input_size=I, prefix="c0_"))
        stack.add(Cell(H, input_size=H, prefix="c1_"))
        stack.initialize(ctx=mt.cpu())
        stack.collect_params().load_dict(
            {"c%s_%s" % (k[3], k[5:]): v.data()
             for k, v in layer.collect_params().items()}, ctx=mt.cpu())
        stack.hybridize()
        res = []
        for block in (layer, stack):
            xs = mt.nd.array(x)
            xs.attach_grad()
            with mt.autograd.record():
                if block is layer:
                    out = layer(xs)
                else:
                    out, _ = stack.unroll(5, xs, layout="TNC",
                                          merge_outputs=True)
                loss = (out * out).sum()
            loss.backward()
            res.append([out.asnumpy(), xs.grad.asnumpy()] + [
                p.grad().asnumpy() for p in block.collect_params().values()])
    close(res[1], res[0], mode)


# -- random cells, by property -----------------------------------------------

def test_dropout_and_zoneout_cells_by_property():
    """DropoutCell at p = 0.5 keeps about half its entries, scaled by 2;
    ZoneoutCell's output takes each entry from the new output or the
    last; both are the identity outside training."""
    r = mt.gluon.rnn
    with mt.cpu():
        mt.random.seed(0)
        cell = r.DropoutCell(0.5)
        x = mt.nd.ones((64, 64))
        with mt.autograd.record():
            out, _ = cell(x, [])
        v = out.asnumpy()
        assert set(np.unique(v)) <= {0.0, 2.0}
        assert 0.45 < (v > 0).mean() < 0.55
        np.testing.assert_array_equal(cell(x, [])[0].asnumpy(), 1.0)
        base = r.RNNCell(32, input_size=8)
        zc = r.ZoneoutCell(base, zoneout_outputs=0.5)
        zc.initialize(ctx=mt.cpu())
        steps = [mt.nd.array(np.random.RandomState(t).randn(16, 8)
                             .astype("f")) for t in range(2)]
        with mt.autograd.record():
            outs, _ = zc.unroll(2, steps, merge_outputs=False)
        o0, o1 = outs[0].asnumpy(), outs[1].asnumpy()
        # step 0: each entry the new output or 0 (no output before it);
        # step 1: each the new output or step 0's
        assert 0.35 < (o0 != 0).mean() < 0.65
        assert 0.35 < (o1 == o0).mean() < 0.65


def test_variational_dropout_locked_mask():
    """VariationalDropoutCell: one mask a sequence (the same at every
    step), about half kept at p = 0.5, dropped by ``reset``; it refuses
    ``hybridize`` as mxtpu's does."""
    r, cr = mt.gluon.rnn, mt.gluon.contrib.rnn
    with mt.cpu():
        mt.random.seed(0)
        cell = cr.VariationalDropoutCell(r.RNNCell(64, input_size=64),
                                         drop_inputs=0.5)
        cell.initialize(ctx=mt.cpu())
        x = mt.nd.ones((8, 64))
        states = cell.begin_state(batch_size=8)
        with mt.autograd.record():
            cell.reset()
            cell(x, states)
            m1 = cell.drop_inputs_mask.asnumpy()
            cell(x, states)
            m2 = cell.drop_inputs_mask.asnumpy()
        np.testing.assert_array_equal(m1, m2)
        assert set(np.unique(m1)) <= {0.0, 2.0}
        assert 0.4 < (m1 > 0).mean() < 0.6
        cell.reset()
        assert cell.drop_inputs_mask is None
        with pytest.raises(NotImplementedError):
            cell.hybridize()


# -- the convolutional cells --------------------------------------------------

CONV_CELLS = ["Conv%dD%sCell" % (d, k) for d in (1, 2, 3)
              for k in ("RNN", "LSTM", "GRU")]
# the cells whose gradients are held to mxtpu's too: each kind and each
# dimension once (mxtpu's eager JAX compiles a convolution's two
# gradients for every new shape, most of this file's time)
CONV_GRAD_CELLS = ("Conv1DRNNCell", "Conv2DLSTMCell", "Conv3DGRUCell")


@pytest.mark.parametrize("name", CONV_CELLS)
def test_conv_cell(name):
    """Each convolutional cell unrolled 2 steps in both packages from
    mxtpu's weights: outputs and states (mxtpu's shapes: the i2h padding
    sets the spatial size); for CONV_GRAD_CELLS every gradient too."""
    d = int(name[4])
    spatial = (4, 3, 3)[:d]
    # as many input as hidden channels and "same" padding: the i2h and h2h
    # convolutions share their shapes (and JAX its compiles)
    x = np.random.RandomState(d).randn(N, 2, 2, *spatial).astype("f")

    def make(pkg):
        return getattr(pkg.gluon.contrib.rnn, name)(
            input_shape=(2,) + spatial, hidden_channels=2, i2h_kernel=3,
            h2h_kernel=3, i2h_pad=1)
    m = make(mx)
    m.collect_params().initialize(mx.init.Zero())

    grad = name in CONV_GRAD_CELLS

    def run(pkg, cell):
        ctx = pkg.cpu()
        steps = [pkg.nd.array(x[:, t], ctx=ctx) for t in range(2)]
        if not grad:
            outs, states = cell.unroll(2, steps, merge_outputs=False)
            return [o.asnumpy() for o in list(outs) + list(states)]
        for s in steps:
            s.attach_grad()
        with pkg.autograd.record():
            outs, states = cell.unroll(2, steps, merge_outputs=False)
            head = sum(((o * o).sum() for o in list(outs) + list(states)),
                       pkg.nd.zeros((1,), ctx=ctx))
        head.backward()
        return [o.asnumpy() for o in list(outs) + list(states)] + \
            [s.grad.asnumpy() for s in steps] + grads(cell)
    with mt.cpu():
        t = make(mt)
        t.collect_params().initialize(mt.init.Xavier(), ctx=mt.cpu())
        carry(m, t)
        got = run(mt, t)
    want = run(mx, m)
    close(got, want, name)
    n_states = 2 if "LSTM" in name else 1
    assert len(got) == 2 + n_states + (2 + 4 if grad else 0)
    assert got[2].shape[1:] == (2,) + spatial


def test_conv_lstm_learns():
    """``tests/test_gluon_contrib.py``'s ConvLSTM learning check in the
    port: 30 Adam steps of predicting a frame lower the loss."""
    with mt.cpu():
        mt.random.seed(0)
        cr, nn = mt.gluon.contrib.rnn, mt.gluon.nn
        cell = cr.Conv2DLSTMCell(input_shape=(1, 6, 6), hidden_channels=4,
                                 i2h_kernel=3, h2h_kernel=3, i2h_pad=1)
        head = nn.Conv2D(1, 1)
        cell.initialize(mt.init.Xavier(), ctx=mt.cpu())
        head.initialize(mt.init.Xavier(), ctx=mt.cpu())
        params = dict(cell.collect_params())
        params.update(head.collect_params())
        trainer = mt.gluon.Trainer(params, "adam", {"learning_rate": 1e-2})
        rng = np.random.RandomState(0)
        seq = [mt.nd.array(rng.rand(2, 1, 6, 6).astype(np.float32))
               for _ in range(4)]
        loss_fn = mt.gluon.loss.L2Loss()
        losses = []
        for _ in range(30):
            with mt.autograd.record():
                outs, _ = cell.unroll(4, seq, merge_outputs=False)
                loss = loss_fn(head(outs[-2]), seq[-1])
            loss.backward()
            trainer.step(2)
            losses.append(float(loss.mean().asnumpy()))
    assert losses[-1] < losses[0], losses


# -- contrib layers, sampler, datasets ---------------------------------------

def test_concurrent_and_identity():
    x = np.random.RandomState(0).randn(4, 5).astype("f")

    def build(pkg):
        cnn, nn = pkg.gluon.contrib.nn, pkg.gluon.nn
        net = cnn.HybridConcurrent(axis=1)
        net.add(nn.Dense(3, in_units=5), cnn.Identity(),
                nn.Dense(2, in_units=5))
        net2 = cnn.Concurrent(axis=1)
        net2.add(cnn.Identity(), nn.Dense(2, in_units=5))
        return net, net2
    mnets = build(mx)
    for n in mnets:
        n.initialize(mx.init.Zero())
    with mt.cpu():
        tnets = build(mt)
        for m, t in zip(mnets, tnets):
            t.initialize(mt.init.Xavier(), ctx=mt.cpu())
            carry(m, t)
        got = [_layer_fb(mt, t, x) for t in tnets]
        tnets[0].hybridize()
        hyb = _layer_fb(mt, tnets[0], x)
    want = [_layer_fb(mx, m, x) for m in mnets]
    close(got[0], want[0], "HybridConcurrent")
    close(got[1], want[1], "Concurrent")
    close(hyb, want[0], "HybridConcurrent hybridized")
    assert got[0][0].shape == (4, 10)
    np.testing.assert_array_equal(got[0][0][:, 3:8], x)


def test_interval_sampler():
    from mxtpu.gluon.contrib.data import IntervalSampler as M
    from mxtpu_torch.gluon.contrib.data import IntervalSampler as P
    for args in ((10, 3), (10, 3, False), (7, 7), (9, 2, True)):
        assert list(P(*args)) == list(M(*args)), args
        assert len(P(*args)) == len(M(*args)), args
    assert list(P(10, 3))[:4] == [0, 3, 6, 9]


def test_wikitext_local_file(tmp_path):
    """WikiText2 over a local token file in both packages: the same
    vocabulary, counts, samples and labels; the same IOError text for a
    missing file."""
    from mxtpu.gluon.contrib.data import WikiText2 as M
    from mxtpu_torch.gluon.contrib.data import WikiText2 as P
    corpus = tmp_path / "wiki.train.tokens"
    corpus.write_text("the cat sat\nthe dog ran\n\nthe cat ran far\n"
                      " = heading = \n")
    want = M(root=str(tmp_path), segment="train", seq_len=4)
    got = P(root=str(tmp_path), segment="train", seq_len=4)
    assert len(got) == len(want) >= 2
    assert got.vocabulary.idx_to_token == want.vocabulary.idx_to_token
    assert got.frequencies == want.frequencies
    for i in range(len(got)):
        for g, w in zip(got[i], want[i]):
            assert g.asnumpy().dtype == np.int32 and g.context == mt.cpu()
            np.testing.assert_array_equal(g.asnumpy(), w.asnumpy())
    val = P(root=str(tmp_path), segment="train", seq_len=3,
            vocab=got.vocabulary)
    assert val.vocabulary is got.vocabulary
    errs = []
    for cls in (M, P):
        with pytest.raises(IOError) as e:
            cls(root=str(tmp_path / "none"), segment="val")
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_cell_params_files_cross(tmp_path):
    """A cell net's ``.params`` file loads in the other package under the
    same names, both ways."""
    def build(pkg):
        r = pkg.gluon.rnn
        s = r.SequentialRNNCell(prefix="net_")
        with s.name_scope():
            s.add(r.LSTMCell(H, input_size=I))
            s.add(r.GRUCell(H, input_size=H))
        return s
    m = build(mx)
    m.collect_params().initialize(mx.init.Uniform(0.1))
    m.save_params(str(tmp_path / "m.params"))
    with mt.cpu():
        t = build(mt)
        t.load_params(str(tmp_path / "m.params"), ctx=mt.cpu())
        assert sorted(t.collect_params()) == sorted(m.collect_params())
        for k, p in t.collect_params().items():
            np.testing.assert_array_equal(
                p.data().asnumpy(), m.collect_params()[k].data().asnumpy())
        for p in t.collect_params().values():
            p.set_data(p.data() * 2)
        t.save_params(str(tmp_path / "t.params"))
    m2 = build(mx)
    m2.load_params(str(tmp_path / "t.params"))
    for k, p in m2.collect_params().items():
        np.testing.assert_allclose(p.data().asnumpy(), 2 * m.collect_params()[
            k].data().asnumpy())
