"""The serving graph of the bucketed LSTM LM built by mxtpu and by
mxtpu_torch: JSON written by each package loads in the other, and both
agree on arguments, outputs and inferred shapes."""
import importlib
import json

import pytest

import mxtpu as mx
import mxtpu_torch as mt

V, E, H, L, T = 50, 16, 16, 2, 8


def lm_symbol(pkg, mode="lstm"):
    # a fresh name manager: automatic names (stack0, split0, ...) count
    # the symbols created before in the process
    with importlib.import_module(pkg.__name__ + ".name").NameManager():
        data = pkg.sym.var("data")
        embed = pkg.sym.Embedding(data, input_dim=V, output_dim=E,
                                  name="embed")
        cell = pkg.rnn.FusedRNNCell(H, num_layers=L, mode=mode,
                                    prefix="lstm_")
        outputs, _ = cell.unroll(T, inputs=embed, layout="NTC",
                                 merge_outputs=True)
        pred = pkg.sym.FullyConnected(outputs, num_hidden=V, flatten=False,
                                      name="pred")
        return pkg.sym.softmax(pred, axis=-1, name="softmax")


def _graph(js):
    """The JSON minus formatting and empty ``var_attrs`` (mxtpu writes
    one for a variable whose only attribute is its initializer, which
    the JSON leaves out)."""
    g = json.loads(js)
    for node in g["nodes"]:
        if node.get("var_attrs") == {}:
            del node["var_attrs"]
    return g


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_both_packages_write_the_same_json(mode):
    assert _graph(lm_symbol(mt, mode).tojson()) == \
        _graph(lm_symbol(mx, mode).tojson())


@pytest.mark.parametrize("direction", ["mxtpu->port", "port->mxtpu"])
def test_json_cross_loads(direction):
    src, dst = (mx, mt) if direction == "mxtpu->port" else (mt, mx)
    original = lm_symbol(src)
    loaded = dst.sym.load_json(original.tojson())
    assert loaded.list_arguments() == original.list_arguments()
    assert loaded.list_outputs() == original.list_outputs()
    assert _graph(loaded.tojson()) == _graph(original.tojson())


@pytest.mark.parametrize("batch", [1, 5])
def test_infer_shape_agrees(batch):
    want = lm_symbol(mx).infer_shape(data=(batch, T))
    got = lm_symbol(mt).infer_shape(data=(batch, T))
    assert got == want
    assert got[1] == [(batch, T, V)]


def test_infer_shape_of_loaded_graph():
    loaded = mt.sym.load_json(lm_symbol(mx).tojson())
    args, outs, aux = loaded.infer_shape(data=(3, T))
    shapes = dict(zip(loaded.list_arguments(), args))
    assert shapes["lstm_parameters"] == (
        mt.ops.rnn.rnn_param_size("lstm", E, H, L, False),)
    assert outs == [(3, T, V)] and aux == []


def test_missing_input_shape_raises():
    with pytest.raises(ValueError):
        lm_symbol(mt).infer_shape()
    args, outs, _ = lm_symbol(mt).infer_shape_partial()
    assert outs == [None]


def test_a_training_step_leaves_no_reference_cycle():
    """A training forward and backward through the Executor leaves no
    garbage cycle: ``eval_graph`` once evaluated through a recursive
    closure, whose cycle kept every activation of a step (and the graph
    that saved them) alive until Python's cycle collector ran. At
    ResNet-50's batch of 128 that is about 20 GB a step on the card."""
    import gc
    data = mt.sym.var("data")
    x = mt.sym.Convolution(data, num_filter=4, kernel=(3, 3), name="c1")
    x = mt.sym.Activation(x, act_type="relu")
    x = mt.sym.FullyConnected(x, num_hidden=3, name="fc")
    net = mt.sym.SoftmaxOutput(x, name="softmax")
    ex = net.simple_bind(mt.cpu(), data=(2, 1, 6, 6), softmax_label=(2,))
    gc.collect()
    gc.disable()
    try:
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward()
        gc.set_debug(gc.DEBUG_SAVEALL)
        found = gc.collect()
        garbage = list(gc.garbage)
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert found == 0, sorted({type(o).__name__ for o in garbage})
