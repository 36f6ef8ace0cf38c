"""The slice as a whole: a bucketed LSTM language model checkpointed by
mxtpu and served by both packages' InferenceEngine (the port on the
CPU), answering the same requests."""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu.serving
import mxtpu_torch as mt
import mxtpu_torch.serving

V, E, H, L, T = 50, 16, 16, 2, 8
BUCKETS = (1, 4, 8)
REQUEST_ROWS = (1, 3, 5)
# f32 end to end (embedding, 2 LSTM layers over 8 steps, a width-50
# head, softmax): summation order only
TOL = dict(atol=1e-5, rtol=1e-5)


def lm_symbol(pkg, mode):
    data = pkg.sym.var("data")
    embed = pkg.sym.Embedding(data, input_dim=V, output_dim=E, name="embed")
    cell = pkg.rnn.FusedRNNCell(H, num_layers=L, mode=mode, prefix="lstm_")
    outputs, _ = cell.unroll(T, inputs=embed, layout="NTC",
                             merge_outputs=True)
    pred = pkg.sym.FullyConnected(outputs, num_hidden=V, flatten=False,
                                  name="pred")
    return pkg.sym.softmax(pred, axis=-1, name="softmax")


def seeded_params(sym, seed=0):
    args, _, _ = sym.infer_shape(data=(1, T))
    rng = np.random.RandomState(seed)
    return {n: (rng.standard_normal(s) * 0.3).astype(np.float32)
            for n, s in zip(sym.list_arguments(), args) if n != "data"}


def requests(seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, V, (rows, T)).astype(np.float32)
            for rows in REQUEST_ROWS]


@pytest.fixture(scope="module", params=["lstm", "gru"])
def checkpoint(request, tmp_path_factory):
    mode = request.param
    sym = lm_symbol(mx, mode)
    params = seeded_params(sym)
    prefix = str(tmp_path_factory.mktemp("ckpt") / mode)
    mx.model.save_checkpoint(prefix, 0, sym,
                             {k: mx.nd.array(v) for k, v in params.items()},
                             {})
    return prefix, params


def _engines(prefix):
    kw = dict(data_shapes={"data": (T,)}, buckets=BUCKETS)
    ref = mxtpu.serving.InferenceEngine.from_checkpoint(prefix, 0, **kw)
    port = mxtpu_torch.serving.InferenceEngine.from_checkpoint(
        prefix, 0, ctx=mt.cpu(), **kw)
    return ref, port


def test_port_answers_as_mxtpu(checkpoint):
    ref, port = _engines(checkpoint[0])
    assert port.stats()["compiles"] == ref.stats()["compiles"] == \
        len(BUCKETS)
    for i, req in enumerate(requests(), 1):
        want = ref.predict([req])
        got = port.predict([req])
        assert len(got) == len(want) == 1
        assert got[0].shape == want[0].shape == (req.shape[0], T, V)
        np.testing.assert_allclose(got[0], want[0], **TOL)
        for key in ("compiles", "hits", "rows", "pad_rows", "predicts"):
            assert port.stats()[key] == ref.stats()[key], key
        assert port.stats()["hits"] == i
        assert port.stats()["compiles"] == len(BUCKETS)
    # rows 1, 3, 5 pad into buckets 1, 4, 8
    assert port.stats()["pad_rows"] == 0 + 1 + 3


def test_port_checkpoint_loads_in_mxtpu(checkpoint, tmp_path):
    prefix, params = checkpoint
    _, port = _engines(prefix)
    sym, arg_params, aux_params = mt.model.load_checkpoint(prefix, 0,
                                                           ctx=mt.cpu())
    out = str(tmp_path / "port")
    mt.model.save_checkpoint(out, 3, sym, arg_params, aux_params)
    jsym, jargs, jaux = mx.model.load_checkpoint(out, 3)
    assert jsym.list_arguments() == sym.list_arguments()
    assert sorted(jargs) == sorted(params) and jaux == {}
    for k, v in params.items():
        np.testing.assert_array_equal(jargs[k].asnumpy(), v)
    ref = mxtpu.serving.InferenceEngine(jsym, jargs, jaux, {"data": (T,)},
                                        buckets=BUCKETS)
    req = requests(seed=4)[1]
    np.testing.assert_allclose(port.predict([req])[0], ref.predict([req])[0],
                               **TOL)


def test_params_from_numpy_keep_the_blob(checkpoint):
    prefix, params = checkpoint
    jargs, jaux = mx.model.load_params(prefix, 0)
    args, aux = mt.model.params_from_numpy(
        {k: v.asnumpy() for k, v in jargs.items()}, {}, ctx=mt.cpu())
    assert aux == {}
    for k, v in params.items():
        assert args[k].dtype == torch.float32
        np.testing.assert_array_equal(args[k].asnumpy(), v)


def test_swap_weights_serves_the_new_version(checkpoint):
    prefix, params = checkpoint
    _, port = _engines(prefix)
    req = requests(seed=2)[2]
    before = port.predict([req])[0]
    doubled = {k: v * 2 for k, v in params.items()}
    assert port.swap_weights(doubled) == 1
    compiles = port.stats()["compiles"]
    after, version = port.predict_versioned([req])
    assert version == 1 and port.stats()["compiles"] == compiles
    assert not np.allclose(after[0], before)
    old, version = port.predict_versioned([req], version=0)
    assert version == 0
    np.testing.assert_array_equal(old[0], before)


def test_request_checks(checkpoint):
    _, port = _engines(checkpoint[0])
    with pytest.raises(ValueError):
        port.predict([np.zeros((9, T), np.float32)])     # > largest bucket
    with pytest.raises(ValueError):
        port.predict([np.zeros((2, T + 1), np.float32)])  # wrong shape
    assert port.bucket_for(3) == 4


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the default context is "
                    "usable here")
    sym = lm_symbol(mt, "lstm")
    with pytest.raises(mt.MXTPUError):
        mt.serving.InferenceEngine(sym, seeded_params(sym), {},
                                   {"data": (T,)})
    assert mt.current_context() == mt.gpu(0)
