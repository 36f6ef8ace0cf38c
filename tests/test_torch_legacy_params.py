"""MXNet's binary ``.params`` format in the port (mxtpu_torch/legacy_params.py)
against mxtpu's (mxtpu/legacy_params.py), on the CPU.

Every case of tests/test_legacy_params.py on the port, and files crossing
both ways: what mxtpu's writer makes loads in the port through
``nd.load``, ``nd.load_from_bytes`` and ``Module.load`` (dense, V2 sparse,
uint32 and int64 dims), and what the port's writer makes loads in mxtpu.
Values are compared exactly: the format stores the raw bytes.
"""
import os
import struct

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu import legacy_params as mx_lp
from mxtpu_torch import legacy_params as lp
from torch_threads import torch_threads_shared  # noqa: F401

DIMS = (np.uint32, np.int64)


@pytest.fixture(autouse=True)
def own_names():
    """Each case names its blocks and symbols in scopes of its own and
    leaves both packages' name counters as it found them: later files
    build the same nets in both packages and compare the names."""
    import mxtpu.gluon.block as mx_block
    import mxtpu_torch.gluon.block as mt_block
    saved = [(d, dict(d)) for d in (mx_block._NAME_COUNTERS,
                                    mt_block._NAME_COUNTERS)]
    with mx.name.NameManager(), mt.name.NameManager():
        yield
    for counters, old in saved:
        counters.clear()
        counters.update(old)


@pytest.fixture(autouse=True)
def on_cpu():
    with mt.cpu():
        yield


def _dense(pkg):
    ctx = {"ctx": pkg.cpu()} if pkg is mt else {}
    return {"w": pkg.nd.array(np.arange(12, dtype="f").reshape(3, 4), **ctx),
            "b": pkg.nd.array(np.ones(4, np.float64), **ctx),
            "i": pkg.nd.array(np.arange(5), **ctx).astype("int32")}


def _sparse(pkg):
    ctx = {"ctx": pkg.cpu()} if pkg is mt else {}
    rsp = pkg.nd.sparse.row_sparse_array(
        (np.arange(6, dtype="f").reshape(2, 3), np.array([1, 4])),
        shape=(8, 3), **ctx)
    csr = pkg.nd.sparse.csr_matrix(np.array([[0, 1.5, 0], [2.5, 0, 0]], "f"),
                                   **ctx)
    return {"r": rsp, "c": csr}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k].asnumpy(), want[k].asnumpy()
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


# -- tests/test_legacy_params.py's cases on the port ---------------------------

@pytest.mark.parametrize("dims_dtype", DIMS, ids=["uint32", "int64"])
def test_dense_roundtrip(tmp_path, dims_dtype):
    arrs = _dense(mt)
    path = str(tmp_path / "p.params")
    lp.save_legacy_params(path, arrs, dims_dtype=dims_dtype)
    with open(path, "rb") as f:
        assert lp.is_legacy_params(f.read(8))
    loaded = mt.nd.load(path)        # sniffed
    _assert_same(loaded, arrs)


def test_unnamed_list_and_empty_shapes(tmp_path):
    path = str(tmp_path / "l.params")
    lp.save_legacy_params(path, [mt.nd.ones((2, 2)), mt.nd.zeros((3,))])
    out = mt.nd.load(path)
    assert isinstance(out, list) and len(out) == 2
    np.testing.assert_array_equal(out[0].asnumpy(), np.ones((2, 2)))
    np.testing.assert_array_equal(out[1].asnumpy(), np.zeros(3))


def test_sparse_v2_blob_parses():
    """A V2 row_sparse blob built by hand, as NDArray::Save writes it."""
    rows = np.array([1, 4], np.int64)
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    blob = [struct.pack("<QQQ", lp.LIST_MAGIC, 0, 1),
            struct.pack("<I", lp.V2_MAGIC),
            struct.pack("<i", 1),                       # row_sparse
            struct.pack("<I", 2) + np.asarray((2, 3), np.uint32).tobytes(),
            struct.pack("<I", 2) + np.asarray((6, 3), np.uint32).tobytes(),
            struct.pack("<ii", 1, 0),                   # cpu ctx
            struct.pack("<i", 0),                       # f32 values
            struct.pack("<i", 6),                       # int64 indices
            struct.pack("<I", 1) + np.asarray((2,), np.uint32).tobytes(),
            data.tobytes(), rows.tobytes(),
            struct.pack("<Q", 1),
            struct.pack("<Q", 3) + b"emb"]
    arrays, names = lp.load_legacy_params(b"".join(blob))
    assert names == ["emb"]
    assert arrays[0]["stype"] == "row_sparse" and \
        arrays[0]["shape"] == (6, 3)
    out = mt.nd.load_from_bytes(b"".join(blob))["emb"]
    assert out.stype == "row_sparse"
    np.testing.assert_array_equal(out.indices.asnumpy(), rows)
    np.testing.assert_array_equal(out.data.asnumpy(), data)


def test_model_zoo_weights_migrate(tmp_path):
    """A Gluon model-zoo net's weights written in MXNet's format load back
    into a fresh net (``ParameterDict.load``, which reads through
    ``nd.load``) and give the same outputs."""
    from mxtpu_torch.gluon.model_zoo import vision
    net = vision.get_resnet(1, 18, classes=10)
    net.initialize(mt.init.Xavier(), ctx=mt.cpu())
    x = mt.nd.array(np.random.RandomState(0).rand(1, 3, 32, 32)
                    .astype("f"))
    want = net(x).asnumpy()
    params = {p.name[len(net.prefix):]: p.data()
              for p in net.collect_params().values()}
    path = str(tmp_path / "zoo.params")
    lp.save_legacy_params(path, params)
    net2 = vision.get_resnet(1, 18, classes=10)
    net2.collect_params().load(path, ctx=mt.cpu(), restore_prefix=net2.prefix)
    np.testing.assert_array_equal(net2(x).asnumpy(), want)


def test_sparse_legacy_writer_roundtrip(tmp_path):
    """Sparse arrays keep their storage through the format."""
    arrs = _sparse(mt)
    path = str(tmp_path / "sp.params")
    lp.save_legacy_params(path, arrs)
    out = mt.nd.load(path)
    assert out["r"].stype == "row_sparse" and out["c"].stype == "csr"
    np.testing.assert_array_equal(out["r"].indices.asnumpy(), [1, 4])
    _assert_same(out, arrs)


def test_predict_bytes_path_reads_legacy():
    blob = lp.save_legacy_params(None, {"w": mt.nd.ones((2, 2))})
    out = mt.nd.load_from_bytes(blob)
    np.testing.assert_array_equal(out["w"].asnumpy(), np.ones((2, 2)))


def test_zero_dim_array_save_refused(tmp_path):
    """An empty shape means "uninitialized" to MXNet's reader: a scalar
    cannot be written."""
    with pytest.raises(TypeError, match="zero-dim"):
        lp.save_legacy_params(str(tmp_path / "z.params"), {
            "scalar": np.float32(0.01),
            "after": np.arange(6, dtype="f").reshape(2, 3)})


def test_bfloat16_refused(tmp_path):
    """MXNet's codes 0..6 have no bfloat16: the writer refuses it, as
    mxtpu's does."""
    import torch
    arr = mt.nd.NDArray(torch.ones(2, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        lp.save_legacy_params(str(tmp_path / "b.params"), {"b": arr})


# -- across the packages -------------------------------------------------------

@pytest.mark.parametrize("dims_dtype", DIMS, ids=["uint32", "int64"])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_mxtpu_files_load_in_port(tmp_path, kind, dims_dtype):
    """mxtpu's writer -> the port's nd.load and nd.load_from_bytes."""
    arrs = (_dense if kind == "dense" else _sparse)(mx)
    path = str(tmp_path / "m.params")
    mx_lp.save_legacy_params(path, arrs, dims_dtype=dims_dtype)
    got = mt.nd.load(path)
    with open(path, "rb") as f:
        got_bytes = mt.nd.load_from_bytes(f.read())
    for out in (got, got_bytes):
        assert sorted(out) == sorted(arrs)
        for k in arrs:
            assert getattr(out[k], "stype", "default") == \
                getattr(arrs[k], "stype", "default")
            np.testing.assert_array_equal(out[k].asnumpy(),
                                          arrs[k].asnumpy(), err_msg=k)
            assert out[k].asnumpy().dtype == arrs[k].asnumpy().dtype


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_port_files_load_in_mxtpu(tmp_path, kind):
    """The port's writer -> mxtpu's nd.load, byte for byte mxtpu's file."""
    port = (_dense if kind == "dense" else _sparse)(mt)
    ref = (_dense if kind == "dense" else _sparse)(mx)
    path = str(tmp_path / "p.params")
    lp.save_legacy_params(path, port)
    with open(path, "rb") as f:
        ours = f.read()
    assert ours == mx_lp.save_legacy_params(None, ref)
    got = mx.nd.load(path)
    for k in port:
        assert getattr(got[k], "stype", "default") == \
            getattr(port[k], "stype", "default")
        np.testing.assert_array_equal(got[k].asnumpy(), port[k].asnumpy())


def _mlp(pkg):
    data = pkg.sym.var("data")
    net = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    net = pkg.sym.BatchNorm(net, name="bn1")
    net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


@pytest.mark.parametrize("writer", ["mxtpu", "port"])
def test_module_load_reads_mxnet_checkpoint(tmp_path, writer):
    """A checkpoint in MXNet's own format (prefix-symbol.json and
    prefix-0003.params with arg:/aux: keys) loads through Module.load and
    predicts what the weights give, in the port."""
    rng = np.random.RandomState(0)
    args = {"fc1_weight": rng.randn(8, 5).astype("f"),
            "fc1_bias": rng.randn(8).astype("f"),
            "bn1_gamma": rng.rand(8).astype("f") + 0.5,
            "bn1_beta": rng.randn(8).astype("f"),
            "fc2_weight": rng.randn(3, 8).astype("f"),
            "fc2_bias": rng.randn(3).astype("f")}
    aux = {"bn1_moving_mean": rng.randn(8).astype("f"),
           "bn1_moving_var": rng.rand(8).astype("f") + 0.5}
    prefix = str(tmp_path / "ck")
    entries = {"arg:" + k: v for k, v in args.items()}
    entries.update(("aux:" + k, v) for k, v in aux.items())
    (mx_lp if writer == "mxtpu" else lp).save_legacy_params(
        "%s-0003.params" % prefix, entries)
    _mlp(mx).save("%s-symbol.json" % prefix)
    x = rng.randn(4, 5).astype("f")
    outs = []
    for pkg in (mt, mx):
        mod = pkg.mod.Module.load(prefix, 3, context=pkg.cpu())
        mod.bind([("data", x.shape)], [("softmax_label", (4,))],
                 for_training=False)
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x)], []), is_train=False)
        outs.append(mod.get_outputs()[0].asnumpy())
    # the two packages' float32 forwards: the same sums, another order
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    sym, arg_params, aux_params = mt.model.load_checkpoint(prefix, 3)
    for k, v in args.items():
        np.testing.assert_array_equal(arg_params[k].asnumpy(), v)
    for k, v in aux.items():
        np.testing.assert_array_equal(aux_params[k].asnumpy(), v)
    assert os.path.exists("%s-symbol.json" % prefix)
