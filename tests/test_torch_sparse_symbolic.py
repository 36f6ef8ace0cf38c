"""Storage types through graphs on the CPU, the port against mxtpu:
tests/test_sparse_symbolic.py's cases in both packages (``var(stype=)``,
``infer_storage_type``'s rules and overrides, ``simple_bind`` of CSR and
row-sparse arguments and gradients, ``stype_dict``, the ``__stype__``
attribute through JSON, both ways), and what sits on them:
example/sparse/linear_classification.py's Module.fit (its first 3 steps
from the same weights, ``chip_smoke.sparse_lc_main`` in both packages), a
touched column whose gradient is exactly zero (unstored in both),
checkpoints with a row-sparse weight crossing both ways,
``Module.prepare(sparse_row_id_fn=)`` pulling rows from the kvstore, and
the fused step's eligibility.

Tolerances: storage types, stored rows and shapes exactly; forward
outputs and gradients within TOL (1e-5: the port's CSR product sums with
``index_add_``, mxtpu's is one dense matmul); weights after Adam steps
within STEP_TOL (1e-5 absolute; an Adam step is sign-like, so a rounding
can only move a weight whose gradient is near zero).
"""
import os
import sys

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def test_var_stype_declared():
    for pkg in (mt, mx):
        arg_st, out_st, aux_st = pkg.sym.var("x", stype="csr") \
            .infer_storage_type()
        assert (arg_st, out_st, aux_st) == (["csr"], ["csr"], [])


@pytest.mark.parametrize("transpose_a", [False, True])
def test_dot_rules(transpose_a):
    got = [pkg.sym.dot(pkg.sym.var("data", stype="csr"), pkg.sym.var("w"),
                       transpose_a=transpose_a).infer_storage_type()
           for pkg in (mt, mx)]
    assert got[0] == got[1]
    assert got[0][1] == ["row_sparse" if transpose_a else "default"]


def test_elemwise_and_fallback():
    for pkg in (mt, mx):
        s = pkg.sym
        a = s.var("a", stype="row_sparse")
        b = s.var("b", stype="row_sparse")
        c = s.var("c")
        cases = [(a + b, "row_sparse"), (s.negative(a), "row_sparse"),
                 (s.exp(a), "default"), (a + c, "default"),
                 (s.broadcast_mul(a, c), "row_sparse"),
                 (s.elemwise_add(s.var("p", stype="csr"),
                                 s.var("q", stype="csr")), "csr")]
        for sym, want in cases:
            assert sym.infer_storage_type()[1] == [want]


def test_infer_storage_type_overrides():
    for pkg in (mt, mx):
        x, y = pkg.sym.var("x"), pkg.sym.var("y")
        out = pkg.sym.dot(x, y, transpose_a=True)
        arg_st, out_st, _ = out.infer_storage_type("csr", None)
        assert arg_st == ["csr", "default"] and out_st == ["row_sparse"]
        assert out.infer_storage_type(x="csr")[1] == ["row_sparse"]
        with pytest.raises(ValueError):
            out.infer_storage_type(x="coo")


def test_simple_bind_materializes_sparse():
    dense = np.zeros((4, 6), np.float32)
    dense[0, 1] = 2.0
    dense[2, 4] = 3.0
    wv = np.random.RandomState(0).randn(6, 3).astype(np.float32)
    got = {}
    for pkg in (mt, mx):
        out = pkg.sym.dot(pkg.sym.var("data", stype="csr"),
                          pkg.sym.var("w", stype="row_sparse"))
        ex = out.simple_bind(ctx=pkg.cpu(), grad_req={"w": "write"},
                             data=(4, 6), w=(6, 3))
        kinds = [type(a).__name__ for a in (
            ex.arg_dict["data"], ex.arg_dict["w"], ex.grad_dict["w"])]
        assert kinds == ["CSRNDArray", "RowSparseNDArray",
                         "RowSparseNDArray"]
        ex.arg_dict["w"][:] = wv
        outs = ex.forward(is_train=True,
                          data=pkg.nd.array(dense).tostype("csr"))
        assert ex.arg_dict["data"].indices.size == 2
        ex.backward(pkg.nd.array(np.ones((4, 3), np.float32)))
        g = ex.grad_dict["w"]
        got[pkg] = (outs[0].asnumpy(), g.asnumpy(), g.indices.asnumpy(),
                    g.nnz)
    for a, b in zip(got[mt][:2], got[mx][:2]):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_allclose(got[mt][0], dense @ wv, **TOL)
    np.testing.assert_array_equal(np.sort(got[mt][2]), [1, 4])
    np.testing.assert_array_equal(got[mt][2], got[mx][2])
    assert got[mt][3] == got[mx][3] == 2


def test_stype_dict_override_in_simple_bind():
    for pkg in (mt, mx):
        ex = pkg.sym.negative(pkg.sym.var("x")).simple_bind(
            ctx=pkg.cpu(), grad_req="null",
            stype_dict={"x": "row_sparse"}, x=(3, 2))
        assert type(ex.arg_dict["x"]).__name__ == "RowSparseNDArray"


@pytest.mark.parametrize("writer", ["port", "mxtpu"])
def test_stype_survives_json_roundtrip(writer):
    src, dst = (mt, mx) if writer == "port" else (mx, mt)
    out = src.sym.dot(src.sym.var("x", stype="csr"), src.sym.var("w"),
                      transpose_a=True)
    for pkg in (src, dst):
        loaded = pkg.sym.load_json(out.tojson())
        assert loaded.infer_storage_type()[:2] == (
            ["csr", "default"], ["row_sparse"])


def test_executor_reshape_keeps_storage_types():
    out = chip_smoke.sparse_lr_symbol(mt, 10)
    ex = out.simple_bind(ctx=mt.cpu(), grad_req={"weight": "write"},
                         data=(4, 10), softmax_label=(4,))
    ex2 = ex.reshape(data=(6, 10), softmax_label=(6,))
    assert ex2.arg_dict["data"].stype == "csr"
    assert ex2.arg_dict["weight"] is ex.arg_dict["weight"]
    assert ex2.grad_dict["weight"].stype == "row_sparse"


def test_zero_gradient_column_left_unstored():
    """Column 3 appears in two rows whose outputs' gradients are equal,
    with values +1 and -1: its gradient is exactly zero, and neither
    package stores it."""
    rows = np.zeros((4, 6), np.float32)
    rows[0, [0, 3]] = [1.0, 1.0]
    rows[1, [0, 3]] = [1.0, -1.0]
    rows[2, 5] = 2.0
    w0 = np.random.RandomState(1).randn(6, 2).astype(np.float32)
    w0[3] = 0.0      # rows 0 and 1 give the same logits, so the same
    # gradients of the head, whose products with +1 and -1 cancel
    label = np.array([1, 1, 0, 0], np.float32)
    got = {}
    for pkg in (mt, mx):
        ex = chip_smoke.sparse_lr_symbol(pkg, 6).simple_bind(
            ctx=pkg.cpu(), grad_req={"weight": "write"}, data=(4, 6),
            softmax_label=(4,))
        ex.arg_dict["weight"][:] = w0
        ex.forward(is_train=True, data=pkg.nd.array(rows).tostype("csr"),
                   softmax_label=pkg.nd.array(label))
        ex.backward()
        g = ex.grad_dict["weight"]
        got[pkg] = (g.indices.asnumpy(), g.asnumpy())
    np.testing.assert_array_equal(got[mt][0], [0, 5])
    np.testing.assert_array_equal(got[mt][0], got[mx][0])
    np.testing.assert_allclose(got[mt][1], got[mx][1], **TOL)
    assert not got[mt][1][3].any()


def test_linear_classification_first_steps():
    """The example's main in both packages from the same starting weight
    (the port's Normal(0.01) draw): its first 3 steps' stored gradient
    rows, gradients and weights, and its own asserts in each."""
    rng = np.random.RandomState(2)
    w0 = (rng.randn(64, 2) * 0.01).astype(np.float32)
    acc_mt, got = chip_smoke.sparse_lc_main(mt, mt.cpu(), w0=w0)
    acc_mx, want = chip_smoke.sparse_lc_main(mx, mx.cpu(), w0=w0)
    assert len(got) == len(want) == chip_smoke.AV_STEPS
    for (gi, gv, gw), (wi, wv, ww) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gv, wv, **TOL)
        np.testing.assert_allclose(gw, ww, **STEP_TOL)
    assert acc_mt > 0.8 and acc_mx > 0.8


def _fit_lr(pkg, it, epochs=1, **kw):
    mod = pkg.mod.Module(chip_smoke.sparse_lr_symbol(pkg, 16),
                         context=pkg.cpu(), data_names=["data"],
                         label_names=["softmax_label"])
    w0 = np.random.RandomState(3).randn(16, 2).astype(np.float32) * 0.1
    mod.fit(it, num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
            arg_params={"weight": pkg.nd.array(w0)}, **kw)
    return mod


def _lr_data(tmp_path):
    rng = np.random.RandomState(4)
    path = str(tmp_path / "lr.libsvm")
    with open(path, "w") as f:
        for _ in range(48):
            cols = np.sort(rng.choice(16, 3, replace=False))
            f.write("%d %s\n" % (int(cols[0] < 6), " ".join(
                "%d:%.2f" % (c, rng.rand() + 0.5) for c in cols)))
    return path


def _lr_iter(pkg, path):
    return pkg.io.LibSVMIter(data_libsvm=path, data_shape=(16,),
                             batch_size=8)


@pytest.mark.parametrize("writer", ["port", "mxtpu"])
def test_checkpoint_with_row_sparse_weight_both_ways(tmp_path, writer):
    """A Module's checkpoint keeps the row-sparse weight's storage type
    (``::stype`` entries) and loads in the other package: as the file, and
    through model.params_from_numpy from mxtpu's loaded dicts."""
    path = _lr_data(tmp_path)
    src, dst = (mt, mx) if writer == "port" else (mx, mt)
    mod = _fit_lr(src, _lr_iter(src, path))
    prefix = str(tmp_path / "lr")
    mod.save_checkpoint(prefix, 1)
    arg, _aux = mod.get_params()
    assert arg["weight"].stype == "row_sparse"
    _sym, arg2, _aux2 = dst.model.load_checkpoint(prefix, 1)
    assert arg2["weight"].stype == "row_sparse"
    np.testing.assert_array_equal(arg2["weight"].asnumpy(),
                                  arg["weight"].asnumpy())
    np.testing.assert_array_equal(arg2["weight"].indices.asnumpy(),
                                  arg["weight"].indices.asnumpy())
    if writer == "mxtpu":
        ported, _ = mt.model.params_from_numpy(arg, {}, ctx=mt.cpu())
        assert ported["weight"].stype == "row_sparse"
        np.testing.assert_array_equal(ported["weight"].indices.asnumpy(),
                                      arg["weight"].indices.asnumpy())
        np.testing.assert_array_equal(ported["weight"].asnumpy(),
                                      arg["weight"].asnumpy())
    mod2 = dst.mod.Module.load(prefix, 1, data_names=["data"],
                               label_names=["softmax_label"])
    it = _lr_iter(dst, path)
    mod2.bind(it.provide_data, it.provide_label, for_training=False)
    score = dict(mod2.score(it, dst.metric.Accuracy()))["accuracy"]
    it0 = _lr_iter(src, path)
    assert score == dict(mod.score(it0, src.metric.Accuracy()))["accuracy"]


def test_sparse_row_id_fn_pulls_rows_from_the_kvstore(tmp_path):
    """Module.fit(sparse_row_id_fn=) with a kvstore that updates: prepare
    pulls each next batch's rows (row_sparse_pull), in both packages
    alike; without such a store it warns and does nothing. (After the
    last step's dense pull the port's weight stores its nonzero rows;
    mxtpu's keeps the rows of the last row_sparse_pull.)"""
    path = _lr_data(tmp_path)

    def row_ids(batch):
        return {"weight": batch.data[0].indices}
    got = {}
    for pkg in (mt, mx):
        kv = pkg.kv.create("local")
        pulled = []

        def held_rows(param, pulled=pulled):
            ex = param.locals["self"]._exec_group.execs[0]
            pulled.append(ex.arg_dict["weight"].indices.asnumpy().tolist())
        mod = _fit_lr(pkg, _lr_iter(pkg, path), epochs=2, kvstore=kv,
                      sparse_row_id_fn=row_ids, batch_end_callback=held_rows)
        got[pkg] = (mod._exec_group.execs[0].arg_dict["weight"].asnumpy(),
                    pulled)
    np.testing.assert_allclose(got[mt][0], got[mx][0], **STEP_TOL)
    # after each step but an epoch's last, the weight holds the next
    # batch's rows, pulled by prepare
    it = _lr_iter(mt, path)
    nxt = [sorted(set(b.data[0].indices.asnumpy().tolist())) for b in it]
    assert got[mt][1][:len(nxt) - 1] == nxt[1:]
    assert got[mt][1][:len(nxt) - 1] == got[mx][1][:len(nxt) - 1]
    mod = _fit_lr(mt, _lr_iter(mt, path))
    with pytest.warns(UserWarning, match="No need to call"):
        mod.prepare(_lr_iter(mt, path).next(), sparse_row_id_fn=row_ids)


def test_fused_step_refuses_sparse_parameters(tmp_path):
    path = _lr_data(tmp_path)
    for pkg, fused in ((mt, mt.module.fused), (mx, mx.module.fused)):
        mod = _fit_lr(pkg, _lr_iter(pkg, path))
        assert fused._fused_eligible(mod) == (
            None, "sparse parameters (lazy-update path)")
        assert mod._fused is None
