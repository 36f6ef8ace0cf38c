"""Sparse arrays on the CPU, the port against mxtpu: tests/test_sparse.py's
and tests/test_sparse_compact.py's cases run in both packages on the same
seeded numpy inputs (construction, cast_storage, retain, dot, the
storage-aware arithmetic, the dense fallback, the lazy optimizer updates,
the local kvstore's sparse half, save / load, the compact arrays), plus
what the port does its own way: CSR stays compressed (no dense value
behind a CSRNDArray, and a LibSVMIter batch at Avazu's 1,000,001 features
holds O(nnz) elements), files cross both ways, and the lazy updates leave
untouched rows' state stale in both.

Tolerances: construction, retain, save / load and the stored rows are
compared exactly; the arithmetic within TOL (1e-6); ``dot`` within
DOT_TOL (1e-5: the port sums a CSR row's products with ``index_add_``,
mxtpu with one dense matmul); the optimizer updates within OPT_TOL
(rtol 1e-5, atol 1e-6: torch and XLA round the same float32 formulas
apart by an ulp or two).
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)
DOT_TOL = dict(rtol=1e-5, atol=1e-5)
OPT_TOL = dict(rtol=1e-5, atol=1e-6)
VOCAB, DIM = 300_000, 16


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _rand_rsp(pkg, shape, density=0.3, seed=0):
    rng = np.random.RandomState(seed)
    dense = rng.randn(*shape).astype(np.float32)
    dense[~(rng.rand(shape[0]) < density)] = 0
    return pkg.nd.sparse.row_sparse_array(pkg.nd.array(dense)), dense


def _rand_csr(pkg, shape, density=0.3, seed=0):
    rng = np.random.RandomState(seed)
    dense = rng.randn(*shape).astype(np.float32)
    dense[rng.rand(*shape) >= density] = 0
    return pkg.nd.sparse.csr_matrix(pkg.nd.array(dense)), dense


def _same_sparse(got, want, tol=None):
    """The same storage type, stored metadata and value."""
    assert got.stype == want.stype
    assert got.shape == tuple(want.shape)
    if tol is None:
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    else:
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **tol)
    if want.stype == "csr":
        for name in ("indices", "indptr"):
            np.testing.assert_array_equal(getattr(got, name).asnumpy(),
                                          getattr(want, name).asnumpy())
    if want.stype == "row_sparse":
        np.testing.assert_array_equal(got.indices.asnumpy(),
                                      want.indices.asnumpy())


# -- construction, conversion -------------------------------------------------

def test_csr_construction():
    data = np.array([1., 2., 3., 0.])
    indices = np.array([0, 2, 1, 3])
    indptr = np.array([0, 2, 3, 4])
    a = {pkg: pkg.nd.sparse.csr_matrix((data, indices, indptr), shape=(3, 4))
         for pkg in (mt, mx)}
    _same_sparse(a[mt], a[mx])
    # the explicit zero stays stored, as given
    assert a[mt].nnz == a[mx].nnz == 4
    np.testing.assert_array_equal(a[mt].data.asnumpy(), data)
    # compressed: the tensor is torch's CSR layout, no dense value
    assert a[mt].data.data.numel() == 4
    assert a[mt]._data.layout == torch.sparse_csr
    assert isinstance(a[mt], mt.nd.CSRNDArray)


def test_rsp_construction_and_explicit_zero_rows():
    data = np.zeros((2, 3), np.float32)
    data[0] = 1.0
    idx = np.array([1, 4])
    r = {pkg: pkg.nd.sparse.row_sparse_array((data, idx), shape=(6, 3))
         for pkg in (mt, mx)}
    _same_sparse(r[mt], r[mx])
    np.testing.assert_array_equal(r[mt].indices.asnumpy(), idx)
    assert r[mt].nnz == 2


def test_cast_storage_round_trip():
    x = np.array([[0, 1.5], [0, 0], [2.5, 0]], np.float32)
    for stype in ("csr", "row_sparse"):
        s = {pkg: pkg.nd.array(x).tostype(stype) for pkg in (mt, mx)}
        _same_sparse(s[mt], s[mx])
        back = s[mt].tostype("default")
        assert back.stype == "default" and mt.nd.array(x).stype == "default"
        np.testing.assert_array_equal(back.asnumpy(), x)
        np.testing.assert_array_equal(
            mt.nd.sparse.cast_storage(s[mt], "default").asnumpy(), x)


def test_sparse_zeros_empty_array():
    for stype, shape in (("csr", (3, 4)), ("row_sparse", (3, 4))):
        z = {pkg: pkg.nd.sparse.zeros(stype, shape) for pkg in (mt, mx)}
        _same_sparse(z[mt], z[mx])
        assert z[mt].nnz == 0
        assert mt.nd.sparse.empty(stype, shape).stype == stype
    c, _ = _rand_csr(mt, (4, 5), seed=3)
    assert mt.nd.sparse.array(c).stype == "csr"
    assert mt.nd.sparse.array(np.ones((2, 2), np.float32)).stype == "default"


def test_retain():
    r = {pkg: _rand_rsp(pkg, (8, 4), density=0.9, seed=1)[0]
         for pkg in (mt, mx)}
    kept = {pkg: pkg.nd.sparse.retain(r[pkg], pkg.nd.array(
        np.array([0, 3, 7]))) for pkg in (mt, mx)}
    _same_sparse(kept[mt], kept[mx])
    assert set(kept[mt].indices.asnumpy().tolist()) <= {0, 3, 7}
    _same_sparse(r[mt].retain([1, 2]), r[mx].retain([1, 2]))


@pytest.mark.parametrize("transpose_a", [False, True])
def test_sparse_dot(transpose_a):
    rhs = np.random.RandomState(3).randn(5 if transpose_a else 7,
                                         4).astype(np.float32)
    out = {}
    for pkg in (mt, mx):
        a, _ = _rand_csr(pkg, (5, 7), seed=2)
        out[pkg] = pkg.nd.sparse.dot(a, pkg.nd.array(rhs),
                                     transpose_a=transpose_a)
    _same_sparse(out[mt], out[mx], DOT_TOL)
    assert out[mt].stype == ("row_sparse" if transpose_a else "default")


def test_dot_transpose_b_and_the_registry_op():
    rhs = np.random.RandomState(5).randn(4, 7).astype(np.float32)
    for pkg in (mt, mx):
        a, da = _rand_csr(pkg, (5, 7), seed=4)
        got = pkg.nd.sparse.dot(a, pkg.nd.array(rhs), transpose_b=True)
        np.testing.assert_allclose(got.asnumpy(), da @ rhs.T, **DOT_TOL)
        got = pkg.nd.dot(a, pkg.nd.array(rhs.T))
        np.testing.assert_allclose(got.asnumpy(), da @ rhs.T, **DOT_TOL)


def test_csr_dot_gradient_never_densifies():
    """dot(csr, w)'s gradient for w from the compressed tensors: against
    the dense product's, and no (rows, cols) tensor is made on the way."""
    a, da = _rand_csr(mt, (6, 9), seed=6)
    w = torch.from_numpy(np.random.RandomState(7).randn(9, 3).astype(
        np.float32)).requires_grad_()
    head = torch.from_numpy(np.random.RandomState(8).randn(6, 3).astype(
        np.float32))
    made = []
    orig = torch.Tensor.to_dense
    torch.Tensor.to_dense = lambda self, *a, **k: made.append(self) or \
        orig(self, *a, **k)
    try:
        out = mt.ops.linalg_ops.dot(a._data, w)
        g, = torch.autograd.grad([(out * head).sum()], [w])
    finally:
        torch.Tensor.to_dense = orig
    assert made == []
    np.testing.assert_allclose(out.detach().numpy(), da @ w.detach().numpy(),
                               **DOT_TOL)
    np.testing.assert_allclose(g.numpy(), da.T @ head.numpy(), **DOT_TOL)


def test_rsp_arithmetic_keeps_stype():
    for fn in ("add", "subtract", "multiply", "divide"):
        out = {}
        for pkg in (mt, mx):
            a, _ = _rand_rsp(pkg, (6, 3), seed=5)
            b, _ = _rand_rsp(pkg, (6, 3), seed=6)
            if fn == "divide":
                b = pkg.nd.sparse.row_sparse_array(
                    pkg.nd.array(np.abs(b.asnumpy()) + 1.0))
            out[pkg] = getattr(pkg.nd.sparse, fn)(a, b)
        _same_sparse(out[mt], out[mx], TOL)
        assert out[mt].stype == "row_sparse"


def test_dense_op_fallback_and_square_sum():
    """Any dense op takes a sparse array (its dense value)."""
    for pkg in (mt, mx):
        a, da = _rand_csr(pkg, (4, 4), seed=7)
        np.testing.assert_allclose(pkg.nd.relu(a).asnumpy(),
                                   np.maximum(da, 0), **TOL)
        np.testing.assert_allclose((a * 2).asnumpy(), da * 2, **TOL)
        r, dr = _rand_rsp(pkg, (5, 3), seed=8)
        np.testing.assert_allclose(pkg.nd.exp(r).asnumpy(), np.exp(dr),
                                   **TOL)
    for axis in (None, 0, 1):
        got = mt.nd.sparse.square_sum(_rand_rsp(mt, (5, 3), seed=9)[0],
                                      axis=axis)
        want = mx.nd.sparse.square_sum(_rand_rsp(mx, (5, 3), seed=9)[0],
                                       axis=axis)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)


def test_csr_slice_astype_copyto():
    for pkg in (mt, mx):
        a, da = _rand_csr(pkg, (6, 5), seed=10)
        np.testing.assert_array_equal(a[1:4].asnumpy(), da[1:4])
        assert a[1:4].stype == "csr"
    c = {pkg: pkg.nd.array(np.eye(3, dtype=np.float32)).tostype("csr")
         .astype("float16") for pkg in (mt, mx)}
    _same_sparse(c[mt], c[mx])
    r = mt.nd.array(np.eye(3, dtype=np.float32)).tostype("row_sparse")
    assert r.astype("float16").stype == "row_sparse"
    a = mt.nd.array(np.eye(4, dtype=np.float32)).tostype("row_sparse")
    b = mt.nd.sparse.zeros("row_sparse", (4, 4))
    a.copyto(b)
    np.testing.assert_array_equal(b.asnumpy(), np.eye(4))
    np.testing.assert_array_equal(b.indices.asnumpy(), [0, 1, 2, 3])


def test_assignment_recovers_nonzero_rows():
    """After an assignment the stored rows are the nonzero rows (mxtpu's
    _recompute_aux after _assign_value), found on the array's device. The
    port counts item assignment as one; mxtpu's __setitem__ leaves the
    rows it stored before (a documented difference)."""
    val = np.zeros((5, 2), np.float32)
    val[[1, 3]] = 2.0
    r = mt.nd.sparse.zeros("row_sparse", (5, 2))
    r[:] = val
    w = mx.nd.sparse.zeros("row_sparse", (5, 2))
    w._assign_value(mx.nd.array(val))
    for arr in (r, w):
        np.testing.assert_array_equal(arr.indices.asnumpy(), [1, 3])
        np.testing.assert_array_equal(arr.data.asnumpy(), val[[1, 3]])
    stale = mx.nd.sparse.zeros("row_sparse", (5, 2))
    stale[:] = val
    assert stale.nnz == 0


# -- the lazy optimizer updates -----------------------------------------------

LAZY_CASES = [("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
              ("adam", {"learning_rate": 0.1}),
              ("adagrad", {"learning_rate": 0.1}),
              ("ftrl", {"learning_rate": 0.1})]


@pytest.mark.parametrize("opt_name,opt_kwargs", LAZY_CASES)
def test_lazy_optimizer_update(opt_name, opt_kwargs):
    """Two lazy updates of different row sets in both packages: the same
    weights and states; untouched rows keep their weight, and their state
    stays stale (what the first update left)."""
    shape = (10, 4)
    rng = np.random.RandomState(8)
    w0 = rng.randn(*shape).astype(np.float32)
    steps = [(rng.randn(3, 4).astype(np.float32), np.array([1, 5, 6])),
             (rng.randn(2, 4).astype(np.float32), np.array([0, 5]))]
    got = {}
    for pkg in (mt, mx):
        o = pkg.optimizer.create(opt_name, **opt_kwargs)
        w = pkg.nd.array(w0.copy())
        state = o.create_state(0, w)
        states = []
        for rows, ids in steps:
            o.update(0, w, pkg.nd.sparse.row_sparse_array(
                (rows, ids), shape=shape), state)
            leaves = state if isinstance(state, tuple) else (state,)
            states.append([s.asnumpy().copy() for s in leaves
                           if s is not None])
        got[pkg] = (w.asnumpy(), states)
    np.testing.assert_allclose(got[mt][0], got[mx][0], **OPT_TOL)
    for s_mt, s_mx in zip(got[mt][1], got[mx][1]):
        for a, b in zip(s_mt, s_mx):
            np.testing.assert_allclose(a, b, **OPT_TOL)
    w, states = got[mt]
    never = [2, 3, 4, 7, 8, 9]
    np.testing.assert_array_equal(w[never], w0[never])
    # row 1 and 6, touched only by the first step: their state is stale
    for first, second in zip(*states):
        np.testing.assert_array_equal(second[[1, 6]], first[[1, 6]])
        np.testing.assert_array_equal(second[never], 0)


def test_lazy_update_off_and_the_update_ops():
    """lazy_update=False takes the dense rule over every row (momentum
    moves untouched rows too); the update ops accept lazy_update."""
    shape = (6, 2)
    w0 = np.arange(12, dtype=np.float32).reshape(shape)
    g = (np.ones((1, 2), np.float32), np.array([2]))
    got = {}
    for pkg in (mt, mx):
        o = pkg.optimizer.SGD(learning_rate=0.5, momentum=0.9, wd=0.1,
                              lazy_update=False)
        w = pkg.nd.array(w0.copy())
        st = o.create_state(0, w)
        o.update(0, w, pkg.nd.sparse.row_sparse_array(g, shape=shape), st)
        upd = pkg.nd.sgd_update(pkg.nd.array(w0), pkg.nd.array(w0), lr=0.1,
                                lazy_update=True)
        got[pkg] = (w.asnumpy(), upd.asnumpy())
    np.testing.assert_allclose(got[mt][0], got[mx][0], **OPT_TOL)
    np.testing.assert_allclose(got[mt][1], got[mx][1], **OPT_TOL)
    assert not np.array_equal(got[mt][0][0], w0[0])


# -- the local kvstore's sparse half ------------------------------------------

def test_kvstore_row_sparse_pull():
    shape = (8, 3)
    val = np.random.RandomState(9).randn(*shape).astype(np.float32)
    out = {}
    for pkg in (mt, mx):
        kv = pkg.kv.create("local")
        kv.init("w", pkg.nd.array(val))
        out[pkg] = pkg.nd.sparse.zeros("row_sparse", shape)
        kv.row_sparse_pull("w", out=out[pkg],
                           row_ids=pkg.nd.array(np.array([5, 2, 5])))
    _same_sparse(out[mt], out[mx])
    np.testing.assert_array_equal(out[mt].indices.asnumpy(), [2, 5])


def test_dense_pull_not_zeroed_by_row_sparse_pull():
    val = np.arange(12, dtype=np.float32).reshape(4, 3)
    for pkg in (mt, mx):
        kv = pkg.kv.create("local")
        kv.init("w", pkg.nd.array(val))
        dense_out = pkg.nd.zeros((4, 3))
        kv.row_sparse_pull("w", out=dense_out,
                           row_ids=pkg.nd.array(np.array([1])))
        np.testing.assert_array_equal(dense_out.asnumpy(), val)
        rows_out = pkg.nd.zeros((1, 3))
        kv.row_sparse_pull("w", out=rows_out,
                           row_ids=pkg.nd.array(np.array([2])))
        np.testing.assert_array_equal(rows_out.asnumpy(), val[2:3])


def test_push_rsp_list_unions_rows():
    val = np.arange(12, dtype=np.float32).reshape(4, 3)
    got = {}
    for pkg in (mt, mx):
        kv = pkg.kv.create("local")
        kv.init("w", pkg.nd.array(val))
        g1 = pkg.nd.sparse.row_sparse_array(
            (np.ones((1, 3), np.float32), np.array([0])), shape=(4, 3))
        g2 = pkg.nd.sparse.row_sparse_array(
            (np.ones((1, 3), np.float32), np.array([2])), shape=(4, 3))
        seen = {}

        def updater(key, recv, local, seen=seen, pkg=pkg):
            seen["rows"] = recv.indices.asnumpy()
            pkg.optimizer.get_updater(pkg.optimizer.create(
                "sgd", learning_rate=1.0, wd=0.0))(key, recv, local)
        kv.set_updater(updater)
        kv.push("w", [g1, g2])
        out = pkg.nd.zeros((4, 3))
        kv.pull("w", out=out)
        got[pkg] = (out.asnumpy(), seen["rows"])
    np.testing.assert_array_equal(got[mt][0], got[mx][0])
    np.testing.assert_array_equal(got[mt][1], [0, 2])
    np.testing.assert_array_equal(got[mt][0][[1, 3]], val[[1, 3]])


# -- save / load --------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "mxtpu"])
def test_sparse_save_load_both_ways(tmp_path, writer):
    """nd.save in one package, nd.load in the other: CSR, row-sparse
    (its stored rows as given, an explicit zero row among them) and
    dense entries."""
    src_pkg, dst_pkg = (mt, mx) if writer == "port" else (mx, mt)
    a, da = _rand_csr(src_pkg, (4, 6), seed=10)
    r = src_pkg.nd.sparse.row_sparse_array(
        (np.array([[1, 2], [0, 0]], np.float32), np.array([1, 3])),
        shape=(5, 2))
    fname = str(tmp_path / "arrs.params")
    src_pkg.nd.save(fname, {"a": a, "r": r,
                            "d": src_pkg.nd.array(np.ones((2, 2), "f"))})
    back = dst_pkg.nd.load(fname)
    assert back["d"].stype == "default"
    _same_sparse(back["a"], a)
    _same_sparse(back["r"], r)
    np.testing.assert_array_equal(back["r"].indices.asnumpy(), [1, 3])
    np.testing.assert_allclose(back["a"].asnumpy(), da, **TOL)
    with open(fname, "rb") as f:
        loaded = mt.nd.load_from_bytes(f.read())
    _same_sparse(loaded["a"], a)


def test_save_rejects_reserved_keys(tmp_path):
    for pkg in (mt, mx):
        with pytest.raises(ValueError):
            pkg.nd.save(str(tmp_path / "x.params"), {"a::b": pkg.nd.zeros(1)})


# -- the compact row-sparse arrays --------------------------------------------

def _nbytes(t_list):
    return sum(t.numel() * t.element_size() for t in t_list)


def test_device_memory_proportional_to_nnz_max():
    a = mt.nd.sparse.zeros("row_sparse", (VOCAB, DIM), nnz_max=32)
    assert a.shape == (VOCAB, DIM) and a._data.shape == (32, DIM)
    assert _nbytes([a._data, a._aux["indices"]._data]) < VOCAB * DIM * 4 / 1000
    a._set_rows(np.array([7, 100_000]), a._data[:2] + 1.0)
    host = a.asnumpy()
    assert host.shape == (VOCAB, DIM)
    assert host[7, 0] == 1.0 and host[100_000, 0] == 1.0
    assert host.sum() == 2 * DIM
    with pytest.raises(Exception, match="nnz_max rows"):
        a.todense()
    with pytest.raises(Exception, match="nnz_max rows"):
        mt.nd.relu(a)


def test_compact_constructors_merge_retain():
    got = {}
    for pkg in (mt, mx):
        sp = pkg.nd.sparse
        a = sp.compact_row_sparse_array(
            (np.array([[1.0] * DIM, [2.0] * DIM], "f"), np.array([10, 3])),
            shape=(VOCAB, DIM), nnz_max=8)
        b = sp.compact_row_sparse_array(
            (np.array([[5.0] * DIM], "f"), np.array([10])),
            shape=(VOCAB, DIM), nnz_max=4)
        m = sp.compact_merge([a, b])
        r = m.retain([3, 77])
        got[pkg] = [(x.indices.asnumpy(), x.data.asnumpy(), x.nnz_max)
                    for x in (a, m, r)]
    for (i1, d1, n1), (i2, d2, n2) in zip(got[mt], got[mx]):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(d1, d2)
        assert n1 == n2
    np.testing.assert_array_equal(got[mt][1][0], [3, 10])
    np.testing.assert_allclose(got[mt][1][1][1], [6.0] * DIM)


def test_kvstore_compact_pull_push_no_densify():
    got = {}
    for pkg in (mt, mx):
        sp = pkg.nd.sparse
        kv = pkg.kv.create("local")
        kv.init(0, sp.compact_row_sparse_array(
            (np.arange(3 * DIM, dtype="f").reshape(3, DIM),
             np.array([5, 900, 200_000])), shape=(VOCAB, DIM), nnz_max=16))
        dst = sp.zeros("row_sparse", (VOCAB, DIM), nnz_max=8)
        kv.row_sparse_pull(0, out=dst, row_ids=pkg.nd.array([900, 5]))
        with pytest.raises(TypeError, match="row_sparse_pull"):
            kv.pull(0, out=pkg.nd.zeros((VOCAB, DIM)))
        g1 = sp.compact_row_sparse_array(
            (np.ones((1, DIM), "f"), np.array([900])), shape=(VOCAB, DIM),
            nnz_max=4)
        g2 = sp.compact_row_sparse_array(
            (np.ones((2, DIM), "f"), np.array([900, 7])), shape=(VOCAB, DIM),
            nnz_max=4)
        seen = {}

        def updater(key, recv, local, seen=seen):
            seen["recv"] = recv
        kv.set_updater(updater)
        kv.push(0, [g1, g2])
        recv = seen["recv"]
        assert type(recv).__name__ == "CompactRowSparseNDArray"
        got[pkg] = (dst.indices.asnumpy(), dst.data.asnumpy(),
                    recv.indices.asnumpy(), recv.data.asnumpy())
    for a, b in zip(got[mt], got[mx]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[mt][2], [7, 900])


def test_kvstore_compact_push_into_dense_store_refused():
    for pkg in (mt, mx):
        kv = pkg.kv.create("local")
        kv.init("w", pkg.nd.zeros((50, 4)))
        g = pkg.nd.sparse.compact_row_sparse_array(
            (np.ones((2, 4), "f"), np.array([3, 7])), shape=(50, 4),
            nnz_max=8)
        with pytest.raises(TypeError):
            kv.push("w", g)


def test_lazy_update_on_compact_weight():
    got = {}
    for pkg in (mt, mx):
        sp = pkg.nd.sparse
        w = sp.compact_row_sparse_array(
            (np.ones((3, DIM), "f"), np.array([2, 50, 9000])),
            shape=(VOCAB, DIM), nnz_max=8)
        g = sp.compact_row_sparse_array(
            (np.full((2, DIM), 0.5, "f"), np.array([50, 9000])),
            shape=(VOCAB, DIM), nnz_max=4)
        opt = pkg.optimizer.SGD(learning_rate=1.0, rescale_grad=1.0, wd=0.0)
        opt.update(0, w, g, opt.create_state(0, w))
        got[pkg] = w.data.asnumpy()
        bad = sp.compact_row_sparse_array(
            (np.ones((1, DIM), "f"), np.array([77])), shape=(VOCAB, DIM),
            nnz_max=2)
        with pytest.raises(KeyError, match="not resident"):
            opt.update(0, w, bad, None)
        mom = pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                rescale_grad=1.0)
        w1 = sp.compact_row_sparse_array(
            (np.ones((1, DIM), "f"), np.array([3])), shape=(VOCAB, DIM),
            nnz_max=2)
        with pytest.raises(NotImplementedError, match="full table lives"):
            mom.update(0, w1, w1.copy(), mom.create_state(0, w1))
    np.testing.assert_array_equal(got[mt], got[mx])
    np.testing.assert_allclose(got[mt][1:], np.full((2, DIM), 0.5))


# -- LibSVMIter's CSR batches -------------------------------------------------

def test_libsvm_csr_batch_holds_o_nnz_at_avazu_width(tmp_path):
    """A CSR batch at 1,000,001 features: its tensors hold nnz values,
    nnz column ids and rows + 1 pointers (a dense batch would hold
    rows x 1,000,001), and its entries are the file's."""
    width, rows, per_row = 1_000_001, 64, 22
    rng = np.random.RandomState(11)
    cols = np.sort(np.stack([rng.choice(width, per_row, replace=False)
                             for _ in range(rows)]), axis=1)
    with open(tmp_path / "a.libsvm", "w") as f:
        for i in range(rows):
            f.write("%d %s\n" % (i % 2, " ".join("%d:1" % c
                                                 for c in cols[i])))
    it = mt.io.LibSVMIter(data_libsvm=str(tmp_path / "a.libsvm"),
                          data_shape=(width,), batch_size=rows)
    batch = it.next()
    csr = batch.data[0]
    assert isinstance(csr, mt.nd.CSRNDArray) and csr.shape == (rows, width)
    nnz = rows * per_row
    t = csr._data
    assert (t.values().numel(), t.col_indices().numel(),
            t.crow_indices().numel()) == (nnz, nnz, rows + 1)
    assert t.values().numel() + t.col_indices().numel() \
        + t.crow_indices().numel() <= 2 * nnz + rows + 1
    np.testing.assert_array_equal(csr.indices.asnumpy(), cols.reshape(-1))
    np.testing.assert_array_equal(csr.indptr.asnumpy(),
                                  np.arange(rows + 1) * per_row)
    np.testing.assert_array_equal(batch.label[0].asnumpy(),
                                  np.arange(rows) % 2)
