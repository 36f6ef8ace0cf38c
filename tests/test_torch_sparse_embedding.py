"""gluon.contrib.nn.SparseEmbedding and the compact gradient slot on the
CPU, the port against mxtpu: tests/test_sparse_compact.py's embedding
cases in both packages from the same weights (the gradient against a
dense take's under autograd, two calls in one pass summing, a batch past
``nnz_max`` growing the slots, ``grad_req="add"``, a dense gradient
reaching a compact slot, lazy SGD through ``gluon.Trainer``), the
Parameter's ``grad_stype`` / ``grad_nnz_max``, and what the port adds: the
backward makes no tensor of the table's size (every op's output counted
under a dispatch mode).

Tolerances: stored rows exactly; forward rows exactly (a gather); the
gradients within TOL (1e-6: sums of the same few float32 rows, in another
order); the trained weights and losses within TRAIN_TOL (1e-5).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)
TRAIN_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _emb(pkg, vocab, dim, w0, nnz_max=8, grad_req="write"):
    emb = pkg.gluon.contrib.nn.SparseEmbedding(vocab, dim, nnz_max=nnz_max)
    emb.initialize(ctx=pkg.cpu())
    emb.weight.set_data(pkg.nd.array(w0))
    if grad_req != "write":
        emb.weight.grad_req = grad_req
    return emb


def _backward(pkg, emb, ids, head):
    with pkg.autograd.record():
        out = emb(pkg.nd.array(ids))
        loss = pkg.nd.sum(out * pkg.nd.array(head))
    loss.backward()
    return out.asnumpy(), emb.weight.grad()


def _rows(g):
    return g.indices.asnumpy(), g.data.asnumpy()


def test_sparse_embedding_grad_matches_dense_gradcheck_and_mxtpu():
    np.random.seed(0)
    vocab, dim, batch = 50, 4, 6
    ids = np.array([3, 7, 3, 49, 0, 7], "f")
    w0 = np.random.randn(vocab, dim).astype("f")
    head = np.random.randn(batch, dim).astype("f")
    # the port's dense gradient: take under autograd
    wd = mt.nd.array(w0)
    gd = mt.nd.zeros((vocab, dim))
    mt.autograd.mark_variables([wd], [gd])
    with mt.autograd.record():
        dense_out = mt.nd.take(wd, mt.nd.array(ids).astype("int32"), axis=0)
        loss = mt.nd.sum(dense_out * mt.nd.array(head))
    loss.backward()
    got = {pkg: _backward(pkg, _emb(pkg, vocab, dim, w0), ids, head)
           for pkg in (mt, mx)}
    out, g = got[mt]
    assert isinstance(g, mt.nd.sparse.CompactRowSparseNDArray)
    assert g.nnz_max == 8
    np.testing.assert_array_equal(g.indices.asnumpy(), [0, 3, 7, 49])
    np.testing.assert_allclose(g.asnumpy(), gd.asnumpy(), **TOL)
    np.testing.assert_array_equal(out, dense_out.asnumpy())
    np.testing.assert_array_equal(out, got[mx][0])
    for a, b in zip(_rows(g), _rows(got[mx][1])):
        np.testing.assert_allclose(a, b, **TOL)


def test_sparse_embedding_shared_weight_sums_in_one_pass():
    got = {}
    for pkg in (mt, mx):
        emb = _emb(pkg, 30, 4, np.ones((30, 4), "f"))
        with pkg.autograd.record():
            loss = pkg.nd.sum(emb(pkg.nd.array(np.array([1, 2], "f")))) \
                + pkg.nd.sum(emb(pkg.nd.array(np.array([2, 5], "f"))))
        loss.backward()
        first = _rows(emb.weight.grad())
        # the next pass with grad_req='write' replaces
        _backward(pkg, emb, np.array([1, 2], "f"), np.ones((2, 4), "f"))
        got[pkg] = first + _rows(emb.weight.grad())
    for a, b in zip(got[mt], got[mx]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[mt][0], [1, 2, 5])
    np.testing.assert_array_equal(got[mt][1][1], np.full(4, 2.0))
    np.testing.assert_array_equal(got[mt][2], [1, 2])


def test_sparse_embedding_grad_req_add_merges():
    got = {}
    for pkg in (mt, mx):
        emb = _emb(pkg, 30, 4, np.ones((30, 4), "f"), grad_req="add")
        _backward(pkg, emb, np.array([1, 2], "f"), np.ones((2, 4), "f"))
        _backward(pkg, emb, np.array([2, 9], "f"), np.ones((2, 4), "f"))
        got[pkg] = _rows(emb.weight.grad())
    for a, b in zip(got[mt], got[mx]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[mt][0], [1, 2, 9])
    np.testing.assert_array_equal(got[mt][1][:, 0], [1.0, 2.0, 1.0])


def test_sparse_embedding_batch_exceeding_nnz_max_grows():
    got = {}
    for pkg in (mt, mx):
        emb = _emb(pkg, 100, 4, np.ones((100, 4), "f"), nnz_max=2)
        _, g = _backward(pkg, emb, np.arange(10, dtype="f"),
                         np.ones((10, 4), "f"))
        got[pkg] = (g.nnz,) + _rows(g)
    assert got[mt][0] == got[mx][0] == 10
    for a, b in zip(got[mt][1:], got[mx][1:]):
        np.testing.assert_array_equal(a, b)


def test_dense_gradient_into_a_compact_slot():
    """A weight with a compact gradient used by a dense op (take): the
    slot takes the gradient's nonzero rows, as mxtpu's does."""
    w0 = np.random.RandomState(1).randn(40, 3).astype("f")
    got = {}
    for pkg in (mt, mx):
        p = pkg.gluon.Parameter("w_weight", shape=(40, 3),
                                grad_stype="row_sparse", grad_nnz_max=4)
        p.initialize(ctx=pkg.cpu())
        p.set_data(pkg.nd.array(w0))
        with pkg.autograd.record():
            loss = pkg.nd.sum(pkg.nd.take(
                p.data(), pkg.nd.array(np.array([5, 1, 5, 30], "f")),
                axis=0) * 2.0)
        loss.backward()
        g = p.grad()
        assert type(g).__name__ == "CompactRowSparseNDArray"
        got[pkg] = _rows(g)
        p.zero_grad()
        assert p.grad().nnz == 0
    for a, b in zip(got[mt], got[mx]):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_array_equal(got[mt][0], [1, 5, 30])


def test_parameter_grad_stype_without_nnz_max_is_dense_backed():
    got = {}
    for pkg in (mt, mx):
        p = pkg.gluon.Parameter("w_weight", shape=(6, 2),
                                grad_stype="row_sparse", stype="row_sparse")
        p.initialize(init=pkg.init.One(), ctx=pkg.cpu())
        with pkg.autograd.record():
            loss = pkg.nd.sum(pkg.nd.take(p.data(), pkg.nd.array(
                np.array([4, 1], "f")), axis=0))
        loss.backward()
        g = p.grad()
        assert type(g).__name__ == "RowSparseNDArray"
        got[pkg] = (g.indices.asnumpy(), g.asnumpy())
        p.zero_grad()
        assert p.grad().nnz == 0
    for a, b in zip(got[mt], got[mx]):
        np.testing.assert_array_equal(a, b)


def test_sparse_embedding_trains_with_lazy_sgd():
    """SparseEmbedding + Dense through gluon.Trainer(sgd) in both packages
    from the same weights: the losses and weights agree, the embedding
    rows no id touches never move, and the loss falls."""
    rng = np.random.RandomState(1)
    vocab, dim, classes = 120, 8, 4
    w_emb = rng.randn(vocab, dim).astype("f") * 0.3
    w_fc = rng.randn(classes, dim).astype("f") * 0.3
    ids = rng.randint(0, 40, (128,)).astype("f")      # rows 40+ untouched
    labels = (ids % classes).astype("f")
    got = {}
    for pkg in (mt, mx):
        net = pkg.gluon.nn.Sequential()
        emb = pkg.gluon.contrib.nn.SparseEmbedding(vocab, dim, nnz_max=32)
        net.add(emb)
        net.add(pkg.gluon.nn.Dense(classes, in_units=dim))
        net.initialize(ctx=pkg.cpu())
        emb.weight.set_data(pkg.nd.array(w_emb))
        net[1].weight.set_data(pkg.nd.array(w_fc))
        net[1].bias.set_data(pkg.nd.zeros((classes,)))
        loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.5})
        losses = []
        for _ in range(20):
            with pkg.autograd.record():
                loss = loss_fn(net(pkg.nd.array(ids)), pkg.nd.array(labels))
            loss.backward()
            trainer.step(len(ids))
            losses.append(float(pkg.nd.mean(loss).asscalar()))
        got[pkg] = (np.array(losses), emb.weight.data().asnumpy())
    np.testing.assert_allclose(got[mt][0], got[mx][0], **TRAIN_TOL)
    np.testing.assert_allclose(got[mt][1], got[mx][1], **TRAIN_TOL)
    np.testing.assert_array_equal(got[mt][1][40:], w_emb[40:])
    assert got[mt][0][-1] < got[mt][0][0]


class _LargestOutput(TorchDispatchMode):
    """Counts the elements of the largest tensor any op makes in new
    memory (a view, or an in-place op's result, is not counted)."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    @staticmethod
    def _ptrs(values):
        return {v.untyped_storage().data_ptr() for v in values
                if isinstance(v, torch.Tensor) and v.layout == torch.strided}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        known = self._ptrs(list(args) + list(kwargs.values()))
        out = func(*args, **kwargs)
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor) and t.layout == torch.strided \
                    and t.untyped_storage().data_ptr() not in known:
                self.largest = max(self.largest, t.numel())
        return out


def test_backward_makes_no_table_sized_tensor():
    """The backward and the lazy SGD step at a vocabulary of 200,000 x 16
    make no tensor of more than the batch's rows (the table has 3.2M
    elements; the ids 64 x 16)."""
    vocab, dim = 200_000, 16
    rng = np.random.RandomState(3)
    ids = rng.randint(0, vocab, (64,)).astype("f")
    emb = _emb(mt, vocab, dim, np.zeros((vocab, dim), "f"), nnz_max=64)
    trainer = mt.gluon.Trainer(emb.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    with mt.autograd.record():
        loss = mt.nd.sum(emb(mt.nd.array(ids)) * 3.0)
    mode = _LargestOutput()
    with mode:
        loss.backward()
        trainer.step(1)
    assert 0 < mode.largest <= 64 * dim
    w = emb.weight.data().asnumpy()
    touched = np.unique(ids.astype(np.int64))
    np.testing.assert_allclose(w[touched], -0.3 * np.bincount(
        ids.astype(np.int64))[touched][:, None].repeat(dim, 1), **TOL)
    assert np.count_nonzero(w.any(1)) == touched.size
