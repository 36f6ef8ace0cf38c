"""The port's metrics against mxtpu's, on the CPU.

mxtpu computes Accuracy and CrossEntropy on the host in numpy; the port
accumulates each batch's sum as a float32 tensor on the predictions'
device and reads it back only in get(). After N batches (a padded one
among them, whose padding rows count, as in mxtpu) the values agree:
Accuracy exactly (a count of hits), CrossEntropy within 1e-6 relative
(a float32 sum of logs in another order). The rest of mxtpu's metrics
are held the same way, each on data of its kind (scores of 7 classes,
binary decisions, regression columns, loss outputs), and those with a
device rule also by their device (sum, count) of one batch against
mxtpu's host update and its jnp ``device_batch``; TopKAccuracy's ties
fall as mxtpu's do on each side.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

BATCHES = 5


def _batches(seed=0, rows=16, classes=7):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(BATCHES):
        logits = rng.standard_normal((rows, classes)).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        label = rng.randint(0, classes, rows).astype(np.float32)
        if i == BATCHES - 1:            # a last batch padded by wrapping
            probs[-5:], label[-5:] = out[0][0][:5], out[0][1][:5]
        out.append((probs.astype(np.float32), label))
    return out


def _run(pkg, metric):
    for probs, label in _batches():
        metric.update([pkg.nd.array(label, ctx=pkg.cpu())],
                      [pkg.nd.array(probs, ctx=pkg.cpu())])
    return metric


@pytest.mark.parametrize("name", ["acc", "ce", "composite"])
def test_values_after_n_batches_match_mxtpu(name):
    def make(pkg):
        if name == "composite":
            return pkg.metric.CompositeEvalMetric(["acc", "ce"])
        return pkg.metric.create(name)
    got = _run(mt, make(mt)).get_name_value()
    want = _run(mx, make(mx)).get_name_value()
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (n, w) in zip(got, want):
        if n == "accuracy":
            assert g == w
        else:
            assert g == pytest.approx(w, rel=1e-6)


def test_accuracy_accumulates_on_the_device_until_get():
    metric = mt.metric.Accuracy()
    probs, label = _batches()[0]
    metric.update([mt.nd.array(label, ctx=mt.cpu())],
                  [mt.nd.array(probs, ctx=mt.cpu())])
    # the batch's hits wait as a tensor; nothing was read back yet
    assert isinstance(metric._pending, torch.Tensor)
    assert metric.sum_metric == 0.0 and metric.num_inst == 16
    host = mx.metric.Accuracy()
    host.update([mx.nd.array(label)], [mx.nd.array(probs)])
    assert metric.get() == host.get()
    assert metric._pending is None and metric.sum_metric == host.sum_metric
    metric.reset()
    assert metric.num_inst == 0 and np.isnan(metric.get()[1])


def test_accuracy_of_decided_labels_and_axis():
    """Scores already of the labels' shape are compared as they are."""
    label = np.array([0, 1, 2, 1], np.float32)
    decided = np.array([0, 1, 1, 1], np.float32)
    for pkg in (mt, mx):
        m = pkg.metric.Accuracy()
        m.update([pkg.nd.array(label, ctx=pkg.cpu())],
                 [pkg.nd.array(decided, ctx=pkg.cpu())])
        assert m.get() == ("accuracy", 0.75)
    scores = np.eye(3, dtype=np.float32)[None].repeat(2, 0)     # (2, 3, 3)
    lab = np.array([[0, 1, 2], [0, 0, 0]], np.float32)
    got, want = mt.metric.Accuracy(axis=2), mx.metric.Accuracy(axis=2)
    got.update([mt.nd.array(lab, ctx=mt.cpu())],
               [mt.nd.array(scores, ctx=mt.cpu())])
    want.update([mx.nd.array(lab)], [mx.nd.array(scores)])
    assert got.get() == want.get()


def test_update_async_reader_and_resetter():
    reads, resets = [], []

    def read():
        reads.append(1)
        return 6.0, 10

    metric = mt.metric.Accuracy()
    metric.update_async(read, lambda: resets.append(1))
    assert metric.get() == ("accuracy", 0.6) and len(reads) == 1
    metric.reset()
    assert resets == [1]
    metric.detach_async()
    assert np.isnan(metric.get()[1])


def test_create_and_mismatch():
    assert isinstance(mt.metric.create("acc"), mt.metric.Accuracy)
    assert isinstance(mt.metric.create(["acc", "ce"]),
                      mt.metric.CompositeEvalMetric)
    with pytest.raises(ValueError):
        mt.metric.create("no-such-metric")
    with pytest.raises(ValueError):
        mt.metric.Accuracy().update([mt.nd.array([1.0], ctx=mt.cpu())], [])


def _kind_batches(kind, seed=1, rows=16):
    """BATCHES (scores, label) pairs of one kind of data."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(BATCHES):
        if kind == "binary":
            scores = rng.rand(rows, 2).astype(np.float32)
            label = rng.randint(0, 2, rows).astype(np.float32)
        elif kind == "regression":
            label = rng.standard_normal(rows).astype(np.float32)
            scores = (label[:, None] + 0.3 * rng.standard_normal(
                (rows, 1))).astype(np.float32)
        elif kind == "pairs":
            label = rng.standard_normal(rows).astype(np.float32)
            scores = (label + 0.5 * rng.standard_normal(rows)).astype(
                np.float32)
        elif kind == "loss":
            scores = rng.rand(rows, 3).astype(np.float32)
            label = np.zeros(rows, np.float32)
        else:
            logits = rng.standard_normal((rows, 7)).astype(np.float32)
            scores = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
                      ).astype(np.float32)
            label = rng.randint(0, 7, rows).astype(np.float32)
        out.append((scores, label))
    return out


NEW_METRICS = {
    "top_k_accuracy": (dict(top_k=3), "scores"),
    "top_k_acc": (dict(top_k=2), "scores"),
    "f1": ({}, "binary"),
    "mcc": ({}, "binary"),
    "mae": ({}, "regression"),
    "mse": ({}, "regression"),
    "rmse": ({}, "regression"),
    "nll_loss": ({}, "scores"),
    "pearsonr": ({}, "pairs"),
    "loss": ({}, "loss"),
    "torch": ({}, "loss"),
    "caffe": ({}, "loss"),
}


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_new_metrics_after_n_batches_match_mxtpu(name):
    """Each metric after BATCHES batches: counts exactly, the rest within
    1e-6 relative (float32 sums in another order)."""
    kw, kind = NEW_METRICS[name]
    got, want = mt.metric.create(name, **kw), mx.metric.create(name, **kw)
    assert type(got).__name__ == type(want).__name__
    assert got.get_config() == want.get_config()
    for scores, label in _kind_batches(kind):
        got.update([mt.nd.array(label, ctx=mt.cpu())],
                   [mt.nd.array(scores, ctx=mt.cpu())])
        want.update([mx.nd.array(label)], [mx.nd.array(scores)])
    (gn, gv), (wn, wv) = got.get(), want.get()
    assert gn == wn and got.num_inst == want.num_inst
    assert gv == pytest.approx(wv, rel=1e-6, abs=1e-7)


DEVICE_RULES = ("top_k_accuracy", "mae", "mse", "rmse", "nll_loss", "ce",
                "loss")


@pytest.mark.parametrize("name", DEVICE_RULES)
def test_device_batch_matches_host_update(name):
    """One batch's device (sum, count), what the fused step adds, against
    mxtpu's host update of the batch and its jnp device_batch."""
    kw, kind = NEW_METRICS.get(name, ({}, "scores"))
    scores, label = _kind_batches(kind, seed=4)[0]
    got = mt.metric.create(name, **kw)
    assert got.supports_device_update()
    total, count = got.device_batch([mt.nd.array(label, ctx=mt.cpu())],
                                    [mt.nd.array(scores, ctx=mt.cpu())])
    host = mx.metric.create(name, **kw)
    host.update([mx.nd.array(label)], [mx.nd.array(scores)])
    jtotal, jcount = host.device_batch([jnp.asarray(label)],
                                       [jnp.asarray(scores)])
    assert count == host.num_inst == jcount
    assert float(total) == pytest.approx(host.sum_metric, rel=1e-6,
                                         abs=1e-7)
    assert float(total) == pytest.approx(float(jtotal), rel=1e-6, abs=1e-7)


def test_top_k_ties_fall_as_in_mxtpu():
    """Tied scores: at 8 classes numpy's argsort keeps the order of the
    indices (the host update's), and at 1,000 classes the device rule's
    stable sort gives jnp's ranking; every row ties."""
    label = np.arange(8, dtype=np.float32)
    scores = np.full((8, 8), 0.125, np.float32)
    for pkg in (mt, mx):
        m = pkg.metric.create("top_k_accuracy", top_k=3)
        m.update([pkg.nd.array(label, ctx=pkg.cpu())],
                 [pkg.nd.array(scores, ctx=pkg.cpu())])
        assert m.get()[1] == 3 / 8          # the three last indices
    wide = np.full((6, 1000), 1e-3, np.float32)
    wide[:, 10] = 0.5
    lab = np.array([10, 999, 998, 997, 996, 3], np.float32)
    got = mt.metric.create("top_k_accuracy", top_k=4).device_batch(
        [mt.nd.array(lab, ctx=mt.cpu())], [mt.nd.array(wide, ctx=mt.cpu())])
    want = mx.metric.create("top_k_accuracy", top_k=4).device_batch(
        [jnp.asarray(lab)], [jnp.asarray(wide)])
    assert float(got[0]) == float(want[0]) == 4.0 and got[1] == want[1]


def test_create_by_name_alias_callable():
    def feval(label, pred):
        return float(np.abs(label - pred.argmax(1)).sum()), label.size
    for pkg in (mt, mx):
        assert type(pkg.metric.create("nll_loss")).__name__ == \
            "NegativeLogLikelihood"
        assert type(pkg.metric.create("pearsonr")).__name__ == \
            "PearsonCorrelation"
        assert pkg.metric.create("top_k_acc", top_k=5).name == \
            "top_k_accuracy_5"
        with pytest.raises((ValueError, AssertionError)):
            pkg.metric.create("top_k_accuracy", top_k=1)
    probs, label = _batches()[0]
    values = []
    for pkg in (mt, mx):
        m = pkg.metric.create(feval)
        assert type(m).__name__ == "CustomMetric" and m.name == "feval"
        m.update([pkg.nd.array(label, ctx=pkg.cpu())],
                 [pkg.nd.array(probs, ctx=pkg.cpu())])
        values.append(m.get())
    assert values[0] == values[1]
