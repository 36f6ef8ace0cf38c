"""The port's metrics against mxtpu's, on the CPU.

mxtpu computes Accuracy and CrossEntropy on the host in numpy; the port
accumulates each batch's sum as a float32 tensor on the predictions'
device and reads it back only in get(). After N batches (a padded one
among them, whose padding rows count, as in mxtpu) the values agree:
Accuracy exactly (a count of hits), CrossEntropy within 1e-6 relative
(a float32 sum of logs in another order).
"""
import numpy as np
import pytest
import torch

import mxtpu as mx
import mxtpu_torch as mt

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
