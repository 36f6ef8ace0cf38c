"""The port's NDArrayIter, ResizeIter and PrefetchingIter against
mxtpu's, on the CPU.

Under one np.random.seed both packages must serve the same batches,
bit for bit (the arrays are copied, not computed): shuffled or not, with
each last_batch_handle (pad, discard, roll_over) over two epochs, with
the same pad counts and descriptors, leaving numpy's global RNG in the
same state; and a state_dict taken mid-epoch resumes the same batches.
The combinators run tests/test_io.py's cases in both packages, each
scenario's batches, states and errors equal to mxtpu's.
"""
import threading

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from torch_threads import torch_threads_shared  # noqa: F401

N, BATCH = 23, 5


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((N, 3, 2)).astype(np.float32),
            rng.randint(0, 4, N).astype(np.float32))


def _epochs(pkg, seed, epochs=2, **kw):
    """Batches of ``epochs`` epochs as numpy, the iterator, and numpy's
    next global draw after building the iterator."""
    x, y = _arrays()
    np.random.seed(seed)
    it = pkg.io.NDArrayIter(x, y, **kw)
    after = np.random.randint(0, 2 ** 31 - 1)
    out = []
    for _ in range(epochs):
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [l.asnumpy() for l in b.label], b.pad))
        it.reset()
    return out, it, after


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_match_mxtpu(handle, shuffle):
    kw = dict(batch_size=BATCH, shuffle=shuffle, last_batch_handle=handle)
    want, want_it, want_after = _epochs(mx, 7, **kw)
    got, got_it, got_after = _epochs(mt, 7, **kw)
    assert got_after == want_after          # one shuffle draw, as mxtpu
    assert len(got) == len(want) > 0
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        for g, w in zip(gd + gl, wd + wl):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    assert [(d.name, d.shape) for d in got_it.provide_data] == \
        [(d.name, d.shape) for d in want_it.provide_data]
    assert [(d.name, d.shape) for d in got_it.provide_label] == \
        [(d.name, d.shape) for d in want_it.provide_label]


def test_pad_counts_and_host_batches():
    got, _, _ = _epochs(mt, 0, epochs=1, batch_size=BATCH)
    assert [p for _, _, p in got] == [0, 0, 0, 0, 2]
    x, y = _arrays()
    last_data, last_label, _ = got[-1]
    np.testing.assert_array_equal(last_data[0], np.concatenate([x[20:],
                                                                x[:2]]))
    np.testing.assert_array_equal(last_label[0], np.concatenate([y[20:],
                                                                 y[:2]]))
    it = mt.io.NDArrayIter(x, y, BATCH)
    batch = next(iter(it))
    assert all(a.context == mt.cpu() for a in batch.data + batch.label)
    # staging onto the CPU context is a no-op; the batch keeps its arrays
    same = batch.data[0]
    assert mt.io.stage_batch(batch, mt.cpu()).data[0] is same


def test_named_and_multiple_inputs_match_mxtpu():
    x, y = _arrays()
    for data in ({"a": x, "b": x[:, 0]}, [x, x[:, :1]]):
        got = mt.io.NDArrayIter(data, y, BATCH)
        want = mx.io.NDArrayIter(data, y, BATCH)
        assert [(d.name, d.shape) for d in got.provide_data] == \
            [(d.name, d.shape) for d in want.provide_data]
        for g, w in zip(got, want):
            for ga, wa in zip(g.data, w.data):
                np.testing.assert_array_equal(ga.asnumpy(), wa.asnumpy())


def test_state_dict_resumes_the_same_batches():
    x, y = _arrays()
    np.random.seed(3)
    it = mt.io.NDArrayIter(x, y, BATCH, shuffle=True)
    np.random.seed(3)
    ref = mx.io.NDArrayIter(x, y, BATCH, shuffle=True)
    for _ in range(2):
        next(it)
        next(ref)
    state = it.state_dict()
    assert state == ref.state_dict()
    np.random.seed(99)                  # a different shuffle, restored
    resumed = mt.io.NDArrayIter(x, y, BATCH, shuffle=True)
    resumed.load_state_dict(state)
    rest = [b.data[0].asnumpy() for b in it]
    again = [b.data[0].asnumpy() for b in resumed]
    assert len(rest) == len(again) == 3
    for a, b in zip(rest, again):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        mt.io.NDArrayIter(x, y, 4).load_state_dict(state)


# ---------------------------------------------------------------------------
# ResizeIter and PrefetchingIter: tests/test_io.py's cases, in both packages
# ---------------------------------------------------------------------------

def _epoch_data(n=20, width=2):
    return (np.arange(n * width, dtype=np.float32).reshape(n, width),
            np.arange(n, dtype=np.float32))


def _values(batches):
    return [([d.asnumpy().tolist() for d in b.data],
             [l.asnumpy().tolist() for l in b.label], b.pad)
            for b in batches]


def _resize(pkg):
    """ResizeIter of 7 over 4 batches wraps around; its state across the
    wrap resumes the same batches in a fresh object."""
    it = pkg.io.ResizeIter(pkg.io.NDArrayIter(np.zeros((16, 2), "f"), None,
                                              batch_size=4), 7)
    count = len(list(it))
    x, y = _epoch_data()
    it = pkg.io.ResizeIter(pkg.io.NDArrayIter(x, y, batch_size=4), 8)
    [it.next() for _ in range(6)]
    state = it.state_dict()
    want = _values(it.next() for _ in range(2))
    it2 = pkg.io.ResizeIter(pkg.io.NDArrayIter(x, y, batch_size=4), 8)
    it2.load_state_dict(state)
    got = _values(it2.next() for _ in range(2))
    with pytest.raises(StopIteration):
        it2.next()
    return count, state, want, got


def _prefetch(pkg):
    """Two epochs through PrefetchingIter, and its descriptors."""
    x = np.arange(64, dtype="f").reshape(16, 4)
    it = pkg.io.PrefetchingIter(pkg.io.NDArrayIter(x, np.arange(16, dtype="f"),
                                                   batch_size=4))
    first = _values(it)
    it.reset()
    return ([(d.name, d.shape) for d in it.provide_data], it.batch_size,
            first, _values(it))


def _rename(pkg):
    """Two wrapped iterators, renamed descriptors, lists concatenated."""
    x1 = np.arange(24, dtype="f").reshape(12, 2)
    x2 = np.arange(24, 36, dtype="f").reshape(12, 1)
    y = np.arange(12, dtype="f")
    it1 = pkg.io.NDArrayIter(x1, y, batch_size=4, data_name="a",
                             label_name="la")
    it2 = pkg.io.NDArrayIter(x2, None, batch_size=4, data_name="b")
    pre = pkg.io.PrefetchingIter([it1, it2],
                                 rename_data=[{"a": "left"}, {"b": "right"}],
                                 rename_label=[{"la": "y"}, {}])
    descs = ([(d.name, d.shape) for d in pre.provide_data],
             [(d.name, d.shape) for d in pre.provide_label])
    first = _values(pre)
    pre.reset()
    return descs, first, _values(pre)


def _tracker(pkg, n=4):
    """A source whose next() marks when each fetch begins."""
    class Tracker(pkg.io.DataIter):
        def __init__(self):
            super().__init__(batch_size=2)
            self.i = 0
            self.started = [threading.Event() for _ in range(n + 1)]

        @property
        def provide_data(self):
            return [pkg.io.DataDesc("data", (2, 3))]

        @property
        def provide_label(self):
            return [pkg.io.DataDesc("label", (2,))]

        def reset(self):
            self.i = 0

        def next(self):
            idx = self.i
            self.started[min(idx, n)].set()
            if idx >= n:
                raise StopIteration
            self.i += 1
            return pkg.io.DataBatch(
                data=[pkg.nd.array(np.full((2, 3), idx, "f"), ctx=pkg.cpu())],
                label=[pkg.nd.array(np.full(2, idx, "f"), ctx=pkg.cpu())],
                pad=0)
    return Tracker()


def _overlap(pkg):
    """The thread fetches batch 1 while the consumer holds batch 0, and a
    reset with a batch in flight restarts at batch 0 with none lost."""
    src = _tracker(pkg)
    it = pkg.io.PrefetchingIter(src)
    assert src.started[0].wait(5)
    assert it.iter_next()
    held = it.current_batch.data[0].asnumpy().tolist()
    assert src.started[1].wait(5), "batch 1 not prefetched while 0 is held"
    rest = []
    while it.iter_next():
        rest.append(float(it.current_batch.data[0].asnumpy()[0, 0]))
    src = _tracker(pkg)
    it = pkg.io.PrefetchingIter(src)
    assert it.iter_next() and it.iter_next()
    it.reset()
    after_reset = []
    while it.iter_next():
        after_reset.append(float(it.current_batch.data[0].asnumpy()[0, 0]))
    it.reset()
    return held, rest, after_reset, sum(1 for _ in it)


def _restore(pkg):
    """state_dict is the delivered position; restored into a fresh
    PrefetchingIter it continues where the saved run left off, then
    resets into a whole epoch."""
    x, y = _epoch_data()
    it = pkg.io.PrefetchingIter(pkg.io.NDArrayIter(x, y, batch_size=4))
    it.next()
    delivered = it.state_dict()
    it.next()
    state = it.state_dict()
    want = _values(it.next() for _ in range(3))
    it2 = pkg.io.PrefetchingIter(pkg.io.NDArrayIter(x, y, batch_size=4))
    it2.load_state_dict(state)
    got = _values(it2.next() for _ in range(3))
    ended = not it2.iter_next()
    it2.reset()
    count = 0
    while it2.iter_next():
        count += 1
    return delivered, state, want, got, ended, count


def _counting(pkg, base, fail_at=None):
    """A source of 6 batches with no resume state (``base`` a DataIter,
    or ``object`` for one outside the protocol); raises at ``fail_at``."""
    class Counting(base):
        batch_size = 2
        provide_data = [("data", (2, 3))]
        provide_label = [("label", (2,))]

        def __init__(self):
            self.i = 0

        def reset(self):
            self.i = 0

        def next(self):
            if self.i == fail_at:
                raise RuntimeError("disk on fire")
            if self.i >= 6:
                raise StopIteration
            b = pkg.io.DataBatch(
                [pkg.nd.array(np.full((2, 3), self.i, "f"), ctx=pkg.cpu())],
                [pkg.nd.array(np.zeros(2, "f"), ctx=pkg.cpu())], pad=0)
            self.i += 1
            return b
    return Counting()


def _stateless(pkg):
    """Sources without a resume state (a DataIter's {} and an object with
    no state_dict at all): restore resets and fast-forwards."""
    out = []
    for base in (pkg.io.DataIter, object):
        it = pkg.io.PrefetchingIter(_counting(pkg, base))
        [it.next() for _ in range(3)]
        state = it.state_dict()
        it2 = pkg.io.PrefetchingIter(_counting(pkg, base))
        it2.load_state_dict(state)
        out.append((state, [float(it2.next().data[0].asnumpy()[0, 0])
                            for _ in range(3)]))
    return out


def _worker_error(pkg):
    """A source that raises mid-stream: the error reaches the consumer's
    next() after the batches before it."""
    it = pkg.io.PrefetchingIter(_counting(pkg, pkg.io.DataIter, fail_at=2))
    got = [float(it.next().data[0].asnumpy()[0, 0]) for _ in range(2)]
    with pytest.raises(RuntimeError, match="disk on fire"):
        it.next()
    return got


@pytest.mark.parametrize("scenario", [_resize, _prefetch, _rename, _overlap,
                                      _restore, _stateless, _worker_error],
                         ids=lambda f: f.__name__.strip("_"))
def test_combinators_match_mxtpu(scenario):
    want = scenario(mx)
    got = scenario(mt)
    assert got == want
