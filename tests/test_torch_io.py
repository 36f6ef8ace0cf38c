"""The port's NDArrayIter against mxtpu's, on the CPU.

Under one np.random.seed both packages must serve the same batches,
bit for bit (the arrays are copied, not computed): shuffled or not, with
each last_batch_handle (pad, discard, roll_over) over two epochs, with
the same pad counts and descriptors, leaving numpy's global RNG in the
same state; and a state_dict taken mid-epoch resumes the same batches.
"""
import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt

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
