"""The port's ImageRecordIter against mxtpu's, on the CPU.

- The pool path (``preprocess_threads=2``: spawned processes running the
  same numpy and PIL/cv2 code in both packages) gives the same batches
  exactly, tolerance 0: data, labels and pad over three epochs under
  ``shuffle=True`` (two ``reset()``s), and the same shards under
  ``part_index``/``num_parts``. The port's batches are float32 NCHW on
  the host.
- The in-process path (``preprocess_threads=0``, or a ``mean_img``:
  ImageIter under PrefetchingIter, augmenters in torch where mxtpu's are
  in XLA) gives the same order, labels and pad, and data within 1e-5 of
  the image's largest value.
- The port's pool starts its workers with the card hidden
  (CUDA_VISIBLE_DEVICES empty in their environment, the parent's
  unchanged), and a worker that dies, or a batch that does not come
  within the deadline, raises.
"""
import os
import random
import signal
import time

import numpy as np
import pytest

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu_torch import image as mt_image
from torch_threads import torch_threads_shared  # noqa: F401

N_RECORDS, BATCH = 37, 8
LEVEL2 = dict(data_shape=(3, 28, 28), batch_size=BATCH,
              mean_r=123.68, mean_g=116.779, mean_b=103.939,
              rand_crop=1, rand_mirror=1, pad=4, fill_value=127,
              random_h=36, random_s=50, random_l=50)


@pytest.fixture(scope="module")
def recfile(tmp_path_factory):
    """common/data.py's synthetic CIFAR records (28x28 JPEG)."""
    path = str(tmp_path_factory.mktemp("rec") / "synth.rec")
    rng = np.random.RandomState(0)
    w = mt.recordio.MXRecordIO(path, "w")
    for i in range(N_RECORDS):
        label = i % 10
        img = np.clip(rng.randint(-35, 36, (28, 28, 3)) + 40
                      + (175 * label) // 9, 0, 255).astype(np.uint8)
        w.write(mt.recordio.pack_img(mt.recordio.IRHeader(
            0, float(label), i, 0), img, quality=95))
    w.close()
    return path


def _epochs(it, epochs):
    """Batches of ``epochs`` epochs, reset between them; none is drawn
    after the last (a prefetch thread would draw from Python's RNG)."""
    out = []
    for epoch in range(epochs):
        if epoch:
            it.reset()
        out.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                    for b in it])
    return out


def _pool_pair(**kw):
    """mxtpu's and the port's iterators, built together so that their
    pools start at once; both on the pool path."""
    its = {k: pkg.io.ImageRecordIter(preprocess_threads=2, **kw)
           for k, pkg in (("mxtpu", mx), ("port", mt))}
    assert isinstance(its["port"]._prefetch, mt_image._FastRecordIter)
    assert type(its["mxtpu"]._prefetch).__name__ == "_FastRecordIter"
    return its


def _close(its):
    for it in its.values():
        it.close()


def test_pool_batches_equal_mxtpus(recfile):
    """Shuffled level-2 batches over three epochs: the same data, labels
    and pad, exactly; the last batch of each epoch padded by 3."""
    its = _pool_pair(path_imgrec=recfile, shuffle=True, **LEVEL2)
    try:
        got, want = (_epochs(its[k], 3) for k in ("port", "mxtpu"))
    finally:
        _close(its)
    orders = set()
    for g_epoch, w_epoch in zip(got, want):
        assert len(g_epoch) == len(w_epoch) == -(-N_RECORDS // BATCH)
        assert [b[2] for b in g_epoch] == [b[2] for b in w_epoch] == \
            [0] * (len(g_epoch) - 1) + [-N_RECORDS % BATCH]
        for (gd, gl, _), (wd, wl, _) in zip(g_epoch, w_epoch):
            assert gd.dtype == wd.dtype == np.float32
            assert gd.shape == (BATCH, 3, 28, 28)
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
        orders.add(tuple(np.concatenate([b[1] for b in g_epoch])))
    assert len(orders) == 3                 # each epoch its own order


def test_pool_shards_equal_mxtpus(recfile):
    """num_parts=2: each part's batches equal mxtpu's, the parts hold the
    same number of records and no record twice."""
    kw = dict(path_imgrec=recfile, data_shape=(3, 28, 28), batch_size=BATCH,
              mean_r=123.68, mean_g=116.779, mean_b=103.939, num_parts=2)
    its = {}
    for part in (0, 1):
        for k, it in _pool_pair(part_index=part, **kw).items():
            its[k, part] = it
    try:
        batches = {key: _epochs(it, 1)[0] for key, it in its.items()}
    finally:
        _close(its)
    for part in (0, 1):
        got, want = batches["port", part], batches["mxtpu", part]
        assert len(got) == len(want) == -(-(N_RECORDS // 2) // BATCH)
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            assert gp == wp
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
    firsts = [batches["port", p][0][0][0] for p in (0, 1)]
    assert not np.array_equal(*firsts)      # record 0 vs record 1


@pytest.mark.parametrize("mean_img", [False, True],
                         ids=["rgb_mean", "mean_img"])
def test_in_process_path_matches_mxtpu(recfile, tmp_path, mean_img):
    """preprocess_threads=0 (and any mean_img): ImageIter under
    PrefetchingIter in both packages, Python's RNG seeded alike: the same
    order (labels), pad and shapes over two epochs, data within 1e-5 of
    the image's largest. A mean image computed by one package is the
    file the other loads."""
    got = {}
    for k, pkg in (("mxtpu", mx), ("port", mt)):
        random.seed(5)
        np.random.seed(5)
        extra = {"mean_img": str(tmp_path / (k + ".npz"))} if mean_img \
            else {}
        it = pkg.io.ImageRecordIter(path_imgrec=recfile, shuffle=True,
                                    preprocess_threads=0, **LEVEL2, **extra)
        assert type(it._prefetch).__name__ == "PrefetchingIter"
        got[k] = _epochs(it, 2)
    if mean_img:
        means = [mx.nd.load(str(tmp_path / "mxtpu.npz"))["mean_img"]
                 .asnumpy(),
                 mt.nd.load(str(tmp_path / "port.npz"), ctx=mt.cpu())
                 ["mean_img"].asnumpy()]
        assert means[0].shape == means[1].shape == (28, 28, 3)
        np.testing.assert_allclose(means[1], means[0], rtol=1e-5)
        loaded = mt.nd.load(str(tmp_path / "mxtpu.npz"), ctx=mt.cpu())
        np.testing.assert_array_equal(loaded["mean_img"].asnumpy(),
                                      means[0])
    for g_epoch, w_epoch in zip(got["port"], got["mxtpu"]):
        assert len(g_epoch) == len(w_epoch) == -(-N_RECORDS // BATCH)
        for (gd, gl, gp), (wd, wl, wp) in zip(g_epoch, w_epoch):
            assert gp == wp
            np.testing.assert_array_equal(gl, wl)
            assert gd.dtype == wd.dtype and gd.shape == wd.shape
            np.testing.assert_allclose(gd, wd, rtol=0,
                                       atol=1e-5 * np.abs(wd).max())


def _environ(pid):
    with open("/proc/%d/environ" % pid, "rb") as f:
        return dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                    if b"=" in kv)


def test_pool_hides_the_card_from_its_workers(recfile, monkeypatch):
    """Each worker's environment has CUDA_VISIBLE_DEVICES empty; the
    parent's is as it was. A batch that does not come within the
    deadline raises."""
    before = os.environ.get("CUDA_VISIBLE_DEVICES")
    it = mt.io.ImageRecordIter(path_imgrec=recfile, preprocess_threads=2,
                               **LEVEL2)
    try:
        assert os.environ.get("CUDA_VISIBLE_DEVICES") == before
        pool = it._prefetch
        assert len(pool._workers) == 2
        for pid in pool._workers:
            assert _environ(pid).get(b"CUDA_VISIBLE_DEVICES") == b""
        assert it.next().data[0].shape == (BATCH, 3, 28, 28)
        assert pool.startup_s is not None and pool.startup_s > 0

        class Never:
            def get(self, timeout):
                time.sleep(timeout)
                raise mt_image.multiprocessing.TimeoutError

        monkeypatch.setattr(mt_image, "_POOL_BATCH_TIMEOUT", 0.3)
        monkeypatch.setattr(mt_image, "_POOL_TICK", 0.1)
        with pytest.raises(RuntimeError, match="delivered nothing"):
            pool._wait(Never())
    finally:
        it.close()


def test_a_dead_worker_raises(recfile):
    """A decode worker killed: the pool replaces it, and the next batch
    raises instead of waiting for tasks that died with it."""
    it = mt.io.ImageRecordIter(path_imgrec=recfile, preprocess_threads=2,
                               **LEVEL2)
    try:
        pool = it._prefetch
        it.next()
        os.kill(pool._workers[0], signal.SIGKILL)
        deadline = time.monotonic() + 30
        while pool._worker_pids() == pool._workers:
            assert time.monotonic() < deadline, "the pool kept a dead worker"
            time.sleep(0.05)
        with pytest.raises(RuntimeError, match="worker died"):
            it.next()
    finally:
        it.close()
