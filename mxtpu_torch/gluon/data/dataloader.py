"""Gluon DataLoader of the PyTorch port.

Counterpart of ``mxtpu/gluon/data/dataloader.py``: batches a Dataset
through a Sampler, in the caller's thread or in worker threads that
make batches ahead of the consumer (``num_workers``, up to ``prefetch``
batches ahead), delivered in order, a worker's error raised to the
caller. ``default_batchify_fn`` stacks samples on the host (arrays, or
NDArrays on the host such as ``data.vision``'s samples), in one copy
that leaves the interpreter lock free for the other workers, and puts
the batch on the current context (the iterating thread's, in the
workers too); where that is a card the batch goes up from pinned host
memory, without blocking the host.
"""
from __future__ import annotations

import queue as _queue
import threading

import numpy as _np
import torch

from ... import ndarray as nd
from ...base import canonical_dtype
from ...context import current_context
from ...ndarray import NDArray
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch on the current context: tuples field by
    field; NDArrays on a card with ``nd.stack``; host NDArrays, and
    anything else as ``nd.array`` of their numpy stack would take it (its
    dtype rules: float64 as float32, int64 as int32), in one copy, straight
    into the host tensor the batch leaves from, pinned when the context
    is a card, and from there up in one copy that does not block the
    host. The copies leave the interpreter lock free for the other
    workers."""
    if isinstance(data[0], tuple):
        return [default_batchify_fn(i) for i in zip(*data)]
    if isinstance(data[0], NDArray) and data[0].context.device_type != "cpu":
        return nd.stack(*data, axis=0)
    ctx = current_context()
    on_card = ctx.device_type == "gpu"
    if isinstance(data[0], NDArray):
        host = torch.empty((len(data),) + data[0].shape, dtype=data[0].dtype,
                           pin_memory=on_card)
        torch.stack([d.data for d in data], out=host)
    else:
        dtype = _np.result_type(*{_np.asarray(d).dtype for d in data})
        dtype = _NARROW.get(dtype, dtype)
        host = torch.empty((len(data),) + _np.shape(data[0]),
                           dtype=canonical_dtype(dtype), pin_memory=on_card)
        _np.stack(data, out=host.numpy())
    if not on_card:
        return NDArray(host, ctx)
    return NDArray(host.to(ctx.torch_device(), non_blocking=True), ctx)


_NARROW = {_np.dtype(_np.float64): _np.dtype(_np.float32),
           _np.dtype(_np.int64): _np.dtype(_np.int32)}


class DataLoader:
    """Batches of ``dataset`` (``mxtpu.gluon.data.DataLoader``)."""

    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif batch_size is not None or shuffle or sampler is not None or \
                last_batch is not None:
            raise ValueError(
                "batch_size/shuffle/sampler/last_batch must not be "
                "specified if batch_sampler is")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)

    def __len__(self):
        return len(self._batch_sampler)

    def _make_batch(self, indices):
        return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        if self._num_workers == 0:
            for indices in self._batch_sampler:
                yield self._make_batch(indices)
            return
        # threaded prefetch pipeline: workers decode ahead of the consumer
        # up to a bounded depth; errors propagate to the caller
        batches = list(self._batch_sampler)
        depth = max(self._prefetch, self._num_workers, 1)
        ctx = current_context()       # the consumer's, for the workers
        out_q = {}
        cond = threading.Condition()
        task_q = _queue.Queue()

        def worker():
            while True:
                # daemon worker parked between tasks; the consumer's
                # finally-block always delivers one None sentinel per
                # worker, so this park cannot outlive the iteration
                item = task_q.get()
                if item is None:
                    return
                i, indices = item
                try:
                    with ctx:
                        result = (self._make_batch(indices), None)
                except BaseException as e:  # propagate to consumer
                    result = (None, e)
                with cond:
                    out_q[i] = result
                    cond.notify_all()

        submitted = min(depth, len(batches))
        for i in range(submitted):
            task_q.put((i, batches[i]))
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self._num_workers)]
        for t in threads:
            t.start()
        try:
            for i in range(len(batches)):
                with cond:
                    while i not in out_q:
                        # tick + liveness: a fleet of workers that died
                        # hard (interpreter teardown, kill) must raise,
                        # not park the consumer forever
                        if not cond.wait(timeout=1.0) and \
                                not any(t.is_alive() for t in threads):
                            raise RuntimeError(
                                "all DataLoader workers died before "
                                "delivering batch %d" % i)
                    batch, err = out_q.pop(i)
                if err is not None:
                    raise err
                if submitted < len(batches):
                    task_q.put((submitted, batches[submitted]))
                    submitted += 1
                yield batch
        finally:
            for _ in threads:
                task_q.put(None)
