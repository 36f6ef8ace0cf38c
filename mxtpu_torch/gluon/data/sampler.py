"""Gluon samplers of the PyTorch port (``mxtpu/gluon/data/sampler.py``;
``RandomSampler`` shuffles with numpy's global stream, as ``mxtpu``'s)."""
from __future__ import annotations

import numpy as _np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(range(self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        indices = _np.arange(self._length)
        _np.random.shuffle(indices)
        return iter(indices.tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Wrap a sampler into batches; last_batch in {'keep','discard',
    'rollover'} (reference sampler.py:81)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError("last_batch must be keep/discard/rollover")

    def __len__(self):
        n = len(self._sampler) + len(self._prev)
        if self._last_batch == "keep":
            return (n + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return n // self._batch_size
        if self._last_batch == "rollover":
            return n // self._batch_size
        raise ValueError("last_batch must be keep/discard/rollover")
