"""Contrib samplers of the PyTorch port (``mxtpu``'s
``gluon/contrib/data/sampler.py``)."""
from __future__ import annotations

from ...data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """i, i + interval, i + 2 interval, ... for each start i (every start
    below ``interval`` with ``rollover``, else 0 alone)."""

    def __init__(self, length, interval, rollover=True):
        assert interval <= length
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        starts = range(self._interval) if self._rollover else [0]
        for start in starts:
            yield from range(start, self._length, self._interval)

    def __len__(self):
        return self._length if self._rollover \
            else (self._length + self._interval - 1) // self._interval
