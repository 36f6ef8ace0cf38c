"""Engine controls of the PyTorch port.

Counterpart of ``mxtpu/engine.py``. Work on the card is asynchronous on
torch's streams, as it is under JAX's dispatch, so the same user
semantics hold: :func:`waitall` waits for every card (a synchronize of
each initialised device; nothing on the CPU); ``NaiveEngine``
(``set_engine_type('NaiveEngine')`` or ``MXNET_ENGINE_TYPE``) makes every
eager NDArray op wait for its result; the bulk size is accepted and
recorded, as in ``mxtpu``.
"""
from __future__ import annotations

import os

import torch

__all__ = ["waitall", "set_bulk_size", "bulk", "set_engine_type",
           "engine_type", "is_synchronous"]

_ENGINE_TYPE = os.environ.get("MXNET_ENGINE_TYPE", "ThreadedEnginePerDevice")
_BULK_SIZE = int(os.environ.get("MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN", "15"))


def waitall():
    """Block until all work queued on the cards has finished."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def set_engine_type(name):
    """'NaiveEngine' makes every eager op synchronous (debug mode); any
    Threaded* name restores asynchronous execution."""
    global _ENGINE_TYPE
    if name not in ("NaiveEngine", "ThreadedEngine",
                    "ThreadedEnginePerDevice"):
        raise ValueError("unknown engine type %r" % name)
    _ENGINE_TYPE = name


def engine_type():
    return _ENGINE_TYPE


def is_synchronous():
    return _ENGINE_TYPE == "NaiveEngine"


def set_bulk_size(size):
    """Set the bulk-execution segment size; returns the previous value."""
    global _BULK_SIZE
    prev = _BULK_SIZE
    _BULK_SIZE = int(size)
    return prev


class bulk:
    """Context manager setting the bulk size for its scope (advisory, as
    in ``mxtpu``: eager torch ops are not bulked)."""

    def __init__(self, size):
        self._size = size
        self._old = None

    def __enter__(self):
        self._old = set_bulk_size(self._size)
        return self

    def __exit__(self, *a):
        set_bulk_size(self._old)
