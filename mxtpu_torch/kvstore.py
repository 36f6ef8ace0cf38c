"""Key-value store of the PyTorch port: the local store.

Counterpart of ``mxtpu/kvstore.py``'s ``KVStore`` and ``create`` for
the single-process types (``local``, ``device``, ``nccl``, ...):
``init``, ``push`` (the pushed list of arrays summed), ``pull``,
``set_optimizer`` / ``set_updater`` (the update runs on the store's
copy of the weight at push time), ``type`` / ``rank`` / ``num_workers``
and the optimizer-state files. The store keeps its own tensor for each
key; ``pull`` copies it into the targets, which never share it.
"""
from __future__ import annotations

import torch

from .ndarray import NDArray

__all__ = ["KVStore", "create"]


def _key_value(keys, vals):
    if isinstance(keys, (list, tuple)):
        if len(keys) != len(vals):
            raise ValueError("%d keys for %d values" % (len(keys), len(vals)))
        return list(keys), list(vals)
    return [keys], [vals]


def _key_int(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


class KVStore:
    """A store of one process: no workers to reduce across."""

    def __init__(self, kv_type="local"):
        self._type = kv_type
        self._store = {}
        self._updater = None

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        """Give key(s) their first value(s) (a copy)."""
        for k, v in zip(*_key_value(key, value)):
            if isinstance(v, (list, tuple)):
                v = v[0]
            if k in self._store:
                raise ValueError("key %r already initialized" % (k,))
            self._store[k] = v.copy()

    def push(self, key, value, priority=0):
        """Push value(s); a list of arrays for one key is summed. With an
        updater, it runs on the store's value with the sum as gradient;
        else the sum becomes the value."""
        for k, v in zip(*_key_value(key, value)):
            if isinstance(v, (list, tuple)):
                merged = v[0] if len(v) == 1 else \
                    NDArray(sum(a.data.to(v[0].data.device) for a in v),
                            v[0].context)
            else:
                merged = v
            stored = self._store[k]
            if self._updater is not None:
                self._updater(_key_int(k), merged, stored)
            else:
                with torch.no_grad():
                    stored.data.copy_(merged.data)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy the value(s) of key(s) into ``out`` (an array or a list of
        arrays a key)."""
        if out is None:
            raise ValueError("pull needs out=")
        for k, o in zip(*_key_value(key, out)):
            src = self._store[k].data
            with torch.no_grad():
                for arr in (o if isinstance(o, (list, tuple)) else [o]):
                    arr.data.copy_(src, non_blocking=arr.data.is_cuda)

    def set_updater(self, updater):
        """``updater(key, grad, weight)`` runs at each push."""
        self._updater = updater

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` at the store, through an Updater."""
        from . import optimizer as opt
        self.set_updater(opt.get_updater(optimizer))

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise RuntimeError("the store has no optimizer to save")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise RuntimeError("the store has no optimizer to load into")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())


def create(name="local"):
    """A store of type ``name``; the port has the single-process ones."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in ("local", "device", "nccl", "local_allreduce_cpu",
                "local_allreduce_device"):
        return KVStore(name)
    raise ValueError("KVStore type %r is not ported (the local types are)"
                     % name)
