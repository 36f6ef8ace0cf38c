"""Key-value store of the PyTorch port: the local store.

Counterpart of ``mxtpu/kvstore.py``'s ``KVStore`` and ``create`` for
the single-process types (``local``, ``device``, ``nccl``, ...):
``init``, ``push`` (the pushed list of arrays summed), ``pull``,
``set_optimizer`` / ``set_updater`` (the update runs on the store's
copy of the weight at push time), ``type`` / ``rank`` / ``num_workers``
and the optimizer-state files. The store keeps its own tensor for each
key; ``pull`` copies it into the targets, which never share it.

The sparse half, as ``mxtpu``'s: a pushed list of row-sparse arrays is
summed into one whose stored rows are the union of theirs, a list of
compact ones merged compactly (``compact_merge``: no dense buffer);
``row_sparse_pull`` moves only the requested rows; a compact store is
pulled only into compact targets, and takes only compact pushes.
"""
from __future__ import annotations

import torch

from .ndarray import NDArray
from .ndarray.sparse import (CompactRowSparseNDArray, RowSparseNDArray,
                             compact_merge)

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
            merged = _merge(v) if isinstance(v, (list, tuple)) else v
            stored = self._store[k]
            if self._updater is not None:
                self._updater(_key_int(k), merged, stored)
            elif isinstance(stored, CompactRowSparseNDArray):
                stored._assign_value(merged)    # compact pushes only
            elif isinstance(merged, CompactRowSparseNDArray):
                raise TypeError(
                    "push of a compact row_sparse gradient into a "
                    "non-compact store would install the (nnz_max, row) "
                    "buffer as the full value; initialise the key with a "
                    "CompactRowSparseNDArray or set an updater")
            else:
                with torch.no_grad():
                    stored._data.copy_(merged.todense()._data
                                       if merged.stype != "default"
                                       else merged._data)
                if isinstance(stored, RowSparseNDArray):
                    stored._aux = None

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy the value(s) of key(s) into ``out`` (an array or a list of
        arrays a key). A compact store goes only into compact targets,
        and a compact target takes only a compact store."""
        if out is None:
            raise ValueError("pull needs out=")
        for k, o in zip(*_key_value(key, out)):
            src = self._store[k]
            for arr in (o if isinstance(o, (list, tuple)) else [o]):
                if isinstance(src, CompactRowSparseNDArray):
                    if not isinstance(arr, CompactRowSparseNDArray):
                        raise TypeError(
                            "pull of a compact row_sparse table into a "
                            "non-compact target would materialize the "
                            "full shape; use row_sparse_pull")
                    arr._assign_value(src)
                    continue
                if isinstance(arr, CompactRowSparseNDArray):
                    raise TypeError(
                        "pull of a dense store into a compact row_sparse "
                        "target: convert the store with "
                        "compact_row_sparse_array or pull row-wise with "
                        "row_sparse_pull")
                with torch.no_grad():
                    arr._data.copy_(src._data, non_blocking=arr._data.is_cuda)
                if isinstance(arr, RowSparseNDArray):
                    arr._aux = None

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` of key(s) (MXNet's
        ``PullRowSparse``): a row-sparse target holds exactly those rows,
        a compact one receives them compactly, a target of the gathered
        rows' shape takes them, and a dense target of the full shape
        takes the whole value (``Module.prepare`` pulls into the
        executors' full arrays: no row may be zeroed there)."""
        from .ndarray.sparse import _index_tensor, row_sparse_array
        if out is None or row_ids is None:
            raise ValueError("row_sparse_pull needs out= and row_ids=")
        keys, outs = _key_value(key, out)
        if not isinstance(row_ids, (list, tuple)):
            row_ids = [row_ids] * len(keys)
        for k, o, rid in zip(keys, outs, row_ids):
            src = self._store[k]
            ids = torch.unique(_index_tensor(rid, src._data.device))
            targets = o if isinstance(o, (list, tuple)) else [o]
            if isinstance(src, CompactRowSparseNDArray):
                if not all(isinstance(a, CompactRowSparseNDArray)
                           for a in targets):
                    raise TypeError(
                        "row_sparse_pull from a compact store requires "
                        "compact targets (a dense target would "
                        "materialize the full table)")
                # only resident rows come back (absent rows are zero in
                # the logical table and stay absent in the pull)
                pulled = src.retain(ids)
                ids, gathered = pulled.indices._data, pulled.data._data
            else:
                gathered = src._data.detach().index_select(0, ids)
            for arr in targets:
                if isinstance(arr, CompactRowSparseNDArray):
                    arr._set_rows(ids, gathered)
                elif isinstance(arr, RowSparseNDArray):
                    rsp = row_sparse_array((gathered, ids), shape=src.shape,
                                           ctx=arr.context)
                    arr._set_data(rsp._data)
                    arr._aux = rsp._aux
                elif tuple(arr.shape) == tuple(gathered.shape):
                    with torch.no_grad():
                        arr._data.copy_(gathered)
                else:
                    with torch.no_grad():
                        arr._data.copy_(src._data)

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


def _merge(values):
    """One array for a pushed list: the sum, with the union of the stored
    rows for row-sparse arrays (compactly for compact ones)."""
    if len(values) == 1:
        return values[0]
    if all(isinstance(a, CompactRowSparseNDArray) for a in values):
        return compact_merge(list(values))
    dev = values[0]._data.device
    total = sum(a._data.to(dev) for a in values)
    if all(isinstance(a, RowSparseNDArray) for a in values):
        rows = torch.unique(torch.cat([a.indices._data.to(dev)
                                       for a in values]))
        return RowSparseNDArray(total, {"indices": rows,
                                        "data": total.index_select(0, rows)},
                                values[0].context)
    return NDArray(total, values[0].context)


def create(name="local"):
    """A store of type ``name``; the port has the single-process ones."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in ("local", "device", "nccl", "local_allreduce_cpu",
                "local_allreduce_device"):
        return KVStore(name)
    raise ValueError("KVStore type %r is not ported (the local types are)"
                     % name)
