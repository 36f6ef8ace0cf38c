"""Gluon datasets of the PyTorch port (``mxtpu/gluon/data/dataset.py``:
Dataset with ``transform`` / ``transform_first``, SimpleDataset,
ArrayDataset, RecordFileDataset)."""
from __future__ import annotations

import os

from ...ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    """Abstract dataset: ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)
        return self.transform(base_fn, lazy)


class SimpleDataset(Dataset):
    """A dataset over a list or array."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """The zip of equal-length arrays (a 1-d NDArray is read as numpy,
    as ``mxtpu`` does)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = _length(args[0])
        self._data = []
        for data in args:
            assert _length(data) == self._length, \
                "All arrays must have the same length; got %d vs %d" \
                % (_length(data), self._length)
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)

    def __len__(self):
        return self._length


def _length(data):
    return data.shape[0] if isinstance(data, NDArray) else len(data)


class RecordFileDataset(Dataset):
    """The records of a RecordIO file, in the order of its ``.idx`` file
    (beside it, same stem), as bytes. ``mxtpu``'s opens
    ``recordio.IndexedRecordIO``, which its ``recordio`` does not define,
    so it raises AttributeError; the port opens the indexed reader,
    ``MXIndexedRecordIO``."""

    def __init__(self, filename):
        from ... import recordio
        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
