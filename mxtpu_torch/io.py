"""Data iterators of the PyTorch port.

Counterpart of the in-memory half of ``mxtpu/io.py``: the
DataDesc / DataBatch / DataIter protocol and NDArrayIter with shuffle,
``last_batch_handle`` (pad / discard / roll_over), pad counts and the
``state_dict`` resume position. Batches come up as NDArrays on the host
(``cpu()``); the executor group copies them to its context, and
:func:`stage_batch` moves an upcoming batch there ahead of its step
without making the host wait for the card.

``shuffle=True`` draws from numpy's global RNG exactly as ``mxtpu``
does (one ``np.random.shuffle`` of the row index at construction), so
under one ``np.random.seed`` both packages see the same batches.
"""
from __future__ import annotations

from collections import namedtuple

import numpy as _np

from . import ndarray as nd
from .context import cpu
from .ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "stage_batch"]


def stage_batch(batch, ctx):
    """Move a :class:`DataBatch`'s arrays to ``ctx`` ahead of the step
    that consumes them. The host-to-card copies are queued without a
    wait (from pageable memory CUDA stages the rows before returning),
    so the upcoming batch's transfer does not block on the step still
    running on the card."""
    device = ctx.torch_device()

    def stage(arrs):
        for i, a in enumerate(arrs or []):
            if isinstance(a, NDArray) and a.data.device != device:
                arrs[i] = NDArray(a.data.to(device, non_blocking=True), ctx)

    stage(batch.data)
    stage(batch.label)
    return batch


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Data description: name, shape, dtype and layout."""

    def __new__(cls, name, shape, dtype=_np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype, ret.layout = dtype, layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self + (self.dtype, self.layout))

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """One mini-batch: lists of data and label NDArrays, and how many of
    its trailing rows are padding."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        for part, what in ((data, "Data"), (label, "Label")):
            if part is not None and not isinstance(part, (list, tuple)):
                raise TypeError("%s must be a list of NDArrays" % what)
        self.data, self.label = data, label
        self.pad, self.index, self.bucket_key = pad, index, bucket_key
        self.provide_data, self.provide_label = provide_data, provide_label

    def __str__(self):
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, [d.shape for d in self.data],
            [l.shape for l in self.label] if self.label else None)


class DataIter:
    """Base data iterator. :meth:`state_dict` returns the resumable
    position (``{}`` for a stateless iterator)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def state_dict(self):
        return {}

    def load_state_dict(self, state):
        del state

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


def _init_data(data, allow_empty, default_name):
    """Normalise input data to a sorted list of (name, numpy array)."""
    if data is None and not allow_empty:
        raise ValueError("data must not be None")
    if data is None:
        data = []
    if isinstance(data, (_np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise ValueError("data must not be empty")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    out = {k: v.asnumpy() if isinstance(v, NDArray) else _np.asarray(v)
           for k, v in data.items()}
    return list(sorted(out.items()))


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays in batches of ``batch_size``.

    ``last_batch_handle``: ``pad`` fills the last batch from the start
    (its ``pad`` says how many rows), ``discard`` drops the rows past
    the last whole batch, ``roll_over`` serves the wrapped batch and
    starts the next epoch where it ended."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = _np.arange(self.data[0][1].shape[0])
        if shuffle:
            _np.random.shuffle(self.idx)
            self.data = [(k, v[self.idx]) for k, v in self.data]
            self.label = [(k, v[self.idx]) for k, v in self.label]
        # the row permutation applied to the arrays, which state_dict
        # carries so a fresh iterator replays the saved epoch's order
        self._shuffle_perm = self.idx.copy() if shuffle else None
        if last_batch_handle == "discard":
            n = self.data[0][1].shape[0]
            self.idx = self.idx[:n - n % batch_size]
        self.data_list = [x[1] for x in self.data] + \
            [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.idx.shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data size.")
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.label]

    def state_dict(self):
        return {"cursor": int(self.cursor),
                "batch_size": int(self.batch_size),
                "order": None if self._shuffle_perm is None
                else [int(i) for i in self._shuffle_perm]}

    def load_state_dict(self, state):
        """Seek to a saved position; a shuffled run's rows are first put
        back into the saved epoch order."""
        bs = int(state.get("batch_size", self.batch_size))
        if bs != self.batch_size:
            raise ValueError(
                "cannot restore a batch_size=%d NDArrayIter state into "
                "a batch_size=%d iterator" % (bs, self.batch_size))
        order = state.get("order")
        if order is not None:
            n = self.data[0][1].shape[0]
            perm = _np.asarray(order, dtype=_np.int64)
            if perm.shape[0] != n:
                raise ValueError(
                    "saved epoch order covers %d rows but this iterator "
                    "holds %d" % (perm.shape[0], n))
            cur = self._shuffle_perm if self._shuffle_perm is not None \
                else _np.arange(n)
            inv = _np.empty(n, dtype=_np.int64)
            inv[cur] = _np.arange(n)
            sel = inv[perm]
            self.data = [(k, v[sel]) for k, v in self.data]
            self.label = [(k, v[sel]) for k, v in self.label]
            self.data_list = [x[1] for x in self.data] + \
                [x[1] for x in self.label]
            self._shuffle_perm = perm
            self.idx = perm[:self.idx.shape[0]]
        self.cursor = int(state["cursor"])

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        if self.cursor >= self.num_data:
            raise RuntimeError("DataIter needs reset.")
        if self.cursor + self.batch_size <= self.num_data:
            return [nd.array(x[1][self.cursor:self.cursor + self.batch_size],
                             ctx=cpu()) for x in data_source]
        pad = self.batch_size - self.num_data + self.cursor
        return [nd.array(_np.concatenate((x[1][self.cursor:], x[1][:pad]),
                                         axis=0), ctx=cpu())
                for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0
