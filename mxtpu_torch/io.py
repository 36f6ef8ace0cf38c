"""Data iterators of the PyTorch port.

Counterpart of ``mxtpu/io.py``: the DataDesc / DataBatch / DataIter
protocol; NDArrayIter with shuffle, ``last_batch_handle`` (pad / discard
/ roll_over), pad counts and the ``state_dict`` resume position; the
combinators ResizeIter and PrefetchingIter (a background thread a
wrapped iterator, double-buffered); the file iterators MNISTIter (idx
and idx.gz files), CSVIter and LibSVMIter (dense batches); and
ImageRecordIter over :mod:`mxtpu_torch.image`. Batches come up as
NDArrays on the host (``cpu()``); the executor group copies them to its
context, and :func:`stage_batch` moves an upcoming batch there ahead of
its step without making the host wait for the card.

``shuffle=True`` draws from numpy's global RNG exactly as ``mxtpu``
does (one ``np.random.shuffle`` of the row index at construction), so
under one ``np.random.seed`` both packages see the same batches.
"""
from __future__ import annotations

import gzip
import logging
import struct
import threading
from collections import namedtuple

import numpy as _np
import torch

from . import ndarray as nd
from .context import cpu
from .ndarray import NDArray

__all__ = ["DataDesc", "DataBatch", "DataIter", "ResizeIter",
           "PrefetchingIter", "NDArrayIter", "CSVIter", "MNISTIter",
           "LibSVMIter", "ImageRecordIter", "stage_batch"]

_log = logging.getLogger(__name__)


def stage_batch(batch, ctx):
    """Move a :class:`DataBatch`'s arrays to ``ctx`` ahead of the step
    that consumes them. The host-to-card copies are queued without a
    wait (from pageable memory CUDA stages the rows before returning),
    so the upcoming batch's transfer does not block on the step still
    running on the card."""
    device = ctx.torch_device()

    def stage(arrs):
        for i, a in enumerate(arrs or []):
            if not isinstance(a, NDArray) or a._data.device == device:
                continue
            arrs[i] = NDArray(a._data.to(device, non_blocking=True), ctx) \
                if a.stype == "default" else a.as_in_context(ctx)

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

    @staticmethod
    def get_list(shapes, types):
        """DataDescs of ``(name, shape)`` pairs, each with its dtype from
        the ``(name, dtype)`` pairs ``types`` (a name missing there raises
        KeyError), or the default dtype when ``types`` is None."""
        if types is None:
            return [DataDesc(n, s) for n, s in shapes]
        dtype_of = dict(types)
        return [DataDesc(n, s, dtype_of[n]) for n, s in shapes]


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


class _CurrentBatchIter(DataIter):
    """Combinator base: serves next/getdata/... off self.current_batch,
    which subclasses refresh in iter_next()."""

    current_batch = None

    def next(self):
        if not self.iter_next():
            raise StopIteration
        return self.current_batch

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class ResizeIter(_CurrentBatchIter):
    """Resize an iterator to ``size`` batches an epoch, wrapping the
    inner one around when its epoch is shorter."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(batch_size=data_iter.batch_size)
        self.data_iter, self.size = data_iter, size
        self.reset_internal, self.cur = reset_internal, 0
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def state_dict(self):
        # cur alone is not resumable when the wrapped epoch is shorter
        # than `size`: the inner position is part of the cursor
        return {"cur": int(self.cur),
                "inner": self.data_iter.state_dict()}

    def load_state_dict(self, state):
        self.data_iter.load_state_dict(state.get("inner") or {})
        self.cur = int(state["cur"])

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:   # wrap around: one epoch of the wrapped
            self.data_iter.reset()   # iterator is shorter than `size`
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True


# prefetch liveness tick: every wait on a double-buffer event re-checks
# the peer (worker: shutdown flag, consumer: the worker thread's life) at
# this period instead of blocking forever on a peer that died
_PREFETCH_TICK = 1.0


def _wait_all(events, threads=None):
    """Wait for every event; with ``threads`` given, a worker that died
    without delivering (thread gone, event never set) raises instead of
    parking the consumer forever."""
    for i, e in enumerate(events):
        while not e.wait(timeout=_PREFETCH_TICK):
            t = threads[i] if threads is not None and i < len(threads) \
                else None
            if t is not None and not t.is_alive():
                raise RuntimeError(
                    "prefetch worker %d died without delivering its "
                    "batch" % i)


def _clear_all(events):
    for e in events:
        e.clear()


def _set_all(events):
    for e in events:
        e.set()


class PrefetchingIter(_CurrentBatchIter):
    """Thread-prefetching combinator: one worker thread a wrapped
    iterator fetches batch i+1 while the consumer holds batch i (a
    data_taken / data_ready event pair a slot). ``state_dict`` is the
    position after the last batch delivered, never where the threads ran
    ahead to; an error in a worker is raised by the consumer's next
    ``next()``."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        self.iters = iters if isinstance(iters, list) else [iters]
        self.n_iter = len(self.iters)
        if not self.n_iter:
            raise ValueError("PrefetchingIter needs an iterator")
        self.rename_data, self.rename_label = rename_data, rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in self.iters]
        self.data_taken = [threading.Event() for _ in self.iters]
        _set_all(self.data_taken)
        self.started = True
        self.next_batch = [None] * self.n_iter
        # each worker snapshots its iterator's position right after
        # fetching a batch; the consumer adopts that snapshot when the
        # batch is delivered
        self._delivered = 0
        self._next_state = [None] * self.n_iter
        self._inner_states = None
        self._errors = [None] * self.n_iter
        self.prefetch_threads = [
            threading.Thread(target=self._worker, args=(i,), daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def _worker(self, i):
        """Pull batch i+1 while the consumer holds batch i."""
        while True:
            while not self.data_taken[i].wait(timeout=_PREFETCH_TICK):
                if not self.started:
                    return
            if not self.started:
                return
            try:
                self.next_batch[i] = self.iters[i].next()
                # an iterator without the resume contract still
                # prefetches; restore then resets and fast-forwards
                sd = getattr(self.iters[i], "state_dict", None)
                self._next_state[i] = sd() if sd is not None else None
            except StopIteration:
                self.next_batch[i] = None
                self._next_state[i] = None
            except BaseException as exc:  # noqa: B036 — handed on: the
                # consumer re-raises it from iter_next, never stranded
                self.next_batch[i] = None
                self._next_state[i] = None
                self._errors[i] = exc
            self.data_taken[i].clear()
            self.data_ready[i].set()

    def __del__(self):
        try:
            self.started = False
            _set_all(self.data_taken)
            for thread in self.prefetch_threads:
                thread.join(timeout=1.0)
        except Exception as e:
            # teardown-order races during interpreter exit are expected
            _log.debug("PrefetchingIter teardown failed: %s", e)

    def _renamed_descs(self, renames, attr):
        sources = [getattr(i, attr) for i in self.iters]
        if renames is None:
            return [d for descs in sources for d in descs]
        return [DataDesc(r[d.name], d.shape, d.dtype)
                if isinstance(d, DataDesc) else DataDesc(*d)
                for r, descs in zip(renames, sources) for d in descs]

    @property
    def provide_data(self):
        return self._renamed_descs(self.rename_data, "provide_data")

    @property
    def provide_label(self):
        return self._renamed_descs(self.rename_label, "provide_label")

    def reset(self):
        _wait_all(self.data_ready, self.prefetch_threads)
        for i in self.iters:
            i.reset()
        self._delivered = 0
        self._inner_states = None
        self._errors = [None] * self.n_iter
        _clear_all(self.data_ready)
        _set_all(self.data_taken)

    def state_dict(self):
        """Position after the last delivered batch."""
        return {"delivered": int(self._delivered),
                "iters": None if self._inner_states is None
                else list(self._inner_states)}

    def load_state_dict(self, state):
        """Park the workers, rewind the wrapped iterators to the delivered
        position (exactly when they keep a state, by reset and
        fast-forward otherwise) and prefetch on from there."""
        _wait_all(self.data_ready, self.prefetch_threads)
        inner = state.get("iters")
        delivered = int(state.get("delivered", 0))
        for k, it in enumerate(self.iters):
            st = inner[k] if inner is not None else None
            if st:
                it.load_state_dict(st)
            else:
                it.reset()
                for _ in range(delivered):
                    it.next()
        self._delivered = delivered
        self._inner_states = list(inner) if inner is not None else None
        self.next_batch = [None] * self.n_iter
        self._next_state = [None] * self.n_iter
        self._errors = [None] * self.n_iter
        _clear_all(self.data_ready)
        _set_all(self.data_taken)

    def iter_next(self):
        _wait_all(self.data_ready, self.prefetch_threads)
        errors = [e for e in self._errors if e is not None]
        if errors:
            self._errors = [None] * self.n_iter
            raise errors[0]
        exhausted = [b is None for b in self.next_batch]
        if any(exhausted):
            if not all(exhausted):
                raise RuntimeError(
                    "Number of entry mismatches between iterators")
            return False
        self._delivered += 1
        self._inner_states = list(self._next_state)
        lead = self.next_batch[0]
        if any(b.pad != lead.pad for b in self.next_batch):
            raise RuntimeError("Number of entry mismatches between "
                               "iterators")
        self.current_batch = DataBatch(
            [a for b in self.next_batch for a in b.data],
            [a for b in self.next_batch for a in b.label],
            lead.pad, lead.index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        _clear_all(self.data_ready)
        _set_all(self.data_taken)
        return True


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

    def hard_reset(self):
        """Back to the first batch, ignoring ``roll_over``'s carry."""
        self.cursor = -self.batch_size

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


class _InnerIter(DataIter):
    """An iterator that serves the batches of an inner NDArrayIter."""

    _inner = None

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, state):
        self._inner.load_state_dict(state)

    def next(self):
        return self._inner.next()


class CSVIter(_InnerIter):
    """Rows of a CSV file as batches of ``data_shape``, labels from
    ``label_csv`` (zeros of ``label_shape`` without one); ``round_batch``
    pads the last batch from the start, else drops it."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32",
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        data = _np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = _np.loadtxt(label_csv, delimiter=",", dtype=dtype,
                                ndmin=2).reshape((-1,) + tuple(label_shape))
        else:
            label = _np.zeros((data.shape[0],) + tuple(label_shape),
                              dtype=dtype)
        self._inner = NDArrayIter(
            data={data_name: data}, label={label_name: label},
            batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard")


def read_idx(path, magic):
    """The array of an idx (or idx.gz) file: uint8 of the shape its
    header gives; ``magic`` is the header's first word (2051 for images
    of rows x cols, 2049 for labels)."""
    opener = gzip.open if path.endswith(".gz") else open
    dims = 3 if magic == 2051 else 1
    with opener(path, "rb") as f:
        head = struct.unpack(">%dI" % (dims + 1), f.read(4 * (dims + 1)))
        if head[0] != magic:
            raise ValueError("%s is not an MNIST %s file (magic %d)"
                             % (path, "image" if dims == 3 else "label",
                                head[0]))
        return _np.frombuffer(f.read(), dtype=_np.uint8).reshape(head[1:])


class MNISTIter(_InnerIter):
    """Batches of the MNIST idx (or idx.gz) files ``image`` and ``label``:
    pixels over 255 as float32, (B, 1, 28, 28) or (B, 784) with ``flat``;
    every ``num_parts``-th image from ``part_index``; shuffled once by
    ``RandomState(seed)``; the rows past the last whole batch dropped.

    The label is named ``softmax_label``, as MXNet's C++ iterator and the
    CSV and LibSVM iterators name it. ``mxtpu``'s MNISTIter names it
    ``label``, so a Module bound to ``softmax_label`` trains there against
    zeros; that one difference is deliberate."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128, shuffle=True,
                 flat=False, silent=False, seed=0, part_index=0, num_parts=1,
                 **kwargs):
        super().__init__(batch_size)
        images = read_idx(image, 2051).astype(_np.float32) / 255.0
        labels = read_idx(label, 2049).astype(_np.float32)
        if num_parts > 1:
            images = images[part_index::num_parts]
            labels = labels[part_index::num_parts]
        if shuffle:
            perm = _np.random.RandomState(seed).permutation(images.shape[0])
            images, labels = images[perm], labels[perm]
        images = images.reshape((images.shape[0], -1) if flat else
                                (images.shape[0], 1) + images.shape[1:])
        self._inner = NDArrayIter({"data": images},
                                  {"softmax_label": labels},
                                  batch_size=batch_size,
                                  last_batch_handle="discard")


def _uint_tokens(buf, starts, ends):
    """The tokens ``buf[starts[i]:ends[i]]`` as int64 if every one is a
    plain non-negative integer (its digits summed by place, one numpy pass
    a place), else None."""
    lengths = ends - starts
    if lengths.size == 0:
        return _np.zeros(0, _np.int64)
    if lengths.min() < 1 or lengths.max() > 18:
        return None
    out = _np.zeros(lengths.size, _np.int64)
    for k in range(int(lengths.max())):
        live = lengths > k
        digit = buf[_np.maximum(ends - 1 - k, 0)].astype(_np.int64) - 48
        digit[~live] = 0
        if digit.min() < 0 or digit.max() > 9:
            return None
        out += digit * 10 ** k
    return out


class LibSVMIter(DataIter):
    """Batches of a LibSVM text file (``label idx:val idx:val ...`` a
    line). Rows of a 1-d ``data_shape`` come as CSR arrays (MXNet's and
    ``mxtpu``'s batch type), built from the parsed rows: each batch's
    ``indptr`` / ``indices`` / ``data`` are gathered from the file's
    compressed rows, so no dense batch is ever made (at Avazu's 1,000,001
    features a dense batch of 8,192 rows would be 32.8 GB). A row's
    columns are sorted, a repeated column keeps its last value and zeros
    are not stored: the CSR of the dense rows ``mxtpu`` fills. A
    multi-dimensional ``data_shape`` gives dense rows, as in ``mxtpu``.
    Labels come from the lines, or from the rows of ``label_libsvm``
    (densified to ``label_shape``'s width, else to its largest index +
    1), which must have as many rows. With ``round_batch`` the last batch
    wraps to the first rows (its ``pad`` counts them); without it the
    last partial batch is dropped."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=None, batch_size=1, round_batch=True,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        self._data_name, self._label_name = data_name, label_name
        self._data_shape = tuple(data_shape) \
            if hasattr(data_shape, "__len__") else (int(data_shape),)
        self._width = int(_np.prod(self._data_shape))
        self._ptr, self._cols, self._vals, labels = self._parse(data_libsvm)
        if self._cols.size and self._cols.max() >= self._width:
            raise IndexError("column %d of %r is past the width %d"
                             % (self._cols.max(), data_libsvm, self._width))
        n = self._ptr.size - 1
        if label_libsvm is not None:
            lptr, lcols, lvals, _ = self._parse(label_libsvm)
            if lptr.size - 1 != n:
                raise ValueError(
                    "label file %r has %d rows but data file %r has %d"
                    % (label_libsvm, lptr.size - 1, data_libsvm, n))
            w = int(label_shape[-1]) if label_shape else \
                1 + (int(lcols.max()) if lcols.size else 0)
            labels = _np.zeros((n, w), _np.float32)
            labels[_np.repeat(_np.arange(n), _np.diff(lptr)), lcols] = lvals
        self._labels = _np.asarray(labels, _np.float32)
        self._round_batch = round_batch
        self._cursor = 0

    @staticmethod
    def _parse(path):
        """``(indptr, indices, values, labels)`` of a LibSVM file: its rows
        compressed (columns sorted, a repeated column's last value, float32
        zeros dropped). The ``idx:val`` pairs are found in the bytes by
        numpy in a few passes, integers read from their digits (summed by
        place); a value that is not a plain integer goes through numpy's
        float parser."""
        with open(path, "rb") as f:
            raw = f.read()
        labels, counts = [], []
        for ln in raw.splitlines():
            head = ln.split(None, 1)
            if head:
                labels.append(float(head[0]))
                counts.append(ln.count(b":"))
        counts = _np.asarray(counts, _np.int64)
        buf = _np.frombuffer(raw, _np.uint8)
        colon = _np.flatnonzero(buf == ord(":"))
        space = _np.flatnonzero(buf <= 32)      # whitespace, line ends
        space = _np.concatenate([[-1], space, [buf.size]])
        after = _np.searchsorted(space, colon)
        cols = _uint_tokens(buf, space[after - 1] + 1, colon)
        vals = _uint_tokens(buf, colon + 1, space[after])
        if cols is None:
            raise ValueError("%r holds a column that is not a non-negative "
                             "integer" % (path,))
        if vals is None:
            vals = _np.array([raw[a:b] for a, b in zip(colon + 1,
                                                       space[after])],
                             dtype=_np.float64)
        vals = vals.astype(_np.float32)
        rows = _np.repeat(_np.arange(counts.size), counts)
        if not ((rows[1:] != rows[:-1]) | (cols[1:] > cols[:-1])).all():
            # a row's columns out of order or repeated: sort them (stable,
            # so a repeated column's last value is last)
            order = _np.argsort(rows * (int(cols.max()) + 1) + cols,
                                kind="stable")
            rows, cols, vals = rows[order], cols[order], vals[order]
        last = _np.ones(cols.size, bool)
        last[:-1] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
        keep = last & (vals != 0)
        ptr = _np.zeros(counts.size + 1, _np.int64)
        ptr[1:] = _np.cumsum(_np.bincount(rows[keep], minlength=counts.size))
        return ptr, cols[keep], vals[keep], _np.asarray(labels)

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self._data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self._label_name, (self.batch_size,)
                         + tuple(self._labels.shape[1:]))]

    def reset(self):
        self._cursor = 0

    def next(self):
        n = self._ptr.size - 1
        if self._cursor >= n or (not self._round_batch
                                 and n - self._cursor < self.batch_size):
            raise StopIteration
        idx = _np.arange(self._cursor, self._cursor + self.batch_size) % n
        self._cursor += self.batch_size
        lo = self._ptr[idx]
        counts = self._ptr[idx + 1] - lo
        indptr = _np.zeros(idx.size + 1, _np.int64)
        indptr[1:] = _np.cumsum(counts)
        pos = _np.repeat(lo - indptr[:-1], counts) + _np.arange(indptr[-1])
        cols, vals = self._cols[pos], self._vals[pos]
        if len(self._data_shape) == 1:
            from .ndarray import sparse
            data = sparse.csr_matrix(
                (torch.from_numpy(vals), torch.from_numpy(cols),
                 torch.from_numpy(indptr)),
                shape=(self.batch_size, self._width), ctx=cpu())
        else:
            dense = _np.zeros((self.batch_size, self._width), _np.float32)
            dense[_np.repeat(_np.arange(idx.size), counts), cols] = vals
            data = nd.array(dense.reshape((self.batch_size,)
                                          + self._data_shape), ctx=cpu())
        return DataBatch(data=[data],
                         label=[nd.array(self._labels[idx], ctx=cpu())],
                         pad=max(0, self._cursor - n))


def ImageRecordIter(**kwargs):
    """RecordIO image pipeline (MXNet's ImageRecordIter), implemented in
    :mod:`mxtpu_torch.image` over :mod:`mxtpu_torch.recordio`."""
    from .image import ImageRecordIterImpl
    return ImageRecordIterImpl(**kwargs)
