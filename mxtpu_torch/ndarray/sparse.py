"""Sparse arrays of the PyTorch port: CSR and row-sparse storage.

Counterpart of ``mxtpu/ndarray/sparse.py`` (MXNet's
``python/mxnet/ndarray/sparse.py``): :class:`CSRNDArray`,
:class:`RowSparseNDArray`, :class:`CompactRowSparseNDArray`, their
constructors, ``cast_storage``, ``retain``, ``square_sum``, the
stype-aware arithmetic and ``dot``. The values are ``mxtpu``'s; the
layouts are the card's:

* **CSR is compressed.** A :class:`CSRNDArray`'s tensor is a
  ``torch.sparse_csr`` tensor whose ``crow_indices`` / ``col_indices`` /
  ``values`` are the array's ``indptr`` / ``indices`` / ``data``, the
  authoritative storage. A dense value is made only where a dense op asks
  for one (``ops.registry.storage_fallback``, MXNet's storage fallback),
  and ``dot`` with a CSR left operand computes from the compressed
  tensors (``ops.linalg_ops.csr_dot``). ``mxtpu`` keeps a dense value
  beside the metadata; the answers are the same, but a batch of Avazu's
  1,000,001 features would be 32.8 GB dense at 8,192 rows.
* **Row-sparse is dense-backed**, as in ``mxtpu``: the tensor holds the
  whole value and ``indices`` / ``data`` name the stored rows. Given at
  construction they are kept as they are (explicit zero rows stay
  stored); after an assignment they are the rows whose value is nonzero,
  found on the array's device when first asked for.
* :class:`CompactRowSparseNDArray` holds ``nnz_max`` row slots and their
  sorted ids (the padding tail holds ``shape[0]``), never the full shape:
  the gradient buffer of a ``SparseEmbedding`` over a large vocabulary.
"""
from __future__ import annotations

import warnings

import numpy as _np
import torch

from ..base import MXNetError, canonical_dtype
from ..context import Context, current_context
from ..ops.linalg_ops import csr_dot
from . import NDArray, array as _dense_array

__all__ = ["BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray",
           "CompactRowSparseNDArray", "csr_matrix", "row_sparse_array",
           "compact_row_sparse_array", "compact_merge", "cast_storage",
           "retain", "square_sum", "zeros", "empty", "array", "add",
           "subtract", "multiply", "divide", "dot"]

_IDX = torch.int64


def _csr_tensor(indptr, indices, values, shape):
    """A ``torch.sparse_csr`` tensor over the given tensors (no checks:
    the constructors build valid ones)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta" notice
        return torch.sparse_csr_tensor(
            indptr.to(_IDX), indices.to(_IDX), values, size=tuple(shape),
            check_invariants=False)


def _compress(dense):
    """A dense 2-d tensor's CSR tensor (its nonzeros stored)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta" notice
        return dense.detach().to_sparse_csr()


def _index_tensor(x, device):
    """Row or column ids (NDArray of either package, tensor, numpy,
    list) as an int64 tensor on ``device``."""
    if isinstance(x, NDArray):
        t = x._data
    elif isinstance(x, torch.Tensor):
        t = x
    else:
        t = torch.as_tensor(_np.asarray(x.asnumpy() if hasattr(x, "asnumpy")
                                        else x).astype(_np.int64))
    return t.detach().to(device=device, dtype=_IDX).reshape(-1)


def _as_nd(x, dtype=None, ctx=None):
    """``x`` as a dense NDArray of the port on ``ctx``, by ``nd.array``'s
    dtype rule (float64 to float32) unless ``dtype`` is given."""
    if isinstance(x, NDArray):
        out = x.astype(dtype) if dtype is not None else x
        return out.as_in_context(ctx) if ctx is not None else out
    if isinstance(x, torch.Tensor):
        return _dense_array(x, ctx=ctx, dtype=dtype)
    if hasattr(x, "asnumpy"):
        x = x.asnumpy()
    return _dense_array(_np.asarray(x), ctx=ctx, dtype=dtype)


def _dense_value(x):
    """The dense tensor of an array (a CSR array's made from it), or the
    value itself."""
    if isinstance(x, CSRNDArray):
        return x._data.to_dense()
    if isinstance(x, CompactRowSparseNDArray):
        return x.todense()._data
    return x._data if isinstance(x, NDArray) else x


class BaseSparseNDArray(NDArray):
    """What the CSR and row-sparse arrays share."""

    __slots__ = ("_aux",)

    _stype = None

    def __init__(self, data, ctx=None):
        super().__init__(data, ctx)
        self._aux = None

    @property
    def stype(self):
        return self._stype

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__,
                                  "x".join(map(str, self.shape)), self._ctx)

    def tostype(self, stype):
        return cast_storage(self, stype)

    def todense(self):
        return NDArray(_dense_value(self), self._ctx)

    def asscipy(self):
        raise NotImplementedError("scipy export not supported")

    @property
    def size(self):
        n = 1
        for s in self.shape:
            n *= s
        return n


class CSRNDArray(BaseSparseNDArray):
    """A compressed sparse row matrix (MXNet's ``CSRNDArray``; storage
    ``kCSRStorage``): ``data``, ``indices`` and ``indptr`` on the card, no
    dense value."""

    _stype = "csr"

    @property
    def data(self):
        """Stored values, shape (nnz,)."""
        return NDArray(self._data.values(), self._ctx)

    @property
    def indices(self):
        """Column of each stored value, shape (nnz,)."""
        return NDArray(self._data.col_indices(), self._ctx)

    @property
    def indptr(self):
        """Row pointers, shape (rows + 1,)."""
        return NDArray(self._data.crow_indices(), self._ctx)

    @property
    def nnz(self):
        return int(self._data.values().numel())

    @property
    def dtype(self):
        return NDArray(self._data.values()).dtype

    def asnumpy(self):
        """The dense value, made on the host."""
        return self._data.detach().cpu().to_dense().numpy()

    def _with(self, values=None, device=None, ctx=None):
        t = self._data
        device = device if device is not None else t.device
        values = t.values() if values is None else values
        return CSRNDArray(_csr_tensor(t.crow_indices().to(device),
                                      t.col_indices().to(device),
                                      values.to(device), t.shape),
                          ctx or self._ctx)

    def copy(self):
        return self._with(self._data.values().clone())

    def detach(self):
        return CSRNDArray(self._data.detach(), self._ctx)

    def astype(self, dtype, copy=True):
        return self._with(self._data.values().to(canonical_dtype(dtype)))

    def as_in_context(self, context):
        if context == self._ctx:
            return self
        return self._with(device=context.torch_device(), ctx=context)

    def copyto(self, other):
        if isinstance(other, Context):
            return self._with(device=other.torch_device(), ctx=other) \
                if other != self._ctx else self.copy()
        if isinstance(other, CSRNDArray):
            other._data = self._with(device=other._data.device)._data
            return other
        if isinstance(other, BaseSparseNDArray):
            raise TypeError("copyto between different sparse stypes")
        return NDArray.copyto(self.todense(), other)

    def _set_data(self, t):
        """Take value ``t``: a CSR tensor as it is, a dense one
        compressed (its nonzeros stored)."""
        if t.layout != torch.sparse_csr:
            t = _compress(t)
        self._data = t
        self._entry = None

    def __getitem__(self, key):
        if isinstance(key, slice):
            if key.step is not None and key.step != 1:
                raise ValueError("CSR slicing supports step=1 only")
            start, stop, _ = key.indices(self.shape[0])
            stop = max(stop, start)
            crow = self._data.crow_indices()
            lo, hi = int(crow[start]), int(crow[stop])
            return CSRNDArray(_csr_tensor(
                crow[start:stop + 1] - lo, self._data.col_indices()[lo:hi],
                self._data.values()[lo:hi], (stop - start, self.shape[1])),
                self._ctx)
        return self.todense()[key]


class RowSparseNDArray(BaseSparseNDArray):
    """A row-sparse array (MXNet's ``RowSparseNDArray``; storage
    ``kRowSparseStorage``), dense-backed: the storage of sparse gradients
    and weights of embedding-style tables."""

    _stype = "row_sparse"

    def __init__(self, dense, aux=None, ctx=None):
        super().__init__(dense, ctx)
        self._aux = aux     # {"indices": int64 rows, "data": the rows}

    def _ensure_aux(self):
        """The stored rows: those given, else the nonzero rows of the
        value (found on its device)."""
        if self._aux is None:
            self._aux = self._recompute_aux()
        return self._aux

    def _recompute_aux(self):
        d = self._data.detach()
        rows = torch.nonzero(d.reshape(d.shape[0], -1).ne(0).any(1)) \
            .reshape(-1) if d.dim() else d.new_zeros((0,), dtype=_IDX)
        return {"indices": rows, "data": d.index_select(0, rows)}

    @property
    def data(self):
        """Stored rows, shape (nnz, *shape[1:])."""
        return NDArray(self._ensure_aux()["data"], self._ctx)

    @property
    def indices(self):
        """Stored row ids, shape (nnz,)."""
        return NDArray(self._ensure_aux()["indices"], self._ctx)

    @property
    def nnz(self):
        return int(self._ensure_aux()["indices"].numel())

    def _set_data(self, t):
        super()._set_data(t)
        self._aux = None

    def copy(self):
        aux = {k: v.clone() for k, v in self._ensure_aux().items()}
        return RowSparseNDArray(self._data.detach().clone(), aux, self._ctx)

    def astype(self, dtype, copy=True):
        d = canonical_dtype(dtype)
        aux = self._ensure_aux()
        return RowSparseNDArray(self._data.detach().to(d),
                                {"indices": aux["indices"],
                                 "data": aux["data"].to(d)}, self._ctx)

    def as_in_context(self, context):
        if context == self._ctx:
            return self
        dev = context.torch_device()
        return RowSparseNDArray(
            self._data.detach().to(dev),
            {k: v.to(dev) for k, v in self._ensure_aux().items()}, context)

    def copyto(self, other):
        if isinstance(other, Context):
            return self.as_in_context(other) if other != self._ctx \
                else self.copy()
        if isinstance(other, BaseSparseNDArray) and \
                type(other) is not type(self):
            raise TypeError("copyto between different sparse stypes")
        dev = other._data.device
        other._set_data(self._data.detach().to(dev, copy=True))
        if isinstance(other, RowSparseNDArray):
            other._aux = {k: v.to(dev, copy=True)
                          for k, v in self._ensure_aux().items()}
        return other

    def retain(self, indices):
        return retain(self, indices)


class CompactRowSparseNDArray(RowSparseNDArray):
    """A row-sparse array in ``nnz_max`` row slots: memory in proportion
    to ``nnz_max``, whatever ``shape[0]`` is, so a logical table larger
    than the card's memory works.

    * ``_data``: the ``(nnz_max, *shape[1:])`` slots;
    * ``_aux['indices']``: their ``(nnz_max,)`` int32 row ids, ascending,
      the padding tail holding ``shape[0]``;
    * ``_nnz``: the number of valid slots (a host int).

    It serves ``asnumpy`` (dense on the host), copies, ``retain``, the
    kvstore's compact merge and ``row_sparse_pull``, the lazy optimizer
    updates and ``SparseEmbedding``'s backward. A dense value on the
    device is refused: ``tostype('default')`` makes one deliberately."""

    __slots__ = ("_nnz", "_lshape")

    def __init__(self, rows, indices, nnz, shape, ctx=None):
        NDArray.__init__(self, rows, ctx)
        self._aux = {"indices": NDArray(indices, self._ctx)}
        self._nnz = int(nnz)
        self._lshape = tuple(shape)

    @classmethod
    def _empty(cls, nnz_max, shape, dtype, ctx):
        dev = ctx.torch_device()
        return cls(torch.zeros((int(nnz_max),) + tuple(shape[1:]),
                               dtype=dtype, device=dev),
                   torch.full((int(nnz_max),), shape[0], dtype=torch.int32,
                              device=dev), 0, shape, ctx)

    @property
    def _idx(self):
        return self._aux["indices"]._data

    @property
    def shape(self):
        return self._lshape

    @property
    def ndim(self):
        return len(self._lshape)

    @property
    def nnz_max(self):
        return int(self._data.shape[0])

    @property
    def nnz(self):
        return self._nnz

    @property
    def data(self):
        """Stored rows (valid slots only), shape (nnz, *shape[1:])."""
        return NDArray(self._data[:self._nnz], self._ctx)

    @property
    def indices(self):
        return NDArray(self._idx[:self._nnz].to(_IDX), self._ctx)

    def asnumpy(self):
        """The dense value on the HOST (the card may not hold it)."""
        out = _np.zeros(self._lshape,
                        dtype=NDArray(self._data[:0]).asnumpy().dtype)
        if self._nnz:
            out[self._idx[:self._nnz].cpu().numpy()] = \
                self._data[:self._nnz].detach().cpu().numpy()
        return out

    def todense(self):
        raise MXNetError(
            "CompactRowSparseNDArray holds only nnz_max rows on the "
            "device; materializing the full %s would defeat its purpose. "
            "Use asnumpy() for a host copy or tostype('default') if the "
            "dense table truly fits." % (self._lshape,))

    def tostype(self, stype):
        if stype == "row_sparse":
            return self.copy()
        if stype == "default":
            return _dense_array(self.asnumpy(), ctx=self._ctx)
        raise ValueError("cannot cast compact row_sparse to %r" % stype)

    def copy(self):
        return CompactRowSparseNDArray(self._data.detach().clone(),
                                       self._idx.clone(), self._nnz,
                                       self._lshape, self._ctx)

    def astype(self, dtype, copy=True):
        return CompactRowSparseNDArray(
            self._data.detach().to(canonical_dtype(dtype)),
            self._idx.clone(), self._nnz, self._lshape, self._ctx)

    def as_in_context(self, context):
        if context == self._ctx:
            return self
        dev = context.torch_device()
        return CompactRowSparseNDArray(self._data.detach().to(dev),
                                       self._idx.to(dev), self._nnz,
                                       self._lshape, context)

    def _assign_value(self, src):
        """Take compact ``src``'s value (the kvstore's pull and push)."""
        if not isinstance(src, CompactRowSparseNDArray):
            raise MXNetError(
                "cannot assign a dense value into a compact row_sparse "
                "array (that would materialize the full shape); build a "
                "compact array with compact_row_sparse_array(...)")
        if src._lshape != self._lshape:
            raise ValueError("shape mismatch in compact assignment")
        self._data = src._data.detach().to(self._data.device, copy=True)
        self._aux = {"indices": NDArray(src._idx.to(self._data.device,
                                                    copy=True), self._ctx)}
        self._nnz = src._nnz

    def _set_data(self, t):
        self._assign_value(t)   # raises: only a compact value fits

    def _set_rows(self, indices, rows):
        """Hold rows ``rows`` (a tensor of ``(n, *shape[1:])``) at ids
        ``indices`` (n distinct ids), sorted, in the existing slots; the
        rest zeroed. More rows than ``nnz_max`` raise."""
        ids = _index_tensor(indices, self._data.device)
        n = int(ids.numel())
        if n > self.nnz_max:
            raise ValueError("%d rows exceed this array's nnz_max=%d"
                             % (n, self.nnz_max))
        order = torch.argsort(ids, stable=True)
        with torch.no_grad():
            self._data[:n] = rows.detach().to(self._data.device,
                                              self._data.dtype)[order]
            self._data[n:].zero_()
            self._idx[:n] = ids[order].to(torch.int32)
            self._idx[n:] = self._lshape[0]
        self._nnz = n

    def _clear(self):
        """Zero the slots (a gradient's reset between steps)."""
        with torch.no_grad():
            self._data.zero_()
            self._idx.fill_(self._lshape[0])
        self._nnz = 0

    def retain(self, indices):
        keep = _index_tensor(indices, self._data.device)
        stored = self._idx[:self._nnz].to(_IDX)
        slots = torch.nonzero(torch.isin(stored, keep)).reshape(-1)
        out = CompactRowSparseNDArray._empty(self.nnz_max, self._lshape,
                                             self._data.dtype, self._ctx)
        if slots.numel():
            out._set_rows(stored[slots], self._data[slots])
        return out


def compact_row_sparse_array(arg1, shape=None, nnz_max=None, ctx=None,
                             dtype=None):
    """A :class:`CompactRowSparseNDArray` from ``(data, indices)``;
    ``nnz_max`` (default: the number of rows given) bounds its slots."""
    ctx = ctx or current_context()
    if isinstance(arg1, CompactRowSparseNDArray):
        return arg1.astype(dtype) if dtype else arg1.copy()
    if not (isinstance(arg1, tuple) and len(arg1) == 2):
        raise TypeError("compact_row_sparse_array expects (data, indices)")
    data, indices = arg1
    data = _as_nd(data, dtype, ctx)
    ids = _index_tensor(indices, data._data.device)
    if shape is None:
        rows = int(ids.max()) + 1 if ids.numel() else 0
        shape = (rows,) + tuple(data.shape[1:])
    nnz_max = int(nnz_max) if nnz_max is not None else max(1, ids.numel())
    out = CompactRowSparseNDArray._empty(nnz_max, shape, data._data.dtype,
                                         ctx)
    if ids.numel():
        out._set_rows(ids, data._data)
    return out


def compact_merge(arrs):
    """The union of compact row-sparse arrays, rows of one id summed
    (MXNet's ``ElementwiseSum`` on row_sparse), with no dense buffer."""
    first = arrs[0]
    total = sum(a._nnz for a in arrs)
    ids = torch.cat([a._idx[:a._nnz].to(_IDX) for a in arrs])
    uniq, inv = torch.unique(ids, return_inverse=True)
    bound = max(min(total, first._lshape[0]) or 1, int(uniq.numel()))
    out = CompactRowSparseNDArray._empty(bound, first._lshape,
                                         first._data.dtype, first._ctx)
    if uniq.numel():
        rows = torch.cat([a._data[:a._nnz] for a in arrs])
        summed = rows.new_zeros((uniq.numel(),) + tuple(rows.shape[1:]))
        summed.index_add_(0, inv, rows)
        out._set_rows(uniq, summed)
    return out


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A :class:`CSRNDArray` from ``(data, indices, indptr)`` and
    ``shape`` (MXNet's calling convention, kept as given: explicit zeros
    stay stored), a dense 2-d array (its nonzeros), or another CSR
    array."""
    ctx = ctx or current_context()
    if isinstance(arg1, CSRNDArray):
        return arg1.astype(dtype) if dtype else arg1.copy()
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        values = _as_nd(data, dtype, ctx)._data
        dev = values.device
        cols = _index_tensor(indices, dev)
        crow = _index_tensor(indptr, dev)
        if shape is None:
            shape = (int(crow.numel()) - 1,
                     int(cols.max()) + 1 if cols.numel() else 0)
        return CSRNDArray(_csr_tensor(crow, cols, values, shape), ctx)
    dense = _as_nd(arg1, dtype, ctx)
    if dense.ndim != 2:
        raise ValueError("csr_matrix requires 2-D input")
    if shape is not None and tuple(shape) != dense.shape:
        raise ValueError("shape mismatch")
    t = dense._data.detach()
    if isinstance(dense, BaseSparseNDArray):
        t = _dense_value(dense)
    return CSRNDArray(_compress(t), ctx)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A :class:`RowSparseNDArray` from ``(data, indices)`` (the rows
    kept as given), a dense array (its nonzero rows), or another
    row-sparse array."""
    ctx = ctx or current_context()
    if isinstance(arg1, RowSparseNDArray):
        return arg1.astype(dtype) if dtype else arg1.copy()
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data, indices = arg1
        rows = _as_nd(data, dtype, ctx)._data.detach()
        ids = _index_tensor(indices, rows.device)
        if shape is None:
            shape = (int(ids.max()) + 1 if ids.numel() else 0,) \
                + tuple(rows.shape[1:])
        dense = rows.new_zeros(tuple(shape))
        if ids.numel():
            dense[ids] = rows
        return RowSparseNDArray(dense, {"indices": ids, "data": rows}, ctx)
    src = _as_nd(arg1, dtype, ctx)
    if shape is not None and tuple(shape) != src.shape:
        raise ValueError("shape mismatch")
    return RowSparseNDArray(_dense_value(src).detach(), None, ctx)


def zeros(stype, shape, ctx=None, dtype=None, nnz_max=None):
    """Zeros of storage type ``stype`` (``mx.nd.sparse.zeros``); with
    ``nnz_max`` a row_sparse array is the compact one."""
    ctx = ctx or current_context()
    dt = canonical_dtype(dtype)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    if stype == "default":
        from . import zeros as dense_zeros
        return dense_zeros(shape, ctx=ctx, dtype=dt)
    dev = ctx.torch_device()
    if stype == "row_sparse" and nnz_max is not None:
        return CompactRowSparseNDArray._empty(nnz_max, shape, dt, ctx)
    if stype == "csr":
        return CSRNDArray(_csr_tensor(
            torch.zeros(shape[0] + 1, dtype=_IDX, device=dev),
            torch.zeros(0, dtype=_IDX, device=dev),
            torch.zeros(0, dtype=dt, device=dev), shape), ctx)
    if stype == "row_sparse":
        return RowSparseNDArray(
            torch.zeros(shape, dtype=dt, device=dev),
            {"indices": torch.zeros(0, dtype=_IDX, device=dev),
             "data": torch.zeros((0,) + shape[1:], dtype=dt, device=dev)},
            ctx)
    raise ValueError("unknown stype %r" % stype)


def empty(stype, shape, ctx=None, dtype=None):
    return zeros(stype, shape, ctx=ctx, dtype=dtype)


def array(source_array, ctx=None, dtype=None):
    """An array keeping the source's storage type (a scipy sparse matrix
    becomes CSR)."""
    if isinstance(source_array, CSRNDArray):
        return csr_matrix(source_array, ctx=ctx, dtype=dtype)
    if isinstance(source_array, RowSparseNDArray):
        return row_sparse_array(source_array, ctx=ctx, dtype=dtype)
    if hasattr(source_array, "tocsr") and hasattr(source_array, "toarray"):
        return csr_matrix(source_array.toarray(), ctx=ctx, dtype=dtype)
    return _dense_array(source_array, ctx=ctx, dtype=dtype)


# ---------------------------------------------------------------------------
# storage conversion (MXNet's cast_storage, sparse_retain, _square_sum)
# ---------------------------------------------------------------------------

def cast_storage(arr, stype):
    """``arr`` in storage ``default``, ``csr`` or ``row_sparse``."""
    if stype == arr.stype:
        return arr.copy() if isinstance(arr, BaseSparseNDArray) else arr
    dense = NDArray(_dense_value(arr).detach().clone(), arr._ctx)
    if stype == "default":
        return dense
    if stype == "csr":
        return csr_matrix(dense, ctx=arr._ctx)
    if stype == "row_sparse":
        return row_sparse_array(dense, ctx=arr._ctx)
    raise ValueError("unknown stype %r" % stype)


def retain(arr, indices):
    """Only the given rows of row-sparse ``arr`` that it stores."""
    if not isinstance(arr, RowSparseNDArray):
        raise TypeError("retain expects a RowSparseNDArray")
    if isinstance(arr, CompactRowSparseNDArray):
        return arr.retain(indices)
    dev = arr._data.device
    idx = torch.sort(_index_tensor(indices, dev)).values
    kept = idx[torch.isin(idx, arr._ensure_aux()["indices"])]
    rows = arr._data.detach().index_select(0, kept)
    dense = torch.zeros_like(arr._data.detach())
    dense[kept] = rows
    return RowSparseNDArray(dense, {"indices": kept, "data": rows}, arr._ctx)


def square_sum(arr, axis=None, keepdims=False):
    """The sum of squares (MXNet's ``_square_sum``, the row-sparse norm of
    lazy Adam/AdaGrad); rows a row-sparse array does not store are zero,
    and a CSR array's sum over everything reads only its values."""
    if isinstance(arr, CSRNDArray) and axis is None:
        v = arr._data.values()
    else:
        v = _dense_value(arr)
    if axis is None:
        out = v.square().sum()
        if keepdims:
            out = out.reshape((1,) * len(arr.shape))
    else:
        out = v.square().sum(dim=axis, keepdim=keepdims)
    return NDArray(out)


# ---------------------------------------------------------------------------
# arithmetic with storage types (MXNet's elemwise FComputeEx paths)
# ---------------------------------------------------------------------------

def _binary(a, b, fn):
    out = fn(_dense_value(a), _dense_value(b))
    ctx = next((x._ctx for x in (a, b) if isinstance(x, NDArray)), None)
    # rsp op rsp of one shape stays rsp (the union of the stored rows);
    # anything else is dense
    if isinstance(a, RowSparseNDArray) and isinstance(b, RowSparseNDArray) \
            and a.shape == b.shape:
        rows = torch.unique(torch.cat([a._ensure_aux()["indices"],
                                       b._ensure_aux()["indices"]]))
        return RowSparseNDArray(out, {"indices": rows,
                                      "data": out.index_select(0, rows)},
                                ctx)
    return NDArray(out, ctx)


def add(a, b):
    return _binary(a, b, torch.add)


def subtract(a, b):
    return _binary(a, b, torch.sub)


def multiply(a, b):
    return _binary(a, b, torch.mul)


def divide(a, b):
    return _binary(a, b, torch.div)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """The storage-aware dot (MXNet's ``dot-inl.h``): ``csr . dense`` is
    dense, ``csr.T . dense`` row-sparse (its stored rows the columns the
    CSR array references), both computed from the compressed tensors;
    anything else is the dense product."""
    rv = _dense_value(rhs)
    if not isinstance(rv, torch.Tensor):
        rv = torch.as_tensor(_np.asarray(rv))
    if transpose_b:
        rv = rv.transpose(-1, -2) if rv.dim() >= 2 else rv
    if isinstance(lhs, CSRNDArray):
        out = csr_dot(lhs._data, rv, transpose_a)
        if not transpose_a:
            return NDArray(out, lhs._ctx)
        cols = torch.unique(lhs._data.col_indices())
        return RowSparseNDArray(out, {"indices": cols, "data":
                                      out.detach().index_select(0, cols)},
                                lhs._ctx)
    lv = _dense_value(lhs)
    if transpose_a:
        lv = lv.transpose(-1, -2) if lv.dim() >= 2 else lv
    return NDArray(torch.matmul(lv, rv), lhs._ctx)
