"""MXNet's binary ``.params`` format in the PyTorch port.

Counterpart of ``mxtpu/legacy_params.py``: reads and writes MXNet's
binary NDArray container (dmlc::Stream layout, ``src/ndarray/
ndarray.cc:1510-1740``): a ``0x112`` list magic, per-array V2 blobs
(storage type, shapes as nnvm Tuples, context, dtype, raw data, sparse
aux blocks), then names. ``nd.load`` and ``nd.load_from_bytes`` sniff
the magic, so a checkpoint that MXNet itself wrote loads through
``mx.model.load_checkpoint`` and ``Module.load``.

Shape dims are nnvm ``Tuple<index_t>`` entries: uint32 in the MXNet
snapshot, int64 in later releases; the reader tries uint32 first and
parses again as int64 when the layout is inconsistent. Everything here
is numpy: the loader turns the entries into the port's arrays.
"""
from __future__ import annotations

import struct

import numpy as _np

LIST_MAGIC = 0x112
V1_MAGIC = 0xF993FAC8
V2_MAGIC = 0xF993FAC9

# mshadow's type codes 0..6 (include/mxnet/base.h TypeFlag), the only
# ones MXNet's format knows
_DTYPES = [_np.dtype(n) for n in ("float32", "float64", "float16", "uint8",
                                  "int32", "int8", "int64")]

__all__ = ["is_legacy_params", "load_legacy_params", "save_legacy_params"]


class _Reader:
    def __init__(self, buf, dims_dtype):
        self.buf = buf
        self.pos = 0
        self.dims_dtype = dims_dtype

    def raw(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("truncated MXNet .params stream")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def u32(self):
        return struct.unpack("<I", self.raw(4))[0]

    def i32(self):
        return struct.unpack("<i", self.raw(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.raw(8))[0]

    def tshape(self):
        ndim = self.u32()
        if ndim > 32:
            raise ValueError("implausible ndim %d" % ndim)
        itemsize = _np.dtype(self.dims_dtype).itemsize
        dims = _np.frombuffer(self.raw(ndim * itemsize), self.dims_dtype)
        if (dims < 0).any() or (dims > 2 ** 40).any():
            raise ValueError("implausible shape %s" % (dims,))
        return tuple(int(d) for d in dims)


def is_legacy_params(header_bytes):
    """Whether a file starting with these >=8 bytes is MXNet's binary
    container (``nd.load`` sniffs with this)."""
    return len(header_bytes) >= 8 and \
        struct.unpack("<Q", header_bytes[:8])[0] == LIST_MAGIC


def _read_one(r):
    """One NDArray blob -> (numpy array | sparse triple dict)."""
    magic = r.u32()
    if magic == V2_MAGIC:
        stype = r.i32()
        nad = {0: 0, 1: 1, 2: 2}.get(stype)
        if nad is None:
            raise ValueError("unknown storage type %d" % stype)
        sshape = r.tshape() if nad else None
        shape = r.tshape()
        if not shape:
            return _np.zeros((0,), _np.float32)
        r.i32()  # ctx dev_type: the loader places the arrays
        r.i32()  # ctx dev_id
        type_flag = r.i32()
        if not 0 <= type_flag < len(_DTYPES):
            raise ValueError("bad dtype code %d" % type_flag)
        aux = []
        for _ in range(nad):
            aux_type = r.i32()
            aux_shape = r.tshape()
            aux.append((aux_type, aux_shape))
        dt = _np.dtype(_DTYPES[type_flag])
        data_shape = sshape if nad else shape
        n = int(_np.prod(data_shape)) if data_shape else 0
        data = _np.frombuffer(r.raw(n * dt.itemsize), dt).reshape(
            data_shape)
        if not nad:
            return data
        aux_arrays = []
        for aux_type, aux_shape in aux:
            if not 0 <= aux_type < len(_DTYPES):
                raise ValueError("bad aux dtype code %d" % aux_type)
            adt = _np.dtype(_DTYPES[aux_type])
            an = int(_np.prod(aux_shape)) if aux_shape else 0
            aux_arrays.append(_np.frombuffer(
                r.raw(an * adt.itemsize), adt).reshape(aux_shape))
        return {"stype": {1: "row_sparse", 2: "csr"}[stype],
                "shape": shape, "data": data, "aux": aux_arrays}
    # V1 / raw-ndim legacy dense blob
    if magic == V1_MAGIC:
        shape = r.tshape()
    else:
        ndim = magic
        if ndim > 32:
            raise ValueError("bad NDArray magic 0x%x" % magic)
        dims = _np.frombuffer(r.raw(ndim * 4), _np.uint32)
        shape = tuple(int(d) for d in dims)
    if not shape:
        return _np.zeros((0,), _np.float32)
    r.i32()
    r.i32()
    type_flag = r.i32()
    if not 0 <= type_flag < len(_DTYPES):
        raise ValueError("bad dtype code %d" % type_flag)
    dt = _np.dtype(_DTYPES[type_flag])
    n = int(_np.prod(shape))
    return _np.frombuffer(r.raw(n * dt.itemsize), dt).reshape(shape)


def _parse(buf, dims_dtype):
    r = _Reader(buf, dims_dtype)
    if r.u64() != LIST_MAGIC:
        raise ValueError("not a MXNet .params file (bad magic)")
    r.u64()  # reserved
    arrays = [_read_one(r) for _ in range(r.u64())]
    names = []
    for _ in range(r.u64()):
        names.append(r.raw(r.u64()).decode("utf-8"))
    if r.pos != len(buf):
        raise ValueError("%d trailing bytes" % (len(buf) - r.pos))
    if names and len(names) != len(arrays):
        raise ValueError("name/array count mismatch")
    return arrays, names


def load_legacy_params(path_or_bytes):
    """Parse an MXNet-format file (a path or its bytes) -> (list of
    arrays, names).

    Array entries are numpy arrays, or sparse triples (dict with stype/
    shape/data/aux) that the caller converts to sparse NDArrays."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    try:
        return _parse(buf, _np.uint32)
    except ValueError:
        # newer writers use int64 shape dims
        return _parse(buf, _np.int64)


def save_legacy_params(path, data, dims_dtype=_np.uint32):
    """Write arrays (a dict name -> array, or a list; NDArrays dense or
    sparse, or numpy) in MXNet's binary container at ``path``, or return
    the bytes when ``path`` is None."""
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = []
        arrays = list(data)
    def tshape(shape):
        return struct.pack("<I", len(shape)) + \
            _np.asarray(shape, dims_dtype).tobytes()

    def dtype_code(dt):
        dt = _np.dtype(dt)
        for i, d in enumerate(_DTYPES):
            if _np.dtype(d) == dt:
                return i
        raise TypeError(
            "the MXNet .params format cannot represent dtype %s; "
            "cast the array first (e.g. .astype('float32') for "
            "bfloat16 weights)" % dt)

    out = [struct.pack("<QQ", LIST_MAGIC, 0), struct.pack("<Q",
                                                          len(arrays))]
    for a in arrays:
        stype = getattr(a, "stype", "default")
        if stype == "row_sparse":
            # V2 sparse blob: stype, storage shape, logical shape, ctx,
            # value dtype, aux (indices) dtype+shape, values, indices
            values = _np.ascontiguousarray(a.data.asnumpy())
            idx = _np.ascontiguousarray(
                a.indices.asnumpy().astype(_np.int64))
            out += [struct.pack("<I", V2_MAGIC), struct.pack("<i", 1),
                    tshape(values.shape), tshape(a.shape),
                    struct.pack("<ii", 1, 0),
                    struct.pack("<i", dtype_code(values.dtype)),
                    struct.pack("<i", 6), tshape(idx.shape),
                    values.tobytes(), idx.tobytes()]
            continue
        if stype == "csr":
            values = _np.ascontiguousarray(a.data.asnumpy())
            indptr = _np.ascontiguousarray(
                a.indptr.asnumpy().astype(_np.int64))
            idx = _np.ascontiguousarray(
                a.indices.asnumpy().astype(_np.int64))
            out += [struct.pack("<I", V2_MAGIC), struct.pack("<i", 2),
                    tshape(values.shape), tshape(a.shape),
                    struct.pack("<ii", 1, 0),
                    struct.pack("<i", dtype_code(values.dtype)),
                    struct.pack("<i", 6), tshape(indptr.shape),
                    struct.pack("<i", 6), tshape(idx.shape),
                    values.tobytes(), indptr.tobytes(), idx.tobytes()]
            continue
        host = _np.asarray(a.asnumpy() if hasattr(a, "asnumpy") else a)
        if host.ndim == 0:
            # an empty shape means "uninitialized NDArray" to MXNet's
            # reader (shape.is_none() early return, ndarray.cc:1515-), so a
            # scalar's payload cannot be represented; writing ctx/dtype/data
            # anyway would desync every later array in the stream
            raise TypeError(
                "cannot save a zero-dim array in the MXNet .params "
                "format (empty shape means uninitialized there); reshape "
                "to (1,) first")
        host = _np.ascontiguousarray(host)
        out += [struct.pack("<I", V2_MAGIC),
                struct.pack("<i", 0),           # dense storage
                tshape(host.shape),
                struct.pack("<ii", 1, 0),       # cpu(0)
                struct.pack("<i", dtype_code(host.dtype)),
                host.tobytes()]
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        enc = n.encode("utf-8")
        out.append(struct.pack("<Q", len(enc)))
        out.append(enc)
    blob = b"".join(out)
    if path is None:
        return blob
    with open(path, "wb") as f:
        f.write(blob)
    return path
