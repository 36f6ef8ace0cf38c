"""Imperative arrays of the PyTorch port.

Counterpart of ``mxtpu/ndarray/__init__.py``, reduced to what the
serving slice needs: :class:`NDArray`, a thin wrapper over a
``torch.Tensor`` that knows its :class:`~mxtpu_torch.context.Context`;
:func:`array`; every registered op as ``nd.<OpName>``; and the ``.npz``
container of ``.params`` files (:func:`save` / :func:`load`), dense
entries only, which ``mxtpu.ndarray.load`` reads and writes too.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import canonical_dtype, numpy_dtype
from ..context import Context, cpu, current_context
from ..ops.registry import get_op

__all__ = ["NDArray", "array", "save", "load"]


class NDArray:
    """A tensor on a context (``mxtpu.ndarray.NDArray``'s data surface)."""

    __slots__ = ("_data", "_ctx")

    def __init__(self, data, ctx=None):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray wraps a torch.Tensor, got %s"
                            % type(data).__name__)
        self._data = data
        if ctx is None:
            ctx = cpu() if data.device.type == "cpu" \
                else Context("gpu", data.device.index or 0)
        self._ctx = ctx

    @property
    def data(self):
        """The underlying ``torch.Tensor``."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The ``torch.dtype`` of the array."""
        return self._data.dtype

    @property
    def context(self):
        return self._ctx

    def asnumpy(self):
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16")
        return t.cpu().numpy()

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self._data.detach().cpu(), "x".join(map(str, self.shape)),
            self._ctx)


def array(source, ctx=None, dtype=None):
    """An NDArray of ``source`` (numpy, list, tensor or NDArray) on
    ``ctx`` (default: the current context, ``gpu(0)``). The dtype rule is
    ``mxtpu``'s: lists default to float32, a numpy array keeps its dtype
    except float64 -> float32 and int64 -> int32."""
    ctx = ctx or current_context()
    if isinstance(source, NDArray):
        source = source.data
    if isinstance(source, torch.Tensor):
        t = source.to(canonical_dtype(dtype)) if dtype is not None \
            else source
    else:
        if dtype is not None:
            a = _np.asarray(source, numpy_dtype(canonical_dtype(dtype)))
        elif not isinstance(source, _np.ndarray):
            a = _np.asarray(source, _np.float32)
        else:
            a = source
            narrow = {_np.dtype(_np.float64): _np.float32,
                      _np.dtype(_np.int64): _np.int32}.get(a.dtype)
            if narrow is not None:
                a = a.astype(narrow)
        t = torch.from_numpy(_np.array(a, order="C"))  # a copy, as in mxtpu
    return NDArray(t.to(ctx.torch_device()), ctx)


def _call_op(op, args, kwargs):
    """Run op ``op`` on NDArray inputs, eagerly; wrap tensor outputs."""
    ctx = None
    tensors = []
    for a in args:
        if isinstance(a, NDArray):
            ctx = ctx or a.context
            tensors.append(a.data)
        else:
            tensors.append(a)
    kw = {}
    for k, v in kwargs.items():
        if isinstance(v, NDArray):
            ctx = ctx or v.context
            v = v.data
        kw[k] = v
    ctx = ctx or current_context()
    if op.needs_train_flag:
        kw.setdefault("_training", False)
    if op.needs_device:
        kw["_device"] = ctx.torch_device()
    out = op.fn(*tensors, **kw)
    if isinstance(out, tuple):
        return [NDArray(o, ctx) for o in out]
    return NDArray(out, ctx)


def save(fname, data):
    """Save NDArrays (dict, list or one) to the ``.npz`` container that
    ``mxtpu.ndarray.save`` writes, at exactly ``fname``."""
    if isinstance(data, NDArray):
        data = {"__arr_0": data}
    elif isinstance(data, (list, tuple)):
        data = {"__arr_%d" % i: v for i, v in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("save expects NDArray, dict, or list")
    payload = {}
    for k, v in data.items():
        if "::" in k:
            raise ValueError("'::' is reserved in save keys: %r" % (k,))
        payload[k] = v.asnumpy() if isinstance(v, NDArray) \
            else _np.asarray(v)
    with open(fname, "wb") as f:
        _np.savez(f, **payload)


def load(fname, ctx=None):
    """Load a ``.params``/``.npz`` file written by either package; dense
    entries only. Arrays go to ``ctx`` (default: the current context)."""
    with _np.load(fname, allow_pickle=False) as z:
        if any("::" in k for k in z.files):
            raise ValueError("%s holds sparse entries, which the port does "
                             "not load yet" % fname)
        out = {k: array(z[k], ctx=ctx) for k in z.files}
    if out and all(k.startswith("__arr_") for k in out):
        return [out[k] for k in sorted(out, key=lambda k: int(k[6:]))]
    return out


def __getattr__(name):
    op = get_op(name)
    if op is None:
        raise AttributeError("module 'mxtpu_torch.ndarray' has no "
                             "attribute %r" % name)

    def fn(*args, **kwargs):
        return _call_op(op, args, kwargs)
    fn.__name__ = name
    fn.__doc__ = op.doc
    return fn
