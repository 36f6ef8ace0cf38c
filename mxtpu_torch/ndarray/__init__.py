"""Imperative arrays of the PyTorch port.

Counterpart of ``mxtpu/ndarray/__init__.py``, reduced to what the slices
use: :class:`NDArray`, a wrapper over a ``torch.Tensor`` that knows its
:class:`~mxtpu_torch.context.Context`, with indexing, arithmetic through
the registry's ops, copies between contexts and the autograd hooks
(``attach_grad``, ``grad``, ``backward``, ``detach``); the creation
functions (:func:`array`, :func:`zeros`, :func:`ones`, :func:`full`,
:func:`empty`, :func:`arange`, :func:`concatenate`) and :func:`waitall`;
every registered op as ``nd.<OpName>``; and the ``.npz`` container of
``.params`` files (:func:`save` / :func:`load`), dense entries only,
which ``mxtpu.ndarray.load`` reads and writes too.

The dtype rules are ``mxtpu``'s: float32 by default, lists as float32,
numpy float64/int64 narrowed to float32/int32 by :func:`array`, a Python
number beside an array taking the array's dtype where it fits. Values
behave as ``mxtpu``'s immutable arrays do: indexing returns a copy
outside ``record()``, and item assignment, in-place arithmetic and
``copyto`` rebind the array to a new tensor, so no other array sees the
change. (Only an rtc kernel writes into an output array in place.)
"""
from __future__ import annotations

import numpy as _np
import torch

from .. import autograd as _ag
from .. import engine as _engine
from ..base import canonical_dtype, numpy_dtype
from ..context import Context, cpu, current_context
from ..ops.registry import ContribNamespace, get_op

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "waitall", "save", "load", "contrib"]


class NDArray:
    """A tensor on a context (``mxtpu.ndarray.NDArray``'s surface)."""

    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data, ctx=None):
        if not isinstance(data, torch.Tensor):
            raise TypeError("NDArray wraps a torch.Tensor, got %s"
                            % type(data).__name__)
        self._data = data
        if ctx is None:
            ctx = cpu() if data.device.type == "cpu" \
                else Context("gpu", data.device.index or 0)
        self._ctx = ctx
        self._grad = None
        self._grad_req = "write"

    @property
    def data(self):
        """The underlying ``torch.Tensor``."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def dtype(self):
        """The ``torch.dtype`` of the array."""
        return self._data.dtype

    @property
    def context(self):
        return self._ctx

    @property
    def T(self):
        """The array with its axes reversed (``transpose``)."""
        return _invoke(get_op("transpose"), [self], {})

    ctx = context

    @property
    def grad(self):
        """The gradient array attached by :meth:`attach_grad` (or None)."""
        return self._grad

    def _set_data(self, t):
        """Rebind to tensor ``t``; a marked variable stays a graph leaf."""
        self._data = _ag._leaf(t) if self._grad is not None else t

    # -- host transfer and waiting -----------------------------------------
    def wait_to_read(self):
        """Block until the array's value is computed."""
        if self._data.device.type == "cuda":
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def asnumpy(self):
        """A numpy copy of the value (never a view: optimizers update
        arrays in place)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            raise TypeError("numpy has no bfloat16")
        return t.cpu().numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self._data.detach().cpu(), "x".join(map(str, self.shape)),
            self._ctx)

    # -- copies ------------------------------------------------------------
    def astype(self, dtype, copy=True):
        return NDArray(self._data.to(canonical_dtype(dtype)), self._ctx)

    def copy(self):
        return NDArray(self._data.clone(), self._ctx)

    def copyto(self, other):
        """Copy into NDArray ``other`` (which takes this array's value,
        dtype included, as in ``mxtpu``) or to a new array on Context
        ``other``."""
        if isinstance(other, NDArray):
            other._set_data(self._data.detach().to(other._data.device,
                                                   copy=True))
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True), other)
        raise TypeError("copyto expects NDArray or Context")

    def as_in_context(self, context):
        if context == self._ctx:
            return self
        return self.copyto(context)

    def detach(self):
        return NDArray(self._data.detach(), self._ctx)

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make this array a variable with a zero gradient array."""
        g = NDArray(torch.zeros_like(self._data.detach()), self._ctx)
        _ag.mark_variables([self], [g], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _ag.backward([self], [out_grad] if out_grad is not None else None,
                     retain_graph=retain_graph, train_mode=train_mode)

    # -- indexing ----------------------------------------------------------
    def _key(self, key):
        def idx(k):
            return k._data.to(device=self._data.device, dtype=torch.int64) \
                if isinstance(k, NDArray) else k
        return tuple(idx(k) for k in key) if isinstance(key, tuple) \
            else idx(key)

    def __getitem__(self, key):
        with torch.set_grad_enabled(_ag.is_recording()):
            t = self._data[self._key(key)]
        if not _ag.is_recording() and t._is_view():
            t = t.clone()
        return NDArray(t, self._ctx)

    def __setitem__(self, key, value):
        v = value._data if isinstance(value, NDArray) else value
        if isinstance(v, (_np.ndarray, list)):
            v = torch.as_tensor(_np.asarray(v))
        t = self._data.detach().clone()
        t[self._key(key)] = v.to(t.device) if isinstance(v, torch.Tensor) \
            else v
        self._set_data(t)

    # -- arithmetic --------------------------------------------------------
    def _binary(self, opname, other, reverse=False):
        pair = [other, self] if reverse else [self, other]
        return _invoke(get_op(opname), pair, {})

    def __add__(self, o): return self._binary("broadcast_add", o)
    def __radd__(self, o): return self._binary("broadcast_add", o, True)
    def __sub__(self, o): return self._binary("broadcast_sub", o)
    def __rsub__(self, o): return self._binary("broadcast_sub", o, True)
    def __mul__(self, o): return self._binary("broadcast_mul", o)
    def __rmul__(self, o): return self._binary("broadcast_mul", o, True)
    def __truediv__(self, o): return self._binary("broadcast_div", o)
    def __rtruediv__(self, o): return self._binary("broadcast_div", o, True)
    def __mod__(self, o): return self._binary("broadcast_mod", o)
    def __rmod__(self, o): return self._binary("broadcast_mod", o, True)
    def __pow__(self, o): return self._binary("broadcast_power", o)
    def __rpow__(self, o): return self._binary("broadcast_power", o, True)
    def __gt__(self, o): return self._binary("broadcast_greater", o)
    def __ge__(self, o): return self._binary("broadcast_greater_equal", o)
    def __lt__(self, o): return self._binary("broadcast_lesser", o)
    def __le__(self, o): return self._binary("broadcast_lesser_equal", o)

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary("broadcast_equal", o)

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary("broadcast_not_equal", o)

    def __hash__(self):
        return id(self)

    def __neg__(self):
        return _invoke(get_op("negative"), [self], {})

    def __abs__(self):
        return _invoke(get_op("abs"), [self], {})

    def _inplace(self, opname, o):
        # recording: return the op's output, so the graph stays whole
        # (Python rebinds x += y to it); otherwise rebind this array
        out = self._binary(opname, o)
        if _ag.is_recording():
            return out
        self._set_data(out._data)
        return self

    def __iadd__(self, o): return self._inplace("broadcast_add", o)
    def __isub__(self, o): return self._inplace("broadcast_sub", o)
    def __imul__(self, o): return self._inplace("broadcast_mul", o)
    def __itruediv__(self, o): return self._inplace("broadcast_div", o)

    # -- op-backed methods -------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return _invoke(get_op("reshape"), [self], {"shape": tuple(shape)})

    def __getattr__(self, name):
        # x.sum(axis=1), x.exp(), ...: ops taking the array first
        op = get_op(name)
        if op is None or name.startswith("_"):
            raise AttributeError(name)

        def method(*args, **kwargs):
            return _invoke(op, (self,) + args, kwargs)
        method.__name__ = name
        return method


def _device_of(args):
    for a in args:
        if isinstance(a, NDArray):
            return a.context
    return None


def _invoke(op, args, kwargs):
    """Run op ``op`` eagerly on NDArray (or scalar) ``args``; wrap tensor
    outputs on the inputs' context. Under ``record()`` the op runs with
    torch's grad mode on and its floating inputs join the graph;
    otherwise it records nothing. Under ``NaiveEngine`` it waits for its
    result.

    As in ``mxtpu``'s ``invoke``: the outputs that ``op.aux_update``
    names are written back into their input arrays (BatchNorm's moving
    statistics), detached and in place, so no graph hangs on them and a
    captured graph that reads those tensors sees the new values; and the
    call returns the op's ``user_outputs`` leading outputs (BatchNorm's
    one, or three under ``output_mean_var``), one array alone and not in
    a list."""
    recording = _ag.is_recording()
    ctx = _device_of(args) or _device_of(kwargs.values()) \
        or current_context()

    def tensor(pos, v):
        if not isinstance(v, NDArray):
            return v
        if recording and op.differentiable and pos not in op.aux_update \
                and not v._data.requires_grad:
            v._data = _ag._leaf(v._data)
        return v._data
    tensors = [tensor(i, a) for i, a in enumerate(args)]
    kw = {k: tensor(None, v) for k, v in kwargs.items()}
    if op.needs_train_flag:
        kw.setdefault("_training", _ag.is_training())
    if op.needs_device:
        kw["_device"] = ctx.torch_device()
    with torch.set_grad_enabled(recording):
        out = op.fn(*tensors, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    for in_pos, out_pos in op.aux_update.items():
        if in_pos < len(args) and isinstance(args[in_pos], NDArray) \
                and outs[out_pos] is not tensors[in_pos]:
            with torch.no_grad():
                args[in_pos]._data.copy_(outs[out_pos].detach())
    if _engine.is_synchronous() and outs[-1].device.type == "cuda":
        torch.cuda.synchronize(outs[-1].device)
    shown = op.user_outputs(kw) if callable(op.user_outputs) \
        else op.user_outputs
    if shown is not None:
        outs = outs[:shown]
    if len(outs) == 1:
        return NDArray(outs[0], ctx)
    return [NDArray(o, ctx) for o in outs]


def array(source, ctx=None, dtype=None):
    """An NDArray of ``source`` (numpy, list, tensor or NDArray) on
    ``ctx`` (default: the current context, ``gpu(0)``). The dtype rule is
    ``mxtpu``'s: lists default to float32, a numpy array keeps its dtype
    except float64 -> float32 and int64 -> int32."""
    ctx = ctx or current_context()
    if isinstance(source, NDArray):
        source = source.data.detach()
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


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None):
    ctx = ctx or current_context()
    return NDArray(torch.zeros(_shape(shape), dtype=canonical_dtype(dtype),
                               device=ctx.torch_device()), ctx)


def ones(shape, ctx=None, dtype=None):
    ctx = ctx or current_context()
    return NDArray(torch.ones(_shape(shape), dtype=canonical_dtype(dtype),
                              device=ctx.torch_device()), ctx)


def full(shape, val, ctx=None, dtype=None):
    ctx = ctx or current_context()
    return NDArray(torch.full(_shape(shape), val,
                              dtype=canonical_dtype(dtype),
                              device=ctx.torch_device()), ctx)


def empty(shape, ctx=None, dtype=None):
    """An array whose values are not set (``mxtpu`` fills zeros; here the
    memory is only allocated)."""
    ctx = ctx or current_context()
    return NDArray(torch.empty(_shape(shape), dtype=canonical_dtype(dtype),
                               device=ctx.torch_device()), ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    ctx = ctx or current_context()
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=canonical_dtype(dtype),
                       device=ctx.torch_device())
    if repeat > 1:
        out = torch.repeat_interleave(out, int(repeat))
    return NDArray(out, ctx)


def concatenate(arrays, axis=0, always_copy=True):
    return _invoke(get_op("concat"), list(arrays), {"dim": axis})


def waitall():
    """Block until all work on the cards has finished."""
    _engine.waitall()


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


def _op_function(op, name):
    """``nd.<name>``: op ``op`` run eagerly on its arguments."""
    def fn(*args, **kwargs):
        return _invoke(op, args, kwargs)
    fn.__name__ = name
    fn.__doc__ = op.doc
    return fn


contrib = ContribNamespace(_op_function)


def __getattr__(name):
    op = get_op(name)
    if op is None:
        raise AttributeError("module 'mxtpu_torch.ndarray' has no "
                             "attribute %r" % name)
    return _op_function(op, name)
