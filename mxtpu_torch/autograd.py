"""Imperative autograd of the PyTorch port, built on torch autograd.

Counterpart of the user surface of ``mxtpu/autograd.py``: ``record`` /
``pause`` scopes, ``train_mode`` / ``predict_mode``, ``mark_variables``
(``NDArray.attach_grad``), ``backward`` with head gradients and
``retain_graph``, and ``grad``. Where ``mxtpu`` keeps its own tape and
asks ``jax.vjp`` for each entry, the port lets torch record the graph:
``record()`` turns torch's grad mode on and ``pause()`` turns it off, and
every floating input of an op run under ``record()`` joins the graph, as
every input lands on ``mxtpu``'s tape. ``backward`` writes the gradients
of the marked variables into their ``grad`` arrays by their ``grad_req``,
as ``mxtpu`` does: ``add`` accumulates, ``write`` and ``null`` overwrite.
A gradient may reach a variable as a sparse COO tensor
(``SparseEmbedding``'s backward); contributions within one backward are
summed by torch, and a compact row-sparse gradient array takes the rows
compactly (:func:`_write_grad`, ``mxtpu``'s compact gradient slot).

:class:`Function` is a user's differentiable function: its ``forward``
runs under :func:`pause`, and a ``torch.autograd.Function`` hands its
output gradients to the user's ``backward``. :func:`get_symbol` turns the
registered op calls that made an array under ``record()`` into a Symbol:
each such call is kept as a :class:`_Call` (op, params, and for each
input the call that made it, a weak reference to an array no recorded
call made, or a number) on the arrays it returned, and only while
recording, so nothing of it touches a path that does not record.
"""
from __future__ import annotations

import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function", "get_symbol"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()
_VARIABLES = weakref.WeakSet()     # NDArrays marked by mark_variables
_VAR_LOCK = threading.Lock()


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_recording(is_record):
    """Turn recording of NDArray ops on or off; returns the previous
    state. (Only the scopes switch torch's grad mode, and restore it.)"""
    prev = _STATE.recording
    _STATE.recording = bool(is_record)
    return prev


def set_training(train_mode):
    prev = _STATE.training
    _STATE.training = bool(train_mode)
    return prev


class _Scope:
    def __init__(self, recording=None, training=None):
        self._rec, self._train = recording, training
        self._prev = None

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training,
                      torch.is_grad_enabled())
        if self._rec is not None:
            _STATE.recording = self._rec
            torch.set_grad_enabled(self._rec)
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *a):
        _STATE.recording, _STATE.training, grad_mode = self._prev
        torch.set_grad_enabled(grad_mode)


def record(train_mode=True):
    """Scope in which ops are recorded for :func:`backward`."""
    return _Scope(recording=True, training=train_mode)


def pause(train_mode=False):
    """Scope in which nothing is recorded."""
    return _Scope(recording=False, training=train_mode)


def train_mode():
    return _Scope(training=True)


def predict_mode():
    return _Scope(training=False)


def _leaf(t):
    """``t`` as a graph leaf that requires grad (a new tensor object over
    the same storage; integer tensors stay as they are)."""
    if not (t.is_floating_point() or t.is_complex()) or \
            (t.requires_grad and t.grad_fn is None):
        return t
    return t.detach().requires_grad_(True)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient arrays to variables (``NDArray.attach_grad``)."""
    from .ndarray import NDArray
    if isinstance(variables, NDArray):
        variables, gradients = [variables], [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise ValueError("invalid grad_req %r" % (req,))
        v._grad = g
        v._grad_req = req
        v._data = _leaf(v._data)
        with _VAR_LOCK:
            _VARIABLES.add(v)


def _heads(heads, head_grads):
    from .ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is not None and not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    outs, gos = [], []
    for i, h in enumerate(heads):
        t = h.data
        if not t.requires_grad:
            continue          # not recorded: no gradient flows from it
        g = None if head_grads is None else head_grads[i]
        outs.append(t)
        gos.append(torch.ones_like(t) if g is None
                   else g.data.to(device=t.device, dtype=t.dtype))
    return outs, gos


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Backpropagate from ``heads`` (with ``head_grads``, default ones)
    and write each marked variable's gradient by its ``grad_req``."""
    outs, gos = _heads(heads, head_grads)
    with _VAR_LOCK:
        variables = [v for v in _VARIABLES
                     if v._grad is not None and v._data.requires_grad]
    if not outs or not variables:
        return
    grads = torch.autograd.grad(outs, [v._data for v in variables], gos,
                                retain_graph=retain_graph, allow_unused=True)
    for v, g in zip(variables, grads):
        if g is not None:
            _write_grad(v, g.detach())


def _write_grad(v, g):
    """Write gradient ``g`` (dense, or sparse COO) into variable ``v``'s
    gradient array by its ``grad_req``. A compact row-sparse array takes
    the gradient's rows (a sparse gradient's stored rows, a dense one's
    nonzero rows) in its slots, merged with those it holds under
    ``add``, its slots grown if the rows do not fit; a row-sparse array
    finds its stored rows anew from the value it takes."""
    from .ndarray import sparse as _sp
    tgt, add = v._grad, v._grad_req == "add"
    if isinstance(tgt, _sp.CompactRowSparseNDArray):
        if g.layout == torch.sparse_coo:
            g = g.coalesce()
            ids, rows = g.indices()[0], g.values()
        else:
            ids = torch.nonzero(g.reshape(g.shape[0], -1).ne(0).any(1)) \
                .reshape(-1)
            rows = g.index_select(0, ids)
        rows = rows.to(tgt._data.dtype)
        if add and tgt.nnz:
            merged = _sp.compact_merge([tgt, _sp.compact_row_sparse_array(
                (rows, ids), shape=tgt.shape, ctx=tgt.context)])
            ids, rows = merged.indices._data, merged.data._data
        if ids.numel() > tgt.nnz_max:
            tgt._assign_value(_sp.CompactRowSparseNDArray._empty(
                ids.numel(), tgt.shape, tgt._data.dtype, tgt.context))
        tgt._set_rows(ids, rows)
        return
    if g.layout != torch.strided:
        g = g.to_dense()
    g = g.to(tgt._data.dtype)
    tgt._data = tgt._data + g if add else g
    if isinstance(tgt, _sp.RowSparseNDArray):
        tgt._aux = None


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned as
    new arrays (zeros where no gradient flows); no ``grad`` is touched."""
    from .ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    outs, gos = _heads(heads, head_grads)
    live = [i for i, v in enumerate(variables) if v._data.requires_grad]
    got = [None] * len(variables)
    if outs and live:
        res = torch.autograd.grad(
            outs, [variables[i]._data for i in live], gos,
            retain_graph=bool(retain_graph) or create_graph,
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(live, res):
            got[i] = g
    out = [NDArray((g if create_graph else g.detach()).to_dense()
                   if g.layout == torch.sparse_coo else
                   (g if create_graph else g.detach()), v.context)
           if g is not None else NDArray(torch.zeros_like(v._data.detach()),
                                         v.context)
           for v, g in zip(variables, got)]
    return out[0] if single else out


# ---------------------------------------------------------------------------
# The record of op calls behind get_symbol
# ---------------------------------------------------------------------------

class _Call:
    """One registered op call made under ``record()``: the op, its static
    params, and its inputs in order, each ``("call", _Call, index)`` (an
    output of an earlier recorded call), ``("var", weakref)`` (an array
    no recorded call made) or ``("scalar", value)``. ``op`` is None for a
    :class:`Function`."""

    __slots__ = ("op", "params", "inputs")

    def __init__(self, op, params, inputs):
        self.op, self.params, self.inputs = op, params, inputs


def _input_ref(v):
    from .ndarray import NDArray
    if not isinstance(v, NDArray):
        return ("scalar", v)
    if v._entry is not None:
        return ("call",) + v._entry
    return ("var", weakref.ref(v))


def record_call(op, args, kwargs, outputs):
    """Keep op ``op``'s call on ``outputs`` (called by the NDArray op
    dispatch under ``record()``): its array inputs in the op's signature
    order (positional ones first, then those given by name), its other
    keyword arguments as params."""
    import inspect
    from .ndarray import NDArray
    named = {k: v for k, v in kwargs.items() if isinstance(v, NDArray)}
    inputs = list(args)
    if named:
        inputs += [named[n] for n in inspect.signature(op.fn).parameters
                   if n in named]
    params = {k: v for k, v in kwargs.items() if k not in named}
    call = _Call(op, params, [_input_ref(v) for v in inputs])
    for i, arr in enumerate(outputs):
        arr._entry = (call, i)


def get_symbol(x):
    """The recorded computation that made ``x``, as a Symbol
    (``mxtpu.autograd.get_symbol``): each recorded op call a node, each
    array no recorded call made a free variable named var0, var1, ... in
    the order they are met, each number a constant."""
    from .ndarray import NDArray
    from .symbol import Symbol, _Node, _apply_op, _array_input_names, var
    if not isinstance(x, NDArray):
        raise TypeError("get_symbol expects an NDArray, got %r" % (x,))
    free, built = {}, {}

    def leaf(ref):
        kind, value = ref[0], ref[1]
        if kind == "scalar":
            node = _Node(None, "_scalar_%r" % value)
            node.attrs["__scalar__"] = value
            return Symbol([(node, 0)])
        if kind == "var":
            if id(value) not in free:
                free[id(value)] = var("var%d" % len(free))
            return free[id(value)]
        return output(ref[1], ref[2])

    def output(call, index):
        if call.op is None:
            raise ValueError(
                "get_symbol: the computation holds an autograd.Function, "
                "which has no symbolic counterpart")
        if id(call) not in built:
            inputs = [leaf(r) for r in call.inputs]
            names = _array_input_names(call.op, call.params) or ()
            built[id(call)] = _apply_op(call.op, None, inputs,
                                        dict(call.params),
                                        input_names=names[:len(inputs)])
        sym = built[id(call)]
        return sym[index] if len(sym._outputs) > 1 else sym

    if x._entry is None:
        return leaf(("var", weakref.ref(x)))
    return output(*x._entry)


class _FunctionBridge(torch.autograd.Function):
    """The graph node of a :class:`Function` call: its outputs are the
    user's forward's; its backward is the user's."""

    @staticmethod
    def forward(ctx, fn, outs, *inputs):
        ctx.fn, ctx.inputs = fn, inputs
        ctx.out_ctx = [o.context for o in outs]
        return tuple(o.data.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .ndarray import NDArray
        gs = [NDArray(g, c) for g, c in zip(grads, ctx.out_ctx)]
        with pause():
            in_grads = ctx.fn.backward(*gs)
        if not isinstance(in_grads, (list, tuple)):
            in_grads = [in_grads]
        return (None, None) + tuple(
            g.data.to(t.dtype) if g is not None and (
                t.is_floating_point() or t.is_complex()) else None
            for g, t in zip(in_grads, ctx.inputs))


class Function:
    """A user-defined differentiable function (``mxtpu.autograd.Function``,
    MXNet's): subclass it with ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` on NDArrays; ``forward`` runs
    under :func:`pause` and may :meth:`save_for_backward`; under
    ``record()`` the outputs' gradients reach ``backward``, whose returned
    arrays are the inputs' gradients."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray
        with pause():
            outputs = self.forward(*inputs)
        if not is_recording():
            return outputs
        single = not isinstance(outputs, (list, tuple))
        outs = [outputs] if single else list(outputs)
        arrays = [i for i in inputs if isinstance(i, NDArray)]
        for a in arrays:
            if not a.data.requires_grad:
                a._data = _leaf(a.data)
        with torch.enable_grad():
            ts = _FunctionBridge.apply(self, outs, *[a.data for a in arrays])
        call = _Call(None, {}, [_input_ref(a) for a in arrays])
        wrapped = []
        for i, (o, t) in enumerate(zip(outs, ts)):
            w = NDArray(t, o.context)
            w._entry = (call, i)
            wrapped.append(w)
        return wrapped[0] if single else wrapped
