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

``Function`` and ``get_symbol`` are not ported yet.
"""
from __future__ import annotations

import threading
import weakref

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad"]


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
                     if v._grad is not None and v.data.requires_grad]
    if not outs or not variables:
        return
    grads = torch.autograd.grad(outs, [v.data for v in variables], gos,
                                retain_graph=retain_graph, allow_unused=True)
    for v, g in zip(variables, grads):
        if g is None:
            continue
        tgt = v._grad
        g = g.detach().to(tgt.dtype)
        tgt._data = tgt._data + g if v._grad_req == "add" else g


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables``, returned as
    new arrays (zeros where no gradient flows); no ``grad`` is touched."""
    from .ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    outs, gos = _heads(heads, head_grads)
    live = [i for i, v in enumerate(variables) if v.data.requires_grad]
    got = [None] * len(variables)
    if outs and live:
        res = torch.autograd.grad(
            outs, [variables[i].data for i in live], gos,
            retain_graph=bool(retain_graph) or create_graph,
            create_graph=create_graph, allow_unused=True)
        for i, g in zip(live, res):
            got[i] = g
    out = [NDArray(g if create_graph else g.detach(), v.context)
           if g is not None else NDArray(torch.zeros_like(v.data.detach()),
                                         v.context)
           for v, g in zip(variables, got)]
    return out[0] if single else out
