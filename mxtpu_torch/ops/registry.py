"""Operator registry of the PyTorch port.

Counterpart of ``mxtpu/ops/registry.py``, with the same op names,
aliases and flags. An op is one function of ``torch.Tensor`` inputs plus
static keyword params. Two keyword arguments are injected by the graph
evaluator, never stored in a graph: ``_training`` (ops flagged
``needs_train_flag``) and ``_device`` (nullary ops flagged
``needs_device``, which create tensors and have no input to take a
device from).

Randomness: ``mxtpu`` threads JAX keys through ``rng_scope`` /
``next_rng_key``; the port threads a ``torch.Generator`` through
:class:`rng_scope` / :func:`next_generator` the same way.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["OpDef", "register", "alias", "get_op", "list_ops",
           "ContribNamespace", "storage_fallback",
           "next_generator", "rng_scope", "set_global_seed", "draw",
           "draw_tape"]

_REGISTRY = {}


class OpDef:
    """A registered operator (see ``mxtpu.ops.registry.OpDef``)."""

    __slots__ = ("name", "fn", "differentiable", "stateful", "num_outputs",
                 "doc", "aux_update", "needs_train_flag", "needs_device",
                 "user_outputs")

    def __init__(self, name, fn, differentiable=True, stateful=False,
                 num_outputs=1, doc=None, aux_update=None,
                 needs_train_flag=False, needs_device=False,
                 user_outputs=None):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.stateful = stateful
        self.num_outputs = num_outputs
        self.doc = doc or fn.__doc__
        # {input_index: output_index}: output j is the new value of aux
        # input i (BatchNorm running stats in mxtpu)
        self.aux_update = aux_update or {}
        self.needs_train_flag = needs_train_flag
        self.needs_device = needs_device
        # how many leading outputs a symbol of the op shows (an int, or a
        # function of the params; None: all): BatchNorm's node has 5, its
        # symbol 1, or 3 under output_mean_var
        self.user_outputs = user_outputs

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name=None, differentiable=True, stateful=False, num_outputs=1,
             aliases=(), aux_update=None, needs_train_flag=False,
             needs_device=False, user_outputs=None):
    """Decorator registering a function of tensors as a framework op."""
    def deco(fn):
        opname = name or fn.__name__
        op = OpDef(opname, fn, differentiable=differentiable,
                   stateful=stateful, num_outputs=num_outputs,
                   aux_update=aux_update, needs_train_flag=needs_train_flag,
                   needs_device=needs_device, user_outputs=user_outputs)
        _REGISTRY[opname] = op
        for a in aliases:
            _REGISTRY[a] = op
        return fn
    return deco


def alias(existing, *names):
    """Register more names for the op registered as ``existing``."""
    op = _REGISTRY[existing]
    for n in names:
        _REGISTRY[n] = op


def get_op(name):
    return _REGISTRY.get(name)


def list_ops():
    """Every registered name, aliases included, sorted."""
    return sorted(_REGISTRY)


# ops that take a CSR operand (a ``torch.sparse_csr`` tensor) as it is
_CSR_OPS = frozenset(["dot"])


def storage_fallback(op, value):
    """``value`` as op ``op`` takes it: a CSR tensor reaching an op
    without a CSR path becomes its dense value (MXNet's storage
    fallback; ``mxtpu``'s CSR arrays are dense-backed, so its ops always
    see that value)."""
    if isinstance(value, torch.Tensor) and \
            value.layout == torch.sparse_csr and op.name not in _CSR_OPS:
        return value.to_dense()
    return value


class ContribNamespace:
    """``nd.contrib`` / ``sym.contrib``: attribute ``X`` is
    ``make(op, "X")`` of registry op ``_contrib_X``, else of ``X``, as
    ``mxtpu``'s contrib namespaces resolve it."""

    def __init__(self, make):
        self._make = make

    def __getattr__(self, name):
        for candidate in ("_contrib_" + name, name):
            op = get_op(candidate)
            if op is not None:
                return self._make(op, name)
        raise AttributeError("no contrib op %r" % name)


# ---------------------------------------------------------------------------
# RNG plumbing: stateful ops draw from next_generator(): the generator of
# the innermost rng_scope, else a per-thread default seeded with 0.
# ---------------------------------------------------------------------------

class _RngState(threading.local):
    def __init__(self):
        self.generator = torch.Generator().manual_seed(0)
        self.stack = []
        self.tape = None


_RNG = _RngState()


class rng_scope:
    """Context manager that makes ``generator`` the one stateful ops
    draw from inside the scope."""

    def __init__(self, generator):
        self.generator = generator

    def __enter__(self):
        _RNG.stack.append(self.generator)
        return self.generator

    def __exit__(self, *a):
        _RNG.stack.pop()


def next_generator():
    """The generator stateful ops draw from now."""
    return _RNG.stack[-1] if _RNG.stack else _RNG.generator


def set_global_seed(seed):
    """Reseed this thread's default generator (``mx.random.seed``)."""
    _RNG.generator.manual_seed(int(seed))


def draw(make):
    """A stateful op's random tensor: ``make(generator)`` on
    :func:`next_generator`, or, inside a replaying :class:`draw_tape`,
    the tensor the recorded call drew at the same position."""
    tape = _RNG.tape
    if tape is not None and tape.replaying:
        return tape.draws[next(tape.position)]
    out = make(next_generator())
    if tape is not None:
        tape.draws.append(out)
    return out


class draw_tape:
    """Context manager over one evaluation's random draws: the first
    ``with`` keeps every tensor :func:`draw` makes, each later one hands
    them back in the same order. A rematerialized forward (``remat``,
    ``MXNET_BACKWARD_DO_MIRROR``) so applies the dropout masks of the
    forward it recomputes, as ``mxtpu``'s ``jax.checkpoint`` replays the
    same key; no generator state is read, which a CUDA graph capture
    would refuse, and the kept masks live in the capture's pool."""

    def __init__(self):
        self.draws = []
        self.replaying = False
        self.position = None
        self._outer = None

    def __enter__(self):
        self._outer = _RNG.tape
        if self.replaying:
            self.position = iter(range(len(self.draws)))
        _RNG.tape = self
        return self

    def __exit__(self, *a):
        _RNG.tape = self._outer
        self.replaying = True
