"""Gluon Block / HybridBlock / SymbolBlock of the PyTorch port.

Counterpart of ``mxtpu/gluon/block.py``: name scopes with the same
prefix counters (so parameter names equal ``mxtpu``'s), child blocks,
hooks, ``collect_params(select)``, ``save_params`` / ``load_params``,
``summary``; deferred shape inference through the Symbol frontend; and
``SymbolBlock`` over a Symbol graph.

``hybridize``. Where ``mxtpu`` wraps a block's forward as one ``jax.jit``
program over (rng key, parameters, inputs), the port builds one
:class:`_Program` per signature: the input shapes, dtypes and devices,
the nesting of the arguments, the train flag and which inputs need a
gradient. A program

* traces ``hybrid_forward`` once into the port's Symbol (children run
  inline, as in ``mxtpu``);
* evaluates that graph with ``symbol.eval_graph`` inside one
  ``torch.autograd.Function``: one tape entry whose inputs are the
  block's inputs and every parameter the graph reads (aux states
  included), whose backward differentiates the whole body, and which
  writes the aux outputs (BatchNorm's moving statistics) back into
  their parameters in place;
* on the card, runs its first call for real and captures its second in
  CUDA graphs, the forward and (when a gradient is wanted) the backward,
  which every later call replays: inputs are copied into static
  buffers, parameters are read in place (the Trainer updates them in
  place) and the moving statistics are copied in place inside the
  forward graph. The backward returns every gradient, and
  ``autograd.backward`` applies each parameter's ``grad_req`` as it does
  for an eager op. The forward graph registers the block's CUDA
  generator, so dropout draws anew at each replay. On the CPU every
  call runs the graph uncaptured.

A new signature builds a new program, as ``mxtpu``'s ``_call_cached_op``
does for a new shape; ``set_data``, ``cast``, ``reset_ctx`` or a new
``grad_req`` on a parameter drops the block's programs, and
``hybridize(active=False)`` makes the block eager. Nothing falls back
quietly: an error inside a capture ends the capture and raises. The one
exception is the fused Module step's (``module/fused.py``): a custom op
whose Python body reads the card refuses the capture
(:class:`~mxtpu_torch.base.CaptureRefused`), and that signature's
program then runs uncaptured, warning once and counting
``fallbacks``. A replayed call's outputs and gradients are copies, so
they hold past later calls; its saved activations do not. So a call
made while the backward of the replayed call before it may still run
(a shared-weight net called twice under one ``record()``, a cell
stepped in a loop, a graph kept by ``retain_graph``) evaluates the same
traced graph uncaptured on the card, and is counted as ``uncaptured``.
``cache_stats()`` counts programs, compiles, hits, captures, replays,
uncaptured calls and fallbacks.
"""
from __future__ import annotations

import contextlib
import re
import threading
import warnings
import weakref
from collections import OrderedDict

import torch

from ..base import CaptureRefused
from .. import autograd as _ag
from .. import ndarray as nd
from .. import symbol as _sym
from ..module.fused import ProgramCache, _end_failed_capture
from ..ndarray import NDArray
from ..ops.registry import next_generator, rng_scope
from .parameter import Parameter, ParameterDict, DeferredInitializationError

__all__ = ["Block", "HybridBlock", "SymbolBlock"]


class _BlockScope:
    """Name manager for nested blocks (``mxtpu``'s, counter for counter)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = _name_counter(hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            current._counter[hint] = count + 1
            prefix = "%s%d_" % (hint, count)
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *a):
        if self._block._empty_prefix:
            return
        _BlockScope._current.value = self._old_scope


_NAME_COUNTERS = {}


def _name_counter(hint):
    count = _NAME_COUNTERS.get(hint, 0)
    _NAME_COUNTERS[hint] = count + 1
    return "%s%d" % (hint, count)


def _flatten_nds(args):
    """Flatten nested lists/tuples of NDArrays: (flat, tree)."""
    flat = []

    def rec(a):
        if isinstance(a, NDArray):
            flat.append(a)
            return ("leaf", len(flat) - 1)
        if isinstance(a, (list, tuple)):
            return ("seq", tuple(rec(x) for x in a))
        return ("const", repr(a))

    return flat, tuple(rec(a) for a in args)


def _rebuild_like(args, it):
    out = []
    for a in args:
        if isinstance(a, NDArray):
            out.append(next(it))
        elif isinstance(a, (list, tuple)):
            out.append(_rebuild_like(a, it))
        else:
            out.append(a)
    return out


def _contains_symbol(args):
    for a in args:
        if isinstance(a, _sym.Symbol):
            return True
        if isinstance(a, (list, tuple)) and _contains_symbol(a):
            return True
    return False


def _iter_syms(nest):
    if isinstance(nest, _sym.Symbol):
        yield nest
    elif isinstance(nest, (list, tuple)):
        for item in nest:
            yield from _iter_syms(item)


def _group(syms):
    """One Symbol over every output of ``syms``."""
    return _sym.Symbol([ref for s in syms for ref in s._outputs])


class Block:
    """Base building block (``mxtpu.gluon.Block``)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = OrderedDict()
        self._reg_params = {}
        self._forward_hooks = []
        self._forward_pre_hooks = []

    def _alias(self):
        return self.__class__.__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """This block's parameters and its children's, optionally those
        whose names match regular expression ``select``."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pat = re.compile(select)
            ret.update({n: p for n, p in self.params.items()
                        if pat.match(n)})
        for child in self._children.values():
            ret.update(child.collect_params(select))
        return ret

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            existing = self.__dict__.get("_children")
            if existing is not None:
                existing[name] = value
        elif isinstance(value, Parameter):
            reg = self.__dict__.get("_reg_params")
            if reg is not None:
                reg[name] = value
        super().__setattr__(name, value)

    def register_child(self, block, name=None):
        self._children[name or str(len(self._children))] = block

    def register_forward_hook(self, hook):
        self._forward_hooks.append(hook)

    def register_forward_pre_hook(self, hook):
        self._forward_pre_hooks.append(hook)

    def apply(self, fn):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    # -- persistence --------------------------------------------------------
    def save_params(self, filename):
        self.collect_params().save(filename, strip_prefix=self.prefix)

    save_parameters = save_params

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra, restore_prefix=self.prefix)

    load_parameters = load_params

    # -- call ---------------------------------------------------------------
    def __call__(self, *args):
        for hook in self._forward_pre_hooks:
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks:
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        lines = ["-" * 64,
                 "%-30s %s" % ("Layer (type)", "Param #"),
                 "=" * 64]
        total = 0
        for name, p in self.collect_params().items():
            n = 1
            for s in (p.shape or ()):
                n *= s
            total += n
            lines.append("%-30s %d" % (name, n))
        lines.append("=" * 64)
        lines.append("Total params: %d" % total)
        print("\n".join(lines))

    def __repr__(self):
        s = "{name}(\n".format(name=self.__class__.__name__)
        for key, block in self._children.items():
            s += "  ({key}): {block}\n".format(
                key=key, block=repr(block).replace("\n", "\n  "))
        return s + ")"


_STAT_KEYS = ("compiles", "hits", "captures", "replays", "uncaptured",
              "fallbacks")


class HybridBlock(Block):
    """A block that ``hybridize()`` turns into one program a signature
    (``mxtpu.gluon.HybridBlock``; the module docstring says how)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._flags = {}
        self._programs = None       # ProgramCache of _Program
        self._program_params = None
        self._versions = None
        self._retired = dict.fromkeys(_STAT_KEYS, 0)
        self._generator = None      # the programs' CUDA generator
        self._refusals = {"warned": False}

    def hybridize(self, active=True, **kwargs):
        if kwargs.get("remat"):
            raise NotImplementedError("hybridize(remat=True) is not ported")
        self._active = active
        self._flags = kwargs
        self._drop_programs()
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        super().cast(dtype)
        self._drop_programs()

    def _drop_programs(self):
        """Forget every program (their counts stay in cache_stats)."""
        if self._programs is not None:
            for k, v in self.cache_stats().items():
                if k in self._retired:
                    self._retired[k] = v
        self._programs = None
        self._program_params = None
        self._versions = None

    def cache_stats(self):
        """``{"programs", "compiles", "hits", "captures", "replays",
        "uncaptured", "fallbacks"}`` of this block's hybridized calls
        (``ProgramCache.stats()`` and the programs' own counts), counted
        since it was made."""
        out = dict(self._retired, programs=0)
        if self._programs is not None:
            s = self._programs.stats()
            entries = self._programs.entries()
            out["programs"] = s["programs"]
            out["compiles"] += s["compiles"]
            out["hits"] += s["hits"]
            for k in ("captures", "replays", "uncaptured", "fallbacks"):
                out[k] += sum(getattr(e, k) for e in entries)
        return out

    def programs(self):
        """The programs built since the block's last invalidation."""
        return [] if self._programs is None else self._programs.entries()

    def infer_shape(self, *args):
        self._deferred_infer_shape(*args)

    def _ordered_params(self):
        """Every parameter reachable from this block, in a stable order."""
        return list(self.collect_params().values())

    def _deferred_infer_shape(self, *args):
        """Resolve unknown parameter shapes by the Symbol frontend's shape
        inference over ``hybrid_forward``, as ``mxtpu`` does."""
        params = self._ordered_params()
        pending = [p for p in params if p._deferred_init is not None]
        if not pending:
            return
        flat, _ = _flatten_nds(args)
        data_syms = [_sym.var("__data%d" % i, dtype=a.dtype)
                     for i, a in enumerate(flat)]
        with _ag.pause():
            out = self._symbolic_forward(*_rebuild_like(args,
                                                        iter(data_syms)))
        out = _group(list(_iter_syms(out)))
        arg_shapes, _, aux_shapes = out.infer_shape_partial(
            **{"__data%d" % i: a.shape for i, a in enumerate(flat)})
        shape_of = dict(zip(out.list_arguments(), arg_shapes))
        shape_of.update(zip(out.list_auxiliary_states(), aux_shapes))
        for p in pending:
            s = shape_of.get(p.name)
            if s is None or not all(d > 0 for d in s):
                raise DeferredInitializationError(
                    "could not infer shape for parameter %s" % p.name)
            p.shape = s
            p._finish_deferred_init()

    def _symbolic_forward(self, *sym_args):
        """``hybrid_forward`` against the Symbol frontend."""
        kwargs = {name: p.var() for name, p in self._reg_params.items()}
        return self.hybrid_forward(_sym, *sym_args, **kwargs)

    def forward(self, *args):
        if _contains_symbol(args):
            # a child inside its parent's trace (F = sym)
            return self._symbolic_forward(*args)
        if self._active:
            return self._call_cached_op(*args)
        try:
            return self._eager_forward(*args)
        except DeferredInitializationError:
            self._deferred_infer_shape(*args)
            return self._eager_forward(*args)

    def _eager_forward(self, *args):
        kwargs = {name: p.data() for name, p in self._reg_params.items()}
        return self.hybrid_forward(nd, *args, **kwargs)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    # -- the hybridized call -------------------------------------------------
    def _current_params(self, args):
        """The block's parameters, initialized (deferred shapes inferred
        from ``args``), with the programs dropped if any changed since
        they were built."""
        params = self._program_params
        if params is None:
            params = self._ordered_params()
            try:
                for p in params:
                    p._finish_deferred_init()
            except DeferredInitializationError:
                self._deferred_infer_shape(*args)
            for p in params:
                p._check_initialized()
        versions = tuple(p._version for p in params)
        if self._programs is None or versions != self._versions:
            self._drop_programs()
            self._programs = ProgramCache()
            self._program_params, self._versions = params, versions
        return params

    def _call_cached_op(self, *args):
        params = self._current_params(args)
        flat, tree = _flatten_nds(args)
        recording = _ag.is_recording()
        need_in = tuple(recording and a.data.requires_grad for a in flat)
        grad = recording and (any(need_in) or any(
            p.grad_req != "null" for p in params))
        training = _ag.is_training()
        key = (tuple((a.shape, a.dtype, a.data.device) for a in flat), tree,
               training, grad, need_in)
        prog, hit = self._programs.get(key, lambda: _Program(
            self, args, params, training, grad, need_in))
        outs = prog.call([a.data for a in flat], hit)
        return prog.unflatten([NDArray(o, flat[0].context if flat
                                       else prog.ctx) for o in outs])

    def _card_generator(self, device):
        """The programs' CUDA generator on ``device``, seeded by one draw
        from the framework's generator (``mx.random.seed`` governs it)."""
        if self._generator is None or self._generator.device != device:
            seed = int(torch.randint(0, 2 ** 31 - 1, (),
                                     generator=next_generator()))
            self._generator = torch.Generator(device=device).manual_seed(
                seed)
        return self._generator

    # -- export --------------------------------------------------------------
    def export(self, path, epoch=0):
        """Save ``path-symbol.json`` and ``path-%04d.params`` (``arg:`` /
        ``aux:`` entries), as ``Module``'s checkpoints."""
        with _ag.pause():
            out = self._symbolic_forward(_sym.var("data"))
        out.save("%s-symbol.json" % path)
        aux = set(out.list_auxiliary_states())
        payload = {("aux:" if p.name in aux else "arg:") + p.name: p.data()
                   for p in self._ordered_params()}
        nd.save("%s-%04d.params" % (path, epoch), payload)


class _Program:
    """One signature of a hybridized block: its traced graph, and on the
    card its captured forward and backward graphs."""

    def __init__(self, block, args, params, training, grad, need_in):
        flat, _ = _flatten_nds(args)
        names = ["__data%d" % i for i in range(len(flat))]
        with _ag.pause():
            out = block._symbolic_forward(*_rebuild_like(
                args, iter(_sym.var(n, dtype=a.dtype)
                           for n, a in zip(names, flat))))
        syms = list(_iter_syms(out))
        self.out_tree = _out_tree(out, iter(len(s._outputs) for s in syms))
        self.graph = _group(syms)
        used = set(self.graph.list_arguments()) | \
            set(self.graph.list_auxiliary_states())
        self.params = [p for p in params if p.name in used]
        self.names = names + [p.name for p in self.params]
        self.by_name = {p.name: p for p in self.params}
        self.n_in = len(flat)
        self.training, self.grad = training, grad
        self.need = tuple(need_in) + tuple(
            grad and p.grad_req != "null" for p in self.params)
        self.ctx = flat[0].context if flat else self.params[0].list_ctx()[0]
        self.device = flat[0].data.device if flat \
            else self.params[0].data().data.device
        self.generator = block._card_generator(self.device) \
            if self.device.type == "cuda" else None
        self.refusals = block._refusals   # the block's warn-once flag
        self.fwd = None             # the forward's CUDA graph
        self.bwd = None             # the backward's (CUDA graph, grads)
        self.captures = 0
        self.replays = 0
        self.uncaptured = 0         # calls made while the graphs were busy
        self.fallbacks = 0
        self.refused = None         # why the card refused the capture
        self.pool_bytes = 0         # what the capture added to the card's
        #                             reserved memory
        self.pending = None         # weakref to the marker the last
        #                             replayed call's tape entry saved

    # -- evaluation ----------------------------------------------------------
    def _rng(self):
        return rng_scope(self.generator) if self.generator is not None \
            else contextlib.nullcontext()

    def _evaluate(self, tensors):
        """Evaluate the graph on ``tensors`` (inputs, then parameters) as
        leaves of a graph of its own; write the aux outputs into their
        parameters. Returns (outputs, leaves)."""
        leaves = [t.detach().requires_grad_(True) if n else t.detach()
                  for t, n in zip(tensors, self.need)]
        feed = dict(zip(self.names, leaves))
        with torch.set_grad_enabled(self.grad), self._rng():
            outs, aux = _sym.eval_graph(self.graph._outputs, feed,
                                        self.training, self.device)
        with torch.no_grad():
            for name, new in aux.items():
                if new is not feed[name]:
                    self.by_name[name].data().data.copy_(new)
        return outs, leaves

    def _grads(self, outs, leaves, gos):
        """Gradients of every leaf that wants one (None elsewhere); the
        graph is kept, for a capture's replays or a retained backward."""
        pairs = [(o, g) for o, g in zip(outs, gos)
                 if g is not None and o.requires_grad]
        want = [i for i, leaf in enumerate(leaves) if leaf.requires_grad]
        res = [None] * len(leaves)
        if pairs and want:
            got = torch.autograd.grad([o for o, _ in pairs],
                                      [leaves[i] for i in want],
                                      [g for _, g in pairs],
                                      retain_graph=True, allow_unused=True)
            for i, g in zip(want, got):
                res[i] = g
        return res

    # -- the call ------------------------------------------------------------
    def call(self, ins, hit):
        """This signature's outputs for input tensors ``ins``: on the
        card the first call runs for real, the second captures, every
        call from the second replays, but for one made while the graphs
        are :meth:`busy`, which evaluates the graph uncaptured."""
        tensors = list(ins) + [p.data().data for p in self.params]
        if self.device.type == "cuda" and hit and self.fwd is None \
                and self.refused is None:
            try:
                self._capture(tensors)
            except CaptureRefused as e:
                self._refuse(e)
        if not self.grad:
            if self.fwd is not None:
                return self._replay_forward(ins)
            with torch.no_grad():
                return self._evaluate(tensors)[0]
        return _ProgramFunction.apply(self, *tensors)

    def _refuse(self, err):
        """The card refused this signature's capture (a custom op read
        it): the signature runs uncaptured from now on."""
        self.refused = str(err)
        self.fallbacks += 1
        self.fwd, self.bwd = None, None
        if not self.refusals["warned"]:
            self.refusals["warned"] = True
            warnings.warn("hybridized block not captured: %s; its calls "
                          "run uncaptured" % err, stacklevel=5)

    def unflatten(self, values):
        it = iter(values)

        def rec(t):
            kind, v = t
            if kind == "sym":
                got = [next(it) for _ in range(v)]
                return got[0] if v == 1 else got
            return [rec(x) for x in v]
        return rec(self.out_tree)

    # -- the card's graphs ---------------------------------------------------
    def _capture(self, tensors):
        """Capture the forward (and, when a gradient is wanted, the
        backward) on a side stream into graphs sharing one memory pool.
        The capture executes nothing. ``pool_bytes`` is what it added to
        the card's reserved memory."""
        dev = self.device
        torch.cuda.synchronize(dev)
        reserved = torch.cuda.memory_reserved(dev)
        pool = torch.cuda.graph_pool_handle()
        self.static_in = [t.detach().clone() for t in tensors[:self.n_in]]
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))

        def captured(fn):
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            with torch.cuda.stream(side):
                # thread-local: a DataLoader's worker threads may copy the
                # next batch up while this thread captures
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    out = fn()
                except BaseException:
                    _end_failed_capture(graph, pool, dev,
                                        self.generator or
                                        torch.cuda.default_generators[
                                            dev.index])
                    raise
                graph.capture_end()
            graph.instantiate()
            return graph, out

        self.fwd, (outs, leaves) = captured(lambda: self._evaluate(
            self.static_in + list(tensors[self.n_in:])))
        self.static_out = outs
        if self.grad:
            self.static_gout = [torch.zeros_like(o) if o.requires_grad
                                else None for o in outs]
            self.bwd = captured(lambda: self._grads(outs, leaves,
                                                    self.static_gout))
        torch.cuda.current_stream(dev).wait_stream(side)
        self.captures += 1
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def busy(self):
        """Whether the backward of the last replayed call may still run:
        its tape entry's saved marker lives until that backward has run
        without ``retain_graph`` or the entry is dropped. A replay now
        would overwrite the activations it reads."""
        return self.pending is not None and self.pending() is not None

    def _replay_forward(self, ins):
        for s, t in zip(self.static_in, ins):
            s.copy_(t)
        self.fwd.replay()
        self.replays += 1
        return [o.detach().clone() for o in self.static_out]

    def _replay_backward(self, gos):
        for s, g in zip(self.static_gout, gos):
            if s is not None:
                if g is None:
                    s.zero_()
                else:
                    s.copy_(g)
        graph, grads = self.bwd
        graph.replay()
        return [None if g is None else g.clone() for g in grads]


def _out_tree(out, counts):
    """The nesting of a traced forward's outputs: ("sym", k) for a Symbol
    of k outputs, ("seq", children) for a list or tuple."""
    if isinstance(out, _sym.Symbol):
        return ("sym", next(counts))
    return ("seq", tuple(_out_tree(o, counts) for o in out))


class _ProgramFunction(torch.autograd.Function):
    """A program's call as one tape entry over (inputs, parameters).

    The entry saves what its backward reads with ``save_for_backward``:
    a replayed call a marker (its activations are the graph's), an
    uncaptured call the traced graph's outputs (whose autograd graph
    holds its activations). So torch frees them after a backward without
    ``retain_graph``, and refuses a second backward, as for any op."""

    @staticmethod
    def forward(ctx, prog, *tensors):
        ctx.prog = prog
        ctx.set_materialize_grads(False)
        ctx.replayed = prog.fwd is not None and not prog.busy()
        if ctx.replayed:
            marker = torch.empty(0)
            ctx.save_for_backward(marker)
            prog.pending = weakref.ref(marker)
            return tuple(prog._replay_forward(tensors[:prog.n_in]))
        if prog.fwd is not None:
            prog.uncaptured += 1
        outs, ctx.leaves = prog._evaluate(tensors)
        ctx.save_for_backward(*outs)
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *gos):
        prog = ctx.prog
        saved = ctx.saved_tensors
        if ctx.replayed:
            grads = prog._replay_backward(gos)
        else:
            # the outer graph's release frees this inner graph
            grads = prog._grads(saved, ctx.leaves, gos)
        return (None,) + tuple(grads)


class SymbolBlock(HybridBlock):
    """A Symbol graph as a Block (``mxtpu.gluon.SymbolBlock``): the
    graph's arguments other than ``inputs`` become parameters (aux states
    with ``grad_req="null"``), and a call evaluates the graph eagerly."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        if isinstance(outputs, (list, tuple)):
            outputs = _group(outputs)
        if isinstance(inputs, _sym.Symbol):
            inputs = [inputs]
        self._output_sym = outputs
        self._input_names = [s.name for s in inputs]
        input_set = set(self._input_names)
        aux_names = set(outputs.list_auxiliary_states())
        for name in outputs.list_arguments() + \
                outputs.list_auxiliary_states():
            if name not in input_set:
                self._params.get(
                    name, grad_req="null" if name in aux_names else "write",
                    allow_deferred_init=True)

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of ``symbol_file``'s graph, with the weights of
        ``param_file`` (``arg:`` / ``aux:`` keys or bare names) on
        ``ctx``."""
        graph = _sym.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        block = SymbolBlock(graph, [_sym.var(n) for n in input_names])
        if param_file:
            loaded = nd.load(param_file, ctx=ctx)
            block._params.load_dict(
                {k.split(":", 1)[1] if ":" in k else k: v
                 for k, v in loaded.items()}, ctx=ctx, allow_missing=True,
                ignore_extra=True, source="file %s" % param_file)
        return block

    def forward(self, *args):
        flat, _ = _flatten_nds(args)
        feed = {name: a.data for name, a in zip(self._input_names, flat)}
        pending = [p for p in self._params.values() if p._data is None]
        if pending:
            arg_shapes, _, aux_shapes = \
                self._output_sym.infer_shape_partial(
                    **{n: a.shape for n, a in zip(self._input_names, flat)})
            shape_of = dict(zip(self._output_sym.list_arguments(),
                                arg_shapes))
            shape_of.update(zip(self._output_sym.list_auxiliary_states(),
                                aux_shapes))
            for p in pending:
                p.shape = shape_of[p.name]
                p._finish_deferred_init()
        for name, p in self._params.items():
            feed[name] = p.data().data
        with torch.set_grad_enabled(_ag.is_recording()):
            outs, _ = _sym.eval_graph(self._output_sym._outputs, feed,
                                      _ag.is_training())
        ctx = flat[0].context if flat else None
        outs = [NDArray(o, ctx) for o in outs]
        return outs[0] if len(outs) == 1 else outs
