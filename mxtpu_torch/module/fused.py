"""Fused Module train step of the PyTorch port: one CUDA graph a batch
signature.

Counterpart of ``mxtpu/module/fused.py`` in its local mode (one context,
the optimizer in the module's ``Updater``, float32). ``mxtpu`` runs
forward, backward, the whole optimizer update and the metric's (sum,
count) as one donated XLA program per batch signature; the port runs the
same step, :meth:`~mxtpu_torch.executor.Executor.make_fused_train_step`,
as one function over the executor's bound tensors, which keep their
storage for the executor's life. On the card, the first step of a
signature runs that function for real on a side stream (the warm-up:
the batch's own step, and lazy set-up such as an rtc module's first
load); the signature's second step captures it in a
``torch.cuda.CUDAGraph``, which executes nothing, and replays the graph,
as does every later step of the signature after copying its batch into
the bound data and label tensors. On the CPU the same function runs
uncaptured each step. Either way ``update()`` is an acknowledgement, and
``update_metric`` adds nothing on the host: the step added the batch to
a device (sum, count) that the metric reads at ``get``.

``ProgramCache`` counts a signature's first step (the step function
built and, on the card, warmed up) as a compile and every later step as
a hit, so a fit shows ``mxtpu``'s counts: two compiles in warm-up, the
bare step and then the step with the metric, because the key holds the
metric. The key is ``mxtpu``'s, the batch's signature and the metric
alone: a rebind for other shapes (fit's scoring of another batch size)
keeps its executors, and one for shapes seen before finds them again
(``DataParallelExecutorGroup``), so the entry's tensors are still the
ones its graph reads. On the card each hit replays a graph, captured at
the first hit: the bare step, run for one batch only, is never captured.

The group. Every module driving one optimizer (a bucketing module's
buckets, through ``borrow_optimizer`` and :func:`attach_borrowed`)
shares one :class:`FusedGroupState`: the parameter and aux store that
every bucket's executors alias (``seed_store`` / ``adopt_store``), the
optimizer states the steps read, ``t``, ``lr``, the generator, the
metric accumulator, the capture stream and one memory pool for all the
graphs. Each module keeps its own ``ProgramCache``, so a bucketing fit
shows one compile a bucket and a hit at every later step, as in
``mxtpu``, and a bucket switch copies nothing. Stateful ops
(the RNN's dropout) draw from the step's own CUDA generator, which each
graph registers, so each replay draws the numbers an uncaptured call
would. Host mirrors stay outside the graph: ``num_update``, each slot's
update count, the learning rate (written into its device tensor when the
schedule moves) and the stats. After a fused step ``get_outputs()``
returns the step's outputs, which the group's next step, of any bucket,
overwrites (``mxtpu``'s donation contract).

Mixed precision (``MXTPU_AMP=bf16``, :func:`amp_mode`) is a mode of the
same step, as in ``mxtpu``: the store keeps float32 weights, optimizer
states and aux states, and the step casts the floating weights and
inputs (never the labels, the aux states or an index input such as an
Embedding's token ids) to bfloat16 inside the captured function, so the
forward and backward run in bfloat16 while the gradients return float32
through the cast and the update runs in float32. It casts; it does not
autocast, which would keep some ops in float32 where ``mxtpu`` rounds.
``MXTPU_AMP_LOSS_SCALE=S`` (:func:`amp_loss_scale`) scales the loss by S
(a loss head such as SoftmaxOutput, which ignores its head gradient,
multiplies its own gradient by S, so the step keeps its size: ``mxtpu``
scales only the head cotangent, which such a head drops, and its steps
come out S times smaller), unscales the gradients,
and skips a step whose gradients are not finite inside the graph, every
tensor the step writes left bitwise as it was; :meth:`FusedGroupState.
amp_overflow_skips` counts the skips with one read of ``t``. A module
whose trained parameters are not float32 logs its reason once and keeps
the float32 step; an unknown ``MXTPU_AMP`` raises. The eager path stays
float32. The ``module.step`` fault point fires once a fused step,
before the batch is copied into the step's inputs: ``nan_grad`` there
poisons the batch (the overflow drill).

The rest is ``mxtpu``'s escape hatch: a Monitor, a custom updater,
several contexts, ``inputs_need_grad``, state inputs, ``grad_req`` other
than ``write`` and any kvstore object keep the eager path
(``_fused_eligible``; ``MXTPU_MODULE_FUSED=0`` everywhere), each reason
logged once at debug level, or warned once when it appears after the
trainer engaged. One case is the card's own: a custom op whose Python
body reads the card cannot be captured (``mxtpu`` runs such an op
through ``jax.pure_callback``). The capture then fails with
:class:`~mxtpu_torch.base.CaptureRefused`; the trainer disables itself
the same way, naming the op, and counts ``stats["fallbacks"]``. The
failed capture executed nothing, so that batch takes the eager step.
Any other failure of a capture or a replay raises. Either way a failed
capture is ended so that the allocator and the generators leave capture
mode (:func:`_end_failed_capture`).
"""
from __future__ import annotations

import copy
import logging
import os
import threading
import warnings

import numpy as _np
import torch

from .. import fault as _fault
from .. import optimizer as opt_mod
from ..base import CaptureRefused, dtype_name
from ..model import _module_fused_enabled
from ..ndarray import NDArray
from ..optimizer import state_to_tree

__all__ = ["ProgramCache", "GraphProgram", "FusedGroupState",
           "FusedModuleTrainer", "maybe_create", "attach_borrowed",
           "metric_readback_interval", "_fused_eligible", "amp_mode",
           "amp_loss_scale"]


class ProgramCache:
    """One entry per signature key, built once by the caller's ``build``
    closure: ``compiles`` counts entries built and ``hits`` lookups that
    found one, with ``mxtpu``'s meaning (``imports`` stays 0: the port
    loads no programs from files). Thread-safe: builds run outside the
    lock, so a slow build does not block stats probes."""

    def __init__(self):
        self._programs = {}
        self._lock = threading.Lock()
        self.compiles = 0
        self.hits = 0
        self.imports = 0

    def get(self, key, build):
        """``(program, hit)`` for ``key``, building it on first use."""
        with self._lock:
            entry = self._programs.get(key)
            if entry is not None:
                self.hits += 1
                return entry, True
        entry = build()
        with self._lock:
            self._programs[key] = entry
            self.compiles += 1
        return entry, False

    def discard(self, keep):
        """Drop every entry for which ``keep(key, entry)`` is false."""
        with self._lock:
            for key in [k for k, e in self._programs.items()
                        if not keep(k, e)]:
                del self._programs[key]

    def entries(self):
        """The entries built so far."""
        with self._lock:
            return list(self._programs.values())

    def stats(self):
        with self._lock:
            return {"programs": len(self._programs),
                    "compiles": self.compiles, "hits": self.hits,
                    "imports": self.imports}


def amp_mode():
    """MXTPU_AMP: the mixed-precision mode of the fused step. Unset (or
    ``0``/``off``/``none``/``false``) is off; ``bf16``/``bfloat16``
    computes in bfloat16 with float32 masters. Anything else raises: a
    mistyped dtype must not train in float32 unnoticed."""
    v = os.environ.get("MXTPU_AMP", "").strip().lower()
    if v in ("", "0", "off", "none", "false"):
        return None
    if v in ("bf16", "bfloat16"):
        return "bf16"
    raise ValueError("MXTPU_AMP must be unset/'bf16', got %r" % v)


def amp_loss_scale():
    """MXTPU_AMP_LOSS_SCALE: the static loss scale S of the AMP step (0
    or unset: off; bfloat16 has float32's exponent range, so scaling is
    optional)."""
    try:
        return float(os.environ.get("MXTPU_AMP_LOSS_SCALE", "0") or 0.0)
    except ValueError:
        return 0.0


def metric_readback_interval():
    """MXTPU_METRIC_READBACK: drain the device metric accumulator every N
    batches (0 = only when the metric is read: epoch end / callbacks)."""
    try:
        return int(os.environ.get("MXTPU_METRIC_READBACK", "0"))
    except ValueError:
        return 0


class _Step:
    """A signature's step: the step function and the tensors it reads
    and writes (the executor's, the optimizer states', the group's
    scalars), and on the card the graph captured from it at the
    signature's second step. ``replays`` counts the graph's launches."""

    def __init__(self, fn, args, exec_):
        self.fn = fn
        self.args = args
        self.exec_ = exec_          # keeps the bound tensors alive
        self.graph = None
        self.outs = None            # the outputs the graph writes
        self.replays = 0
        self.pool_bytes = 0

    def call(self):
        return self.fn(*self.args)

    def replay(self):
        self.graph.replay()
        self.replays += 1
        return self.outs


class FusedGroupState:
    """State shared by every module driving one optimizer (the
    ``borrow_optimizer`` group: a bucketing module's buckets): the
    parameter and aux store, the optimizer states the steps read, the
    device scalars (the generator, the step count ``t``, ``lr``), the
    device metric accumulator, the capture stream and memory pool, and
    the counters."""

    def __init__(self, optimizer, updater, ctx):
        self.optimizer = optimizer
        self.updater = updater
        self.ctx = ctx
        self.num_update = int(optimizer.num_update)
        self.generator = None
        self.t_dev = None
        self.lr_dev = None
        self.lr_host = None
        # the parameter and aux arrays every module of the group works on
        self.param_store = {}
        self.aux_store = {}
        self.states = {}             # slot -> the state the steps read
        self.side = None             # the card's warm-up / capture stream
        self.pool = None             # the memory pool the graphs share
        # device-side metric accumulation
        self.metric = None
        self.metric_fn = None
        self.metric_key = None
        self.metric_acc = None
        self.batches_since_drain = 0
        self.readback_every = metric_readback_interval()
        self.warned_fallback = False
        self.stats = {"steps": 0, "compiles": 0, "cache_hits": 0,
                      "metric_drains": 0, "fallbacks": 0}
        # mixed precision (set_amp)
        self.amp = None
        self.compute_dtype = None
        self.loss_scale = None

    def set_amp(self, amp):
        """Engage the group's mixed-precision mode (``maybe_create``)."""
        self.amp = amp
        if amp == "bf16":
            self.compute_dtype = torch.bfloat16
            self.loss_scale = amp_loss_scale() or None

    def amp_overflow_skips(self):
        """Loss-scale overflow steps skipped so far: the steps attempted
        (the host's count) less the steps applied (one read of the
        device's ``t``, made only when asked). 0 without loss scaling."""
        if not self.loss_scale or self.t_dev is None:
            return 0
        return int(self.num_update) - int(self.t_dev.item())

    # -- device scalars ----------------------------------------------------
    def device_state(self):
        """Make ``t`` and ``lr`` on the context's device at the first
        fused step. The step's generator is seeded then by one draw from
        numpy's global stream, where ``mxtpu`` draws its PRNG key, so
        both packages leave numpy's stream alike."""
        if self.t_dev is None:
            dev = self.ctx.torch_device()
            seed = int(_np.random.randint(0, 2 ** 31 - 1))
            self.generator = torch.Generator(device=dev).manual_seed(seed)
            self.t_dev = torch.tensor(self.num_update, dtype=torch.int32,
                                      device=dev)
            self.lr_host = self.host_lr()
            self.lr_dev = torch.tensor(self.lr_host, dtype=torch.float32,
                                       device=dev)

    def host_lr(self):
        o = self.optimizer
        return float(o.lr_scheduler(self.num_update)) \
            if o.lr_scheduler is not None else float(o.lr)

    def refresh_lr(self):
        """Write the rate into its device tensor only when the schedule
        moved: the steady state copies nothing up."""
        new_lr = self.host_lr()
        if new_lr != self.lr_host:
            self.lr_host = new_lr
            self.lr_dev.fill_(new_lr)

    # -- device metric accumulator ----------------------------------------
    def drain_metric(self):
        """Fetch and zero the device (sum, count): the one host sync of
        the metric path, paid when the metric is read."""
        acc = self.metric_acc
        if acc is None:
            return 0.0, 0.0
        total, count = acc.tolist()
        acc.zero_()
        self.batches_since_drain = 0
        self.stats["metric_drains"] += 1
        return total, count

    def zero_metric(self):
        if self.metric_acc is not None:
            self.metric_acc.zero_()
        self.batches_since_drain = 0

    def detach_metric(self):
        m = self.metric
        if m is not None:
            if self.metric_fn is not None:
                m._drain_async()
            m.detach_async()
        self.metric = None
        self.metric_fn = None
        self.metric_key = None


class FusedModuleTrainer:
    """Per-Module runner of the fused train step over its executor (the
    local mode: the update runs inside the step, and ``update()``
    acknowledges it)."""

    def __init__(self, module, group):
        self._module = module
        self._group = group
        exec_group = module._exec_group
        exec_ = exec_group.execs[0]
        # updater slot i = position in the executor group's param list
        # (the indices the eager per-param loop uses, so lr/wd multipliers
        # and saved optimizer states line up)
        names_in_graph = [n for n in exec_group.param_names
                          if n in exec_group.arg_names]
        self._train_names, self._opt_slots = [], []
        for i, name in enumerate(names_in_graph):
            if exec_.grad_dict.get(name) is not None:
                self._train_names.append(name)
                self._opt_slots.append(i)
        self._param_names = names_in_graph
        self._cache = ProgramCache()
        self._last_fused = False
        self._last_metric_applied = False

    # -- group plumbing ----------------------------------------------------
    def seed_store(self):
        """First module of the group: its executor's arrays become the
        group's parameter and aux store."""
        exec_ = self._module._exec_group.execs[0]
        fs = self._group
        fs.param_store = {n: exec_.arg_dict[n] for n in self._param_names}
        fs.aux_store = {n: exec_.aux_dict[n] for n in exec_._aux_names}

    def adopt_store(self):
        """Alias this module's executors, now and after every rebind, to
        the group's store."""
        fs = self._group
        if fs.param_store:
            self._module._exec_group.adopt_store(fs.param_store,
                                                 fs.aux_store)

    # -- fallback ----------------------------------------------------------
    def _disable(self, reason):
        fs = self._group
        fs.stats["fallbacks"] += 1
        if not fs.warned_fallback:
            warnings.warn(
                "Module fused train step disabled: %s — falling back to "
                "the eager forward/backward/update path." % reason,
                stacklevel=4)
            fs.warned_fallback = True
        fs.detach_metric()
        self._module._fused = None

    # -- metric routing ----------------------------------------------------
    def note_eager_forward(self):
        self._last_fused = False

    def note_metric(self, metric):
        """True when this batch's contribution is already accumulated on
        the device; False routes the caller to the host update path (and
        registers the metric so later steps add it)."""
        fs = self._group
        if not self._last_fused:
            return False
        if fs.metric is metric and self._last_metric_applied:
            fs.batches_since_drain += 1
            if fs.readback_every > 0 and \
                    fs.batches_since_drain >= fs.readback_every:
                metric._drain_async()
            return True
        if fs.metric is not metric:
            self._register_metric(metric)
        return False

    def _register_metric(self, metric):
        fs = self._group
        fs.detach_metric()
        fs.metric = metric
        if not metric.supports_device_update():
            return
        label_names = tuple(self._module._label_names)
        ctx = fs.ctx

        def metric_fn(feed, outs):
            labels = [NDArray(feed[n], ctx) for n in label_names
                      if n in feed]
            return metric.device_batch(labels,
                                       [NDArray(o, ctx) for o in outs])

        kw = tuple(sorted((k, repr(v)) for k, v in metric._kwargs.items()))
        fs.metric_fn = metric_fn
        fs.metric_key = (type(metric).__name__, kw)
        metric.update_async(fs.drain_metric, fs.zero_metric)

    # -- the step ----------------------------------------------------------
    @staticmethod
    def _shape_sig(arrs):
        return tuple((tuple(a.shape), str(a.dtype)) for a in (arrs or []))

    def _state(self, slot, weight):
        """The optimizer state of ``slot`` as the steps read it: the first
        one the Updater made. A slot the Updater replaced later (its
        ``set_states``) is copied into those tensors and handed back, so
        a captured graph keeps reading the right storage."""
        updater = self._group.updater
        state = updater.ensure_state(slot, weight)
        held = self._group.states.setdefault(slot, state)
        if state is not held:
            with torch.no_grad():
                for dst, src in zip(_leaves(held), _leaves(state)):
                    dst.copy_(src)
            updater.states[slot] = held
        return held

    def _build(self, exec_, metric_fn, states):
        """A signature's step function over the tensors it works on."""
        fs = self._group
        fn, other_names = exec_.make_fused_train_step(
            self._train_names, fs.optimizer, self._opt_slots,
            metric_fn=metric_fn, compute_dtype=fs.compute_dtype,
            loss_scale=fs.loss_scale,
            cast_exclude=tuple(self._module._label_names))
        args = (tuple(exec_.arg_dict[n].data for n in self._train_names),
                tuple(state_to_tree(s) for s in states),
                tuple(exec_.aux_dict[n].data for n in exec_._aux_names),
                tuple(exec_.arg_dict[n].data for n in other_names),
                fs.generator, fs.t_dev, fs.lr_dev, fs.metric_acc)
        return _Step(fn, args, exec_)

    def _on_card(self):
        return self._group.t_dev.is_cuda

    def _warm_up(self, entry):
        """A signature's first step on the card, run for real on the side
        stream the capture will use."""
        fs = self._group
        dev = fs.t_dev.device
        main = torch.cuda.current_stream(dev)
        if fs.side is None:
            fs.side = torch.cuda.Stream(device=dev)
        fs.side.wait_stream(main)
        with torch.cuda.stream(fs.side):
            outs = entry.call()
        main.wait_stream(fs.side)
        for o in outs:
            o.record_stream(main)
        return outs

    def _capture(self, entry):
        """Capture one call of the step on the side stream into
        ``entry.graph``, which keeps its node list (``raw_cuda_graph()``)
        for inspection. The group's graphs share one memory pool and
        replay one at a time on one stream. A graph captured later may
        hold its outputs in blocks that an earlier one freed as
        temporaries and writes again at each replay, so a step's outputs
        hold only until the group's next replay, of any bucket (``fit``
        reads them before it). ``entry.pool_bytes`` is what the capture
        added to the card's reserved memory."""
        fs = self._group
        gen = fs.generator
        dev = fs.t_dev.device
        torch.cuda.synchronize(dev)
        if fs.pool is None:
            fs.pool = torch.cuda.graph_pool_handle()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.register_generator_state(gen)
        with torch.cuda.stream(fs.side):
            graph.capture_begin(pool=fs.pool)
            try:
                outs = entry.call()
            except BaseException:
                _end_failed_capture(graph, fs.pool, dev, gen)
                raise
            graph.capture_end()
        graph.instantiate()
        entry.graph, entry.outs = graph, outs
        entry.pool_bytes = torch.cuda.memory_reserved(dev) - reserved

    def step(self, data_batch):
        """Run one fused forward+backward+update[+metric] step. Returns
        False (after disabling, where appropriate) when the batch must
        take the eager path instead."""
        mod = self._module
        fs = self._group
        if isinstance(data_batch, list):
            return False  # multi-module list batches: eager path
        # the fused step's fault point (the loss-scale overflow drill
        # poisons the batch here, before it is copied into the inputs)
        if _fault.fire("module.step", op="step") == "nan_grad":
            data_batch = copy.copy(data_batch)
            data_batch.data = [NDArray(d._data * float("nan"), d.context)
                               for d in data_batch.data]
        exec_group = mod._exec_group
        exec_ = exec_group.execs[0]
        if exec_._monitor_callback is not None:
            self._disable("a Monitor is installed (per-node outputs need "
                          "the eager executor)")
            return False
        if not isinstance(mod._updater, opt_mod.Updater) or \
                mod._updater is not fs.updater:
            self._disable("a custom updater replaced the shared "
                          "optimizer Updater")
            return False
        # late reshape (bucketing-style): same contract as forward()
        curr_shapes = tuple(i.shape for i in mod._data_shapes)
        new_shapes = tuple(i.shape for i in data_batch.data)
        if curr_shapes != new_shapes:
            mod.reshape(*mod._shapes_for_batch(data_batch, new_shapes))
            exec_group = mod._exec_group
            exec_ = exec_group.execs[0]

        # the key is mxtpu's: the batch's signature and the metric; a
        # rebind finds the signature's executor again (its group keeps
        # them), so the entry's tensors are the ones loaded below
        key = (self._shape_sig(data_batch.data),
               self._shape_sig(data_batch.label), fs.metric_key)
        metric_fn = fs.metric_fn if fs.metric_key is not None else None
        states = [self._state(slot, exec_.arg_dict[name])
                  for slot, name in zip(self._opt_slots, self._train_names)]
        exec_group.load_batch(data_batch)
        fs.device_state()
        if fs.optimizer.num_update > fs.num_update:
            # eager update() calls interleaved with fused steps advanced
            # the host counters; re-sync the device step count
            fs.num_update = int(fs.optimizer.num_update)
            fs.t_dev.fill_(fs.num_update)
        fs.num_update += 1
        fs.refresh_lr()
        if fs.metric_acc is None:
            fs.metric_acc = torch.zeros(2, dtype=torch.float32,
                                        device=fs.t_dev.device)

        entry, hit = self._cache.get(
            key, lambda: self._build(exec_, metric_fn, states))
        if entry.exec_ is not exec_:
            raise RuntimeError("the fused step of signature %s was built "
                               "over another executor" % (key[:2],))
        if not self._on_card():
            outs = entry.call()
        elif not hit:
            outs = self._warm_up(entry)
        else:
            if entry.graph is None:
                try:
                    self._capture(entry)
                except CaptureRefused as e:
                    # the capture ran nothing: this batch takes the eager
                    # step, which counts its own update
                    fs.num_update -= 1
                    self._disable(str(e))
                    return False
            outs = entry.replay()
        fs.stats["cache_hits" if hit else "compiles"] += 1
        self._finish(exec_, outs, metric_fn)
        return True

    def _finish(self, exec_, outs, metric_fn):
        """Publish the step's outputs and advance the host mirrors of the
        counters the step advanced on the device."""
        fs = self._group
        exec_._outputs = [NDArray(o, exec_._ctx) for o in outs]
        exec_._tape = None
        opt = fs.optimizer
        opt.num_update = fs.num_update
        for slot in self._opt_slots:
            opt._index_update_count[slot] = fs.num_update
        fs.stats["steps"] += 1
        self._last_fused = True
        self._last_metric_applied = metric_fn is not None


def _end_failed_capture(graph, pool, dev, generator):
    """End a capture whose step raised. Where torch refused the step
    before CUDA saw it, the capture ends as usual. Where CUDA refused it
    (a wait for the card inside it), ``capture_end`` raises before torch
    stops the allocator filling the graph's pool and before it takes the
    generators out of capture mode; both are done here, so that the eager
    path after a fallback allocates and draws as before."""
    try:
        graph.capture_end()
        return
    except Exception:
        pass
    torch._C._cuda_endAllocateToPool(dev.index, pool)
    torch._C._cuda_releasePool(dev.index, pool)
    for gen in (torch.cuda.default_generators[dev.index], generator):
        gen.graphsafe_set_state(gen.clone_state())


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    return []


class GraphProgram:
    """A forward-only program captured on its own: ``fn``, run with no
    gradient, over static tensors (its inputs are written into them
    before a call), keeping ``params`` alive (the weights it reads). On
    the CPU every call runs ``fn``. On the card the first call runs it
    for real on the side stream ``side``, and the next call (or
    :meth:`prime`) captures it there in a CUDA graph with a pool of its
    own, which every later call replays; a failed capture is ended
    (:func:`_end_failed_capture`) and raises. The outputs are the graph's
    and hold until its next replay. Not reentrant: one caller at a time.
    The serving engine's generation programs are such programs."""

    def __init__(self, name, fn, device, params, side):
        self.name, self.fn, self.device = name, fn, device
        self.params, self.side = params, side
        self.graph = None
        self.outs = None
        self.ran = False

    def _run(self):
        with torch.no_grad():
            return self.fn()

    def __call__(self):
        if self.device.type != "cuda":
            return self._run()
        if self.graph is None:
            if not self.ran:
                self.ran = True
                return self._run_side()
            self._capture()
        self.graph.replay()
        return self.outs

    def prime(self):
        """Run once and capture now, so that no request pays for either
        (the state a decode program advances is scratch at warm-up)."""
        if self.device.type == "cuda" and self.graph is None:
            if not self.ran:
                self.ran = True
                self._run_side()
            self._capture()

    def _run_side(self):
        main = torch.cuda.current_stream(self.device)
        side = self.side
        side.wait_stream(main)
        with torch.cuda.stream(side):
            outs = self._run()
        main.wait_stream(side)
        for t in _tensors(outs):
            t.record_stream(main)
        return outs

    def _capture(self):
        dev = self.device
        torch.cuda.synchronize(dev)
        pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self.side):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                outs = self._run()
            except BaseException as e:
                _end_failed_capture(graph, pool, dev,
                                    torch.cuda.default_generators[dev.index])
                raise RuntimeError("the %s program could not be captured "
                                   "in a CUDA graph: %s: %s"
                                   % (self.name, type(e).__name__, e)) from e
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(self.side)
        self.graph, self.outs = graph, outs


def _leaves(state):
    """The tensors of a state slot, in order."""
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _leaves(s)]
    return [state.data]


def _sparse_param_names(exec_):
    """Names bound with sparse storage (the argument or its gradient):
    a CSR input, a row-sparse weight or gradient."""
    return [name for name, arr in exec_.arg_dict.items()
            if arr.stype != "default" or
            getattr(exec_.grad_dict.get(name), "stype", "default")
            != "default"]


def _fused_eligible(module):
    """``mxtpu``'s eligibility predicate, case for case, for the modes
    the port has: returns ``('local', None)``, or ``(None, reason)``
    with ``mxtpu``'s words for the reason. Any kvstore object keeps the
    eager path: the port's stores, like ``mxtpu``'s, have no async push
    path. Sparse storage keeps it too: its lazy updates gather and
    scatter a batch's rows, which a captured step cannot follow."""
    if not _module_fused_enabled():
        return None, "MXTPU_MODULE_FUSED=0"
    if len(module._context) != 1 or len(module._exec_group.execs) != 1:
        return None, "multi-context executor group"
    if not module.for_training:
        return None, "bound for inference (for_training=False)"
    if module.inputs_need_grad:
        return None, "inputs_need_grad (callers read input gradients)"
    if module._state_names:
        return None, "explicit state inputs (state_names)"
    if module._grad_req != "write":
        return None, "grad_req=%r (fused step assumes 'write')" \
            % (module._grad_req,)
    if module._kvstore is not None:
        return None, "kvstore %r has no async push path" \
            % (getattr(module._kvstore, "type",
                       type(module._kvstore).__name__),)
    if _sparse_param_names(module._exec_group.execs[0]):
        return None, "sparse parameters (lazy-update path)"
    if not isinstance(module._updater, opt_mod.Updater):
        return None, "custom updater"
    return "local", None


def _log_fallback(module, reason):
    """One-shot debug log naming why the fused path did not engage."""
    if getattr(module, "_fused_fallback_logged", None) == reason:
        return
    module._fused_fallback_logged = reason
    logger = getattr(module, "logger", None) or logging
    logger.debug("Module fused train step not engaged: %s — eager path",
                 reason)


def _amp_eligible(module):
    """``(amp, reason)``: the AMP mode ``MXTPU_AMP`` asks for, or None
    with the reason it cannot engage (a trained parameter that is not
    float32: AMP needs float32 masters), in ``mxtpu``'s words."""
    amp = amp_mode()
    if amp is None:
        return None, None
    exec_ = module._exec_group.execs[0]
    for name, arr in exec_.arg_dict.items():
        if exec_.grad_dict.get(name) is None:
            continue
        if arr._data.dtype != torch.float32:
            return None, (
                "MXTPU_AMP=bf16 requested but parameter %r is %s — AMP "
                "needs fp32 master weights (fp64/fp16 params keep the "
                "fp32 fused step)" % (name, dtype_name(arr._data.dtype)))
    return amp, None


def _log_amp_fallback(module, reason):
    """One-shot debug log naming why AMP stayed off while the fused step
    engaged."""
    if getattr(module, "_amp_fallback_logged", None) == reason:
        return
    module._amp_fallback_logged = reason
    logger = getattr(module, "logger", None) or logging
    logger.debug("Module AMP mode not engaged: %s — fp32 fused step",
                 reason)


def maybe_create(module):
    """Called at the end of ``Module.init_optimizer``: the fused trainer
    when the module is eligible, else None. The group takes the AMP mode
    that ``MXTPU_AMP`` asks for, where the module is eligible for it."""
    mode, reason = _fused_eligible(module)
    if mode is None:
        _log_fallback(module, reason)
        return None
    group = FusedGroupState(module._optimizer, module._updater,
                            module._context[0])
    amp, amp_reason = _amp_eligible(module)
    if amp is not None:
        group.set_amp(amp)
    elif amp_reason is not None:
        _log_amp_fallback(module, amp_reason)
    trainer = FusedModuleTrainer(module, group)
    trainer.seed_store()
    return trainer


def attach_borrowed(module, shared_module):
    """Called from ``Module.borrow_optimizer``: join the lender's group,
    with this module's executors aliased to the group's store (a bucket
    switch then copies nothing, and each bucket's graph reads the same
    parameter, state and scalar tensors)."""
    lender = getattr(shared_module, "_fused", None)
    if lender is None:
        _log_fallback(module, "shared optimizer owner runs eager")
        return None
    mode, reason = _fused_eligible(module)
    if mode is None:
        _log_fallback(module, reason)
        return None
    trainer = FusedModuleTrainer(module, lender._group)
    trainer.adopt_store()
    return trainer
