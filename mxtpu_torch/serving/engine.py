"""Inference engine of the PyTorch port: per-bucket predict programs and
the generation programs.

Counterpart of ``mxtpu/serving/engine.py``'s predict menu and generation
contract. A fixed menu of batch sizes (the buckets); a request pads into
the smallest bucket that holds it and its outputs are sliced back to its
rows. Where ``mxtpu`` compiles each bucket's forward ahead of time into
one XLA program, the port, which runs eagerly, prepares a closure per
bucket: shapes resolved, loss-head leftovers allocated on the device, and
on a CUDA context the hand-written kernels built before the first request.
Programs live in a :class:`~mxtpu_torch.module.fused.ProgramCache`,
whose ``compiles``/``hits`` keep their meaning: ``compiles`` equals the
number of programs built, and does not move while requests are answered.

The engine runs on ``gpu(0)`` (``cuda:0``) unless the caller passes
``ctx=cpu()``; on a host without CUDA, a GPU context raises.

Versioned weights, as ``mxtpu``'s engine has them: the parameters live in
per-version stores on the device. :meth:`InferenceEngine.swap_weights`
installs a new version with the same names and shapes (a mismatch, a
half table, a stale version or a wrong digest is refused); a request's
version is resolved once, at admission (:meth:`route_version`: stable,
or the canary split hashed on the request id), so one batch is answered
by one version. Stores are kept for the stable, latest, canary and
pinned versions and the last ``MXTPU_SERVE_VERSION_KEEP``; a pinned
version freezes the stable route (the engine half of a rollback), and
:meth:`load_store` brings a historical version back from a snapshot.

A graph whose head is a ``Custom`` op (a classifier with a custom
softmax-with-loss head, say) serves as any other: the prop's shape hint
names the label argument's shape, which is fed as zeros, and the op runs
on the engine's device, where it may launch ``mx.rtc`` kernels.

Generation. A symbol with one data input (the token ids), a variable
``pos`` declared ``(0,)`` and, for every other declared ``(0, S, ...)``
state variable ``n``, an output ``n_next`` serves autoregressive
generation (``example/char_lm`` builds one). Its programs are
``mxtpu``'s: prefill (one prompt padded into a length bucket, batch 1:
the first greedy token from the true last prompt row and the state rows),
adopt (a prefilled sequence into a slot of the packed K-slot state) and
decode (one step over the K slots). The packed state is a
:class:`GenState` of static tensors that the decode program advances in
place: ``cached_attention`` writes each step's row into the caches it is
given (``ops.nn.static_cache``), where ``mxtpu`` donates the state and
XLA aliases the write, so a step never copies the cache. A lane's
state also owns a copy of the weights its programs read: when a lane
opens on a weight version, that version is copied into the state's
weight buffers on the device (:meth:`InferenceEngine.gen_state_init`),
so the state's prefill program of each bucket and its decode program are
built once and serve every version. On the card they are captured as
CUDA graphs (:class:`~mxtpu_torch.module.fused.GraphProgram`) over the
state's buffers, for ``MXTPU_SERVE_GENERATE_LANES`` states at
:meth:`InferenceEngine.warm`; a swap captures nothing, and a lane in
flight keeps the version it opened on. On the CPU the same programs run
eagerly. Inactive slots compute garbage at constant cost; adoption
overwrites their rows.

Sharded serving and program export (``export_programs`` /
``prewarm_from``) wait for a later slice.
"""
from __future__ import annotations

import os
import threading
import weakref
import zlib

import numpy as _np
import torch

from ..base import canonical_dtype, dtype_name
from ..checkpoint import weight_digest
from ..context import current_context
from ..module.fused import GraphProgram, ProgramCache
from ..ops.nn import static_cache
from ..symbol import Symbol, eval_graph

__all__ = ["InferenceEngine", "GenState", "parse_buckets",
           "parse_shape_spec", "version_keep", "gen_slots", "gen_max_new",
           "gen_prefill_buckets", "gen_lanes_max"]


def version_keep():
    """MXTPU_SERVE_VERSION_KEEP: weight versions kept on the device beyond
    the live set (stable, latest, canary, pinned), so that a request
    admitted on version v is still answerable after the next swap."""
    return max(1, int(os.environ.get("MXTPU_SERVE_VERSION_KEEP", "2")))


def gen_slots():
    """MXTPU_SERVE_GENERATE_SLOTS: decode-batch capacity, the fixed slot
    count every decode program is built for."""
    return max(1, int(os.environ.get("MXTPU_SERVE_GENERATE_SLOTS", "32")))


def gen_max_new():
    """MXTPU_SERVE_GENERATE_MAX_NEW: hard cap on tokens generated per
    sequence (a request's ``max_new`` is clamped to it)."""
    return max(1, int(os.environ.get("MXTPU_SERVE_GENERATE_MAX_NEW",
                                     "256")))


def gen_prefill_buckets():
    """MXTPU_SERVE_GENERATE_PREFILL_BUCKETS: prompt-length buckets the
    prefill programs are built for (the grammar of MXTPU_SERVE_BUCKETS; a
    prompt pads into the smallest that holds it)."""
    return parse_buckets(os.environ.get(
        "MXTPU_SERVE_GENERATE_PREFILL_BUCKETS", "8,16,32"))


def gen_lanes_max():
    """MXTPU_SERVE_GENERATE_LANES: concurrent decode lanes (one per weight
    version in flight); 2 covers a swap: the old version drains while the
    new one serves. :meth:`InferenceEngine.warm` builds this many lane
    states."""
    return max(1, int(os.environ.get("MXTPU_SERVE_GENERATE_LANES", "2")))


def parse_buckets(spec):
    """``MXTPU_SERVE_BUCKETS`` grammar: comma-separated batch sizes,
    e.g. ``1,2,4,8,16,32`` — sorted, deduped, all positive."""
    sizes = sorted({int(b) for b in str(spec).split(",") if b.strip()})
    if not sizes or sizes[0] < 1:
        raise ValueError("bucket spec %r needs positive batch sizes"
                         % (spec,))
    return tuple(sizes)


def parse_shape_spec(spec):
    """``MXTPU_SERVE_DATA_SHAPES`` grammar: ``name=dims;name=dims`` with
    dims a comma list of per-sample dimensions (no batch dimension), e.g.
    ``data=3,32,32`` or ``data=64;mask=64``."""
    shapes = {}
    for item in str(spec).split(";"):
        item = item.strip()
        if not item:
            continue
        name, _, dims = item.partition("=")
        if not dims:
            raise ValueError("shape spec %r needs name=dims" % (item,))
        shapes[name.strip()] = tuple(
            int(d) for d in dims.split(",") if d.strip())
    if not shapes:
        raise ValueError("empty data shape spec %r" % (spec,))
    return shapes


class _Vals(list):
    """A store's tensors, in the engine's name order: a sequence a lane
    state can hold a weak reference to (a tuple cannot be), so that the
    version its weight buffers hold is known without keeping that
    version's store alive. Never mutated."""


class GenState:
    """A decode lane's packed state, static tensors on the engine's
    device: the token feed ``tok (K, 1)``, the positions ``pos (K,)``
    int32, one cache ``(K,) + per-sample shape`` a state variable, and
    ``weights``, the (params, aux) buffers the state's programs read. The
    decode program advances it in place; ``serial`` names the state's
    programs in the program cache, and ``bound`` weakly references the
    store whose weights the buffers hold."""

    __slots__ = ("tok", "pos", "states", "weights", "serial", "bound")

    def __init__(self, tok, pos, states, weights, serial):
        self.tok, self.pos, self.states = tok, pos, states
        self.weights = weights
        self.serial = serial
        self.bound = None

    @property
    def slots(self):
        return int(self.tok.shape[0])


class InferenceEngine:
    """Per-bucket predict programs, and the generation programs of a
    generative symbol, over one loaded model."""

    def __init__(self, symbol, arg_params, aux_params, data_shapes,
                 buckets=(1, 2, 4, 8, 16, 32), ctx=None, dtype="float32",
                 warm=True, version=0):
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else current_context()
        self._dev = self._ctx.torch_device()
        self._buckets = parse_buckets(
            buckets if isinstance(buckets, str)
            else ",".join(str(b) for b in buckets))
        self._dtype = canonical_dtype(dtype)
        self._data_names = tuple(sorted(data_shapes))
        self._sample_shapes = {n: tuple(data_shapes[n])
                               for n in self._data_names}
        arg_names = symbol.list_arguments()
        missing = [n for n in self._data_names if n not in arg_names]
        if missing:
            raise ValueError("data inputs %r are not arguments of the "
                             "symbol (args: %r)" % (missing, arg_names))
        # serving inputs, checkpoint parameters, and the leftovers: label
        # vars of a training head and generative state vars, fed as zeros
        self._param_names = tuple(n for n in arg_names
                                  if n not in self._data_names
                                  and n in arg_params)
        self._extra_names = tuple(n for n in arg_names
                                  if n not in self._data_names
                                  and n not in arg_params)
        self._aux_names = tuple(symbol.list_auxiliary_states())
        self._gen = self._detect_generate()
        param_vals = _Vals(self._put(arg_params[n])
                           for n in self._param_names)
        aux_vals = _Vals(self._put(aux_params[n]) for n in self._aux_names)
        self._param_specs = tuple((tuple(v.shape), v.dtype)
                                  for v in param_vals)
        self._aux_specs = tuple((tuple(v.shape), v.dtype) for v in aux_vals)
        self._store_lock = threading.Lock()
        v0 = int(version)
        # version -> (params, aux, digest recorded at install or None)
        self._stores = {v0: (param_vals, aux_vals, None)}
        self._latest = v0          # the swap watermark (stream dedupe)
        self._stable = v0          # the version requests default to
        self._canary = None        # (version, fraction) under rollout
        self._pinned = None        # a rollback anchor: stable is frozen
        self._serve_epoch = 0      # bumps on every swap or route change
        self._keep = version_keep()
        self.cache = ProgramCache()
        self._gen_lock = threading.Lock()
        self._gen_free = {}            # K -> [GenState] not in a lane
        self._gen_serial = 0
        # the stream the generation programs run their first call and
        # their capture on (the card only)
        self._side = torch.cuda.Stream(device=self._dev) \
            if self._gen is not None and self._dev.type == "cuda" else None
        self._stats_lock = threading.Lock()
        self._stats = {"predicts": 0, "rows": 0, "pad_rows": 0, "swaps": 0,
                       "swaps_refused": 0, "version_rebinds": 0,
                       "gen_prefills": 0, "gen_steps": 0, "lane_binds": 0}
        if warm:
            self.warm()

    def _put(self, v):
        """A copy of one parameter on the engine's device (a store is a
        snapshot: a caller's later writes to its tensor never reach it):
        an NDArray or tensor keeps its dtype, anything else goes through
        numpy."""
        if hasattr(v, "data") and isinstance(v.data, torch.Tensor):
            v = v.data
        if not isinstance(v, torch.Tensor):
            host = v.asnumpy() if hasattr(v, "asnumpy") else _np.asarray(v)
            return torch.from_numpy(_np.array(host, order="C")).to(self._dev)
        t = v.detach().to(self._dev).contiguous()
        return t.clone() if t.data_ptr() == v.data_ptr() else t

    # -- construction ------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, prefix, epoch, data_shapes, **kw):
        """Load a ``save_checkpoint`` artifact (symbol json + params),
        written by either package, into a ready engine."""
        from ..context import cpu
        from ..model import load_checkpoint
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch,
                                                         ctx=cpu())
        return cls(symbol, arg_params, aux_params, data_shapes, **kw)

    # -- introspection -----------------------------------------------------
    @property
    def buckets(self):
        return self._buckets

    @property
    def max_bucket(self):
        return self._buckets[-1]

    @property
    def data_names(self):
        return self._data_names

    @property
    def device(self):
        return self._dev

    def signature(self):
        """The input contract a client learns at hello (``mxtpu``'s
        keys)."""
        sig = {"data_names": list(self._data_names),
               "sample_shapes": {n: list(s) for n, s
                                 in self._sample_shapes.items()},
               "dtype": dtype_name(self._dtype),
               "buckets": list(self._buckets)}
        if self._gen is not None:
            sig["generate"] = self.generate_spec()
        return sig

    def program_fingerprint(self):
        """What makes two engines program-compatible: the signature, every
        store's shapes and dtypes, and the torch version."""
        return {"signature": self.signature(),
                "params": [[list(s), dtype_name(d)]
                           for s, d in self._param_specs],
                "aux": [[list(s), dtype_name(d)]
                        for s, d in self._aux_specs],
                "torch": torch.__version__}

    def stats(self):
        with self._stats_lock:
            out = dict(self._stats)
        out.update(self.cache.stats())
        out.update(self.version_state())
        return out

    def _note(self, field):
        with self._stats_lock:
            self._stats[field] += 1

    # -- versioned weights -------------------------------------------------
    def version_state(self):
        """The version picture a client and an operator see: stable,
        latest, the resident versions, the route epoch, canary, pin."""
        with self._store_lock:
            return {"version": self._stable,
                    "latest": self._latest,
                    "versions": sorted(self._stores),
                    "serve_epoch": self._serve_epoch,
                    "canary": list(self._canary) if self._canary
                    else None,
                    "pinned": self._pinned}

    def _host_params(self, vals):
        return {n: _host(v) for n, v in zip(self._param_names, vals)}

    def current_params(self, version=None):
        """Host copies of a resident version's parameters (the stable one
        by default), name -> numpy."""
        with self._store_lock:
            v = self._stable if version is None else int(version)
            store = self._stores[v]
        return self._host_params(store[0])

    def store_digest(self, version=None):
        """The digest recorded for a resident version's parameters at its
        install, else computed from its bytes (the stable version by
        default); None when not resident."""
        with self._store_lock:
            v = self._stable if version is None else int(version)
            store = self._stores.get(v)
        if store is None:
            return None
        if store[2] is not None:
            return store[2]
        return weight_digest(self._host_params(store[0]))

    def _incoming(self, arg_params, aux_params, version):
        """The device values of an incoming version, or None for a half
        table; a shape mismatch raises (it would need new programs)."""
        if any(n not in arg_params for n in self._param_names):
            return None
        vals = []
        for name, (shape, dtype) in zip(self._param_names,
                                        self._param_specs):
            v = self._put(arg_params[name])
            if tuple(v.shape) != shape:
                raise ValueError(
                    "weight version %d: param %r has shape %r, the "
                    "engine's programs take %r — a swap must never "
                    "retrace" % (version, name, tuple(v.shape), shape))
            vals.append(v.to(dtype))
        aux = None
        if aux_params:
            aux = _Vals(self._put(aux_params[n]).to(dt)
                        for n, (_s, dt) in zip(self._aux_names,
                                               self._aux_specs))
        return _Vals(vals), aux

    def _verify(self, vals, digest, version):
        if digest is not None and \
                weight_digest(self._host_params(vals)) != digest:
            raise ValueError(
                "weight version %d failed digest verification — refusing "
                "to serve corrupt params" % version)

    def swap_weights(self, arg_params, aux_params=None, version=None,
                     digest=None, activate=True):
        """Install ``arg_params`` (name -> numpy, NDArray or tensor; every
        checkpoint parameter, the engine's shapes) as a new weight version
        and, unless pinned, make it the stable one. ``aux_params`` None
        carries the latest store's aux states over. ``digest`` (the
        publisher's ``weight_digest``) is checked against the incoming
        bytes first. Returns the installed version, or None when refused:
        a version at or below the watermark (a replayed record) or a half
        table. Neither predict programs (weights are their arguments) nor
        generation programs (they read a lane's own buffers) are built."""
        with self._store_lock:
            v = self._latest + 1 if version is None else int(version)
            if v <= self._latest:
                refused = True
            else:
                refused = False
        if refused:
            self._note("swaps_refused")
            return None
        got = self._incoming(arg_params, aux_params, v)
        if got is None:
            self._note("swaps_refused")
            return None
        params, aux = got
        self._verify(params, digest, v)
        with self._store_lock:
            if v <= self._latest:          # raced with a newer swap
                refused = True
            else:
                refused = False
                if aux is None:
                    aux = self._stores[self._latest][1]
                self._stores[v] = (params, aux, digest)
                self._latest = v
                if activate and self._pinned is None:
                    self._stable = v
                self._serve_epoch += 1
                self._gc_stores_locked()
        self._note("swaps_refused" if refused else "swaps")
        return None if refused else v

    def _gc_stores_locked(self):
        live = {self._stable, self._latest, self._pinned}
        if self._canary is not None:
            live.add(self._canary[0])
        keep = sorted(self._stores)[-self._keep:]
        for v in [v for v in self._stores
                  if v not in live and v not in keep]:
            del self._stores[v]

    def set_canary(self, version, fraction):
        """Route ``fraction`` of requests (by a hash of the request id) to
        ``version``; the rest stay on stable. None ends the canary."""
        fraction = float(fraction)
        with self._store_lock:
            if version is not None and int(version) not in self._stores:
                raise ValueError("canary version %r is not resident (have "
                                 "%r)" % (version, sorted(self._stores)))
            self._canary = (int(version), fraction) \
                if version is not None else None
            self._serve_epoch += 1

    def promote(self, version=None):
        """Make ``version`` (default: the canary's, else the latest) the
        stable route; ends the canary and the pin."""
        with self._store_lock:
            if version is None and self._canary is not None:
                version = self._canary[0]
            if version is None:
                version = self._latest
            version = int(version)
            if version not in self._stores:
                raise ValueError("cannot promote non-resident version %d"
                                 % version)
            self._stable = version
            self._canary = None
            self._pinned = None
            self._serve_epoch += 1
            return version

    def abort_canary(self):
        with self._store_lock:
            self._canary = None
            self._serve_epoch += 1

    def pin(self, version):
        """Freeze the stable route on ``version`` (resident): swaps keep
        installing stores but stop becoming stable until :meth:`unpin`."""
        with self._store_lock:
            version = int(version)
            if version not in self._stores:
                raise ValueError("cannot pin non-resident version %d (have "
                                 "%r)" % (version, sorted(self._stores)))
            self._pinned = version
            self._stable = version
            self._canary = None
            self._serve_epoch += 1

    def unpin(self):
        with self._store_lock:
            self._pinned = None
            self._serve_epoch += 1

    def load_store(self, arg_params, version, digest=None,
                   aux_params=None):
        """Install a historical version as a resident store without
        touching the routes (past the watermark's refusal: a canary or a
        rollback serves older versions); pair it with :meth:`set_canary`,
        :meth:`pin` or :meth:`promote`. A digest mismatch or a half table
        raises; nothing is half installed."""
        version = int(version)
        got = self._incoming(arg_params, aux_params, version)
        if got is None:
            raise ValueError("weight version %d is missing params — "
                             "refusing a half table" % version)
        params, aux = got
        self._verify(params, digest, version)
        with self._store_lock:
            if aux is None:
                aux = self._stores[self._stable][1]
            self._stores[version] = (params, aux, digest)
            self._serve_epoch += 1
        return version

    def restore_version(self, arg_params, aux_params=None, version=0,
                        digest=None):
        """The rollback composite: :meth:`load_store`, then :meth:`pin`."""
        version = self.load_store(arg_params, version, digest=digest,
                                  aux_params=aux_params)
        self.pin(version)
        return version

    def route_version(self, rid):
        """The version that answers request ``rid``, resolved once at
        admission: the canary's for the share of request ids whose crc32
        falls under its fraction, else stable's. No clock, no randomness."""
        with self._store_lock:
            if self._canary is None:
                return self._stable
            version, fraction = self._canary
            if zlib.crc32(str(rid).encode()) % 10000 < fraction * 10000:
                return version
            return self._stable

    def _resolve_store(self, version):
        """``(params, aux, answered version)`` of ``version`` (None: the
        stable one); a version dropped between admission and dispatch
        rebinds to stable (counted), so a batch is still answered by one
        version."""
        with self._store_lock:
            v = self._stable if version is None else int(version)
            store = self._stores.get(v)
            rebind = store is None
            if rebind:
                v = self._stable
                store = self._stores[v]
        if rebind:
            self._note("version_rebinds")
        return store[0], store[1], v

    def store_exact(self, version):
        """``(params, aux)`` of exactly ``version``, or None: a replayed
        sequence that already streamed tokens must never rebind to
        another version."""
        with self._store_lock:
            store = self._stores.get(int(version))
        return None if store is None else (store[0], store[1])

    # -- requests ----------------------------------------------------------
    def check_rows(self, arrays):
        """Validate one request payload (one numpy array per data input,
        in ``data_names`` order). Returns the row count."""
        if len(arrays) != len(self._data_names):
            raise ValueError(
                "payload has %d arrays, model takes %d inputs %r"
                % (len(arrays), len(self._data_names), self._data_names))
        rows = None
        for name, arr in zip(self._data_names, arrays):
            arr = _np.asarray(arr)
            want = self._sample_shapes[name]
            if arr.ndim != len(want) + 1 or tuple(arr.shape[1:]) != want:
                raise ValueError("input %r has shape %r, want (rows,)+%r"
                                 % (name, tuple(arr.shape), want))
            if rows is None:
                rows = int(arr.shape[0])
            elif int(arr.shape[0]) != rows:
                raise ValueError("inputs disagree on rows: %r has %d, "
                                 "expected %d" % (name, arr.shape[0], rows))
        if rows == 0:
            raise ValueError("empty request (0 rows)")
        if rows > self.max_bucket:
            raise ValueError("request rows %d exceed the largest bucket %d"
                             % (rows, self.max_bucket))
        return rows

    def bucket_for(self, rows):
        """Smallest configured bucket holding ``rows``."""
        for b in self._buckets:
            if rows <= b:
                return b
        raise ValueError("rows %d exceed the largest bucket %d"
                         % (rows, self.max_bucket))

    # -- programs ----------------------------------------------------------
    def _declared_var_specs(self):
        """``name -> (shape, dtype)`` for every symbol variable that
        declared a ``__shape__`` with a leading 0 (batch) dimension: the
        per-sample contract generative state vars ride (shape inference
        cannot derive them)."""
        out = {}
        for node_name, attrs in self._symbol.attr_dict().items():
            s = attrs.get("__shape__")
            if s is None:
                continue
            s = tuple(int(d) for d in s)
            if s and s[0] == 0 and all(d > 0 for d in s[1:]):
                out[node_name] = (s, canonical_dtype(
                    attrs.get("__dtype__", self._dtype)))
        return out

    def _extra_shapes(self, bucket):
        """``(name, shape, dtype)`` of the non-data, non-parameter
        arguments for ``bucket``: generative state vars (declared
        ``__shape__``, batch dim 0) and label vars of a training head (by
        shape inference)."""
        if not self._extra_names:
            return ()
        declared = self._declared_var_specs()
        resolved = {n: ((bucket,) + declared[n][0][1:], declared[n][1])
                    for n in self._extra_names if n in declared}
        missing = [n for n in self._extra_names if n not in resolved]
        if missing:
            kwargs = {n: (bucket,) + self._sample_shapes[n]
                      for n in self._data_names}
            arg_shapes, _outs, _aux = self._symbol.infer_shape(**kwargs)
            by_name = dict(zip(self._symbol.list_arguments(), arg_shapes))
            bad = [n for n in missing if by_name.get(n) is None]
            if bad:
                raise ValueError(
                    "symbol arguments %r are neither checkpoint parameters "
                    "nor data inputs, and their shapes cannot be inferred"
                    % (bad,))
            for n in missing:
                resolved[n] = (tuple(by_name[n]), self._dtype)
        return tuple((n,) + resolved[n] for n in self._extra_names)

    def _build_program(self, bucket):
        """The bucket's forward as a closure over the resolved graph."""
        data_names, param_names = self._data_names, self._param_names
        aux_names, dev = self._aux_names, self._dev
        outputs_ref = self._symbol._outputs
        extra = {n: torch.zeros(s, dtype=dt, device=dev)
                 for n, s, dt in self._extra_shapes(bucket)}

        def program(data_vals, param_vals, aux_vals):
            feed = dict(zip(param_names, param_vals))
            feed.update(zip(aux_names, aux_vals))
            feed.update(zip(data_names, data_vals))
            feed.update(extra)
            with torch.inference_mode():
                outs, _aux_updates = eval_graph(outputs_ref, feed, False,
                                                device=dev)
            return outs

        return program

    def program(self, bucket):
        """The prepared program for ``bucket`` (cached)."""
        if bucket not in self._buckets:
            raise ValueError("no bucket %d (configured: %r)"
                             % (bucket, self._buckets))
        program, _hit = self.cache.get(
            ("predict", bucket), lambda: self._build_program(bucket))
        return program

    def warm(self):
        """Prepare every bucket program now, and on a CUDA context build
        the kernels, so that no request pays for either; for a generative
        model also ``gen_lanes_max()`` lane states, each with its prefill
        menu and decode program (on the card each captured), and the
        adopt program. Returns the number of programs in the cache."""
        if self._dev.type == "cuda":
            from .._build import build_all
            build_all()
        for b in self._buckets:
            self.program(b)
        if self._gen is not None:
            K = gen_slots()
            with self._gen_lock:
                have = len(self._gen_free.get(K, ()))
            states = [self.gen_state_init(K)
                      for _ in range(max(0, gen_lanes_max() - have))]
            for state in states:
                for L in self.gen_prefill_menu():
                    self.gen_prefill_program(L, state).prime()
                self.gen_decode_program(state).prime()
                self.gen_state_release(state)
            self.gen_adopt_program(K)
        return self.cache.stats()["programs"]

    # -- autoregressive generation -----------------------------------------
    # The generative symbol contract (mxtpu's): exactly one data input
    # (the token ids, [batch, time]), an extra var named "pos" (per-slot
    # write offset, declared shape (0,)), and for every other extra var
    # ``n`` (a state cache, declared per-sample shape (0, S, ...)) an
    # output named ``n + "_next"`` carrying its updated value.
    def _detect_generate(self):
        if len(self._data_names) != 1:
            return None
        if "pos" not in self._extra_names:
            return None
        out_idx = {n: i for i, n in
                   enumerate(self._symbol.list_outputs())}
        declared = self._declared_var_specs()
        states = []
        for n in self._extra_names:
            if n == "pos":
                continue
            i = out_idx.get(n + "_next_output")
            spec = declared.get(n)
            if i is None or spec is None or len(spec[0]) < 2:
                return None
            states.append((n, tuple(spec[0][1:]), spec[1], i))
        if not states:
            return None
        return {"tok": self._data_names[0], "pos": "pos",
                "states": tuple(states),
                "cache_len": int(min(s[1][0] for s in states)),
                "in_place": self._states_in_place(states)}

    def _states_in_place(self, states):
        """True when every state's ``n_next`` output is (through
        ``identity`` nodes) the updated cache a ``cached_attention`` node
        computes from variable ``n``, and the logits need that node: then
        the programs evaluate the logits alone and the op writes each
        cache in place. Otherwise they evaluate every output and copy the
        new states over the old."""
        outputs = self._symbol._outputs
        needed = {id(nd) for nd in Symbol([outputs[0]])._topo()}
        for n, _s, _dt, i in states:
            node, oi = outputs[i]
            while node.op is not None and node.op.name == "identity":
                node, oi = node.inputs[0]
            if node.op is None or node.op.name != "cached_attention" \
                    or oi not in (1, 2) or id(node) not in needed:
                return False
            src, _ = node.inputs[2 + oi]
            if not src.is_variable or src.name != n:
                return False
        return True

    @property
    def is_generative(self):
        return self._gen is not None

    def generate_spec(self):
        """The generation contract (None for one-shot models): state
        names, cache length (the hard sequence-length ceiling), the
        prefill menu, the slots and the max_new clamp."""
        if self._gen is None:
            return None
        return {"token_input": self._gen["tok"],
                "states": [n for n, _s, _d, _i in self._gen["states"]],
                "cache_len": self._gen["cache_len"],
                "prefill_buckets": list(self.gen_prefill_menu()),
                "slots": gen_slots(),
                "max_new": gen_max_new()}

    def gen_prefill_menu(self):
        """Prefill prompt-length buckets, clamped to the cache length."""
        if self._gen is None:
            return ()
        S = self._gen["cache_len"]
        menu = tuple(b for b in gen_prefill_buckets() if b <= S)
        return menu or (S,)

    def gen_bucket_for(self, plen):
        for b in self.gen_prefill_menu():
            if plen <= b:
                return b
        raise ValueError(
            "prompt length %d exceeds the largest prefill bucket %d"
            % (plen, self.gen_prefill_menu()[-1]))

    def _require_gen(self):
        if self._gen is None:
            raise ValueError(
                "model is not generative: the symbol lacks the "
                "pos/state-next generation contract")

    def _gen_run(self, feed):
        """The graph over ``feed``: (logits, the new states, or None when
        the caches were written in place)."""
        outputs = self._symbol._outputs
        states = self._gen["states"]
        if self._gen["in_place"]:
            with static_cache():
                outs, _aux = eval_graph([outputs[0]], feed, False,
                                        device=self._dev)
            return outs[0], None
        outs, _aux = eval_graph([outputs[0]] + [outputs[i] for _n, _s, _d, i
                                                in states],
                                feed, False, device=self._dev)
        return outs[0], tuple(outs[1:])

    def _store_feed(self, params, aux):
        feed = dict(zip(self._param_names, params))
        feed.update(zip(self._aux_names, aux))
        return feed

    def _build_gen_prefill(self, L, state):
        """Prompt in (padded to bucket ``L``, batch 1) -> (first greedy
        token, the state rows), over ``state``'s weight buffers. The first
        token comes from the true last prompt row, ``length - 1``, so
        padding never leaks into it."""
        g, dev = self._gen, self._dev
        params, aux = state.weights
        tokens = torch.zeros((1, L), dtype=self._dtype, device=dev)
        length = torch.ones((1,), dtype=torch.int32, device=dev)
        caches = tuple(torch.zeros((1,) + s, dtype=dt, device=dev)
                       for _n, s, dt, _i in g["states"])
        feed = self._store_feed(params, aux)
        feed[g["tok"]] = tokens
        feed[g["pos"]] = torch.zeros((1,), dtype=torch.int32, device=dev)
        feed.update(zip((n for n, _s, _d, _i in g["states"]), caches))

        def prefill():
            logits, new = self._gen_run(feed)
            if logits.dim() == 2:              # flattened head: (L, V)
                logits = logits.reshape(1, L, -1)
            at = (length.long() - 1)[:, None, None].expand(
                1, 1, logits.shape[-1])
            last = logits.gather(1, at)
            first = torch.argmax(last[:, 0, :], dim=-1).to(torch.int32)
            return first, (caches if new is None else new)

        prog = GraphProgram("prefill L=%d lane %d" % (L, state.serial),
                            prefill, dev, params, self._side)
        prog.tokens, prog.length = tokens, length
        return prog

    def _build_gen_decode(self, state):
        """One decode step over ``state``'s K slots and weight buffers: the
        next greedy token of each slot; the token feed, the positions and
        the caches advanced in place."""
        g = self._gen
        params, aux = state.weights
        feed = self._store_feed(params, aux)
        feed[g["tok"]] = state.tok
        feed[g["pos"]] = state.pos
        feed.update(zip((n for n, _s, _d, _i in g["states"]), state.states))

        def decode():
            logits, new = self._gen_run(feed)
            if logits.dim() == 3:
                logits = logits[:, -1, :]
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            if new is not None:
                for c, v in zip(state.states, new):
                    c.copy_(v)
            state.tok.copy_(nxt[:, None].to(state.tok.dtype))
            state.pos.add_(1)
            return nxt

        return GraphProgram("decode K=%d lane %d" % (state.slots,
                                                    state.serial),
                            decode, self._dev, params, self._side)

    def _build_gen_adopt(self, K):
        """Write one prefilled sequence into slot ``slot`` of a K-slot
        state: how a queued sequence joins the in-flight batch at a step
        boundary without draining it. A few copies on the device."""
        def adopt(state, first, plen, rows, slot):
            with torch.no_grad():
                state.tok[slot:slot + 1, 0].copy_(
                    first.reshape(1).to(state.tok.dtype))
                state.pos[slot:slot + 1].fill_(int(plen))
                for c, r in zip(state.states, rows):
                    c[slot:slot + 1].copy_(r.to(c.dtype))
            return state

        return adopt

    def gen_prefill_program(self, L, state):
        """The prefill program of bucket ``L`` over ``state``'s weights."""
        self._require_gen()
        program, _hit = self.cache.get(
            ("gen_prefill", L, state.serial),
            lambda: self._build_gen_prefill(L, state))
        return program

    def gen_decode_program(self, state):
        """The decode program of ``state``."""
        self._require_gen()
        program, _hit = self.cache.get(
            ("gen_decode", state.slots, state.serial),
            lambda: self._build_gen_decode(state))
        return program

    def gen_adopt_program(self, K):
        self._require_gen()
        program, _hit = self.cache.get(
            ("gen_adopt", K), lambda: self._build_gen_adopt(K))
        return program

    def gen_state_init(self, K, store=None):
        """A zeroed K-slot decode state for a lane whose weight buffers
        hold ``store`` (``(params, aux)``; the stable one by default): a
        released state (whose programs are built) that already holds it,
        else another released one into which the store is copied on the
        device, else a new state."""
        self._require_gen()
        if store is None:
            params, aux, _v = self._resolve_store(None)
        else:
            params, aux = store[0], store[1]
        with self._gen_lock:
            free = self._gen_free.setdefault(K, [])
            state = next((st for st in free if st.bound is not None
                          and st.bound() is params), None)
            if state is None and free:
                state = free[-1]
            if state is not None:
                free.remove(state)
            else:
                self._gen_serial += 1
                serial = self._gen_serial
        if state is None:
            dev = self._dev
            state = GenState(
                torch.zeros((K, 1), dtype=self._dtype, device=dev),
                torch.zeros((K,), dtype=torch.int32, device=dev),
                tuple(torch.zeros((K,) + s, dtype=dt, device=dev)
                      for _n, s, dt, _i in self._gen["states"]),
                (tuple(torch.empty_like(p) for p in params),
                 tuple(torch.empty_like(a) for a in aux)), serial)
        with torch.no_grad():
            if state.bound is None or state.bound() is not params:
                for dst, src in zip(state.weights[0] + state.weights[1],
                                    tuple(params) + tuple(aux)):
                    dst.copy_(src)
                state.bound = weakref.ref(params)
                self._note("lane_binds")
            for t in (state.tok, state.pos) + state.states:
                t.zero_()
        return state

    def gen_state_release(self, state):
        """Give a lane's state back when the lane closes."""
        with self._gen_lock:
            self._gen_free.setdefault(state.slots, []).append(state)

    def gen_prefill(self, tokens, state):
        """Prefill one prompt with ``state``'s weights. Returns
        ``(first_token (1,) int32 device tensor, state rows)``; the caller
        reads the token and adopts the rows into a slot before the next
        prefill of the same bucket and state, which writes them again."""
        self._require_gen()
        arr = _np.asarray(tokens).reshape(-1)
        plen = int(arr.shape[0])
        if plen < 1:
            raise ValueError("empty prompt")
        L = self.gen_bucket_for(plen)
        program = self.gen_prefill_program(L, state)
        padded = _np.zeros((1, L), _np.float32)
        padded[0, :plen] = arr
        program.tokens.copy_(torch.from_numpy(padded))
        program.length.fill_(plen)
        first, rows = program()
        self._note("gen_prefills")
        return first, rows

    def gen_step(self, state):
        """One decode step over a lane's state; returns ``(next tokens
        (K,) int32 on the device, state)``, the state advanced in place."""
        self._require_gen()
        nxt = self.gen_decode_program(state)()
        self._note("gen_steps")
        return nxt, state

    def gen_adopt(self, state, first_tok, plen, rows, slot):
        """Write a prefilled sequence into ``slot`` of a lane's state;
        its position starts at the prompt length."""
        self._require_gen()
        return self.gen_adopt_program(state.slots)(state, first_tok, plen,
                                                   rows, slot)

    # -- execution ---------------------------------------------------------
    def predict(self, arrays, rows=None):
        """Pad ``arrays`` into the smallest bucket, run its program on the
        current weights and return numpy outputs sliced to ``rows``."""
        outs, _v = self.predict_versioned(arrays, rows=rows)
        return outs

    def predict_versioned(self, arrays, rows=None, version=None):
        """As :meth:`predict`, against weight ``version`` (None: the
        current one); returns ``(outputs, answered_version)``."""
        if rows is None:
            rows = self.check_rows(arrays)
        bucket = self.bucket_for(rows)
        program = self.program(bucket)
        param_vals, aux_vals, answered = self._resolve_store(version)
        np_dtype = _np.float32 if self._dtype == torch.bfloat16 \
            else _np.dtype(dtype_name(self._dtype))
        data_vals = []
        for name, arr in zip(self._data_names, arrays):
            padded = _np.zeros((bucket,) + self._sample_shapes[name],
                               np_dtype)
            padded[:rows] = _np.asarray(arr)[:rows]
            data_vals.append(torch.from_numpy(padded)
                             .to(self._dev).to(self._dtype))
        outs = program(tuple(data_vals), param_vals, aux_vals)
        with self._stats_lock:
            self._stats["predicts"] += 1
            self._stats["rows"] += rows
            self._stats["pad_rows"] += bucket - rows
        return [_host(o[:rows]) for o in outs], answered


def _host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
