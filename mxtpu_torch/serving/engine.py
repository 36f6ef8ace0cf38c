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
``ctx=cpu()``; on a host without CUDA, a GPU context raises. Weights live
in per-version stores: :meth:`InferenceEngine.swap_weights` installs a
new version with the same names and shapes, and a request's version is
resolved once, so one batch is answered by one version.

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
XLA aliases the write, so a step never copies the cache. On the card the
prefill program of each bucket and the decode program of each state are
captured as CUDA graphs (:class:`~mxtpu_torch.module.fused.GraphProgram`),
over one weight version each: at
:meth:`InferenceEngine.warm` for the stable version, else at their first
call (run for real) and captured at the second; a failed capture raises.
On the CPU the same programs run eagerly. Inactive slots compute garbage
at constant cost; adoption overwrites their rows.

Sharded serving, canaries and program export wait for a later slice.
"""
from __future__ import annotations

import os
import threading

import numpy as _np
import torch

from ..base import canonical_dtype, dtype_name
from ..context import current_context
from ..module.fused import GraphProgram, ProgramCache
from ..ops.nn import static_cache
from ..symbol import Symbol, eval_graph

__all__ = ["InferenceEngine", "GenState", "parse_buckets", "gen_slots",
           "gen_max_new", "gen_prefill_buckets"]


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


def parse_buckets(spec):
    """``MXTPU_SERVE_BUCKETS`` grammar: comma-separated batch sizes,
    e.g. ``1,2,4,8,16,32`` — sorted, deduped, all positive."""
    sizes = sorted({int(b) for b in str(spec).split(",") if b.strip()})
    if not sizes or sizes[0] < 1:
        raise ValueError("bucket spec %r needs positive batch sizes"
                         % (spec,))
    return tuple(sizes)


class GenState:
    """A decode lane's packed state, static tensors on the engine's
    device: the token feed ``tok (K, 1)``, the positions ``pos (K,)``
    int32 and one cache ``(K,) + per-sample shape`` a state variable. The
    decode program advances it in place; ``serial`` names it in the
    program cache."""

    __slots__ = ("tok", "pos", "states", "serial")

    def __init__(self, tok, pos, states, serial):
        self.tok, self.pos, self.states = tok, pos, states
        self.serial = serial

    @property
    def slots(self):
        return int(self.tok.shape[0])


class InferenceEngine:
    """Per-bucket predict programs, and the generation programs of a
    generative symbol, over one loaded model."""

    _KEEP_VERSIONS = 2

    def __init__(self, symbol, arg_params, aux_params, data_shapes,
                 buckets=(1, 2, 4, 8, 16, 32), ctx=None, dtype="float32",
                 warm=True):
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
        param_vals = tuple(self._put(arg_params[n])
                           for n in self._param_names)
        aux_vals = tuple(self._put(aux_params[n]) for n in self._aux_names)
        self._param_specs = tuple((tuple(v.shape), v.dtype)
                                  for v in param_vals)
        self._store_lock = threading.Lock()
        self._stores = {0: (param_vals, aux_vals)}
        self._stable = 0
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
                       "gen_prefills": 0, "gen_steps": 0}
        if warm:
            self.warm()

    def _put(self, v):
        """One parameter on the engine's device: an NDArray or tensor
        keeps its dtype, anything else goes through numpy."""
        if hasattr(v, "data") and isinstance(v.data, torch.Tensor):
            v = v.data
        if not isinstance(v, torch.Tensor):
            host = v.asnumpy() if hasattr(v, "asnumpy") else _np.asarray(v)
            v = torch.from_numpy(_np.array(host, order="C"))
        return v.to(self._dev).contiguous()

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
        """``{"version": the stable version, "versions": resident}``."""
        with self._store_lock:
            return {"version": self._stable,
                    "versions": sorted(self._stores)}

    def swap_weights(self, arg_params):
        """Install ``arg_params`` (every checkpoint parameter, same shapes)
        as the next weight version and make it the one requests use; aux
        states carry over. Predict programs take weights as arguments, so
        a swap rebuilds none; a generation program reads one version's
        weights, so the new version's are built at their first use, and
        those of versions no longer resident are dropped. Returns the
        version installed."""
        vals = []
        for name, (shape, dtype) in zip(self._param_names,
                                        self._param_specs):
            if name not in arg_params:
                raise ValueError("weight swap is missing param %r" % name)
            v = self._put(arg_params[name]).to(dtype)
            if tuple(v.shape) != shape:
                raise ValueError("weight swap: param %r has shape %r, the "
                                 "engine serves %r"
                                 % (name, tuple(v.shape), shape))
            vals.append(v)
        with self._store_lock:
            v = max(self._stores) + 1
            self._stores[v] = (tuple(vals), self._stores[self._stable][1])
            self._stable = v
            for old in sorted(self._stores)[:-self._KEEP_VERSIONS]:
                del self._stores[old]
            live = {id(p) for p, _a in self._stores.values()}
        self.cache.discard(lambda _k, e: not isinstance(e, GraphProgram)
                           or id(e.params) in live)
        self._note("swaps")
        return v

    def _resolve_store(self, version):
        with self._store_lock:
            v = self._stable if version is None else int(version)
            if v not in self._stores:
                raise ValueError("weight version %d is not resident (have "
                                 "%r)" % (v, sorted(self._stores)))
            params, aux = self._stores[v]
        return params, aux, v

    def store_exact(self, version):
        """``(params, aux)`` of exactly ``version``, or None: a replayed
        sequence that already streamed tokens must never rebind to
        another version."""
        with self._store_lock:
            return self._stores.get(int(version))

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
        the kernels, so that no request pays for either; a generative
        model's prefill menu, decode and adopt programs too, over the
        stable weights (on the card each captured). Returns the number of
        programs."""
        if self._dev.type == "cuda":
            from .._build import build_all
            build_all()
        for b in self._buckets:
            self.program(b)
        n = len(self._buckets)
        if self._gen is not None:
            params, aux, _v = self._resolve_store(None)
            for L in self.gen_prefill_menu():
                self.gen_prefill_program(L, params, aux).prime()
                n += 1
            K = gen_slots()
            state = self.gen_state_init(K)
            self.gen_decode_program(state, params, aux).prime()
            self.gen_adopt_program(K)
            self.gen_state_release(state)
            n += 2
        return n

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

    def _build_gen_prefill(self, L, params, aux):
        """Prompt in (padded to bucket ``L``, batch 1) -> (first greedy
        token, the state rows). The first token comes from the true last
        prompt row, ``length - 1``, so padding never leaks into it."""
        g, dev = self._gen, self._dev
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

        prog = GraphProgram("prefill L=%d" % L, prefill, dev, params,
                             self._side)
        prog.tokens, prog.length = tokens, length
        return prog

    def _build_gen_decode(self, state, params, aux):
        """One decode step over ``state``'s K slots: the next greedy token
        of each slot; the token feed, the positions and the caches
        advanced in place."""
        g = self._gen
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

        return GraphProgram("decode K=%d" % state.slots, decode, self._dev,
                             params, self._side)

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

    def _store_args(self, params, aux):
        if params is None:
            params, aux, _v = self._resolve_store(None)
        return params, aux

    def gen_prefill_program(self, L, param_vals=None, aux_vals=None):
        """The prefill program of bucket ``L`` over a store (the stable one
        by default)."""
        self._require_gen()
        params, aux = self._store_args(param_vals, aux_vals)
        program, _hit = self.cache.get(
            ("gen_prefill", L, id(params)),
            lambda: self._build_gen_prefill(L, params, aux))
        return program

    def gen_decode_program(self, state, param_vals=None, aux_vals=None):
        """The decode program of ``state`` over a store (the stable one by
        default)."""
        self._require_gen()
        params, aux = self._store_args(param_vals, aux_vals)
        program, _hit = self.cache.get(
            ("gen_decode", state.slots, state.serial, id(params)),
            lambda: self._build_gen_decode(state, params, aux))
        return program

    def gen_adopt_program(self, K):
        self._require_gen()
        program, _hit = self.cache.get(
            ("gen_adopt", K), lambda: self._build_gen_adopt(K))
        return program

    def gen_state_init(self, K):
        """A zeroed K-slot decode state for a lane: one released earlier
        (whose programs are still cached) or a new one."""
        self._require_gen()
        with self._gen_lock:
            free = self._gen_free.get(K)
            state = free.pop() if free else None
            if state is None:
                self._gen_serial += 1
                serial = self._gen_serial
        if state is None:
            dev = self._dev
            return GenState(
                torch.zeros((K, 1), dtype=self._dtype, device=dev),
                torch.zeros((K,), dtype=torch.int32, device=dev),
                tuple(torch.zeros((K,) + s, dtype=dt, device=dev)
                      for _n, s, dt, _i in self._gen["states"]),
                serial)
        with torch.no_grad():
            for t in (state.tok, state.pos) + state.states:
                t.zero_()
        return state

    def gen_state_release(self, state):
        """Give a lane's state back when the lane closes."""
        with self._gen_lock:
            self._gen_free.setdefault(state.slots, []).append(state)

    def gen_prefill(self, tokens, param_vals, aux_vals):
        """Prefill one prompt against an explicit store. Returns
        ``(first_token (1,) int32 device tensor, state rows)``; the caller
        reads the token and adopts the rows into a slot before the next
        prefill of the same bucket, which writes them again."""
        self._require_gen()
        arr = _np.asarray(tokens).reshape(-1)
        plen = int(arr.shape[0])
        if plen < 1:
            raise ValueError("empty prompt")
        L = self.gen_bucket_for(plen)
        program = self.gen_prefill_program(L, param_vals, aux_vals)
        padded = _np.zeros((1, L), _np.float32)
        padded[0, :plen] = arr
        program.tokens.copy_(torch.from_numpy(padded))
        program.length.fill_(plen)
        first, rows = program()
        self._note("gen_prefills")
        return first, rows

    def gen_step(self, state, param_vals, aux_vals):
        """One decode step over a lane's state; returns ``(next tokens
        (K,) int32 on the device, state)``, the state advanced in place."""
        self._require_gen()
        nxt = self.gen_decode_program(state, param_vals, aux_vals)()
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
