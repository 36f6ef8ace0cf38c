"""ModelServer: the serving replica of the PyTorch port, on the wire of
``mxtpu``'s (``mxtpu/serving/server.py``).

One replica is one :class:`ModelServer`: for each hosted model an
:class:`~mxtpu_torch.serving.engine.InferenceEngine`, its
:class:`~mxtpu_torch.serving.batcher.DynamicBatcher` and, for a
generative model, its
:class:`~mxtpu_torch.serving.batcher.GenerateScheduler`. The listener is
:mod:`mxtpu_torch.kvstore_async`'s threaded ``_TCPServer`` with its
pickle-5 frames, per-connection pipelining, ``MXTPU_PS_TOKEN`` preamble
and the same-process shortcut (the server registers in the local-server
map, so an in-process client dispatches straight into :meth:`_dispatch`
under the same admission, batching and fault points). The wire is
``mxtpu``'s byte for byte: either package's client talks to either
package's server.

A reply can be withheld (``_NO_REPLY``): an injected ``serve.request``
drop sends nothing, the client's deadline fires, and it replays the
request id on another replica, as after a frame lost on the wire.

Threads and the card: :meth:`start` warms every program (on the card:
builds the kernels and captures the generation graphs, whose capture is
thread-local) before the listener opens; after that only the batchers'
flush threads and the schedulers' threads touch the card. Handler
threads work on numpy and never synchronize the device.

Lifecycle:

* ``start()`` — warm every program, then listen.
* ``drain()`` — stop admissions (a new request gets the retriable
  ``draining`` verdict, steering clients to the other replicas), flush
  everything admitted, return. ``python -m mxtpu_torch.serving`` runs it
  on SIGTERM, then ``stop()``.
* ``stop()`` — sever every conversation before the listener's shutdown
  poll: a stopped replica looks dead to its clients at once.
* ``kill()`` — the fault injector's crash: refuse new conversations now,
  tear down on a side thread.
"""
from __future__ import annotations

import collections
import itertools
import os
import socket
import socketserver
import threading
import time

from .. import fault as _fault
from .. import kvstore_async as _ka
from .. import obs as _obs
from .batcher import DynamicBatcher, GenerateScheduler

# server instruments: every counter is a registry series labelled by
# server instance; stats() reads them back, a `metrics` poll reads the
# same numbers
_SRV_COUNTERS = {
    "requests": _obs.counter(
        "serve.requests", "predict frames admitted or refused",
        ("inst",)),
    "responses": _obs.counter(
        "serve.responses", "ok replies delivered", ("inst",)),
    "shed_overloaded": _obs.counter(
        "serve.shed_overloaded", "requests shed at queue depth",
        ("inst",)),
    "shed_draining": _obs.counter(
        "serve.shed_draining", "requests refused while draining",
        ("inst",)),
    "expired": _obs.counter(
        "serve.expired", "requests expired before dispatch", ("inst",)),
    "dropped": _obs.counter(
        "serve.dropped", "admissions lost to injected drops",
        ("inst",)),
    "dup_requests": _obs.counter(
        "serve.dup_requests", "replayed request ids observed",
        ("inst",)),
    "errors": _obs.counter(
        "serve.errors", "err verdicts returned", ("inst",)),
    "swaps": _obs.counter(
        "serve.swaps", "weight versions installed", ("inst",)),
    "swaps_dropped": _obs.counter(
        "serve.swaps_dropped", "weight records lost to injected drops",
        ("inst",)),
    "rollbacks": _obs.counter(
        "serve.rollbacks", "bit-exact rollbacks executed", ("inst",)),
}
_SRV_REQUEST_MS = _obs.histogram(
    "serve.request_ms",
    "admission-to-reply latency of ok responses", ("model",))
_SRV_INST = itertools.count(1)

__all__ = ["ModelServer", "queue_depth", "batch_deadline_ms",
           "default_budget_ms", "generate_budget_ms"]


class _ModelEntry:
    """One hosted (model, versioned weights) menu: its engine, its own
    dynamic batcher (requests of two models never share a batch), the
    generation scheduler (generative engines only), and the per-version
    response and latency counters the rollout verdict reads."""

    __slots__ = ("name", "engine", "batcher", "scheduler", "lock",
                 "by_version")

    def __init__(self, name, engine, batcher, scheduler=None):
        self.name = name
        self.engine = engine
        self.batcher = batcher
        self.scheduler = scheduler
        self.lock = threading.Lock()
        self.by_version = {}    # version -> responses/errors/latency

    def note(self, version, field, lat_ms=None):
        with self.lock:
            rec = self.by_version.setdefault(
                version, {"responses": 0, "errors": 0, "expired": 0,
                          "lat_ms_sum": 0.0})
            rec[field] += 1
            if lat_ms is not None:
                rec["lat_ms_sum"] += lat_ms

    def version_stats(self):
        with self.lock:
            return {v: dict(rec) for v, rec in self.by_version.items()}


# withheld reply sentinel: the wire handler sends nothing (the client's
# deadline notices); the in-process shortcut returns it verbatim and the
# serving client raises the same ConnectionError the timeout would
_NO_REPLY = ("_no_reply",)


def queue_depth():
    """MXTPU_SERVE_QUEUE_DEPTH: admitted-but-unflushed request bound —
    at depth, new predicts shed with the retriable overloaded verdict."""
    return int(os.environ.get("MXTPU_SERVE_QUEUE_DEPTH", "256"))


def batch_deadline_ms():
    """MXTPU_SERVE_BATCH_DEADLINE_MS: longest a queued request waits
    for batch company before the batcher flushes anyway."""
    return float(os.environ.get("MXTPU_SERVE_BATCH_DEADLINE_MS", "5"))


def default_budget_ms():
    """MXTPU_SERVE_DEADLINE_MS: per-request latency budget applied when
    the client sent none; expired requests are dropped pre-dispatch."""
    return float(os.environ.get("MXTPU_SERVE_DEADLINE_MS", "1000"))


def generate_budget_ms():
    """MXTPU_SERVE_GENERATE_DEADLINE_MS: per-sequence generation budget
    applied when the client sent none — a budget exhausted between
    decode steps frees the slot with the ``expired`` verdict."""
    return float(os.environ.get("MXTPU_SERVE_GENERATE_DEADLINE_MS",
                                "30000"))


class _ServeHandler(socketserver.BaseRequestHandler):
    """One client connection.

    * **Pipelined dispatch.** A predict is admitted, not awaited: the
      loop registers a resolve callback and immediately reads the next
      frame, so one connection's in-flight window (``MXTPU_PS_WINDOW``)
      lands many requests in the same coalesced batch instead of
      serializing them through one handler thread. Replies pair by
      correlation id — the client's ``_Channel`` already handles
      out-of-order completion. A dedicated per-connection sender
      thread writes replies, so a slow client's socket can stall only
      its own connection, never the batcher's flush loop.
    * **Withheld replies.** ``_NO_REPLY`` (an injected
      ``serve.request``/``drop``) sends nothing: the client's per-call
      deadline fires, its window fails, and the request id replays on
      another replica — a dropped request behaves exactly like a frame
      lost on a real wire.

    The transport's fault points: ``server.recv`` fires a frame in the
    read loop, ``server.send`` a reply in the sender (so a sever or kill
    on ``op=predict`` lands after compute: the lost-ack path), a
    streamed token frame included.
    """

    def handle(self):
        server = self.server.owner
        sock = self.request
        with server._active_lock:
            server._active.add(sock)
        import queue as _queue
        out_q = _queue.Queue()
        dead = threading.Event()

        posting = threading.Lock()

        def post(item):
            # counted in the server's unsent replies until sent or lost:
            # a drain also waits for the replies of the work it flushed;
            # a reply to a dead connection is dropped uncounted
            with posting:
                if dead.is_set():
                    return
                server._note_unsent(1)
                out_q.put(item)

        def _send_loop():
            while not dead.is_set():
                try:
                    item = out_q.get(timeout=0.2)
                except _queue.Empty:
                    continue
                if item is None:
                    return
                cid, op, key, reply, more = item
                try:
                    _fault.fire("server.send", op=op, key=key,
                                sock=sock, server=server)
                    # a streamed partial (a generate token) rides as a
                    # "+"-tagged 3-tuple: it does NOT retire the
                    # client's pending slot — only the terminal 2-tuple
                    # reply pairs and releases the window
                    _ka._send_frame(sock, (cid, reply, "+") if more
                                    else (cid, reply))
                except (ConnectionError, EOFError, OSError):
                    server._note_unsent(-1)
                    dead.set()
                    # shutdown before close: close() alone leaves the fd
                    # open under the read loop blocked in recv, so the
                    # client would see no FIN and wait out its deadline
                    for end in (lambda: sock.shutdown(socket.SHUT_RDWR),
                                sock.close):
                        try:
                            end()
                        except OSError:
                            pass
                    return
                server._note_unsent(-1)

        sender = threading.Thread(target=_send_loop, daemon=True,
                                  name="mxtpu-torch-serve-tx")
        sender.start()
        try:
            if server._token:
                import hmac
                expected = _ka._auth_blob(server._token)
                got = _ka._recv_exact(sock, len(expected))
                if not hmac.compare_digest(got, expected):
                    return
            while not dead.is_set():
                frame = _ka._recv_frame(sock)
                cid, msg = frame[0], frame[1]
                # optional third element: a sampled trace context —
                # pure metadata, dropping it can never change a reply
                tctx = frame[2] if len(frame) > 2 else None
                op = msg[0]
                key = msg[1] if len(msg) > 1 and \
                    isinstance(msg[1], (str, int)) else None
                _fault.fire("server.recv", op=op, key=key,
                            sock=sock, server=server)
                if op == "predict":
                    if tctx is None:
                        res = server._admit(msg)
                    else:
                        with _obs.adopt(tctx), \
                                _obs.span("serve.admit", rid=str(key)):
                            res = server._admit(msg, tctx=tctx)
                    if res == _NO_REPLY:
                        continue
                    if isinstance(res, tuple):   # immediate verdict
                        post((cid, op, key, res, False))
                    else:                        # parked: reply at flush
                        res.on_resolve(
                            lambda reply, cid=cid, key=key:
                            post((cid, "predict", key, reply,
                                       False)))
                    continue
                if op == "generate":
                    # the token stream rides the SAME pipelined sender
                    # as every other reply: each generated token becomes
                    # a partial frame, the terminal verdict (repeating
                    # the full token list) pairs the request
                    def _tok(idx, tok, ver, cid=cid, key=key):
                        post((cid, "generate", key,
                                   ("tok", idx, tok, ver), True))
                    if tctx is None:
                        res = server._admit_generate(msg, on_token=_tok)
                    else:
                        with _obs.adopt(tctx), \
                                _obs.span("serve.admit", rid=str(key)):
                            res = server._admit_generate(
                                msg, tctx=tctx, on_token=_tok)
                    if res == _NO_REPLY:
                        continue
                    if isinstance(res, tuple):   # immediate verdict
                        post((cid, op, key, res, False))
                    else:                        # parked: reply at finish
                        res.on_resolve(
                            lambda reply, cid=cid, key=key:
                            post((cid, "generate", key, reply,
                                       False)))
                    continue
                reply = server._dispatch(msg)
                if reply != _NO_REPLY:
                    post((cid, op, key, reply, False))
                if op == "stop":
                    break
        except (ConnectionError, EOFError, OSError):
            pass
        finally:
            out_q.put(None)
            sender.join(timeout=5.0)
            with posting:
                dead.set()
                while True:         # replies the dead connection lost
                    try:
                        item = out_q.get_nowait()
                    except _queue.Empty:
                        break
                    if item is not None:
                        server._note_unsent(-1)
            with server._active_lock:
                server._active.discard(sock)


class ModelServer:
    """One serving replica: model engines, their dynamic batchers and
    generation schedulers behind the serving wire."""

    def __init__(self, engine, port=0, host="127.0.0.1", token=None,
                 replicas=None, model_name="model", queue_depth_=None,
                 batch_deadline_ms_=None, default_budget_ms_=None,
                 weight_dir=None):
        self._model_name = model_name
        self._tcp = _ka._TCPServer((host, port), _ServeHandler)
        self._tcp.owner = self
        self._token = token if token is not None \
            else os.environ.get("MXTPU_PS_TOKEN") or None
        # the replica set this server advertises at hello: itself and its
        # peers (MXTPU_SERVE_ADDRS): how clients learn where to fail over
        if replicas is None:
            replicas = [a.strip() for a in
                        os.environ.get("MXTPU_SERVE_ADDRS", "").split(",")
                        if a.strip()]
        self._replicas = list(replicas)
        if self.address not in self._replicas:
            self._replicas.insert(0, self.address)
        self._depth = queue_depth() if queue_depth_ is None \
            else int(queue_depth_)
        self._deadline_ms = batch_deadline_ms() \
            if batch_deadline_ms_ is None else float(batch_deadline_ms_)
        self._budget_ms = default_budget_ms() \
            if default_budget_ms_ is None else float(default_budget_ms_)
        # N hosted (model, version) menus; the ctor engine is the
        # default model every 4-tuple predict frame routes to
        self._models = {}
        self._models_lock = threading.Lock()
        self._models[model_name] = _ModelEntry(
            model_name, engine,
            DynamicBatcher(engine, self._depth, self._deadline_ms,
                           server=self),
            self._make_scheduler(engine))
        # versioned weight snapshots (rollback source): the replica
        # reads the SAME directory the publisher writes
        if weight_dir is None:
            weight_dir = os.environ.get("MXTPU_SERVE_WEIGHT_DIR") or None
        self._weight_dir = weight_dir
        self._weight_ckpt = None
        if weight_dir:
            from ..checkpoint import CheckpointManager
            self._weight_ckpt = CheckpointManager(
                weight_dir, max_to_keep=0, async_save=False,
                use_orbax=False)
        self._draining = False
        # the lifecycle epoch: bumped on every drain/resume transition
        # and carried by ping verdicts, so a client that receives a
        # delayed probe reply can tell it is stale evidence and must not
        # demote a healthy replica on it
        self._serve_epoch = 1
        self._c_lock = threading.Lock()
        # registry-backed counters (stats() reads them back); the lock
        # stays for the rid-dedupe window below
        inst = "m%d" % next(_SRV_INST)
        self._c = {f: m.labels(inst) for f, m in _SRV_COUNTERS.items()}
        self._view_key = None
        # the request-id window (observability, not correctness: predict
        # is pure, a replay recomputes the same bits), bounded
        self._seen_rids = collections.OrderedDict()
        self._seen_max = 4096
        self._active = set()
        self._active_lock = threading.Lock()
        # replies queued on connections and not yet sent (drain waits)
        self._unsent = 0
        self._unsent_cv = threading.Condition()
        self._thread = None

    # -- lifecycle ---------------------------------------------------------
    @property
    def address(self):
        h, p = self._tcp.server_address
        return "%s:%d" % (h, p)

    @property
    def _engine(self):
        """The default model's engine (single-model back-compat)."""
        return self._models[self._model_name].engine

    @property
    def _batcher(self):
        return self._models[self._model_name].batcher

    def _entries(self):
        with self._models_lock:
            return list(self._models.values())

    def _entry_for(self, model):
        name = self._model_name if model is None else model
        with self._models_lock:
            return self._models.get(name)

    def add_model(self, name, engine):
        """Host another (model, versioned-weights) menu next to the
        default one; clients route with ``predict(..., model=name)``.
        The new menu gets its own batcher, so its versions never
        coalesce with another model's batches."""
        with self._models_lock:
            if name in self._models:
                raise ValueError("model %r is already hosted" % (name,))
            self._models[name] = _ModelEntry(
                name, engine,
                DynamicBatcher(engine, self._depth, self._deadline_ms,
                               server=self),
                self._make_scheduler(engine))
        if self._thread is not None:
            engine.warm()

    def _make_scheduler(self, engine):
        """A continuous :class:`GenerateScheduler` for a generative
        engine (one whose symbol declares the KV-cache/pos contract);
        classic one-shot models host no scheduler and refuse
        ``generate`` with an err verdict."""
        if not engine.is_generative:
            return None
        return GenerateScheduler(engine, self._depth, server=self)

    def start(self):
        """Warm every hosted engine (this thread builds the kernels and
        captures the graphs), then open the listener."""
        for entry in self._entries():
            entry.engine.warm()
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, daemon=True,
            name="mxtpu-torch-serve-listener")
        self._thread.start()
        with _ka._LOCAL_GUARD:
            # same-process clients skip socket+pickle, same dispatch
            _ka._LOCAL_SERVERS[self.address] = self
        if self._view_key is None:
            self._view_key = _obs.view("serving.server",
                                       self._metrics_view)
        return self

    def _metrics_view(self):
        """The replica's registry view: the draining flag and each
        model's engine, batcher and per-version evidence."""
        models = {}
        for entry in self._entries():
            row = {"engine": entry.engine.stats(),
                   "batcher": entry.batcher.stats(),
                   "by_version": entry.version_stats()}
            if entry.scheduler is not None:
                row["scheduler"] = entry.scheduler.stats()
            models[entry.name] = row
        return {"address": self.address, "draining": self._draining,
                "queue_depth": self._depth, "models": models}

    def _set_draining(self, flag):
        """Flip the draining verdict, minting a new lifecycle epoch on
        every transition — the monotone stamp ping verdicts carry."""
        if self._draining != flag:
            # transitions run on the control path only; a ping reads the
            # monotone stamp without a lock (a stale read is the verdict
            # before the transition)
            self._serve_epoch += 1
        self._draining = flag

    def drain(self, timeout=30.0):
        """Graceful phase: refuse new work, flush admitted work and send
        its replies."""
        deadline = time.monotonic() + timeout
        self._set_draining(True)
        ok = True
        for entry in self._entries():
            ok = entry.batcher.drain(timeout=timeout) and ok
            if entry.scheduler is not None:
                ok = entry.scheduler.drain(timeout=timeout) and ok
        with self._unsent_cv:
            while self._unsent > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._unsent_cv.wait(min(0.1, left))
        return ok

    def _note_unsent(self, n):
        with self._unsent_cv:
            self._unsent += n
            if self._unsent <= 0:
                self._unsent_cv.notify_all()

    def resume(self):
        """Re-open admissions after a drain (the hot swap's drain, swap,
        resume): drained batchers and schedulers are replaced (their
        threads exited), then the draining verdict stops."""
        for entry in self._entries():
            if entry.batcher._stopped:
                entry.batcher.release_metrics()
                entry.batcher = DynamicBatcher(
                    entry.engine, self._depth, self._deadline_ms,
                    server=self)
            if entry.scheduler is not None and entry.scheduler._stopped:
                entry.scheduler.release_metrics()
                entry.scheduler = self._make_scheduler(entry.engine)
        self._set_draining(False)
        return True

    def stop(self):
        self._set_draining(True)
        self._tcp.dying = True
        if self._view_key is not None:
            _obs.REGISTRY.unview(self._view_key)
            self._view_key = None
        for s in self._c.values():
            s.drop()
        for entry in self._entries():
            entry.batcher.stop()
            if entry.scheduler is not None:
                entry.scheduler.stop()
        with _ka._LOCAL_GUARD:
            if _ka._LOCAL_SERVERS.get(self.address) is self:
                del _ka._LOCAL_SERVERS[self.address]
        # sever established conversations before the listener's
        # shutdown poll: a dead replica must look dead now (failover
        # latency is what the client sees)
        with self._active_lock:
            active = list(self._active)
        for s in active:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        if self._thread is not None:
            self._tcp.shutdown()
        self._tcp.server_close()

    def kill(self):
        """Crash as the fault injector (kind=kill) sees it: refuse new
        conversations from this instant, full teardown on the side."""
        self._tcp.dying = True
        threading.Thread(target=self.stop, daemon=True).start()

    # -- dispatch ----------------------------------------------------------
    def _note_rid(self, rid):
        with self._c_lock:
            dup = rid in self._seen_rids
            if dup:
                self._seen_rids.move_to_end(rid)
            else:
                self._seen_rids[rid] = True
                while len(self._seen_rids) > self._seen_max:
                    self._seen_rids.popitem(last=False)
        if dup:
            self._c["dup_requests"].inc()
        return dup

    def _bump(self, field, n=1):
        self._c[field].inc(n)

    def _account_reply(self, reply, entry=None, req=None, arrival=None):
        if reply[0] == "ok":
            self._c["responses"].inc()
        elif reply[0] == "expired":
            self._c["expired"].inc()
        else:
            self._c["errors"].inc()
        if entry is None or req is None:
            return
        # per-(model, version) accounting — what the rollout verdict
        # compares canary vs stable on
        if reply[0] == "ok":
            v = reply[2].get("version") if len(reply) > 2 and \
                isinstance(reply[2], dict) else req.version
            lat = None if arrival is None \
                else (time.monotonic() - arrival) * 1e3
            if lat is not None:
                # the serve.request latency histogram: p50/p99 per
                # model for mxtop / bench_serving / the controller
                _SRV_REQUEST_MS.labels(entry.name).observe(lat)
            entry.note(v, "responses", lat_ms=lat)
        elif reply[0] == "expired":
            entry.note(req.version, "expired")
        else:
            entry.note(req.version, "errors")

    def _admit(self, msg, tctx=None):
        """Admission control for one ``("predict", rid, arrays,
        budget_ms[, model])`` frame. Returns an immediate verdict tuple
        (shed/draining/err), ``_NO_REPLY`` (injected drop), or the
        parked :class:`~mxtpu.serving.batcher.Request` whose terminal
        reply arrives at batch flush. rid is the client's (origin, seq)
        identity; a failover replay carries the original rid. The
        request's weight version is resolved here (stable, or the canary
        split hashed on rid), so its whole batch answers from one store.
        ``tctx`` (a sampled trace that rode the frame) parks with the
        request so the batch flush continues the trace; it never changes
        the answer."""
        rid, arrays, budget_ms = msg[1], msg[2], msg[3]
        model = msg[4] if len(msg) > 4 else None
        arrival = time.monotonic()
        self._bump("requests")
        self._note_rid(rid)
        # admission-point fault hook: delay burns request budget
        # (deadline-expiry drills), drop loses the admitted request
        # without a reply (the client's deadline + replay path)
        act = _fault.fire("serve.request", op="predict", key=rid,
                          server=self)
        if act == "drop":
            self._bump("dropped")
            return _NO_REPLY
        if self._draining or self._tcp.dying:
            self._bump("shed_draining")
            return ("draining", {"replicas": self._replicas})
        entry = self._entry_for(model)
        if entry is None:
            self._bump("errors")
            return ("err", "unknown model %r (hosting %r)"
                    % (model, sorted(self._models)))
        try:
            rows = entry.engine.check_rows(arrays)
        except ValueError as e:
            self._bump("errors")
            return ("err", "bad predict payload: %s" % e)
        budget = self._budget_ms if budget_ms is None else float(budget_ms)
        deadline = arrival + budget / 1000.0
        # the park bound: budget + batch window + a flush allowance (an
        # injected mid-batch kill resolves every parked request, so the
        # bound only matters for genuine flusher bugs)
        req = entry.batcher.submit(
            rid, arrays, rows, deadline,
            wait_bound=(budget / 1000.0 + self._deadline_ms / 1000.0
                        + _FLUSH_GRACE),
            version=entry.engine.route_version(rid), tctx=tctx)
        if isinstance(req, tuple):          # shed verdict, not parked
            self._bump("shed_overloaded")
            return req
        req.on_resolve(lambda reply, e=entry, r=req, a=arrival:
                       self._account_reply(reply, e, r, a))
        return req

    def _admit_generate(self, msg, tctx=None, on_token=None):
        """Admission control for one ``("generate", rid, tokens, opts)``
        frame — the stateful-sequence sibling of :meth:`_admit` with the
        SAME verdict surface (drop/draining/overloaded/err) and the same
        rid identity for exactly-once replay accounting. ``opts`` keys:
        ``max_new``, ``budget_ms``, ``eos_id``, ``model``, ``version``
        (a failover replay pins the version its first answer streamed
        from; a pinned version no longer resident is an err, since a
        silent rebind would tear the sequence). The weight version
        resolves here, once, at admission: a swap mid-sequence never
        mixes versions within one sequence. ``on_token`` streams
        each generated token (scheduler thread) — the wire handler turns
        them into partial frames on the pipelined sender."""
        rid, tokens = msg[1], msg[2]
        opts = msg[3] if len(msg) > 3 and msg[3] is not None else {}
        model = opts.get("model")
        arrival = time.monotonic()
        self._bump("requests")
        self._note_rid(rid)
        act = _fault.fire("serve.request", op="generate", key=rid,
                          server=self)
        if act == "drop":
            self._bump("dropped")
            return _NO_REPLY
        if self._draining or self._tcp.dying:
            self._bump("shed_draining")
            return ("draining", {"replicas": self._replicas})
        entry = self._entry_for(model)
        if entry is None:
            self._bump("errors")
            return ("err", "unknown model %r (hosting %r)"
                    % (model, sorted(self._models)))
        if entry.scheduler is None:
            self._bump("errors")
            return ("err", "model %r is not generative — its symbol "
                    "declares no KV-cache/pos contract" % (entry.name,))
        budget = opts.get("budget_ms")
        budget = generate_budget_ms() if budget is None else float(budget)
        deadline = arrival + budget / 1000.0
        pinned = opts.get("version") is not None
        version = opts["version"] if pinned \
            else entry.engine.route_version(rid)
        req = entry.scheduler.submit(
            rid, tokens, opts.get("max_new", 64), deadline,
            wait_bound=budget / 1000.0 + _FLUSH_GRACE,
            version=version, pinned=pinned, eos_id=opts.get("eos_id"),
            on_token=on_token, tctx=tctx)
        if isinstance(req, tuple):          # shed/err verdict
            if req[0] == "overloaded":
                self._bump("shed_overloaded")
            elif req[0] == "draining":
                self._bump("shed_draining")
            else:
                self._bump("errors")
            return req
        req.on_resolve(lambda reply, e=entry, r=req, a=arrival:
                       self._account_reply(reply, e, r, a))
        return req

    # -- live weight deployment --------------------------------------------
    def swap_weights(self, arg_params, aux_params=None, version=None,
                     digest=None, model=None):
        """Install one streamed weight version into a hosted model: the
        one choke point every weight source (the snapshot poller, the
        ``weights_push`` wire op) goes through, so the ``serve.swap``
        fault point covers them all.
        Returns the installed version, or None when the record was
        dropped/refused (the replica keeps answering from the last
        complete version)."""
        entry = self._entry_for(model)
        if entry is None:
            raise ValueError("unknown model %r (hosting %r)"
                             % (model, sorted(self._models)))
        # mid-swap fault hook: drop loses this version record (the next
        # one lands normally), kill is the kill-replica-mid-swap drill
        act = _fault.fire("serve.swap", op="swap",
                          key="v%s" % (version,), server=self)
        if act == "drop":
            self._bump("swaps_dropped")
            return None
        v = entry.engine.swap_weights(arg_params, aux_params,
                                      version=version, digest=digest)
        if v is not None:
            self._bump("swaps")
        return v

    def _ensure_resident(self, entry, version):
        """Make ``version`` a resident store (restore it from the
        versioned weight snapshot when it aged out of memory), digest-
        verified either way. Returns the restore source."""
        version = int(version)
        recorded = self._weight_ckpt.digest(version) \
            if self._weight_ckpt is not None else None
        state = entry.engine.version_state()
        if version in state["versions"]:
            if recorded is not None and \
                    entry.engine.store_digest(version) != recorded:
                raise ValueError(
                    "resident version %d does not match its recorded "
                    "digest — refusing to route to corrupt weights"
                    % version)
            return "resident"
        if self._weight_ckpt is None:
            raise ValueError(
                "version %d is not resident and no weight dir is "
                "configured (MXTPU_SERVE_WEIGHT_DIR)" % version)
        tree = self._weight_ckpt.restore_exact(version)
        if tree is None:
            raise ValueError("version %d has no retained snapshot "
                             "in %s" % (version, self._weight_dir))
        entry.engine.load_store(tree["params"], version,
                                digest=recorded)
        return "snapshot"

    def rollback(self, version, model=None):
        """Bit-exact rollback: route back to ``version`` (its resident
        store, else restored from the versioned weight snapshot,
        ``MXTPU_SERVE_WEIGHT_DIR``), verified against the digest the
        publisher recorded, then pinned (streamed swaps keep landing but
        stop becoming stable until unpinned)."""
        entry = self._entry_for(model)
        if entry is None:
            raise ValueError("unknown model %r (hosting %r)"
                             % (model, sorted(self._models)))
        version = int(version)
        src = self._ensure_resident(entry, version)
        entry.engine.pin(version)
        self._bump("rollbacks")
        return {"version": version, "source": src,
                "digest": entry.engine.store_digest(version)}

    def _do_predict(self, msg):
        """Blocking form for the in-process shortcut (each caller is
        its own thread, so concurrent local predicts still coalesce)."""
        res = self._admit(msg)
        if res == _NO_REPLY or isinstance(res, tuple):
            return res
        return res.wait(res.wait_bound)

    def _do_generate(self, msg, on_token=None):
        """Blocking form of generate: admit, then park until the
        terminal verdict. Without ``on_token`` the per-token stream is
        simply not observed — the terminal ``ok`` repeats the full
        token list, so nothing is lost."""
        res = self._admit_generate(msg, on_token=on_token)
        if res == _NO_REPLY or isinstance(res, tuple):
            return res
        return res.wait(res.wait_bound)

    def stats(self):
        counters = {f: s.value for f, s in self._c.items()}
        models = {}
        for entry in self._entries():
            row = {"engine": entry.engine.stats(),
                   "batcher": entry.batcher.stats(),
                   "weights": entry.engine.version_state(),
                   "by_version": entry.version_stats()}
            if entry.scheduler is not None:
                row["scheduler"] = entry.scheduler.stats()
            models[entry.name] = row
        return {"address": self.address, "model": self._model_name,
                "draining": self._draining, "replicas": self._replicas,
                "queue_depth": self._depth,
                "batch_deadline_ms": self._deadline_ms,
                "counters": counters,
                "batcher": self._batcher.stats(),
                "engine": self._engine.stats(),
                "models": models}

    def _dispatch(self, msg):
        cmd = msg[0]
        if cmd == "predict":
            return self._do_predict(msg)
        if cmd == "generate":
            # non-streaming fallback (plain request transport): the
            # terminal reply carries the whole token list
            return self._do_generate(msg)
        if cmd == "hello":
            # clients learn the replica set and the hosted menus
            # (signatures and weight-version state) here
            models = {entry.name: {
                "signature": entry.engine.signature(),
                "weights": entry.engine.version_state()}
                for entry in self._entries()}
            return ("ok", {"model": self._model_name,
                           "replicas": self._replicas,
                           "draining": self._draining,
                           "queue_depth": self._depth,
                           "batch_deadline_ms": self._deadline_ms,
                           "default_budget_ms": self._budget_ms,
                           "signature": self._engine.signature(),
                           "models": models})
        if cmd == "ping":
            # the probe verdict carries the lifecycle epoch: clients
            # ignore any reply stamped older than one they have seen
            return ("ok", {"draining": self._draining,
                           "epoch": self._serve_epoch,
                           "pending": sum(
                               e.batcher.pending()
                               + (e.scheduler.pending()
                                  if e.scheduler is not None else 0)
                               for e in self._entries())})
        if cmd == "stats":
            return ("ok", self.stats())
        if cmd == "metrics":
            # this process's whole registry snapshot, on the same
            # transport, auth and verdicts as every other op
            return ("ok", _obs.REGISTRY.snapshot())
        if cmd == "drain":
            # the operator's hook: the same two-phase path as SIGTERM
            self._set_draining(True)
            for entry in self._entries():
                threading.Thread(target=entry.batcher.drain, kwargs={
                    "timeout": float(msg[1]) if len(msg) > 1 else 30.0},
                    daemon=True).start()
                if entry.scheduler is not None:
                    threading.Thread(
                        target=entry.scheduler.drain, kwargs={
                            "timeout": float(msg[1]) if len(msg) > 1
                            else 30.0},
                        daemon=True).start()
            return ("ok", {"draining": True})
        if cmd == "resume":
            # the hot swap's exit: drain, swap, resume
            return ("ok", {"draining": not self.resume()})
        if cmd == "weights_push":
            # ("weights_push", model, version, params, aux, digest): a
            # publisher lands a version straight on the replica
            _, model, version, params, aux, digest = msg
            try:
                v = self.swap_weights(params, aux, version=version,
                                      digest=digest, model=model)
            except ValueError as e:
                return ("err", "weight swap refused — %s" % e)
            entry = self._entry_for(model)
            return ("ok", {"version": v,
                           "weights": entry.engine.version_state()})
        if cmd == "rollout":
            # ("rollout", model, action, kwargs): the operator surface
            # RolloutController drives across the replicas
            return self._do_rollout(msg)
        if cmd == "stop":
            threading.Thread(target=self.stop, daemon=True).start()
            return ("ok",)
        return ("err", "unknown serving command %r" % (cmd,))

    def _dispatch_stream(self, msg, emit):
        """Streaming dispatch for the in-process shortcut
        (``_ServerConn._local_stream``): a ``generate`` streams each
        token through ``emit`` as a partial reply, as the wire handler's
        "+"-tagged frames; every other command answers as
        :meth:`_dispatch`."""
        if msg[0] == "generate":
            return self._do_generate(
                msg, on_token=lambda idx, tok, ver:
                emit(("tok", idx, tok, ver)))
        return self._dispatch(msg)

    def _do_rollout(self, msg):
        _, model, action, kw = msg
        kw = kw or {}
        entry = self._entry_for(model)
        if entry is None:
            return ("err", "unknown model %r (hosting %r)"
                    % (model, sorted(self._models)))
        try:
            if action == "canary":
                if kw.get("version") is not None:
                    self._ensure_resident(entry, kw["version"])
                entry.engine.set_canary(kw.get("version"),
                                        kw.get("fraction", 0.0))
            elif action == "promote":
                if kw.get("version") is not None:
                    self._ensure_resident(entry, kw["version"])
                entry.engine.promote(kw.get("version"))
            elif action == "abort":
                entry.engine.abort_canary()
            elif action == "pin":
                self._ensure_resident(entry, kw["version"])
                entry.engine.pin(kw["version"])
            elif action == "unpin":
                entry.engine.unpin()
            elif action == "rollback":
                self.rollback(kw["version"], model=model)
            elif action != "status":
                return ("err", "unknown rollout action %r" % (action,))
        except (ValueError, KeyError) as e:
            return ("err", "rollout %s refused — %s" % (action, e))
        return ("ok", {"weights": entry.engine.version_state(),
                       "by_version": entry.version_stats()})


# extra seconds a parked handler waits past (budget + batch window) for
# its flush before declaring the flusher stalled
_FLUSH_GRACE = float(os.environ.get("MXTPU_SERVE_FLUSH_GRACE", "30"))
