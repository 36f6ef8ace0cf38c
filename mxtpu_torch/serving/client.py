"""ServingClient: a replica-set client with in-place failover, on the
wire of ``mxtpu``'s (``mxtpu/serving/client.py``).

One client holds a :class:`~mxtpu_torch.kvstore_async._ServerConn` per
replica (retries, pipelined windows, the same-process shortcut), sends
every request to the active replica, and on a failed window
health-probes it and fails over in place. Replicas are symmetric (each
loaded the same checkpoint), so failover is a route change.

Exactly once is the client's contract: every request carries a
``(origin, seq)`` request id, a replay after a failure carries the
original id, and the client delivers one terminal outcome per id.
Predict is a pure function of the weights, so a replay answered by
another replica gives the bits the dead one would have given. A
generation replay pins the weight version of the first token frame and
drops the token indices already delivered, so ``on_token`` sees every
index once, in order.

Terminal outcomes:

* the output arrays (success);
* :class:`Overloaded` — every live replica shed the request (queue at
  depth) or is draining; retriable (``retriable`` is True);
* :class:`DeadlineExceeded` — the budget expired before dispatch (or,
  for generation, between decode steps);
* ``ConnectionError`` — no replica reachable;
* ``RuntimeError`` — a server's error verdict (a bad payload).
"""
from __future__ import annotations

import itertools
import os
import threading
import uuid

import numpy as _np

from .. import kvstore_async as _ka
from .. import obs as _obs

__all__ = ["ServingClient", "Overloaded", "DeadlineExceeded"]

# extra reply-wait seconds past the request budget before the client
# declares the window dead and fails over
_CLIENT_GRACE = float(os.environ.get("MXTPU_SERVE_CLIENT_GRACE", "30"))


class Overloaded(RuntimeError):
    """Every replica shed this request (queue at depth / draining).
    Retriable by contract: back off and resubmit — same semantics as
    the kvstore's buffered-push path, but surfaced to the caller
    because serving latency budgets make silent queueing wrong."""
    retriable = True

    def __init__(self, msg, verdicts=None):
        super().__init__(msg)
        self.verdicts = verdicts or []


class DeadlineExceeded(RuntimeError):
    """The request's budget expired before its batch dispatched. Not
    retriable with the same deadline — the budget is gone."""
    retriable = False


def _default_budget_ms():
    return float(os.environ.get("MXTPU_SERVE_DEADLINE_MS", "1000"))


def _default_generate_budget_ms():
    # generation budgets the whole multi-step sequence, so its default
    # (MXTPU_SERVE_GENERATE_DEADLINE_MS) is far larger than predict's
    return float(os.environ.get("MXTPU_SERVE_GENERATE_DEADLINE_MS",
                                "30000"))


class ServingClient:
    """One application's view of a serving replica set."""

    def __init__(self, addrs=None, token=None, budget_ms=None,
                 connect_timeout=30.0):
        if addrs is None:
            addrs = [a.strip() for a in
                     os.environ.get("MXTPU_SERVE_ADDRS", "").split(",")
                     if a.strip()]
        if isinstance(addrs, str):
            addrs = [a.strip() for a in addrs.split(",") if a.strip()]
        if not addrs:
            raise ValueError("no serving replicas: pass addrs= or set "
                             "MXTPU_SERVE_ADDRS")
        self._token = token if token is not None \
            else os.environ.get("MXTPU_PS_TOKEN") or None
        self._budget_ms = _default_budget_ms() if budget_ms is None \
            else float(budget_ms)
        self._connect_timeout = float(connect_timeout)
        self._origin = uuid.uuid4().hex[:12]
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        self._addrs = list(addrs)
        self._conns = {}               # addr -> _ServerConn (lazy)
        self._active_i = 0
        self._stats = _ka._CommStats()
        self._c = {"requests": 0, "responses": 0, "replays": 0,
                   "failovers": 0, "shed": 0, "expired": 0}
        self.signature = None
        self.model = None
        self.models = {}           # hosted menus learned at hello
        # the newest lifecycle epoch seen a replica: a probe verdict
        # stamped older is stale evidence (a delayed reply) and never
        # demotes
        self._addr_epoch = {}
        # sampled request tracing (MXTPU_TRACE_SAMPLE): a sampled request
        # opens a trace whose context rides the wire frame (client
        # request, server admit, batch dispatch: one timeline)
        self._tracer = _obs.Sampler()

    # -- replica plumbing --------------------------------------------------
    def _conn_for(self, addr, connect_timeout=None):
        with self._lock:
            conn = self._conns.get(addr)
        if conn is not None:
            return conn
        conn = _ka._ServerConn(
            addr, token=self._token, stats=self._stats,
            connect_timeout=self._connect_timeout
            if connect_timeout is None else connect_timeout)
        with self._lock:
            # another thread made one first: use (and keep) it
            existing = self._conns.get(addr)
            if existing is not None:
                return existing
            self._conns[addr] = conn
        return conn

    def _active(self):
        with self._lock:
            return self._active_i, self._addrs[self._active_i]

    def _fail_over(self, from_i):
        """Advance the active index past ``from_i`` (idempotent under
        racing threads: only the first mover swaps)."""
        with self._lock:
            if self._active_i == from_i and len(self._addrs) > 1:
                self._active_i = (from_i + 1) % len(self._addrs)
                self._c["failovers"] += 1
                return True
        return False

    def _bump(self, field, n=1):
        with self._lock:
            self._c[field] += n

    def hello(self):
        """Greet the replica set: learn the full replica list, the
        model signature and the server's batching knobs from whichever
        replica answers first."""
        last = None
        for i in range(len(self._addrs)):
            addr = self._addrs[(self._active_i + i) % len(self._addrs)]
            try:
                conn = self._conn_for(addr)
                reply = conn.request("hello", self._origin, timeout=10.0)
            except (ConnectionError, OSError, RuntimeError) as e:
                last = e
                continue
            info = reply[1]
            with self._lock:
                for a in info.get("replicas", []):
                    if a not in self._addrs:
                        self._addrs.append(a)
            self.signature = info.get("signature")
            self.model = info.get("model")
            self.models = info.get("models", {})
            return info
        raise ConnectionError("no serving replica answered hello: %s"
                              % (last,))

    # -- the predict path --------------------------------------------------
    def _request_timeout(self, budget_ms):
        # reply can legally take budget + batch window + flush; anything
        # past that is a dead/stalled replica and the window must fail
        return budget_ms / 1000.0 + _CLIENT_GRACE

    def predict(self, arrays, budget_ms=None, model=None):
        """One predict: returns the list of output arrays (rows match
        the request). ``arrays`` is one numpy array (single-input
        models) or a list/tuple in the server's ``data_names`` order.
        ``model`` routes to a non-default hosted menu by id.
        A connection-level failure health-probes the active replica
        and replays the SAME request id on the next one."""
        outs, _info = self.predict2(arrays, budget_ms=budget_ms,
                                    model=model)
        return outs

    def predict2(self, arrays, budget_ms=None, model=None):
        """:meth:`predict` plus the reply's info dict — notably
        ``info["version"]``, the weight version that answered (what
        the rollout drills key their per-version evidence on)."""
        if not self._tracer.sample():
            return self._predict2_impl(arrays, budget_ms, model)
        tok = _obs.start_trace()
        try:
            with _obs.span("serve.client.request"):
                return self._predict2_impl(arrays, budget_ms, model)
        finally:
            _obs.end_trace(tok)

    def _predict2_impl(self, arrays, budget_ms=None, model=None):
        if isinstance(arrays, _np.ndarray):
            arrays = (arrays,)
        arrays = tuple(_np.ascontiguousarray(a) for a in arrays)
        budget = self._budget_ms if budget_ms is None else float(budget_ms)
        rid = "%s:%d" % (self._origin, next(self._seq))
        self._bump("requests")
        timeout = self._request_timeout(budget)
        verdicts, last_err = [], None
        with self._lock:
            n_replicas = len(self._addrs)
        for attempt in range(n_replicas + 1):
            i, addr = self._active()
            if any(a == addr for a, _, _ in verdicts):
                # rotation came back to a shed replica: one that said
                # "draining" may have resumed since (a rolling hot swap
                # drains the replicas in turn), so it is probed first
                if not self._resumed(addr, verdicts):
                    break
                verdicts = [v for v in verdicts if v[0] != addr]
            if attempt:
                self._bump("replays")
            try:
                conn = self._conn_for(addr)
                if model is None:       # wire-compatible 4-tuple
                    reply = conn.request("predict", rid, arrays, budget,
                                         timeout=timeout, retries=0)
                else:
                    reply = conn.request("predict", rid, arrays, budget,
                                         model, timeout=timeout,
                                         retries=0)
            except (ConnectionError, OSError) as e:
                last_err = e
                # health-probe before abandoning the replica: a severed
                # window on a live server is replayed in place, a dead
                # server fails over
                if self._probe(addr):
                    continue       # alive: replay rid on the same route
                self._fail_over(i)
                continue
            except RuntimeError as e:
                # server-side err verdicts that really mean "this
                # replica is going away mid-batch" re-route like a
                # connection failure; anything else is the caller's
                if "replica failed mid-batch" in str(e) \
                        or "server stopped" in str(e):
                    last_err = e
                    self._fail_over(i)
                    continue
                raise
            verdict = reply[0]
            if verdict == "ok":
                self._bump("responses")
                info = reply[2] if len(reply) > 2 and \
                    isinstance(reply[2], dict) else {}
                # the request identity rides the info dict
                info.setdefault("rid", rid)
                return list(reply[1]), info
            if verdict == "_no_reply":
                # the in-process shortcut's rendering of a withheld
                # reply (injected drop): same replay the wire timeout
                # would trigger, without waiting out the clock
                last_err = ConnectionError("request %s dropped" % rid)
                self._fail_over(i)
                continue
            if verdict == "expired":
                self._bump("expired")
                raise DeadlineExceeded(
                    "request %s expired before dispatch (budget %.0fms, "
                    "%.1fms late)" % (rid, budget,
                                      reply[1].get("late_ms", 0.0)))
            if verdict in ("overloaded", "draining"):
                # retriable shed: note it, try the next replica once —
                # if the whole set sheds (or there is no other
                # replica), surface Overloaded to the caller's backoff
                verdicts.append((addr, verdict, reply[1]))
                if not self._fail_over(i):
                    break
                continue
            raise RuntimeError("unexpected predict verdict %r" % (reply,))
        if verdicts:
            self._bump("shed")
            raise Overloaded(
                "request %s shed by all replicas: %s"
                % (rid, [(a, v) for a, v, _ in verdicts]),
                verdicts=verdicts)
        raise ConnectionError(
            "request %s failed on every replica: %s" % (rid, last_err))

    # -- the generate path -------------------------------------------------
    def generate(self, tokens, max_new=64, budget_ms=None, model=None,
                 eos_id=None, on_token=None):
        """Autoregressive generation: returns the generated token list.
        ``tokens`` is the 1-D int prompt; ``on_token(idx, tok, version)``
        (optional) fires per streamed token, in order, exactly once —
        even across a replica failover mid-sequence."""
        toks, _info = self.generate2(tokens, max_new=max_new,
                                     budget_ms=budget_ms, model=model,
                                     eos_id=eos_id, on_token=on_token)
        return toks

    def generate2(self, tokens, max_new=64, budget_ms=None, model=None,
                  eos_id=None, on_token=None):
        """:meth:`generate` plus the terminal info dict — notably
        ``info["version"]`` (the one weight version the WHOLE sequence
        answered from) and ``info["reason"]`` (``eos``/``len``)."""
        if not self._tracer.sample():
            return self._generate2_impl(tokens, max_new, budget_ms,
                                        model, eos_id, on_token)
        tok = _obs.start_trace()
        try:
            with _obs.span("serve.client.generate"):
                return self._generate2_impl(tokens, max_new, budget_ms,
                                            model, eos_id, on_token)
        finally:
            _obs.end_trace(tok)

    def _generate2_impl(self, tokens, max_new, budget_ms, model,
                        eos_id, on_token):
        """Exactly-once streaming with in-place failover.

        The client pins the weight version from the first token frame it
        sees; a replay after a connection failure carries the original
        rid and that pinned version, so the surviving replica
        regenerates the same deterministic sequence and the index dedupe
        below turns the replayed prefix into no-ops: the caller's
        ``on_token`` sees every index once, in order. Tokens whose
        partial frames were dropped are recovered from the terminal
        ``ok`` reply (which repeats the full list)."""
        prompt = _np.ascontiguousarray(
            _np.asarray(tokens, _np.int32).reshape(-1))
        budget = _default_generate_budget_ms() if budget_ms is None \
            else float(budget_ms)
        rid = "%s:%d" % (self._origin, next(self._seq))
        self._bump("requests")
        timeout = self._request_timeout(budget)
        out_tokens = []
        pinned = [None]            # version from the first token frame
        plock = threading.Lock()

        def _on_partial(reply):
            if not isinstance(reply, tuple) or len(reply) != 4 \
                    or reply[0] != "tok":
                return
            _, idx, tok, ver = reply
            with plock:
                if pinned[0] is None:
                    pinned[0] = ver
                if idx != len(out_tokens):
                    return     # replayed/duplicated frame: already have it
                out_tokens.append(int(tok))
            if on_token is not None:
                on_token(idx, int(tok), ver)

        verdicts, last_err = [], None
        with self._lock:
            n_replicas = len(self._addrs)
        for attempt in range(n_replicas + 1):
            i, addr = self._active()
            if any(a == addr for a, _, _ in verdicts):
                # rotation came back to a shed replica: one that said
                # "draining" may have resumed since (a rolling hot swap
                # drains the replicas in turn), so it is probed first
                if not self._resumed(addr, verdicts):
                    break
                verdicts = [v for v in verdicts if v[0] != addr]
            if attempt:
                self._bump("replays")
            opts = {"max_new": int(max_new), "budget_ms": budget}
            if eos_id is not None:
                opts["eos_id"] = int(eos_id)
            if model is not None:
                opts["model"] = model
            with plock:
                if pinned[0] is not None:
                    opts["version"] = pinned[0]
            try:
                conn = self._conn_for(addr)
                reply = conn.stream("generate", rid, prompt, opts,
                                    timeout=timeout,
                                    on_partial=_on_partial)
            except (ConnectionError, OSError) as e:
                last_err = e
                if self._probe(addr):
                    continue   # alive: replay rid on the same route
                self._fail_over(i)
                continue
            except RuntimeError as e:
                if "replica failed mid-batch" in str(e) \
                        or "server stopped" in str(e):
                    last_err = e
                    self._fail_over(i)
                    continue
                raise
            verdict = reply[0]
            if verdict == "ok":
                self._bump("responses")
                info = reply[1] if isinstance(reply[1], dict) else {}
                full = [int(t) for t in
                        _np.asarray(info.get("tokens", ()),
                                    _np.int64).reshape(-1)]
                with plock:
                    recovered_from = len(out_tokens)
                    out_tokens.extend(full[recovered_from:])
                if on_token is not None:
                    # tokens whose partial frames were lost on the wire:
                    # delivered now from the authoritative terminal list
                    for idx in range(recovered_from, len(full)):
                        on_token(idx, full[idx], info.get("version"))
                return list(out_tokens), info
            if verdict == "_no_reply":
                last_err = ConnectionError("request %s dropped" % rid)
                self._fail_over(i)
                continue
            if verdict == "expired":
                self._bump("expired")
                raise DeadlineExceeded(
                    "sequence %s expired mid-generation (budget %.0fms, "
                    "%d token(s) generated, %.1fms late)"
                    % (rid, budget, reply[1].get("generated", 0),
                       reply[1].get("late_ms", 0.0)))
            if verdict in ("overloaded", "draining"):
                verdicts.append((addr, verdict, reply[1]))
                if not self._fail_over(i):
                    break
                continue
            raise RuntimeError("unexpected generate verdict %r" % (reply,))
        if verdicts:
            self._bump("shed")
            raise Overloaded(
                "sequence %s shed by all replicas: %s"
                % (rid, [(a, v) for a, v, _ in verdicts]),
                verdicts=verdicts)
        raise ConnectionError(
            "sequence %s failed on every replica: %s" % (rid, last_err))

    def _resumed(self, addr, verdicts):
        """Whether ``addr``, which shed this request with ``draining``,
        answers a probe as admitting again."""
        return any(a == addr and v == "draining" for a, v, _ in verdicts) \
            and self._probe(addr)

    def _probe(self, addr):
        """Health-probe one replica: True keeps routing to it, False
        demotes it (fails over past it). The ping verdict carries the
        replica's lifecycle epoch, minted at each drain/resume: a reply
        stamped below the newest epoch this client has seen for that
        replica is stale evidence (a delayed reply), so its ``draining``
        is ignored rather than flapping a resumed replica out of the
        rotation. A current draining verdict demotes: a replay into a
        draining replica only gets shed."""
        try:
            conn = self._conn_for(addr, connect_timeout=2.0)
            if not conn.ping(timeout=2.0, origin=self._origin):
                return False
        except (ConnectionError, OSError):
            return False
        info = conn.last_ping if isinstance(conn.last_ping, dict) else {}
        epoch = info.get("epoch")
        if epoch is None:
            return True            # pre-epoch server: alive is enough
        with self._lock:
            known = self._addr_epoch.get(addr, 0)
            if epoch < known:
                return True        # stale verdict: not demotion evidence
            self._addr_epoch[addr] = epoch
        return not info.get("draining")

    # -- observability / lifecycle ----------------------------------------
    def server_stats(self, addr=None):
        addr = addr if addr is not None else self._active()[1]
        return self._conn_for(addr).request("stats", timeout=10.0)[1]

    def drain(self, addr=None, timeout=30.0):
        """Start a replica's two-phase drain (default: the active one),
        the wire form of SIGTERM: the replica sheds new requests with the
        retriable ``draining`` verdict (steering this client to its
        peers) while it flushes everything admitted."""
        addr = addr if addr is not None else self._active()[1]
        return self._conn_for(addr).request(
            "drain", float(timeout), timeout=10.0)[1]

    def stats(self):
        with self._lock:
            out = dict(self._c)
            out["active"] = self._addrs[self._active_i]
            out["replicas"] = list(self._addrs)
        out["comms"] = self._stats.snapshot()
        return out

    def close(self):
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.close()
