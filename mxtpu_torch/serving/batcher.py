"""Continuous-batching generation scheduler of the PyTorch port: the
generation half of ``mxtpu/serving/batcher.py``.

A :class:`GenerateScheduler` keeps one packed decode batch in flight per
weight version (a *lane* of K slots) and lets sequences join and leave it
at every step boundary: a finished sequence frees its slot, and a queued
one is prefilled and adopted into a free slot, so the decode batch never
drains. A step costs the same whatever the number of active slots (the
decode program is built for K; inactive slots compute garbage), so
tokens/s grows with the active sequences.

Versions: a sequence's weight version resolves once, at admission, and
its store rides the sequence's lane, so a packed step never mixes
versions. A swap never tears a sequence in flight: its lane keeps the
resolved store alive by reference while new admissions open a lane on
the new version, and the old lane drains. A pinned replay of a version
no longer resident is refused (``engine.store_exact``).

One host read a decode step: the K next tokens (and one a prefill: the
first token). ``on_token`` streams tokens from the scheduler thread;
``eos_id``, ``max_new`` and the deadline stop a sequence. A lane's state
goes back to the engine when the lane closes (``gen_state_release``), so
the next lane reuses it and its captured decode program. The dynamic
batcher of predict requests, the server and the client come with the
port of the rest of serving.

Locking: one condition variable guards the queue and counters; it is
never held across an engine call or a reply callback.
"""
from __future__ import annotations

import collections
import itertools
import os
import threading
import time

import numpy as _np

from .. import fault as _fault
from .. import obs as _obs

__all__ = ["GenerateScheduler", "GenRequest", "gen_lanes_max"]

_GEN_COUNTERS = {
    "sequences": _obs.counter(
        "serve.gen.sequences", "generate sequences admitted", ("inst",)),
    "finished": _obs.counter(
        "serve.gen.finished", "sequences finished (eos/len)", ("inst",)),
    "expired": _obs.counter(
        "serve.gen.expired", "sequences expired (at dequeue or "
        "mid-generation between decode steps)", ("inst",)),
    "shed_queue_full": _obs.counter(
        "serve.gen.shed_queue_full", "generate submits shed at depth",
        ("inst",)),
    "steps": _obs.counter(
        "serve.gen.steps", "decode steps dispatched", ("inst",)),
    "tokens": _obs.counter(
        "serve.gen.tokens", "tokens generated (decode + prefill first "
        "tokens)", ("inst",)),
    "prefills": _obs.counter(
        "serve.gen.prefills", "prefill dispatches", ("inst",)),
    "step_faults": _obs.counter(
        "serve.gen.step_faults", "decode steps lost to injected faults",
        ("inst",)),
}
_GEN_GAUGES = {
    "slots_active": _obs.gauge(
        "serve.gen.slots_active", "in-flight sequences across lanes",
        ("inst",)),
    "lanes": _obs.gauge(
        "serve.gen.lanes", "live decode lanes (one per weight version)",
        ("inst",)),
    "queue_hwm": _obs.gauge(
        "serve.gen.queue_hwm", "generate queue high-water mark",
        ("inst",)),
}
_GEN_INST = itertools.count(1)


def gen_lanes_max():
    """MXTPU_SERVE_GENERATE_LANES: concurrent decode lanes (one per
    weight version in flight); 2 covers a swap: the old version drains
    while the new one serves."""
    return max(1, int(os.environ.get("MXTPU_SERVE_GENERATE_LANES", "2")))


class GenRequest:
    """One admitted generate sequence: blocking :meth:`wait` or
    :meth:`on_resolve`, and ``on_token(idx, tok, version)`` for every
    generated token, in order, from the scheduler thread. The terminal
    ``ok`` reply holds the full token list."""

    __slots__ = ("rid", "prompt", "max_new", "eos_id", "deadline",
                 "enq_t", "event", "reply", "wait_bound", "version",
                 "pinned", "tokens_out", "on_token", "_cbs", "_cb_lock",
                 "store", "ttft_ms")

    def __init__(self, rid, prompt, max_new, deadline, wait_bound=120.0,
                 version=None, pinned=False, eos_id=None, on_token=None):
        self.rid = rid
        self.prompt = prompt
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.deadline = deadline
        self.wait_bound = wait_bound
        self.version = version
        self.pinned = bool(pinned)
        self.on_token = on_token
        self.store = None              # (params, aux) resolved at admission
        self.enq_t = time.monotonic()
        self.ttft_ms = None
        self.event = threading.Event()
        self.reply = None
        self.tokens_out = []
        self._cbs = []
        self._cb_lock = threading.Lock()

    def emit(self, tok):
        """Record and stream one generated token (scheduler thread)."""
        idx = len(self.tokens_out)
        self.tokens_out.append(int(tok))
        cb = self.on_token
        if cb is not None:
            cb(idx, int(tok), self.version)

    def on_resolve(self, cb):
        with self._cb_lock:
            if self.reply is None:
                self._cbs.append(cb)
                return
        cb(self.reply)

    def resolve(self, reply):
        with self._cb_lock:
            if self.reply is not None:
                return
            self.reply = reply
            cbs, self._cbs = self._cbs, []
        for cb in cbs:
            cb(reply)
        self.event.set()

    def wait(self, timeout=None):
        timeout = self.wait_bound if timeout is None else timeout
        if not self.event.wait(timeout):
            return ("err", "no decode progress within %.1fs for %s"
                    % (timeout, self.rid))
        return self.reply

    def _finish(self, reason):
        return ("ok", {"rid": self.rid,
                       "tokens": _np.asarray(self.tokens_out, _np.int32),
                       "n": len(self.tokens_out),
                       "version": self.version,
                       "reason": reason})


class _GenLane:
    """One packed decode batch: every slot on one weight version, whose
    store is held by reference, so a swap or a store's removal never
    tears the lane's sequences."""

    __slots__ = ("version", "store", "state", "slot_req", "active")

    def __init__(self, version, store, state, capacity):
        self.version = version
        self.store = store             # (param_vals, aux_vals)
        self.state = state             # the engine's GenState
        self.slot_req = [None] * capacity
        self.active = 0


class GenerateScheduler:
    """Continuous decode scheduler in front of one generative
    :class:`~mxtpu_torch.serving.engine.InferenceEngine`."""

    def __init__(self, engine, queue_depth, slots=None, lanes=None):
        from .engine import gen_slots, gen_max_new
        self._engine = engine
        self._depth = int(queue_depth)
        self._slots = int(slots) if slots else gen_slots()
        self._max_lanes = int(lanes) if lanes else gen_lanes_max()
        self._max_new_cap = gen_max_new()
        self._cv = threading.Condition()
        self._queue = collections.deque()
        self._lanes = {}               # version -> _GenLane
        self._step_ms = collections.deque(maxlen=1 << 16)
        self._active = 0
        self._stopped = False
        self._killed = None            # hard-stop error message
        inst = "g%d" % next(_GEN_INST)
        self._c = {f: m.labels(inst) for f, m in _GEN_COUNTERS.items()}
        self._g = {f: m.labels(inst) for f, m in _GEN_GAUGES.items()}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="mxtpu-torch-serve-generate")
        self._thread.start()

    # -- admission ---------------------------------------------------------
    def submit(self, rid, prompt, max_new, deadline=None, wait_bound=120.0,
               version=None, pinned=False, eos_id=None, on_token=None):
        """Admit one sequence. Returns the parked :class:`GenRequest` or
        a verdict tuple: ``overloaded`` (queue at depth, retriable),
        ``draining``, or ``err`` (a prompt out of range, or a pinned
        replay version no longer resident)."""
        prompt = _np.asarray(prompt).reshape(-1)
        plen = int(prompt.shape[0])
        spec = self._engine.generate_spec()
        if spec is None:
            return ("err", "model is not generative: the symbol lacks the "
                           "pos/state-next generation contract")
        cache_len = spec["cache_len"]
        if plen < 1 or plen >= cache_len:
            return ("err", "prompt length %d out of range [1, %d)"
                    % (plen, cache_len))
        self._engine.gen_bucket_for(plen)     # raises -> caller's err
        max_new = max(1, min(int(max_new), self._max_new_cap,
                             cache_len - plen))
        if pinned and version is not None:
            store = self._engine.store_exact(version)
            if store is None:
                return ("err", "weight version %r is no longer resident"
                               " — cannot replay a pinned sequence"
                        % (version,))
            answered = int(version)
        else:
            params, aux, answered = self._engine._resolve_store(version)
            store = (params, aux)
        with self._cv:
            if self._stopped:
                return ("draining", {"reason": "scheduler stopped"})
            if len(self._queue) + self._active >= self._depth:
                self._c["shed_queue_full"].inc()
                return ("overloaded",
                        {"queue_depth": self._depth,
                         "queued": len(self._queue) + self._active})
            req = GenRequest(rid, prompt, max_new, deadline,
                             wait_bound=wait_bound, version=answered,
                             pinned=pinned, eos_id=eos_id,
                             on_token=on_token)
            req.store = store
            self._queue.append(req)
            self._c["sequences"].inc()
            self._g["queue_hwm"].set_max(len(self._queue))
            self._cv.notify_all()
            return req

    # -- the scheduler thread ----------------------------------------------
    def _run(self):
        # the lane table is owned by this thread: placement, stepping,
        # retirement and the teardown happen here; stop() posts _killed
        # and joins, and this loop tears down on its way out
        while True:
            with self._cv:
                if self._killed is not None:
                    break
                if not self._queue and self._active == 0:
                    if self._stopped:
                        break
                    self._cv.wait(timeout=0.05)
                    continue
            try:
                self._admit_queued()
                self._step_lanes()
            except BaseException as e:
                # a decode step failed: every in-flight and queued
                # sequence fails fast
                self._c["step_faults"].inc()
                self._fail_all("replica failed mid-batch: %s: %s"
                               % (type(e).__name__, e))
                return
        # a drained scheduler fails nothing; either way the lanes' states
        # go back to the engine
        self._fail_all(self._killed or "scheduler stopped")

    def _admit_queued(self):
        """Move queued sequences into free slots (prefill + adopt at the
        step boundary); expiry of queued sequences is decided here."""
        with self._cv:
            pending = list(self._queue)
            self._queue.clear()
        keep, expired = [], []
        now = time.monotonic()
        for req in pending:
            if req.deadline is not None and now >= req.deadline:
                expired.append(req)
                continue
            lane = self._lane_for(req)
            if lane is None:
                keep.append(req)       # no lane or slot yet: stays queued
                continue
            slot = lane.slot_req.index(None)
            self._prefill_into(req, lane, slot)
        with self._cv:
            self._queue.extendleft(reversed(keep))
            self._cv.notify_all()
        for req in expired:
            self._c["expired"].inc()
            req.resolve(("expired",
                         {"rid": req.rid, "generated": 0,
                          "late_ms": round((now - req.deadline) * 1e3,
                                           3)}))

    def _lane_for(self, req):
        """The lane of ``req.version`` with a free slot, opened on demand
        (closing an idle lane at the lane cap), or None."""
        lane = self._lanes.get(req.version)
        if lane is not None:
            return lane if lane.active < len(lane.slot_req) else None
        if len(self._lanes) >= self._max_lanes:
            idle = [v for v, ln in self._lanes.items() if ln.active == 0]
            if not idle:
                return None
            self._close_lane(idle[0])
        lane = _GenLane(req.version, req.store,
                        self._engine.gen_state_init(self._slots),
                        self._slots)
        self._lanes[req.version] = lane
        self._g["lanes"].set_max(len(self._lanes))
        return lane

    def _close_lane(self, version):
        lane = self._lanes.pop(version)
        self._engine.gen_state_release(lane.state)

    def _prefill_into(self, req, lane, slot):
        self._c["prefills"].inc()
        try:
            first, rows = self._engine.gen_prefill(
                req.prompt, lane.store[0], lane.store[1])
        except Exception as e:
            req.resolve(("err", "prefill failed: %s: %s"
                         % (type(e).__name__, e)))
            return
        tok0 = int(first.cpu()[0])            # the prefill's host read
        req.ttft_ms = (time.monotonic() - req.enq_t) * 1e3
        self._c["tokens"].inc()
        req.emit(tok0)
        if (req.max_new <= 1
                or (req.eos_id is not None and tok0 == req.eos_id)):
            self._c["finished"].inc()
            req.resolve(req._finish(
                "eos" if req.eos_id is not None and tok0 == req.eos_id
                else "len"))
            return
        lane.state = self._engine.gen_adopt(
            lane.state, first, int(req.prompt.shape[0]), rows, slot)
        lane.slot_req[slot] = req
        lane.active += 1
        with self._cv:
            self._active += 1
        self._g["slots_active"].set(self._active)

    def _step_lanes(self):
        for lane in list(self._lanes.values()):
            if lane.active == 0:
                continue
            if _fault.fire("serve.step") == "drop":
                self._c["step_faults"].inc()
                for slot, req in enumerate(lane.slot_req):
                    if req is not None:
                        self._free(lane, slot)
                        req.resolve(("err",
                                     "decode step dropped (injected)"))
                continue
            t0 = time.perf_counter()
            nxt, lane.state = self._engine.gen_step(
                lane.state, lane.store[0], lane.store[1])
            toks = nxt.cpu().numpy()          # the one host read a step
            ms = (time.perf_counter() - t0) * 1e3
            self._step_ms.append(ms)
            self._c["steps"].inc()
            self._c["tokens"].inc(lane.active)
            now = time.monotonic()
            for slot, req in enumerate(lane.slot_req):
                if req is None:
                    continue
                tok = int(toks[slot])
                req.emit(tok)
                if ((req.eos_id is not None and tok == req.eos_id)
                        or len(req.tokens_out) >= req.max_new):
                    self._free(lane, slot)
                    self._c["finished"].inc()
                    req.resolve(req._finish(
                        "eos" if req.eos_id is not None
                        and tok == req.eos_id else "len"))
                elif req.deadline is not None and now >= req.deadline:
                    # a budget spent between decode steps frees the slot
                    # now instead of decoding on
                    self._free(lane, slot)
                    self._c["expired"].inc()
                    req.resolve(("expired",
                                 {"rid": req.rid,
                                  "generated": len(req.tokens_out),
                                  "late_ms": round(
                                      (now - req.deadline) * 1e3, 3)}))
        self._g["slots_active"].set(self._active)
        # close empty lanes off the stable version: a drained swap lane
        # gives its store and its state back here
        stable = self._engine.version_state()["version"]
        for v in [v for v, ln in self._lanes.items()
                  if ln.active == 0 and v != stable]:
            self._close_lane(v)

    def _free(self, lane, slot):
        lane.slot_req[slot] = None
        lane.active -= 1
        with self._cv:
            self._active -= 1
            self._cv.notify_all()

    def _fail_all(self, msg):
        with self._cv:
            pend = list(self._queue)
            self._queue.clear()
            self._killed = msg
            self._cv.notify_all()
        for version in list(self._lanes):
            lane = self._lanes[version]
            for slot, req in enumerate(lane.slot_req):
                if req is not None:
                    lane.slot_req[slot] = None
                    req.resolve(("err", msg))
            lane.active = 0
            self._close_lane(version)
        with self._cv:
            self._active = 0
        for req in pend:
            req.resolve(("err", msg))

    # -- lifecycle ---------------------------------------------------------
    def pending(self):
        with self._cv:
            return len(self._queue) + self._active

    def drain(self, timeout=30.0):
        """Finish every admitted sequence, then stop the thread; the
        caller stops admissions first. Bounded by ``timeout``."""
        deadline = time.monotonic() + timeout
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
            while self._queue or self._active:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=min(0.1, left))
        self._thread.join(timeout=max(0.1, deadline - time.monotonic()))
        self.release_metrics()
        return True

    def stop(self):
        """Hard stop: fail everything queued and in flight. The teardown
        runs on the scheduler thread, which owns the lanes."""
        with self._cv:
            self._stopped = True
            self._killed = "server stopped"
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
        self.release_metrics()

    def stats(self):
        out = {f: s.value for f, s in self._c.items()}
        out.update({f: s.value for f, s in self._g.items()})
        with self._cv:
            out["queued"] = len(self._queue)
            out["active"] = self._active
        return out

    def step_times(self):
        """The wall ms of each decode step so far (the last 65,536)."""
        return list(self._step_ms)

    def release_metrics(self):
        for s in list(self._c.values()) + list(self._g.values()):
            s.drop()
