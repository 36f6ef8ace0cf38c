"""Cross-process trace spans: one request, one timeline. The port of
``mxtpu/obs/trace.py``.

A serving request crosses processes (client -> replica -> batcher), and
this module follows it across them:

* a **trace context** ``(trace_id, span_id)`` lives in a thread-local;
  :func:`span` records a chrome-trace complete event into the profiler's
  event list (:mod:`mxtpu_torch.profiler`) carrying ``args={"trace",
  "span", "parent"}``, and a chrome flow ``s``/``f`` pair, so
  chrome://tracing draws the arrows between processes;
* the context **rides the wire** as an optional third element of the
  pickle-5 frame tuple, ``(cid, msg, (trace_id, span_id))``, sent only
  while a trace is active; a receiver treats it as metadata that never
  changes a reply;
* **sampling** is deterministic: ``MXTPU_TRACE_SAMPLE=f`` samples every
  round(1/f)-th request of each :class:`Sampler`, by counter, never by
  clock or randomness. At the default 0 every hook is one thread-local
  read that finds nothing.

Timestamps are epoch microseconds (``time.time()``), the one clock every
process of a host shares, so merged timelines line up without offsets.

A process with ``MXTPU_TRACE_DIR`` set dumps its span events at exit and
every 2 s from the first span on (and on demand via
:func:`dump_process_trace`) to ``<dir>/trace-<role>-<pid>.json``;
:func:`merge_traces` stitches the per-process files into one
chrome://tracing JSON.
"""
from __future__ import annotations

import atexit
import glob
import json
import os
import threading
import time
import uuid

from .. import profiler as _profiler
from . import metrics as _metrics

__all__ = ["Sampler", "sample_rate", "trace_dir", "start_trace",
           "active_ctx", "wire_ctx", "adopt", "span",
           "dump_process_trace", "merge_traces"]

_tls = threading.local()

# the default series are resolved once: a span bump is one lock acquire,
# not a labels() lookup an event
_spans_recorded = _metrics.counter(
    "trace.spans",
    "chrome-trace span events recorded by this process").default()
_traces_started = _metrics.counter(
    "trace.started",
    "sampled root traces started by this process").default()
_span_drops = _metrics.counter(
    "trace.span_drops",
    "spans dropped past MXTPU_TRACE_EVENTS_MAX").default()

# cheap unique ids: one urandom read a process, then a counter
import itertools as _it

_ID_PREFIX = uuid.uuid4().hex[:10]
_ID_SEQ = _it.count(1)


def _new_id():
    return "%s%x" % (_ID_PREFIX, next(_ID_SEQ))


_rate_cache = (None, 0.0)


def sample_rate():
    """MXTPU_TRACE_SAMPLE: fraction of steps/requests that carry a
    trace (0 disables, 1 traces everything). Deterministic: a rate f
    samples every round(1/f)-th event of each Sampler. Re-read every
    call (tests toggle it live); the float parse is memoized on the
    raw string so the per-step cost is one dict lookup + compare."""
    global _rate_cache
    raw = os.environ.get("MXTPU_TRACE_SAMPLE", "0") or "0"
    if raw != _rate_cache[0]:
        try:
            v = float(raw)
        except ValueError:
            v = 0.0
        _rate_cache = (raw, v)
    return _rate_cache[1]


def trace_dir():
    """MXTPU_TRACE_DIR: per-process span dumps land here as
    ``trace-<role>-<pid>.json`` (atexit, or dump_process_trace);
    unset disables the dump."""
    return os.environ.get("MXTPU_TRACE_DIR") or None


_events_max_cache = None


def events_max():
    """MXTPU_TRACE_EVENTS_MAX: hard bound on span events one process
    records (default 200000) — a long sampled run plateaus with a
    counted truncation instead of growing the event list forever.
    Read once (it bounds a whole process lifetime; tests reset the
    cache directly)."""
    global _events_max_cache
    if _events_max_cache is None:
        try:
            _events_max_cache = int(os.environ.get(
                "MXTPU_TRACE_EVENTS_MAX", "200000"))
        except ValueError:
            _events_max_cache = 200000
    return _events_max_cache


class Sampler:
    """Deterministic every-Nth sampler for one event stream (a
    trainer's steps, a client's requests). Thread-safe; zero-rate
    short-circuits to False without touching the counter lock."""

    def __init__(self, rate=None):
        self._rate = rate
        self._n = 0
        self._lock = threading.Lock()

    def _period(self):
        rate = sample_rate() if self._rate is None else self._rate
        if rate <= 0:
            return 0
        return max(1, int(round(1.0 / min(rate, 1.0))))

    def sample(self):
        period = self._period()
        if not period:
            return False
        with self._lock:
            self._n += 1
            return self._n % period == 1 or period == 1


def _now_us():
    return time.time() * 1e6


def start_trace(name="trace"):
    """Open a sampled root context on this thread; returns a token for
    :func:`end_trace`. The root span itself is recorded by whatever
    :func:`span` scopes the caller opens inside it."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (_new_id(), name)
    _traces_started.inc()
    return prev


def end_trace(prev=None):
    _tls.ctx = prev


def active_ctx():
    """The thread's (trace_id, parent_span) or None — ONE attribute
    read on the untraced fast path."""
    return getattr(_tls, "ctx", None)


def wire_ctx():
    """The tuple a sender attaches to an outgoing frame (None when no
    trace is active — the frame then stays the classic 2-tuple)."""
    return active_ctx()


class adopt:
    """``with adopt(tctx):`` — server-side scope continuing a trace
    that arrived on the wire; no-op for tctx None."""

    def __init__(self, tctx):
        self._tctx = tctx
        self._prev = None

    def __enter__(self):
        if self._tctx is not None:
            self._prev = getattr(_tls, "ctx", None)
            _tls.ctx = (self._tctx[0], self._tctx[1])
        return self

    def __exit__(self, *exc):
        if self._tctx is not None:
            _tls.ctx = self._prev
        return False


class span:
    """``with span("kv.client.rpc", op="push"):`` — records one
    complete ('X') chrome-trace event tagged with the active trace id,
    plus the flow-event pair that stitches processes. A span opened
    with no active context records nothing (the sampled-out path)."""

    __slots__ = ("name", "args", "_t0", "_ctx", "_prev", "_sid")

    def __init__(self, name, **args):
        self.name = name
        self.args = args
        self._ctx = active_ctx()
        self._t0 = None
        self._sid = None
        self._prev = None

    def __enter__(self):
        if self._ctx is None:
            return self
        self._t0 = _now_us()
        self._sid = _new_id()
        # children opened inside this scope parent onto this span
        self._prev = _tls.ctx
        _tls.ctx = (self._ctx[0], self._sid)
        return self

    def __exit__(self, *exc):
        if self._ctx is None:
            return False
        _tls.ctx = self._prev
        if self._sid is None or \
                _spans_recorded.value >= events_max():
            _span_drops.inc()
            return False
        t1 = _now_us()
        tid, parent = self._ctx
        args = {"trace": tid, "span": self._sid, "parent": parent}
        for k, v in self.args.items():
            args[k] = str(v)
        pid = os.getpid()
        thr = threading.get_ident() % 100000
        # one lock acquire lands the span AND its chrome flow pair
        # (the 's'/'f' events, id = trace id, are what make
        # chrome://tracing draw arrows between the processes)
        _profiler._emit_many((
            {"name": self.name, "cat": "trace", "ph": "X",
             "ts": self._t0, "dur": max(t1 - self._t0, 0.01),
             "pid": pid, "tid": thr, "args": args},
            {"name": "t:" + tid, "cat": "trace", "ph": "s",
             "id": tid, "ts": self._t0, "pid": pid, "tid": thr},
            {"name": "t:" + tid, "cat": "trace", "ph": "f",
             "bp": "e", "id": tid, "ts": t1, "pid": pid, "tid": thr},
        ))
        _spans_recorded.inc(1)
        _maybe_autodump()
        return False


_dumper_started = [False]
_dumper_guard = threading.Lock()


def _maybe_autodump():
    """First traced span (with MXTPU_TRACE_DIR set) starts ONE daemon
    dumper thread that writes the process timeline every 2 s: a server
    process the launcher SIGTERMs never runs atexit, so its spans must
    already be on disk — and the dump (whose cost grows with the event
    list) runs OFF the traced step's thread. Writes are atomic (tmp +
    rename), so a concurrent merge never reads a torn file."""
    if _dumper_started[0] or trace_dir() is None:
        return
    with _dumper_guard:
        if _dumper_started[0]:
            return
        _dumper_started[0] = True
        threading.Thread(target=_dump_loop, daemon=True,
                         name="mxtpu-obs-trace-dump").start()


def _dump_loop():
    while True:
        time.sleep(2.0)
        try:
            dump_process_trace()
        except OSError:
            pass                 # a full disk must not end tracing


def _process_label():
    role = os.environ.get("DMLC_ROLE", "worker")
    rank = os.environ.get("MXTPU_PROC_ID") \
        or os.environ.get("MXTPU_PS_PORT") \
        or os.environ.get("MXTPU_SERVE_PORT") or ""
    return "%s%s" % (role, ("-" + rank) if rank else "")


def dump_process_trace(path=None):
    """Write this process's trace-cat events (spans + flow pairs) as
    one chrome-trace JSON; returns the path, or None when there is
    nothing to write. Snapshot-and-continue: collection keeps running."""
    events = [e for e in _profiler.snapshot_events()
              if e.get("cat") == "trace"]
    if not events:
        return None
    d = trace_dir()
    if path is None:
        if d is None:
            return None
        path = os.path.join(
            d, "trace-%s-%d.json" % (_process_label(), os.getpid()))
    meta = [{"ph": "M", "name": "process_name", "pid": os.getpid(),
             "args": {"name": _process_label()}}]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": meta + events,
                   "displayTimeUnit": "ms"}, f)
    os.replace(tmp, path)
    return path


def merge_traces(dir_or_files, out=None):
    """Stitch every per-process ``trace-*.json`` into ONE
    chrome://tracing timeline (distinct pids keep the processes as
    separate tracks; identical trace ids + flow events stitch the
    hops). Returns the merged event list; writes ``out`` when given."""
    if isinstance(dir_or_files, str):
        files = sorted(glob.glob(os.path.join(dir_or_files,
                                              "trace-*.json")))
    else:
        files = list(dir_or_files)
    merged = []
    for fname in files:
        try:
            with open(fname) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue           # a half-written dump is a gap, not fatal
        merged.extend(doc.get("traceEvents", []))
    if out is not None:
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"traceEvents": merged, "displayTimeUnit": "ms"},
                      f)
        os.replace(tmp, out)
    return merged


if trace_dir():
    atexit.register(dump_process_trace)
