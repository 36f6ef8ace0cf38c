"""The profiler's event buffer: the part of ``mxtpu/profiler.py`` that the
cross-process trace spans (:mod:`mxtpu_torch.obs.trace`) write through.

One process-wide list of chrome://tracing events under one lock: a span
and its flow pair land with one acquire (:func:`_emit_many`), every
reader copies the list under the lock (:func:`snapshot_events`), so a
dump never races a concurrent emit. ``dump`` writes the list as one
chrome-trace JSON (tmp file and rename), ``dumps`` aggregates the
complete events by name. The configured collection modes of ``mxtpu``'s
profiler (``set_config`` / ``set_state``, its annotation objects and its
``jax.profiler`` hooks) wait for the profiler's own port; the card's
kernel timelines come from ``torch.profiler``.
"""
from __future__ import annotations

import json
import os
import threading
import time

__all__ = ["dump", "dumps", "snapshot_events", "reset", "record_span"]

_lock = threading.Lock()
_state = {"filename": "profile.json", "events": []}
_PID = os.getpid()


def _now_us():
    return time.perf_counter() * 1e6


def _emit(ev):
    with _lock:
        _state["events"].append(ev)


def _emit_many(evs):
    """Append a batch of events under one lock acquire (a trace span lands
    with its flow pair)."""
    with _lock:
        _state["events"].extend(evs)


def snapshot_events():
    """A consistent copy of the event list while collection goes on."""
    with _lock:
        return list(_state["events"])


def reset():
    """Drop the collected events."""
    with _lock:
        _state["events"] = []


def record_span(name, cat, t0_us, t1_us, args=None):
    """Append one complete ('X') chrome trace event."""
    _emit({"name": name, "cat": cat, "ph": "X", "ts": t0_us,
           "dur": max(t1_us - t0_us, 0.01), "pid": _PID,
           "tid": threading.get_ident() % 100000, "args": args or {}})


def dumps(reset=False):
    """The complete events aggregated by name, as text: calls, total and
    mean microseconds."""
    with _lock:
        events = list(_state["events"])
        if reset:
            _state["events"] = []
    agg = {}
    for e in events:
        if "dur" not in e:
            continue
        tot, cnt = agg.get(e["name"], (0.0, 0))
        agg[e["name"]] = (tot + e["dur"], cnt + 1)
    lines = ["%-40s %10s %12s %12s" % ("Name", "Calls", "Total(us)",
                                       "Avg(us)")]
    for k, (tot, cnt) in sorted(agg.items(), key=lambda kv: -kv[1][0]):
        lines.append("%-40s %10d %12.1f %12.1f" % (k, cnt, tot, tot / cnt))
    return "\n".join(lines)


def dump(filename=None):
    """Write the events as one chrome://tracing JSON file (a tmp file and
    a rename, so a reader never sees a torn file); collection goes on.
    Returns the path."""
    with _lock:
        events = list(_state["events"])
        fname = filename or _state["filename"]
    tmp = "%s.tmp.%d" % (fname, os.getpid())
    with open(tmp, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    os.replace(tmp, fname)
    return fname
