"""Deterministic fault injection: the part of ``mxtpu/fault.py`` the
serving path of the port fires.

The generation scheduler calls :func:`fire` at ``serve.step``, once a
decode step, and an installed spec decides, from deterministic per-rule
counters (never the clock, never randomness), whether that step is
dropped or delayed. A spec is ``mxtpu``'s syntax: rules separated by
``;``, each a comma-separated list of ``key=value`` pairs, e.g.
``kind=delay,point=serve.step,delay=0.05,nth=2,count=50``.

Rule keys: ``kind`` — ``drop`` (:func:`fire` returns ``"drop"``; the
caller skips the event) or ``delay`` (sleep ``delay`` seconds, then
proceed); ``point`` — ``serve.step`` or ``any``; ``nth`` — the 1-based
matching event at which the rule starts firing; ``count`` — how many
consecutive matching events fire (``inf`` for all). ``mxtpu``'s other
kinds and points come with the port of the server, the kvstore and the
trainers that fire them.
"""
from __future__ import annotations

import threading
import time

__all__ = ["install", "uninstall", "fire"]

_POINTS = ("serve.step", "any")
_KINDS = ("drop", "delay")


class _Rule:
    __slots__ = ("kind", "point", "nth", "count", "delay", "seen", "fired")

    def __init__(self, kind, point="any", nth=1, count=1, delay=0.0):
        if kind not in _KINDS:
            raise ValueError("unknown fault kind %r (one of %s)"
                             % (kind, "/".join(_KINDS)))
        if point not in _POINTS:
            raise ValueError("unknown fault point %r (one of %s)"
                             % (point, "/".join(_POINTS)))
        self.kind = kind
        self.point = point
        self.nth = int(nth)
        self.count = float("inf") if count == "inf" else int(count)
        self.delay = float(delay)
        self.seen = 0          # matching events observed
        self.fired = 0         # faults delivered


def _parse_rule(text):
    kw = {}
    for pair in text.split(","):
        pair = pair.strip()
        if not pair:
            continue
        if "=" not in pair:
            raise ValueError("fault rule field %r is not key=value" % pair)
        k, _, v = pair.partition("=")
        kw[k.strip()] = v.strip()
    if "kind" not in kw:
        raise ValueError("fault rule %r has no kind=" % text)
    return _Rule(**kw)


_rules = None
_guard = threading.Lock()


def install(spec):
    """Install a spec string globally, in place of any earlier one."""
    global _rules
    rules = [_parse_rule(r) for r in spec.split(";") if r.strip()]
    with _guard:
        _rules = rules


def uninstall():
    global _rules
    with _guard:
        _rules = None


def fire(point):
    """The hook components call: None (proceed, after sleeping for a
    delay) or ``"drop"``. Free when no spec is installed."""
    if _rules is None:
        return None
    with _guard:
        rule = None
        for r in _rules or ():
            if r.point != "any" and r.point != point:
                continue
            r.seen += 1
            if r.seen >= r.nth and r.fired < r.count:
                r.fired += 1
                rule = r
                break
    if rule is None:
        return None
    if rule.kind == "delay":
        time.sleep(rule.delay)
        return None
    return "drop"
