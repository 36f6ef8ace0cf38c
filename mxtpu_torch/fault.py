"""Deterministic fault injection: the part of ``mxtpu/fault.py`` that the
port's components fire.

A component calls :func:`fire` at a fixed point, and an installed spec
decides, from deterministic per-rule counters (never the clock, never
randomness), whether that event is dropped, delayed or poisoned. A spec
is ``mxtpu``'s syntax: rules separated by ``;``, each a comma-separated
list of ``key=value`` pairs, e.g.
``kind=delay,point=serve.step,delay=0.05,nth=2,count=50`` or
``kind=nan_grad,point=module.step,nth=3``.

Rule keys: ``kind`` — ``drop`` (:func:`fire` returns ``"drop"``; the
caller skips the event), ``delay`` (sleep ``delay`` seconds, then
proceed) or ``nan_grad`` (training-loop points only: :func:`fire`
returns ``"nan_grad"`` and the caller poisons this step's batch, so that
the loss and the gradients go non-finite); ``point`` — ``serve.step``
(fired by the generation scheduler once a decode step), ``module.step``
(fired by the fused Module train step once a step, before the batch is
copied into the step's inputs: ``nan_grad`` there is the AMP loss-scale
overflow drill) or ``any``; ``op`` — the operation to match (``*``, the
default, matches all; ``|`` separates alternatives); ``nth`` — the
1-based matching event at which the rule starts firing; ``count`` — how
many consecutive matching events fire (``inf`` for all). ``mxtpu``'s
other kinds and points come with the port of the server, the kvstore and
the trainers that fire them.

:func:`install` sets a spec globally; ``with inject(spec) as inj:``
sets it for a block and restores the one before, and ``inj.stats()``
gives each rule's (kind, point, op, seen, fired).
"""
from __future__ import annotations

import threading
import time

__all__ = ["FaultInjector", "install", "uninstall", "inject", "fire"]

_POINTS = ("serve.step", "module.step", "any")
_KINDS = ("drop", "delay", "nan_grad")
_STEP_POINTS = ("module.step", "any")     # where nan_grad applies


class _Rule:
    __slots__ = ("kind", "point", "op", "ops", "nth", "count", "delay",
                 "seen", "fired")

    def __init__(self, kind, point="any", op="*", nth=1, count=1,
                 delay=0.0):
        if kind not in _KINDS:
            raise ValueError("unknown fault kind %r (one of %s)"
                             % (kind, "/".join(_KINDS)))
        if point not in _POINTS:
            raise ValueError("unknown fault point %r (one of %s)"
                             % (point, "/".join(_POINTS)))
        if kind == "nan_grad" and point not in _STEP_POINTS:
            raise ValueError("kind=nan_grad only applies to the "
                             "module.step point")
        self.kind = kind
        self.point = point
        self.op = op
        self.ops = None if op == "*" else frozenset(op.split("|"))
        self.nth = int(nth)
        self.count = float("inf") if count == "inf" else int(count)
        self.delay = float(delay)
        self.seen = 0          # matching events observed
        self.fired = 0         # faults delivered

    def matches(self, point, op):
        if self.point != "any" and self.point != point:
            return False
        return self.ops is None or op in self.ops


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


class FaultInjector:
    """The rules of a spec and their counters (thread-safe)."""

    def __init__(self, spec):
        self.rules = [_parse_rule(r) for r in spec.split(";") if r.strip()]
        self._lock = threading.Lock()

    def fire(self, point, op=None):
        """None (proceed, after sleeping for a delay), ``"drop"`` or
        ``"nan_grad"``."""
        with self._lock:
            rule = None
            for r in self.rules:
                if not r.matches(point, op):
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
        return rule.kind

    def stats(self):
        """Per-rule (kind, point, op, seen, fired): whether a schedule
        ran."""
        with self._lock:
            return [(r.kind, r.point, r.op, r.seen, r.fired)
                    for r in self.rules]


_injector = None
_guard = threading.Lock()


def install(spec):
    """Install a spec string (or a :class:`FaultInjector`) globally, in
    place of any earlier one. Returns the injector."""
    global _injector
    inj = spec if isinstance(spec, FaultInjector) else FaultInjector(spec)
    with _guard:
        _injector = inj
    return inj


def uninstall():
    global _injector
    with _guard:
        _injector = None


def fire(point, op=None):
    """The hook components call: None (proceed), ``"drop"`` or
    ``"nan_grad"``. Free when no spec is installed."""
    inj = _injector
    if inj is None:
        return None
    return inj.fire(point, op=op)


class inject:
    """``with inject("kind=...") as inj:`` installs the spec for the block
    and restores the injector before it (usually none) on exit."""

    def __init__(self, spec):
        self._spec = spec
        self._saved = None
        self.injector = None

    def __enter__(self):
        with _guard:
            self._saved = _injector
        self.injector = install(self._spec)
        return self.injector

    def __exit__(self, *exc):
        global _injector
        with _guard:
            _injector = self._saved
        return False
