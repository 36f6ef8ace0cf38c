"""Deterministic fault injection: the part of ``mxtpu/fault.py`` that the
port's components fire.

A component calls :func:`fire` at a fixed point, and an installed spec
decides, from deterministic per-rule counters (never the clock, never
randomness), whether that event is dropped, delayed, severed, truncated,
escalated to a server kill or poisoned. A spec is ``mxtpu``'s syntax
(``MXTPU_FAULT_SPEC`` or :func:`install`): rules separated by ``;``, each
a comma-separated list of ``key=value`` pairs, e.g.
``kind=kill,point=serve.batch,nth=1`` or
``kind=delay,point=serve.step,delay=0.05,nth=2,count=50``.

Rule keys:

``kind``   ``sever`` (the connection dies at this point: :func:`fire`
           raises :class:`FaultSever`), ``drop`` (:func:`fire` returns
           ``"drop"``; the caller skips the event, and on the wire the
           peer waits out its deadline), ``delay`` (sleep ``delay``
           seconds, then proceed), ``stall`` (the same as ``delay``,
           named for straggler schedules), ``truncate`` (a frame head
           promising more bytes than follow is written to ``sock``, then
           the connection dies), ``kill`` (server points only: the
           ``server=`` passed to :func:`fire` is killed, every connection
           dies, then :class:`FaultSever` is raised) or ``nan_grad``
           (``module.step`` only: :func:`fire` returns ``"nan_grad"`` and
           the caller poisons this step's batch, so that the loss and the
           gradients go non-finite: the AMP loss-scale overflow drill).
``point``  the transport's ``worker.send`` / ``worker.recv`` (the client
           side of a request) and ``server.recv`` / ``server.send`` (the
           server side: a ``server.send`` fault lands after the request
           was applied, the lost-ack path); ``serve.request`` (a serving
           replica admitting a request, ``op=predict|generate``,
           ``key=`` the request id: ``drop`` loses it without a reply,
           ``delay`` burns its budget); ``serve.batch`` (the dynamic
           batcher, just before a coalesced batch runs, ``op=batch``:
           ``kill`` is the kill-replica-mid-batch drill);
           ``serve.step`` (the generation scheduler, once a decode
           step); ``serve.swap`` (a replica, just before a weight version
           swaps in, ``op=swap``, ``key=v<version>``); ``publish.snapshot``
           (``WeightPublisher.publish``, before anything is written,
           ``op=publish``); ``module.step`` (the fused Module train step,
           once a step, before the batch is copied in); or ``any``.
``op``     the operation to match (``*``, the default, matches all; ``|``
           separates alternatives).
``key``    a substring of the event's key to match (optional).
``role``   fire only in processes whose ``DMLC_ROLE`` matches (default
           ``*``: any).
``addr``   worker-side points only: a substring of the remote address.
``nth``    the 1-based matching event at which the rule starts firing.
``count``  how many consecutive matching events fire (``inf`` for all).
``delay``  seconds, for ``delay`` and ``stall``.

``mxtpu``'s ``partition`` and elastic kinds, its ``dst=`` scope, and its
``worker.step``, ``ctl.*`` and ``stream.*`` points come with the port of
the parameter server, the fleet and streaming that fire them.

:func:`install` sets a spec globally; ``with inject(spec) as inj:`` sets
it for a block and restores the one before, and ``inj.stats()`` gives
each rule's (kind, point, op, seen, fired).
"""
from __future__ import annotations

import os
import struct
import threading
import time

__all__ = ["FaultSever", "FaultInjector", "install", "uninstall", "inject",
           "fire", "active", "parse_spec"]

_POINTS = ("worker.send", "worker.recv", "server.recv", "server.send",
           "module.step", "serve.request", "serve.batch", "serve.step",
           "serve.swap", "publish.snapshot", "any")
_KINDS = ("sever", "drop", "delay", "truncate", "kill", "stall", "nan_grad")
_STEP_POINTS = ("module.step", "any")     # where nan_grad applies


class FaultSever(ConnectionError):
    """An injected connection loss (a ConnectionError, so every retry and
    reconnect path treats it as the real thing)."""


class _Rule:
    __slots__ = ("kind", "point", "op", "ops", "key", "role", "addr", "nth",
                 "count", "delay", "seen", "fired")

    def __init__(self, kind, point="any", op="*", key=None, nth=1, count=1,
                 delay=0.0, role="*", addr=None):
        if kind not in _KINDS:
            raise ValueError("unknown fault kind %r (one of %s)"
                             % (kind, "/".join(_KINDS)))
        if point not in _POINTS:
            raise ValueError("unknown fault point %r (one of %s)"
                             % (point, "/".join(_POINTS)))
        if kind == "kill" and point.startswith("worker"):
            raise ValueError("kind=kill only applies to server points")
        if kind == "nan_grad" and point not in _STEP_POINTS:
            raise ValueError("kind=nan_grad only applies to the "
                             "module.step point")
        self.kind = kind
        self.point = point
        self.op = op
        self.ops = None if op == "*" else frozenset(op.split("|"))
        self.key = key
        self.role = role
        self.addr = addr
        self.nth = int(nth)
        self.count = float("inf") if count in ("inf", float("inf")) \
            else int(count)
        self.delay = float(delay)
        self.seen = 0          # matching events observed
        self.fired = 0         # faults delivered

    def matches(self, point, op, key, addr=None):
        if self.point != "any" and self.point != point:
            return False
        if self.ops is not None and op not in self.ops:
            return False
        if self.key is not None and (key is None
                                     or self.key not in str(key)):
            return False
        if self.role != "*" and \
                self.role != os.environ.get("DMLC_ROLE", "worker"):
            return False
        return self.addr is None or (addr is not None
                                     and self.addr in str(addr))


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


def parse_spec(spec):
    """The rules of a spec string."""
    return [_parse_rule(r) for r in spec.split(";") if r.strip()]


class FaultInjector:
    """The rules of a spec and their counters (thread-safe: handler and
    pool threads fire at once and every window stays exact)."""

    def __init__(self, spec_or_rules):
        self.rules = parse_spec(spec_or_rules) \
            if isinstance(spec_or_rules, str) else list(spec_or_rules)
        self._lock = threading.Lock()

    def _select(self, point, op, key, addr):
        with self._lock:
            for r in self.rules:
                if not r.matches(point, op, key, addr):
                    continue
                r.seen += 1
                if r.seen >= r.nth and r.fired < r.count:
                    r.fired += 1
                    return r
        return None

    def fire(self, point, op=None, key=None, sock=None, server=None,
             addr=None):
        """None (proceed, after sleeping for a delay), ``"drop"`` or
        ``"nan_grad"``; raises :class:`FaultSever` for connection faults
        (``kill`` kills ``server`` first, so the crash looks like a dead
        replica, not one lost frame)."""
        rule = self._select(point, op, key, addr)
        if rule is None:
            return None
        if rule.kind in ("delay", "stall"):
            time.sleep(rule.delay)
            return None
        if rule.kind in ("drop", "nan_grad"):
            return rule.kind
        if rule.kind == "truncate":
            if sock is not None:
                try:
                    # a frame head promising far more bytes than follow:
                    # the peer blocks on the body until our close lands
                    sock.sendall(struct.pack("<Q", 1 << 20) + b"\x00" * 8)
                except OSError:
                    pass
            raise FaultSever("injected truncate at %s (%s)" % (point, op))
        if rule.kind == "kill":
            if server is not None:
                server.kill()
            raise FaultSever("injected server kill at %s (%s)"
                             % (point, op))
        raise FaultSever("injected sever at %s (%s)" % (point, op))

    def stats(self):
        """Per-rule (kind, point, op, seen, fired): whether a schedule
        ran."""
        with self._lock:
            return [(r.kind, r.point, r.op, r.seen, r.fired)
                    for r in self.rules]


_injector = None
_env_loaded = False
_guard = threading.Lock()


def install(spec):
    """Install a spec string, rule list or :class:`FaultInjector`
    globally, in place of any earlier one. Returns the injector."""
    global _injector, _env_loaded
    inj = spec if isinstance(spec, FaultInjector) else FaultInjector(spec)
    with _guard:
        _injector = inj
        _env_loaded = True
    return inj


def uninstall():
    global _injector, _env_loaded
    with _guard:
        _injector = None
        _env_loaded = True     # an explicit uninstall outranks the env


def active():
    """The installed injector, read from ``MXTPU_FAULT_SPEC`` on first
    use; None when fault-free."""
    global _injector, _env_loaded
    if not _env_loaded:
        with _guard:
            if not _env_loaded:
                spec = os.environ.get("MXTPU_FAULT_SPEC", "").strip()
                if spec:
                    _injector = FaultInjector(spec)
                _env_loaded = True
    return _injector


def fire(point, op=None, key=None, sock=None, server=None, addr=None):
    """The hook components call: None (proceed), ``"drop"`` or
    ``"nan_grad"``, or :class:`FaultSever` raised. Free when no spec is
    installed."""
    inj = active()
    if inj is None:
        return None
    return inj.fire(point, op=op, key=key, sock=sock, server=server,
                    addr=addr)


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
