"""The metrics registry of the PyTorch port: the part of the host-only
``mxtpu/obs/metrics.py`` the generation scheduler publishes into, one
process-wide registry of labelled counters and gauges.

Hot-path increments take one per-series lock; the registry lock only
guards creation. Components give their series back with
:meth:`Series.drop` when they close. Histograms, snapshots, polled views
and the cardinality bound come with the port of the rest of ``obs``.
"""
from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "Registry", "REGISTRY", "counter", "gauge"]


class Series:
    """One (metric, label-tuple) series: the object hot paths hold and
    bump."""

    __slots__ = ("_metric", "labels", "_lock", "_value")

    def __init__(self, metric, labels):
        self._metric = metric
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0

    @property
    def value(self):
        with self._lock:
            return self._value

    def drop(self):
        """Forget this series in the registry (component close); the
        object keeps working for its holder."""
        self._metric._drop(self)


class Counter(Series):
    """Monotone event count."""

    def inc(self, n=1):
        with self._lock:
            self._value += n


class Gauge(Series):
    """Point-in-time value (high-water marks via :meth:`set_max`)."""

    def set(self, v):
        with self._lock:
            self._value = v

    def set_max(self, v):
        with self._lock:
            if v > self._value:
                self._value = v


_KINDS = {"counter": Counter, "gauge": Gauge}


class Metric:
    """One named family of series; ``labels(*values)`` returns the series
    for that label tuple, created on first use."""

    def __init__(self, name, kind, help="", labelnames=()):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series = {}          # label tuple -> Series

    def labels(self, *values):
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                "metric %s takes labels %r, got %r"
                % (self.name, self.labelnames, key))
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = self._series[key] = _KINDS[self.kind](self, key)
            return s

    def _drop(self, series):
        with self._lock:
            if self._series.get(series.labels) is series:
                del self._series[series.labels]


class Registry:
    """The process-wide metrics registry. ``counter`` and ``gauge`` are
    idempotent by name (re-registration returns the existing metric; a
    kind clash raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _metric(self, name, kind, help, labelnames):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = Metric(name, kind, help,
                                                 labelnames)
            elif m.kind != kind:
                raise ValueError("metric %r already registered as %s, not "
                                 "%s" % (name, m.kind, kind))
            return m

    def counter(self, name, help="", labels=()):
        return self._metric(name, "counter", help, labels)

    def gauge(self, name, help="", labels=()):
        return self._metric(name, "gauge", help, labels)


#: the process-wide default registry every component publishes into
REGISTRY = Registry()


def counter(name, help="", labels=()):
    return REGISTRY.counter(name, help=help, labels=labels)


def gauge(name, help="", labels=()):
    return REGISTRY.gauge(name, help=help, labels=labels)
