"""The metrics registry of the PyTorch port: ``mxtpu/obs/metrics.py``
(host-only code) as the port's components publish into it. One
process-wide registry of typed instruments; ``Registry.snapshot()`` is the
JSON a ``metrics`` wire poll of a serving replica returns, and every
component's ``stats()`` dict reads its values back from the registry's
instruments.

* **Hot-path increments are lock-cheap.** A :class:`Counter` bump is one
  per-series lock and an int add; the registry lock only guards the
  creation of metrics and series and the copy of their structure in a
  snapshot.
* **Label cardinality is bounded.** A metric takes at most
  ``MXTPU_METRICS_MAX_SERIES`` distinct label tuples (default 256). Past
  the bound ``labels()`` returns a *detached* series: exact for its
  holder, left out of ``snapshot()`` and counted in the metric's
  ``overflowed``. Components give their series back with
  :meth:`Series.drop` when they close.
* **A snapshot holds no lock across user code.** The structure is copied
  under the registry lock; series values and view callables are read
  after it is released.

Histograms are fixed-bucket (log-spaced, in ms by default): ``observe()``
is one lock and one bucket increment, and ``p50`` / ``p99`` are estimated
by linear interpolation inside the owning bucket.
"""
from __future__ import annotations

import bisect
import os
import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "counter", "gauge", "histogram", "view", "max_series",
           "DEFAULT_BUCKETS"]


def max_series():
    """MXTPU_METRICS_MAX_SERIES: label-cardinality bound per metric —
    past it, new label tuples get detached (snapshot-invisible but
    locally exact) series and bump the metric's ``overflowed``."""
    try:
        return max(1, int(os.environ.get("MXTPU_METRICS_MAX_SERIES",
                                         "256")))
    except ValueError:
        return 256


# log-spaced ms-scale latency buckets: sub-100us dispatches through
# 10s-stalls land in distinguishable buckets; +inf is implicit
DEFAULT_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                   50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0,
                   10000.0)


class Series:
    """One (metric, label-tuple) time series: the object hot paths
    hold and bump. ``detached`` series (cardinality overflow, or
    dropped on close) count exactly for their holder but are invisible
    to ``snapshot()``."""

    __slots__ = ("_metric", "labels", "_lock", "_value", "detached")

    def __init__(self, metric, labels):
        self._metric = metric
        self.labels = labels
        self._lock = threading.Lock()
        self._value = 0
        self.detached = False

    @property
    def value(self):
        with self._lock:
            return self._value

    def drop(self):
        """Give this series' cardinality slot back (component close):
        the object keeps working for its holder, the registry forgets
        it."""
        self._metric._drop(self)

    def snap(self):
        return self.value


class Counter(Series):
    """Monotone event count."""

    def inc(self, n=1):
        with self._lock:
            self._value += n


class Gauge(Series):
    """Point-in-time value (queue depth, window occupancy, high-water
    marks via :meth:`set_max`)."""

    def set(self, v):
        with self._lock:
            self._value = v

    def inc(self, n=1):
        with self._lock:
            self._value += n

    def dec(self, n=1):
        with self._lock:
            self._value -= n

    def set_max(self, v):
        with self._lock:
            if v > self._value:
                self._value = v


class Histogram(Series):
    """Fixed-bucket distribution: count, sum, per-bucket counts, and
    interpolated quantiles. One lock + one bisect per observe."""

    __slots__ = ("bounds", "_counts", "_sum", "_count")

    def __init__(self, metric, labels, bounds=None):
        super().__init__(metric, labels)
        self.bounds = tuple(bounds) if bounds is not None \
            else DEFAULT_BUCKETS
        self._counts = [0] * (len(self.bounds) + 1)   # +inf tail
        self._sum = 0.0
        self._count = 0

    def observe(self, v):
        v = float(v)
        with self._lock:
            self._counts[bisect.bisect_left(self.bounds, v)] += 1
            self._sum += v
            self._count += 1

    def percentile(self, q):
        """Quantile estimate from the bucket counts (linear inside the
        owning bucket); None when empty."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if not total:
            return None
        target = q * total
        seen = 0.0
        for i, c in enumerate(counts):
            if seen + c >= target and c:
                lo = self.bounds[i - 1] if i else 0.0
                hi = self.bounds[i] if i < len(self.bounds) \
                    else self.bounds[-1] * 2
                frac = (target - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return self.bounds[-1] * 2

    @property
    def count(self):
        with self._lock:
            return self._count

    @property
    def sum(self):
        with self._lock:
            return self._sum

    def snap(self):
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
        out = {"count": total, "sum": round(s, 6),
               "buckets": counts}
        # the headline quantiles, precomputed for whoever polls
        for q, key in ((0.5, "p50"), (0.99, "p99")):
            out[key] = None if not total else round(
                self.percentile(q), 6)
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Metric:
    """One named family of series. ``labels(*values)`` returns the
    series for that label tuple, creating it while under the
    cardinality bound and handing back a detached one past it."""

    def __init__(self, registry, name, kind, help="", labelnames=(),
                 buckets=None):
        self.registry = registry
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = buckets
        self._lock = threading.Lock()
        self._series = {}          # label tuple -> Series
        self.overflowed = 0

    def _make(self, labels):
        cls = _KINDS[self.kind]
        if self.kind == "histogram":
            return cls(self, labels, bounds=self.buckets)
        return cls(self, labels)

    def labels(self, *values):
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                "metric %s takes labels %r, got %r"
                % (self.name, self.labelnames, key))
        with self._lock:
            s = self._series.get(key)
            if s is not None:
                return s
            if len(self._series) >= max_series():
                # past the bound: exact-but-invisible, loudly counted
                self.overflowed += 1
                s = self._make(key)
                s.detached = True
                return s
            s = self._make(key)
            self._series[key] = s
            return s

    def default(self):
        """The unlabeled series (label-less metrics)."""
        return self.labels()

    # convenience single-series forwards, so a label-less metric reads
    # like the instrument itself at call sites
    def inc(self, n=1):
        self.default().inc(n)

    def set(self, v):
        self.default().set(v)

    def observe(self, v):
        self.default().observe(v)

    def _drop(self, series):
        with self._lock:
            key = series.labels
            if self._series.get(key) is series:
                del self._series[key]
            series.detached = True

    def series_count(self):
        with self._lock:
            return len(self._series)

    def _structure(self):
        with self._lock:
            return list(self._series.values()), self.overflowed


class Registry:
    """The process-wide metrics plane. ``counter``/``gauge``/
    ``histogram`` are idempotent by name (re-registration returns the
    existing metric; a kind clash raises). ``view`` registers a polled
    dict source, so a component's composite ``stats()`` (a serving
    replica's models, batchers and versions) appears in the snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}
        self._views = {}           # unique name -> fn() -> dict
        self._view_seq = 0

    # -- registration ------------------------------------------------------
    def _metric(self, name, kind, help, labelnames, buckets=None):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if m.kind != kind:
                    raise ValueError(
                        "metric %r already registered as %s, not %s"
                        % (name, m.kind, kind))
                return m
            m = Metric(self, name, kind, help=help,
                       labelnames=labelnames, buckets=buckets)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labels=()):
        return self._metric(name, "counter", help, labels)

    def gauge(self, name, help="", labels=()):
        return self._metric(name, "gauge", help, labels)

    def histogram(self, name, help="", labels=(), buckets=None):
        return self._metric(name, "histogram", help, labels,
                            buckets=buckets)

    _VIEWS_MAX = 512   # cardinality backstop for never-closed
    #                    components (a long test session's guards)

    def view(self, name, fn):
        """Register a polled dict source under ``name`` (uniquified
        with ``#n`` when several instances share it). Returns the
        unique key; pass it to :meth:`unview` on component close.
        Past the view bound the registration is dropped (returns
        None — unview(None) is a no-op): bounded, never fatal."""
        with self._lock:
            if len(self._views) >= self._VIEWS_MAX:
                return None
            key = name
            if key in self._views:
                self._view_seq += 1
                key = "%s#%d" % (name, self._view_seq)
            self._views[key] = fn
            return key

    def unview(self, key):
        with self._lock:
            self._views.pop(key, None)

    # -- read side ---------------------------------------------------------
    def series_count(self):
        with self._lock:
            metrics = list(self._metrics.values())
        return sum(m.series_count() for m in metrics)

    def snapshot(self):
        """One JSON-serializable picture of this process: every
        registered series' value/distribution, every view's dict, and
        the cardinality accounting. Collected
        without holding the registry lock across series locks or view
        callables."""
        with self._lock:
            metrics = list(self._metrics.items())
            views = list(self._views.items())
        out_metrics = {}
        nseries = 0
        overflowed = 0
        for name, m in sorted(metrics):
            series, ovf = m._structure()
            overflowed += ovf
            nseries += len(series)
            fam = {"kind": m.kind, "labels": list(m.labelnames),
                   "overflowed": ovf, "series": {}}
            for s in series:
                fam["series"][",".join(s.labels)] = s.snap()
            out_metrics[name] = fam
        out_views = {}
        for key, fn in sorted(views):
            try:
                out_views[key] = fn()
            except Exception as e:   # a dying component's view must
                #                      never kill the whole snapshot
                out_views[key] = {"error": "%s: %s"
                                  % (type(e).__name__, e)}
        return {"time": time.time(), "pid": os.getpid(),
                # MXTPU_OBS_ROLE overrides for processes that must not
                # carry DMLC_ROLE (serving replicas pop it so the
                # server import hook stays off)
                "role": os.environ.get("MXTPU_OBS_ROLE")
                or os.environ.get("DMLC_ROLE", "worker"),
                "series": nseries, "overflowed_series": overflowed,
                "max_series": max_series(),
                "metrics": out_metrics, "views": out_views}


#: the process-wide default registry every component publishes into
REGISTRY = Registry()


def counter(name, help="", labels=()):
    return REGISTRY.counter(name, help=help, labels=labels)


def gauge(name, help="", labels=()):
    return REGISTRY.gauge(name, help=help, labels=labels)


def histogram(name, help="", labels=(), buckets=None):
    return REGISTRY.histogram(name, help=help, labels=labels,
                              buckets=buckets)


def view(name, fn):
    return REGISTRY.view(name, fn)
