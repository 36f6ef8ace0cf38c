"""Observability of the PyTorch port: the metrics registry
(:mod:`.metrics`: counters, gauges, histograms, polled views, the
cardinality bound, ``REGISTRY.snapshot()``) and the sampled cross-process
trace spans (:mod:`.trace`), as ``mxtpu.obs`` has them. ``mxtpu``'s
telemetry aggregator waits for the port of the fleet."""
from .metrics import (Counter, Gauge, Histogram, Registry, REGISTRY,
                      counter, gauge, histogram, max_series, view)
from .trace import (Sampler, active_ctx, adopt, dump_process_trace,
                    end_trace, merge_traces, sample_rate, span,
                    start_trace, trace_dir, wire_ctx)

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "counter", "gauge", "histogram", "view", "max_series",
           "Sampler", "span", "adopt", "active_ctx", "wire_ctx",
           "start_trace", "end_trace", "sample_rate", "trace_dir",
           "dump_process_trace", "merge_traces"]
