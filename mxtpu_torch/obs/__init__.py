"""Observability of the PyTorch port: the metrics registry
(:mod:`.metrics`), the part of ``mxtpu.obs``'s that the generation
scheduler uses. Histograms, telemetry and tracing come with the port of
the rest of serving."""
from .metrics import (Counter, Gauge, Registry, REGISTRY, counter,
                      gauge)

__all__ = ["Counter", "Gauge", "Registry", "REGISTRY", "counter", "gauge"]
