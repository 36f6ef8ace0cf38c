"""Per-signature program cache (``mxtpu.module.fused.ProgramCache``).

In ``mxtpu`` an entry is a compiled XLA program; in the port, which runs
eagerly, it is a prepared closure. ``compiles`` counts entries built and
``hits`` lookups that found one, with the same meaning in both packages.
"""
from __future__ import annotations

import threading

__all__ = ["ProgramCache"]


class ProgramCache:
    """One entry per signature key, built once by the caller's ``build``
    closure. Thread-safe: builds run outside the lock, so a slow build
    does not block stats probes."""

    def __init__(self):
        self._programs = {}
        self._lock = threading.Lock()
        self.compiles = 0
        self.hits = 0

    def get(self, key, build):
        """``(program, hit)`` for ``key``, building it on first use."""
        with self._lock:
            entry = self._programs.get(key)
            if entry is not None:
                self.hits += 1
                return entry, True
        entry = build()
        with self._lock:
            self._programs[key] = entry
            self.compiles += 1
        return entry, False

    def stats(self):
        with self._lock:
            return {"programs": len(self._programs),
                    "compiles": self.compiles, "hits": self.hits}
