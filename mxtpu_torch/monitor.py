"""Monitor of the PyTorch port (``mxtpu/monitor.py``): statistics of the
outputs and arguments whose names match a pattern, once every
``interval`` batches.

``install(executor)`` sets the executor's monitor callback, which the
executor calls on each output after a forward (an installed monitor keeps
a ``Module`` on its eager step: the fused step has no per-output hook).
``tic`` opens a window every ``interval`` calls; ``toc`` adds each
matching argument's statistic, closes the window and returns ``(step,
name, value)`` triples, the values as text; ``toc_print`` logs them.
``stat_func`` defaults to ``norm(x) / sqrt(x.size)``, computed on the
array's device; ``toc`` reads each value back.
"""
from __future__ import annotations

import logging
import re

from . import ndarray as nd
from .ndarray import NDArray

__all__ = ["Monitor"]


def _default_stat(x):
    return nd.norm(x) / (x.size ** 0.5)


class Monitor:
    """Statistics of matching outputs and arguments every ``interval``
    batches, sorted by name with ``sort``."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.stat_func = stat_func or _default_stat
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def stat_helper(self, name, arr):
        """The executors' callback: queue the statistic of a matching
        output while a window is open."""
        if not self.activated or not self.re_prog.match(name):
            return
        if isinstance(arr, NDArray):
            self.queue.append((self.step, name, self.stat_func(arr)))

    def install(self, exe):
        """Attach to an executor."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def _wait(self):
        for exe in self.exes:
            for arr in getattr(exe, "arg_arrays", []):
                arr.wait_to_read()

    def tic(self):
        """Open a window on every ``interval``-th call."""
        if self.step % self.interval == 0:
            self._wait()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Close the window: the matching arguments' statistics join the
        outputs'; returns ``(step, name, value text)`` triples."""
        if not self.activated:
            return []
        self._wait()
        for exe in self.exes:
            for name, arr in getattr(exe, "arg_dict", {}).items():
                if self.re_prog.match(name):
                    self.queue.append((self.step, name, self.stat_func(arr)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            if not isinstance(v_list, list):
                raise TypeError("stat_func must return an NDArray or a "
                                "list of them")
            s = ",".join("%f" % float(v.asnumpy().ravel()[0])
                         if isinstance(v, NDArray) else str(v)
                         for v in v_list)
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        """Log :meth:`toc`'s triples."""
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
