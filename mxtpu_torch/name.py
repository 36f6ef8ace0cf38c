"""Automatic symbol naming (parity with python/mxnet/name.py NameManager;
copy of mxtpu/name.py, which the port may not import)."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "current"]


class NameManager:
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old = None

    def get(self, name, hint):
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        if not hasattr(NameManager._current, "value"):
            NameManager._current.value = NameManager()
        self._old = NameManager._current.value
        NameManager._current.value = self
        return self

    def __exit__(self, *a):
        NameManager._current.value = self._old


def current():
    if not hasattr(NameManager._current, "value"):
        NameManager._current.value = NameManager()
    return NameManager._current.value
