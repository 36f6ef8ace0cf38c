"""Symbol attribute scoping (reference python/mxnet/attribute.py):
``with mx.AttrScope(ctx_group="dev1"):`` stamps every symbol created in
the scope with the given attributes. A copy of mxtpu/attribute.py, which
the port may not import."""
from __future__ import annotations

import threading

__all__ = ["AttrScope"]


class AttrScope:
    """Attach attributes to all symbols created within the scope
    (reference attribute.py:24). Scopes nest (inner wins) and instances
    are freely reusable/re-entrant: the active stack lives in
    thread-local state, never on the instance."""

    _local = threading.local()

    def __init__(self, **kwargs):
        for value in kwargs.values():
            if not isinstance(value, str):
                raise ValueError("Attributes need to be strings")
        self._attr = kwargs

    @staticmethod
    def _stack():
        if not hasattr(AttrScope._local, "stack"):
            AttrScope._local.stack = []
        return AttrScope._local.stack

    def get(self, attr):
        """Effective attrs at this scope merged into (a copy of)
        ``attr``; explicit entries win."""
        stack = self._stack()
        eff = {}
        idx = max((i for i, s in enumerate(stack) if s is self),
                  default=None)
        if idx is not None:
            # merge every scope active at our INNERMOST entry (bottom-up:
            # inner wins) — a re-entered scope must still see scopes
            # nested between its two entries
            for scope in stack[:idx + 1]:
                eff.update(scope._attr)
        else:
            eff.update(self._attr)
        if attr:
            eff.update(attr)
        return eff

    def __enter__(self):
        self._stack().append(self)
        return self

    def __exit__(self, *a):
        stack = self._stack()
        assert stack and stack[-1] is self, "unbalanced AttrScope exit"
        stack.pop()


def current():
    """The innermost active scope (an empty one when none is active)."""
    stack = AttrScope._stack()
    return stack[-1] if stack else _EMPTY


_EMPTY = AttrScope()
