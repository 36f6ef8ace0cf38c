"""Contrib layers of the PyTorch port (``mxtpu``'s
``gluon/contrib/nn/basic_layers.py``)."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import Sequential, HybridSequential
from .... import ndarray as nd

__all__ = ["Concurrent", "HybridConcurrent", "Identity"]


class Concurrent(Sequential):
    """Children run on the same input, their outputs concatenated along
    ``axis`` (reference basic_layers.py:27)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return nd.concat(*[block(x) for block in self._children.values()],
                         dim=self.axis)


class HybridConcurrent(HybridSequential):
    """Hybridizable Concurrent (reference basic_layers.py:60)."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def hybrid_forward(self, F, x):
        return F.concat(*[block(x) for block in self._children.values()],
                        dim=self.axis)


class Identity(HybridBlock):
    """The input unchanged (reference basic_layers.py:93)."""

    def hybrid_forward(self, F, x):
        return x
