"""Contrib layers of the PyTorch port (``mxtpu.gluon.contrib.nn``)."""
from .basic_layers import (Concurrent, HybridConcurrent, Identity,
                           SparseEmbedding)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding"]
