"""Gluon contrib of the PyTorch port (``mxtpu.gluon.contrib``): the
Concurrent / Identity layers and ``SparseEmbedding`` (its gradient a
compact row-sparse array), the convolutional and contrib recurrent
cells, and the interval sampler and WikiText datasets."""
from . import nn
from . import rnn
from . import data

__all__ = ["nn", "rnn", "data"]
