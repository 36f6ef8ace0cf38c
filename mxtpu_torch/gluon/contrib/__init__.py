"""Gluon contrib of the PyTorch port (``mxtpu.gluon.contrib``): the
Concurrent / Identity layers, the convolutional and contrib recurrent
cells, and the interval sampler and WikiText datasets.
(``SparseEmbedding``, whose gradient is row-sparse, is not ported.)"""
from . import nn
from . import rnn
from . import data

__all__ = ["nn", "rnn", "data"]
