"""Gluon recurrent layers of the PyTorch port (``mxtpu.gluon.rnn``; the
fused layers: the cells wait)."""
from .rnn_layer import *  # noqa: F401,F403
