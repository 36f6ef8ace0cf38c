"""Gluon recurrent layers and cells of the PyTorch port
(``mxtpu.gluon.rnn``): the fused layers and the cells stepped a call."""
from .rnn_layer import *  # noqa: F401,F403
from .rnn_cell import *  # noqa: F401,F403
