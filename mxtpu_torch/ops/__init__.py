"""Operator library of the PyTorch port: one registry behind ``nd.*`` and
``sym.*``, as in ``mxtpu.ops``. Importing the modules below registers
their ops; the LSTM/GRU time loops live in :mod:`.rnn_scan`.
"""
from .registry import OpDef, register, get_op, next_generator, rng_scope

from . import shape_ops      # noqa: F401
from . import nn             # noqa: F401
from . import rnn            # noqa: F401
