"""Gluon neural-network layers of the PyTorch port (``mxtpu.gluon.nn``)."""
from .basic_layers import *
from .conv_layers import *
from .activations import *

from .basic_layers import __all__ as _b
from .conv_layers import __all__ as _c
from .activations import __all__ as _a

__all__ = list(_b) + list(_c) + list(_a)
