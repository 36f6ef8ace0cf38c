"""Gluon vision data of the PyTorch port (``mxtpu.gluon.data.vision``):
the datasets over local files, and the transforms."""
from .datasets import *  # noqa: F401,F403
from . import transforms  # noqa: F401
