"""Gluon data API of the PyTorch port (``mxtpu.gluon.data``; the record
file dataset and ``data.vision`` wait for an image decoder)."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
