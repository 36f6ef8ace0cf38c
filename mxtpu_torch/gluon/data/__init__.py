"""Gluon data API of the PyTorch port (``mxtpu.gluon.data``): datasets,
samplers, the DataLoader and ``data.vision``'s datasets and transforms."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision  # noqa: F401
