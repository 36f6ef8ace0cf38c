"""Contrib data of the PyTorch port (``mxtpu.gluon.contrib.data``)."""
from .sampler import IntervalSampler
from . import text
from .text import WikiText2, WikiText103

__all__ = ["IntervalSampler", "text", "WikiText2", "WikiText103"]
