"""Parallel helpers of the PyTorch port: so far the local attention core
of ``mxtpu.parallel.ring_attention`` (see :mod:`.ring_attention`)."""
from .ring_attention import local_attention

__all__ = ["local_attention"]
