"""Parallel helpers of the PyTorch port: so far the local attention core
of ``mxtpu.parallel.ring_attention`` (see :mod:`.ring_attention`) and the
one-device core of ``mxtpu.parallel.moe`` (see :mod:`.moe`)."""
from .moe import moe_dispatch, moe_ffn
from .ring_attention import local_attention

__all__ = ["local_attention", "moe_dispatch", "moe_ffn"]
