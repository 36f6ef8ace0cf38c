"""Operator library of the PyTorch port: one registry behind ``nd.*`` and
``sym.*``, as in ``mxtpu.ops``. Importing the modules below registers
their ops; the LSTM/GRU time loops live in :mod:`.rnn_scan`, flash
attention in :mod:`.flash_attention`, the detection ops and their NMS
kernel in :mod:`.vision`; ``dot``, ``batch_dot`` and the LAPACK family
in :mod:`.linalg_ops`; the bounding-box, deformable, image and small ops
in :mod:`.extra_ops`; the samplers in :mod:`.random_ops`, the optimizer
updates in :mod:`.optim_ops`, quantization, FFT and count sketch in
:mod:`.contrib_ops`.
"""
from .registry import (OpDef, register, get_op, next_generator, rng_scope,
                       set_global_seed)

from . import shape_ops      # noqa: F401
from . import elemwise       # noqa: F401
from . import reduce         # noqa: F401
from . import nn             # noqa: F401
from . import rnn            # noqa: F401
from . import vision         # noqa: F401
from . import linalg_ops     # noqa: F401
from . import extra_ops      # noqa: F401
from . import random_ops     # noqa: F401
from . import optim_ops      # noqa: F401
from . import contrib_ops    # noqa: F401


@register("_contrib_flash_attention", aliases=("flash_attention",))
def _flash_attention_op(q, k, v, causal=False, scale=None, q_offset=0,
                        k_offset=0, block_q=512, block_k=1024):
    """Flash attention (see ops/flash_attention.py): the CUDA kernels on
    the card, their plain versions on the CPU."""
    from .flash_attention import flash_attention
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           q_offset=q_offset, k_offset=k_offset,
                           block_q=block_q, block_k=block_k)
