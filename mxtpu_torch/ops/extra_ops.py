"""``Crop`` of the PyTorch port, and the legacy names of ported ops.

Counterpart of part of ``mxtpu/ops/extra_ops.py``: the legacy Crop op
(MXNet's ``src/operator/crop.cc``), which fully convolutional nets use
to align an upsampled map with another, and the aliases ``mxtpu`` gives
there to ops ported elsewhere (``Convolution_v1``, ``Pooling_v1``,
``CuDNNBatchNorm``, ``_contrib_SparseEmbedding``). The other ops of that
file are not ported yet.
"""
from __future__ import annotations

from .registry import alias, register


@register("Crop", aliases=("crop_like",))
def crop_op(data, crop_like=None, offset=(0, 0), h_w=(0, 0),
            center_crop=False, num_args=1):
    """``data``'s two spatial axes cut to ``crop_like``'s size (else to
    ``h_w``), from ``offset`` (y, x), or centred with ``center_crop``."""
    th, tw = (crop_like.shape[2], crop_like.shape[3]) \
        if crop_like is not None else tuple(h_w)
    H, W = data.shape[2], data.shape[3]
    if center_crop:
        oy, ox = (H - th) // 2, (W - tw) // 2
    else:
        oy, ox = offset
    if not (0 <= oy and oy + th <= H and 0 <= ox and ox + tw <= W):
        raise ValueError("Crop: a %dx%d window at (%d, %d) does not fit a "
                         "%dx%d map" % (th, tw, oy, ox, H, W))
    return data[:, :, oy:oy + th, ox:ox + tw]


alias("Convolution", "Convolution_v1")
alias("Pooling", "Pooling_v1")
alias("BatchNorm", "CuDNNBatchNorm")
alias("Embedding", "_contrib_SparseEmbedding")
