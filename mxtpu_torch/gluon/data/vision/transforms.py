"""Gluon vision transforms of the PyTorch port
(``mxtpu/gluon/data/vision/transforms.py``): Compose, Cast, ToTensor,
Normalize, Resize, CenterCrop, RandomResizedCrop, RandomFlipLeftRight and
RandomFlipTopBottom, on HWC images (ToTensor makes them CHW). Each keeps
an image where it lies, on the host for a dataset's samples; the resize
and crops are :mod:`mxtpu_torch.image`'s. The random ones draw as
``mxtpu``'s do: the crop from Python's ``random``, the flips from
numpy's global stream.
"""
from __future__ import annotations

import numpy as _np
import torch

from .... import image
from ....ndarray import NDArray
from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom"]


class Compose(Sequential):
    """The transforms applied in order."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    """The image as ``dtype``."""

    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC (or NHWC) uint8 in [0, 255] as CHW (NCHW) float32 in [0, 1]."""

    def hybrid_forward(self, F, x):
        x = F.cast(x, dtype="float32") / 255.0
        if len(x.shape) == 3:
            return F.transpose(x, axes=(2, 0, 1))
        return F.transpose(x, axes=(0, 3, 1, 2))


class Normalize(HybridBlock):
    """(x - mean) / std a channel, on CHW (or NCHW) images."""

    def __init__(self, mean, std):
        super().__init__()
        self._mean = _np.asarray(mean, dtype=_np.float32)
        self._std = _np.asarray(std, dtype=_np.float32)

    def hybrid_forward(self, F, x):
        shape = (-1, 1, 1) if len(x.shape) == 3 else (1, -1, 1, 1)
        mean = F.array(self._mean, ctx=x.context).reshape(shape)
        std = F.array(self._std, ctx=x.context).reshape(shape)
        return (x - mean) / std


class Resize(Block):
    """The image resized to ``size`` (w, h), or within it keeping its
    aspect ratio."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (list, tuple)) else (size, size)
        self._keep = keep_ratio

    def forward(self, x):
        w, h = self._size
        if self._keep:
            ih, iw = x.shape[0], x.shape[1]
            scale = min(w / iw, h / ih)
            w, h = int(iw * scale), int(ih * scale)
        return image.imresize(x, w, h)


class CenterCrop(Block):
    """The centre ``size`` (w, h) of the image, resized up where the
    image is smaller."""

    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (list, tuple)) else (size, size)

    def forward(self, x):
        return image.center_crop(x, self._size)[0]


class RandomResizedCrop(Block):
    """A crop of random area (``scale`` of the image's) and aspect ratio
    (``ratio``), resized to ``size``."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = size if isinstance(size, (list, tuple)) else (size, size)
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        return image.random_size_crop(x, self._size, self._scale,
                                      self._ratio)[0]


def _flip(x, axis):
    """HWC image ``x`` reversed along ``axis``, where it lies."""
    return NDArray(torch.flip(x.data, (axis,)), x.context)


class RandomFlipLeftRight(Block):
    """The image mirrored left to right with probability 1/2."""

    def forward(self, x):
        return _flip(x, 1) if _np.random.rand() < 0.5 else x


class RandomFlipTopBottom(Block):
    """The image flipped top to bottom with probability 1/2."""

    def forward(self, x):
        return _flip(x, 0) if _np.random.rand() < 0.5 else x
