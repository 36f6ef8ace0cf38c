"""Detection image pipeline of the PyTorch port: box-aware augmenters and
ImageDetIter.

Counterpart of ``mxtpu/image_detection.py``. A label is an [N, 5+] float
array per image, a row per object: ``[class_id, xmin, ymin, xmax, ymax,
...]`` with corners normalized to [0, 1]; a batch pads its rows with -1,
which MultiBoxTarget reads as padding.

The geometry runs in numpy on the host and the augmenters draw from
Python's ``random`` in ``mxtpu``'s order, so a seeded run of either
package crops, pads and mirrors alike. Images are HWC NDArrays on the
host (:mod:`mxtpu_torch.image`); ImageDetIter decodes and augments in the
calling thread, as ``mxtpu``'s does, and a batch goes to the card where
the consumer copies it.
"""
from __future__ import annotations

import inspect
import json
import random as _random

import numpy as _np
import torch

from . import image as _img
from .ndarray import NDArray

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """Base detection augmenter: ``__call__(src, label) -> (src, label)``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """A classification augmenter on the image; the boxes stay (for
    colour and cast augmenters)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.dumps()
                         if hasattr(augmenter, "dumps") else str(augmenter))
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """One augmenter of the list, picked at random, or none with
    probability ``skip_prob``."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if not self.aug_list or _random.random() < self.skip_prob:
            return src, label
        return _random.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror the image and the x coordinates with probability ``p``."""

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _random.random() < self.p:
            src = NDArray(torch.flip(src.data, dims=(1,)), src.context)
            label = label.copy()
            xmin = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - xmin
        return src, label


def _box_iob(boxes, crop):
    """Intersection over box area of each [xmin, ymin, xmax, ymax] box
    with the crop window (``min_object_covered`` /
    ``min_eject_coverage``'s measure)."""
    ix = _np.maximum(0.0, _np.minimum(boxes[:, 2], crop[2])
                     - _np.maximum(boxes[:, 0], crop[0]))
    iy = _np.maximum(0.0, _np.minimum(boxes[:, 3], crop[3])
                     - _np.maximum(boxes[:, 1], crop[1]))
    inter = ix * iy
    area = _np.maximum(1e-12, (boxes[:, 2] - boxes[:, 0])
                       * (boxes[:, 3] - boxes[:, 1]))
    return inter / area


class DetRandomCropAug(DetAugmenter):
    """Random crop constrained by object coverage: a window whose aspect
    and area lie in range and which covers at least
    ``min_object_covered`` of some object; boxes covered less than
    ``min_eject_coverage`` are dropped, the rest clipped and normalized to
    the crop."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 min_eject_coverage=0.3, max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def _sample(self, label):
        for _ in range(self.max_attempts):
            area = _random.uniform(*self.area_range)
            ratio = _random.uniform(*self.aspect_ratio_range)
            w = min(1.0, (area * ratio) ** 0.5)
            h = min(1.0, (area / ratio) ** 0.5)
            x0 = _random.uniform(0.0, 1.0 - w)
            y0 = _random.uniform(0.0, 1.0 - h)
            crop = _np.array([x0, y0, x0 + w, y0 + h])
            if label.shape[0] == 0:
                return crop
            if _box_iob(label[:, 1:5], crop).max() >= \
                    self.min_object_covered:
                return crop
        return None

    def _update_labels(self, label, crop):
        if label.shape[0] == 0:
            return label
        keep = _box_iob(label[:, 1:5], crop) >= self.min_eject_coverage
        out = label[keep].copy()
        if out.shape[0] == 0:
            return None
        w, h = crop[2] - crop[0], crop[3] - crop[1]
        out[:, 1] = _np.clip((out[:, 1] - crop[0]) / w, 0.0, 1.0)
        out[:, 3] = _np.clip((out[:, 3] - crop[0]) / w, 0.0, 1.0)
        out[:, 2] = _np.clip((out[:, 2] - crop[1]) / h, 0.0, 1.0)
        out[:, 4] = _np.clip((out[:, 4] - crop[1]) / h, 0.0, 1.0)
        return out

    def __call__(self, src, label):
        crop = self._sample(label)
        if crop is None:
            return src, label
        new_label = self._update_labels(label, crop)
        if new_label is None:     # every object ejected: no crop
            return src, label
        H, W = src.shape[0], src.shape[1]
        x0, y0 = int(crop[0] * W), int(crop[1] * H)
        x1, y1 = max(x0 + 1, int(crop[2] * W)), max(y0 + 1, int(crop[3] * H))
        return NDArray(src.data[y0:y1, x0:x1], src.context), new_label


class DetRandomPadAug(DetAugmenter):
    """Random expansion (SSD's zoom-out): the image at a random offset
    inside a larger ``pad_val`` canvas, the boxes normalized to it."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        H, W = src.shape[0], src.shape[1]
        for _ in range(self.max_attempts):
            area = _random.uniform(*self.area_range)
            ratio = _random.uniform(*self.aspect_ratio_range)
            nw, nh = int(W * (area * ratio) ** 0.5), \
                int(H * (area / ratio) ** 0.5)
            if nw < W or nh < H:
                continue
            x0 = _random.randint(0, nw - W)
            y0 = _random.randint(0, nh - H)
            pix = src.asnumpy()
            canvas = _np.empty((nh, nw, src.shape[2]), pix.dtype)
            canvas[:] = _np.asarray(self.pad_val, pix.dtype)
            canvas[y0:y0 + H, x0:x0 + W] = pix
            out = label.copy()
            if out.shape[0]:
                out[:, 1] = (out[:, 1] * W + x0) / nw
                out[:, 3] = (out[:, 3] * W + x0) / nw
                out[:, 2] = (out[:, 2] * H + y0) / nh
                out[:, 4] = (out[:, 4] * H + y0) / nh
            return _img._host(canvas), out
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """The standard detection chain: resize, random crop and pad (each
    with its own probability, through DetRandomSelectAug), colour jitter,
    mirror, the forced resize to ``data_shape``, cast and normalize."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(_img.ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        auglist.append(DetRandomSelectAug([DetRandomCropAug(
            min_object_covered, aspect_ratio_range,
            (area_range[0], min(1.0, area_range[1])),
            min_eject_coverage, max_attempts)], 1 - rand_crop))
    if rand_pad > 0:
        auglist.append(DetRandomSelectAug(
            [DetRandomPadAug(aspect_ratio_range,
                             (1.0, max(1.0, area_range[1])), max_attempts,
                             pad_val)], 1 - rand_pad))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(_img.ColorJitterAug(
            brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(_img.HueJitterAug(hue)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(_img.RandomGrayAug(rand_gray)))
    if pca_noise > 0:
        auglist.append(DetBorrowAug(_img.LightingAug(
            pca_noise,
            _np.array([55.46, 4.794, 1.148]),
            _np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]]))))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetBorrowAug(_img.ForceResizeAug(
        (data_shape[2], data_shape[1]), inter_method)))
    auglist.append(DetBorrowAug(_img.CastAug()))
    if mean is not None or std is not None:
        if mean is True or mean is None:
            mean = _np.array([123.68, 116.28, 103.53])
        if std is True or std is None:
            std = _np.array([58.395, 57.12, 57.375])
        auglist.append(DetBorrowAug(_img.ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(_img.ImageIter):
    """Detection iterator: batches of images with [B, max_objects,
    label_width] labels, padded with -1. It decodes and augments in the
    calling thread."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, imglist=None,
                 shuffle=False, aug_list=None, label_width=5,
                 data_name="data", label_name="label",
                 last_batch_handle="pad", part_index=0, num_parts=1,
                 **kwargs):
        if aug_list is None:
            unknown = set(kwargs) - set(
                inspect.signature(CreateDetAugmenter).parameters)
            if unknown:
                raise TypeError("unexpected ImageDetIter arguments: %s"
                                % sorted(unknown))
            aug_list = CreateDetAugmenter(data_shape, **kwargs)
        elif kwargs:
            raise TypeError("unexpected ImageDetIter arguments: %s"
                            % sorted(kwargs))
        super().__init__(
            batch_size, data_shape, path_imgrec=path_imgrec,
            path_imglist=path_imglist, path_root=path_root,
            imglist=imglist, shuffle=shuffle,
            aug_list=[],                 # the detection chain runs in _load
            data_name=data_name, label_name=label_name,
            last_batch_handle=last_batch_handle,
            part_index=part_index, num_parts=num_parts)
        self.det_auglist = aug_list
        self.label_width = label_width
        self._items = [(src, self._parse_label(lbl))
                       for src, lbl in self._items]
        self.max_objects = max(
            [lbl.shape[0] for _, lbl in self._items] or [1])

    def _parse_label(self, label):
        """A flat record label [header_width, obj_width, extra...,
        objects...] as [N, obj_width]; an [N, 5+] array as it is."""
        arr = _np.asarray(label, _np.float32)
        if arr.ndim == 2 and arr.shape[1] >= 5:
            return arr
        raw = arr.ravel()
        if raw.size >= 2 and float(raw[0]).is_integer() \
                and 2 <= raw[0] <= raw.size:
            header_width = int(raw[0])
            obj_width = int(raw[1])
            body = raw[header_width:]
            if obj_width >= 5 and body.size % obj_width == 0:
                return body.reshape(-1, obj_width).astype(_np.float32)
        raise ValueError(
            "cannot parse detection label of shape %s; expected flat "
            "[header_width, obj_width, ...] or an [N, >=5] array"
            % (arr.shape,))

    @property
    def provide_label(self):
        from .io import DataDesc
        return [DataDesc(self._label_name,
                         (self.batch_size, self.max_objects,
                          self.label_width))]

    @property
    def label_shape(self):
        return (self.max_objects, self.label_width)

    def reshape(self, data_shape=None, label_shape=None):
        """Change the data and label shapes between epochs; the chain's
        forced resize follows the data shape."""
        if data_shape is not None:
            self.data_shape = tuple(data_shape)
            size = (self.data_shape[2], self.data_shape[1])
            for aug in self.det_auglist:
                inner = getattr(aug, "augmenter", None)
                if isinstance(inner, _img.ForceResizeAug):
                    inner.size = size
        if label_shape is not None:
            self.max_objects = int(label_shape[0])
            self.label_width = int(label_shape[1])

    def sync_label_shape(self, it, verbose=False):
        """Make two iterators (train and validation) agree on the padded
        label shape."""
        assert isinstance(it, ImageDetIter)
        n = max(self.max_objects, it.max_objects)
        w = max(self.label_width, it.label_width)
        self.max_objects = it.max_objects = n
        self.label_width = it.label_width = w
        return it

    def _load(self, item):
        src, label = item
        if isinstance(src, (bytes, bytearray)):
            img = _img.imdecode(src)
        else:
            img = _img.imread(src)
        label = _np.asarray(label, _np.float32)
        for aug in self.det_auglist:
            img, label = aug(img, label)
        padded = _np.full((self.max_objects, self.label_width), -1.0,
                          _np.float32)
        n = min(label.shape[0], self.max_objects)
        w = min(label.shape[1], self.label_width)
        padded[:n, :w] = label[:n, :w]
        chw = img.data.to(torch.float32).permute(2, 0, 1)
        return NDArray(chw, img.context), padded
