"""Image API of the PyTorch port: decode, resize, crops, augmenters, and
the record pipelines behind ``mx.io.ImageRecordIter``.

Counterpart of ``mxtpu/image.py``. Images are decoded on the host (PIL
and numpy) into NDArrays on ``cpu()``, whatever the current context: the
pipelines run in worker threads and processes, and a batch goes to the
card once, where the module that consumes it copies it
(:func:`mxtpu_torch.io.stage_batch`). The augmenters' arithmetic runs in
torch where ``mxtpu``'s runs in XLA (float32 either way), and in numpy
where ``mxtpu``'s does.

Two record pipelines, chosen as ``mxtpu`` chooses them:

- ``_FastRecordIter``: a spawned process pool running
  :mod:`mxtpu_torch._image_worker` (decode, crop, mirror, MXNet's default
  record augmenter) for the fixed-function configurations; its batches
  equal ``mxtpu``'s bit for bit. The pool starts with the card hidden
  from its children, and a worker that dies, or a batch that does not
  arrive within ``MXTPU_IMAGE_POOL_TIMEOUT`` seconds, raises.
- ``ImageIter`` under :class:`mxtpu_torch.io.PrefetchingIter` (one
  background thread) for everything else: custom augmenters,
  ``mean_img``, multi-label records.

A script that builds an ``ImageRecordIter`` must guard its top level
with ``if __name__ == "__main__":``: each spawned decode worker imports
the main module again.
"""
from __future__ import annotations

import collections
import io as _io
import logging
import multiprocessing
import os
import random as _random
import time

import numpy as _np
import torch

from . import ndarray as nd
from .context import cpu
from .io import DataBatch, DataDesc, PrefetchingIter
from .ndarray import NDArray

_log = logging.getLogger(__name__)

# hard deadline on one decode batch from the process pool; ten minutes is
# far beyond any real decode+augment batch
_POOL_BATCH_TIMEOUT = float(os.environ.get(
    "MXTPU_IMAGE_POOL_TIMEOUT", "600"))
# how often a wait for a pool batch checks that every worker still lives
_POOL_TICK = 1.0

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "random_size_crop", "color_normalize",
           "HorizontalFlipAug", "RandomCropAug", "CenterCropAug",
           "ResizeAug", "ForceResizeAug", "CastAug", "ColorNormalizeAug",
           "RandomSizedCropAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "ColorJitterAug", "LightingAug",
           "RandomOrderAug", "CreateAugmenter", "Augmenter", "ImageIter"]


def _to_np(img):
    if isinstance(img, NDArray):
        return img.asnumpy()
    return _np.asarray(img)


def _host(arr, dtype=None):
    """An NDArray on the host of a numpy array (``nd.array``'s dtype
    rules)."""
    return nd.array(arr, ctx=cpu(), dtype=dtype)


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode a jpeg/png byte buffer to an HWC uint8 NDArray on the host."""
    from PIL import Image
    img = Image.open(_io.BytesIO(buf if isinstance(buf, (bytes, bytearray))
                                 else bytes(buf)))
    img = img.convert("RGB" if flag else "L")
    arr = _np.asarray(img, dtype=_np.uint8)
    if not flag:
        arr = arr[:, :, None]
    return _host(arr, _np.uint8)


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


def imresize(src, w, h, interp=1):
    from PIL import Image
    arr = _to_np(src)
    squeeze = arr.shape[-1] == 1
    img = Image.fromarray(arr[..., 0] if squeeze else arr.astype(_np.uint8))
    img = img.resize((w, h),
                     Image.NEAREST if interp == 0 else Image.BILINEAR)
    out = _np.asarray(img)
    if squeeze:
        out = out[:, :, None]
    return _host(out, arr.dtype)


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = _host(_to_np(src)[y0:y0 + h, x0:x0 + w, :])
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max(0, (w - new_w) // 2)
    y0 = max(0, (h - new_h) // 2)
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = _random.randint(0, max(0, w - new_w))
    y0 = _random.randint(0, max(0, h - new_h))
    out = fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = _random.uniform(area[0], area[1]) * src_area
        log_ratio = (_np.log(ratio[0]), _np.log(ratio[1]))
        aspect = _np.exp(_random.uniform(*log_ratio))
        new_w = int(round((target_area * aspect) ** 0.5))
        new_h = int(round((target_area / aspect) ** 0.5))
        if new_w <= w and new_h <= h:
            x0 = _random.randint(0, w - new_w)
            y0 = _random.randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def _on(value, ctx):
    """``value`` (NDArray, numpy or list) as an NDArray on ``ctx``."""
    if isinstance(value, NDArray):
        return value.as_in_context(ctx)
    return nd.array(value, ctx=ctx)


def color_normalize(src, mean, std=None):
    if mean is not None:
        src = src - _on(mean, src.context)
    if std is not None:
        src = src / _on(std, src.context)
    return src


class Augmenter:
    """Base of the image augmenters: a callable on an HWC NDArray."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size, self.interp = size, interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size, self.area, self.ratio, self.interp = \
            size, area, ratio, interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _random.random() < self.p:
            return _host(_to_np(src)[:, ::-1, :])
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _random.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], dtype=_np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + _random.uniform(-self.contrast, self.contrast)
        arr = _to_np(src).astype(_np.float32)
        gray = (arr * self._coef).sum() * (3.0 / arr.size)
        return _host(arr * alpha + gray * (1.0 - alpha))


class SaturationJitterAug(Augmenter):
    _coef = _np.array([[[0.299, 0.587, 0.114]]], dtype=_np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + _random.uniform(-self.saturation, self.saturation)
        arr = _to_np(src).astype(_np.float32)
        gray = (arr * self._coef).sum(axis=2, keepdims=True)
        return _host(arr * alpha + gray * (1.0 - alpha))


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        _random.shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class RandomGrayAug(Augmenter):
    """Convert to 3-channel grayscale with probability p (BT.709-like luma
    weights, as MXNet's RandomGrayAug)."""

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p
        self._coef = _np.array([[[0.21, 0.72, 0.07]]], _np.float32)

    def __call__(self, src):
        if _random.random() < self.p:
            x = src.data.to(torch.float32)
            gray = (x * torch.from_numpy(self._coef).to(x.device)).sum(
                dim=2, keepdim=True)
            src = NDArray(gray.expand(src.shape).to(src.data.dtype),
                          src.context)
        return src


class HueJitterAug(Augmenter):
    """Random hue rotation in [-hue, hue] via the YIQ linear
    approximation."""

    def __init__(self, hue=0.0):
        super().__init__(hue=hue)
        self.hue = hue
        self.tyiq = _np.array([[0.299, 0.587, 0.114],
                               [0.596, -0.274, -0.321],
                               [0.211, -0.523, 0.311]], _np.float32)
        self.ityiq = _np.array([[1.0, 0.956, 0.621],
                                [1.0, -0.272, -0.647],
                                [1.0, -1.107, 1.705]], _np.float32)

    def __call__(self, src):
        alpha = _random.uniform(-self.hue, self.hue)
        u, w = _np.cos(alpha * _np.pi), _np.sin(alpha * _np.pi)
        bt = _np.array([[1.0, 0.0, 0.0],
                        [0.0, u, -w],
                        [0.0, w, u]], _np.float32)
        t = _np.dot(_np.dot(self.ityiq, bt), self.tyiq).T
        x = src.data.to(torch.float32)
        return NDArray(x @ torch.from_numpy(t).to(x.device), src.context)


class LightingAug(Augmenter):
    """PCA lighting noise."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval)
        self.eigvec = _np.asarray(eigvec)

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd, size=(3,))
        rgb = _np.dot(self.eigvec * alpha, self.eigval)
        return src + nd.array(rgb, ctx=src.context)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = _host(mean) if mean is not None else None
        self.std = _host(std) if std is not None else None

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


def _affine_hsl_cfg(max_rotate_angle=0, max_shear_ratio=0.0,
                    min_random_scale=1.0, max_random_scale=1.0,
                    max_aspect_ratio=0.0, random_h=0, random_s=0,
                    random_l=0):
    """(affine cfg, hsl cfg) dicts for the record iterator's default
    augmenter: one source for the pool workers and CreateAugmenter."""
    affine = {}
    if max_rotate_angle or max_shear_ratio or max_aspect_ratio or \
            (min_random_scale, max_random_scale) != (1.0, 1.0):
        affine = {"max_rotate_angle": max_rotate_angle,
                  "max_shear_ratio": max_shear_ratio,
                  "min_random_scale": min_random_scale,
                  "max_random_scale": max_random_scale,
                  "max_aspect_ratio": max_aspect_ratio}
    hsl = {}
    if random_h or random_s or random_l:
        hsl = {"random_h": random_h, "random_s": random_s,
               "random_l": random_l}
    return affine, hsl


class RecordDefaultAug(Augmenter):
    """The record iterator's default geometry and color augmenters (pad,
    affine rotate/shear/scale/aspect, h/s/l jitter), the pool workers'
    own functions (:mod:`mxtpu_torch._image_worker`)."""

    def __init__(self, pad=0, fill_value=127, affine=None, hsl=None):
        super().__init__(pad=pad, fill_value=fill_value,
                         affine=affine or {}, hsl=hsl or {})
        self.pad = pad
        self.fill_value = fill_value
        self.affine = affine or {}
        self.hsl = hsl or {}

    def __call__(self, src):
        from . import _image_worker as w
        arr = _np.clip(src.asnumpy(), 0, 255).astype(_np.uint8)
        rng = _np.random.RandomState(_random.randint(0, 2 ** 31 - 1))
        if self.affine:
            arr = w.affine_augment(arr, rng, fill_value=self.fill_value,
                                   **self.affine)
        if self.pad:
            arr = w.pad_image(arr, self.pad, self.fill_value)
        if self.hsl:
            arr = w.hsl_jitter(arr, rng, **self.hsl)
        return _host(arr)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2, pad=0, fill_value=127,
                    max_random_scale=1.0, min_random_scale=1.0,
                    max_aspect_ratio=0.0, max_rotate_angle=0,
                    max_shear_ratio=0.0, random_h=0, random_s=0,
                    random_l=0):
    """The standard augmenter list, in ``mxtpu``'s order."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    affine, hsl = _affine_hsl_cfg(max_rotate_angle, max_shear_ratio,
                                  min_random_scale, max_random_scale,
                                  max_aspect_ratio, random_h, random_s,
                                  random_l)
    if affine or pad or hsl:
        # pre-crop geometry and color of the record iterator; the h/s/l
        # jitter runs here, on uint8, rather than after the cast
        auglist.append(RecordDefaultAug(pad, fill_value, affine, hsl))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3.0 / 4.0, 4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = _np.array([55.46, 4.794, 1.148])
        eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                            [-0.5808, -0.0045, -0.8140],
                            [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        # MXNet's order: ColorJitter, Hue, Lighting, then RandomGray
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and (not hasattr(mean, "size") or mean.size > 0):
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Image iterator over an image list or RecordIO file with augmenters,
    decoding in the calling thread; batches on the host."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label",
                 part_index=0, num_parts=1, last_batch_handle="pad",
                 **kwargs):
        if last_batch_handle not in ("pad", "discard"):
            raise ValueError("last_batch_handle must be 'pad' or "
                             "'discard', got %r" % last_batch_handle)
        self.last_batch_handle = last_batch_handle
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self._shuffle = shuffle
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **kwargs)
        self._data_name = data_name
        self._label_name = label_name
        self._items = []  # (path-or-bytes, label)
        if path_imgrec is not None:
            self._items.extend(
                _read_record_items(path_imgrec, part_index, num_parts))
        elif imglist is not None:
            for entry in imglist:
                label, path = entry[0], entry[-1]
                self._items.append((os.path.join(path_root or "", path),
                                    label))
        elif path_imglist is not None:
            with open(path_imglist) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    label = [float(x) for x in parts[1:-1]]
                    self._items.append(
                        (os.path.join(path_root or "", parts[-1]),
                         label[0] if len(label) == 1 else _np.array(label)))
        self._order = list(range(len(self._items)))
        self.reset()

    def reset(self):
        if self._shuffle:
            _random.shuffle(self._order)
        self._cursor = 0

    def state_dict(self):
        # the shuffled order is part of the cursor: restoring cursor=k
        # into a differently-shuffled order would replay or skip samples
        return {"cursor": int(self._cursor), "order": list(self._order)}

    def load_state_dict(self, state):
        self._order = list(state["order"])
        self._cursor = int(state["cursor"])

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self._label_name, (self.batch_size,))]

    def __iter__(self):
        return self

    def _load(self, item):
        src, label = item
        if isinstance(src, (bytes, bytearray)):
            img = imdecode(src)
        else:
            img = imread(src)
        for aug in self.auglist:
            img = aug(img)
        chw = img.data.to(torch.float32).permute(2, 0, 1)
        return NDArray(chw, img.context), label

    def next(self):
        if self._cursor >= len(self._items):
            raise StopIteration
        if self.last_batch_handle == "discard" and \
                len(self._items) - self._cursor < self.batch_size:
            raise StopIteration
        datas, labels = [], []
        while len(datas) < self.batch_size:
            if self._cursor >= len(self._items):
                idx = self._order[0]
            else:
                idx = self._order[self._cursor]
                self._cursor += 1
            d, l = self._load(self._items[idx])
            datas.append(d)
            labels.append(l)
        data = nd.stack(*datas, axis=0)
        label = _host(_np.asarray(labels))
        return DataBatch(data=[data], label=[label])

    __next__ = next


def _spawn_safe():
    """Whether multiprocessing's spawn can import the parent's __main__
    again.

    Spawn re-runs the main module in each worker; when the parent is fed
    from stdin (``python -`` / heredoc), __main__.__file__ is "<stdin>"
    and every worker dies in prepare() and is respawned forever. Detect
    that and let callers fall back to the in-process pipeline."""
    if multiprocessing.current_process().name != "MainProcess":
        # already inside a worker (a script without a __main__ guard):
        # never build a pool of pools
        return False
    import __main__ as main_mod
    main_file = getattr(main_mod, "__file__", None)
    return main_file is None or os.path.exists(main_file)


def _read_record_items(path_imgrec, part_index=0, num_parts=1):
    """Read a recordio shard into (jpeg_bytes, label) items: record i
    belongs to part i % num_parts, and every part keeps the same count."""
    from . import recordio
    idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
    rec = recordio.MXIndexedRecordIO(idx_path, path_imgrec, "r") \
        if os.path.exists(idx_path) else \
        recordio.MXRecordIO(path_imgrec, "r")
    items = []
    rec_idx = 0
    while True:
        item = rec.read()
        if item is None:
            break
        if rec_idx % num_parts == part_index:
            header, img = recordio.unpack(item)
            items.append((img, header.label))
        rec_idx += 1
    rec.close()
    if num_parts > 1:
        # equal shard sizes across workers: a collective step is a
        # blocking all-process operation, so every rank must see the
        # same number of batches an epoch
        equal = rec_idx // num_parts
        items = items[:equal]
    return items


class _FastRecordIter:
    """Process-pool decode+augment pipeline: ``nprocs`` spawned workers
    run :func:`mxtpu_torch._image_worker.decode_augment`, and
    ``prefetch_buffer`` batches stay in flight, so decoding overlaps the
    consumer's step.

    The pool's children import the package (and torch) to reach the
    worker module, so the pool starts with ``CUDA_VISIBLE_DEVICES`` empty:
    a decode worker cannot initialise the card. ``startup_s`` is the time
    from the pool's start to its first batch decoded (None before).

    Each batch is normalized and put in NCHW order in one pass, written
    into a host tensor that is pinned when the process has a card, so the
    consumer's one copy up (``Module.prepare``) does not wait for the
    card's queue. Each batch takes a fresh tensor from torch's pinned
    allocator, which reuses a block only after the copies queued out of
    it have run (an event recorded with each copy), so a batch is never
    overwritten under a copy in flight."""

    def __init__(self, items, batch_size, data_shape, cfg, shuffle,
                 nprocs, prefetch_buffer, data_name, label_name, seed=0):
        from . import _image_worker
        self._items = items
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self._shuffle = shuffle
        self._depth = max(1, int(prefetch_buffer))
        self._data_name = data_name
        self._label_name = label_name
        self._seed = seed
        self._epoch = 0
        self._mean = cfg.get("mean")
        self._std = cfg.get("std")
        self._pin = torch.cuda.is_available()
        ctx = multiprocessing.get_context("spawn")
        self.startup_s = None
        self._t0 = time.perf_counter()
        prev = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            self._pool = ctx.Pool(max(1, int(nprocs)),
                                  initializer=_image_worker.init_worker,
                                  initargs=(cfg,))
        finally:
            if prev is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = prev
        self._workers = self._worker_pids()
        self._order = list(range(len(items)))
        self.reset()

    def _worker_pids(self):
        return sorted(p.pid for p in self._pool._pool)

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self._label_name, (self.batch_size,))]

    def reset(self):
        self._epoch += 1
        if self._shuffle:
            rng = _np.random.RandomState(self._seed + self._epoch)
            rng.shuffle(self._order)
        self._cursor = 0
        self._pending = collections.deque()
        for _ in range(self._depth):
            self._submit()

    def _submit(self):
        if self._cursor >= len(self._order):
            return
        from . import _image_worker
        n = len(self._order)
        idxs = []
        while len(idxs) < self.batch_size:
            idxs.append(self._order[self._cursor % n])
            self._cursor += 1
        pad = max(0, self._cursor - n)
        if pad:
            self._cursor = n + 1  # epoch exhausted
        tasks = [(self._seed + self._epoch * 7919 + i, self._items[i][0],
                  float(self._items[i][1])
                  if _np.isscalar(self._items[i][1]) or
                  getattr(self._items[i][1], "ndim", 1) == 0
                  else float(_np.asarray(self._items[i][1]).reshape(-1)[0]))
                 for i in idxs]
        chunk = max(1, self.batch_size // (2 * self._pool._processes))
        first = self._epoch == 1 and self._cursor <= self.batch_size
        res = self._pool.map_async(_image_worker.decode_augment, tasks,
                                   chunksize=chunk,
                                   callback=self._decoded if first else None)
        self._pending.append((res, pad))

    def _decoded(self, _batch):
        """Runs in the pool's result thread when the first batch is in."""
        self.startup_s = time.perf_counter() - self._t0

    def _check_workers(self):
        """Raise if a worker died: the pool replaces it, but the tasks it
        held are lost, and a batch waiting on them never arrives."""
        if self._worker_pids() != self._workers:
            raise RuntimeError("an image decode worker died (pool workers "
                               "%s, now %s)" % (self._workers,
                                                self._worker_pids()))

    def _wait(self, res):
        """The batch of ``res``; raises when a worker died or nothing came
        within _POOL_BATCH_TIMEOUT."""
        deadline = time.monotonic() + _POOL_BATCH_TIMEOUT
        while True:
            self._check_workers()
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(
                    "image decode pool delivered nothing for %.0fs "
                    "(MXTPU_IMAGE_POOL_TIMEOUT raises the deadline)"
                    % _POOL_BATCH_TIMEOUT)
            try:
                return res.get(min(_POOL_TICK, left))
            except multiprocessing.TimeoutError:
                pass

    def next(self):
        if not self._pending:
            raise StopIteration
        res, pad = self._pending.popleft()
        self._submit()      # keep the pool at full depth while we wait
        out = self._wait(res)
        # uint8 HWC -> float32 NCHW, normalized, in one pass over the batch
        u8 = _np.stack([a for a, _l in out])
        host = torch.empty((u8.shape[0], u8.shape[3]) + u8.shape[1:3],
                           dtype=torch.float32, pin_memory=self._pin)
        arrs = host.numpy()
        arrs[...] = u8.transpose(0, 3, 1, 2)
        if self._mean is not None:
            arrs -= self._mean[:, None, None]
        if self._std is not None:
            arrs /= self._std[:, None, None]
        labels = _np.asarray([_l for _a, _l in out], _np.float32)
        return DataBatch(data=[NDArray(host, cpu())],
                         label=[_host(labels)], pad=pad)

    __next__ = next

    def __iter__(self):
        return self

    def close(self):
        self._pool.terminate()

    def __del__(self):
        try:
            self._pool.terminate()
        except Exception as e:
            # interpreter-teardown races are expected; anything else in
            # the log beats silence
            _log.debug("image pool teardown failed: %s", e)


class ImageRecordIterImpl:
    """RecordIO image pipeline (MXNet's ImageRecordIter v2: shard ->
    parallel decode+augment -> batch -> prefetch), as ``mxtpu`` builds it.

    Two paths: the fixed-function pipeline (resize / crop / mirror /
    mean-std, pad, affine, h/s/l) runs on a spawned process pool
    (``preprocess_threads`` workers, :class:`_FastRecordIter`);
    configurations outside that surface (other keywords, ``mean_img``,
    multi-label) and parents that cannot spawn (fed from stdin, or a
    pool worker themselves) take the in-process :class:`ImageIter` under
    a background-thread :class:`~mxtpu_torch.io.PrefetchingIter`.
    ``_prefetch`` is the iterator that serves the batches.

    Keywords: path_imgrec, data_shape, batch_size, shuffle, rand_crop,
    rand_mirror, mean_r/g/b, std_r/g/b, resize, label_width,
    part_index/num_parts (sharding), preprocess_threads, prefetch_buffer,
    pad, fill_value and the default augmenter's ranges.

    A script that builds this iterator at its top level must guard it
    with ``if __name__ == "__main__":``: each decode worker imports the
    main module again, and an unguarded script re-runs its top level in
    every worker.
    """

    def __init__(self, path_imgrec, data_shape, batch_size, shuffle=False,
                 rand_crop=False, rand_mirror=False, mean_img=None,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=0.0, std_g=0.0,
                 std_b=0.0, resize=0, label_width=1, part_index=0,
                 num_parts=1, preprocess_threads=4, prefetch_buffer=4,
                 data_name="data", label_name="softmax_label",
                 pad=0, fill_value=127, max_random_scale=1.0,
                 min_random_scale=1.0, max_aspect_ratio=0.0,
                 max_rotate_angle=0, max_shear_ratio=0.0,
                 random_h=0, random_s=0, random_l=0, **kwargs):
        mean = None
        if mean_r or mean_g or mean_b:
            mean = _np.array([mean_r, mean_g, mean_b])
        std = None
        if std_r or std_g or std_b:
            std = _np.array([std_r or 1.0, std_g or 1.0, std_b or 1.0])
        affine, hsl = _affine_hsl_cfg(max_rotate_angle, max_shear_ratio,
                                      min_random_scale, max_random_scale,
                                      max_aspect_ratio, random_h,
                                      random_s, random_l)
        fast_ok = (not kwargs and not mean_img and label_width == 1
                   and len(data_shape) == 3 and data_shape[0] == 3
                   and int(preprocess_threads) >= 1 and _spawn_safe())
        if fast_ok:
            items = _read_record_items(path_imgrec, part_index, num_parts)
            cfg = {"crop_h": data_shape[1], "crop_w": data_shape[2],
                   "resize": resize, "rand_crop": bool(rand_crop),
                   "rand_mirror": bool(rand_mirror),
                   "pad": int(pad), "fill_value": int(fill_value),
                   "affine": affine, "hsl": hsl,
                   "mean": None if mean is None
                   else mean.astype(_np.float32),
                   "std": None if std is None else std.astype(_np.float32)}
            self._prefetch = _FastRecordIter(
                items, batch_size, data_shape, cfg, shuffle,
                preprocess_threads, prefetch_buffer, data_name, label_name)
            self._inner = self._prefetch
            return
        self._inner = ImageIter(
            batch_size, data_shape, label_width=label_width,
            path_imgrec=path_imgrec, shuffle=shuffle,
            rand_crop=rand_crop, rand_mirror=rand_mirror, mean=mean,
            std=std, resize=resize,
            pad=pad, fill_value=fill_value,
            max_random_scale=max_random_scale,
            min_random_scale=min_random_scale,
            max_aspect_ratio=max_aspect_ratio,
            max_rotate_angle=max_rotate_angle,
            max_shear_ratio=max_shear_ratio,
            random_h=random_h, random_s=random_s, random_l=random_l,
            data_name=data_name, label_name=label_name,
            part_index=part_index, num_parts=num_parts, **kwargs)
        if mean_img:
            self._install_mean_img(mean_img)
        self._prefetch = PrefetchingIter(self._inner)

    def _install_mean_img(self, mean_img):
        """Mean-image subtraction: the mean image is loaded from
        ``mean_img``, or computed over the shard with the augmenters and
        saved there on first use."""
        inner = self._inner
        if os.path.exists(mean_img):
            loaded = nd.load(mean_img, ctx=cpu())
            mean_arr = (loaded["mean_img"] if isinstance(loaded, dict)
                        else loaded[0]).asnumpy()
        else:
            total = None
            count = 0
            for item in inner._items:
                img = imdecode(item[0]) if isinstance(
                    item[0], (bytes, bytearray)) else imread(item[0])
                for aug in inner.auglist:
                    img = aug(img)
                arr = img.asnumpy().astype(_np.float64)
                total = arr if total is None else total + arr
                count += 1
            mean_arr = (total / max(count, 1)).astype(_np.float32)
            nd.save(mean_img, {"mean_img": _host(mean_arr)})

        class _MeanImageAug(Augmenter):
            def __init__(self, m):
                super().__init__()
                self._m = _host(m)

            def __call__(self, src):
                return src.astype("float32") - self._m

        inner.auglist = list(inner.auglist) + [_MeanImageAug(mean_arr)]

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._prefetch, name)

    def __iter__(self):
        return self._prefetch.__iter__()

    def __next__(self):
        return self._prefetch.__next__()
