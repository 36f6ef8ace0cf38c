"""Decode-and-augment worker of the port's ImageRecordIter pool.

Counterpart of ``mxtpu/_image_worker.py``, arithmetic for arithmetic: for
a given (seed, bytes, label) and configuration :func:`decode_augment`
returns the same uint8 array as ``mxtpu``'s, bit for bit. The module
imports numpy and cv2 or PIL and nothing of the port, so it computes no
tensor and never touches the card; a spawned worker still runs the
package's ``__init__`` (and imports torch) to reach it, which is why the
pool starts with the card hidden (``mxtpu_torch.image._FastRecordIter``).

Each record: JPEG decode -> resize -> (random|center) crop -> optional
mirror, with MXNet's default record augmenter around it (affine
rotate/shear/scale/aspect, pad, h/s/l jitter), in uint8/float32 numpy.
cv2 decodes when it can be imported, PIL otherwise (``force_pil`` picks
PIL); both give RGB HWC uint8 with the same crop geometry.
"""
from __future__ import annotations

import io

import numpy as np

try:
    import cv2 as _cv2
except ImportError:  # pragma: no cover
    _cv2 = None

_CFG = {}


def init_worker(cfg):
    """Pool initializer: stash the static pipeline config. Runs inside
    each worker process (and in-process for the unit-cost benchmark)."""
    _CFG.clear()
    _CFG.update(cfg)
    if _cv2 is not None:
        # workers are the parallelism; no nested cv2 threads. Note this is
        # process-wide: in-process callers (the unit-cost benchmark, the
        # parity tests) also lose cv2-internal threading after init_worker,
        # which is the behavior a single-core measurement wants anyway.
        _cv2.setNumThreads(0)


def _decode_resize_cv2(buf, resize):
    arr = _cv2.imdecode(np.frombuffer(buf, np.uint8), _cv2.IMREAD_COLOR)
    if arr is None:
        # cv2 can't decode every format PIL can (GIF stragglers in
        # scraped datasets) — fall back per record rather than fail
        return _decode_resize_pil(buf, resize)
    arr = _cv2.cvtColor(arr, _cv2.COLOR_BGR2RGB)
    if resize:
        h, w = arr.shape[:2]
        scale = resize / min(w, h)
        arr = _cv2.resize(arr, (max(1, round(w * scale)),
                                max(1, round(h * scale))),
                          interpolation=_cv2.INTER_LINEAR)
    return arr


def _decode_resize_pil(buf, resize):
    from PIL import Image
    img = Image.open(io.BytesIO(buf))
    if img.mode != "RGB":
        img = img.convert("RGB")
    if resize:
        w, h = img.size
        scale = resize / min(w, h)
        img = img.resize((max(1, round(w * scale)),
                          max(1, round(h * scale))), Image.BILINEAR)
    return np.asarray(img, np.uint8)


def affine_augment(arr, rng, max_rotate_angle=0, max_shear_ratio=0.0,
                   min_random_scale=1.0, max_random_scale=1.0,
                   max_aspect_ratio=0.0, fill_value=127):
    """Random rotate/shear/scale/aspect as one warp — the reference's
    default record augmenter geometry (src/io/image_aug_default.cc). Same
    output size; exposed border pixels take fill_value."""
    h, w = arr.shape[:2]
    angle = rng.uniform(-max_rotate_angle, max_rotate_angle) \
        if max_rotate_angle else 0.0
    shear = rng.uniform(-max_shear_ratio, max_shear_ratio) \
        if max_shear_ratio else 0.0
    scale = rng.uniform(min_random_scale, max_random_scale) \
        if (min_random_scale, max_random_scale) != (1.0, 1.0) else 1.0
    if max_aspect_ratio:
        ratio = np.sqrt(1.0 + rng.uniform(-max_aspect_ratio,
                                          max_aspect_ratio))
    else:
        ratio = 1.0
    sx, sy = scale * ratio, scale / ratio
    if (angle, shear, sx, sy) == (0.0, 0.0, 1.0, 1.0):
        return arr
    rad = np.deg2rad(angle)
    c, s = np.cos(rad), np.sin(rad)
    # rotate @ shear @ scale, anchored at the image center
    m = np.array([[c * sx - s * shear * sx, -s * sy + c * shear * sy],
                  [s * sx + c * shear * sx, c * sy + s * shear * sy]])
    cx, cy = w / 2.0, h / 2.0
    t = np.array([cx, cy]) - m @ np.array([cx, cy])
    fill = (fill_value,) * 3
    if _cv2 is not None:
        mat = np.hstack([m, t[:, None]]).astype(np.float64)
        return _cv2.warpAffine(arr, mat, (w, h),
                               flags=_cv2.INTER_LINEAR,
                               borderMode=_cv2.BORDER_CONSTANT,
                               borderValue=fill)
    from PIL import Image
    inv = np.linalg.inv(m)
    it = -inv @ t
    coeffs = (inv[0, 0], inv[0, 1], it[0], inv[1, 0], inv[1, 1], it[1])
    img = Image.fromarray(arr).transform((w, h), Image.AFFINE, coeffs,
                                         Image.BILINEAR, fillcolor=fill)
    return np.asarray(img, np.uint8)


def _rgb_to_hls(arr):
    """Vectorized uint8 RGB -> float HLS (h in degrees 0-360, l/s in 0-1).
    HLS (not HSV) is the reference's jitter space (image_aug_default.cc
    converts via cv::COLOR_RGB2HLS)."""
    rgb = arr.astype(np.float32) / 255.0
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    d = mx - mn
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(mx == r, (g - b) / d % 6.0,
                     np.where(mx == g, (b - r) / d + 2.0,
                              (r - g) / d + 4.0)) * 60.0
    h = np.where(d == 0, 0.0, h)
    lgt = (mx + mn) / 2.0
    denom = 1.0 - np.abs(2.0 * lgt - 1.0)
    s = np.where(d == 0, 0.0, d / np.where(denom == 0, 1.0, denom))
    return h, lgt, s


def _hls_to_rgb(h, lgt, s):
    c = (1.0 - np.abs(2.0 * lgt - 1.0)) * s
    hp = (h % 360.0) / 60.0
    x = c * (1.0 - np.abs(hp % 2.0 - 1.0))
    i = np.floor(hp).astype(np.int32) % 6
    z = np.zeros_like(c)
    r = np.choose(i, [c, x, z, z, x, c])
    g = np.choose(i, [x, c, c, x, z, z])
    b = np.choose(i, [z, z, x, c, c, x])
    m = lgt - c / 2.0
    rgb = np.stack([r + m, g + m, b + m], axis=-1)
    return np.clip(rgb * 255.0, 0, 255).astype(np.uint8)


def hsl_jitter(arr, rng, random_h=0, random_s=0, random_l=0):
    """Random hue/lightness/saturation shifts in HLS space, reference
    units (random_h is on OpenCV's 0-180 hue scale — 1 unit = 2 degrees;
    random_s/l are of 255 — image_aug_default.cc random_h/s/l)."""
    if not (random_h or random_s or random_l):
        return arr
    h, lgt, s = _rgb_to_hls(arr)
    if random_h:
        h = h + rng.uniform(-random_h, random_h) * 2.0
    if random_s:
        s = np.clip(s + rng.uniform(-random_s, random_s) / 255.0, 0.0, 1.0)
    if random_l:
        lgt = np.clip(lgt + rng.uniform(-random_l, random_l) / 255.0,
                      0.0, 1.0)
    return _hls_to_rgb(h, lgt, s)


def pad_image(arr, pad, fill_value=127):
    """Constant-border pad before crop (the CIFAR pad+random-crop recipe,
    reference ImageRecordIter `pad` parameter)."""
    return np.pad(arr, ((pad, pad), (pad, pad), (0, 0)),
                  constant_values=np.uint8(fill_value))


def decode_augment(task):
    """(seed, jpeg_bytes, label) -> (H,W,C) uint8, label.

    Returns uint8 HWC — 4x less pipe traffic than float32; the parent
    applies mean/std + NCHW transpose on the whole batch at once
    (vectorized, and XLA fuses it into the first conv anyway).

    Augmentation order mirrors the reference default augmenter
    (image_aug_default.cc): decode -> resize -> affine (rotate/shear/
    scale/aspect) -> pad -> crop -> mirror -> h/s/l jitter."""
    seed, buf, label = task
    cfg = _CFG
    rng = np.random.RandomState(seed)
    resize = cfg.get("resize", 0)
    use_cv2 = _cv2 is not None and not cfg.get("force_pil")
    if use_cv2:
        arr = _decode_resize_cv2(buf, resize)
    else:
        arr = _decode_resize_pil(buf, resize)
    fill = cfg.get("fill_value", 127)
    if cfg.get("affine"):
        arr = affine_augment(arr, rng, fill_value=fill, **cfg["affine"])
    if cfg.get("pad"):
        arr = pad_image(arr, cfg["pad"], fill)
    ch, cw = cfg["crop_h"], cfg["crop_w"]
    h, w = arr.shape[:2]
    if w < cw or h < ch:
        nw, nh = max(w, cw), max(h, ch)
        if use_cv2:
            arr = _cv2.resize(arr, (nw, nh),
                              interpolation=_cv2.INTER_LINEAR)
        else:
            from PIL import Image
            arr = np.asarray(Image.fromarray(arr).resize(
                (nw, nh), Image.BILINEAR), np.uint8)
        h, w = arr.shape[:2]
    if cfg.get("rand_crop"):
        x0 = rng.randint(0, w - cw + 1)
        y0 = rng.randint(0, h - ch + 1)
    else:
        x0, y0 = (w - cw) // 2, (h - ch) // 2
    arr = arr[y0:y0 + ch, x0:x0 + cw]
    if cfg.get("rand_mirror") and rng.rand() < 0.5:
        arr = arr[:, ::-1]
    if cfg.get("hsl"):
        arr = hsl_jitter(arr, rng, **cfg["hsl"])
    return np.ascontiguousarray(arr), label
