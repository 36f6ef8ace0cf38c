"""The port's image module (mxtpu_torch/image.py, _image_worker.py)
against mxtpu's, on the CPU.

- The pool worker's ``decode_augment`` is the same numpy and PIL code in
  both packages: for each (seed, JPEG bytes, label) it returns the same
  uint8 array, bit for bit, on train_cifar10's level-2 configuration
  (pad 4, fill 127, random crop and mirror, h/s/l jitter 36/50/50), on
  level 3's affine warp and on a resize + center crop, 64 seeds each,
  with PIL forced.
- Every augmenter, from the same Python and numpy RNG states on the same
  image. Geometry (resize, crops, flip), casts and the numpy-computed
  jitters (contrast, saturation, the record default augmenter) are exact;
  the arithmetic that runs through XLA in mxtpu and through torch in the
  port (brightness, hue, lighting, gray, normalize) is held to 1e-5
  relative (float32 either way; readings are at most a few ulp).
- CreateAugmenter builds the same list (classes and dumps()), and the
  whole list applied gives the same image within 1e-5 of its largest
  value (normalized values cross 0).
"""
import io
import random

import numpy as np
import pytest
from PIL import Image

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu import _image_worker as mx_worker
from mxtpu_torch import _image_worker as mt_worker
from torch_threads import torch_threads_shared  # noqa: F401

RTOL = 1e-5
SEEDS = 64
LEVEL2 = {"crop_h": 28, "crop_w": 28, "resize": 0, "rand_crop": True,
          "rand_mirror": True, "pad": 4, "fill_value": 127, "affine": {},
          "hsl": {"random_h": 36, "random_s": 50, "random_l": 50},
          "force_pil": True}
CONFIGS = {
    "cifar_level2": LEVEL2,
    "level3_affine": dict(LEVEL2, affine={
        "max_rotate_angle": 10, "max_shear_ratio": 0.1,
        "min_random_scale": 1.0, "max_random_scale": 1.0,
        "max_aspect_ratio": 0.25}),
    "resize_center": {"crop_h": 16, "crop_w": 16, "resize": 20,
                      "rand_crop": False, "rand_mirror": False,
                      "force_pil": True},
}


def _jpeg(rng, label, hw=28):
    """common/data.py's synthetic CIFAR image for ``label``, as JPEG."""
    base = 40 + (175 * label) // 9
    img = np.clip(rng.randint(-35, 36, (hw, hw, 3)) + base, 0,
                  255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=95)
    return buf.getvalue()


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_decode_augment_is_mxtpus_bit_for_bit(config):
    rng = np.random.RandomState(0)
    tasks = [(1000 + 7919 * s, _jpeg(rng, s % 10), float(s % 10))
             for s in range(SEEDS)]
    outs = {}
    for name, worker in (("mxtpu", mx_worker), ("port", mt_worker)):
        worker.init_worker(dict(CONFIGS[config]))
        outs[name] = [worker.decode_augment(t) for t in tasks]
    changed = 0
    for (got, gl), (want, wl), task in zip(outs["port"], outs["mxtpu"],
                                           tasks):
        assert gl == wl == task[2]
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape == (CONFIGS[config]["crop_h"],
                                           CONFIGS[config]["crop_w"], 3)
        np.testing.assert_array_equal(got, want)
        changed += not np.array_equal(got, outs["port"][0][0])
    assert changed > SEEDS // 2      # the seeds draw different augmentations


def _image(dtype="uint8", hw=(20, 24), seed=0):
    rng = np.random.RandomState(seed)
    arr = rng.randint(0, 256, hw + (3,)).astype(np.uint8)
    return arr if dtype == "uint8" else arr.astype(np.float32)


EIGVAL = np.array([55.46, 4.794, 1.148])
EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                   [-0.5808, -0.0045, -0.8140],
                   [-0.5836, -0.6948, 0.4203]])
# name: (build(pkg), input dtype, exact?)
AUGS = {
    "resize": (lambda p: p.image.ResizeAug(16), "uint8", True),
    "force_resize": (lambda p: p.image.ForceResizeAug((10, 14)), "uint8",
                     True),
    "random_crop": (lambda p: p.image.RandomCropAug((12, 10)), "uint8",
                    True),
    "center_crop": (lambda p: p.image.CenterCropAug((12, 10)), "uint8",
                    True),
    "random_sized_crop": (lambda p: p.image.RandomSizedCropAug(
        (12, 12), (0.08, 1.0), (3 / 4, 4 / 3)), "uint8", True),
    "flip": (lambda p: p.image.HorizontalFlipAug(0.5), "uint8", True),
    "cast": (lambda p: p.image.CastAug(), "uint8", True),
    "brightness": (lambda p: p.image.BrightnessJitterAug(0.3), "float32",
                   False),
    "contrast": (lambda p: p.image.ContrastJitterAug(0.3), "float32",
                 True),
    "saturation": (lambda p: p.image.SaturationJitterAug(0.3), "float32",
                   True),
    "color_jitter": (lambda p: p.image.ColorJitterAug(0.3, 0.3, 0.3),
                     "float32", False),
    "hue": (lambda p: p.image.HueJitterAug(0.2), "float32", False),
    "lighting": (lambda p: p.image.LightingAug(0.1, EIGVAL, EIGVEC),
                 "float32", False),
    "gray": (lambda p: p.image.RandomGrayAug(1.0), "float32", False),
    "normalize": (lambda p: p.image.ColorNormalizeAug(
        np.array([123.68, 116.28, 103.53]),
        np.array([58.395, 57.12, 57.375])), "float32", False),
    "record_default": (lambda p: p.image.RecordDefaultAug(
        4, 127, {"max_rotate_angle": 10, "max_shear_ratio": 0.1,
                 "min_random_scale": 0.9, "max_random_scale": 1.1,
                 "max_aspect_ratio": 0.25},
        {"random_h": 36, "random_s": 50, "random_l": 50}), "uint8", True),
}


def _apply(pkg, augs, arr, seed):
    """``augs`` applied in turn from seeded RNGs, to an NDArray of
    ``arr`` on the CPU."""
    random.seed(seed)
    np.random.seed(seed)
    img = pkg.nd.array(arr, ctx=pkg.cpu(), dtype=arr.dtype)
    for aug in augs:
        img = aug(img)
    return img.asnumpy()


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmenter_matches_mxtpu(name):
    build, dtype, exact = AUGS[name]
    for seed in range(4):
        arr = _image(dtype, seed=seed)
        want = _apply(mx, [build(mx)], arr, seed)
        got = _apply(mt, [build(mt)], arr, seed)
        assert got.dtype == want.dtype and got.shape == want.shape
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    assert build(mt).dumps() == build(mx).dumps()


CREATE = {
    "cifar_train": dict(rand_crop=True, rand_mirror=True, pad=4,
                        fill_value=127, random_h=36, random_s=50,
                        random_l=50, mean=np.array([123.68, 116.779,
                                                    103.939])),
    "imagenet_train": dict(resize=32, rand_resize=True, rand_mirror=True,
                           brightness=0.4, contrast=0.4, saturation=0.4,
                           hue=0.1, pca_noise=0.1, rand_gray=0.2,
                           mean=True, std=True),
    "affine_val": dict(max_rotate_angle=10, max_shear_ratio=0.1,
                       max_aspect_ratio=0.25, min_random_scale=0.9,
                       mean=np.array([1.0, 2.0, 3.0])),
    "plain": dict(),
}


@pytest.mark.parametrize("config", sorted(CREATE))
def test_create_augmenter_matches_mxtpu(config):
    """The same augmenters in the same order with the same dumps(), and
    the list applied to one image gives the same result within RTOL."""
    shape = (3, 16, 16)
    lists = {k: pkg.image.CreateAugmenter(shape, **CREATE[config])
             for k, pkg in (("mxtpu", mx), ("port", mt))}
    assert [type(a).__name__ for a in lists["port"]] == \
        [type(a).__name__ for a in lists["mxtpu"]]
    assert [a.dumps() for a in lists["port"]] == \
        [a.dumps() for a in lists["mxtpu"]]
    for seed in range(3):
        arr = _image(hw=(24, 20), seed=seed)
        want = _apply(mx, lists["mxtpu"], arr, seed)
        got = _apply(mt, lists["port"], arr, seed)
        assert got.shape == want.shape == (16, 16, 3)
        # normalized values cross 0: RTOL of the image's largest value
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * np.abs(want).max())


def test_decode_resize_and_crops_match_mxtpu():
    """imdecode (PNG, color and gray), imresize, resize_short and the crop
    functions: the same pixels, dtypes and boxes; color_normalize within
    RTOL. The port's images live on the host."""
    arr = _image(hw=(21, 30), seed=5)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    png = buf.getvalue()
    results = {}
    for k, pkg in (("mxtpu", mx), ("port", mt)):
        im = pkg.image
        random.seed(9)
        img = im.imdecode(png)
        gray = im.imdecode(png, flag=0)
        out = [img, gray, im.imresize(img, 13, 11),
               im.imresize(img, 13, 11, interp=0), im.resize_short(img, 10),
               im.fixed_crop(img, 3, 2, 8, 9), im.fixed_crop(
                   img, 3, 2, 8, 9, size=(5, 6))]
        boxes = []
        for fn, args in ((im.center_crop, ((8, 9),)),
                         (im.random_crop, ((8, 9),)),
                         (im.random_size_crop, ((8, 8), (0.1, 1.0),
                                                (0.75, 1.33)))):
            crop, box = fn(img, *args)
            out.append(crop)
            boxes.append(tuple(int(b) for b in box))
        results[k] = ([o.asnumpy() for o in out], boxes,
                      im.color_normalize(img.astype("float32"),
                                         np.array([1.0, 2.0, 3.0]),
                                         np.array([2.0, 4.0, 8.0]))
                      .asnumpy())
        if pkg is mt:
            assert img.context == mt.cpu()
    got, want = results["port"], results["mxtpu"]
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0][0], arr)
    for g, w in zip(got[0], want[0]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL)
