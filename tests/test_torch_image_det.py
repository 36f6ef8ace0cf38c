"""The detection pipeline of the PyTorch port (``mxtpu_torch/
image_detection.py``) against ``mxtpu``'s on the CPU.

Each case of tests/test_image_det.py runs in both packages with Python's
``random`` and numpy seeded alike, and the two give the same images and
labels: labels (numpy geometry) exactly, uint8 images exactly, float
images within 1e-5 of 255 (the colour augmenters' arithmetic runs in
torch where mxtpu's runs in XLA). Then ImageDetIter reads a ``.rec`` of
detection labels written by each package's ``recordio``, with random
crop, pad and mirror: the same batches in both packages, labels padded
with -1 to the file's largest object count.
"""
import io as _io
import random

import numpy as np
import pytest
from PIL import Image

import mxtpu as mx
import mxtpu_torch as mt
from mxtpu import image_detection as mx_det
from mxtpu_torch import image_detection as mt_det
from torch_threads import torch_threads_shared  # noqa: F401

IMG_ATOL = 255 * 1e-5


def _img(pkg, h=60, w=80):
    rng = np.random.RandomState(0)
    return pkg.nd.array(rng.randint(0, 255, (h, w, 3)).astype(np.uint8),
                        ctx=pkg.cpu())


def _label():
    # one object in the left half, one in the bottom-right corner
    return np.array([[0, 0.10, 0.20, 0.40, 0.60],
                     [1, 0.70, 0.70, 0.95, 0.95]], np.float32)


def _png(arr):
    buf = _io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _det(pkg):
    """The package's detection module."""
    return mx_det if pkg is mx else mt_det


# each case: a function of a package giving {name: numpy}; the packages
# must agree on every entry

def case_box_iob(pkg):
    boxes = _label()[:, 1:5]
    iob = _det(pkg)._box_iob
    return {"full": iob(boxes, np.array([0.0, 0.0, 1.0, 1.0])),
            "left": iob(boxes, np.array([0.0, 0.0, 0.5, 1.0]))}


def case_horizontal_flip_boxes(pkg):
    random.seed(0)
    img, lab = _det(pkg).DetHorizontalFlipAug(p=1.0)(_img(pkg), _label())
    assert (lab[:, 1] <= lab[:, 3]).all()
    return {"img": img.asnumpy(), "label": lab}


def case_random_crop_keeps_and_renormalizes(pkg):
    random.seed(3)
    aug = _det(pkg).DetRandomCropAug(min_object_covered=0.5,
                                     area_range=(0.3, 0.9),
                                     min_eject_coverage=0.3,
                                     max_attempts=100)
    img, lab = aug(_img(pkg), _label())
    assert lab.shape[0] >= 1 and img.shape[0] <= 60 and img.shape[1] <= 80
    return {"img": img.asnumpy(), "label": lab}


def case_random_pad_expands_and_rescales(pkg):
    random.seed(1)
    aug = _det(pkg).DetRandomPadAug(area_range=(1.5, 2.5), pad_val=(9, 9, 9))
    img, lab = aug(_img(pkg), _label())
    assert img.shape[0] >= 60 and img.shape[1] >= 80
    return {"img": img.asnumpy(), "label": lab}


def case_random_select_skip(pkg):
    d = _det(pkg)
    aug = d.DetRandomSelectAug([d.DetHorizontalFlipAug(p=1.0)],
                               skip_prob=1.0)
    img, lab = aug(_img(pkg), _label())
    np.testing.assert_allclose(lab, _label())
    return {"img": img.asnumpy(), "label": lab}


def case_create_det_augmenter_chain(pkg):
    random.seed(0)
    np.random.seed(0)
    augs = _det(pkg).CreateDetAugmenter((3, 32, 48), rand_crop=0.5,
                                        rand_pad=0.5, rand_mirror=True,
                                        mean=True, std=True)
    img, lab = _img(pkg), _label()
    for a in augs:
        img, lab = a(img, lab)
    assert img.shape == (32, 48, 3) and lab.shape[1] == 5
    return {"img": img.asnumpy(), "label": lab,
            "names": np.array([a.dumps() for a in augs])}


def case_image_det_iter_batching(pkg):
    random.seed(0)
    rng = np.random.RandomState(0)
    items = [(_png(rng.randint(0, 255, (40, 50, 3)).astype(np.uint8)),
              _label()[:1 + i % 2]) for i in range(5)]
    d = _det(pkg)
    it = d.ImageDetIter(batch_size=2, data_shape=(3, 32, 32), imglist=None,
                        aug_list=d.CreateDetAugmenter((3, 32, 32)),
                        path_imgrec=None)
    it._items = [(src, it._parse_label(lbl)) for src, lbl in items]
    it.max_objects = max(lbl.shape[0] for _, lbl in it._items)
    it._order = list(range(len(it._items)))
    it.reset()
    batch = it.next()
    data, label = batch.data[0], batch.label[0]
    assert data.shape == (2, 3, 32, 32)
    assert it.provide_label[0].shape == (2, it.max_objects, 5)
    return {"data": data.asnumpy(), "label": label.asnumpy()}


def case_parse_label_flat_reference_format(pkg):
    cls = _det(pkg).ImageDetIter
    it = cls.__new__(cls)
    flat = np.array([4, 5, 0, 0,
                     0, 0.1, 0.2, 0.4, 0.6,
                     1, 0.7, 0.7, 0.95, 0.95], np.float32)
    parsed = cls._parse_label(it, flat)
    with pytest.raises(ValueError):
        cls._parse_label(it, np.array([1.0, 2.0, 3.0]))
    return {"parsed": parsed}


def case_sync_label_shape(pkg):
    cls = _det(pkg).ImageDetIter
    a, b = cls.__new__(cls), cls.__new__(cls)
    a.max_objects, a.label_width = 3, 5
    b.max_objects, b.label_width = 7, 6
    a.sync_label_shape(b)
    return {"shapes": np.array([a.max_objects, b.max_objects,
                                a.label_width, b.label_width]),
            "label_shape": np.array(a.label_shape)}


def case_gray_hue_augmenters(pkg):
    random.seed(0)
    np.random.seed(0)
    img = _img(pkg)
    gray = pkg.image.RandomGrayAug(p=1.0)(img)
    hue = pkg.image.HueJitterAug(hue=0.3)(img)
    augs = _det(pkg).CreateDetAugmenter((3, 32, 32), rand_gray=0.5, hue=0.2)
    im2, lab = _img(pkg), _label()
    for a in augs:
        im2, lab = a(im2, lab)
    assert im2.shape == (32, 32, 3)
    return {"gray": gray.asnumpy(), "hue": hue.asnumpy(),
            "chain": im2.asnumpy(), "label": lab}


def case_last_batch_discard(pkg):
    rng = np.random.RandomState(0)
    items = [(_png(rng.randint(0, 255, (8, 8, 3), dtype=np.uint8)), 0.0)
             for _ in range(5)]
    it = pkg.image.ImageIter(2, (3, 8, 8), aug_list=[],
                             last_batch_handle="discard")
    it._items = items
    it._order = list(range(5))
    it.reset()
    batches = [b.data[0].asnumpy() for b in it]
    with pytest.raises(ValueError):
        pkg.image.ImageIter(2, (3, 8, 8), aug_list=[],
                            last_batch_handle="roll_over")
    return {"n": np.array(len(batches)), "data": np.stack(batches)}


def case_det_iter_reshape_updates_aug_chain(pkg):
    d = _det(pkg)
    it = d.ImageDetIter.__new__(d.ImageDetIter)
    it.det_auglist = d.CreateDetAugmenter((3, 32, 32))
    it.data_shape = (3, 32, 32)
    it.max_objects, it.label_width = 2, 5
    it.reshape(data_shape=(3, 64, 48))
    sizes = [a.augmenter.size for a in it.det_auglist
             if isinstance(getattr(a, "augmenter", None),
                           pkg.image.ForceResizeAug)]
    img, lab = _img(pkg), _label()
    for a in it.det_auglist:
        img, lab = a(img, lab)
    assert img.shape[:2] == (64, 48)
    return {"sizes": np.array(sizes), "img": img.asnumpy(), "label": lab}


CASES = {n[len("case_"):]: f for n, f in dict(globals()).items()
         if n.startswith("case_")}


def _same(got, want, name):
    assert got.keys() == want.keys(), name
    for k in got:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (name, k, g.shape,
                                                            w.shape)
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=IMG_ATOL,
                                       err_msg="%s %s" % (name, k))
        else:
            np.testing.assert_array_equal(g, w, err_msg="%s %s" % (name, k))


@pytest.mark.parametrize("case", sorted(CASES))
def test_image_det_case_matches_mxtpu(case):
    got = CASES[case](mt)
    want = CASES[case](mx)
    _same(got, want, case)


def test_twelve_reference_cases_and_the_reexports():
    assert len(CASES) == 12
    for name in mt_det.__all__:
        assert getattr(mt.image, name) is getattr(mt_det, name)
        assert hasattr(mx.image, name)


# -- ImageDetIter over record files -------------------------------------------

def _write_rec(pkg, path, n=7, hw=(36, 44)):
    """``n`` PNG records with 1-3 objects each, flat detection labels."""
    rng = np.random.RandomState(5)
    writer = pkg.recordio.MXRecordIO(str(path), "w")
    for i in range(n):
        img = rng.randint(0, 255, hw + (3,)).astype(np.uint8)
        k = 1 + i % 3
        xy = rng.uniform(0, 0.6, (k, 2))
        objs = np.concatenate([rng.randint(0, 4, (k, 1)), xy,
                               xy + rng.uniform(0.1, 0.4, (k, 2))], 1)
        label = np.concatenate([[2, 5], objs.ravel()]).astype(np.float32)
        writer.write(pkg.recordio.pack(pkg.recordio.IRHeader(0, label, i, 0),
                                       _png(img)))
    writer.close()
    return str(path)


def _batches(pkg, path, augment):
    random.seed(7)
    np.random.seed(7)
    aug = dict(rand_crop=1, rand_pad=1, rand_mirror=True, mean=True,
               std=True) if augment else {}
    it = _det(pkg).ImageDetIter(3, (3, 24, 28), path_imgrec=path,
                                shuffle=augment, **aug)
    out = []
    for _ in range(2):            # two epochs: the last batch pads
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy()))
        it.reset()
    return out, it


@pytest.mark.parametrize("writer", ["mxtpu_torch", "mxtpu"])
@pytest.mark.parametrize("augment", [False, True])
def test_image_det_iter_over_records_matches_mxtpu(tmp_path, writer,
                                                   augment):
    pkg = mt if writer == "mxtpu_torch" else mx
    path = _write_rec(pkg, tmp_path / "det.rec")
    got, it = _batches(mt, path, augment)
    want, _ = _batches(mx, path, augment)
    assert it.max_objects == 3 and len(got) == len(want) == 6
    assert it.provide_label[0].shape == (3, 3, 5)
    for (gd, gl), (wd, wl) in zip(got, want):
        assert gd.shape == (3, 3, 24, 28) and gl.shape == (3, 3, 5)
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_allclose(gd, wd, rtol=0, atol=1e-5)
    labels = np.concatenate([lab for _, lab in got])
    pad = (labels == -1).all(axis=-1)
    assert pad.any()
    # a padding row is -1 through and through; a real one is a box
    assert (pad | (labels[..., 3] > labels[..., 1])).all()


def test_record_files_cross_packages(tmp_path):
    """The two packages' recordio write the same bytes for the same
    records."""
    a = _write_rec(mt, tmp_path / "a.rec")
    b = _write_rec(mx, tmp_path / "b.rec")
    assert open(a, "rb").read() == open(b, "rb").read()
