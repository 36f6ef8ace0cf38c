"""Gluon vision datasets of the PyTorch port
(``mxtpu/gluon/data/vision/datasets.py``): MNIST, FashionMNIST, CIFAR10,
CIFAR100 and ImageFolderDataset. They read local files under ``root``
only: MNIST's idx (or idx.gz) files, CIFAR's python pickles. Where the
files are missing they raise ``mxtpu``'s error, since downloads are
disabled.

A sample is an HWC uint8 NDArray on the host (``cpu()``) and its label:
the transforms run on the host too, and the DataLoader stacks a batch
into pinned memory and copies it to the card once. (In ``mxtpu`` a
sample is an array on the default device; here that would be a copy up
and several small kernels for each sample.)
"""
from __future__ import annotations

import os
import pickle

import numpy as _np

from .... import ndarray as nd
from ....context import cpu
from ....io import read_idx
from ..dataset import Dataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    """Images in ``self._data`` (N, H, W, C), labels in ``self._label``."""

    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        img = nd.array(self._data[idx], ctx=cpu())
        label = self._label[idx]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """MNIST's idx files under ``root``: ``train-images-idx3-ubyte`` and
    ``train-labels-idx1-ubyte`` (``t10k-...`` with ``train=False``), each
    also as ``.gz``. Images (N, 28, 28, 1) uint8, labels int32."""

    _files = {
        True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    }

    def __init__(self, root=os.path.join("~", ".mxtpu", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _find(self, stem):
        for cand in (stem, stem + ".gz"):
            p = os.path.join(self._root, cand)
            if os.path.exists(p):
                return p
        raise IOError(
            "%s not found under %s — downloads are disabled; place the "
            "MNIST idx files there." % (stem, self._root))

    def _get_data(self):
        img_stem, lbl_stem = self._files[self._train]
        self._data = read_idx(self._find(img_stem), 2051)[..., None]
        self._label = read_idx(self._find(lbl_stem), 2049).astype(_np.int32)


class FashionMNIST(MNIST):
    """Fashion-MNIST: MNIST's file names and format under its own root."""

    def __init__(self, root=os.path.join("~", ".mxtpu", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


def _unpickle(path):
    with open(path, "rb") as f:
        return pickle.load(f, encoding="latin1")


def _hwc(rows):
    """CIFAR's rows of 3 x 32 x 32 (channel-major) as (N, 32, 32, 3)."""
    return _np.asarray(rows).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10's python batches under ``root/cifar-10-batches-py``:
    ``data_batch_1`` to ``_5`` (``test_batch`` with ``train=False``).
    Images (N, 32, 32, 3) uint8, labels int32."""

    def __init__(self, root=os.path.join("~", ".mxtpu", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        pydir = os.path.join(self._root, "cifar-10-batches-py")
        if not os.path.isdir(pydir):
            raise IOError(
                "CIFAR-10 python batches not found under %s — downloads are "
                "disabled; extract cifar-10-python.tar.gz there."
                % self._root)
        files = ["data_batch_%d" % i for i in range(1, 6)] \
            if self._train else ["test_batch"]
        batches = [_unpickle(os.path.join(pydir, fn)) for fn in files]
        self._data = _hwc(_np.concatenate([b["data"] for b in batches]))
        self._label = _np.asarray([y for b in batches for y in b["labels"]],
                                  dtype=_np.int32)


class CIFAR100(_DownloadedDataset):
    """CIFAR-100's python files under ``root/cifar-100-python``: ``train``
    (``test``), with the coarse labels, or the fine ones under
    ``fine_label``."""

    def __init__(self, root=os.path.join("~", ".mxtpu", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._train = train
        self._fine = fine_label
        super().__init__(root, transform)

    def _get_data(self):
        pydir = os.path.join(self._root, "cifar-100-python")
        if not os.path.isdir(pydir):
            raise IOError(
                "CIFAR-100 python batches not found under %s — downloads "
                "are disabled; extract cifar-100-python.tar.gz there."
                % self._root)
        batch = _unpickle(os.path.join(pydir,
                                       "train" if self._train else "test"))
        self._data = _hwc(batch["data"])
        key = "fine_labels" if self._fine else "coarse_labels"
        self._label = _np.asarray(batch[key], dtype=_np.int32)


class ImageFolderDataset(Dataset):
    """Images in a folder a class under ``root`` (classes in sorted
    order, ``synsets``), read with ``image.imread`` (``flag`` 1: RGB, 0:
    grey) as host NDArrays."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".bmp"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from .... import image
        path, label = self.items[idx]
        img = image.imread(path, self._flag)
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
