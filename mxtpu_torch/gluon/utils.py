"""Gluon utilities of the PyTorch port (``mxtpu/gluon/utils.py``):
``split_data``, ``split_and_load``, ``clip_global_norm``, ``check_sha1``;
``download`` raises, as there is no network."""
from __future__ import annotations

import hashlib

import torch

from .. import ndarray as nd
from ..ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split ``data`` along ``batch_axis`` into ``num_slice`` slices (the
    last takes the remainder)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices "
            "along axis %d" % (data.shape, num_slice, batch_axis))
    step = size // num_slice
    lead = (slice(None),) * batch_axis
    return [data[lead + (slice(i * step, (i + 1) * step
                               if i < num_slice - 1 else size),)]
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split ``data`` and load each slice on one context of
    ``ctx_list``."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Scale ``arrays`` so that the L2 norm of their concatenation is at
    most ``max_norm``; returns that norm before scaling (a host read)."""
    assert len(arrays) > 0
    with torch.no_grad():
        total = torch.stack([a.data.float().square().sum()
                             for a in arrays]).sum()
        total_norm = float(total.sqrt())
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total_norm


def check_sha1(filename, sha1_hash):
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    raise RuntimeError(
        "network downloads are disabled in this environment; place the "
        "file locally and pass its path instead (url=%s)" % url)
