"""Bucketing data iterator of the PyTorch port.

Counterpart of ``mxtpu/rnn/io.py``'s ``BucketSentenceIter``: sentences
grouped by length into buckets, padded with ``invalid_label`` to their
bucket's length, and served in batches that carry ``bucket_key``, the
next-token labels beside them. The order is ``mxtpu``'s: ``reset``
shuffles the batch list with Python's ``random.shuffle`` and then each
bucket's rows with ``np.random.shuffle``, so one seed of both generators
gives both packages the same batches in the same order.

At each ``reset`` every bucket's (shuffled) rows and labels are copied
once to the context that was current when the iterator was made; a
batch is then a slice of them on the device, with no copy from the host
a step.
"""
from __future__ import annotations

import logging
import random

import numpy as np

from .. import ndarray as nd
from ..context import current_context
from ..io import DataBatch, DataDesc, DataIter
from ..ndarray import NDArray

__all__ = ["BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    """Batches of bucketed, padded sentences (``mxtpu``
    BucketSentenceIter), staged on the current context."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            buckets = [i for i, j in enumerate(
                np.bincount([len(s) for s in sentences]))
                if j >= batch_size]
        buckets.sort()
        ndiscard = 0
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                ndiscard += 1
                continue
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[: len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [np.asarray(i, dtype=dtype) for i in self.data]
        if ndiscard:
            logging.warning("discarded %d sentences longer than the largest "
                            "bucket", ndiscard)

        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.ctx = current_context()
        self.nddata = []
        self.ndlabel = []
        self.major_axis = layout.find("N")
        self.layout = layout
        self.default_bucket_key = max(buckets)
        if self.major_axis == 0:
            shape = (batch_size, self.default_bucket_key)
        elif self.major_axis == 1:
            shape = (self.default_bucket_key, batch_size)
        else:
            raise ValueError("invalid layout %s (must contain N)" % layout)
        self.provide_data = [DataDesc(name=self.data_name, shape=shape,
                                      layout=layout)]
        self.provide_label = [DataDesc(name=self.label_name, shape=shape,
                                       layout=layout)]

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1,
                                   batch_size)])
        self.curr_idx = 0
        self.reset()

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for buck in self.data:
            np.random.shuffle(buck)
        self.nddata = []
        self.ndlabel = []
        for buck in self.data:
            label = np.empty_like(buck)
            label[:, :-1] = buck[:, 1:]
            label[:, -1] = self.invalid_label
            self.nddata.append(nd.array(buck, ctx=self.ctx,
                                        dtype=self.dtype).data)
            self.ndlabel.append(nd.array(label, ctx=self.ctx,
                                         dtype=self.dtype).data)

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        if self.major_axis == 1:
            data, label = data.t(), label.t()
        return DataBatch(
            [NDArray(data, self.ctx)], [NDArray(label, self.ctx)], pad=0,
            bucket_key=self.buckets[i],
            provide_data=[DataDesc(name=self.data_name,
                                   shape=tuple(data.shape),
                                   layout=self.layout)],
            provide_label=[DataDesc(name=self.label_name,
                                    shape=tuple(label.shape),
                                    layout=self.layout)])
