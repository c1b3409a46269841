"""Bucketed sequence iterator; counterpart of ``mxnet_tpu/rnn/io.py``.

``BucketSentenceIter`` pads each sentence to its bucket's length, groups
the sentences into per-bucket batches and tags each batch with its
``bucket_key``, from which ``BucketingModule`` picks the bucket's module.
It shuffles with Python's ``random`` and numpy's global generator, as the
JAX package's does, so one seed of both gives both packages the same
batches.  Batches are host (``cpu()``) arrays, as ``NDArrayIter``'s are.
"""
from __future__ import annotations

import random

import numpy as np

from .. import ndarray as nd
from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter

__all__ = ["BucketSentenceIter"]


class BucketSentenceIter(DataIter):
    """Iterator over sentences (lists of int ids) bucketed by length.

    sentences, batch_size, buckets (default: every length with at least a
    batch of sentences), invalid_label (the padding id), data_name/
    label_name, dtype and layout ('NT' or 'TN').  The label is the data
    shifted one step left (next-token prediction)."""

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=-1,
                 data_name="data", label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            counts = np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(counts)
                       if n >= batch_size]
            if not buckets:
                buckets = [max(len(s) for s in sentences)]
        buckets.sort()
        self.data = [[] for _ in buckets]
        for sent in sentences:
            buck = np.searchsorted(buckets, len(sent))
            if buck == len(buckets):
                continue  # longer than the largest bucket: discarded
            buff = np.full((buckets[buck],), invalid_label, dtype=dtype)
            buff[:len(sent)] = sent
            self.data[buck].append(buff)
        self.data = [np.asarray(x, dtype=dtype) for x in self.data]
        self.batch_size = batch_size
        self.buckets = buckets
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.default_bucket_key = max(buckets)
        self.major_axis = layout.find("N")

        self.idx = []
        for i, buck in enumerate(self.data):
            self.idx.extend([(i, j) for j in
                             range(0, len(buck) - batch_size + 1, batch_size)])
        self.curr_idx = 0
        self.nddata = []
        self.ndlabel = []
        self.reset()

    @property
    def provide_data(self):
        if self.major_axis == 0:
            shape = (self.batch_size, self.default_bucket_key)
        else:
            shape = (self.default_bucket_key, self.batch_size)
        return [DataDesc(self.data_name, shape)]

    @property
    def provide_label(self):
        return [DataDesc(self.label_name, self.provide_data[0].shape)]

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
            self.nddata.append(nd.array(buck, cpu(), dtype=self.dtype))
            self.ndlabel.append(nd.array(label, cpu(), dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        if self.major_axis != 0:
            data, label = data.T, label.T
        return DataBatch(
            data=[data], label=[label], pad=0,
            bucket_key=self.buckets[i],
            provide_data=[DataDesc(self.data_name, data.shape)],
            provide_label=[DataDesc(self.label_name, label.shape)])
