"""The legacy `mx.rnn` namespace of the PyTorch port (counterpart of
incubator_mxnet_tpu/rnn/__init__.py; ref: python/mxnet/rnn/).

`BucketSentenceIter` is the bucketing feeder of variable-length token
sequences whose `bucket_key` picks a bucket's program; the legacy cell
names resolve to the `gluon.rnn` cells, as in the JAX package.
"""
from __future__ import annotations

import numpy as _np

from ..io import DataBatch, DataDesc, DataIter
from ..gluon.rnn import (RNNCell, LSTMCell, GRUCell, SequentialRNNCell,
                         BidirectionalCell, DropoutCell, ZoneoutCell,
                         ResidualCell)

__all__ = ["BucketSentenceIter", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "BidirectionalCell", "DropoutCell",
           "ZoneoutCell", "ResidualCell"]


class BucketSentenceIter(DataIter):
    """Bucketing iterator over variable-length token sequences (ref:
    python/mxnet/rnn/io.py BucketSentenceIter).

    Each sentence goes to the smallest bucket that fits it, padded with
    `invalid_label` (a longer one is dropped and counted in
    `discarded`); each batch comes from one bucket, so it has one static
    shape.  `label` is the sentence shifted left by one (the next token),
    padded with `invalid_label`.  Shuffling draws from
    `RandomState(seed)` in the JAX package's order, so the batches are
    the same.  Batches are NDArrays on `ctx` (default `cuda:0`, or the
    device of an enclosing `with cpu():`)."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 layout="NT", shuffle=True, seed=0, ctx=None):
        super().__init__(batch_size)
        if not buckets:
            # every length that fills at least one batch (the reference's
            # default_gen_buckets)
            counts = {}
            for s in sentences:
                counts[len(s)] = counts.get(len(s), 0) + 1
            buckets = sorted(n for n, c in counts.items()
                             if c >= batch_size) or \
                [max(len(s) for s in sentences)]
        self.buckets = sorted(buckets)
        self.data_name = data_name
        self.label_name = label_name
        self.invalid_label = invalid_label
        self.dtype = dtype
        self.layout = layout
        self._ctx = ctx
        self._shuffle = shuffle
        self._rs = _np.random.RandomState(seed)

        self.data = [[] for _ in self.buckets]
        self.discarded = 0
        for s in sentences:
            buck = next((i for i, b in enumerate(self.buckets)
                         if len(s) <= b), None)
            if buck is None:
                self.discarded += 1
                continue
            row = _np.full(self.buckets[buck], invalid_label,
                           dtype=self.dtype)
            row[:len(s)] = s
            self.data[buck].append(row)
        self.data = [_np.asarray(x, dtype=self.dtype) if len(x) else
                     _np.zeros((0, b), self.dtype)
                     for x, b in zip(self.data, self.buckets)]

        self.default_bucket_key = max(self.buckets)
        shape = ((batch_size, self.default_bucket_key) if layout == "NT"
                 else (self.default_bucket_key, batch_size))
        self.provide_data = [DataDesc(data_name, shape, dtype)]
        self.provide_label = [DataDesc(label_name, shape, dtype)]
        self.reset()

    def reset(self):
        """Shuffle within the buckets and make the batch plan again."""
        self._plan = []              # (bucket index, first row)
        for i, d in enumerate(self.data):
            if self._shuffle and len(d) > 1:
                self._rs.shuffle(d)
            for start in range(0, len(d) - self.batch_size + 1,
                               self.batch_size):
                self._plan.append((i, start))
        if self._shuffle:
            self._rs.shuffle(self._plan)
        self._cursor = 0

    def next(self):
        if self._cursor >= len(self._plan):
            raise StopIteration
        i, start = self._plan[self._cursor]
        self._cursor += 1
        from .. import ndarray as nd
        d = self.data[i][start:start + self.batch_size]
        lab = _np.full_like(d, self.invalid_label)
        lab[:, :-1] = d[:, 1:]
        if self.layout == "TN":
            d, lab = d.T, lab.T
        return DataBatch(
            [nd.array(d, ctx=self._ctx)],
            label=[nd.array(lab, ctx=self._ctx)],
            bucket_key=self.buckets[i],
            provide_data=[DataDesc(self.data_name, d.shape, self.dtype)],
            provide_label=[DataDesc(self.label_name, d.shape, self.dtype)])
