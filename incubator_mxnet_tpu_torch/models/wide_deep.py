"""Wide & Deep recommender of the PyTorch port (counterpart of
incubator_mxnet_tpu/models/wide_deep.py; bench.py's config 5; ref:
example/sparse/wide_deep/{model.py,train.py}).

Sparse features arrive as a fixed number of fields, padded (indices,
values) pairs, so every shape is static.  The wide part is a per-feature
scalar weight (a (vocab, 1) `Embedding`), the deep part an `Embedding`
of width `embed_dim` under an MLP; with `sparse_grad=True` both tables
take row_sparse gradients, which the optimizers update lazily
(`ndarray.sparse`), and `contrib.sparse_jit.BucketedSparseTrainer` trains
the same net as one captured program per bucket.  `csr_to_fields` turns
a `LibSVMIter` batch into the fields format.
"""
from __future__ import annotations

import numpy as np

from ..gluon import nn
from ..gluon.block import HybridBlock

__all__ = ["WideDeep", "wide_deep", "csr_to_fields"]


class WideDeep(HybridBlock):
    """Fields-format input: `indices` (B, F) int feature ids and `values`
    (B, F) float feature values (0-padded); logits (B, classes).  Its
    parameters wait for `initialize(ctx=...)`, and the MLP's input width
    for the first forward, as in the JAX package."""

    def __init__(self, num_features, embed_dim=16, hidden=(64, 32),
                 classes=2, sparse_grad=True):
        super().__init__()
        self.wide = nn.Embedding(num_features, 1, sparse_grad=sparse_grad)
        self.deep_embed = nn.Embedding(num_features, embed_dim,
                                       sparse_grad=sparse_grad)
        self.mlp = nn.HybridSequential()
        for h in hidden:
            self.mlp.add(nn.Dense(h, activation="relu", flatten=False))
        self.out = nn.Dense(classes, flatten=False)

    def forward(self, indices, values):
        B, Fn = indices.shape
        vals = values.reshape(B, Fn, 1)
        wide_term = (self.wide(indices) * vals).sum(1)          # (B, 1)
        emb = self.deep_embed(indices) * vals                   # (B, F, E)
        deep_term = self.out(self.mlp(emb.reshape(B, -1)))      # (B, C)
        return deep_term + wide_term


def wide_deep(num_features=1000, **kwargs):
    return WideDeep(num_features, **kwargs)


def csr_to_fields(csr, num_fields):
    """A `CSRNDArray` batch (`LibSVMIter`'s) in the padded (indices,
    values) fields format the model takes, on the batch's device.  A row
    with fewer than `num_fields` entries pads with (0, 0.0); extra
    entries are cut."""
    from .. import ndarray as nd
    indptr = csr.indptr.asnumpy()
    indices = csr.indices.asnumpy()
    values = csr.data.asnumpy()
    B = len(indptr) - 1
    out_i = np.zeros((B, num_fields), np.int32)
    out_v = np.zeros((B, num_fields), np.float32)
    for b in range(B):
        lo, hi = indptr[b], min(indptr[b + 1], indptr[b] + num_fields)
        n = hi - lo
        out_i[b, :n] = indices[lo:hi]
        out_v[b, :n] = values[lo:hi]
    return (nd.array(out_i, ctx=csr.context, dtype="int32"),
            nd.array(out_v, ctx=csr.context))
