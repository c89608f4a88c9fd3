"""`gluon.contrib.nn` layers of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/contrib/nn/basic_layers.py): `Concurrent`,
`HybridConcurrent`, `Identity`, `SparseEmbedding` (an `Embedding`
whose gradient is row_sparse), `SyncBatchNorm` on one device and
`PixelShuffle1D/2D/3D`.

`HybridConcurrent` subclasses `HybridSequential`, as in the JAX package,
but runs its own forward: every branch takes the same input and their
outputs are concatenated, so the sequential Conv2D → BatchNorm fusion
never pairs the last layer of one branch with the first of the next
(the branches' own `HybridSequential`s still fuse inside).
"""
from __future__ import annotations

import torch

from ....base import MXNetError
from ...block import Block, HybridBlock
from ...nn.basic_layers import (BatchNorm, Embedding, HybridSequential,
                                Sequential)

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle1D", "PixelShuffle2D",
           "PixelShuffle3D"]


def _concat_branches(block, x):
    return torch.cat([branch(x) for branch in block], dim=block.axis)


class Concurrent(Sequential):
    """ref: contrib.nn.Concurrent: every child on the same input, the
    outputs concatenated along `axis`."""

    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return _concat_branches(self, x)


class HybridConcurrent(HybridSequential):
    """ref: contrib.nn.HybridConcurrent (module doc)."""

    def __init__(self, axis=-1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return _concat_branches(self, x)


class Identity(HybridBlock):
    """ref: contrib.nn.Identity: its input, as it is."""

    def forward(self, x):
        return x


class SparseEmbedding(Block):
    """ref: contrib SparseEmbedding: an Embedding whose weight gradient is
    row_sparse, for very large tables (here the one `Embedding` with
    `sparse_grad=True`, the child `_embedding`, as the JAX package names
    it)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, device=None):
        super().__init__()
        self._embedding = Embedding(input_dim, output_dim, dtype=dtype,
                                    weight_initializer=weight_initializer,
                                    sparse_grad=True, device=device)

    def forward(self, x):
        return self._embedding(x)


class SyncBatchNorm(BatchNorm):
    """ref: contrib.nn.SyncBatchNorm: BatchNorm over axis 1 whose batch
    statistics span the replicas of a data-parallel group.  Run in the
    replicas' threads of a group (`parallel.collectives.replica_sync`,
    as `parallel.ShardedTrainer` at zero 0 and 1 does), its moments and
    backward sums are summed across them (`ops.sync_batch_norm`); with
    `axis_name` it must be (the JAX layer's shard_map axis); without one
    and outside a group it is BatchNorm, as upstream MXNet degrades at
    one device and the JAX layer is without an axis name.
    `num_devices` is taken for the reference's signature."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", axis_name=None,
                 device=None, dtype="float32"):
        super().__init__(
            axis=1, momentum=momentum, epsilon=epsilon, center=center,
            scale=scale, use_global_stats=use_global_stats,
            beta_initializer=beta_initializer,
            gamma_initializer=gamma_initializer,
            running_mean_initializer=running_mean_initializer,
            running_variance_initializer=running_variance_initializer,
            in_channels=in_channels, device=device, dtype=dtype)
        self._num_devices = num_devices
        self._axis_name = axis_name

    def forward(self, x, sums=None):
        from ....parallel import collectives
        if self._axis_name and self.batch_stats and \
                collectives.current_sync() is None:
            raise MXNetError(
                "SyncBatchNorm(axis_name=%r) outside a replica group: run "
                "it in the replicas' threads (parallel.collectives."
                "replica_sync)" % (self._axis_name,))
        return super().forward(x, sums)


class _PixelShuffle(HybridBlock):
    """(B, C·f1·…·fn, s1, …, sn) → (B, C, s1·f1, …, sn·fn): sub-pixel
    upsampling by the factors `factor` (ref: contrib PixelShuffle)."""

    def __init__(self, factor, ndim):
        super().__init__()
        self._f = (factor,) * ndim if isinstance(factor, int) \
            else tuple(factor)
        if len(self._f) != ndim:
            raise ValueError("%s takes %d factors, got %r"
                             % (type(self).__name__, ndim, factor))

    def forward(self, x):
        f, n = self._f, len(self._f)
        B, C, spatial = x.shape[0], x.shape[1], tuple(x.shape[2:])
        for fi in f:
            C //= fi
        x = x.reshape((B, C) + f + spatial)
        perm = [0, 1]
        for i in range(n):
            perm += [2 + n + i, 2 + i]      # each s_i, then its f_i
        x = x.permute(perm)
        return x.reshape((B, C) + tuple(s * fi for s, fi in zip(spatial,
                                                                 f)))


class PixelShuffle1D(_PixelShuffle):
    def __init__(self, factor):
        super().__init__(factor, 1)


class PixelShuffle2D(_PixelShuffle):
    def __init__(self, factor):
        super().__init__(factor, 2)


class PixelShuffle3D(_PixelShuffle):
    def __init__(self, factor):
        super().__init__(factor, 3)
