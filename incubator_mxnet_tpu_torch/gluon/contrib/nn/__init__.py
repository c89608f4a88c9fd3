"""`gluon.contrib.nn` of the PyTorch port."""
from .basic_layers import (Concurrent, HybridConcurrent, Identity,
                           SparseEmbedding, SyncBatchNorm, PixelShuffle1D,
                           PixelShuffle2D, PixelShuffle3D)
