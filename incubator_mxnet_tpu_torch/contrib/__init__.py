"""Contributed modules of the PyTorch port (counterpart of
incubator_mxnet_tpu/contrib/): `amp` and `sparse_jit` (the bucketed
row_sparse trainer)."""
from . import amp
from . import sparse_jit
