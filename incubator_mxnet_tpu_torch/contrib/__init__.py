"""Contributed modules of the PyTorch port (counterpart of
incubator_mxnet_tpu/contrib/), limited to `amp`."""
from . import amp
