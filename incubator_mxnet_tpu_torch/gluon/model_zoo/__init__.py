"""Model zoo of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/model_zoo/)."""
from . import vision
