"""`gluon.contrib` of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/contrib/): its `nn` layers and `rnn` cells.
The contrib `estimator` is not yet ported."""
from . import nn
from . import rnn
