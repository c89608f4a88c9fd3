"""`gluon.contrib` of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/contrib/): its `nn` layers.  The contrib
`rnn` cells and `estimator` are not yet ported."""
from . import nn
