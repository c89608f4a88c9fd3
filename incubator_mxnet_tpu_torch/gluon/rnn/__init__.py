"""`mx.gluon.rnn` of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/rnn/): the fused layers and the cells."""
from .rnn_cell import *      # noqa: F401,F403
from .rnn_layer import *     # noqa: F401,F403
