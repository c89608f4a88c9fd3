"""`gluon.contrib.rnn` of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/contrib/rnn/)."""
from .rnn_cell import *          # noqa: F401,F403
from .conv_rnn_cell import *     # noqa: F401,F403
