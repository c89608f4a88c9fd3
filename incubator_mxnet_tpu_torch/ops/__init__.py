"""Operators of the PyTorch port: plain PyTorch for what the JAX package
left to XLA, hand-written CUDA kernels for what it wrote in Pallas (and
for the greedy NMS of the detection ops, `nms`).  The
modules register their operators in `registry` under the JAX package's
names, for `mx.nd`."""
from . import registry
from . import tensor
from . import nn
from . import attention
from . import optimizer
from . import random
from . import nms
from . import contrib
from . import rcnn
from . import rnn
