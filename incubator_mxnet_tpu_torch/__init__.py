"""incubator_mxnet_tpu_torch — the PyTorch/CUDA port of
incubator_mxnet_tpu, for NVIDIA Hopper (H100).

Conventional import:  ``import incubator_mxnet_tpu_torch as mx``

Plain tensor code is PyTorch; every kernel that the JAX package wrote in
Pallas for the TPU is a CUDA kernel written by hand (`ops/csrc/`), built
with nvcc at first use.  Entry points run on `cuda:0` unless the caller
passes `device="cpu"`.  This package imports neither JAX nor the JAX
package.
"""
from __future__ import annotations

__version__ = "0.1.0"

from . import config
from .base import MXNetError
from .context import cpu, gpu, current_device, resolve_device
from . import random
from . import initializer
from . import initializer as init   # alias namespace, as in the JAX package
from . import ops
from . import autograd
from . import optimizer
from . import gluon
from . import contrib
from . import models
from . import serving
from .serving import InferenceEngine
from . import weights
