"""incubator_mxnet_tpu_torch — the PyTorch/CUDA port of
incubator_mxnet_tpu, for NVIDIA Hopper (H100).

Conventional import:  ``import incubator_mxnet_tpu_torch as mx``

`mx.nd` is MXNet's imperative surface: `NDArray` over a torch tensor,
one function per registered operator (`ops.registry`) and `autograd`
over torch's.  Plain tensor code is PyTorch; every kernel that the JAX
package wrote in Pallas for the TPU is a CUDA kernel written by hand
(`ops/csrc/`), built with nvcc at first use.  Entry points run on
`cuda:0` unless the caller passes `device="cpu"`; the host image
functions (`mx.image`, `gluon.data.vision.transforms`) return NDArrays on
the CPU, as MXNet's image operators do.  This package imports neither
JAX nor the JAX package.
"""
from __future__ import annotations

__version__ = "0.1.0"

from . import config
from .base import MXNetError
from .context import (cpu, gpu, current_device, current_context, num_gpus,
                      resolve_device)
from . import random
from . import initializer
from . import initializer as init   # alias namespace, as in the JAX package
from . import ndarray
from . import ndarray as nd         # canonical alias mx.nd
from .ndarray import NDArray
from . import ops
from . import autograd
from . import lr_scheduler
from . import optimizer
from . import metric
from . import callback
from . import gluon
from . import kvstore
from . import kvstore as kv
from . import parallel
from . import io
from .io import recordio
from . import rnn
from . import image
from . import contrib
from . import models
from . import serving
from .serving import InferenceEngine
from . import weights
from . import test_utils
