"""Operators of the PyTorch port: plain PyTorch for what the JAX package
left to XLA, hand-written CUDA kernels for what it wrote in Pallas."""
from . import nn
from . import attention
from . import optimizer
