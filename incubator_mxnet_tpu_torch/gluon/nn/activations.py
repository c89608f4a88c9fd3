"""Gluon activation layers of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/nn/activations.py): `Activation`,
`LeakyReLU`, `PReLU` (a learned slope `alpha`, one value by default
zeros, as in the JAX package), `ELU`, `SELU`, `GELU` (the exact erf
form) and `Swish`, each over the `LeakyReLU` / `Activation` ops."""
from __future__ import annotations

import torch

from ..block import HybridBlock, new_parameter
from ...ops import nn as ops

__all__ = ["Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU",
           "Swish"]


class Activation(HybridBlock):
    """ref: nn.Activation: relu, sigmoid, tanh, softrelu or softsign."""

    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return ops.activation(x, act_type=self._act_type)


class _LeakyReLUOp(HybridBlock):
    """One `LeakyReLU` op of a fixed act_type and slope."""

    _act_type = None

    def __init__(self, slope=0.25):
        super().__init__()
        self._slope = slope

    def forward(self, x):
        return ops.leaky_relu(x, act_type=self._act_type, slope=self._slope)


class LeakyReLU(_LeakyReLUOp):
    """x where x >= 0, else alpha x."""

    _act_type = "leaky"

    def __init__(self, alpha):
        super().__init__(alpha)


class ELU(_LeakyReLUOp):
    """x where x >= 0, else alpha (exp(x) - 1)."""

    _act_type = "elu"

    def __init__(self, alpha=1.0):
        super().__init__(alpha)


class SELU(_LeakyReLUOp):
    _act_type = "selu"

    def __init__(self):
        super().__init__()


class GELU(_LeakyReLUOp):
    _act_type = "gelu"

    def __init__(self):
        super().__init__()


class PReLU(HybridBlock):
    """x where x >= 0, else alpha x with a learned `alpha` (1,)."""

    def __init__(self, alpha_initializer="zeros", device=None,
                 dtype="float32"):
        super().__init__()
        self.alpha = new_parameter("alpha", (1,), alpha_initializer, device,
                                   dtype)

    def forward(self, x):
        return ops.leaky_relu(x, self.alpha, act_type="prelu")


class Swish(HybridBlock):
    """x sigmoid(beta x)."""

    def __init__(self, beta=1.0):
        super().__init__()
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)
