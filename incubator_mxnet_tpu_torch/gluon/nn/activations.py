"""Gluon activation layers of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/nn/activations.py), limited to `Activation`."""
from __future__ import annotations

from ..block import HybridBlock
from ...ops import nn as ops

__all__ = ["Activation"]


class Activation(HybridBlock):
    """ref: nn.Activation: relu, sigmoid, tanh, softrelu or softsign."""

    def __init__(self, activation):
        super().__init__()
        self._act_type = activation

    def forward(self, x):
        return ops.activation(x, act_type=self._act_type)
