"""DenseNet 121/161/169/201 of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/model_zoo/vision/densenet.py), with the JAX
package's structure and parameter names.  Each dense layer's bottleneck
1x1 convolution is followed by a BatchNorm in its `HybridSequential`, so
it runs fused while training (58 pairs in densenet121)."""
from __future__ import annotations

import torch

from ...block import HybridBlock
from ...nn import (HybridSequential, Conv2D, Dense, BatchNorm, Activation,
                   MaxPool2D, AvgPool2D, GlobalAvgPool2D, Flatten)
from ._factory import build

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size):
        super().__init__()
        self.body = HybridSequential()
        self.body.add(BatchNorm(), Activation("relu"),
                      Conv2D(bn_size * growth_rate, kernel_size=1,
                             use_bias=False),
                      BatchNorm(), Activation("relu"),
                      Conv2D(growth_rate, kernel_size=3, padding=1,
                             use_bias=False))

    def forward(self, x):
        return torch.cat([x, self.body(x)], dim=1)


def _make_dense_block(num_layers, bn_size, growth_rate):
    out = HybridSequential()
    for _ in range(num_layers):
        out.add(_DenseLayer(growth_rate, bn_size))
    return out


def _make_transition(num_output_features):
    out = HybridSequential()
    out.add(BatchNorm(), Activation("relu"),
            Conv2D(num_output_features, kernel_size=1, use_bias=False),
            AvgPool2D(pool_size=2, strides=2))
    return out


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, classes=1000):
        super().__init__()
        self.features = HybridSequential()
        self.features.add(Conv2D(num_init_features, kernel_size=7,
                                 strides=2, padding=3, use_bias=False),
                          BatchNorm(), Activation("relu"),
                          MaxPool2D(pool_size=3, strides=2, padding=1))
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            self.features.add(_make_dense_block(num_layers, bn_size,
                                                growth_rate))
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                num_features //= 2
                self.features.add(_make_transition(num_features))
        self.features.add(BatchNorm(), Activation("relu"),
                          GlobalAvgPool2D(), Flatten())
        self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


_densenet_spec = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
}


def _get(num):
    def ctor(**kw):
        return build(DenseNet, *_densenet_spec[num], **kw)
    ctor.__name__ = "densenet%d" % num
    return ctor


densenet121 = _get(121)
densenet161 = _get(161)
densenet169 = _get(169)
densenet201 = _get(201)
