"""SqueezeNet 1.0 and 1.1 of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/model_zoo/vision/squeezenet.py), with the JAX
package's structure and parameter names.  It has no BatchNorm."""
from __future__ import annotations

import torch

from ...block import HybridBlock
from ...nn import (HybridSequential, Conv2D, Dropout, MaxPool2D,
                   GlobalAvgPool2D, Flatten)
from ._factory import build

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class _Fire(HybridBlock):
    def __init__(self, squeeze_channels, expand1x1_channels,
                 expand3x3_channels):
        super().__init__()
        self.squeeze = Conv2D(squeeze_channels, kernel_size=1,
                              activation="relu")
        self.expand1x1 = Conv2D(expand1x1_channels, kernel_size=1,
                                activation="relu")
        self.expand3x3 = Conv2D(expand3x3_channels, kernel_size=3,
                                padding=1, activation="relu")

    def forward(self, x):
        x = self.squeeze(x)
        return torch.cat([self.expand1x1(x), self.expand3x3(x)], dim=1)


class SqueezeNet(HybridBlock):
    def __init__(self, version="1.0", classes=1000):
        super().__init__()
        self.features = HybridSequential()
        if version == "1.0":
            self.features.add(Conv2D(96, kernel_size=7, strides=2,
                                     activation="relu"),
                              MaxPool2D(pool_size=3, strides=2,
                                        ceil_mode=True),
                              _Fire(16, 64, 64), _Fire(16, 64, 64),
                              _Fire(32, 128, 128),
                              MaxPool2D(pool_size=3, strides=2,
                                        ceil_mode=True),
                              _Fire(32, 128, 128), _Fire(48, 192, 192),
                              _Fire(48, 192, 192), _Fire(64, 256, 256),
                              MaxPool2D(pool_size=3, strides=2,
                                        ceil_mode=True),
                              _Fire(64, 256, 256))
        else:
            self.features.add(Conv2D(64, kernel_size=3, strides=2,
                                     activation="relu"),
                              MaxPool2D(pool_size=3, strides=2,
                                        ceil_mode=True),
                              _Fire(16, 64, 64), _Fire(16, 64, 64),
                              MaxPool2D(pool_size=3, strides=2,
                                        ceil_mode=True),
                              _Fire(32, 128, 128), _Fire(32, 128, 128),
                              MaxPool2D(pool_size=3, strides=2,
                                        ceil_mode=True),
                              _Fire(48, 192, 192), _Fire(48, 192, 192),
                              _Fire(64, 256, 256), _Fire(64, 256, 256))
        self.features.add(Dropout(0.5))
        self.output = HybridSequential()
        self.output.add(Conv2D(classes, kernel_size=1, activation="relu"),
                        GlobalAvgPool2D(), Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def squeezenet1_0(**kw):
    return build(SqueezeNet, "1.0", **kw)


def squeezenet1_1(**kw):
    return build(SqueezeNet, "1.1", **kw)
