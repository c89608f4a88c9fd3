"""AlexNet of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/model_zoo/vision/alexnet.py), with the JAX
package's structure and parameter names."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (HybridSequential, Conv2D, Dense, Dropout, Flatten,
                   MaxPool2D)
from ._factory import build

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    def __init__(self, classes=1000):
        super().__init__()
        self.features = HybridSequential()
        self.features.add(
            Conv2D(64, kernel_size=11, strides=4, padding=2,
                   activation="relu"),
            MaxPool2D(pool_size=3, strides=2),
            Conv2D(192, kernel_size=5, padding=2, activation="relu"),
            MaxPool2D(pool_size=3, strides=2),
            Conv2D(384, kernel_size=3, padding=1, activation="relu"),
            Conv2D(256, kernel_size=3, padding=1, activation="relu"),
            Conv2D(256, kernel_size=3, padding=1, activation="relu"),
            MaxPool2D(pool_size=3, strides=2),
            Flatten(),
            Dense(4096, activation="relu"), Dropout(0.5),
            Dense(4096, activation="relu"), Dropout(0.5))
        self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(**kwargs):
    return build(AlexNet, **kwargs)
