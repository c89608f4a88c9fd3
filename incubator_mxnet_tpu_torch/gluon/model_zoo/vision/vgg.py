"""VGG 11/13/16/19, with and without BatchNorm, of the PyTorch port
(counterpart of incubator_mxnet_tpu/gluon/model_zoo/vision/vgg.py), with
the JAX package's structure and parameter names; every width deferred to
the first forward.  Its 3x3 convolutions never fuse with their
BatchNorms (only a pointwise one does)."""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (HybridSequential, Conv2D, Dense, Dropout, Flatten,
                   MaxPool2D, BatchNorm, Activation)
from ._factory import build

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn", "get_vgg"]

_vgg_spec = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False):
        super().__init__()
        self.features = HybridSequential()
        for i, num in enumerate(layers):
            for _ in range(num):
                self.features.add(Conv2D(filters[i], kernel_size=3,
                                         padding=1))
                if batch_norm:
                    self.features.add(BatchNorm())
                self.features.add(Activation("relu"))
            self.features.add(MaxPool2D(strides=2))
        self.features.add(Flatten(),
                          Dense(4096, activation="relu"), Dropout(0.5),
                          Dense(4096, activation="relu"), Dropout(0.5))
        self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def get_vgg(num_layers, **kwargs):
    """VGG of `num_layers` (11, 13, 16 or 19); `batch_norm`, `classes`,
    and the factories' `pretrained` and `ctx`."""
    layers, filters = _vgg_spec[num_layers]
    return build(VGG, layers, filters, **kwargs)


def vgg11(**kw):
    return get_vgg(11, **kw)


def vgg13(**kw):
    return get_vgg(13, **kw)


def vgg16(**kw):
    return get_vgg(16, **kw)


def vgg19(**kw):
    return get_vgg(19, **kw)


def vgg11_bn(**kw):
    return get_vgg(11, batch_norm=True, **kw)


def vgg13_bn(**kw):
    return get_vgg(13, batch_norm=True, **kw)


def vgg16_bn(**kw):
    return get_vgg(16, batch_norm=True, **kw)


def vgg19_bn(**kw):
    return get_vgg(19, batch_norm=True, **kw)
