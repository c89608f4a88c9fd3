"""Inception v3 of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/model_zoo/vision/inception.py), with the JAX
package's structure and parameter names; 299 x 299 inputs (its final
8 x 8 average pool needs them).  Every convolution is a
`HybridSequential` of Conv2D, BatchNorm(epsilon 0.001) and ReLU, so its
1x1 ones run fused while training.  The branches of a mixed block run on
the same input (`_Concurrent`, which the JAX package writes in place of
upstream's HybridConcurrent) and are concatenated on the channels."""
from __future__ import annotations

import torch

from ...block import HybridBlock
from ...nn import (HybridSequential, Conv2D, BatchNorm, Activation,
                   MaxPool2D, AvgPool2D, Dropout, Dense)
from ._factory import build

__all__ = ["Inception3", "inception_v3"]


def _conv(channels, kernel_size, strides=1, padding=0):
    out = HybridSequential()
    out.add(Conv2D(channels, kernel_size=kernel_size, strides=strides,
                   padding=padding, use_bias=False),
            BatchNorm(epsilon=0.001),
            Activation("relu"))
    return out


class _Concurrent(HybridBlock):
    """Its children (`branch0`, `branch1`, ...) on the same input,
    concatenated on the channels."""

    def __init__(self):
        super().__init__()
        self._n = 0

    def add(self, *blocks):
        for b in blocks:
            setattr(self, "branch%d" % self._n, b)
            self._n += 1

    def forward(self, x):
        return torch.cat([getattr(self, "branch%d" % i)(x)
                          for i in range(self._n)], dim=1)


def _branch(*specs):
    seq = HybridSequential()
    for channels, kernel, stride, pad in specs:
        seq.add(_conv(channels, kernel, stride, pad))
    return seq


def _pool_branch(pool, *specs):
    seq = HybridSequential()
    seq.add(pool)
    for channels, kernel, stride, pad in specs:
        seq.add(_conv(channels, kernel, stride, pad))
    return seq


def _make_A(pool_features):
    out = _Concurrent()
    out.add(_branch((64, 1, 1, 0)),
            _branch((48, 1, 1, 0), (64, 5, 1, 2)),
            _branch((64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 1, 1)),
            _pool_branch(AvgPool2D(pool_size=3, strides=1, padding=1),
                         (pool_features, 1, 1, 0)))
    return out


def _make_B():
    out = _Concurrent()
    out.add(_branch((384, 3, 2, 0)),
            _branch((64, 1, 1, 0), (96, 3, 1, 1), (96, 3, 2, 0)),
            _pool_branch(MaxPool2D(pool_size=3, strides=2)))
    return out


def _make_C(channels_7x7):
    c = channels_7x7
    out = _Concurrent()
    out.add(_branch((192, 1, 1, 0)),
            _branch((c, 1, 1, 0), (c, (1, 7), 1, (0, 3)),
                    (192, (7, 1), 1, (3, 0))),
            _branch((c, 1, 1, 0), (c, (7, 1), 1, (3, 0)),
                    (c, (1, 7), 1, (0, 3)), (c, (7, 1), 1, (3, 0)),
                    (192, (1, 7), 1, (0, 3))),
            _pool_branch(AvgPool2D(pool_size=3, strides=1, padding=1),
                         (192, 1, 1, 0)))
    return out


def _make_D():
    out = _Concurrent()
    out.add(_branch((192, 1, 1, 0), (320, 3, 2, 0)),
            _branch((192, 1, 1, 0), (192, (1, 7), 1, (0, 3)),
                    (192, (7, 1), 1, (3, 0)), (192, 3, 2, 0)),
            _pool_branch(MaxPool2D(pool_size=3, strides=2)))
    return out


class _SplitBranch(HybridBlock):
    """A reduction, then (1, 3) and (3, 1) convolutions side by side,
    concatenated: the E block's expanded branches."""

    def __init__(self, reduce_spec):
        super().__init__()
        self.reduce = HybridSequential()
        for channels, kernel, stride, pad in reduce_spec:
            self.reduce.add(_conv(channels, kernel, stride, pad))
        self.a = _conv(384, (1, 3), 1, (0, 1))
        self.b = _conv(384, (3, 1), 1, (1, 0))

    def forward(self, x):
        x = self.reduce(x)
        return torch.cat([self.a(x), self.b(x)], dim=1)


def _make_E():
    out = _Concurrent()
    out.add(_branch((320, 1, 1, 0)),
            _SplitBranch([(384, 1, 1, 0)]),
            _SplitBranch([(448, 1, 1, 0), (384, 3, 1, 1)]),
            _pool_branch(AvgPool2D(pool_size=3, strides=1, padding=1),
                         (192, 1, 1, 0)))
    return out


class Inception3(HybridBlock):
    def __init__(self, classes=1000):
        super().__init__()
        f = HybridSequential()
        f.add(_conv(32, 3, 2, 0), _conv(32, 3, 1, 0), _conv(64, 3, 1, 1),
              MaxPool2D(pool_size=3, strides=2),
              _conv(80, 1, 1, 0), _conv(192, 3, 1, 0),
              MaxPool2D(pool_size=3, strides=2),
              _make_A(32), _make_A(64), _make_A(64),
              _make_B(),
              _make_C(128), _make_C(160), _make_C(160), _make_C(192),
              _make_D(),
              _make_E(), _make_E(),
              AvgPool2D(pool_size=8), Dropout(0.5))
        self.features = f
        self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(**kwargs):
    return build(Inception3, **kwargs)
