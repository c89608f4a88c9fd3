"""Gluon convolution and pooling layers of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/nn/conv_layers.py): `Conv2D` and the 2-D
pooling layers.

As the port's other layers, `Conv2D` takes its input width
(`in_channels`) when it is built, where the JAX layer may defer it to
the first forward.
"""
from __future__ import annotations

from ..block import HybridBlock, new_parameter
from ...context import resolve_device
from ...ops import nn as ops

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalMaxPool2D",
           "GlobalAvgPool2D"]


def _to_tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


class Conv2D(HybridBlock):
    """ref: nn.Conv2D → Convolution.  weight (channels,
    in_channels / groups, kh, kw), bias zeros."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 device=None, dtype="float32"):
        super().__init__()
        if in_channels <= 0:
            raise ValueError("Conv2D in the PyTorch port needs "
                             "in_channels > 0 (widths are not deferred)")
        if layout != "NCHW":
            raise NotImplementedError("Conv2D(layout=%r) is not yet ported"
                                      % (layout,))
        kernel = _to_tuple(kernel_size, 2)
        self._kwargs = dict(kernel=kernel, stride=_to_tuple(strides, 2),
                            dilate=_to_tuple(dilation, 2),
                            pad=_to_tuple(padding, 2), num_filter=channels,
                            num_group=groups, no_bias=not use_bias,
                            layout=layout)
        self.act = activation
        dev = resolve_device(device)
        self.weight = new_parameter(
            "weight", (channels, in_channels // groups) + kernel,
            weight_initializer, dev, dtype)
        self.bias = new_parameter("bias", (channels,), bias_initializer,
                                  dev, dtype) if use_bias else None

    @property
    def pointwise(self):
        """A plain 1x1 product over channels: 1x1 kernel, stride 1, no
        padding or dilation, one group, no bias and no activation."""
        kw = self._kwargs
        return (kw["kernel"] == (1, 1) and kw["stride"] == (1, 1)
                and kw["pad"] == (0, 0) and kw["dilate"] == (1, 1)
                and kw["num_group"] == 1 and self.bias is None
                and self.act is None)

    def forward(self, x):
        out = ops.convolution(x, self.weight, self.bias, **self._kwargs)
        if self.act is not None:
            out = ops.activation(out, act_type=self.act)
        return out


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", layout="NCHW",
                 count_include_pad=True):
        super().__init__()
        if layout != "NCHW":
            raise NotImplementedError("pooling layout %r is not yet ported"
                                      % (layout,))
        if strides is None:
            strides = pool_size
        self._kwargs = dict(
            kernel=pool_size, stride=strides, pad=padding,
            global_pool=global_pool, pool_type=pool_type,
            pooling_convention="full" if ceil_mode else "valid",
            count_include_pad=count_include_pad)

    def forward(self, x):
        return ops.pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(_to_tuple(pool_size, 2),
                         _to_tuple(strides, 2) if strides is not None
                         else None, _to_tuple(padding, 2), ceil_mode,
                         layout=layout)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(_to_tuple(pool_size, 2),
                         _to_tuple(strides, 2) if strides is not None
                         else None, _to_tuple(padding, 2), ceil_mode,
                         pool_type="avg", layout=layout,
                         count_include_pad=count_include_pad)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, (0, 0), True, global_pool=True,
                         pool_type="max", layout=layout)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW"):
        super().__init__((1, 1), None, (0, 0), True, global_pool=True,
                         pool_type="avg", layout=layout)
