"""Gluon convolution and pooling layers of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/nn/conv_layers.py): the 1-, 2- and 3-D
convolutions and transposed convolutions, the max, average and global
pools of each rank, and `ReflectionPad2D`.

As in the JAX package, a convolution built with `in_channels=0` takes
its input width from the first forward's input (`infer_shape`).  A
convolution's weight is (channels, in_channels / groups, *kernel), a
transposed one's (in_channels, channels / groups, *kernel), the
reference's layout.  Only channel-first layouts are computed, as in the
JAX ops (which read every layout as channel-first); another raises.
"""
from __future__ import annotations

from ..block import HybridBlock, materialize, new_parameter
from ...ops import nn as ops
from ...ops import tensor as tensor_ops

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

#: the channel-first layout of each number of spatial axes
_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _to_tuple(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _check_layout(layout, n, what):
    if layout != _LAYOUTS[n]:
        raise NotImplementedError("%s(layout=%r): the port computes the "
                                  "channel-first layout %s only"
                                  % (what, layout, _LAYOUTS[n]))


class _Conv(HybridBlock):
    """A convolution of `n` spatial axes (ref: nn._Conv): the op
    `Convolution`, or `Deconvolution` for the transposed subclasses,
    then `activation` if given.  The bias is zeros by default."""

    _transposed = False

    def __init__(self, n, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels, activation, use_bias,
                 weight_initializer, bias_initializer, device, dtype,
                 adj=None):
        super().__init__()
        _check_layout(layout, n, type(self).__name__)
        kernel = _to_tuple(kernel_size, n)
        self._kwargs = dict(kernel=kernel, stride=_to_tuple(strides, n),
                            dilate=_to_tuple(dilation, n),
                            pad=_to_tuple(padding, n), num_filter=channels,
                            num_group=groups, no_bias=not use_bias,
                            layout=layout)
        if adj is not None:
            self._kwargs["adj"] = _to_tuple(adj, n)
        self.act = activation
        self.channels = channels
        self.weight = new_parameter(
            "weight", self._weight_shape(in_channels), weight_initializer,
            device, dtype)
        self.bias = new_parameter("bias", (channels,), bias_initializer,
                                  device, dtype) if use_bias else None

    def _weight_shape(self, in_channels):
        """(out, in / groups, *kernel); 0 for a width not known yet."""
        return (self.channels, in_channels // self._kwargs["num_group"]) \
            + self._kwargs["kernel"]

    def infer_shape(self, x):
        """Materialise a deferred weight from `x`'s channels."""
        materialize(self.weight, self._weight_shape(x.shape[1]))

    def forward(self, x):
        self.infer_shape(x)
        op = ops.deconvolution if self._transposed else ops.convolution
        out = op(x, self.weight, self.bias, **self._kwargs)
        if self.act is not None:
            out = ops.activation(out, act_type=self.act)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", in_channels=0,
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", device=None, dtype="float32"):
        super().__init__(1, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype)


class Conv2D(_Conv):
    """ref: nn.Conv2D → Convolution.  A pointwise one (`pointwise`)
    followed by a BatchNorm runs fused inside a `HybridSequential`."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 device=None, dtype="float32"):
        super().__init__(2, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype)

    @property
    def pointwise(self):
        """A plain 1x1 product over channels: 1x1 kernel, stride 1, no
        padding or dilation, one group, no bias and no activation."""
        kw = self._kwargs
        return (kw["kernel"] == (1, 1) and kw["stride"] == (1, 1)
                and kw["pad"] == (0, 0) and kw["dilate"] == (1, 1)
                and kw["num_group"] == 1 and self.bias is None
                and self.act is None)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", device=None, dtype="float32"):
        super().__init__(3, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype)


class _ConvTranspose(_Conv):
    """ref: nn._Conv with the `Deconvolution` op; `output_padding` is its
    `adj`."""

    _transposed = True

    def _weight_shape(self, in_channels):
        """(in, out / groups, *kernel), the reference's layout."""
        return (in_channels, self.channels // self._kwargs["num_group"]) \
            + self._kwargs["kernel"]


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 device=None, dtype="float32"):
        super().__init__(1, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype, adj=output_padding)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", device=None, dtype="float32"):
        super().__init__(2, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype, adj=output_padding)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 in_channels=0, activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 device=None, dtype="float32"):
        super().__init__(3, channels, kernel_size, strides, padding,
                         dilation, groups, layout, in_channels, activation,
                         use_bias, weight_initializer, bias_initializer,
                         device, dtype, adj=output_padding)


class _Pooling(HybridBlock):
    """Pooling over `n` spatial axes (ref: nn._Pooling → Pooling);
    `strides` defaults to the pool size, `ceil_mode` is the 'full'
    convention."""

    def __init__(self, n, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", layout=None,
                 count_include_pad=True):
        super().__init__()
        _check_layout(layout, n, type(self).__name__)
        pool_size = _to_tuple(pool_size, n)
        self._kwargs = dict(
            kernel=pool_size,
            stride=pool_size if strides is None else _to_tuple(strides, n),
            pad=_to_tuple(padding, n), global_pool=global_pool,
            pool_type=pool_type,
            pooling_convention="full" if ceil_mode else "valid",
            count_include_pad=count_include_pad)

    def forward(self, x):
        return ops.pooling(x, **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False):
        super().__init__(1, pool_size, strides, padding, ceil_mode,
                         layout=layout)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False):
        super().__init__(2, pool_size, strides, padding, ceil_mode,
                         layout=layout)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False):
        super().__init__(3, pool_size, strides, padding, ceil_mode,
                         layout=layout)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True):
        super().__init__(1, pool_size, strides, padding, ceil_mode,
                         pool_type="avg", layout=layout,
                         count_include_pad=count_include_pad)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, count_include_pad=True):
        super().__init__(2, pool_size, strides, padding, ceil_mode,
                         pool_type="avg", layout=layout,
                         count_include_pad=count_include_pad)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout="NCDHW", ceil_mode=False, count_include_pad=True):
        super().__init__(3, pool_size, strides, padding, ceil_mode,
                         pool_type="avg", layout=layout,
                         count_include_pad=count_include_pad)


class _GlobalPooling(_Pooling):
    def __init__(self, n, pool_type, layout):
        super().__init__(n, 1, None, 0, True, global_pool=True,
                         pool_type=pool_type, layout=layout)


class GlobalMaxPool1D(_GlobalPooling):
    def __init__(self, layout="NCW"):
        super().__init__(1, "max", layout)


class GlobalMaxPool2D(_GlobalPooling):
    def __init__(self, layout="NCHW"):
        super().__init__(2, "max", layout)


class GlobalMaxPool3D(_GlobalPooling):
    def __init__(self, layout="NCDHW"):
        super().__init__(3, "max", layout)


class GlobalAvgPool1D(_GlobalPooling):
    def __init__(self, layout="NCW"):
        super().__init__(1, "avg", layout)


class GlobalAvgPool2D(_GlobalPooling):
    def __init__(self, layout="NCHW"):
        super().__init__(2, "avg", layout)


class GlobalAvgPool3D(_GlobalPooling):
    def __init__(self, layout="NCDHW"):
        super().__init__(3, "avg", layout)


class ReflectionPad2D(HybridBlock):
    """ref: nn.ReflectionPad2D: `padding` pixels mirrored on each side of
    an NCHW input (an int), or the `pad` op's 8-entry pad_width."""

    def __init__(self, padding=0):
        super().__init__()
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def forward(self, x):
        return tensor_ops.pad(x, mode="reflect", pad_width=self._padding)
