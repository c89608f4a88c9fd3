"""ResNet v1, v1b and v2 of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/model_zoo/vision/resnet.py).

The structure and the parameter names are the JAX package's
(`features.5.0.body.0.weight`, `features.1.running_mean`, ...).  The
stem convolution takes its input channels from the first forward's
images, as the JAX stem does; every other width follows from the
network's channels and is known when the block is built.  Every block
takes `device` and `dtype`: with a device its parameters are
initialized there at once (the stem's at the first forward), without
one they wait for `initialize(init, ctx)` (`get_resnet(ctx=...)` passes
its `ctx` as the device).  Inside each bottleneck the 1x1 convolutions
that a BatchNorm follows run through the fused 1x1-conv + statistics
kernel while training (`HybridSequential`); resnet50_v1b has 33 such
pairs.  The v2 (pre-activation) blocks hold their layers as attributes,
not in a `HybridSequential`, as the JAX ones do, so nothing of v2 fuses.
"""
from __future__ import annotations

import torch

from ....base import MXNetError
from ...block import HybridBlock
from ...nn import (HybridSequential, Conv2D, BatchNorm, Activation, Dense,
                   MaxPool2D, GlobalAvgPool2D, Flatten)
from ._factory import check_pretrained

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2", "resnet18_v1b", "resnet34_v1b", "resnet50_v1b",
           "resnet101_v1b", "resnet152_v1b"]

def _conv3x3(channels, stride, in_channels, **kw):
    return Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                  use_bias=False, in_channels=in_channels, **kw)


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, dtype="float32"):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.body = HybridSequential()
        self.body.add(_conv3x3(channels, stride, in_channels, **kw))
        self.body.add(BatchNorm(in_channels=channels, **kw))
        self.body.add(Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, **kw))
        self.body.add(BatchNorm(in_channels=channels, **kw))
        if downsample:
            self.downsample = HybridSequential()
            self.downsample.add(Conv2D(channels, kernel_size=1,
                                       strides=stride, use_bias=False,
                                       in_channels=in_channels, **kw))
            self.downsample.add(BatchNorm(in_channels=channels, **kw))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)


class BottleneckV1(HybridBlock):
    """v1: stride on the first 1x1; v1b: stride on the 3x3."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 stride_on_3x3=False, device=None, dtype="float32"):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        s1, s3 = (1, stride) if stride_on_3x3 else (stride, 1)
        mid = channels // 4
        self.body = HybridSequential()
        self.body.add(Conv2D(mid, kernel_size=1, strides=s1, use_bias=False,
                             in_channels=in_channels, **kw))
        self.body.add(BatchNorm(in_channels=mid, **kw))
        self.body.add(Activation("relu"))
        self.body.add(_conv3x3(mid, s3, mid, **kw))
        self.body.add(BatchNorm(in_channels=mid, **kw))
        self.body.add(Activation("relu"))
        self.body.add(Conv2D(channels, kernel_size=1, strides=1,
                             use_bias=False, in_channels=mid, **kw))
        self.body.add(BatchNorm(in_channels=channels, **kw))
        if downsample:
            self.downsample = HybridSequential()
            self.downsample.add(Conv2D(channels, kernel_size=1,
                                       strides=stride, use_bias=False,
                                       in_channels=in_channels, **kw))
            self.downsample.add(BatchNorm(in_channels=channels, **kw))
        else:
            self.downsample = None

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.body(x) + residual)


class BasicBlockV2(HybridBlock):
    """Pre-activation: BatchNorm and ReLU before each 3x3 convolution;
    the downsample takes the first activation."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, dtype="float32"):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.bn1 = BatchNorm(in_channels=in_channels, **kw)
        self.conv1 = _conv3x3(channels, stride, in_channels, **kw)
        self.bn2 = BatchNorm(in_channels=channels, **kw)
        self.conv2 = _conv3x3(channels, 1, channels, **kw)
        self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                 in_channels=in_channels, **kw) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        return self.conv2(x) + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 device=None, dtype="float32"):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        mid = channels // 4
        self.bn1 = BatchNorm(in_channels=in_channels, **kw)
        self.conv1 = Conv2D(mid, 1, 1, use_bias=False,
                            in_channels=in_channels, **kw)
        self.bn2 = BatchNorm(in_channels=mid, **kw)
        self.conv2 = _conv3x3(mid, stride, mid, **kw)
        self.bn3 = BatchNorm(in_channels=mid, **kw)
        self.conv3 = Conv2D(channels, 1, 1, use_bias=False, in_channels=mid,
                            **kw)
        self.downsample = Conv2D(channels, 1, stride, use_bias=False,
                                 in_channels=in_channels, **kw) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = torch.relu(self.bn1(x))
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = torch.relu(self.bn2(x))
        x = self.conv2(x)
        x = torch.relu(self.bn3(x))
        return self.conv3(x) + residual


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, stride_on_3x3=False, device=None,
                 dtype="float32"):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise ValueError("ResNetV1 needs one more width than stages, "
                             "got %d stages and %d widths"
                             % (len(layers), len(channels)))
        kw = dict(device=device, dtype=dtype)
        self.features = HybridSequential()
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0, **kw))
        else:
            self.features.add(Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                     **kw))
            self.features.add(BatchNorm(in_channels=channels[0], **kw))
            self.features.add(Activation("relu"))
            self.features.add(MaxPool2D(3, 2, 1))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(self._make_layer(
                block, num_layer, channels[i + 1], stride, channels[i],
                stride_on_3x3, kw))
        self.features.add(GlobalAvgPool2D())
        self.features.add(Flatten())
        self.output = Dense(classes, in_units=channels[-1], **kw)

    @staticmethod
    def _make_layer(block, layers, channels, stride, in_channels,
                    stride_on_3x3, kw):
        if block is BottleneckV1:
            kw = dict(kw, stride_on_3x3=stride_on_3x3)
        layer = HybridSequential()
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, **kw))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels, **kw))
        return layer

    def forward(self, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """Pre-activation ResNet: an input BatchNorm without scale or shift,
    the stem, the stages, then BatchNorm and ReLU before the pool."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, device=None, dtype="float32"):
        super().__init__()
        if len(layers) != len(channels) - 1:
            raise ValueError("ResNetV2 needs one more width than stages, "
                             "got %d stages and %d widths"
                             % (len(layers), len(channels)))
        kw = dict(device=device, dtype=dtype)
        self.features = HybridSequential()
        self.features.add(BatchNorm(scale=False, center=False, **kw))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 0, **kw))
        else:
            self.features.add(Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                     **kw))
            self.features.add(BatchNorm(in_channels=channels[0], **kw))
            self.features.add(Activation("relu"))
            self.features.add(MaxPool2D(3, 2, 1))
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            layer = HybridSequential()
            layer.add(block(channels[i + 1], stride,
                            channels[i + 1] != in_channels,
                            in_channels=in_channels, **kw))
            for _ in range(num_layer - 1):
                layer.add(block(channels[i + 1], 1, False,
                                in_channels=channels[i + 1], **kw))
            self.features.add(layer)
            in_channels = channels[i + 1]
        self.features.add(BatchNorm(in_channels=in_channels, **kw))
        self.features.add(Activation("relu"))
        self.features.add(GlobalAvgPool2D())
        self.features.add(Flatten())
        self.output = Dense(classes, in_units=in_channels, **kw)

    def forward(self, x):
        return self.output(self.features(x))


_resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
_resnet_nets = (ResNetV1, ResNetV2)
_resnet_blocks = ({"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
                  {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2})


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               use_v1b=False, **kwargs):
    """ResNet `version` 1 or 2 of `num_layers` layers; `use_v1b` puts v1's
    stride on the 3x3 convolution.  Keyword arguments go to the network
    (classes, thumbnail, device, dtype); `ctx` initializes the network
    there, as `device` does."""
    if num_layers not in _resnet_spec:
        raise MXNetError("invalid resnet depth %d" % num_layers)
    if version not in (1, 2):
        raise MXNetError("resnet version must be 1 or 2")
    check_pretrained(pretrained)
    block_type, layers, channels = _resnet_spec[num_layers]
    if use_v1b:
        kwargs["stride_on_3x3"] = True
    if ctx is not None:
        kwargs.setdefault("device", ctx)
    return _resnet_nets[version - 1](
        _resnet_blocks[version - 1][block_type], layers, channels, **kwargs)


def resnet18_v1(**kw):
    return get_resnet(1, 18, **kw)


def resnet34_v1(**kw):
    return get_resnet(1, 34, **kw)


def resnet50_v1(**kw):
    return get_resnet(1, 50, **kw)


def resnet101_v1(**kw):
    return get_resnet(1, 101, **kw)


def resnet152_v1(**kw):
    return get_resnet(1, 152, **kw)


def resnet18_v2(**kw):
    return get_resnet(2, 18, **kw)


def resnet34_v2(**kw):
    return get_resnet(2, 34, **kw)


def resnet50_v2(**kw):
    return get_resnet(2, 50, **kw)


def resnet101_v2(**kw):
    return get_resnet(2, 101, **kw)


def resnet152_v2(**kw):
    return get_resnet(2, 152, **kw)


def resnet18_v1b(**kw):
    return get_resnet(1, 18, use_v1b=True, **kw)


def resnet34_v1b(**kw):
    return get_resnet(1, 34, use_v1b=True, **kw)


def resnet50_v1b(**kw):
    """bench.py's ResNet-50 training model (north-star config 1)."""
    return get_resnet(1, 50, use_v1b=True, **kw)


def resnet101_v1b(**kw):
    return get_resnet(1, 101, use_v1b=True, **kw)


def resnet152_v1b(**kw):
    return get_resnet(1, 152, use_v1b=True, **kw)
