"""MobileNet v1, v2 and v3 of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/model_zoo/vision/mobilenet.py), with the JAX
package's structure and parameter names.

Every width is deferred to the first forward, as in the JAX package
(`initialize(init, ctx)`, then a forward).  `_add_conv` puts a bias-free
Conv2D before a BatchNorm inside a `HybridSequential`, so each pointwise
convolution that a BatchNorm follows runs fused with its statistics
while training: mobilenet_v2_1_0 has 34 such pairs (16 expansions, 17
projections and the 320 → 1280 head), mobilenet1_0 13.  ReLU6, h-swish
and h-sigmoid are `hybrid_forward` blocks over `F.clip`, as there.
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn import (HybridSequential, Conv2D, Dense, BatchNorm, Activation,
                   GlobalAvgPool2D, Flatten)
from ._factory import build

__all__ = ["MobileNet", "MobileNetV2", "MobileNetV3", "mobilenet1_0",
           "mobilenet0_75", "mobilenet0_5", "mobilenet0_25",
           "mobilenet_v2_1_0", "mobilenet_v2_0_75", "mobilenet_v2_0_5",
           "mobilenet_v2_0_25", "mobilenet_v3_small",
           "mobilenet_v3_large"]


def _add_conv(out, channels, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False):
    out.add(Conv2D(channels, kernel, stride, pad, groups=num_group,
                   use_bias=False))
    out.add(BatchNorm())
    if active:
        out.add(_ReLU6() if relu6 else Activation("relu"))


class _ReLU6(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.clip(x, 0.0, 6.0)


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    """v2's inverted residual: a 1x1 expansion by `t` (none for t = 1), a
    3x3 depthwise convolution, a linear 1x1 projection, and the shortcut
    where the shape allows."""

    def __init__(self, in_channels, channels, t, stride):
        super().__init__()
        self.use_shortcut = stride == 1 and in_channels == channels
        self.out = HybridSequential()
        if t != 1:
            _add_conv(self.out, in_channels * t, relu6=True)
        _add_conv(self.out, in_channels * t, kernel=3, stride=stride,
                  pad=1, num_group=in_channels * t, relu6=True)
        _add_conv(self.out, channels, active=False, relu6=True)

    def forward(self, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000):
        super().__init__()
        self.features = HybridSequential()
        _add_conv(self.features, int(32 * multiplier), kernel=3, stride=2,
                  pad=1)
        dw_channels = [int(x * multiplier) for x in
                       [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]]
        channels = [int(x * multiplier) for x in
                    [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
        strides = [1, 2, 1, 2, 1, 2] + [1] * 5 + [2, 1]
        for dwc, c, s in zip(dw_channels, channels, strides):
            _add_conv_dw(self.features, dwc, c, s)
        self.features.add(GlobalAvgPool2D(), Flatten())
        self.output = Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000):
        super().__init__()
        self.features = HybridSequential()
        _add_conv(self.features, int(32 * multiplier), kernel=3, stride=2,
                  pad=1, relu6=True)
        in_channels_group = [int(x * multiplier) for x in
                             [32] + [16] + [24] * 2 + [32] * 3 + [64] * 4
                             + [96] * 3 + [160] * 3]
        channels_group = [int(x * multiplier) for x in
                          [16] + [24] * 2 + [32] * 3 + [64] * 4 + [96] * 3
                          + [160] * 3 + [320]]
        ts = [1] + [6] * 16
        strides = [1, 2] + [1, 2] + [1] * 2 + [2] + [1] * 6 + [2] + [1] * 3
        for in_c, c, t, s in zip(in_channels_group, channels_group, ts,
                                 strides):
            self.features.add(LinearBottleneck(in_c, c, t, s))
        last_channels = int(1280 * multiplier) if multiplier > 1.0 else 1280
        _add_conv(self.features, last_channels, relu6=True)
        self.features.add(GlobalAvgPool2D())
        self.output = HybridSequential()
        self.output.add(Conv2D(classes, 1, use_bias=False), Flatten())

    def forward(self, x):
        return self.output(self.features(x))


class _HSwish(HybridBlock):
    def hybrid_forward(self, F, x):
        return x * F.clip(x + 3.0, 0.0, 6.0) / 6.0


class _HSigmoid(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.clip(x + 3.0, 0.0, 6.0) / 6.0


class _SE(HybridBlock):
    """Squeeze and excite: a pooled 1x1 bottleneck gating the channels."""

    def __init__(self, channels, reduction=4):
        super().__init__()
        self.pool = GlobalAvgPool2D()
        self.fc1 = Conv2D(max(channels // reduction, 8), 1)
        self.act = Activation("relu")
        self.fc2 = Conv2D(channels, 1)
        self.gate = _HSigmoid()

    def forward(self, x):
        w = self.gate(self.fc2(self.act(self.fc1(self.pool(x)))))
        return x * w


class _V3Bottleneck(HybridBlock):
    def __init__(self, in_c, exp_c, out_c, kernel, stride, se, hs):
        super().__init__()
        self.use_res = stride == 1 and in_c == out_c
        self.body = HybridSequential()
        if exp_c != in_c:
            self.body.add(Conv2D(exp_c, 1, use_bias=False), BatchNorm(),
                          _HSwish() if hs else Activation("relu"))
        self.body.add(Conv2D(exp_c, kernel, stride, kernel // 2,
                             groups=exp_c, use_bias=False), BatchNorm(),
                      _HSwish() if hs else Activation("relu"))
        if se:
            self.body.add(_SE(exp_c))
        self.body.add(Conv2D(out_c, 1, use_bias=False), BatchNorm())

    def forward(self, x):
        out = self.body(x)
        return x + out if self.use_res else out


# (kernel, expansion, out, SE, hard swish, stride) per GluonCV's
# mobilenet_v3
_V3_SMALL = [(3, 16, 16, True, False, 2), (3, 72, 24, False, False, 2),
             (3, 88, 24, False, False, 1), (5, 96, 40, True, True, 2),
             (5, 240, 40, True, True, 1), (5, 240, 40, True, True, 1),
             (5, 120, 48, True, True, 1), (5, 144, 48, True, True, 1),
             (5, 288, 96, True, True, 2), (5, 576, 96, True, True, 1),
             (5, 576, 96, True, True, 1)]
_V3_LARGE = [(3, 16, 16, False, False, 1), (3, 64, 24, False, False, 2),
             (3, 72, 24, False, False, 1), (5, 72, 40, True, False, 2),
             (5, 120, 40, True, False, 1), (5, 120, 40, True, False, 1),
             (3, 240, 80, False, True, 2), (3, 200, 80, False, True, 1),
             (3, 184, 80, False, True, 1), (3, 184, 80, False, True, 1),
             (3, 480, 112, True, True, 1), (3, 672, 112, True, True, 1),
             (5, 672, 160, True, True, 2), (5, 960, 160, True, True, 1),
             (5, 960, 160, True, True, 1)]


class MobileNetV3(HybridBlock):
    def __init__(self, mode="small", multiplier=1.0, classes=1000):
        super().__init__()
        cfg = _V3_SMALL if mode == "small" else _V3_LARGE
        last_exp = 576 if mode == "small" else 960
        head_c = 1024 if mode == "small" else 1280

        def _c(x):
            return max(8, int(x * multiplier))

        self.features = HybridSequential()
        self.features.add(Conv2D(_c(16), 3, 2, 1, use_bias=False),
                          BatchNorm(), _HSwish())
        in_c = _c(16)
        for k, e, o, se, hs, s in cfg:
            self.features.add(_V3Bottleneck(in_c, _c(e), _c(o), k, s,
                                            se, hs))
            in_c = _c(o)
        self.features.add(Conv2D(_c(last_exp), 1, use_bias=False),
                          BatchNorm(), _HSwish())
        self.features.add(GlobalAvgPool2D())
        self.output = HybridSequential()
        self.output.add(Conv2D(head_c if multiplier <= 1.0
                               else _c(head_c), 1), _HSwish(),
                        Conv2D(classes, 1), Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def mobilenet_v3_small(**kw):
    return build(MobileNetV3, "small", **kw)


def mobilenet_v3_large(**kw):
    return build(MobileNetV3, "large", **kw)


def mobilenet1_0(**kw):
    return build(MobileNet, 1.0, **kw)


def mobilenet0_75(**kw):
    return build(MobileNet, 0.75, **kw)


def mobilenet0_5(**kw):
    return build(MobileNet, 0.5, **kw)


def mobilenet0_25(**kw):
    return build(MobileNet, 0.25, **kw)


def mobilenet_v2_1_0(**kw):
    """The slice's training model: 34 fused pointwise pairs a step."""
    return build(MobileNetV2, 1.0, **kw)


def mobilenet_v2_0_75(**kw):
    return build(MobileNetV2, 0.75, **kw)


def mobilenet_v2_0_5(**kw):
    return build(MobileNetV2, 0.5, **kw)


def mobilenet_v2_0_25(**kw):
    return build(MobileNetV2, 0.25, **kw)
