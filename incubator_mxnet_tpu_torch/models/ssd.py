"""SSD single-shot detector of the PyTorch port (counterpart of
incubator_mxnet_tpu/models/ssd.py; bench.py's config 3a).

The structure and the parameter names are the JAX package's
(`features.stage1.0.0.weight`, `features.norm_scale`, `cls_preds.3.bias`,
...), so `weights.load_reference_params` carries a JAX net's parameters
over by name.  `ssd_512_vgg16` is the headline: VGG16 with the
reduced/atrous fc6 (a 3x3 convolution of dilation 6) and fc7, and the
conv8..conv12 extra stages, seven feature maps for a 512 x 512 image;
`ssd_toy`, `ssd_300` and `ssd_512` keep the small stacked extractor.

Every shape is static: the anchors come from the feature maps' shapes
(`MultiBoxPrior`), the targets from `MultiBoxTarget`'s fixed-shape
matching, and detection is `MultiBoxDetection`, whose greedy NMS is the
`ops.nms` kernel on the card, so net and loss each capture into one
program when hybridized.  `SSDTrainLoss` is `MultiBoxTarget` +
softmax-CE + smooth-L1 as a `forward` over the port's tensor ops, where
the JAX block has `hybrid_forward(F, ...)` over `nd` ops (a form the
port's `HybridBlock` runs too).  Every block takes
`device` and `dtype`, as the ResNet blocks do.
"""
from __future__ import annotations

import torch

from ..gluon import nn
from ..gluon.block import HybridBlock, _nd_call, new_parameter
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..initializer import Constant
from ..ops import contrib as _contrib
from ..ops import nn as _ops
from ..ops.tensor import l2_normalization

__all__ = ["SSD", "ssd_300", "ssd_512", "ssd_512_vgg16", "ssd_toy",
           "VGG16ReducedFeatures", "ssd_training_targets", "SSDTrainLoss"]


def _down_block(channels, kw):
    blk = nn.HybridSequential()
    for _ in range(2):
        blk.add(nn.Conv2D(channels, kernel_size=3, padding=1, **kw))
        blk.add(nn.BatchNorm(in_channels=channels, **kw))
        blk.add(nn.Activation("relu"))
    blk.add(nn.MaxPool2D(pool_size=2))
    return blk


class _StackedFeatures(HybridBlock):
    """The small multi-scale extractor (tests, smokes): conv-BN-relu
    down-blocks, one feature map per block."""

    def __init__(self, base_channels, device=None, dtype="float32"):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.blocks = nn.HybridSequential()
        for ch in base_channels:
            self.blocks.add(_down_block(ch, kw))

    def forward(self, x):
        feats = []
        for blk in self.blocks:
            x = blk(x)
            feats.append(x)
        return feats


def _vgg_stage(num, channels, kw):
    blk = nn.HybridSequential()
    for _ in range(num):
        blk.add(nn.Conv2D(channels, kernel_size=3, padding=1,
                          activation="relu", **kw))
    return blk


class VGG16ReducedFeatures(HybridBlock):
    """VGG16-reduced-atrous SSD feature extractor (ref:
    example/ssd/symbol/symbol_vgg16_reduced.py): conv1_1..conv4_3, then
    conv5, a 3x3 stride-1 pool5, the atrous fc6 (3x3, dilation 6) and
    fc7 (1x1), then conv8..conv12.  Seven feature maps for a 512 x 512
    input (64, 32, 16, 8, 4, 2, 1).  conv4_3's head branch is
    channel-L2-normalized with a learned per-channel scale
    (`norm_scale`, init 20); the un-normalized map feeds stage 2."""

    def __init__(self, device=None, dtype="float32"):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.stage1 = nn.HybridSequential()     # -> conv4_3 (stride 8)
        self.stage1.add(_vgg_stage(2, 64, kw), nn.MaxPool2D(pool_size=2),
                        _vgg_stage(2, 128, kw), nn.MaxPool2D(pool_size=2),
                        _vgg_stage(3, 256, kw), nn.MaxPool2D(pool_size=2),
                        _vgg_stage(3, 512, kw))
        self.stage2 = nn.HybridSequential()     # -> fc7 (stride 16)
        self.stage2.add(nn.MaxPool2D(pool_size=2), _vgg_stage(3, 512, kw))
        self.stage2.add(nn.MaxPool2D(pool_size=3, strides=1, padding=1))
        self.stage2.add(nn.Conv2D(1024, kernel_size=3, padding=6,
                                  dilation=6, activation="relu", **kw))
        self.stage2.add(nn.Conv2D(1024, kernel_size=1, activation="relu",
                                  **kw))
        self.extras = nn.HybridSequential()
        for squeeze, out, kernel, stride, pad in (
                (256, 512, 3, 2, 1),        # conv8  -> 16
                (128, 256, 3, 2, 1),        # conv9  -> 8
                (128, 256, 3, 2, 1),        # conv10 -> 4
                (128, 256, 3, 2, 1),        # conv11 -> 2
                (128, 256, 4, 1, 1)):       # conv12 -> 1
            blk = nn.HybridSequential()
            blk.add(nn.Conv2D(squeeze, kernel_size=1, activation="relu",
                              **kw),
                    nn.Conv2D(out, kernel_size=kernel, strides=stride,
                              padding=pad, activation="relu", **kw))
            self.extras.add(blk)
        self.norm_scale = new_parameter("norm_scale", (1, 512, 1, 1),
                                        Constant(20.0), device, dtype)

    def forward(self, x):
        c43 = self.stage1(x)
        feats = [l2_normalization(c43, mode="channel") * self.norm_scale]
        f = self.stage2(c43)
        feats.append(f)
        for blk in self.extras:
            f = blk(f)
            feats.append(f)
        return feats


class SSD(HybridBlock):
    """Multi-scale one-shot detector.  `features` maps the image to a
    list of feature maps (one per anchor scale); `base_channels` builds
    the small stacked extractor instead.  forward(x) -> (anchors (1, N,
    4), cls_preds (B, N, classes + 1), box_preds (B, N * 4)), what
    MultiBoxTarget and MultiBoxDetection take."""

    def __init__(self, classes, base_channels=None, features=None,
                 sizes=((0.2, 0.272), (0.37, 0.447), (0.54, 0.619)),
                 ratios=((1, 2, 0.5),) * 3, device=None, dtype="float32"):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        if features is None:
            if base_channels is None:
                raise ValueError(
                    "SSD: pass either features= (a block returning a "
                    "list of feature maps) or base_channels= (toy "
                    "stacked extractor)")
            assert len(base_channels) == len(sizes)
            features = _StackedFeatures(base_channels, **kw)
        assert len(sizes) == len(ratios)
        self._classes = classes
        self._sizes = sizes
        self._ratios = ratios
        self.features = features
        self.cls_preds = nn.HybridSequential()
        self.box_preds = nn.HybridSequential()
        for i in range(len(sizes)):
            a = len(sizes[i]) + len(ratios[i]) - 1
            self.cls_preds.add(nn.Conv2D(a * (classes + 1), kernel_size=3,
                                         padding=1, **kw))
            self.box_preds.add(nn.Conv2D(a * 4, kernel_size=3, padding=1,
                                         **kw))

    def forward(self, x):
        B = x.shape[0]
        anchors, cls_outs, box_outs = [], [], []
        for i, feat in enumerate(self.features(x)):
            anchors.append(_contrib.multibox_prior(
                feat, sizes=self._sizes[i], ratios=self._ratios[i]))
            c = self.cls_preds[i](feat)
            cls_outs.append(c.permute(0, 2, 3, 1).reshape(
                B, -1, self._classes + 1))
            b = self.box_preds[i](feat)
            box_outs.append(b.permute(0, 2, 3, 1).reshape(B, -1))
        # in the promoted dtype: conv4_3's scaled map is f32 beside bf16
        # maps, as in the JAX package
        return (torch.cat(anchors, dim=1), torch.cat(cls_outs, dim=1),
                torch.cat(box_outs, dim=1))


def ssd_training_targets(anchors, cls_preds, labels):
    """MultiBoxTarget front (ref: example/ssd training_targets): tensors
    or NDArrays in, the same out."""
    def run(anchors, cls_preds, labels):
        return _contrib.multibox_target(anchors, labels,
                                        cls_preds.detach().transpose(1, 2))
    out = _nd_call(run, (anchors, cls_preds, labels), {})
    return run(anchors, cls_preds, labels) if out is None else out


def ssd_toy(classes=1, **kwargs):
    """Small config for tests and smokes (32 x 32 inputs)."""
    return SSD(classes, base_channels=(8, 16), sizes=((0.2, 0.3),
                                                      (0.5, 0.6)),
               ratios=((1, 2, 0.5),) * 2, **kwargs)


def ssd_300(classes=20, **kwargs):
    return SSD(classes, base_channels=(32, 64, 128, 128),
               sizes=((0.1, 0.141), (0.2, 0.272), (0.37, 0.447),
                      (0.54, 0.619)),
               ratios=((1, 2, 0.5),) * 4, **kwargs)


def ssd_512(classes=20, **kwargs):
    """Small-convnet 512 x 512 config (a smoke model; the config-3a
    headline is `ssd_512_vgg16`)."""
    return SSD(classes, base_channels=(32, 64, 128, 128, 256),
               sizes=((0.07, 0.1), (0.15, 0.222), (0.3, 0.367),
                      (0.45, 0.519), (0.6, 0.671)),
               ratios=((1, 2, 0.5),) * 5, **kwargs)


def ssd_512_vgg16(classes=20, device=None, dtype="float32"):
    """bench.py config 3a: SSD-512 on VGG16-reduced-atrous (ref:
    example/ssd symbol_vgg16_reduced.py; GluonCV ssd_512_vgg16_atrous
    sizes and ratios, normalized to [0, 1]); 24,564 anchors."""
    sizes = ((0.07, 0.1025), (0.15, 0.2121), (0.3, 0.3674),
             (0.45, 0.5196), (0.6, 0.6708), (0.75, 0.8216),
             (0.9, 0.9721))
    ratios = ((1, 2, 0.5),) + ((1, 2, 0.5, 3, 1.0 / 3),) * 4 \
        + ((1, 2, 0.5),) * 2
    return SSD(classes, features=VGG16ReducedFeatures(device=device,
                                                      dtype=dtype),
               sizes=sizes, ratios=ratios, device=device, dtype=dtype)


class SSDTrainLoss(HybridBlock):
    """SSD training loss: MultiBoxTarget + softmax-CE over every anchor +
    smooth-L1 on the matched boxes, one block, so that hybridized it is
    one captured program.  forward(anchors, cls_preds, box_preds,
    labels) -> scalar loss."""

    def __init__(self, box_weight=1.0):
        super().__init__()
        self._box_w = box_weight
        self._ce = SoftmaxCrossEntropyLoss()

    def forward(self, anchors, cls_preds, box_preds, labels):
        loc_t, loc_m, cls_t = _contrib.multibox_target(
            anchors.detach(), labels, cls_preds.detach().transpose(1, 2))
        C = cls_preds.shape[-1]
        ce = self._ce(cls_preds.reshape(-1, C), cls_t.reshape(-1)).mean()
        box_l = (_ops.smooth_l1(box_preds - loc_t) * loc_m).mean()
        return ce + self._box_w * box_l
