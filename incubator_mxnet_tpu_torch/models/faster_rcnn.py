"""Faster R-CNN two-stage detector of the PyTorch port (counterpart of
incubator_mxnet_tpu/models/faster_rcnn.py; bench.py's config 3b).

backbone -> RPN -> `_contrib_Proposal` (NMS by the `ops.nms` kernel on
the card) -> `_contrib_ProposalTarget` while training -> ROIAlign ->
class and box heads.  Every stage has a fixed shape (padded proposals
carry -1 rows and zero-weight targets), so a hybridized training step is
one captured program.  The selection ops take no gradient, as in the
JAX package: the RPN's convolutions get none from the head loss, and
the Trainer updates them with a zero gradient, as the JAX Trainer does.

`faster_rcnn_resnet50_v1b` is the headline: resnet50_v1b's stem and
stages 1-3 as the shared features (stride 16, 1024 channels), stage 4
and global average pooling as the per-roi top on 14 x 14 ROIAlign
output.  Its pointwise convolution + BatchNorm pairs run through the
`ops.conv_stats` kernel while training: 27 in the features, 6 in the top
(stage 4's stride-2 projection is not pointwise).  The parameter names
are the JAX package's (`features.4.0.body.0.weight`,
`top.0.2.body.7.gamma`, `cls_head.weight`, ...).
"""
from __future__ import annotations

import math

from ..gluon import nn
from ..gluon.block import HybridBlock, _nd_call
from ..gluon.loss import SoftmaxCrossEntropyLoss
from ..ops import contrib as _contrib
from ..ops import nn as _ops
from ..ops import rcnn as _rcnn

__all__ = ["FasterRCNN", "faster_rcnn_toy", "faster_rcnn_resnet50_v1b",
           "rcnn_training_targets", "RCNNTrainLoss"]


def _conv_block(channels, stride=1, device=None, dtype="float32"):
    kw = dict(device=device, dtype=dtype)
    blk = nn.HybridSequential()
    blk.add(nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                      **kw))
    blk.add(nn.BatchNorm(in_channels=channels, **kw))
    blk.add(nn.Activation("relu"))
    return blk


class FasterRCNN(HybridBlock):
    """Two-stage detector.

    forward(x, im_info) -> (cls_pred (R, classes + 1), box_pred (R, 4 *
    (classes + 1)), rois (R, 5), rpn_cls (B, 2A, H, W), rpn_box (B, 4A,
    H, W)), R = B * rpn_post_nms_top_n.

    forward(x, im_info, gt_boxes, batch_rois) runs ProposalTarget
    between Proposal and ROIAlign, so the heads' rows align with the
    sampled rois -> (cls_pred, box_pred, rois, labels, bbox_targets,
    bbox_weights, rpn_cls, rpn_box), R = batch_rois."""

    def __init__(self, classes, backbone_channels=(16, 32, 64),
                 feature_stride=8, rpn_channels=64,
                 anchor_scales=(2, 4), anchor_ratios=(0.5, 1, 2),
                 rpn_pre_nms_top_n=256, rpn_post_nms_top_n=64,
                 rpn_min_size=4, roi_size=7, top_units=128,
                 features=None, top_features=None, device=None,
                 dtype="float32"):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self._classes = classes
        self._stride = feature_stride
        self._scales = anchor_scales
        self._ratios = anchor_ratios
        self._pre = rpn_pre_nms_top_n
        self._post = rpn_post_nms_top_n
        self._min_size = rpn_min_size
        self._roi = roi_size
        num_anchors = len(anchor_scales) * len(anchor_ratios)
        if features is not None:
            self.features = features
        else:
            # toy backbone: a strided conv stack (stride = 2 ** n_down)
            n_down = int(math.log2(feature_stride))
            self.features = nn.HybridSequential()
            for i, ch in enumerate(backbone_channels):
                self.features.add(_conv_block(ch, 2 if i < n_down else 1,
                                              **kw))
        self.rpn_conv = nn.Conv2D(rpn_channels, kernel_size=3, padding=1,
                                  activation="relu", **kw)
        self.rpn_cls = nn.Conv2D(2 * num_anchors, kernel_size=1, **kw)
        self.rpn_box = nn.Conv2D(4 * num_anchors, kernel_size=1, **kw)
        # a conv top (resnet stage 4 + global pooling) takes the pooled
        # rois as maps; the default dense top takes them flattened
        self._conv_top = top_features is not None
        if self._conv_top:
            self.top = top_features
        else:
            self.top = nn.HybridSequential()
            self.top.add(nn.Dense(top_units, activation="relu", **kw),
                         nn.Dense(top_units, activation="relu", **kw))
        self.cls_head = nn.Dense(classes + 1, **kw)
        self.box_head = nn.Dense(4 * (classes + 1), **kw)

    def rpn(self, feat):
        """(rpn_cls, rpn_box) of the shared features."""
        r = self.rpn_conv(feat)
        return self.rpn_cls(r), self.rpn_box(r)

    def proposals(self, rpn_cls, rpn_box, im_info):
        """Proposal over the RPN's softmaxed {bg, fg} scores (no
        gradient), (B * rpn_post_nms_top_n, 5) rois."""
        B, twoA = rpn_cls.shape[0], rpn_cls.shape[1]
        prob = _ops.softmax(rpn_cls.detach().reshape(B, 2, -1), axis=1)
        return _rcnn.proposal(
            prob.reshape(rpn_cls.shape), rpn_box.detach(), im_info,
            rpn_pre_nms_top_n=self._pre, rpn_post_nms_top_n=self._post,
            rpn_min_size=self._min_size, scales=self._scales,
            ratios=self._ratios, feature_stride=self._stride)

    def head(self, feat, rois):
        """(cls_pred, box_pred) of the rois on the shared features."""
        pooled = _contrib.roi_align(feat, rois.detach(),
                                    pooled_size=(self._roi, self._roi),
                                    spatial_scale=1.0 / self._stride)
        if self._conv_top:
            top = self.top(pooled)
            top = top.reshape(top.shape[0], -1)
        else:
            top = self.top(pooled.reshape(pooled.shape[0], -1))
        return self.cls_head(top), self.box_head(top)

    def forward(self, x, im_info, gt_boxes=None, batch_rois=None,
                num_classes=None):
        feat = self.features(x)
        rpn_cls, rpn_box = self.rpn(feat)
        rois = self.proposals(rpn_cls, rpn_box, im_info)
        target = None
        if gt_boxes is not None:
            target = _rcnn.proposal_target(
                rois, gt_boxes, num_classes=(num_classes or self._classes)
                + 1, batch_images=x.shape[0],
                batch_rois=batch_rois or self._post)
            rois = target[0]
        cls_pred, box_pred = self.head(feat, rois)
        if target is not None:
            _, labels, bbox_targets, bbox_weights = target
            return (cls_pred, box_pred, rois, labels, bbox_targets,
                    bbox_weights, rpn_cls, rpn_box)
        return cls_pred, box_pred, rois, rpn_cls, rpn_box


def rcnn_training_targets(rois, gt_boxes, num_classes, batch_rois=64,
                          fg_fraction=0.25, fg_overlap=0.5):
    """ROI sampling and the box head's targets (ref: proposal_target.cc
    as example/rcnn train_end2end uses it): tensors or NDArrays in, the
    same out."""
    def run(rois, gt_boxes):
        return _rcnn.proposal_target(
            rois, gt_boxes, num_classes=num_classes + 1,
            batch_images=int(gt_boxes.shape[0]), batch_rois=batch_rois,
            fg_fraction=fg_fraction, fg_overlap=fg_overlap)
    out = _nd_call(run, (rois, gt_boxes), {})
    return run(rois, gt_boxes) if out is None else out


def faster_rcnn_resnet50_v1b(classes=20, device=None, dtype="float32",
                             **kwargs):
    """bench.py config 3b: Faster R-CNN on resnet50_v1b (ref: example/rcnn
    resnet symbol: conv1-conv4 the shared feature, conv5 the per-roi
    head; GluonCV faster_rcnn_resnet50_v1b).  Proposals are the top 2000
    anchors' greedy NMS down to 1000 per image; ROIAlign at 14 x 14,
    which stage 4's stride 2 takes to 7 x 7, pooled to 2048 per roi."""
    from ..gluon.model_zoo.vision import resnet50_v1b
    base = resnet50_v1b(device=device, dtype=dtype)
    features = nn.HybridSequential()
    for i in range(7):          # stem (conv, bn, relu, pool) + stages 1-3
        features.add(base.features[i])
    top = nn.HybridSequential()
    top.add(base.features[7])   # stage 4
    top.add(nn.GlobalAvgPool2D())
    kwargs.setdefault("rpn_pre_nms_top_n", 2000)
    kwargs.setdefault("rpn_post_nms_top_n", 1000)
    return FasterRCNN(classes, features=features, top_features=top,
                      feature_stride=16, rpn_channels=512,
                      anchor_scales=(8, 16, 32), anchor_ratios=(0.5, 1, 2),
                      rpn_min_size=16, roi_size=14, device=device,
                      dtype=dtype, **kwargs)


def faster_rcnn_toy(classes=3, **kwargs):
    """Tiny config for tests and smoke training (64 x 64 images)."""
    return FasterRCNN(classes, backbone_channels=(8, 16),
                      feature_stride=4, rpn_channels=16,
                      anchor_scales=(2, 4), anchor_ratios=(0.5, 1, 2),
                      rpn_pre_nms_top_n=64, rpn_post_nms_top_n=16,
                      rpn_min_size=2, roi_size=3, top_units=32, **kwargs)


class RCNNTrainLoss(HybridBlock):
    """Faster R-CNN head loss: softmax-CE over the sampled rois (padding
    rows, label -1, masked out) + smooth-L1 on the weighted box targets,
    one block, so that hybridized it is one captured program.
    forward(cls_pred, box_pred, labels, bbox_targets, bbox_weights) ->
    scalar loss."""

    def __init__(self, box_weight=0.1):
        super().__init__()
        self._box_w = box_weight
        self._ce = SoftmaxCrossEntropyLoss()

    def forward(self, cls_pred, box_pred, labels, targets, weights):
        mask = (labels >= 0).to(labels.dtype)
        safe = labels.clamp(0.0, 1e9)
        cls_l = (self._ce(cls_pred, safe) * mask).mean()
        box_l = _ops.smooth_l1((box_pred - targets) * weights,
                               scalar=1.0).sum(dim=1).mean()
        return cls_l + self._box_w * box_l
