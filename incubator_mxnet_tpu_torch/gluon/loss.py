"""Gluon losses of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/loss.py): `L2Loss`, `L1Loss`,
`SigmoidBinaryCrossEntropyLoss` (alias `SigmoidBCELoss`, with
`pos_weight`), `SoftmaxCrossEntropyLoss` (alias `SoftmaxCELoss`),
`KLDivLoss`, `HuberLoss`, `HingeLoss`, `SquaredHingeLoss`,
`LogisticLoss` (`label_format` "signed" or "binary"), `TripletLoss`,
`CosineEmbeddingLoss` and `CTCLoss` (over the `CTCLoss` op, the blank
last), each with the JAX class's arguments, defaults and formula,
written as a `forward` on tensors.

A loss returns one value per example: the mean over every axis but
`batch_axis` (`TripletLoss` and `CosineEmbeddingLoss` reduce their own
axes, as there).  `sample_weight` multiplies the elementwise loss
(broadcast), then `weight`.
"""
from __future__ import annotations

import torch

from ..ops import nn as ops
from ..ops.tensor import norm as _norm
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CosineEmbeddingLoss", "CTCLoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _mean_exclude(loss, batch_axis):
    """Mean over every axis but `batch_axis`."""
    ax = batch_axis % loss.ndim
    dims = [d for d in range(loss.ndim) if d != ax]
    return loss.mean(dim=dims) if dims else loss


def _sum_exclude(loss, batch_axis):
    """Sum over every axis but `batch_axis`."""
    ax = batch_axis % loss.ndim
    dims = [d for d in range(loss.ndim) if d != ax]
    return loss.sum(dim=dims) if dims else loss


def _softrelu(x):
    return ops.activation(x, act_type="softrelu")


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (
            type(self).__name__, self._batch_axis, self._weight)

    def _reduce(self, loss, sample_weight, weight=None):
        loss = _apply_weighting(loss, self._weight if weight is None
                                else weight, sample_weight)
        return _mean_exclude(loss, self._batch_axis)


class L2Loss(Loss):
    """ref: gluon.loss.L2Loss: weight / 2 (label - pred)^2."""

    def __init__(self, weight=1.0, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        return self._reduce(loss, sample_weight, self._weight / 2)


class L1Loss(Loss):
    """ref: gluon.loss.L1Loss: |label - pred|."""

    def __init__(self, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        return self._reduce(loss, sample_weight)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """ref: gluon.loss.SigmoidBinaryCrossEntropyLoss: on logits, the
    stable relu(x) - x z + softrelu(-|x|) (with `pos_weight`, x - x z +
    (1 + (pos_weight - 1) z) (softrelu(-|x|) + relu(-x))); with
    `from_sigmoid`, -(log(p + 1e-12) z + log(1 - p + 1e-12) (1 - z)),
    `pos_weight` scaling the first term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label \
                    + _softrelu(-torch.abs(pred))
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    _softrelu(-torch.abs(pred)) + torch.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1. - pred + eps) * (1. - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1. - pred + eps) * (1. - label))
        return self._reduce(loss, sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """ref: gluon.loss.SoftmaxCrossEntropyLoss.  With sparse labels on
    logits it takes the fused path (`ops.nn.fused_softmax_ce`, whose
    backward rebuilds the softmax from a per-row lse); otherwise it is
    log_softmax and a pick or a dense dot with the labels."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        ax = self._axis % pred.ndim
        if self._sparse_label and not self._from_logits:
            loss = ops.fused_softmax_ce(pred, label, axis=ax).unsqueeze(ax)
        else:
            if not self._from_logits:
                pred = ops.log_softmax(pred, axis=ax)
            if self._sparse_label:
                idx = label.long().clamp(0, pred.shape[ax] - 1).unsqueeze(ax)
                loss = -pred.gather(ax, idx)
            else:
                loss = -(pred * label.reshape(pred.shape)).sum(
                    dim=ax, keepdim=True)
        return self._reduce(loss, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """ref: gluon.loss.KLDivLoss: label (log(label + 1e-12) - pred), pred
    taken through log_softmax over `axis` unless `from_logits`."""

    def __init__(self, from_logits=True, axis=-1, weight=None,
                 batch_axis=0):
        super().__init__(weight, batch_axis)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = ops.log_softmax(pred, axis=self._axis % pred.ndim)
        loss = label * (torch.log(label + 1e-12) - pred)
        return self._reduce(loss, sample_weight)


class HuberLoss(Loss):
    """ref: gluon.loss.HuberLoss: |d| - rho / 2 where |d| > rho, else
    d^2 / (2 rho), d = label - pred."""

    def __init__(self, rho=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        return self._reduce(loss, sample_weight)


class HingeLoss(Loss):
    """ref: gluon.loss.HingeLoss: relu(margin - pred label)."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * label.reshape(pred.shape))
        return self._reduce(loss, sample_weight)


class SquaredHingeLoss(Loss):
    """ref: gluon.loss.SquaredHingeLoss: relu(margin - pred label)^2."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(torch.relu(
            self._margin - pred * label.reshape(pred.shape)))
        return self._reduce(loss, sample_weight)


class LogisticLoss(Loss):
    """ref: gluon.loss.LogisticLoss: the sigmoid cross-entropy on logits,
    with labels in {-1, 1} ("signed", mapped to {0, 1}) or {0, 1}
    ("binary")."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed"):
        super().__init__(weight, batch_axis)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label \
            + _softrelu(-torch.abs(pred))
        return self._reduce(loss, sample_weight)


class TripletLoss(Loss):
    """ref: gluon.loss.TripletLoss: relu(sum over all but `batch_axis` of
    (positive - pred)^2 - (negative - pred)^2, + margin)."""

    def __init__(self, margin=1, weight=None, batch_axis=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = positive.reshape(pred.shape)
        negative = negative.reshape(pred.shape)
        loss = _sum_exclude(torch.square(positive - pred)
                            - torch.square(negative - pred),
                            self._batch_axis)
        loss = torch.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    """ref: gluon.loss.CosineEmbeddingLoss: with cos the cosine of the
    flattened inputs (1e-12 added to the norms' product), 1 - cos where
    label is 1, else relu(cos - margin)."""

    def __init__(self, weight=None, batch_axis=0, margin=0):
        super().__init__(weight, batch_axis)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape((input1.shape[0], -1))
        input2 = input2.reshape((input2.shape[0], -1))
        cos = torch.sum(input1 * input2, dim=-1) / (
            _norm(input1, axis=-1) * _norm(input2, axis=-1) + 1e-12)
        label = label.reshape((-1,))
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class CTCLoss(Loss):
    """ref: gluon.loss.CTCLoss: the CTC loss per example of pred
    activations ("NTC" or "TNC") and labels ("NT" or "TN") whose blank is
    the last class; `pred_lengths` and `label_lengths` bound each
    example's steps and label."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None):
        super().__init__(weight, label_layout.find("N"))
        self._layout = layout

    def forward(self, pred, label, pred_lengths=None, label_lengths=None,
                sample_weight=None):
        if self._layout == "NTC":
            pred = pred.transpose(0, 1)
        if self._batch_axis == 1:
            label = label.transpose(0, 1)
        loss = ops.ctc_loss(pred, label, pred_lengths, label_lengths,
                            use_data_lengths=pred_lengths is not None,
                            use_label_lengths=label_lengths is not None,
                            blank_label="last")
        return _apply_weighting(loss, self._weight, sample_weight)
