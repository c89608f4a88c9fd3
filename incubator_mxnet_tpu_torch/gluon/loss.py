"""Gluon losses of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/loss.py), limited to `SoftmaxCrossEntropyLoss`.

A loss returns one value per example: the mean over every axis but
`batch_axis`.
"""
from __future__ import annotations

import torch

from ..ops import nn as ops
from .block import HybridBlock

__all__ = ["Loss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss"]


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


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis):
        super().__init__()
        self._weight = weight
        self._batch_axis = batch_axis


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
                pred = torch.log_softmax(pred, dim=ax)
            if self._sparse_label:
                idx = label.long().clamp(0, pred.shape[ax] - 1).unsqueeze(ax)
                loss = -pred.gather(ax, idx)
            else:
                loss = -(pred * label.reshape(pred.shape)).sum(
                    dim=ax, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return _mean_exclude(loss, self._batch_axis)


SoftmaxCELoss = SoftmaxCrossEntropyLoss
