"""Region-proposal operators of the PyTorch port (counterpart of
incubator_mxnet_tpu/ops/rcnn.py; ref: src/operator/contrib/{proposal.cc,
multi_proposal.cc, proposal_target.cc}): RPN proposals and the sampling
of training rois for Faster R-CNN.

Every output has a fixed shape (padded rois carry -1, padded labels -1,
their targets and weights 0), and nothing reads a device value on the
host, so a hybridized Faster R-CNN step captures Proposal and
ProposalTarget into its program.  The greedy NMS of `_nms_keep` is
`ops.nms`' hand-written kernel on the card; the JAX package's blocked
fixpoint reaches the same greedy result.  The pre-NMS top-k, the NMS
order and ProposalTarget's fg/bg picks sort stably, so equal scores (bf16
RPN scores tie often) keep the lower index first, as `lax.top_k` and
`jnp.argsort` do.  The base anchors, which the JAX package makes with
numpy, are made on the device once per (device, parameters).
"""
from __future__ import annotations

import numpy as np
import torch

from . import nms as _nms
from .contrib import _const
from .registry import register, alias

__all__ = ["proposal", "proposal_target"]


def _make_anchors(base_size, scales, ratios):
    """The base anchors (A, 4), numpy f32 (ref: proposal.cc
    GenerateAnchors)."""
    base = np.array([1, 1, base_size, base_size], np.float32) - 1
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    anchors = []
    for r in ratios:
        size = w * h
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            wss, hss = ws * s, hs * s
            anchors.append([cx - 0.5 * (wss - 1), cy - 0.5 * (hss - 1),
                            cx + 0.5 * (wss - 1), cy + 0.5 * (hss - 1)])
    return np.array(anchors, np.float32)


def _bbox_transform_inv(boxes, deltas):
    """Regression deltas applied to boxes (ref: bbox_transform_inv)."""
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * (w - 1.0)
    cy = boxes[..., 1] + 0.5 * (h - 1.0)
    dx, dy, dw, dh = (deltas[..., 0], deltas[..., 1], deltas[..., 2],
                      deltas[..., 3])
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw.clamp(-10.0, 10.0)) * w
    ph = torch.exp(dh.clamp(-10.0, 10.0)) * h
    return torch.stack([pcx - 0.5 * (pw - 1.0), pcy - 0.5 * (ph - 1.0),
                        pcx + 0.5 * (pw - 1.0), pcy + 0.5 * (ph - 1.0)],
                       dim=-1)


def _stable_topk(x, k):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equals (`lax.top_k`)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _nms_keep(boxes, scores, thresh, topk):
    """Greedy NMS of (B, n, 4) boxes by their (B, n) scores, +1 IoU
    convention: (order, keep) with order (B, n) the stable descending
    score order and keep (B, topk) the first `topk` kept positions in
    that order, -1 padded."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    b = torch.gather(boxes, 1, order[..., None].expand(boxes.shape))
    keep = _nms.nms_sorted(b.float(), None, thresh, plus_one=True,
                           topk=topk, positions_only=True)
    return order, keep


@register("_contrib_Proposal",
          ndarray_inputs=("cls_prob", "bbox_pred", "im_info"),
          differentiable=False, jit=True)
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """RPN proposals (ref: proposal.cc).  cls_prob (N, 2A, H, W), its
    second half the foreground scores; bbox_pred (N, 4A, H, W); im_info
    (N, 3) = (height, width, scale).  (N * post, 5) rois [batch_idx, x1,
    y1, x2, y2], -1 rows past an image's kept set; with `output_score`
    also their (N * post, 1) scores."""
    N, twoA, H, W = cls_prob.shape
    A = twoA // 2
    dev = cls_prob.device
    post = rpn_post_nms_top_n
    anchors = _const(_make_anchors(feature_stride, scales, ratios).tolist(),
                     dev)
    shift_x = torch.arange(W, dtype=torch.float32, device=dev) \
        * feature_stride
    shift_y = torch.arange(H, dtype=torch.float32, device=dev) \
        * feature_stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    shifts = torch.stack([sx.reshape(-1), sy.reshape(-1), sx.reshape(-1),
                          sy.reshape(-1)], dim=1)             # (HW, 4)
    all_anchors = (anchors[None] + shifts[:, None]).reshape(-1, 4)
    # (N, H*W*A) foreground scores and (N, H*W*A, 4) deltas
    fg = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(N, -1)
    dl = bbox_pred.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2) \
        .reshape(N, -1, 4)
    props = _bbox_transform_inv(all_anchors, dl)
    im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]
    zero = torch.zeros((), dtype=props.dtype, device=dev)
    props = torch.stack([
        torch.minimum(torch.maximum(props[..., 0], zero), im_w - 1.0),
        torch.minimum(torch.maximum(props[..., 1], zero), im_h - 1.0),
        torch.minimum(torch.maximum(props[..., 2], zero), im_w - 1.0),
        torch.minimum(torch.maximum(props[..., 3], zero), im_h - 1.0)],
        dim=-1)
    ws = props[..., 2] - props[..., 0] + 1
    hs = props[..., 3] - props[..., 1] + 1
    min_size = rpn_min_size * im_info[:, 2:3]
    valid = (ws >= min_size) & (hs >= min_size)
    fg = torch.where(valid, fg, torch.full_like(fg, -1e10))
    k = min(rpn_pre_nms_top_n, fg.shape[1])
    top_scores, top_idx = _stable_topk(fg, k)
    top_boxes = torch.gather(props, 1, top_idx[..., None].expand(N, k, 4))
    order, keep = _nms_keep(top_boxes, top_scores, threshold, post)
    sorted_boxes = torch.gather(top_boxes, 1,
                                order[..., None].expand(N, k, 4))
    sorted_scores = torch.gather(top_scores, 1, order)
    sel = keep.clamp(0, k - 1)
    sel_scores = torch.gather(sorted_scores, 1, sel)
    # min-size-filtered anchors carry the -1e10 sentinel: when fewer
    # valid proposals survive than `post`, they become -1 padding
    ok = (keep >= 0) & (sel_scores > -1e9)
    sel_boxes = torch.gather(sorted_boxes, 1, sel[..., None].expand(N, post,
                                                                    4))
    boxes_out = torch.where(ok[..., None], sel_boxes,
                            torch.full_like(sel_boxes, -1.0))
    batch_idx = torch.arange(N, dtype=boxes_out.dtype, device=dev)[
        :, None, None].expand(N, post, 1)
    rois = torch.cat([batch_idx, boxes_out], dim=-1).reshape(N * post, 5)
    if output_score:
        scores_out = torch.where(ok, sel_scores,
                                 torch.full_like(sel_scores, -1.0))
        return rois, scores_out.reshape(-1, 1)
    return rois


alias("_contrib_Proposal", "_contrib_MultiProposal")


@register("_contrib_ProposalTarget",
          ndarray_inputs=("rois", "gt_boxes"),
          differentiable=False, num_outputs=4, jit=True)
def proposal_target(rois, gt_boxes, num_classes=21, batch_images=1,
                    batch_rois=128, fg_fraction=0.25, fg_overlap=0.5,
                    box_stds=(0.1, 0.1, 0.2, 0.2)):
    """Sample rois into training batches (ref: proposal_target.cc).  rois
    (R, 5), gt_boxes (N, G, 5) [x1, y1, x2, y2, cls], cls < 0 padding.
    Per image, its rois and its valid gt boxes (appended as candidates)
    are matched to the gt by IoU (+1 convention); the `per_img *
    fg_fraction` best at IoU >= fg_overlap are foreground, the rest of
    `per_img` the best background.  Outputs, B = N * per_img rows,
    per_img = batch_rois // batch_images: rois (B, 5), labels (B,)
    (class + 1, 0 background, -1 padding), bbox_targets and bbox_weights
    (B, 4 * num_classes), the class's four slots filled for
    foreground."""
    N, G, _ = gt_boxes.shape
    per_img = batch_rois // max(batch_images, 1)
    fg_per_img = int(round(per_img * fg_fraction))
    dev = rois.device
    R = rois.shape[0]
    out = []
    for i in range(N):
        gt = gt_boxes[i]
        gt_valid = gt[:, 4] >= 0
        gt_as_rois = torch.cat([torch.full((G, 1), i, dtype=rois.dtype,
                                           device=dev),
                                gt[:, :4].to(rois.dtype)], dim=1)
        cand = torch.cat([rois, gt_as_rois], dim=0)
        mask = (cand[:, 0] == i) & torch.cat(
            [torch.ones(R, dtype=torch.bool, device=dev), gt_valid])
        iou = _nms.iou_plus_one(cand[:, 1:5], gt[:, :4])
        iou = torch.where(gt_valid[None, :], iou, torch.zeros_like(iou))
        max_iou = iou.amax(dim=1)
        gt_assign = torch.argmax(iou, dim=1)
        max_iou = torch.where(mask, max_iou, torch.full_like(max_iou, -1.0))
        is_fg = max_iou >= fg_overlap
        fg_score = torch.where(is_fg, max_iou,
                               torch.full_like(max_iou, -1e10))
        fg_vals, fg_idx = _stable_topk(fg_score, fg_per_img)
        fg_ok = fg_vals > -1e9
        bg_score = torch.where(mask & ~is_fg, max_iou,
                               torch.full_like(max_iou, -1e10))
        bg_vals, bg_idx = _stable_topk(bg_score, per_img - fg_per_img)
        bg_ok = bg_vals > -1e9
        sel = torch.cat([fg_idx, bg_idx])
        sel_fg = torch.cat([fg_ok, torch.zeros_like(bg_ok)])
        sel_ok = torch.cat([fg_ok, bg_ok])
        r = cand[sel]
        g = gt[gt_assign[sel]]
        labels = torch.where(sel_fg, g[:, 4] + 1, torch.zeros_like(g[:, 4]))
        labels = torch.where(sel_ok, labels, torch.full_like(labels, -1.0))
        rw = r[:, 3] - r[:, 1] + 1
        rh = r[:, 4] - r[:, 2] + 1
        rcx = r[:, 1] + 0.5 * (rw - 1)
        rcy = r[:, 2] + 0.5 * (rh - 1)
        gw = g[:, 2] - g[:, 0] + 1
        gh = g[:, 3] - g[:, 1] + 1
        gcx = g[:, 0] + 0.5 * (gw - 1)
        gcy = g[:, 1] + 0.5 * (gh - 1)
        t = torch.stack([(gcx - rcx) / rw.clamp_min(1) / box_stds[0],
                         (gcy - rcy) / rh.clamp_min(1) / box_stds[1],
                         torch.log(gw.clamp_min(1) / rw.clamp_min(1))
                         / box_stds[2],
                         torch.log(gh.clamp_min(1) / rh.clamp_min(1))
                         / box_stds[3]], dim=1).to(torch.float32)
        cls = labels.clamp(0, num_classes - 1).long()
        cols = cls[:, None] * 4 + torch.arange(4, device=dev)[None, :]
        fgf = sel_fg[:, None]
        targets = torch.zeros((per_img, 4 * num_classes),
                              dtype=torch.float32, device=dev).scatter(
            1, cols, torch.where(fgf, t, torch.zeros_like(t)))
        weights = torch.zeros((per_img, 4 * num_classes),
                              dtype=torch.float32, device=dev).scatter(
            1, cols, fgf.to(torch.float32).expand(per_img, 4))
        out.append((r, labels, targets, weights))
    r, labels, targets, weights = (torch.cat(parts) for parts in zip(*out))
    return r, labels, targets, weights
