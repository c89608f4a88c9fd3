"""Contrib operators of the PyTorch port (counterpart of
incubator_mxnet_tpu/ops/contrib.py): box primitives, the MultiBox family
and `box_nms` (SSD), ROIAlign and ROIPooling (Faster R-CNN), the resize
and adaptive pooling, and the rest of that module, registered under the
JAX package's names with its metadata.

They are XLA ops in the JAX package, so plain PyTorch is their port, but
for the greedy pass of `box_nms` (and so `MultiBoxDetection`), which is
`ops.nms`' hand-written kernel on the card.  Every output has a fixed
shape: suppressed and padded entries carry -1, as in the JAX package.
Nothing here reads a device value on the host, so a hybridized block
captures these ops into one program.  Constants that the JAX package
builds with numpy (the MultiBox anchor shapes) are made on the device
once per (device, values) and reused (`_const`): a copy from host memory
inside a CUDA graph capture would fail.

Where the JAX package sorts (`jnp.argsort`, `lax.top_k`), the port sorts
stably, so equal scores keep the lower index first, as there.

`MultiBoxTarget` forces a match for every valid ground-truth box, as the
reference's multibox_target.cc does; the JAX package's scatter lets a
padding row's write undo one (ROADMAP.md, Queue 3).  `BilinearResize2D`
follows `jax.image.resize` (half-pixel centres, antialiased when it
shrinks) and, as the JAX op, ignores `align_corners`.
"""
from __future__ import annotations

import math
import threading

import numpy as np
import torch

from . import nms as _nms
from .registry import register

__all__ = ["box_iou", "box_nms", "box_encode", "box_decode",
           "bipartite_matching", "multibox_prior", "multibox_target",
           "multibox_detection", "roi_align", "roi_pooling",
           "bilinear_resize_2d", "adaptive_avg_pooling_2d", "count_sketch",
           "index_copy", "getnnz", "interleaved_matmul_selfatt_qk",
           "interleaved_matmul_selfatt_valatt"]

_CONSTS = {}
_CONSTS_LOCK = threading.Lock()


def _const(values, device, dtype=torch.float32):
    """A tensor of `values` (nested lists of Python floats) on `device`,
    made once per (values, device, dtype)."""
    key = (repr(values), str(torch.device(device)), dtype)
    with _CONSTS_LOCK:
        t = _CONSTS.get(key)
        if t is None:
            t = _CONSTS[key] = torch.tensor(values, dtype=dtype,
                                            device=device)
        return t


# ---------------------------------------------------------------------------
# box primitives
# ---------------------------------------------------------------------------

_iou_corner = _nms.iou_corner


def _center_to_corner(x):
    cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


@register("box_iou", ndarray_inputs=("lhs", "rhs"))
def box_iou(lhs, rhs, format="corner"):
    """ref: bounding_box.cc box_iou — pairwise IoU, lhs.shape[:-1] +
    rhs.shape[:-1]."""
    if format == "center":
        lhs, rhs = _center_to_corner(lhs), _center_to_corner(rhs)
    out = _iou_corner(lhs.reshape(-1, 4), rhs.reshape(-1, 4))
    return out.reshape(tuple(lhs.shape[:-1]) + tuple(rhs.shape[:-1]))


@register("box_nms", ndarray_inputs=("data",), differentiable=False,
          jit=True)
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """ref: bounding_box.cc box_nms.  data (..., N, K); the output has its
    shape, with the score of every suppressed or invalid box set to -1.
    The boxes are ranked by score (invalid ones last), the first `topk`
    ranks take part (all for topk <= 0), and the greedy pass is
    `ops.nms.nms_sorted` in f32."""
    shape = data.shape
    d = data.reshape((-1,) + tuple(shape[-2:]))
    B, N, K = d.shape
    scores = d[..., score_index]
    boxes = d[..., coord_start:coord_start + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    cls = d[..., id_index] if id_index >= 0 else None
    valid = scores > valid_thresh
    if cls is not None and background_id >= 0:
        valid = valid & (cls != background_id)
    ranked = torch.where(valid, scores, torch.full_like(scores, -math.inf))
    order = torch.sort(ranked, dim=1, descending=True, stable=True).indices
    svalid = torch.gather(valid, 1, order)
    if topk > 0:
        svalid = svalid & (torch.arange(N, device=d.device) < topk)
    sboxes = torch.gather(boxes, 1, order[..., None].expand(B, N, 4))
    scls = None
    if cls is not None and not force_suppress:
        scls = torch.gather(cls, 1, order)
    keep = _nms.nms_sorted(sboxes.float(), svalid, overlap_thresh, cls=scls)
    # back to the input order
    keep_orig = torch.empty_like(keep).scatter_(1, order, keep)
    new_scores = torch.where(keep_orig, scores, torch.full_like(scores, -1))
    out = d.clone()
    out[..., score_index] = new_scores
    return out.reshape(shape)


@register("box_encode", ndarray_inputs=("samples", "matches", "anchors",
                                        "refs"), differentiable=False)
def box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """ref: bounding_box.cc box_encode — corner references matched to
    corner anchors, encoded in centre form; (targets, masks)."""
    m = matches.long()
    ref = torch.gather(refs, 1, m[..., None].expand(
        tuple(m.shape) + (refs.shape[-1],)))

    def corner2center(x):
        w = x[..., 2] - x[..., 0]
        h = x[..., 3] - x[..., 1]
        return x[..., 0] + w / 2, x[..., 1] + h / 2, w, h
    gx, gy, gw, gh = corner2center(ref)
    ax, ay, aw, ah = corner2center(anchors)
    t0 = ((gx - ax) / aw - means[0]) / stds[0]
    t1 = ((gy - ay) / ah - means[1]) / stds[1]
    t2 = (torch.log((gw / aw).clamp_min(1e-12)) - means[2]) / stds[2]
    t3 = (torch.log((gh / ah).clamp_min(1e-12)) - means[3]) / stds[3]
    targets = torch.stack([t0, t1, t2, t3], dim=-1)
    mask = (samples > 0.5)[..., None]
    return (torch.where(mask, targets, torch.zeros_like(targets)),
            mask.expand(targets.shape).to(targets.dtype))


@register("box_decode", ndarray_inputs=("data", "anchors"))
def box_decode(data, anchors, std0=1.0, std1=1.0, std2=1.0, std3=1.0,
               clip=-1.0, format="corner"):
    """ref: bounding_box.cc box_decode — centre-form deltas on corner
    anchors back to corner boxes."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = anchors[..., 0] + aw / 2
    ay = anchors[..., 1] + ah / 2
    ox = data[..., 0] * std0 * aw + ax
    oy = data[..., 1] * std1 * ah + ay
    dw = data[..., 2] * std2
    dh = data[..., 3] * std3
    if clip > 0:
        dw = dw.clamp_max(clip)
        dh = dh.clamp_max(clip)
    ow = torch.exp(dw) * aw / 2
    oh = torch.exp(dh) * ah / 2
    return torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)


@register("bipartite_matching", ndarray_inputs=("data",),
          differentiable=False, num_outputs=2)
def bipartite_matching(data, threshold=0.5, is_ascend=False, topk=-1):
    """ref: bounding_box.cc bipartite_matching — greedy matching on a
    (B, N, M) score matrix: K steps of the best remaining pair (the first
    in row-major order among equals), each accepted while its score
    passes `threshold`; (row matches (B, N), column matches (B, M)),
    float32, -1 where unmatched."""
    B, N, M = data.shape
    s = -data if is_ascend else data.clone()
    K = min(N, M) if topk <= 0 else min(topk, N, M)
    dev = data.device
    row = torch.full((B, N), -1, dtype=torch.long, device=dev)
    col = torch.full((B, M), -1, dtype=torch.long, device=dev)
    rows, cols = torch.arange(N, device=dev), torch.arange(M, device=dev)
    for _ in range(K):
        flat = s.reshape(B, N * M)
        idx = torch.argmax(flat, dim=1)
        best = torch.gather(flat, 1, idx[:, None])[:, 0]
        r, c = idx // M, idx % M
        orig = -best if is_ascend else best
        ok = (orig < threshold) if is_ascend else (orig > threshold)
        rsel = (rows[None, :] == r[:, None]) & ok[:, None]
        csel = (cols[None, :] == c[:, None]) & ok[:, None]
        row = torch.where(rsel, c[:, None], row)
        col = torch.where(csel, r[:, None], col)
        blank = rsel[:, :, None] | csel[:, None, :]
        s = torch.where(blank, torch.full_like(s, -math.inf), s)
    return row.to(torch.float32), col.to(torch.float32)


# ---------------------------------------------------------------------------
# MultiBox family (SSD)
# ---------------------------------------------------------------------------


@register("MultiBoxPrior", ndarray_inputs=("data",), differentiable=False,
          jit=True)
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """ref: multibox_prior.cc — the anchors of one feature map (1,
    H*W*A, 4), corner form in [0, 1]: (sizes[0], r) for every ratio, then
    (s, 1) for sizes[1:]."""
    H, W = data.shape[2], data.shape[3]
    dev = data.device
    sizes, ratios = tuple(sizes), tuple(ratios)
    step_y = steps[1] if steps[1] > 0 else 1.0 / H
    step_x = steps[0] if steps[0] > 0 else 1.0 / W
    ys = (torch.arange(H, device=dev) + offsets[1]) * step_y
    xs = (torch.arange(W, device=dev) + offsets[0]) * step_x
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    ws = [sizes[0] * float(np.sqrt(r)) for r in ratios] + list(sizes[1:])
    hs = [sizes[0] / float(np.sqrt(r)) for r in ratios] + list(sizes[1:])
    ws, hs = _const(ws, dev), _const(hs, dev)
    cxe, cye = cx[..., None], cy[..., None]
    boxes = torch.stack([cxe - ws / 2, cye - hs / 2, cxe + ws / 2,
                         cye + hs / 2], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    return boxes.reshape(1, H * W * ws.shape[0], 4)


@register("MultiBoxTarget", ndarray_inputs=("anchor", "label", "cls_pred"),
          jit=True, differentiable=False, num_outputs=3)
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """ref: multibox_target.cc — SSD training targets.  anchor (1, N, 4)
    corner; label (B, M, 5) [cls, x1, y1, x2, y2], rows of cls < 0 are
    padding.  An anchor is positive when its best IoU reaches
    `overlap_threshold` or it is the best anchor of a valid ground-truth
    box (every valid box forces its match).  (loc_target (B, N*4),
    loc_mask (B, N*4), cls_target (B, N): 0 background, class + 1)."""
    anchors = anchor.reshape(-1, 4)
    N = anchors.shape[0]
    B, M, _ = label.shape
    gt_valid = label[..., 0] >= 0                          # (B, M)
    gt_boxes = label[..., 1:5]
    iou = _iou_corner(anchors.expand(B, N, 4), gt_boxes)     # (B, N, M)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=2)                             # per anchor
    best_gt = torch.argmax(iou, dim=2)
    best_anchor = torch.argmax(iou, dim=1)                 # (B, M)
    forced = ((torch.arange(N, device=anchor.device)[None, None, :]
               == best_anchor[:, :, None]) & gt_valid[:, :, None]).any(1)
    pos = forced | (best_iou >= overlap_threshold)
    lab = torch.gather(label[..., 0], 1, best_gt)
    cls_t = torch.where(pos, lab + 1.0, torch.zeros_like(lab))
    mg = torch.gather(gt_boxes, 1, best_gt[..., None].expand(B, N, 4))
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = anchors[:, 0] + aw / 2
    ay = anchors[:, 1] + ah / 2
    gw = (mg[..., 2] - mg[..., 0]).clamp_min(1e-8)
    gh = (mg[..., 3] - mg[..., 1]).clamp_min(1e-8)
    gx = mg[..., 0] + gw / 2
    gy = mg[..., 1] + gh / 2
    t = torch.stack([(gx - ax) / aw / variances[0],
                     (gy - ay) / ah / variances[1],
                     torch.log(gw / aw) / variances[2],
                     torch.log(gh / ah) / variances[3]], dim=-1)
    mask = pos[..., None].to(t.dtype).expand(B, N, 4)
    t = t * mask
    return t.reshape(B, N * 4), mask.reshape(B, N * 4), cls_t


@register("MultiBoxDetection", ndarray_inputs=("cls_prob", "loc_pred",
                                               "anchor"),
          differentiable=False, jit=True)
def multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """ref: multibox_detection.cc — decode and per-class NMS.  cls_prob
    (B, C, N), loc_pred (B, N*4), anchor (1, N, 4); (B, N, 6) rows
    [cls_id, score, x1, y1, x2, y2], -1 where not kept."""
    B, C, N = cls_prob.shape
    anchors = anchor.reshape(-1, 4)
    loc = loc_pred.reshape(B, N, 4)
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = anchors[:, 0] + aw / 2
    ay = anchors[:, 1] + ah / 2
    ox = loc[..., 0] * variances[0] * aw + ax
    oy = loc[..., 1] * variances[1] * ah + ay
    ow = torch.exp(loc[..., 2] * variances[2]) * aw / 2
    oh = torch.exp(loc[..., 3] * variances[3]) * ah / 2
    boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    fg = cls_prob[:, 1:, :] if background_id == 0 else cls_prob
    score = fg.amax(dim=1)
    cls_id = torch.argmax(fg, dim=1).to(torch.float32)
    keep = score > threshold
    cls_id = torch.where(keep, cls_id, torch.full_like(cls_id, -1.0))
    score = torch.where(keep, score, torch.full_like(score, -1.0))
    det = torch.cat([cls_id[..., None], score[..., None], boxes], dim=-1)
    return box_nms(det, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)


# ---------------------------------------------------------------------------
# ROI ops (Faster R-CNN)
# ---------------------------------------------------------------------------

_ROI_CHUNK = 32


def _bilinear_rows(coords, n):
    """(R, P) sample coordinates -> (R, P, n) bilinear weights, with the
    reference's edges: taps floor and floor + 1 clipped into range, the
    whole row 0 outside [-1, n]."""
    c0 = torch.floor(coords)
    w1 = coords - c0
    w0 = 1.0 - w1
    i0 = c0.long().clamp(0, n - 1)
    i1 = (c0.long() + 1).clamp(0, n - 1)
    inb = (coords >= -1) & (coords <= n)
    idx = torch.arange(n, device=coords.device)
    wm = (w0[..., None] * (idx == i0[..., None])
          + w1[..., None] * (idx == i1[..., None]))
    return torch.where(inb[..., None], wm, torch.zeros_like(wm))


@register("ROIAlign", ndarray_inputs=("data", "rois"), nograd_argnums=(1,),
          jit=True)
def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=2, position_sensitive=False, aligned=False):
    """ref: contrib/roi_align.cc — bilinear-sampled ROI pooling.  data
    (B, C, H, W); rois (R, 5) [batch_idx, x1, y1, x2, y2]; (R, C, PH, PW).

    The separable form of the JAX op: bilinear sampling factors into a
    per-roi row matrix Wy (PH, H) and column matrix Wx (PW, W), each the
    mean of its S samples, so pooling is two contractions and the batch
    pick a one-hot factor folded into the first:
    t = sum_{b,h} (onehot(b) Wy)[r, p, b, h] data[b, c, h, w], then
    out = sum_w Wx[r, q, w] t[r, c, p, w], in chunks of 32 rois.  The
    backward is the transposed products (no scatter).  f32 data contracts
    in full f32, as the JAX op's HIGHEST precision does, under torch's
    default of no TF32 in matmuls (`torch.backends.cuda.matmul.
    allow_tf32`, which a caller that turns it on turns on here too);
    bf16 data contracts with bf16 matrices, accumulates in
    f32 and rounds each product to bf16, as the JAX op casts; float64
    data takes float64 sample coordinates and contractions.  A roi of
    batch index -1 pools to zeros."""
    PH, PW = pooled_size
    S = max(1, int(sample_ratio))
    offset = 0.5 if aligned else 0.0
    B, C, H, W = data.shape
    R = rois.shape[0]
    if R == 0:
        return data.new_zeros((0, C, PH, PW))
    r32 = rois.to(torch.promote_types(data.dtype, torch.float32))
    x1 = r32[:, 1] * spatial_scale - offset
    y1 = r32[:, 2] * spatial_scale - offset
    x2 = r32[:, 3] * spatial_scale - offset
    y2 = r32[:, 4] * spatial_scale - offset
    floor = 1e-6 if aligned else 1.0
    rw = (x2 - x1).clamp_min(floor)
    rh = (y2 - y1).clamp_min(floor)
    dev = data.device
    ys = y1[:, None] + (torch.arange(PH * S, device=dev) + 0.5) \
        * (rh / PH / S)[:, None]
    xs = x1[:, None] + (torch.arange(PW * S, device=dev) + 0.5) \
        * (rw / PW / S)[:, None]
    wy = _bilinear_rows(ys, H).reshape(R, PH, S, H).mean(dim=2)
    wx = _bilinear_rows(xs, W).reshape(R, PW, S, W).mean(dim=2)
    bh = (torch.arange(B, device=dev)[None, :]
          == r32[:, 0].long()[:, None]).to(r32.dtype)          # (R, B)
    # the batch pick folded into the row matrix: (R, PH, B, H)
    m = (bh[:, None, :, None] * wy[:, :, None, :]).to(data.dtype)
    wx = wx.to(data.dtype)
    outs = []
    for lo in range(0, R, _ROI_CHUNK):
        hi = min(R, lo + _ROI_CHUNK)
        t = torch.einsum("rpbh,bchw->rcpw", m[lo:hi], data)
        outs.append(torch.einsum("rqw,rcpw->rcpq", wx[lo:hi], t))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)


@register("ROIPooling", ndarray_inputs=("data", "rois"), nograd_argnums=(1,),
          jit=True)
def roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """ref: src/operator/roi_pooling.cc — quantised max pooling; an empty
    bin is -inf, as in the JAX op."""
    PH, PW = pooled_size
    B, C, H, W = data.shape
    dev = data.device
    b = rois[:, 0].long()
    x1 = torch.round(rois[:, 1] * spatial_scale)
    y1 = torch.round(rois[:, 2] * spatial_scale)
    x2 = torch.round(rois[:, 3] * spatial_scale)
    y2 = torch.round(rois[:, 4] * spatial_scale)
    rw = (x2 - x1 + 1).clamp_min(1.0)
    rh = (y2 - y1 + 1).clamp_min(1.0)
    ph = torch.arange(PH, device=dev)
    pw = torch.arange(PW, device=dev)
    hstart = torch.floor(ph * rh[:, None] / PH) + y1[:, None]      # (R, PH)
    hend = torch.ceil((ph + 1) * rh[:, None] / PH) + y1[:, None]
    wstart = torch.floor(pw * rw[:, None] / PW) + x1[:, None]
    wend = torch.ceil((pw + 1) * rw[:, None] / PW) + x1[:, None]
    yy = torch.arange(H, device=dev)
    xx = torch.arange(W, device=dev)
    in_h = (yy >= hstart[..., None]) & (yy < hend[..., None])      # R PH H
    in_w = (xx >= wstart[..., None]) & (xx < wend[..., None])      # R PW W
    m = in_h[:, :, None, :, None] & in_w[:, None, :, None, :]    # R PH PW H W
    img = data[b]                                                 # R C H W
    big = torch.where(m[:, None], img[:, :, None, None],
                      torch.full((), -math.inf, dtype=data.dtype,
                                 device=dev))
    return big.amax(dim=(4, 5))


# ---------------------------------------------------------------------------
# resize / adaptive pooling
# ---------------------------------------------------------------------------


def _resize_weights(n_in, n_out, device):
    """(n_in, n_out) weights of `jax.image.resize`'s bilinear method:
    the triangle kernel at half-pixel centres, widened by the scale when
    shrinking (antialiasing), each column normalised, and 0 for a sample
    outside the input."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs() \
        / kernel_scale
    w = (1 - x.abs()).clamp_min(0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@register("BilinearResize2D", ndarray_inputs=("data",), jit=True)
def bilinear_resize_2d(data, height=0, width=0, scale_height=None,
                       scale_width=None, mode="size", align_corners=True):
    """ref: contrib/bilinear_resize.cc, as the JAX op computes it:
    `jax.image.resize(..., method="bilinear")`, one weight matrix per
    spatial axis (`align_corners` is ignored there and here)."""
    n, c, h, w = data.shape
    if height == 0 or mode != "size":
        height = int(h * (scale_height or 1.0))
        width = int(w * (scale_width or 1.0))
    height, width = int(height), int(width)
    if (height, width) == (h, w):
        return data.clone()
    wh = _resize_weights(h, height, data.device).to(data.dtype)
    ww = _resize_weights(w, width, data.device).to(data.dtype)
    out = torch.einsum("nchw,hH->ncHw", data, wh)
    return torch.einsum("ncHw,wW->ncHW", out, ww)


@register("AdaptiveAvgPooling2D", ndarray_inputs=("data",))
def adaptive_avg_pooling_2d(data, output_size=(1, 1)):
    """ref: contrib/adaptive_avg_pooling.cc — torch-style bins
    [floor(i H / OH), ceil((i + 1) H / OH))."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    OH, OW = output_size
    n, c, H, W = data.shape
    if H % OH == 0 and W % OW == 0:
        return data.reshape(n, c, OH, H // OH, OW, W // OW).mean(dim=(3, 5))
    rows = []
    for oh in range(OH):
        h0, h1 = (oh * H) // OH, -(-((oh + 1) * H) // OH)
        cols = []
        for ow in range(OW):
            w0, w1 = (ow * W) // OW, -(-((ow + 1) * W) // OW)
            cols.append(data[:, :, h0:h1, w0:w1].mean(dim=(2, 3)))
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


@register("count_sketch", ndarray_inputs=("data", "h", "s"),
          differentiable=False)
def count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """ref: contrib/count_sketch.cc — out[..., h[i]] += data[..., i] s[i]."""
    idx = h.long().reshape(-1)
    sign = s.reshape(-1)
    out = torch.zeros(tuple(data.shape[:-1]) + (int(out_dim),),
                      dtype=data.dtype, device=data.device)
    return out.index_add(data.ndim - 1, idx, data * sign)


@register("index_copy", ndarray_inputs=("old", "index", "new"),
          nograd_argnums=(1,))
def index_copy(old, index, new):
    """ref: contrib/index_copy.cc — old with rows `index` set to new."""
    out = old.clone()
    out[index.long()] = new.to(old.dtype)
    return out


@register("getnnz", ndarray_inputs=("data",), differentiable=False)
def getnnz(data, axis=None):
    nz = data != 0
    if axis is None:
        return nz.sum().to(torch.int64).reshape(1)
    return nz.sum(dim=axis).to(torch.int64)


# interleaved attention (ref: contrib/transformer.cc, the BERT path)

@register("interleaved_matmul_selfatt_qk",
          ndarray_inputs=("queries_keys_values",))
def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1):
    """qkv (T, B, 3 C), interleaved per head -> q k^T / sqrt(d),
    (B * heads, T, T)."""
    T, B, C3 = queries_keys_values.shape
    d = C3 // 3 // heads
    qkv = queries_keys_values.reshape(T, B, heads, 3, d)
    q = qkv[:, :, :, 0, :].permute(1, 2, 0, 3).reshape(B * heads, T, d)
    k = qkv[:, :, :, 1, :].permute(1, 2, 0, 3).reshape(B * heads, T, d)
    return torch.matmul(q, k.transpose(1, 2)) / float(np.sqrt(d))


@register("interleaved_matmul_selfatt_valatt",
          ndarray_inputs=("queries_keys_values", "attention"))
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads=1):
    """attention (B * heads, T, T) times the interleaved values,
    (T, B, C)."""
    T, B, C3 = queries_keys_values.shape
    C = C3 // 3
    d = C // heads
    qkv = queries_keys_values.reshape(T, B, heads, 3, d)
    v = qkv[:, :, :, 2, :].permute(1, 2, 0, 3).reshape(B * heads, T, d)
    out = torch.matmul(attention, v)
    return out.reshape(B, heads, T, d).permute(2, 0, 1, 3).reshape(T, B, C)
