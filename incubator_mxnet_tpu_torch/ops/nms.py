"""Greedy non-maximum suppression of the PyTorch port: one hand-written
CUDA kernel (`csrc/nms.cu`) that serves both of the JAX package's NMS
passes, `box_nms` (incubator_mxnet_tpu/ops/contrib.py:59) and `_nms_keep`
(incubator_mxnet_tpu/ops/rcnn.py:58).  Neither is a Pallas kernel: the
JAX package leaves them to XLA loops, which on the card would be N tiny
launches or a loop whose exit depends on the data, and neither fits in a
captured CUDA graph.

`nms_sorted(boxes, valid, thresh, cls=None, plus_one=False, topk=0,
positions_only=False)` takes B images of N boxes in score order and
returns `keep` (B, N) bool, and with `topk > 0` also the first `topk`
kept positions (B, topk) int64, -1 after them; with `positions_only`
only those positions, which lets the kernel stop at the `topk`-th kept
box:

* a CUDA tensor launches the kernel (a count launch where `valid` is
  given, a mask launch and a scan launch), or raises `ValueError` for
  what it does not take (boxes not f32, more than 65,535 images);
* a CPU tensor takes the plain PyTorch version (`nms_sorted_plain`): the
  same greedy pass as N vectorised updates with no host read, so that
  the CPU recorder of `graph_capture` captures it;
* there is no fallback between the two and no size threshold.

`iou_corner` and `iou_plus_one` are the two IoU formulas, in the JAX
package's order of operations, which the kernel repeats with rounding
intrinsics so that `iou > thresh` decides the same way.  `nms_launches`
counts the wrapper's calls that launched the kernel (each is one mask
and one scan launch, `mxt_nms_mask_kernel` and `mxt_nms_scan_kernel`,
after one `mxt_nms_count_kernel` where `valid` is given).
"""
from __future__ import annotations

import torch

from . import _kernels

__all__ = ["nms_sorted", "nms_sorted_plain", "iou_corner", "iou_plus_one",
           "first_kept"]

#: calls of the wrapper that launched the CUDA kernel in this process
nms_launches = 0


def iou_corner(a, b):
    """IoU of (..., N, 4) corner boxes against (..., M, 4), (..., N, M):
    no +1, and 0 where the union is 0 (`_iou_corner` of the JAX
    contrib ops)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = (br - tl).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0.0) * \
        (a[..., 3] - a[..., 1]).clamp_min(0.0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0.0) * \
        (b[..., 3] - b[..., 1]).clamp_min(0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def iou_plus_one(a, b):
    """IoU with the +1 pixel convention and the union floored at 1e-12
    (`_nms_keep` and `ProposalTarget` of the JAX rcnn ops), (..., N, M)."""
    area_a = (a[..., 2] - a[..., 0] + 1).clamp_min(0) * \
        (a[..., 3] - a[..., 1] + 1).clamp_min(0)
    area_b = (b[..., 2] - b[..., 0] + 1).clamp_min(0) * \
        (b[..., 3] - b[..., 1] + 1).clamp_min(0)
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = (br - tl + 1).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area_a[..., :, None] + area_b[..., None, :]
                     - inter).clamp_min(1e-12)


def first_kept(keep, topk):
    """The positions of the first `topk` True entries of each row of
    `keep` (B, N), -1 after them, (B, topk) int64: a cumsum and a
    scatter, with no host read (`jnp.nonzero(size=topk, fill_value=-1)`
    of the JAX package)."""
    B, N = keep.shape
    pos = keep.long().cumsum(1) - 1
    slot = torch.where(keep & (pos < topk), pos, torch.full_like(pos, topk))
    out = torch.full((B, topk + 1), -1, dtype=torch.long, device=keep.device)
    out.scatter_(1, slot, torch.arange(N, device=keep.device).expand(B, N))
    return out[:, :topk]


def nms_sorted_plain(boxes, valid, thresh, cls=None, plus_one=False, topk=0,
                     positions_only=False):
    """Plain PyTorch version of the kernel: the (B, N, N) suppression
    pairs, then one vectorised update per box in score order,
    keep &= ~(sup[i] & keep[i]), with keep starting as `valid`."""
    _check_mode(topk, positions_only)
    B, N, _ = boxes.shape
    sup = (iou_plus_one if plus_one else iou_corner)(boxes, boxes) > thresh
    if cls is not None:
        sup &= cls[:, :, None] == cls[:, None, :]
    sup &= torch.ones(N, N, dtype=torch.bool, device=boxes.device).triu(1)
    keep = torch.ones(B, N, dtype=torch.bool, device=boxes.device) \
        if valid is None else valid.clone()
    for i in range(N):
        keep = keep & ~(sup[:, i, :] & keep[:, i:i + 1])
    if positions_only:
        return first_kept(keep, topk)
    if topk > 0:
        return keep, first_kept(keep, topk)
    return keep


def _check_mode(topk, positions_only):
    if positions_only and topk <= 0:
        raise ValueError("nms positions_only needs topk > 0, got %d" % topk)


def _nms_cuda(boxes, valid, thresh, cls, plus_one, topk, positions_only):
    global nms_launches
    _check_mode(topk, positions_only)
    if boxes.dtype != torch.float32:
        raise ValueError("nms kernel takes float32 boxes, got %s"
                         % boxes.dtype)
    if boxes.ndim != 3 or boxes.shape[2] != 4:
        raise ValueError("nms kernel needs boxes (B, N, 4), got %s"
                         % (tuple(boxes.shape),))
    B, N, _ = boxes.shape
    if B > 65535:
        raise ValueError("nms kernel takes at most 65535 images, got %d" % B)
    dev = boxes.device
    for name, t in (("cls", cls), ("valid", valid)):
        if t is not None and (t.device != dev or tuple(t.shape) != (B, N)):
            raise ValueError("nms %s must be (B, N) = %s on %s, got %s on %s"
                             % (name, (B, N), dev, tuple(t.shape), t.device))
    boxes = boxes.contiguous()
    if cls is not None:
        cls = cls.to(torch.float32).contiguous()
    if valid is not None:
        valid = valid.to(torch.bool).contiguous()
    keep = None if positions_only else \
        torch.empty((B, N), dtype=torch.bool, device=dev)
    idx = torch.empty((B, max(topk, 0)), dtype=torch.long, device=dev)
    if B * N == 0:
        idx.fill_(-1)
    else:
        lib = _kernels.library("nms")
        scratch = torch.empty(B * lib.mxt_nms_mask_words(N),
                              dtype=torch.long, device=dev)
        with torch.cuda.device(dev):
            rc = lib.mxt_nms(
                boxes.data_ptr(), 0 if cls is None else cls.data_ptr(),
                0 if valid is None else valid.data_ptr(), scratch.data_ptr(),
                0 if keep is None else keep.data_ptr(),
                idx.data_ptr() if topk > 0 else 0, B, N, float(thresh),
                int(bool(plus_one)), int(max(topk, 0)),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError("nms kernel launch failed with CUDA error %d"
                               % rc)
        nms_launches += 1
    if positions_only:
        return idx
    return (keep, idx) if topk > 0 else keep


def nms_sorted(boxes, valid, thresh, cls=None, plus_one=False, topk=0,
               positions_only=False):
    """Greedy NMS over `boxes` (B, N, 4) f32 in score order (module doc):
    the kernel for CUDA tensors, the plain version for CPU ones.  `valid`
    (B, N) bool or None: the boxes that take part (a box that does not is
    neither kept nor suppresses); `cls` (B, N) or None: class ids, only
    boxes of one class suppress each other; `plus_one`: `iou_plus_one`,
    else `iou_corner`; `positions_only` (with `topk > 0`): return only
    the first `topk` kept positions."""
    if boxes.device.type == "cuda":
        return _nms_cuda(boxes, valid, thresh, cls, plus_one, topk,
                         positions_only)
    if boxes.device.type == "cpu":
        return nms_sorted_plain(boxes, valid, thresh, cls, plus_one, topk,
                                positions_only)
    raise ValueError("nms runs on CUDA or CPU tensors, got a tensor on %s"
                     % boxes.device)
