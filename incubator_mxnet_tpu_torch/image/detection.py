"""Detection augmenters of the PyTorch port (a port of
incubator_mxnet_tpu/image/detection.py; ref: python/mxnet/image/detection.py).

Augmenters transform `(image, label)` pairs where `label` is an
(N, 4+)-array of `[id, xmin, ymin, xmax, ymax, ...]` rows with
normalised [0, 1] coordinates, the SSD training format.  Host numpy, as
the classification augmenters in `image.py`: images come back as
NDArrays on the CPU.
"""
from __future__ import annotations

import numpy as _np

from .image import (Augmenter, CastAug, ColorNormalizeAug, ResizeAug,
                    _as_np, _host, imresize)

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter"]


class DetAugmenter:
    """Base detection augmenter (ref: detection.DetAugmenter)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap an image-only Augmenter; the label passes through
    (ref: detection.DetBorrowAug)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.__class__.__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly select ONE of the aug candidates (or skip)
    (ref: detection.DetRandomSelectAug)."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if _np.random.rand() < self.skip_prob or not self.aug_list:
            return src, label
        aug = self.aug_list[_np.random.randint(len(self.aug_list))]
        return aug(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image and boxes together (ref: detection.DetHorizontalFlipAug)."""

    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _np.random.rand() < self.p:
            img = _host(_np.ascontiguousarray(_as_np(src)[:, ::-1]))
            label = _np.array(label, dtype=_np.float32, copy=True)
            valid = label[:, 0] >= 0
            x1 = label[valid, 1].copy()
            label[valid, 1] = 1.0 - label[valid, 3]
            label[valid, 3] = 1.0 - x1
            return img, label
        return src, label


def _bbox_overlap(boxes, crop):
    """IoU-with-crop per box; boxes (N,4), crop (4,) in [0,1] coords."""
    ix1 = _np.maximum(boxes[:, 0], crop[0])
    iy1 = _np.maximum(boxes[:, 1], crop[1])
    ix2 = _np.minimum(boxes[:, 2], crop[2])
    iy2 = _np.minimum(boxes[:, 3], crop[3])
    iw = _np.maximum(0.0, ix2 - ix1)
    ih = _np.maximum(0.0, iy2 - iy1)
    inter = iw * ih
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / _np.maximum(area, 1e-12)


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping boxes whose overlap with the crop meets
    `min_object_covered`; boxes are clipped and renormalised to the
    crop (ref: detection.DetRandomCropAug, the SSD sampling recipe)."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), max_attempts=50):
        super().__init__(min_object_covered=min_object_covered)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = int(max_attempts)

    def __call__(self, src, label):
        img = _as_np(src)
        H, W = img.shape[:2]
        label = _np.array(label, dtype=_np.float32, copy=True)
        valid = label[:, 0] >= 0
        boxes = label[valid, 1:5]
        for _ in range(self.max_attempts):
            area = _np.random.uniform(*self.area_range)
            ratio = _np.random.uniform(*self.aspect_ratio_range)
            cw = min(1.0, _np.sqrt(area * ratio))
            ch = min(1.0, _np.sqrt(area / ratio))
            cx = _np.random.uniform(0.0, 1.0 - cw)
            cy = _np.random.uniform(0.0, 1.0 - ch)
            crop = _np.array([cx, cy, cx + cw, cy + ch], _np.float32)
            if boxes.size:
                cov = _bbox_overlap(boxes, crop)
                keep = cov >= self.min_object_covered
                if not keep.any():
                    continue
            else:
                keep = _np.zeros((0,), bool)
            x0, y0 = int(cx * W), int(cy * H)
            x1, y1 = int((cx + cw) * W), int((cy + ch) * H)
            if x1 <= x0 or y1 <= y0:
                continue
            out_img = _host(_np.ascontiguousarray(img[y0:y1, x0:x1]))
            # renormalise surviving boxes into crop coordinates
            new_rows = []
            vi = _np.where(valid)[0]
            for j, k in zip(vi, range(len(keep))):
                if not keep[k]:
                    continue
                row = label[j].copy()
                bx1 = (max(row[1], crop[0]) - crop[0]) / cw
                by1 = (max(row[2], crop[1]) - crop[1]) / ch
                bx2 = (min(row[3], crop[2]) - crop[0]) / cw
                by2 = (min(row[4], crop[3]) - crop[1]) / ch
                row[1:5] = [bx1, by1, bx2, by2]
                new_rows.append(row)
            if not new_rows and boxes.size:
                continue
            pad = _np.full((label.shape[0] - len(new_rows),
                            label.shape[1]), -1.0, _np.float32)
            new_label = _np.concatenate(
                [_np.array(new_rows, _np.float32).reshape(
                    -1, label.shape[1]), pad], axis=0) \
                if new_rows else pad
            return out_img, new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Pad the image into a larger canvas (zoom-out), shifting boxes
    (ref: detection.DetRandomPadAug)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(127, 127, 127)):
        super().__init__(area_range=area_range)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = int(max_attempts)
        self.pad_val = pad_val

    def __call__(self, src, label):
        img = _as_np(src)
        H, W, C = img.shape
        label = _np.array(label, dtype=_np.float32, copy=True)
        for _ in range(self.max_attempts):
            area = _np.random.uniform(*self.area_range)
            ratio = _np.random.uniform(*self.aspect_ratio_range)
            scale_w = _np.sqrt(area * ratio)
            scale_h = _np.sqrt(area / ratio)
            if scale_w < 1.0 or scale_h < 1.0:
                continue
            newW, newH = int(W * scale_w), int(H * scale_h)
            ox = _np.random.randint(0, newW - W + 1)
            oy = _np.random.randint(0, newH - H + 1)
            canvas = _np.empty((newH, newW, C), img.dtype)
            canvas[...] = _np.asarray(self.pad_val, img.dtype)
            canvas[oy:oy + H, ox:ox + W] = img
            valid = label[:, 0] >= 0
            label[valid, 1] = (label[valid, 1] * W + ox) / newW
            label[valid, 3] = (label[valid, 3] * W + ox) / newW
            label[valid, 2] = (label[valid, 2] * H + oy) / newH
            label[valid, 4] = (label[valid, 4] * H + oy) / newH
            return _host(canvas), label
        return src, label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_mirror=False, mean=None, std=None,
                       min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), max_attempts=50,
                       pad_val=(127, 127, 127)):
    """Standard detection pipeline factory (ref:
    detection.CreateDetAugmenter): optional random crop/pad (probability
    = rand_crop/rand_pad), flip, resize to data_shape, cast+normalise."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(1.0, area_range[1])),
                                max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(1.0, area_range[0]), area_range[1]),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    # final geometry: force to data_shape (H, W from (C, H, W))
    auglist.append(DetBorrowAug(_ForceResizeAug(data_shape[2],
                                                data_shape[1])))
    auglist.append(DetBorrowAug(CastAug()))
    if mean is not None or std is not None:
        mean = mean if mean is not None else _np.zeros(3, _np.float32)
        std = std if std is not None else _np.ones(3, _np.float32)
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class _ForceResizeAug(Augmenter):
    def __init__(self, w, h):
        super().__init__(size=(w, h))
        self._w, self._h = w, h

    def __call__(self, src):
        return imresize(src, self._w, self._h)
