"""Vision transforms of the PyTorch port (a port of
incubator_mxnet_tpu/gluon/data/vision/transforms.py; ref:
python/mxnet/gluon/data/vision/transforms.py).

The transforms run on the host in numpy, in DataLoader workers, and
return NDArrays on the CPU, as MXNet's image operators do: the one
exception to the port's default device.  The card is reached through
`DataLoader(ctx=...)`, `DeviceFeed` or an explicit copy.  The resize is
the decode service's numpy triangle filter (half-pixel centres,
antialiased when it shrinks), the semantics of the JAX package's
bilinear image resize.
"""
from __future__ import annotations

import numpy as _np
import torch

from ...block import Block
from ...nn.basic_layers import Sequential, HybridSequential
from ....ndarray.ndarray import NDArray
from .... import ndarray as nd

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomLighting", "CropResize"]


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):   # a Block call unwraps its NDArrays
        return NDArray(x, ctx="cpu").asnumpy()
    return _np.asarray(x)


def _host(a):
    """A host result: an NDArray on the CPU."""
    return nd.array(a, ctx="cpu")


class Compose(Sequential):
    """ref: transforms.Compose."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return _host(_as_np(x).astype(self._dtype))


class ToTensor(Block):
    """HWC uint8 [0,255] → CHW float32 [0,1] (ref semantics)."""

    def forward(self, x):
        a = _as_np(x).astype(_np.float32) / 255.0
        if a.ndim == 3:
            a = a.transpose(2, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(0, 3, 1, 2)
        return _host(a)


class Normalize(Block):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = _np.asarray(mean, dtype=_np.float32)
        self._std = _np.asarray(std, dtype=_np.float32)

    def forward(self, x):
        a = _as_np(x).astype(_np.float32)
        mean = self._mean.reshape(-1, 1, 1)
        std = self._std.reshape(-1, 1, 1)
        return _host((a - mean) / std)


def _resize_np(a, size, interp="bilinear"):
    """Host resize to `size` (an int, or (w, h)) of an HWC (or HW)
    image, as float32 HWC: the numpy triangle filter."""
    from ....io.decode_service import _resize_linear
    wh = (size, size) if isinstance(size, int) else tuple(size)
    return _resize_linear(a, wh)


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio

    def forward(self, x):
        a = _as_np(x)
        if self._keep and isinstance(self._size, int):
            h, w = a.shape[:2]
            scale = self._size / min(h, w)
            size = (int(round(w * scale)), int(round(h * scale)))
        else:
            size = self._size
        return _host(_resize_np(a, size).astype(a.dtype))


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size

    def forward(self, x):
        a = _as_np(x)
        w, h = self._size
        H, W = a.shape[:2]
        if H < h or W < w:
            a = _resize_np(a, (max(w, W), max(h, H))).astype(a.dtype)
            H, W = a.shape[:2]
        y0 = (H - h) // 2
        x0 = (W - w) // 2
        return _host(a[y0:y0 + h, x0:x0 + w])


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3/4, 4/3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio

    def forward(self, x):
        a = _as_np(x)
        H, W = a.shape[:2]
        area = H * W
        for _ in range(10):
            target_area = _np.random.uniform(*self._scale) * area
            log_ratio = (_np.log(self._ratio[0]), _np.log(self._ratio[1]))
            aspect = _np.exp(_np.random.uniform(*log_ratio))
            w = int(round(_np.sqrt(target_area * aspect)))
            h = int(round(_np.sqrt(target_area / aspect)))
            if w <= W and h <= H:
                x0 = _np.random.randint(0, W - w + 1)
                y0 = _np.random.randint(0, H - h + 1)
                crop = a[y0:y0 + h, x0:x0 + w]
                return _host(_resize_np(crop, self._size)
                                .astype(a.dtype))
        return CenterCrop(self._size).forward(a)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        a = _as_np(x)
        if _np.random.rand() < 0.5:
            a = a[:, ::-1]
        return _host(_np.ascontiguousarray(a))


class RandomFlipTopBottom(Block):
    def forward(self, x):
        a = _as_np(x)
        if _np.random.rand() < 0.5:
            a = a[::-1]
        return _host(_np.ascontiguousarray(a))


class _RandomJitter(Block):
    def __init__(self, amount):
        super().__init__()
        self._amount = amount

    def _factor(self):
        return 1.0 + _np.random.uniform(-self._amount, self._amount)


class RandomBrightness(_RandomJitter):
    def forward(self, x):
        a = _as_np(x).astype(_np.float32)
        return _host(_np.clip(a * self._factor(), 0, 255))


class RandomContrast(_RandomJitter):
    def forward(self, x):
        a = _as_np(x).astype(_np.float32)
        mean = a.mean()
        return _host(_np.clip((a - mean) * self._factor() + mean, 0, 255))


class RandomSaturation(_RandomJitter):
    def forward(self, x):
        a = _as_np(x).astype(_np.float32)
        gray = a.mean(axis=-1, keepdims=True)
        f = self._factor()
        return _host(_np.clip(a * f + gray * (1 - f), 0, 255))


class RandomLighting(Block):
    """AlexNet-style PCA lighting noise (ref: transforms.RandomLighting)."""

    _eigval = _np.array([55.46, 4.794, 1.148])
    _eigvec = _np.array([[-0.5675, 0.7192, 0.4009],
                         [-0.5808, -0.0045, -0.8140],
                         [-0.5836, -0.6948, 0.4203]])

    def __init__(self, alpha=0.05):
        super().__init__()
        self._alpha = alpha

    def forward(self, x):
        a = _as_np(x).astype(_np.float32)
        alpha = _np.random.normal(0, self._alpha, size=(3,))
        rgb = (self._eigvec * alpha * self._eigval).sum(axis=1)
        return _host(_np.clip(a + rgb, 0, 255))


class CropResize(Block):
    def __init__(self, x, y, width, height, size=None, interpolation=1):
        super().__init__()
        self._x, self._y = x, y
        self._w, self._h = width, height
        self._size = size

    def forward(self, data):
        a = _as_np(data)
        crop = a[self._y:self._y + self._h, self._x:self._x + self._w]
        if self._size is not None:
            crop = _resize_np(crop, self._size).astype(a.dtype)
        return _host(crop)
