"""mx.image of the PyTorch port (a port of incubator_mxnet_tpu/image/image.py;
ref: python/mxnet/image/image.py): imread/imdecode/imresize, the crops,
`color_normalize`, the augmenters with `CreateAugmenter`, and `ImageIter`
over `io.ImageRecordIter`.  Decode is PIL's; the augmenters are host
numpy.  Every function returns NDArrays on the CPU, as MXNet's image
operators do (the port's one exception to `cuda:0` by default): the
card is reached through `DataLoader(ctx=...)`, `DeviceFeed` or a copy.
"""
from __future__ import annotations

import numpy as _np

from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..gluon.data.vision.transforms import _host, _resize_np

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "color_normalize", "HorizontalFlipAug",
           "CastAug", "ColorNormalizeAug", "ResizeAug", "CenterCropAug",
           "RandomCropAug", "CreateAugmenter", "Augmenter", "ImageIter"]


def _as_np(img):
    return img.asnumpy() if isinstance(img, NDArray) else _np.asarray(img)


def imread(filename, flag=1, to_rgb=True):
    try:
        from PIL import Image
    except ImportError:
        raise MXNetError("PIL unavailable — cannot decode %s" % filename)
    im = Image.open(filename)
    im = im.convert("RGB" if flag else "L")
    a = _np.asarray(im)
    if a.ndim == 2:
        a = a[:, :, None]
    return _host(a)


def imdecode(buf, flag=1, to_rgb=True):
    from ..io.recordio import _decode_img
    return _host(_decode_img(bytes(buf), flag))


def imresize(src, w, h, interp=1):
    a = _as_np(src)
    return _host(_resize_np(a, (w, h)).astype(a.dtype))


def resize_short(src, size, interp=1):
    a = _as_np(src)
    H, W = a.shape[:2]
    if H > W:
        w, h = size, int(H * size / W)
    else:
        w, h = int(W * size / H), size
    return imresize(src, w, h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=1):
    a = _as_np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
            a = _resize_np(a, size).astype(a.dtype)
    return _host(a)


def center_crop(src, size, interp=1):
    a = _as_np(src)
    H, W = a.shape[:2]
    w, h = size
    x0 = max(0, (W - w) // 2)
    y0 = max(0, (H - h) // 2)
    return fixed_crop(src, x0, y0, w, h, size, interp), (x0, y0, w, h)


def random_crop(src, size, interp=1):
    a = _as_np(src)
    H, W = a.shape[:2]
    w, h = size
    x0 = _np.random.randint(0, max(1, W - w + 1))
    y0 = _np.random.randint(0, max(1, H - h + 1))
    return fixed_crop(src, x0, y0, w, h, size, interp), (x0, y0, w, h)


def color_normalize(src, mean, std=None):
    a = _as_np(src).astype(_np.float32)
    a = a - _as_np(mean)
    if std is not None:
        a = a / _as_np(std)
    return _host(a)


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return resize_short(src, self.size)


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return center_crop(src, self.size)[0]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return random_crop(src, self.size)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p=0.5):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _np.random.rand() < self.p:
            return _host(_np.ascontiguousarray(_as_np(src)[:, ::-1]))
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return _host(_as_np(src).astype(self.typ))


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__()
        self.mean = _np.asarray(mean, _np.float32)
        self.std = _np.asarray(std, _np.float32)

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """ref: image.CreateAugmenter."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size))
    else:
        auglist.append(CenterCropAug(crop_size))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(
            mean if mean is not None else _np.zeros(3),
            std if std is not None else _np.ones(3)))
    return auglist


class ImageIter:
    """ref: image.ImageIter — .rec/.lst driven iterator (python layer)."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, shuffle=False, aug_list=None, **kwargs):
        from ..io.io import ImageRecordIter
        if path_imgrec is None:
            raise MXNetError("ImageIter currently requires path_imgrec")
        self._inner = ImageRecordIter(path_imgrec, data_shape, batch_size,
                                      shuffle=shuffle, **kwargs)
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    __next__ = next
