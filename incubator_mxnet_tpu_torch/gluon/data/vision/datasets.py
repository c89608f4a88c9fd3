"""Vision datasets of the PyTorch port (a port of
incubator_mxnet_tpu/gluon/data/vision/datasets.py; ref:
python/mxnet/gluon/data/vision/datasets.py).

MNIST, FashionMNIST and CIFAR read the standard file formats from a
local `root`: there is no automatic download, so point `root` at files
fetched beforehand.  `SyntheticImageDataset` makes deterministic data
for benchmarks and tests.  Images come back as numpy arrays or, from
`ImageRecordDataset` and `ImageFolderDataset`, as NDArrays on the CPU:
decode runs on the host, and the card is reached through
`DataLoader(ctx=...)`.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as _np

from ..dataset import Dataset, ArrayDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "SyntheticImageDataset", "ImageRecordDataset",
           "ImageFolderDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._transform = transform
        self._train = train
        self._root = os.path.expanduser(root)
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(self._data[idx], self._label[idx])
        return self._data[idx], self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


class MNIST(_DownloadedDataset):
    """ref: gluon.data.vision.MNIST (idx-ubyte format)."""

    _train_data = ("train-images-idx3-ubyte.gz",)
    _train_label = ("train-labels-idx1-ubyte.gz",)
    _test_data = ("t10k-images-idx3-ubyte.gz",)
    _test_label = ("t10k-labels-idx1-ubyte.gz",)

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _read(self, names):
        for name in names:
            path = os.path.join(self._root, name)
            if os.path.exists(path):
                return path
            if os.path.exists(path[:-3]):
                return path[:-3]
        raise FileNotFoundError(
            "MNIST files not found under %s (no egress — place them "
            "manually)" % self._root)

    def _get_data(self):
        dpath = self._read(self._train_data if self._train else
                           self._test_data)
        lpath = self._read(self._train_label if self._train else
                           self._test_label)
        opener = gzip.open if dpath.endswith(".gz") else open
        with opener(lpath, "rb") as f:
            struct.unpack(">II", f.read(8))
            label = _np.frombuffer(f.read(), dtype=_np.uint8) \
                .astype(_np.int32)
        with opener(dpath, "rb") as f:
            _, _, rows, cols = struct.unpack(">IIII", f.read(16))
            data = _np.frombuffer(f.read(), dtype=_np.uint8) \
                .reshape(len(label), rows, cols, 1)
        self._data = data
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """ref: gluon.data.vision.CIFAR10 (binary batches format)."""

    _train_files = ["data_batch_%d.bin" % i for i in range(1, 6)]
    _test_files = ["test_batch.bin"]
    _num_classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar10"),
                 train=True, transform=None):
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as f:
            raw = _np.frombuffer(f.read(), dtype=_np.uint8)
        rec = raw.reshape(-1, 3072 + 1)
        return rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            rec[:, 0].astype(_np.int32)

    def _get_data(self):
        files = self._train_files if self._train else self._test_files
        data, label = [], []
        for name in files:
            path = os.path.join(self._root, name)
            if not os.path.exists(path):
                raise FileNotFoundError(
                    "CIFAR file %s not found (no egress — place it "
                    "manually)" % path)
            d, l = self._read_batch(path)
            data.append(d)
            label.append(l)
        self._data = _np.concatenate(data)
        self._label = _np.concatenate(label)


class CIFAR100(CIFAR10):
    _train_files = ["train.bin"]
    _test_files = ["test.bin"]
    _num_classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        super().__init__(root, train, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as f:
            raw = _np.frombuffer(f.read(), dtype=_np.uint8)
        rec = raw.reshape(-1, 3072 + 2)
        lbl = rec[:, 1 if self._fine_label else 0].astype(_np.int32)
        return rec[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), lbl


class SyntheticImageDataset(Dataset):
    """Deterministic synthetic images — benchmark/test input source."""

    def __init__(self, num_samples=1024, shape=(224, 224, 3),
                 num_classes=1000, seed=0, dtype="uint8"):
        rng = _np.random.RandomState(seed)
        self._data = rng.randint(
            0, 255, size=(num_samples,) + tuple(shape)).astype(dtype)
        self._label = rng.randint(0, num_classes,
                                  size=(num_samples,)).astype(_np.int32)

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        return self._data[idx], self._label[idx]


class ImageRecordDataset(Dataset):
    """ref: vision.ImageRecordDataset over im2rec RecordIO files."""

    def __init__(self, filename, flag=1, transform=None):
        from ...data.dataset import RecordFileDataset
        from ....io.recordio import unpack_img
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform
        self._unpack = unpack_img

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        record = self._record[idx]
        header, img = self._unpack(record)
        from .... import ndarray as nd
        img = nd.array(img, ctx="cpu")       # a host op: on the CPU
        if self._transform is not None:
            return self._transform(img, header.label)
        return img, header.label


class ImageFolderDataset(Dataset):
    """ref: vision.ImageFolderDataset — label per subdirectory."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png", ".bmp"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                if os.path.splitext(filename)[1].lower() in self._exts:
                    self.items.append((os.path.join(path, filename), label))

    def __getitem__(self, idx):
        from ....image.image import imread
        img = imread(self.items[idx][0], self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
