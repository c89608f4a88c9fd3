"""PyTorch port: `gluon.data` against the JAX package.

Datasets (filter, shard, take, transform, transform_first, `ArrayDataset`,
`RecordFileDataset`), the samplers (`BatchSampler`'s keep, discard and
rollover over two epochs) and the `DataLoader` (serial, thread and
`spawn` workers, the picklability fallback, `ctx=` through the device
feed) give the JAX package's samples and batches exactly under the same
numpy seed.  The vision datasets read files the tests write (MNIST and
FashionMNIST idx, gz and plain; CIFAR-10/100 binaries; a RecordIO file;
an image folder) exactly as the JAX package does.  Each of the fourteen
transforms gives the JAX transform's output under the same numpy seed:
exactly, or, where it resizes, within 1e-4 x 255 in f32 (the port's
numpy filter against `jax.image.resize`) and one step in uint8 (a float
within that distance of an integer truncates either way).  Host
transforms return NDArrays on the CPU.
"""
import gzip
import os
import pickle
import struct
import warnings

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu.gluon import data as jdata
from incubator_mxnet_tpu.gluon.data.vision import transforms as jtf
from incubator_mxnet_tpu.io import recordio as jrec

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.gluon import data as tdata
from incubator_mxnet_tpu_torch.gluon.data.vision import transforms as ttf
from incubator_mxnet_tpu_torch.io import recordio as trec

pytestmark = pytest.mark.torch_port


def _np(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _assert_same(got, ref):
    got, ref = _np(got), _np(ref)
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _assert_same(g, r)
        return
    np.testing.assert_array_equal(got, ref)


def _arrays(n=10):
    rs = np.random.RandomState(0)
    return (rs.randn(n, 3, 4).astype(np.float32),
            rs.randint(0, 5, n).astype(np.int32))


# -- datasets and samplers -----------------------------------------------------

def test_dataset_ops_match_jax():
    x, y = _arrays()
    t, j = tdata.ArrayDataset(x, y), jdata.ArrayDataset(x, y)
    assert len(t) == len(j) == 10
    cases = [
        lambda d: d.filter(lambda s: s[1] > 1),
        lambda d: d.shard(3, 1),
        lambda d: d.take(4),
        lambda d: d.transform(lambda a, b: (a * 2, b + 1)),
        lambda d: d.transform(lambda a, b: (a - 1, b), lazy=False),
        lambda d: d.transform_first(lambda a: a.sum(axis=0)),
    ]
    for case in cases:
        got, ref = case(t), case(j)
        assert len(got) == len(ref)
        for i in range(len(ref)):
            _assert_same(got[i], ref[i])
    s = tdata.SimpleDataset(list(range(5)))
    assert list(s) == list(jdata.SimpleDataset(list(range(5))))
    # a 1-D NDArray column becomes numpy, as in the JAX package
    col = tdata.ArrayDataset(tmx.nd.array(y, ctx="cpu"))
    assert isinstance(col._data[0], np.ndarray)


def test_record_file_dataset_matches_jax(tmp_path):
    path = str(tmp_path / "r.rec")
    w = trec.MXIndexedRecordIO(str(tmp_path / "r.idx"), path, "w")
    for i in range(5):
        w.write_idx(i, b"record-%d" % i)
    w.close()
    t, j = tdata.RecordFileDataset(path), jdata.RecordFileDataset(path)
    assert len(t) == len(j) == 5
    assert [t[i] for i in range(5)] == [j[i] for i in range(5)]


@pytest.mark.parametrize("last", ["keep", "discard", "rollover"])
def test_samplers_match_jax(last):
    np.random.seed(3)
    t = tdata.BatchSampler(tdata.RandomSampler(10), 3, last)
    np.random.seed(3)
    j = jdata.BatchSampler(jdata.RandomSampler(10), 3, last)
    for epoch in range(2):
        np.random.seed(10 + epoch)
        got = list(t)
        np.random.seed(10 + epoch)
        assert got == list(j)
        assert len(t) == len(j)
    seq = tdata.BatchSampler(tdata.SequentialSampler(7, start=2), 4)
    assert list(seq) == list(jdata.BatchSampler(
        jdata.SequentialSampler(7, start=2), 4))
    with pytest.raises(ValueError):
        list(tdata.BatchSampler(tdata.SequentialSampler(5), 2, "bad"))


# -- the DataLoader ------------------------------------------------------------

def _loader_batches(loader):
    return [_np(b) for b in loader]


@pytest.mark.parametrize("workers,thread_pool", [(0, False), (2, True),
                                                 (2, False)])
def test_dataloader_matches_jax(workers, thread_pool):
    """Serial, thread and spawn workers, shuffled, `ctx="cpu"` through
    the device feed: the JAX loader's batches, NDArrays on the CPU."""
    x, y = _arrays(11)
    ds_t, ds_j = tdata.ArrayDataset(x, y), jdata.ArrayDataset(x, y)
    np.random.seed(5)
    t = tdata.DataLoader(ds_t, batch_size=4, shuffle=True,
                         num_workers=workers, thread_pool=thread_pool,
                         ctx="cpu", timeout=60)
    np.random.seed(5)
    j = jdata.DataLoader(ds_j, batch_size=4, shuffle=True,
                         num_workers=workers, thread_pool=thread_pool,
                         timeout=60)
    try:
        for epoch in range(2):
            np.random.seed(20 + epoch)
            got = list(t)
            np.random.seed(20 + epoch)
            ref = _loader_batches(j)
            assert len(got) == len(ref) == len(t) == 3
            for g, r in zip(got, ref):
                assert all(isinstance(a, tmx.nd.NDArray)
                           and a.context.type == "cpu" for a in g)
                _assert_same(g, r)
    finally:
        t.close()


def test_dataloader_custom_batchify_and_last_batch():
    x, y = _arrays(10)

    def batchify(samples):
        return tmx.nd.array(np.stack([s[0] for s in samples]), ctx="cpu")
    t = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=4,
                         last_batch="discard", batchify_fn=batchify,
                         ctx="cpu")
    got = [b.asnumpy() for b in t]
    assert len(got) == 2
    np.testing.assert_array_equal(got[1], x[4:8])
    with pytest.raises(ValueError, match="batch_size"):
        tdata.DataLoader(tdata.ArrayDataset(x), batch_size=2,
                         batch_sampler=tdata.BatchSampler(
                             tdata.SequentialSampler(10), 2))


class _Unpicklable(tdata.Dataset):
    def __init__(self, n):
        self._fn = lambda i: np.full((2,), i, np.float32)
        self._n = n

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        return self._fn(i)

    def __reduce__(self):
        raise pickle.PicklingError("not picklable")


def test_dataloader_unpicklable_falls_back_to_threads():
    with pytest.warns(UserWarning, match="thread workers"):
        t = tdata.DataLoader(_Unpicklable(5), batch_size=2, num_workers=2,
                             ctx="cpu")
    try:
        assert t._thread_pool
        got = [b.asnumpy()[:, 0].tolist() for b in t]
        assert got == [[0, 1], [2, 3], [4]]
    finally:
        t.close()


# -- vision datasets ------------------------------------------------------------

def _write_mnist(root, prefix, n, rows=5, cols=4, gz=True):
    rs = np.random.RandomState(len(prefix))
    pix = rs.randint(0, 256, (n, rows, cols)).astype(np.uint8)
    lab = rs.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    with opener(os.path.join(root, "%s-labels-idx1-ubyte%s"
                             % (prefix, suffix)), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + lab.tobytes())
    with opener(os.path.join(root, "%s-images-idx3-ubyte%s"
                             % (prefix, suffix)), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, rows, cols) + pix.tobytes())


def _assert_dataset_same(t, j):
    assert len(t) == len(j)
    for i in range(len(j)):
        _assert_same(t[i], j[i])


@pytest.mark.parametrize("cls,gz", [("MNIST", True), ("FashionMNIST", False)])
def test_mnist_from_local_files(tmp_path, cls, gz):
    _write_mnist(str(tmp_path), "train", 7, gz=gz)
    _write_mnist(str(tmp_path), "t10k", 3, gz=gz)
    for train in (True, False):
        t = getattr(tdata.vision, cls)(root=str(tmp_path), train=train)
        j = getattr(jdata.vision, cls)(root=str(tmp_path), train=train)
        _assert_dataset_same(t, j)
    with pytest.raises(FileNotFoundError, match="place them"):
        tdata.vision.MNIST(root=str(tmp_path / "none"))


@pytest.mark.parametrize("cls,fine", [("CIFAR10", None), ("CIFAR100", False),
                                      ("CIFAR100", True)])
def test_cifar_from_local_files(tmp_path, cls, fine):
    rs = np.random.RandomState(1)
    labels = 1 if cls == "CIFAR10" else 2
    files = (["data_batch_%d.bin" % i for i in range(1, 6)] +
             ["test_batch.bin"]) if cls == "CIFAR10" else \
        ["train.bin", "test.bin"]
    for name in files:
        rec = rs.randint(0, 256, (3, labels + 3072)).astype(np.uint8)
        rec.tofile(str(tmp_path / name))
    kw = {} if fine is None else {"fine_label": fine}
    for train in (True, False):
        t = getattr(tdata.vision, cls)(root=str(tmp_path), train=train, **kw)
        j = getattr(jdata.vision, cls)(root=str(tmp_path), train=train, **kw)
        _assert_dataset_same(t, j)


def test_synthetic_record_and_folder_datasets(tmp_path):
    from PIL import Image
    t = tdata.vision.SyntheticImageDataset(6, (8, 9, 3), 10, seed=2)
    j = jdata.vision.SyntheticImageDataset(6, (8, 9, 3), 10, seed=2)
    _assert_dataset_same(t, j)
    rs = np.random.RandomState(4)
    path = str(tmp_path / "img.rec")
    w = trec.MXIndexedRecordIO(str(tmp_path / "img.idx"), path, "w")
    for i in range(4):
        w.write_idx(i, trec.pack_img(trec.IRHeader(0, float(i), i, 0),
                                     rs.randint(0, 255, (6, 7, 3),
                                                dtype=np.uint8),
                                     img_fmt=".png"))
    w.close()
    t = tdata.vision.ImageRecordDataset(path)
    j = jdata.vision.ImageRecordDataset(path)
    _assert_dataset_same(t, j)
    assert t[0][0].context.type == "cpu"
    for cls in ("cat", "dog"):
        os.makedirs(tmp_path / "folder" / cls)
        for k in range(2):
            Image.fromarray(rs.randint(0, 255, (5, 6, 3), dtype=np.uint8)) \
                .save(str(tmp_path / "folder" / cls / ("%d.png" % k)))
    t = tdata.vision.ImageFolderDataset(str(tmp_path / "folder"))
    j = jdata.vision.ImageFolderDataset(str(tmp_path / "folder"))
    assert t.synsets == j.synsets == ["cat", "dog"]
    _assert_dataset_same(t, j)
    assert t[3][0].context.type == "cpu"


# -- transforms -----------------------------------------------------------------

_IMG = np.random.RandomState(9).randint(0, 256, (20, 24, 3)).astype(np.uint8)

# (name, constructor arguments, whether the output went through a resize)
TRANSFORMS = [
    ("Cast", ("float32",), False), ("ToTensor", (), False),
    ("Normalize", ((0.4, 0.5, 0.6), (0.2, 0.3, 0.25)), False),
    ("Resize", (12,), True), ("Resize", ((10, 14),), True),
    ("Resize", (12, True), True), ("CenterCrop", (10,), False),
    ("CenterCrop", ((30, 26),), True), ("RandomResizedCrop", (8,), True),
    ("RandomFlipLeftRight", (), False), ("RandomFlipTopBottom", (), False),
    ("RandomBrightness", (0.3,), False), ("RandomContrast", (0.3,), False),
    ("RandomSaturation", (0.3,), False), ("RandomLighting", (0.1,), False),
    ("CropResize", (2, 3, 10, 8), False),
    ("CropResize", (2, 3, 10, 8, (6, 5)), True)]


@pytest.mark.parametrize("name,args,resized", TRANSFORMS)
def test_transform_matches_jax(name, args, resized):
    x = _IMG.astype(np.float32) / 255 if name == "Normalize" else _IMG
    if name == "Normalize":
        x = x.transpose(2, 0, 1)
    for seed in (0, 1, 2):
        np.random.seed(seed)
        got = getattr(ttf, name)(*args)(tmx.nd.array(x, ctx="cpu"))
        np.random.seed(seed)
        ref = getattr(jtf, name)(*args)(jmx.nd.array(x)).asnumpy()
        assert isinstance(got, tmx.nd.NDArray) and got.context.type == "cpu"
        got = got.asnumpy()
        assert got.shape == ref.shape and got.dtype == ref.dtype
        if not resized:
            np.testing.assert_array_equal(got, ref)
        elif got.dtype == np.uint8:
            assert np.abs(got.astype(int) - ref).max() <= 1
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * 255)


def test_compose_matches_jax():
    def chain(tf):
        return tf.Compose([tf.RandomFlipLeftRight(), tf.CenterCrop(16),
                           tf.ToTensor(), tf.Normalize(0.5, 0.25)])
    np.random.seed(7)
    got = chain(ttf)(tmx.nd.array(_IMG, ctx="cpu")).asnumpy()
    np.random.seed(7)
    ref = chain(jtf)(jmx.nd.array(_IMG)).asnumpy()
    np.testing.assert_array_equal(got, ref)
    # in a dataset's transform_first, as a DataLoader worker runs it
    x, y = _IMG[None].repeat(3, 0), np.arange(3, dtype=np.int32)
    t = tdata.ArrayDataset(x, y).transform_first(ttf.ToTensor())
    j = jdata.ArrayDataset(x, y).transform_first(jtf.ToTensor())
    _assert_dataset_same(t, j)
    assert isinstance(torch.from_numpy(_np(t[0][0])), torch.Tensor)
