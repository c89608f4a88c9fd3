"""PyTorch port: `mx.image` against the JAX package.

`imread`, `imdecode`, `imresize`, `resize_short`, the crops,
`color_normalize`, every augmenter and the chain `CreateAugmenter`
builds, `ImageIter` over a RecordIO file, and the detection augmenters
with `CreateDetAugmenter` give the JAX package's images and labels under
the same numpy seed: exactly, or where a resize runs within one step in
uint8 and 1e-4 x 255 in float32 (the port's numpy triangle filter
against `jax.image.resize`), and one uint8 step where the resized uint8
image is cast after.  Every image comes back as an NDArray on
the CPU.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import image as jimg
from incubator_mxnet_tpu.io import recordio as jrec

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import image as timg
from incubator_mxnet_tpu_torch.io import recordio as trec

pytestmark = pytest.mark.torch_port

_IMG = np.random.RandomState(3).randint(0, 256, (18, 22, 3)).astype(np.uint8)


def _host(x):
    assert isinstance(x, tmx.nd.NDArray) and x.context.type == "cpu"
    return x.asnumpy()


def _close(got, ref, resized, step=1e-4 * 255):
    """Exact, or after a resize one uint8 step, and `step` in float32
    (one uint8 step where a resized uint8 image was cast after)."""
    ref = ref.asnumpy() if hasattr(ref, "asnumpy") else np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if not resized:
        np.testing.assert_array_equal(got, ref)
    elif got.dtype == np.uint8:
        assert np.abs(got.astype(int) - ref).max() <= 1
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=step)


def test_imread_imdecode(tmp_path):
    from PIL import Image
    path = str(tmp_path / "a.png")
    Image.fromarray(_IMG).save(path)
    for flag in (1, 0):
        _close(_host(timg.imread(path, flag)), jimg.imread(path, flag), False)
    buf = open(path, "rb").read()
    _close(_host(timg.imdecode(buf)), jimg.imdecode(buf), False)
    np.testing.assert_array_equal(_host(timg.imdecode(buf)), _IMG)


# (function, args, whether it resizes)
FUNCS = [("imresize", (11, 7), True), ("imresize", (40, 30), True),
         ("resize_short", (9,), True), ("fixed_crop", (2, 3, 8, 6), False),
         ("fixed_crop", (2, 3, 8, 6, (5, 4)), True),
         ("center_crop", ((10, 8),), False),
         ("random_crop", ((10, 8),), False)]


@pytest.mark.parametrize("fn,args,resized", FUNCS)
def test_image_functions_match_jax(fn, args, resized):
    np.random.seed(1)
    got = getattr(timg, fn)(tmx.nd.array(_IMG, ctx="cpu"), *args)
    np.random.seed(1)
    ref = getattr(jimg, fn)(jmx.nd.array(_IMG), *args)
    if isinstance(ref, tuple):          # the crops return (image, rect)
        assert got[1] == ref[1]
        got, ref = got[0], ref[0]
    _close(_host(got), ref, resized)


def test_color_normalize_matches_jax():
    mean = np.array([120.0, 110.0, 100.0], np.float32)
    std = np.array([50.0, 60.0, 70.0], np.float32)
    got = timg.color_normalize(tmx.nd.array(_IMG, ctx="cpu"), mean, std)
    ref = jimg.color_normalize(jmx.nd.array(_IMG), mean, std)
    _close(_host(got), ref, False)


AUGS = [("ResizeAug", (10,), True), ("CenterCropAug", ((8, 6),), False),
        ("RandomCropAug", ((8, 6),), False),
        ("HorizontalFlipAug", (0.5,), False), ("CastAug", (), False),
        ("ColorNormalizeAug", ((100., 110., 120.), (50., 60., 70.)), False)]


@pytest.mark.parametrize("name,args,resized", AUGS)
def test_augmenters_match_jax(name, args, resized):
    for seed in range(3):
        np.random.seed(seed)
        got = getattr(timg, name)(*args)(tmx.nd.array(_IMG, ctx="cpu"))
        np.random.seed(seed)
        ref = getattr(jimg, name)(*args)(jmx.nd.array(_IMG))
        _close(_host(got), ref, resized)


@pytest.mark.parametrize("kw", [dict(resize=12, rand_crop=True,
                                     rand_mirror=True),
                                dict(mean=(120., 110., 100.),
                                     std=(60., 50., 55.))])
def test_create_augmenter_chain_matches_jax(kw):
    t = timg.CreateAugmenter((3, 8, 10), **kw)
    j = jimg.CreateAugmenter((3, 8, 10), **kw)
    assert [type(a).__name__ for a in t] == [type(a).__name__ for a in j]
    for seed in range(3):
        np.random.seed(seed)
        x = tmx.nd.array(_IMG, ctx="cpu")
        for a in t:
            x = a(x)
        np.random.seed(seed)
        y = jmx.nd.array(_IMG)
        for a in j:
            y = a(y)
        # the resize's uint8 output, one step either way, is cast
        _close(_host(x), y, "resize" in kw, step=1.0)


def test_image_iter_over_record_file(tmp_path):
    path = str(tmp_path / "i.rec")
    rs = np.random.RandomState(2)
    w = trec.MXRecordIO(path, "w")
    for i in range(7):
        w.write(trec.pack_img(trec.IRHeader(0, float(i), i, 0),
                              rs.randint(0, 255, (20, 24, 3),
                                         dtype=np.uint8), img_fmt=".png"))
    w.close()
    t = timg.ImageIter(3, (3, 12, 14), path_imgrec=path, resize=16,
                       dtype="uint8", workers=0, ctx="cpu")
    j = jimg.ImageIter(3, (3, 12, 14), path_imgrec=path, resize=16,
                       dtype="uint8", workers=0)
    got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in t]
    ref = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in j]
    assert len(got) == len(ref) == 3 and got[-1][2] == ref[-1][2] == 2
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[0], r[0])
        np.testing.assert_array_equal(g[1], r[1])
    with pytest.raises(tmx.MXNetError, match="path_imgrec"):
        timg.ImageIter(3, (3, 12, 14))


# -- detection -----------------------------------------------------------------

_LABEL = np.array([[0, 0.1, 0.2, 0.5, 0.6], [2, 0.4, 0.3, 0.9, 0.8],
                   [-1, -1, -1, -1, -1]], np.float32)

DET_AUGS = [("DetHorizontalFlipAug", (0.5,)),
            ("DetRandomCropAug", (0.3,)),
            ("DetRandomPadAug", ())]


@pytest.mark.parametrize("name,args", DET_AUGS)
def test_detection_augmenters_match_jax(name, args):
    for seed in range(4):
        np.random.seed(seed)
        gi, gl = getattr(timg, name)(*args)(tmx.nd.array(_IMG, ctx="cpu"),
                                            _LABEL)
        np.random.seed(seed)
        ri, rl = getattr(jimg, name)(*args)(jmx.nd.array(_IMG), _LABEL)
        _close(_host(gi), ri, False)
        np.testing.assert_array_equal(np.asarray(gl), np.asarray(rl))


def test_create_det_augmenter_matches_jax():
    kw = dict(resize=20, rand_crop=0.5, rand_pad=0.5, rand_mirror=True,
              mean=(120., 110., 100.), std=(60., 50., 55.))
    t = timg.CreateDetAugmenter((3, 12, 16), **kw)
    j = jimg.CreateDetAugmenter((3, 12, 16), **kw)
    assert [type(a).__name__ for a in t] == [type(a).__name__ for a in j]
    for seed in range(4):
        np.random.seed(seed)
        x, lab = tmx.nd.array(_IMG, ctx="cpu"), _LABEL
        for a in t:
            x, lab = a(x, lab)
        np.random.seed(seed)
        y, ref_lab = jmx.nd.array(_IMG), _LABEL
        for a in j:
            y, ref_lab = a(y, ref_lab)
        _close(_host(x), y, True)
        np.testing.assert_array_equal(np.asarray(lab), np.asarray(ref_lab))
    sel = timg.DetRandomSelectAug([timg.DetHorizontalFlipAug(1.0)], 1.0)
    img, lab = sel(tmx.nd.array(_IMG, ctx="cpu"), _LABEL)
    np.testing.assert_array_equal(lab, _LABEL)
