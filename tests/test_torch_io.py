"""PyTorch port: the input pipeline (`mx.io`) against the JAX package.

RecordIO files written by either package read byte for byte in the
other (plain, indexed, multi-label, JPEG, PNG, the RAWI frame and the
``.crc`` sidecar).  `decode_record` and `shard_records` equal the JAX
functions bit for bit, the port's numpy resize is within 1e-4 x 255 of
`jax.image.resize` in f32, and a `DecodeService` of 2 workers delivers
the JAX service's batches byte for byte, under each start method and
after a killed worker is respawned; a corrupt record is quarantined through the ``.crc`` sidecar
and past the budget the epoch fails.  `DeviceFeed` on the CPU mirrors
tests/python/unittest/test_device_feed.py (order, counters, reset in
flight, errors, close, a recycled slab not aliased, the synchronous
mode).  `normalize_transform` equals the JAX one bit for bit in bf16.
`ImageRecordIter` on its threaded, native and service paths gives the
JAX iterator's batches (exact), and every `NDArrayIter`, `CSVIter`,
`LibSVMIter`, `MNISTIter`, `ResizeIter` and `PrefetchingIter` mode the
JAX iterator's.  `set_input_transform` on a small ResNet v1b fed uint8,
eager and hybridized, is bit for bit the port fed the normalized floats
and within test_torch_resnet's rule of the JAX block.  Tests that
start processes use 2 workers and a bound of their own.
"""
import gzip
import os
import struct
import sys
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import config as jcfg
from incubator_mxnet_tpu.io import decode_service as jds
from incubator_mxnet_tpu.io import device_feed as jfeed
from incubator_mxnet_tpu.io import io as jio
from incubator_mxnet_tpu.io import native as jnative
from incubator_mxnet_tpu.io import recordio as jrec
from incubator_mxnet_tpu.gluon.data.vision import transforms as jtf

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import config as tcfg
from incubator_mxnet_tpu_torch import fault as tfault
from incubator_mxnet_tpu_torch import integrity as tinteg
from incubator_mxnet_tpu_torch.io import decode_service as tds
from incubator_mxnet_tpu_torch.io import device_feed as tfeed
from incubator_mxnet_tpu_torch.io import io as tio
from incubator_mxnet_tpu_torch.io import native as tnative
from incubator_mxnet_tpu_torch.io import recordio as trec
from incubator_mxnet_tpu_torch.io import resilient as tres
from incubator_mxnet_tpu_torch.gluon.data.vision import transforms as ttf
from incubator_mxnet_tpu_torch.monitor import events as tevents

pytestmark = pytest.mark.torch_port

N_REC = 24
SHAPE = (3, 24, 28)


def _images(seed, n, hw=(32, 40)):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 255, hw + (3,), dtype=np.uint8) for _ in range(n)]


def _write(rec_mod, path, images, fmt=".jpg", indexed=False):
    if indexed:
        w = rec_mod.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                      path, "w")
    else:
        w = rec_mod.MXRecordIO(path, "w")
    for i, img in enumerate(images):
        buf = rec_mod.pack_img(rec_mod.IRHeader(0, float(i), i, 0), img,
                               quality=90, img_fmt=fmt)
        w.write_idx(i, buf) if indexed else w.write(buf)
    w.close()
    return path


@pytest.fixture(scope="module")
def rec_file(tmp_path_factory):
    """A plain JPEG .rec written by the port, record id in the label."""
    path = str(tmp_path_factory.mktemp("tio") / "data.rec")
    return _write(trec, path, _images(7, N_REC))


# -- RecordIO -----------------------------------------------------------------

@pytest.mark.parametrize("fmt,indexed", [(".jpg", False), (".png", True)])
def test_recordio_files_byte_equal_and_cross_read(tmp_path, fmt, indexed):
    """The same records written by both packages are the same bytes
    (data and .idx), and each package reads the other's file."""
    imgs = _images(1, 6)
    tp = _write(trec, str(tmp_path / "t.rec"), imgs, fmt, indexed)
    jp = _write(jrec, str(tmp_path / "j.rec"), imgs, fmt, indexed)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    if indexed:
        assert open(tp[:-4] + ".idx").read() == open(jp[:-4] + ".idx").read()
    for reader, path in ((jrec, tp), (trec, jp)):
        r = (reader.MXIndexedRecordIO(path[:-4] + ".idx", path, "r")
             if indexed else reader.MXRecordIO(path, "r"))
        for i, img in enumerate(imgs):
            raw = r.read_idx(i) if indexed else r.read()
            h, got = reader.unpack_img(raw)
            assert h.label == float(i) and h.id == i
            if fmt == ".png":
                np.testing.assert_array_equal(got, img)
        r.close()


def test_recordio_multilabel_split_and_offsets(tmp_path):
    """Multi-label pack/unpack both ways; a split record (cflag 1..3)
    written by hand reads whole in both; offsets agree."""
    label = np.array([3.0, 1.5, -2.0], np.float32)
    for a, b in ((trec, jrec), (jrec, trec)):
        h, s = b.unpack(a.pack(a.IRHeader(0, label, 5, 9), b"payload"))
        assert h.flag == 3 and h.id == 5 and h.id2 == 9 and s == b"payload"
        np.testing.assert_array_equal(h.label, label)
    path = str(tmp_path / "split.rec")
    with open(path, "wb") as f:
        for cflag, part in ((1, b"abcde"), (2, b"fg"), (3, b"hij")):
            f.write(struct.pack("<II", 0xced7230a, (cflag << 29) | len(part)))
            f.write(part + b"\0" * ((-len(part)) % 4))
        f.write(struct.pack("<II", 0xced7230a, 3) + b"xyz\0")
    for mod in (trec, jrec):
        r = mod.MXRecordIO(path, "r")
        assert r.read() == b"abcdefghij" and r.read() == b"xyz"
        assert r.read() is None
        r.close()
    assert trec.list_record_offsets(path) == jrec.list_record_offsets(path)
    assert trec.idx_sidecar_path("/d/train") == "/d/train.idx"


def test_recordio_rawi_frame_without_pil(tmp_path, monkeypatch):
    """With PIL missing both packages write the same RAWI frame and
    decode it to the same pixels."""
    img = _images(2, 1, (5, 7))[0]
    monkeypatch.setitem(sys.modules, "PIL", None)
    a = trec.pack_img(trec.IRHeader(0, 1.0, 0, 0), img)
    b = jrec.pack_img(jrec.IRHeader(0, 1.0, 0, 0), img)
    assert a == b and a[24:28] == b"RAWI"
    np.testing.assert_array_equal(jrec.unpack_img(a)[1], img)
    np.testing.assert_array_equal(trec.unpack_img(b)[1], img)


def test_crc_sidecar_cross_read(rec_file, tmp_path):
    path = str(tmp_path / "c.rec")
    with open(rec_file, "rb") as f, open(path, "wb") as g:
        g.write(f.read())
    side = trec.write_crc_sidecar(path)
    assert side == path + ".crc"
    assert trec.read_crc_sidecar(path) == jrec.read_crc_sidecar(path)
    algo, crcs = jrec.read_crc_sidecar(path)
    assert algo == tinteg.checksum_algo() and len(crcs) == N_REC


# -- decode and shard ----------------------------------------------------------

@pytest.mark.parametrize("resize,crop,mirror,dtype", [
    (-1, False, False, "uint8"), (30, True, True, "uint8"),
    (20, True, False, "float32"), (50, False, True, "float32")])
def test_decode_record_bit_equal(rec_file, resize, crop, mirror, dtype):
    r = trec.MXRecordIO(rec_file, "r")
    mean = np.array([120., 110., 100.], np.float32).reshape(3, 1, 1)
    std = np.array([60., 50., 70.], np.float32).reshape(3, 1, 1)
    kw = dict(mean=mean, std=std) if dtype == "float32" else {}
    for i in range(4):
        raw = r.read()
        got = tds.decode_record(raw, SHAPE, resize, crop, mirror,
                                tds._record_rng(3, 1, 0, i, 2),
                                dtype=dtype, **kw)
        ref = jds.decode_record(raw, SHAPE, resize, crop, mirror,
                                jds._record_rng(3, 1, 0, i, 2),
                                dtype=dtype, **kw)
        assert got[0].dtype == ref[0].dtype and got[0].shape == SHAPE
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1] == ref[1]
    r.close()


@pytest.mark.parametrize("n,workers,batch,shuffle", [
    (10, 1, None, False), (37, 3, None, True), (40, 3, 16, True),
    (37, 2, 8, False), (5, 4, 2, True)])
def test_shard_records_bit_equal(n, workers, batch, shuffle):
    for epoch in (0, 3):
        got = [tds.shard_records(n, workers, w, epoch=epoch, shuffle=shuffle,
                                 seed=11, batch_size=batch)
               for w in range(workers)]
        ref = [jds.shard_records(n, workers, w, epoch=epoch, shuffle=shuffle,
                                 seed=11, batch_size=batch)
               for w in range(workers)]
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        assert sorted(np.concatenate(got).tolist()) == list(range(n))


@pytest.mark.parametrize("hw,size", [((32, 40), (17, 13)), ((12, 9), (30, 25)),
                                     ((32, 40), 32), ((7, 50), (50, 7))])
def test_numpy_resize_matches_jax_image_resize(hw, size):
    """The port's triangle filter against jax.image.resize ('bilinear')
    in f32, within 1e-4 x 255."""
    a = np.random.RandomState(5).randint(0, 255, hw + (3,)).astype(np.uint8)
    got = ttf._resize_np(a, size)
    ref = jtf._resize_np(a, size)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * 255)


# -- the decode service ---------------------------------------------------------

@pytest.fixture(autouse=True)
def _bounded_service(monkeypatch):
    """A bound of the tests' own on every service wait: a wedged pool
    fails the test in seconds instead of hanging the suite."""
    for mod in (tds, jds):
        monkeypatch.setattr(mod, "_PULL_TIMEOUT_S", 30.0)
        monkeypatch.setattr(mod, "_DRAIN_TIMEOUT_S", 10.0)
        monkeypatch.setattr(mod, "_READY_TIMEOUT_S", 20.0)


def _service(mod, path, batch=4, **kw):
    args = dict(workers=2, shuffle=True, seed=13, rand_crop=True,
                rand_mirror=True, dtype="uint8", resize=30)
    args.update(kw)
    return mod.DecodeService(path, batch, SHAPE, **args)


def _stream(svc):
    """One epoch as {(wid, seq): (data, label)} copies."""
    return {(sb.wid, sb.seq): (sb.data.copy(), sb.label.copy())
            for sb in svc}


def _assert_streams_equal(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k][0], ref[k][0])
        np.testing.assert_array_equal(got[k][1], ref[k][1])


@pytest.mark.parametrize("method", ["fork", "spawn", "forkserver"])
def test_decode_service_matches_jax_service(rec_file, method):
    """Two epochs of 2 workers, started by each MXNET_IO_MP_START method
    (spawn and forkserver workers are fresh interpreters that import the
    port's package): every (wid, seq) batch byte for byte the JAX
    service's (on its default, fork), every record once per epoch."""
    tcfg.set("MXNET_IO_MP_START", method)   # read when the workers start
    t, j = _service(tds, rec_file), _service(jds, rec_file)
    try:
        for _ in range(2):
            got, ref = _stream(t), _stream(j)
            _assert_streams_equal(got, ref)
            ids = sorted(int(v) for _, lab in got.values() for v in lab[:, 0])
            assert ids == list(range(N_REC))
        assert t.workers == 2 and t.num_records == N_REC
        started = type(t._procs[0]._popen).__module__.rsplit(".", 1)[-1]
        assert started in ("popen_" + method, "popen_%s_posix" % method)
    finally:
        t.close()
        j.close()
        tcfg.unset("MXNET_IO_MP_START")


def test_decode_service_respawn_bit_identical(rec_file):
    """A worker killed mid-epoch is respawned and the epoch's batches
    are byte for byte the JAX service's uninterrupted stream.  Batches of
    2 in a ring of 3 slots: each worker still owes 3 of its 6 batches
    when the consumer has taken one."""
    small = dict(batch=2, ring_slots=3)
    j = _service(jds, rec_file, **small)
    try:
        ref = _stream(j)
    finally:
        j.close()
    svc = _service(tds, rec_file, **small)
    try:
        it = iter(svc)
        first = next(it)
        got = {(first.wid, first.seq): (first.data.copy(),
                                        first.label.copy())}
        time.sleep(0.3)
        restarts = tevents.get("io.decode.worker_restarts")
        svc._procs[0].kill()
        while True:
            try:
                sb = next(it)
            except StopIteration:
                break
            got[(sb.wid, sb.seq)] = (sb.data.copy(), sb.label.copy())
        assert tevents.get("io.decode.worker_restarts") == restarts + 1
    finally:
        svc.close()
    _assert_streams_equal(got, ref)


def test_decode_service_quarantine_and_budget(rec_file, tmp_path):
    """A record whose payload does not match its .crc entry is
    quarantined (the batch ships short, the clean records keep the
    JAX service's bytes); with budget 0 the epoch fails."""
    path = str(tmp_path / "q.rec")
    with open(rec_file, "rb") as f, open(path, "wb") as g:
        g.write(f.read())
    trec.write_crc_sidecar(path)
    off = trec.list_record_offsets(path)[5]
    with open(path, "r+b") as f:          # flip a payload bit of record 5
        f.seek(off + 8 + 40)
        b = f.read(1)
        f.seek(off + 8 + 40)
        f.write(bytes([b[0] ^ 1]))
    corrupt = tevents.get("io.decode.records_corrupt")
    svc, j = _service(tds, path), _service(jds, path)
    try:
        got, ref = _stream(svc), _stream(j)
        _assert_streams_equal(got, ref)
        ids = sorted(int(v) for _, lab in got.values() for v in lab[:, 0])
        assert ids == [i for i in range(N_REC) if i != 5]
        assert tevents.get("io.decode.records_corrupt") == corrupt + 1
    finally:
        svc.close()
        j.close()
    tcfg.set("MXNET_IO_CORRUPT_BUDGET", 0)
    try:
        svc = _service(tds, path)
        try:
            with pytest.raises(tinteg.CorruptRecordBudgetExceeded):
                _stream(svc)
        finally:
            svc.close()
    finally:
        tcfg.unset("MXNET_IO_CORRUPT_BUDGET")


# -- DeviceFeed on the CPU --------------------------------------------------------

def _batches(n=5):
    return [(np.full((2, 3), i, np.float32), np.arange(2) + i)
            for i in range(n)]


def test_feed_order_values_and_counters():
    c0 = tfeed.feed_counters()
    feed = tfeed.DeviceFeed(_batches(), ctx="cpu")
    got = list(feed)
    assert len(got) == 5
    for i, (x, y) in enumerate(got):
        assert isinstance(x, tmx.nd.NDArray) and x.context.type == "cpu"
        np.testing.assert_array_equal(x.asnumpy(), np.full((2, 3), i))
        assert y.dtype == np.int32          # int64 narrowed as nd.array
        np.testing.assert_array_equal(y.asnumpy(), np.arange(2) + i)
    c1 = tfeed.feed_counters()
    assert c1["feed.batches"] - c0.get("feed.batches", 0) == 5
    assert c1["feed.bytes"] - c0.get("feed.bytes", 0) == 5 * (24 + 8)
    for k in ("feed.read_us", "feed.transfer_us", "feed.stall_us",
              "feed.step_us", "feed.epochs"):
        assert k in c1


def test_feed_sync_mode_matches():
    tcfg.set("MXNET_FEED_ASYNC", 0)
    try:
        feed = tfeed.DeviceFeed(_batches(), ctx="cpu")
        assert feed._async is False
        got = [x.asnumpy()[0, 0] for x, _ in feed]
    finally:
        tcfg.unset("MXNET_FEED_ASYNC")
    assert got == [0, 1, 2, 3, 4]


def test_feed_reset_mid_flight_and_epochs():
    def source():
        return iter(_batches())
    feed = tfeed.DeviceFeed(source, ctx="cpu", depth=2)
    it = iter(feed)
    assert next(it)[0].asnumpy()[0, 0] == 0
    feed.reset()
    assert [x.asnumpy()[0, 0] for x, _ in feed] == [0, 1, 2, 3, 4]
    assert [x.asnumpy()[0, 0] for x, _ in feed] == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("where", ["source", "transform"])
def test_feed_error_propagates(where):
    def source():
        yield _batches(1)[0]
        if where == "source":
            raise ValueError("boom")
        yield _batches(2)[1]

    def transform(b):
        if b[0][0, 0] == 1:
            raise ValueError("boom")
        return b
    feed = tfeed.DeviceFeed(source, ctx="cpu",
                            transform=transform if where != "source" else None)
    it = iter(feed)
    next(it)
    with pytest.raises(ValueError, match="boom"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_feed_close_stops_and_thread_retires():
    feed = tfeed.DeviceFeed(_batches(50), ctx="cpu", depth=1)
    it = iter(feed)
    next(it)
    t = feed._thread
    feed.close()
    with pytest.raises(StopIteration):
        next(it)
    t.join(timeout=5)
    assert not t.is_alive()


def test_feed_recycled_slab_not_aliased():
    """A source that reuses one buffer (the decode service's slab ring)
    hands the feed the same numpy array each batch: every delivered
    batch keeps its own values."""
    slab = np.zeros((2, 2), np.uint8)

    def source():
        for i in range(4):
            slab[...] = i
            yield slab
    got = list(tfeed.DeviceFeed(source, ctx="cpu", depth=1))
    assert [g.asnumpy()[0, 0] for g in got] == [0, 1, 2, 3]


def test_feed_sharding_not_yet_ported():
    """`sharding=` places each replica's rows on its context (more in
    test_torch_gluon_multi.py); a spec that splits another dimension is
    not ported."""
    from incubator_mxnet_tpu_torch import parallel as tpar
    mesh = tpar.make_mesh(devices=[tmx.cpu(0), tmx.cpu(1)])
    rows = [np.arange(8, dtype=np.float32).reshape(4, 2)]
    (got,) = list(tfeed.DeviceFeed(rows, sharding=tpar.batch_sharded(mesh)))
    assert [g.context for g in got] == [tmx.cpu(0), tmx.cpu(1)]
    np.testing.assert_array_equal(got[1].asnumpy(), rows[0][2:])
    with pytest.raises(NotImplementedError, match="batch dimension"):
        tfeed.DeviceFeed(_batches(), sharding=tpar.NamedSharding(
            mesh, tpar.P(None, "data")))


@pytest.mark.parametrize("mean,std,dtype", [
    (127.5, 64.0, "bfloat16"), ((123.7, 116.3, 103.5), (58.4, 57.1, 57.4),
                                "bfloat16"), ((10., 20., 30.), 3.0, "float32")])
def test_normalize_transform_matches_jax(mean, std, dtype):
    """bf16 bit for bit: both compute (x.f32 - mean) / std in f32 and
    round once to the dtype."""
    x = np.random.RandomState(3).randint(0, 256, (2, 3, 5, 6)).astype(np.uint8)
    got = tfeed.normalize_transform(mean, std, dtype)(
        tmx.nd.array(x, ctx="cpu"))
    ref = jfeed.normalize_transform(mean, std, dtype)(jmx.nd.array(x))
    got_t = got._data
    assert str(got_t.dtype).endswith(dtype)
    ref_np = np.asarray(ref._data.astype("float32"))
    np.testing.assert_array_equal(got_t.float().numpy(), ref_np)
    norm = tfeed.make_normalizer(mean, std, dtype)(torch.from_numpy(x))
    np.testing.assert_array_equal(norm.float().numpy(), ref_np)


# -- ImageRecordIter ------------------------------------------------------------

def _iter_batches(it, n=None):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        if n is not None and len(out) == n:
            break
    return out


def _record_iter(mod, path, backend, **kw):
    args = dict(batch_size=5, shuffle=False, resize=30, dtype="uint8")
    if backend == "service":
        args.update(workers=2, shuffle=True, rand_crop=True, rand_mirror=True)
    elif backend == "native":
        args.update(workers=0, shuffle=True, rand_crop=True, rand_mirror=True)
    else:
        args.update(workers=0, mean_r=0.0)
    args.update(kw)
    if mod is tio:
        args["ctx"] = "cpu"
    return mod.ImageRecordIter(path, SHAPE, **args)


@pytest.mark.parametrize("backend", ["threaded", "native", "service"])
def test_image_record_iter_matches_jax(rec_file, tmp_path, backend,
                                       monkeypatch):
    if backend == "native" and not tnative.available():
        pytest.skip("no g++ or libjpeg: the native reader is unavailable")
    path = rec_file
    if backend == "threaded":
        # a .crc sidecar opts out of the native reader
        path = str(tmp_path / "t.rec")
        with open(rec_file, "rb") as f, open(path, "wb") as g:
            g.write(f.read())
        trec.write_crc_sidecar(path)
    t = _record_iter(tio, path, backend)
    j = _record_iter(jio, path, backend)
    try:
        assert t.io_workers == (2 if backend == "service" else 0)
        assert (t._native is not None) == (backend == "native")
        for epoch in range(2):
            if epoch:
                t.reset()
                j.reset()
            got, ref = _iter_batches(t), _iter_batches(j)
            assert len(got) == len(ref) == 5
            key = (lambda b: tuple(b[1].tolist())) \
                if backend == "service" else None
            if key:
                got, ref = sorted(got, key=key), sorted(ref, key=key)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g[0], r[0])
                np.testing.assert_array_equal(g[1], r[1])
                assert g[2] == r[2]
            assert sorted(p for *_, p in got) == [0, 0, 0, 0, 1]
    finally:            # both epochs ran to their end: no thread reads
        t.close()
        j.close()


def test_image_record_iter_uint8_rejects_mean(rec_file):
    with pytest.raises(ValueError, match="raw pixels"):
        tio.ImageRecordIter(rec_file, SHAPE, 4, dtype="uint8", mean_r=1.0,
                            ctx="cpu")


# -- the in-memory and text iterators --------------------------------------------

@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_modes(handle, shuffle):
    data = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    label = np.arange(7, dtype=np.float32)
    np.random.seed(4)
    t = tio.NDArrayIter(data, label, 3, shuffle, handle, ctx="cpu")
    np.random.seed(4)
    j = jio.NDArrayIter(data, label, 3, shuffle, handle)
    for epoch in range(2):
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in t]
        ref = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad) for b in j]
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[0], r[0])
            np.testing.assert_array_equal(g[1], r[1])
            assert g[2] == r[2]
        for it in (t, j):       # the same global numpy draws for both
            np.random.seed(5 + epoch)
            it.reset()
    assert t.provide_data == j.provide_data


def test_csv_libsvm_mnist_iters(tmp_path):
    dpath, lpath = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dpath, np.random.RandomState(0).rand(10, 4), delimiter=",")
    np.savetxt(lpath, np.arange(10), delimiter=",")
    for rb in (True, False):
        t = list(tio.CSVIter(dpath, (4,), lpath, batch_size=4,
                             round_batch=rb, ctx="cpu"))
        j = list(jio.CSVIter(dpath, (4,), lpath, batch_size=4,
                             round_batch=rb))
        assert len(t) == len(j)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a.data[0].asnumpy(),
                                          b.data[0].asnumpy())
            np.testing.assert_array_equal(a.label[0].asnumpy(),
                                          b.label[0].asnumpy())
    svm = str(tmp_path / "d.libsvm")
    with open(svm, "w") as f:
        f.write("1 0:1.5 3:2.0\n0 1:1.0\n1 2:3.0 4:1.0\n")
    t = list(tio.LibSVMIter(svm, (5,), batch_size=2, ctx="cpu"))
    j = list(jio.LibSVMIter(svm, (5,), batch_size=2))
    assert len(t) == len(j) == 2
    for a, b in zip(t, j):
        assert a.data[0].shape == b.data[0].shape == (2, 5)
        assert a.data[0].stype == "csr"
        np.testing.assert_array_equal(a.data[0].asnumpy(),
                                      b.data[0].asnumpy())
        np.testing.assert_array_equal(
            a.data[0].tostype("default").asnumpy(), b.data[0].asnumpy())
        np.testing.assert_array_equal(a.label[0].asnumpy(),
                                      b.label[0].asnumpy())
    img, lab = str(tmp_path / "i.gz"), str(tmp_path / "l.gz")
    pix = np.random.RandomState(1).randint(0, 256, (6, 4, 5)).astype(np.uint8)
    with gzip.open(lab, "wb") as f:
        f.write(struct.pack(">II", 2049, 6) + bytes(range(6)))
    with gzip.open(img, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 6, 4, 5) + pix.tobytes())
    for flat in (False, True):
        t = list(tio.MNISTIter(img, lab, batch_size=4, flat=flat, ctx="cpu"))
        j = list(jio.MNISTIter(img, lab, batch_size=4, flat=flat))
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.data[0].asnumpy(),
                                       b.data[0].asnumpy(), rtol=0,
                                       atol=1e-7)
            assert a.pad == b.pad


def test_resize_and_prefetching_iters():
    data = np.arange(10, dtype=np.float32).reshape(5, 2)
    t = tio.ResizeIter(tio.NDArrayIter(data, batch_size=2, ctx="cpu"), 7)
    j = jio.ResizeIter(jio.NDArrayIter(data, batch_size=2), 7)
    got = [b.data[0].asnumpy() for b in t]
    ref = [b.data[0].asnumpy() for b in j]
    assert len(got) == 7
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    t = tio.PrefetchingIter([tio.NDArrayIter(data, batch_size=2, ctx="cpu"),
                             tio.NDArrayIter(data * 2, batch_size=2,
                                             ctx="cpu")])
    got = [[d.asnumpy() for d in b.data] for b in t]
    assert len(got) == 3
    np.testing.assert_array_equal(got[1][1], data[2:4] * 2)
    t.reset()
    assert len(list(t)) == 3


# -- retries --------------------------------------------------------------------

def test_retrying_reader_retries_transient_and_not_corrupt(rec_file):
    r = tres.RetryingReader(trec.MXRecordIO(rec_file, "r"), retries=2,
                            backoff=0.0, jitter=False)
    first = trec.MXRecordIO(rec_file, "r").read()
    tfault.install("io.read", at_calls=[1], times=1)
    try:
        retries = tevents.get("io.retry")
        assert r.read() == first                # rewound and retried
        assert tevents.get("io.retry") == retries + 1
    finally:
        tfault.clear()
    calls = []

    def corrupt():
        calls.append(1)
        raise tinteg.RecordCorrupt("x.rec", 8, "payload CRC mismatch")
    with pytest.raises(tinteg.RecordCorrupt):
        tres.retry_io(corrupt, retries=3, backoff=0.0)
    assert len(calls) == 1


# -- the input transform ----------------------------------------------------------

@pytest.fixture(scope="module")
def transform_ref():
    """A small ResNet v1b's parameters from the JAX package, a uint8
    batch, and the JAX block's eager training call with the normalize
    installed: (params, x, y, loss, {name: gradient})."""
    from incubator_mxnet_tpu.gluon.block import nameless_scope as jscope
    from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres
    with jscope():
        jmx.random.seed(0)
        jnet = jres.ResNetV1(jres.BottleneckV1, *RESNET_ARGS, classes=10)
        jnet.initialize()
    x = np.random.RandomState(0).randint(0, 256, (8, 3, 32, 40)).astype(
        np.uint8)
    y = np.arange(8, dtype=np.float32)
    jnet(jmx.nd.array(((x - 127.5) / 64).astype(np.float32)))
    params = jnet._collect_params_with_prefix()
    init = {n: p.data().asnumpy() for n, p in params.items()}
    jnet.set_input_transform(jfeed.normalize_transform(127.5, 64.0,
                                                       "float32"))
    with jmx.autograd.record():
        jl = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(
            jnet(jmx.nd.array(x, dtype="uint8")), jmx.nd.array(y))
    jl.backward()
    grads = {n: p.grad().asnumpy() for n, p in params.items()
             if p.grad_req != "null"}
    return init, x, y, jl.asnumpy(), grads


RESNET_ARGS = ([1, 1, 1, 1], [8, 16, 32, 64, 128])


def _port_resnet(params):
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    from incubator_mxnet_tpu_torch.weights import load_reference_params
    net = resnet.ResNetV1(resnet.BottleneckV1, *RESNET_ARGS, classes=10,
                          device="cpu")
    load_reference_params(net, params, device="cpu")
    return net


@pytest.mark.parametrize("hybrid", [False, True])
def test_set_input_transform_matches_jax(transform_ref, hybrid):
    """uint8 in, the normalize inside the step: 3 calls (eager, capture,
    replay when hybridized), each bit for bit the port's block without a
    transform fed the normalized f32 batch, and against the JAX block's
    eager call the loss within 1e-5 and every gradient within 1e-4 of
    its scale (test_torch_resnet's rule for this net: BatchNorm over a
    few values a channel sums in another order)."""
    params, x, y, ref, jgrads = transform_ref
    tnet, plain = _port_resnet(params), _port_resnet(params)
    tnet.set_input_transform(tfeed.normalize_transform(127.5, 64.0,
                                                       "float32"))
    if hybrid:
        tnet.hybridize(static_alloc=True, static_shape=True)
    tloss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    with tmx.autograd.record():
        pl = tloss(plain((tx.float() - 127.5) / 64.0), ty)
    tmx.autograd.backward(pl)
    pgrads = {n: p.grad.clone() for n, p in plain.named_parameters()
              if p.requires_grad}
    for _ in range(3):
        with tmx.autograd.record():
            tl = tloss(tnet(tx), ty)
        tmx.autograd.backward(tl)
        assert torch.equal(tl.detach(), pl.detach())
        grads = {n: p.grad for n, p in tnet.named_parameters()
                 if p.requires_grad}
        assert all(torch.equal(g, pgrads[n]) for n, g in grads.items())
        np.testing.assert_allclose(tl.detach().numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        assert grads.keys() == jgrads.keys()
        for n, g in grads.items():
            scale = max(np.abs(jgrads[n]).max(), 1e-3)
            assert np.abs(g.numpy() - jgrads[n]).max() <= 1e-4 * scale, n
    assert not tx.requires_grad
    if hybrid:
        cached = tnet._cached_graph
        assert (cached.eager_calls, cached.captures, cached.replays) == \
            (1, 2, 2)
        # the program's static input is the uint8 batch
        prog = next(iter(cached._programs.values()))[0]
        assert [s.dtype for s in prog.static_in] == [torch.uint8]
        tnet.set_input_transform(None)
        assert not cached._programs
