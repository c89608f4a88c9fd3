"""PyTorch port: the in-process KVStore against the JAX package's, case
by case as tests/python/unittest/test_kvstore.py writes them, on the
same numpy inputs: init/pull, push over several copies, pushpull, list
keys, the store's optimizer (SGD and Adam, within 1e-6 of scale),
row_sparse pulls and pushes (exact), 2-bit compression and its residual
(exact), the optimizer-state round trip, rank and workers of one
process, membership generations."""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import kvstore as jkv
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu.ndarray import sparse as jsparse
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import kvstore as tkv
from incubator_mxnet_tpu_torch.kvstore.kvstore import _quantize_2bit

pytestmark = pytest.mark.torch_port

TOL = 1e-6


def _t(a):
    return tmx.nd.array(np.asarray(a, np.float32), ctx="cpu")


def _j(a):
    return jnd.array(np.asarray(a, np.float32))


def _err(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-6))


def _both(kind):
    return jkv.create(kind), tkv.create(kind)


def _pull(store, key, shape, make):
    out = make(np.zeros(shape))
    store.pull(key, out=out)
    return out.asnumpy()


def test_init_pull():
    rs = np.random.RandomState(0)
    v = rs.randn(2, 3)
    js, ts = _both("local")
    js.init(3, _j(v))
    ts.init(3, _t(v))
    np.testing.assert_array_equal(_pull(ts, 3, (2, 3), _t),
                                  _pull(js, 3, (2, 3), _j))


def test_push_aggregates_four_copies():
    rs = np.random.RandomState(1)
    copies = [rs.randn(5) for _ in range(4)]
    js, ts = _both("device")
    js.init("w", _j(np.zeros(5)))
    ts.init("w", _t(np.zeros(5)))
    js.push("w", [_j(c) for c in copies])
    ts.push("w", [_t(c) for c in copies])
    np.testing.assert_array_equal(_pull(ts, "w", (5,), _t),
                                  _pull(js, "w", (5,), _j))
    # copies given as tensors on CPU replica contexts sum the same way
    ts.push("w", [torch.from_numpy(c.astype(np.float32)) for c in copies])
    np.testing.assert_array_equal(_pull(ts, "w", (5,), _t),
                                  _pull(js, "w", (5,), _j))


def test_pushpull_and_list_keys():
    rs = np.random.RandomState(2)
    a, b = rs.randn(3), rs.randn(3)
    js, ts = _both("nccl")
    js.init(0, _j(np.zeros(3)))
    ts.init(0, _t(np.zeros(3)))
    ja, jb, ta, tb = _j(a), _j(b), _t(a), _t(b)
    js.pushpull(0, [ja, jb], out=[ja, jb])
    ts.pushpull(0, [ta, tb], out=[ta, tb])
    for t, j in ((ta, ja), (tb, jb)):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    # the store itself is untouched by pushpull
    np.testing.assert_array_equal(_pull(ts, 0, (3,), _t), np.zeros(3))
    keys = [1, 2, 3]
    vals = [rs.randn(2) for _ in keys]
    js.init(keys, [_j(v) for v in vals])
    ts.init(keys, [_t(v) for v in vals])
    jo = [_j(np.zeros(2)) for _ in keys]
    to = [_t(np.zeros(2)) for _ in keys]
    js.pull(keys, out=jo)
    ts.pull(keys, out=to)
    for t, j in zip(to, jo):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


@pytest.mark.parametrize("name,kw", [
    ("sgd", dict(learning_rate=0.1, momentum=0.9, wd=1e-3)),
    ("adam", dict(learning_rate=0.01, wd=1e-3)),
])
def test_store_side_optimizer(name, kw):
    rs = np.random.RandomState(3)
    w0 = rs.randn(4, 3)
    grads = [[rs.randn(4, 3) for _ in range(2)] for _ in range(3)]
    js, ts = _both("local")
    js.init(0, _j(w0))
    ts.init(0, _t(w0))
    js.set_optimizer(jopt.create(name, **kw))
    ts.set_optimizer(tmx.optimizer.create(name, **kw))
    for g in grads:
        js.push(0, [_j(x) for x in g])
        ts.push(0, [_t(x) for x in g])
    assert _err(_pull(ts, 0, (4, 3), _t), _pull(js, 0, (4, 3), _j)) <= TOL


def test_row_sparse_pull_and_sparse_push():
    w = np.arange(12, dtype=np.float32).reshape(4, 3)
    js, ts = _both("local")
    js.init("emb", _j(w))
    ts.init("emb", _t(w))
    jo, to = _j(np.zeros((4, 3))), _t(np.zeros((4, 3)))
    js.row_sparse_pull("emb", out=jo, row_ids=jnd.array([0, 2],
                                                        dtype="int64"))
    ts.row_sparse_pull("emb", out=to, row_ids=tmx.nd.array(
        [0, 2], dtype="int32", ctx="cpu"))
    np.testing.assert_array_equal(to.asnumpy(), jo.asnumpy())
    # a sparse push without an optimizer replaces the pushed rows
    rows = np.array([1, 3], np.int32)
    vals = np.full((2, 3), -5.0, np.float32)
    jrsp = jsparse.row_sparse_array((jnd.array(vals), jnd.array(
        rows, dtype="int32")), shape=(4, 3))
    trsp = tmx.nd.sparse.row_sparse_array((vals, rows), shape=(4, 3),
                                          ctx="cpu")
    js.push("emb", jrsp)
    ts.push("emb", trsp)
    np.testing.assert_array_equal(_pull(ts, "emb", (4, 3), _t),
                                  _pull(js, "emb", (4, 3), _j))
    # two sparse copies sum over the union of their rows
    js.push("emb", [jrsp, jrsp])
    ts.push("emb", [trsp, trsp])
    np.testing.assert_array_equal(_pull(ts, "emb", (4, 3), _t),
                                  _pull(js, "emb", (4, 3), _j))


def test_quantize_2bit_and_residual_over_three_pushes():
    from incubator_mxnet_tpu.kvstore.kvstore import _quantize_2bit as jq
    rs = np.random.RandomState(4)
    thr = 0.5
    jres = np.zeros(7, np.float32)
    tres = torch.zeros(7)
    for _ in range(3):
        g = rs.randn(7).astype(np.float32) * 0.6
        jqv, jres = jq(np.asarray(g), jres, thr)
        tq, tres = _quantize_2bit(torch.from_numpy(g), tres, thr)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jqv))
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    # a one-process dist store compresses its pushes as the JAX one does
    js, ts = _both("dist_sync")
    for s in (js, ts):
        s.set_gradient_compression({"type": "2bit", "threshold": thr})
    js.init(0, _j(np.zeros(3)))
    ts.init(0, _t(np.zeros(3)))
    for g in ([0.7, 0.3, -0.7], [0.2, 0.3, 0.0], [0.1, -0.1, -0.4]):
        js.push(0, _j(g))
        ts.push(0, _t(g))
        np.testing.assert_array_equal(_pull(ts, 0, (3,), _t),
                                      _pull(js, 0, (3,), _j))
    with pytest.raises(tmx.MXNetError):
        tkv.create("device").set_gradient_compression({"type": "2bit"})
    with pytest.raises(tmx.MXNetError, match="unsupported"):
        ts.set_gradient_compression({"type": "1bit"})


def test_optimizer_states_round_trip(tmp_path):
    fname = str(tmp_path / "kv.states")
    ts = tkv.create("local")
    ts.init(0, _t(np.zeros(2)))
    with pytest.raises(tmx.MXNetError, match="optimizer not set"):
        ts.save_optimizer_states(fname)
    ts.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    ts.push(0, _t(np.ones(2)))
    ts.save_optimizer_states(fname)
    before = ts._updater.states[0].clone()
    ts.push(0, _t(np.ones(2)))
    ts.load_optimizer_states(fname)
    torch.testing.assert_close(ts._updater.states[0], before)
    # the same next step as the JAX store from the same states
    js = jkv.create("local")
    js.init(0, _j(np.zeros(2)))
    js.set_optimizer(jopt.SGD(learning_rate=0.1, momentum=0.9))
    js.push(0, _j(np.ones(2)))
    ts2 = tkv.create("local")
    ts2.init(0, _t(np.zeros(2)))
    ts2.set_optimizer(tmx.optimizer.SGD(learning_rate=0.1, momentum=0.9))
    ts2.push(0, _t(np.ones(2)))
    ts2.save_optimizer_states(fname)
    ts2.load_optimizer_states(fname)
    js.push(0, _j(np.ones(2)))
    ts2.push(0, _t(np.ones(2)))
    assert _err(_pull(ts2, 0, (2,), _t), _pull(js, 0, (2,), _j)) <= TOL


def test_rank_workers_and_invalid_type():
    for kind in ("local", "dist_sync"):
        js, ts = _both(kind)
        assert (ts.rank, ts.num_workers) == (js.rank, js.num_workers) \
            == (0, 1)
    with pytest.raises(tmx.MXNetError, match="unknown kvstore"):
        tkv.create("bogus")
    with pytest.raises(jmx.MXNetError):
        jkv.create("bogus")


def test_push_replaces_and_pull_gives_a_fresh_buffer():
    js, ts = _both("local")
    js.init("k", _j(np.full(3, 2.0)))
    ts.init("k", _t(np.full(3, 2.0)))
    for s, mk in ((js, _j), (ts, _t)):
        s.push("k", mk(np.full(3, 8.0)))
    np.testing.assert_array_equal(_pull(ts, "k", (3,), _t), np.full(3, 8.0))
    for s, mk in ((js, _j), (ts, _t)):
        s.push("k", [mk(np.ones(3)), mk(np.full(3, 4.0))])
    np.testing.assert_array_equal(_pull(ts, "k", (3,), _t),
                                  _pull(js, "k", (3,), _j))
    ts.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1))
    out = _t(np.zeros(3))
    ts.pull("k", out=out)
    held = out._data
    ts.push("k", _t(np.ones(3)))      # the store updates its weight
    assert out._data is held
    np.testing.assert_array_equal(out.asnumpy(), np.full(3, 5.0))
    assert out._data.data_ptr() != ts._store["k"]._data.data_ptr()


def test_stale_membership():
    js, ts = _both("local")
    for s in (js, ts):
        assert s.generation == 0
        s._barrier(generation=0)
        assert s.advance_generation() == 1
        s.check_generation(None)
    with pytest.raises(tkv.StaleMembership, match="generation 0"):
        ts.check_generation(0)
    with pytest.raises(jkv.StaleMembership):
        js.check_generation(0)
    with pytest.raises(tkv.StaleMembership):
        ts._barrier(generation=0)
    ts._barrier(generation=1)
