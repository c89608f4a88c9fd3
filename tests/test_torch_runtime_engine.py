"""PyTorch port: `runtime`, `util` and `engine` against the JAX package's
modules of the same names.

`runtime.Features()` reads this process: the names both packages read
from the host alike (CPU, BF16, PROFILER, OPENCV, PIL, MULTIHOST, ...)
agree with the JAX package's, and its accelerator names report what this
host has (here: no card, so CUDA, CUDNN, NCCL and the port's KERNELS are
off, and the JAX names TPU, XLA, PALLAS are off in the port).  The
engine's listeners see each `nd` op of the registry and each replay of a
hybridized block's captured program; naive mode gives the same results.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import engine, runtime, util

pytestmark = pytest.mark.torch_port


def test_features_keys_and_values():
    from incubator_mxnet_tpu import runtime as jrt
    feats = runtime.Features()
    jfeats = jrt.Features()
    assert set(jfeats) <= set(feats)
    assert set(feats) - set(jfeats) == {"NCCL", "KERNELS"}
    for name in ("CPU", "BF16", "INT64_TENSOR_SIZE", "DIST_KVSTORE",
                 "SIGNAL_HANDLER", "PROFILER", "OPENCV", "PIL",
                 "MULTIHOST"):
        assert feats.is_enabled(name) == jfeats.is_enabled(name), name
    for name in ("TPU", "XLA", "PALLAS", "MKLDNN"):
        assert feats.is_enabled(name) is False, name
    cuda = torch.cuda.is_available()
    assert feats.is_enabled("CUDA") == cuda
    if not cuda:
        for name in ("CUDNN", "NCCL", "KERNELS"):
            assert feats.is_enabled(name) is False, name
    assert all(isinstance(f, runtime.Feature) and f.name == n
               for n, f in feats.items())
    assert repr(feats).startswith("[") and "✔ CPU" in repr(feats)
    with pytest.raises(KeyError):
        feats.is_enabled("NO_SUCH_FEATURE")


def test_np_flags_follow_the_jax_package():
    from incubator_mxnet_tpu import util as jutil
    seen = []
    for mod in (util, jutil):
        flags = [mod.is_np_array()]
        mod.set_np()
        flags.append(mod.is_np_array())
        mod.set_np(array=False)
        flags.append(mod.is_np_array())
        mod.set_np(shape=True, array=True)
        mod.reset_np()
        flags.append(mod.is_np_array())

        @mod.use_np
        def inner():
            return mod.is_np_array()

        @mod.use_np
        class Thing:
            def get(self):
                return mod.is_np_array()
        flags += [inner(), mod.is_np_array(), Thing().get(),
                  mod.is_np_array()]
        seen.append(flags)
    assert seen[0] == seen[1] == [False, True, False, False, True, False,
                                  True, False]


def test_makedirs(tmp_path):
    d = tmp_path / "a" / "b"
    util.makedirs(str(d))
    util.makedirs(str(d))
    assert d.is_dir()


def _hybrid_net():
    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(4, in_units=3, activation="relu",
                                   device="cpu"),
                tmx.gluon.nn.Dense(2, in_units=4, device="cpu"))
        net.initialize()
    return net


def test_listeners_see_nd_ops_and_replays():
    calls = []

    def listen(name, ctx, seconds):
        calls.append((name, str(ctx), seconds))
    a = tmx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3),
                     ctx="cpu")
    assert not engine.has_listeners()
    engine.add_dispatch_listener(listen)
    try:
        b = tmx.nd.relu(a - 2)
        tmx.nd.dot(b, b.T)
        net = _hybrid_net()
        net.hybridize()
        x = torch.ones(5, 3)
        with torch.no_grad():
            outs = [net(x) for _ in range(4)]
    finally:
        engine.remove_dispatch_listener(listen)
    names = [c[0] for c in calls]
    assert "relu" in names and "dot" in names
    assert all(c[1] == "cpu" and c[2] >= 0.0 for c in calls)
    # the first call runs eagerly, the second captures (a recording runs
    # its ops), the last two replay
    replays = [n for n in names if n.endswith("_cachedop")]
    assert replays == [net.name + "_cachedop"] * 2
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    n = len(calls)
    tmx.nd.relu(a)
    with torch.no_grad():
        net(x)
    assert len(calls) == n and not engine.has_listeners()
    engine.remove_dispatch_listener(listen)     # removing twice is fine


def test_backward_replay_is_a_dispatch():
    calls = []
    net = _hybrid_net()
    net.hybridize()
    x = torch.ones(5, 3)
    engine.add_dispatch_listener(lambda n, c, s: calls.append(n))
    try:
        for _ in range(3):
            with tmx.autograd.record():
                y = net(x).sum()
            y.backward()
    finally:
        engine._LISTENERS.clear()
    assert calls.count(net.name + "_cachedop_backward") >= 1


def test_naive_mode_gives_the_same_results(monkeypatch):
    def run():
        a = tmx.nd.array(np.linspace(-1, 1, 12, dtype=np.float32)
                         .reshape(3, 4), ctx="cpu")
        net = _hybrid_net()
        net.hybridize()
        with tmx.autograd.record():
            out = net(a._data[:, :3])
        return (tmx.nd.sigmoid(a) * 3).asnumpy(), out.detach()
    tmx.random.seed(3)
    plain = run()
    prev = engine.set_naive_mode(True)
    try:
        assert engine.naive_mode()
        tmx.random.seed(3)
        naive = run()
    finally:
        engine.set_naive_mode(prev)
    assert engine.naive_mode() is False
    np.testing.assert_array_equal(plain[0], naive[0])
    assert torch.equal(plain[1], naive[1])
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert tmx.config.get("MXNET_ENGINE_TYPE") == "NaiveEngine"


def test_bulk_restores_its_size_and_waitall():
    start = engine._BULK_SIZE
    assert start == tmx.config.get("MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN")
    with engine.bulk(64):
        assert engine._BULK_SIZE == 64
        with engine.bulk(1):
            assert engine._BULK_SIZE == 1
        assert engine._BULK_SIZE == 64
    assert engine._BULK_SIZE == start
    assert engine.set_bulk_size(7) == start
    assert engine.set_bulk_size(start) == 7
    engine.wait_all()
    tmx.nd.waitall()
