"""PyTorch port: the `dist_sync` KVStore over a gloo process group of 2
and 3 workers on this host, each a process that the port's launcher
(`incubator_mxnet_tpu_torch.tools.launch`) starts from this file (run as
`python tests/test_torch_kvstore_dist.py worker OUT`).

Every worker pushes gradients of its own (from a seed per rank); the
test holds the store's results against an in-process `local` store fed
every worker's copies (within 1e-6 of scale: the dist sum is in f32
in another order), and the 2-bit compressed sums against the JAX
package's `_quantize_2bit` on each worker's gradient (exact), with the
wire carrying only the packed 2-bit codes.  The workers also
show the barrier's deadline (an injected stuck peer makes the barrier
raise naming the rank), a stale membership generation refused before
the barrier, and a gluon.Trainer step over the workers.  Each worker
has a deadline of its own (`signal.alarm`), so a hung rank fails the
test instead of stalling the run.
"""
import os
import signal
import sys

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.torch_port

THR = 0.5
TOL = 1e-6


def _grads(rank, pushes=3, shape=(4, 3)):
    rs = np.random.RandomState(100 + rank)
    return [(rs.randn(*shape) * 0.6).astype(np.float32)
            for _ in range(pushes)]


def _worker(out):
    signal.alarm(90)
    import incubator_mxnet_tpu_torch as tmx
    from incubator_mxnet_tpu_torch import fault, kvstore
    kv = kvstore.create("dist_sync")
    rank, nw = kv.rank, kv.num_workers
    assert nw == int(os.environ["DMLC_NUM_WORKER"]) and nw > 1

    def arr(a):
        return tmx.nd.array(a, ctx="cpu")

    got = {}
    kv.init(3, arr(np.full((4, 3), 7.0 if rank == 0 else 99.0,
                           np.float32)))
    o = arr(np.zeros((4, 3), np.float32))
    kv.pull(3, out=o)
    got["init"] = o.asnumpy()
    sums = []
    for g in _grads(rank):
        kv.push(3, arr(g))
        kv.pull(3, out=o)
        sums.append(o.asnumpy())
    got["sums"] = sums
    a = arr(_grads(rank, 1)[0])
    kv.pushpull(5, a)
    got["pushpull"] = a.asnumpy()
    kv.set_gradient_compression({"type": "2bit", "threshold": THR})
    kv.init(1, arr(np.zeros((4, 3), np.float32)))
    compressed, wire = [], []
    import torch.distributed as dist

    def record(name, fn):
        def call(*args, **kwargs):
            t = args[1] if name == "all_gather" else args[0]
            wire.append((name, str(t.dtype), t.numel()))
            return fn(*args, **kwargs)
        return call
    sent = {n: getattr(dist, n) for n in ("all_gather", "all_reduce")}
    for n, fn in sent.items():
        setattr(dist, n, record(n, fn))
    try:
        for g in _grads(rank):
            kv.push(1, arr(g))
            kv.pull(1, out=o)
            compressed.append(o.asnumpy())
    finally:
        for n, fn in sent.items():
            setattr(dist, n, fn)
    got["compressed"], got["wire"] = compressed, wire

    # an injected stuck peer: the barrier's deadline names this rank
    fault.install("kvstore.barrier_hang", times=1)
    try:
        kv._barrier(timeout=0.5)
    except tmx.MXNetError as e:
        got["timeout"] = str(e)
    fault.clear()
    kv._barrier(timeout=60)
    kv.advance_generation()
    try:
        kv._barrier(generation=0)
    except kvstore.StaleMembership as e:
        got["stale"] = str(e)
    kv._barrier(generation=1, timeout=60)

    # a gluon.Trainer step over the workers (ref: dist_sync_kvstore.py)
    tmx.random.seed(123)
    net = tmx.gluon.nn.Dense(1, use_bias=False, in_units=3, device="cpu")
    got["w0"] = net.weight.detach().numpy().copy()
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.5}, kvstore="dist_sync")
    x = torch.full((2, 3), float(rank + 1))
    with tmx.autograd.record():
        loss = (net(x) ** 2).sum()
    tmx.autograd.backward(loss)
    tr.step(2)
    got["w1"] = net.weight.detach().numpy().copy()
    torch.save(got, "%s.rank%d" % (out, rank))
    kv._barrier(timeout=60)
    import torch.distributed as dist
    dist.destroy_process_group()


@pytest.mark.parametrize("nworkers", [2, 3])
def test_dist_sync_over_gloo_workers(tmp_path, nworkers):
    from incubator_mxnet_tpu.kvstore.kvstore import _quantize_2bit
    from incubator_mxnet_tpu_torch import kvstore
    from incubator_mxnet_tpu_torch.tools import launch
    here = os.path.abspath(__file__)
    repo = os.path.dirname(os.path.dirname(here))
    out = str(tmp_path / "kv")
    env = {"PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                           ""),
           "OMP_NUM_THREADS": "1"}
    with open(str(tmp_path / "log"), "w") as log:
        rc = launch.launch(nworkers, [sys.executable, here, "worker", out],
                           env=env, timeout=150, out=log)
    text = open(str(tmp_path / "log")).read()
    assert rc == 0, text[-4000:]
    got = [torch.load("%s.rank%d" % (out, r), weights_only=False)
           for r in range(nworkers)]

    # the same pushes as copies of one in-process store
    local = kvstore.create("local")
    local.init(3, torch.full((4, 3), 7.0))
    pushes = [_grads(r) for r in range(nworkers)]
    for i in range(3):
        local.push(3, [torch.from_numpy(p[i]) for p in pushes])
        want = torch.zeros(4, 3)
        local.pull(3, out=want)
        for r in range(nworkers):
            err = np.abs(got[r]["sums"][i] - want.numpy()).max() / \
                np.abs(want.numpy()).max()
            assert err <= TOL, (r, i, err)
    first = [_grads(r, 1)[0] for r in range(nworkers)]
    for r in range(nworkers):
        np.testing.assert_array_equal(got[r]["init"], np.full((4, 3), 7.0))
        want = np.sum(first, axis=0, dtype=np.float64)
        assert np.abs(got[r]["pushpull"] - want).max() <= \
            TOL * np.abs(want).max()

    # 2-bit: the JAX quantizer on each worker's gradients, summed
    residual = [np.zeros((4, 3), np.float32) for _ in range(nworkers)]
    for i in range(3):
        total = np.zeros((4, 3), np.float64)
        for r in range(nworkers):
            q, residual[r] = _quantize_2bit(pushes[r][i], residual[r], THR)
            total += np.asarray(q, np.float64)
        for r in range(nworkers):
            np.testing.assert_array_equal(got[r]["compressed"][i],
                                          total.astype(np.float32))
    # each compressed push sent the 12 elements' codes in 3 bytes
    for r in range(nworkers):
        assert got[r]["wire"] == [("all_gather", "torch.uint8", 3)] * 3, \
            got[r]["wire"]

    for r in range(nworkers):
        assert "rank %d/%d" % (r, nworkers) in got[r]["timeout"]
        assert "generation 0" in got[r]["stale"]
        # w1 = w0 - lr / 2 * sum_r grad_r, grad_r = 2 sum_b pred_b x_b
        w0 = got[r]["w0"]
        grad = np.zeros_like(w0)
        for q in range(nworkers):
            xq = np.full((2, 3), float(q + 1), np.float32)
            grad += 2.0 * (xq.dot(w0.T) * xq).sum(axis=0, keepdims=True)
        np.testing.assert_allclose(got[r]["w1"], w0 - 0.25 * grad,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[r]["w1"], got[0]["w1"])


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv[2])
