"""PyTorch port: InferenceEngine over bert_small on the CPU.

Bucketed batching, padding, backpressure, deadlines and shutdown, with
the engine's answers held row by row against the module's own forward.
"""
import threading
import time

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.serving import (DeadlineExceeded,
                                               EngineClosed, InferenceEngine,
                                               QueueFull)

pytestmark = pytest.mark.torch_port

T = 16


class _Recorder(torch.nn.Module):
    """Wraps a module and keeps a copy of every batch it is given.  The
    engine runs the module only while it captures a bucket's program;
    a replay re-issues the copy into the same tensor, so the kept copy of
    a bucket holds the batch that bucket served last."""

    def __init__(self, net):
        super().__init__()
        self.net = net
        self.batches = []

    def forward(self, x):
        self.batches.append(x.clone())
        return self.net(x)


@pytest.fixture(scope="module")
def net():
    tmx.random.seed(0)
    # dropout left on: the engine must serve in eval() mode
    return tmx.models.bert_small(device="cpu", vocab_size=100,
                                 max_length=T)


def _tokens(n, seed=0):
    return np.random.RandomState(seed).randint(0, 100, (n, T)) \
        .astype(np.int32)


def _wait(cond, timeout=10.0):
    end = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < end, "condition not reached in time"
        time.sleep(0.002)


def test_threaded_traffic_matches_direct_forward(net):
    toks = _tokens(15)
    eng = net.inference_engine(device="cpu", buckets=(1, 2, 4, 8),
                               example_shape=(T,), wire_dtype="int32")
    warm = eng.warmup()
    assert warm["buckets"] == [1, 2, 4, 8]
    futs = {}
    lock = threading.Lock()

    def client(idx):
        for i in idx:
            f = eng.submit(toks[i])
            with lock:
                futs[i] = f

    threads = [threading.Thread(target=client, args=(range(j, 12, 3),))
               for j in range(3)]
    for t in threads:
        t.start()
    fb = eng.submit_batch(toks[12:])
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    res = {i: f.result(timeout=30) for i, f in futs.items()}
    batch = fb.result(timeout=30)
    assert eng.close(timeout=10)
    net.eval()
    with torch.inference_mode():
        ref = net(torch.from_numpy(toks))
    for i in range(12):
        assert res[i].shape == (T, 100)
        torch.testing.assert_close(res[i], ref[i], rtol=0, atol=1e-5)
    assert batch.shape == (3, T, 100)
    # each result owns its storage: none pins the padded bucket output
    for r in list(res.values()) + [batch]:
        assert r.untyped_storage().nbytes() == r.numel() * r.element_size()
    torch.testing.assert_close(batch, ref[12:], rtol=0, atol=1e-5)
    st = eng.stats()
    assert st["requests"] == 13 and st["examples"] == 15
    assert st["warmup_batches"] == 4
    assert sum(st["bucket_batches"].values()) == st["batches"] >= 2
    assert st["e2e_p99_ms"] >= st["e2e_p50_ms"] > 0


def test_padding_up_to_bucket_and_batch_count(net, monkeypatch):
    rec = _Recorder(net)
    eng = InferenceEngine(rec, device="cpu", buckets=(1, 2, 4),
                          max_wait_us=100_000, example_shape=(T,),
                          wire_dtype="int32")
    eng.warmup()
    # one call per bucket, at its capture (the JAX engine's trace)
    assert [b.shape[0] for b in rec.batches] == [1, 2, 4]
    toks = _tokens(3, seed=1)
    # all three are queued before the dispatcher starts, so they coalesce
    # into one batch whatever the scheduling
    start = eng._ensure_dispatcher
    monkeypatch.setattr(eng, "_ensure_dispatcher", lambda: None)
    futs = [eng.submit(t) for t in toks]
    start()
    outs = [f.result(timeout=30) for f in futs]
    eng.close(timeout=10)
    # traffic replays the bucket-4 program: no further call, and the
    # program's copy of its input now holds the served batch
    assert len(rec.batches) == 3
    served = rec.batches[2]
    assert served.shape == (4, T) and served.dtype == torch.int32
    assert torch.equal(served[:3], torch.from_numpy(toks))
    assert not served[3].any()              # zero padding
    st = eng.stats()
    assert st["batches"] == 1 and st["bucket_batches"] == {1: 0, 2: 0, 4: 1}
    assert st["padded"] == 1 and st["examples"] == 3
    with torch.inference_mode():
        ref = net.eval()(torch.from_numpy(toks))
    for o, r in zip(outs, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-5)


def test_queue_full_at_cap(net):
    eng = InferenceEngine(net, device="cpu", buckets=(1,), queue_cap=2,
                          example_shape=(T,), wire_dtype="int32")
    toks = _tokens(4, seed=2)
    with eng._exec_lock:                    # the device is busy
        first = eng.submit(toks[0])
        _wait(lambda: eng._q.qsize() == 0)  # dispatcher holds it
        queued = [eng.submit(toks[1]), eng.submit(toks[2])]
        with pytest.raises(QueueFull):
            eng.submit(toks[3])
        assert eng.stats()["rejected"] == 1
    for f in [first] + queued:
        assert f.result(timeout=30).shape == (T, 100)
    eng.close(timeout=10)


def test_deadline_exceeded_on_expiry(net):
    eng = InferenceEngine(net, device="cpu", buckets=(1,),
                          example_shape=(T,), wire_dtype="int32")
    toks = _tokens(2, seed=3)
    with pytest.raises(DeadlineExceeded):
        eng.submit(toks[0], deadline=0)     # born expired
    with eng._exec_lock:
        first = eng.submit(toks[0])
        _wait(lambda: eng._q.qsize() == 0)
        late = eng.submit(toks[1], deadline=0.05)
        time.sleep(0.2)
    assert first.result(timeout=30).shape == (T, 100)
    with pytest.raises(DeadlineExceeded):
        late.result(timeout=30)
    assert eng.stats()["expired"] == 2
    eng.close(timeout=10)


def test_close_resolves_every_future(net):
    eng = InferenceEngine(net, device="cpu", buckets=(1,),
                          example_shape=(T,), wire_dtype="int32")
    toks = _tokens(4, seed=4)
    with eng._exec_lock:
        futs = [eng.submit(toks[0])]
        _wait(lambda: eng._q.qsize() == 0)
        futs += [eng.submit(t) for t in toks[1:]]
        closer = threading.Thread(target=eng.close, kwargs={"timeout": 0.2})
        closer.start()
        closer.join(timeout=10)
        assert not closer.is_alive()
        with pytest.raises(EngineClosed):
            eng.submit(toks[0])
    for f in futs[1:]:
        with pytest.raises(EngineClosed):
            f.result(timeout=10)
    # the batch that was on the device when close() began completes
    assert futs[0].result(timeout=30).shape == (T, 100)
    assert all(f.done() for f in futs)


def test_construction_without_cuda_raises(net, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="device='cpu'"):
        InferenceEngine(net)
    with pytest.raises(MXNetError, match="device='cpu'"):
        net.inference_engine()


def test_signature_checks(net):
    eng = InferenceEngine(net, device="cpu", buckets=(1, 2),
                          example_shape=(T,), wire_dtype="int32")
    with pytest.raises(ValueError, match="example shape"):
        eng.submit(np.zeros(T + 1, np.int32))
    with pytest.raises(ValueError, match="wire dtype"):
        eng.submit(np.zeros(T, np.int64))
    with pytest.raises(ValueError, match="largest bucket"):
        eng.submit_batch(np.zeros((3, T), np.int32))
    eng.close(timeout=10)


def test_bucket_knobs_from_config(net, monkeypatch):
    monkeypatch.setenv("MXNET_SERVE_MAX_BATCH", "8")
    eng = InferenceEngine(net, device="cpu")
    assert eng.buckets == (1, 2, 4, 8)
    monkeypatch.setenv("MXNET_SERVE_BUCKETS", "4,1")
    assert InferenceEngine(net, device="cpu", max_batch=2).buckets == (1, 4)
    assert InferenceEngine(net, device="cpu", buckets=[3]).buckets == (3,)
