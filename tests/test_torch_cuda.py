"""PyTorch port on the card: the CUDA kernels against their plain versions,
and the serving and training paths (BERT in f32 and bf16, ResNet,
Transformer NMT and its cached decode step) through them, and float16
through the kernels' f16 instances.

Marked `cuda`; each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so on a machine with the card (and no
JAX) it runs without the repository's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import re
import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops import attention as tatt
from incubator_mxnet_tpu_torch.ops import conv_stats as tcs
from incubator_mxnet_tpu_torch.ops import nn as tnn
from incubator_mxnet_tpu_torch.monitor import events
from chip_smoke import (WD_SPARSE_TOL, _device_kernels, _low_tolerance,
                        _port_kernel_calls)

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]


def _name(dtype):
    """'bfloat16' for torch.bfloat16, and so on."""
    return str(dtype).replace("torch.", "")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    # f32 stays f32, in cuBLAS and in cuDNN's convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("BH,T,d,dtype,causal", [
    (8, 512, 64, torch.float32, False),
    (8, 200, 64, torch.float32, True),
    (8, 200, 128, torch.bfloat16, True),
    (8, 77, 16, torch.float32, False),
    (8, 256, 32, torch.bfloat16, False),
    (8, 200, 128, torch.float32, True),
    (4, 333, 128, torch.float32, False),
    (4, 333, 128, torch.bfloat16, True),
    (8, 512, 64, torch.float16, False),
    (8, 200, 64, torch.float16, True),
    (4, 333, 128, torch.float16, False),
])
def test_flash_kernel_matches_plain_version(card, BH, T, d, dtype, causal):
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    q, k, v = (torch.randn(BH, T, d, device=card, generator=gen).to(dtype)
               for _ in range(3))
    before = tatt.flash_fwd_launches
    out, lse = tatt.flash_attention_fwd(q, k, v, d ** -0.5, causal)
    torch.cuda.synchronize()
    assert tatt.flash_fwd_launches == before + 1
    assert out.dtype == dtype and lse.shape == (BH, T)
    ref_out, ref_lse = tatt.flash_attention_fwd_plain(q, k, v, d ** -0.5,
                                                      causal)
    ref = ref_out.float()
    if dtype == torch.float32:
        tol = 1e-4      # the same sums in another order
    else:
        # both outputs rounded to the dtype, and P rounded against the
        # running max in the kernel but the final max in the plain
        # version: 4 u (|ref| + rms(ref)), u the unit roundoff (2**-6 ...
        # in bf16, 2**-9 ... in f16), is at least 2 ulps of each element,
        # and the rms covers the elements near zero
        tol = _low_tolerance(ref, _name(dtype))
    assert bool(((out.float() - ref).abs() <= tol).all())
    # lse comes from f32 scores in both dtypes
    assert (lse - ref_lse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_kernel_is_deterministic(card, dtype):
    # one owner per output element: two launches on the same inputs give
    # the same bits in out and lse
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    q, k, v = (torch.randn(16, 333, 64, device=card, generator=gen)
               .to(dtype) for _ in range(3))
    first = tatt.flash_attention_fwd(q, k, v, 0.125, True)
    second = tatt.flash_attention_fwd(q, k, v, 0.125, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_without_kernel_takes_naive_attention(card, causal):
    # 768 units over 16 heads: d 48 has no kernel instance, so
    # flash_attention computes it with naive_attention and plain autograd,
    # and no kernel launches
    B, H, T, d = 2, 16, 64, 48
    gen = torch.Generator(device=card)
    gen.manual_seed(4)
    q, k, v, w = (torch.randn(B, H, T, d, device=card, generator=gen)
                  for _ in range(4))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (tatt.flash_fwd_launches, tatt.flash_bwd_dq_launches,
              tatt.flash_bwd_dkv_launches)
    out = tatt.flash_attention(*qkv, causal=causal)
    (out * w).sum().backward()
    torch.cuda.synchronize()
    assert (tatt.flash_fwd_launches, tatt.flash_bwd_dq_launches,
            tatt.flash_bwd_dkv_launches) == before
    ref_qkv = [t.cpu().requires_grad_() for t in (q, k, v)]
    ref = tatt.naive_attention(*ref_qkv, d ** -0.5, causal=causal)
    (ref * w.cpu()).sum().backward()
    assert (out.detach().cpu() - ref.detach()).abs().max().item() <= 1e-4
    for got, r in zip(qkv, ref_qkv):
        assert (got.grad.cpu() - r.grad).abs().max().item() <= \
            1e-4 * r.grad.abs().max().item()


def test_flash_kernel_raises_on_what_it_does_not_take(card):
    q = torch.zeros((2, 16, 48), device=card)
    before = tatt.flash_fwd_launches
    with pytest.raises(ValueError, match="head dim"):
        tatt.flash_attention_fwd(q, q, q, 0.1)
    h = torch.zeros((2, 16, 64), device=card, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        tatt.flash_attention_fwd(h, h, h, 0.1)
    k = torch.zeros((2, 16, 64), device=card)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(2 * 16 * 64 + 1, device=card)
        tatt.flash_attention_fwd(k, k, flat[1:].view(2, 16, 64), 0.1)
    assert tatt.flash_fwd_launches == before


def test_engine_serves_through_kernel(card):
    tmx.random.seed(0)
    net = tmx.models.bert_small(vocab_size=100, max_length=64)
    assert next(net.parameters()).device == card    # cuda:0 by default
    eng = net.inference_engine(buckets=(1, 2, 4), example_shape=(64,),
                               wire_dtype="int32")
    toks = np.random.RandomState(0).randint(0, 100, (5, 64)) \
        .astype(np.int32)
    before = tatt.flash_fwd_launches
    eng.warmup()
    # each bucket's capture issues its 2 launches (2 layers) into its
    # graph; a replay runs no wrapper and counts nothing
    assert tatt.flash_fwd_launches - before == 2 * 3
    futs = [eng.submit(t) for t in toks]
    outs = [f.result(timeout=60) for f in futs]
    assert eng.close(timeout=30)
    assert tatt.flash_fwd_launches - before == 2 * 3
    # a replayed batch launches the kernel twice, by the profiler's names
    x = np.zeros((4, 64), np.int32)
    rows, _ = _device_kernels(torch, lambda: eng._run(0, x, []), 3)
    assert _port_kernel_calls(rows, 3) == {"flash_fwd_kernel": 2}
    cpu = tmx.models.bert_small(vocab_size=100, max_length=64,
                                device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    with torch.inference_mode():
        ref = cpu.eval()(torch.from_numpy(toks))
    for o, r in zip(outs, ref):
        assert o.device == card
        assert (o.cpu() - r).abs().max().item() <= 1e-4


def test_engine_captures_per_replica_bucket_flat_in_traffic(card):
    tmx.random.seed(1)
    net = tmx.models.bert_small(vocab_size=100, max_length=64)
    eng = tmx.serving.InferenceEngine(
        net, devices=["cuda:0", "cuda:0"], buckets=(1, 2, 4),
        example_shape=(64,), wire_dtype="int32")
    traces = events.get("serve.traces")
    eng.warmup()
    assert events.get("serve.traces") - traces == 2 * 3
    toks = np.random.RandomState(1).randint(0, 100, (20, 64)) \
        .astype(np.int32)
    outs = [f.result(timeout=60) for f in [eng.submit(t) for t in toks]]
    assert eng.close(timeout=30)
    assert events.get("serve.traces") - traces == 2 * 3
    with torch.inference_mode():
        ref = net.eval()(torch.from_numpy(toks).to(card))
    for o, r in zip(outs, ref):
        assert (o - r).abs().max().item() <= 1e-4
    assert all(n > 0 for n in eng.stats()["device_batches"])


def test_capture_while_another_engine_serves(card):
    """Engine b warms up (captures) while engine a serves from another
    thread on the same card: the device gate holds a's work off each
    capture, so no capture fails."""
    tmx.random.seed(2)
    a_net = tmx.models.bert_small(vocab_size=100, max_length=64)
    b_net = tmx.models.bert_small(vocab_size=100, max_length=64)
    a = a_net.inference_engine(buckets=(1, 2, 4), example_shape=(64,),
                               wire_dtype="int32")
    b = b_net.inference_engine(buckets=(1, 2, 4, 8), example_shape=(64,),
                               wire_dtype="int32")
    a.warmup()
    toks = np.random.RandomState(2).randint(0, 100, (8, 64)) \
        .astype(np.int32)
    stop, errors, served = threading.Event(), [], [0]

    def traffic():
        try:
            while not stop.is_set():
                for f in [a.submit(t) for t in toks[:3]]:
                    f.result(timeout=60)
                    served[0] += 1
        except Exception as e:      # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=traffic)
    t.start()
    try:
        b.warmup()
        outs = [f.result(timeout=60) for f in [b.submit(x) for x in toks]]
    finally:
        stop.set()
        t.join(timeout=60)
    assert not errors, errors
    assert served[0] > 0
    with torch.inference_mode():
        ref = b_net.eval()(torch.from_numpy(toks).to(card))
    for o, r in zip(outs, ref):
        assert (o - r).abs().max().item() <= 1e-4
    a.close()
    b.close()


def test_refresh_params_from_swaps_in_place_on_card(card):
    tmx.random.seed(3)
    v1 = tmx.models.bert_small(vocab_size=100, max_length=64)
    v2 = tmx.models.bert_small(vocab_size=100, max_length=64).eval()
    eng = v1.inference_engine(buckets=(1, 2), example_shape=(64,),
                              wire_dtype="int32")
    eng.warmup()
    ptrs = {n: t.data_ptr() for n, t in eng._reps[0].params.items()}
    traces = events.get("serve.traces")
    eng.refresh_params_from(v2)
    toks = np.random.RandomState(3).randint(0, 100, (2, 64)) \
        .astype(np.int32)
    out = eng.submit_batch(toks).result(timeout=60)
    assert eng.close(timeout=30)
    assert events.get("serve.traces") == traces
    assert {n: t.data_ptr() for n, t in eng._reps[0].params.items()} \
        == ptrs
    with torch.inference_mode():
        ref = v2(torch.from_numpy(toks).to(card))
    assert (out - ref).abs().max().item() <= 1e-5


def test_refresh_params_from_waits_for_the_callers_stream(card):
    # the swap source is loaded on the default stream behind a stall and
    # not synchronized: the copy onto the replica must wait for the load
    tmx.random.seed(3)
    v1 = tmx.models.bert_small(vocab_size=100, max_length=64)
    v2 = tmx.models.bert_small(vocab_size=100, max_length=64).eval()
    toks = np.random.RandomState(4).randint(0, 100, (2, 64)) \
        .astype(np.int32)
    with torch.inference_mode():
        ref = v2(torch.from_numpy(toks).to(card))
    weights = {k: v.clone() for k, v in v2.state_dict().items()}
    with torch.no_grad():
        for t in v2.state_dict().values():
            t.zero_()
    eng = v1.inference_engine(buckets=(2,), example_shape=(64,),
                              wire_dtype="int32")
    eng.warmup()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    v2.load_state_dict(weights)
    eng.refresh_params_from(v2)
    out = eng.submit_batch(toks).result(timeout=60)
    assert eng.close(timeout=30)
    assert (out - ref).abs().max().item() <= 1e-5


def test_a_served_result_outlives_default_stream_reads(card):
    # a client reads its result on the default stream behind a stall and
    # drops it: the next batch's result copy must not take its block
    # before that read has run
    tmx.random.seed(5)
    net = tmx.models.bert_small(vocab_size=100, max_length=64).eval()
    eng = net.inference_engine(buckets=(1,), example_shape=(64,),
                               wire_dtype="int32")
    eng.warmup()
    a, b = np.random.RandomState(5).randint(0, 100, (2, 64)) \
        .astype(np.int32)
    want = eng.submit(a).result(timeout=60).clone()
    out = eng.submit(a).result(timeout=60)
    torch.cuda._sleep(200_000_000)
    seen = out * 1
    del out
    eng.submit(b).result(timeout=60)
    torch.cuda.synchronize()
    assert eng.close(timeout=30)
    assert torch.equal(seen, want)


def test_registry_admission_on_card_budget(card):
    tmx.random.seed(4)
    net = tmx.models.bert_small(vocab_size=100, max_length=64)
    reg = tmx.serving.ModelRegistry(devices=[tmx.gpu(0)])
    total = torch.cuda.mem_get_info(card)[1]
    assert reg._budgets == [total]              # the card's own budget
    rec = reg.register("m", net, example_shape=(64,), wire_dtype="int32",
                       buckets=(1, 2))
    assert rec["basis"] == "projected"
    reg.warmup("m")
    st = reg.stats()
    assert st["models"]["m"]["basis"] == "measured"
    assert st["ledger"][0]["committed"] == st["models"]["m"][
        "footprint_bytes"] > rec["detail"]["param_bytes"]
    tight = tmx.serving.ModelRegistry(devices=[tmx.gpu(0)],
                                      hbm_budget=rec["footprint_bytes"] // 2)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated(card)
    with pytest.raises(tmx.serving.AdmissionDenied, match="'m2'"):
        tight.register("m2", net, example_shape=(64,), wire_dtype="int32",
                       buckets=(1, 2))
    assert torch.cuda.memory_allocated(card) == allocated
    out = reg.submit("m", np.zeros(64, np.int32)).result(timeout=60)
    assert out.shape == (64, 100)
    reg.close()
    tight.close()


def _bwd_inputs(card, BH, T, d, dtype, causal, seed=1):
    """q, k, v, dO (randn/2 from `seed`) and the forward kernel's out and
    lse."""
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    q, k, v, do = (torch.randn(BH, T, d, device=card, generator=gen)
                   .mul_(0.5).to(dtype) for _ in range(4))
    out, lse = tatt.flash_attention_fwd(q, k, v, d ** -0.5, causal)
    return q, k, v, do, out, lse


# every head dim x both dtypes x causal or not, at a ragged T (77, not a
# multiple of 16) and at two whole tiles of 128 query rows
@pytest.mark.parametrize("BH,T,d,dtype,causal", [
    (8, 512, 64, torch.float32, False),
    (8, 512, 64, torch.float32, True),
    (8, 200, 128, torch.float32, True),
    (8, 77, 16, torch.float32, False),
    (8, 200, 64, torch.bfloat16, True),
    (8, 256, 32, torch.bfloat16, False),
    (4, 130, 128, torch.bfloat16, False),
] + [(3, T, d, dtype, causal) for T in (77, 256)
     for d in tatt.KERNEL_HEAD_DIMS
     for dtype in (torch.float32, torch.bfloat16)
     for causal in (False, True)]
    + [(3, T, d, torch.float16, causal) for T in (77, 256) for d in (64, 128)
       for causal in (False, True)])
def test_flash_bwd_kernels_match_plain_version(card, BH, T, d, dtype,
                                               causal):
    q, k, v, do, out, lse = _bwd_inputs(card, BH, T, d, dtype, causal)
    scale = d ** -0.5
    before = (tatt.flash_bwd_dq_launches, tatt.flash_bwd_dkv_launches)
    dq, dk, dv = tatt.flash_attention_bwd(q, k, v, out, lse, do, scale,
                                          causal)
    torch.cuda.synchronize()
    assert (tatt.flash_bwd_dq_launches, tatt.flash_bwd_dkv_launches) == \
        (before[0] + 1, before[1] + 1)
    ref = tatt.flash_attention_bwd_plain(q, k, v, out, lse, do, scale,
                                         causal)
    for got, r in zip((dq, dk, dv), ref):
        assert got.dtype == dtype and got.shape == (BH, T, d)
        r = r.float()
        if dtype == torch.float32:
            # the same sums in another order
            tol = 1e-4 * r.abs().max()
        else:
            # P and dS rounded at the same points, outputs rounded to the
            # dtype: 4 u (|ref| + rms(ref)) is at least 2 ulps
            tol = _low_tolerance(r, _name(dtype))
        assert bool(((got.float() - r).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_bwd_kernels_are_deterministic(card, dtype):
    # one owner per output element, no atomics: two launches on the same
    # inputs give the same bits in dq, dk, dv and D
    q, k, v, do, out, lse = _bwd_inputs(card, 16, 333, 64, dtype, True)
    first = tatt.flash_attention_bwd_dq(q, k, v, out, lse, do, 0.125, True)
    first += tatt.flash_attention_bwd_dkv(q, k, v, do, lse, first[1], 0.125,
                                          True)
    second = tatt.flash_attention_bwd_dq(q, k, v, out, lse, do, 0.125, True)
    second += tatt.flash_attention_bwd_dkv(q, k, v, do, lse, second[1],
                                           0.125, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_bwd_kernels_raise_on_what_they_do_not_take(card):
    q = torch.zeros((2, 16, 64), device=card)
    lse = torch.zeros((2, 16), device=card)
    before = (tatt.flash_bwd_dq_launches, tatt.flash_bwd_dkv_launches)
    with pytest.raises(ValueError, match="float32 row statistics"):
        tatt.flash_attention_bwd(q, q, q, q, lse.double(), q, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tatt.flash_attention_bwd(q, q, q, q, lse,
                                 q.transpose(0, 1).contiguous()
                                 .transpose(0, 1), 0.1)
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(2 * 16 * 64 + 1, device=card)
        tatt.flash_attention_bwd(q, q, q, q, lse,
                                 flat[1:].view(2, 16, 64), 0.1)
    assert (tatt.flash_bwd_dq_launches,
            tatt.flash_bwd_dkv_launches) == before


def test_bert_training_step_through_kernels(card):
    tmx.random.seed(0)
    kw = dict(vocab_size=100, max_length=64, dropout=0.0,
              output_hidden=True)
    net = tmx.models.bert_small(**kw)
    head = tmx.models.FusedMLMCELoss(100, 64)
    cpu = tmx.models.bert_small(device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    cpu_head = tmx.models.FusedMLMCELoss(100, 64, device="cpu")
    cpu_head.load_state_dict({k: v.cpu()
                              for k, v in head.state_dict().items()})
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randint(0, 100, (2, 64)))
    y = torch.from_numpy(rs.randint(0, 100, (2, 64)).astype(np.float32))
    trainer = tmx.gluon.Trainer(
        {**net.collect_params(), **head.collect_params()}, "adam",
        {"learning_rate": 1e-4})
    before = (tatt.flash_fwd_launches, tatt.flash_bwd_dq_launches,
              tatt.flash_bwd_dkv_launches)
    with tmx.autograd.record():
        loss = head(net(x.to(card)), y.to(card))
    tmx.autograd.backward(loss)
    torch.cuda.synchronize()
    assert (tatt.flash_fwd_launches - before[0],
            tatt.flash_bwd_dq_launches - before[1],
            tatt.flash_bwd_dkv_launches - before[2]) == (2, 2, 2)  # 2 layers
    with tmx.autograd.record():
        ref = cpu_head(cpu(x), y)
    tmx.autograd.backward(ref)
    assert (loss.cpu() - ref.detach()).abs().max().item() <= 1e-4
    cpu_params = list(cpu.parameters()) + list(cpu_head.parameters())
    gmax = max(p.grad.abs().max().item() for p in cpu_params)
    for p, r in zip(list(net.parameters()) + list(head.parameters()),
                    cpu_params):
        # 1e-3 of each gradient's scale, floored at 1e-3 of the largest
        # (attn.key.bias has an exact gradient of 0)
        err = (p.grad.cpu() - r.grad).abs().max().item()
        assert err <= 1e-3 * max(r.grad.abs().max().item(), 1e-3 * gmax)
    trainer.step(2)
    assert all(bool(torch.isfinite(p).all()) for p in net.parameters())


def _causal_counts():
    return (tatt.flash_fwd_causal_launches, tatt.flash_bwd_dq_causal_launches,
            tatt.flash_bwd_dkv_causal_launches)


def _counts():
    return (tatt.flash_fwd_launches, tatt.flash_bwd_dq_launches,
            tatt.flash_bwd_dkv_launches) + _causal_counts()


# the NMT step's shape (batch 64 x 8 heads, T 64, d 64: one 64 x 64 tile,
# every tile on the diagonal when causal), and a ragged causal T whose
# only tile is partial
@pytest.mark.parametrize("BH,T,causal", [(512, 64, False), (512, 64, True),
                                         (512, 50, True)])
def test_flash_kernels_at_nmt_shapes(card, BH, T, causal):
    q, k, v, do, out, lse = _bwd_inputs(card, BH, T, 64, torch.float32,
                                        causal)
    before = _counts()
    runs = []
    for _ in range(2):
        fwd = tatt.flash_attention_fwd(q, k, v, 0.125, causal)
        dq, delta = tatt.flash_attention_bwd_dq(q, k, v, out, lse, do, 0.125,
                                                causal)
        dk, dv = tatt.flash_attention_bwd_dkv(q, k, v, do, lse, delta, 0.125,
                                              causal)
        runs.append(fwd + (dq, delta, dk, dv))
    torch.cuda.synchronize()
    c = int(causal)
    assert tuple(a - b for a, b in zip(_counts(), before)) == \
        (2, 2, 2, 2 * c, 2 * c, 2 * c)
    # one owner per output element: the same bits over two launches
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    ref_out, ref_lse = tatt.flash_attention_fwd_plain(q, k, v, 0.125, causal)
    ref_dq, ref_delta = tatt.flash_attention_bwd_dq_plain(
        q, k, v, out, lse, do, 0.125, causal)
    ref_dk, ref_dv = tatt.flash_attention_bwd_dkv_plain(
        q, k, v, do, lse, delta, 0.125, causal)
    o, l, dq, delta, dk, dv = runs[0]
    # f32: the same sums in another order (as the cases above)
    assert (o - ref_out).abs().max().item() <= 1e-4
    assert (l - ref_lse).abs().max().item() <= 1e-4
    assert (delta - ref_delta).abs().max().item() <= \
        1e-4 * max(ref_delta.abs().max().item(), 1.0)
    for got, r in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert (got - r).abs().max().item() <= 1e-4 * r.abs().max().item()


def _nmt_pair(card, **kw):
    """transformer_nmt_small on the card (random weights from seed 0) and
    a CPU copy."""
    tmx.random.seed(0)
    kw = dict(src_vocab=40, tgt_vocab=40, dropout=0.0, **kw)
    net = tmx.models.transformer_nmt_small(**kw)
    assert next(net.parameters()).device == card    # cuda:0 by default
    cpu = tmx.models.transformer_nmt_small(device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    return net, cpu


def test_nmt_training_step_through_kernels(card):
    net, cpu = _nmt_pair(card, output_hidden=True)
    head = tmx.models.FusedMLMCELoss(40, 64)
    cpu_head = tmx.models.FusedMLMCELoss(40, 64, device="cpu")
    cpu_head.load_state_dict({k: v.cpu()
                              for k, v in head.state_dict().items()})
    rs = np.random.RandomState(0)
    src = torch.from_numpy(rs.randint(0, 40, (2, 24)))
    tgt = torch.from_numpy(rs.randint(0, 40, (2, 20)))
    y = torch.from_numpy(rs.randint(0, 40, (2, 20)).astype(np.float32))
    trainer = tmx.gluon.Trainer(
        {**net.collect_params(), **head.collect_params()}, "adam",
        {"learning_rate": 1e-4})
    before = _counts()
    with tmx.autograd.record():
        loss = head(net(src.to(card), tgt.to(card)), y.to(card))
    tmx.autograd.backward(loss)
    torch.cuda.synchronize()
    # 2 encoder layers and 2 causal decoder layers, each kernel once each
    assert tuple(a - b for a, b in zip(_counts(), before)) == \
        (4, 4, 4, 2, 2, 2)
    with tmx.autograd.record():
        ref = cpu_head(cpu(src, tgt), y)
    tmx.autograd.backward(ref)
    assert (loss.cpu() - ref.detach()).abs().max().item() <= 1e-4
    cpu_params = list(cpu.parameters()) + list(cpu_head.parameters())
    gmax = max(p.grad.abs().max().item() for p in cpu_params)
    for p, r in zip(list(net.parameters()) + list(head.parameters()),
                    cpu_params):
        # 1e-3 of each gradient's scale, floored at 1e-3 of the largest
        # (the key biases have an exact gradient of 0)
        err = (p.grad.cpu() - r.grad).abs().max().item()
        assert err <= 1e-3 * max(r.grad.abs().max().item(), 1e-3 * gmax)
    trainer.step(2)
    assert all(bool(torch.isfinite(p).all()) for p in net.parameters())


def test_nmt_decode_steps_on_card(card):
    net, cpu = _nmt_pair(card)
    rs = np.random.RandomState(1)
    src = torch.from_numpy(rs.randint(0, 40, (3, 10)))
    tgt = torch.from_numpy(rs.randint(0, 40, (3, 6)))
    valid = torch.tensor([10.0, 7.0, 3.0])
    before = _counts()
    with torch.inference_mode():
        cache = net.init_cache(src.to(card), valid.to(card), max_len=6,
                               mem_len=16)
        ref_cache = cpu.init_cache(src, valid, max_len=6, mem_len=16)
        forced = net(src.to(card), tgt.to(card),
                     src_valid_length=valid.to(card))
        after_forward = _counts()
        for i in range(6):
            pos = torch.full((3,), i)
            out, cache = net.decode_step(tgt[:, i].to(card), pos.to(card),
                                         cache)
            ref, ref_cache = cpu.decode_step(tgt[:, i], pos, ref_cache)
            # f32 logits of size ~1, card against the CPU copy and
            # against the teacher-forced forward on the card
            assert (out.cpu() - ref).abs().max().item() <= 1e-4
            assert (out - forced[:, i]).abs().max().item() <= 1e-4
    torch.cuda.synchronize()
    # the decode step attends with torch.bmm: no kernel launched.  The
    # masked forward launched the forward kernel once per decoder layer,
    # causal; its encoder took the masked, unfused path
    assert _counts() == after_forward
    assert tuple(a - b for a, b in zip(after_forward, before)) == \
        (2, 0, 0, 2, 0, 0)


def _conv_inputs(card, N, C, HW, O, dtype, seed=2):
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    x = torch.randn(N, C, HW, device=card, generator=gen).to(dtype)
    w = (torch.randn(O, C, device=card, generator=gen) * 0.05).to(dtype)
    return x, w


# with the instance bf16 and f16 take (f32 always takes the CUDA cores): ragged
# shapes; whole-image slabs at HW 49 and 196 (C 512 and 2048, O not a
# multiple of 128); 16-byte rows, with a ragged column tile at HW 784
@pytest.mark.parametrize("N,C,HW,O,bf16_path", [
    (3, 72, 49, 80, "cuda_cores"), (5, 17, 33, 65, "cuda_cores"),
    (2, 256, 196, 128, "tensor_cores_slabs"), (1, 1, 1, 1, "cuda_cores"),
    (4, 64, 3136, 64, "tensor_cores_rows"),
    (6, 512, 49, 2048, "tensor_cores_slabs"),
    (5, 2048, 49, 520, "tensor_cores_slabs"),
    (3, 512, 196, 1024, "tensor_cores_slabs"),
    (2, 2048, 196, 72, "tensor_cores_slabs"),
    (3, 256, 784, 200, "tensor_cores_rows")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_conv1x1_stats_kernel_matches_plain_version(card, N, C, HW, O,
                                                    bf16_path, dtype):
    path = bf16_path if dtype != torch.float32 else "cuda_cores"
    assert tcs.conv1x1_stats_path(N, C, HW, O, dtype) == path
    x, w = _conv_inputs(card, N, C, HW, O, dtype)
    before = tcs.conv1x1_stats_launches
    y, s1, s2 = tcs.fused_conv1x1_stats(x, w)
    torch.cuda.synchronize()
    assert tcs.conv1x1_stats_launches == before + 1
    assert y.dtype == dtype and y.shape == (N, O, HW)
    assert s1.shape == s2.shape == (1, O) and s1.dtype == torch.float32
    ref_y, ref_s1, ref_s2 = tcs.fused_conv1x1_stats_plain(x, w)
    if dtype == torch.float32:
        # f32 sums over C in another order
        assert bool(((y - ref_y).abs() <= 1e-4 * ref_y.abs().max()).all())
    else:
        # the kernel's y and the plain version's, each against the exact
        # product: what an f32 sum over C in any order, rounded to y's
        # dtype, can miss it by
        exact, bound = tcs.conv1x1_y_bound(x, w)
        for got in (y, ref_y):
            assert bool(((got.double() - exact).abs() <= bound).all())
    # the sums of N·HW f32 terms in another order: Σy within 1e-5 of
    # sqrt(N·HW·Σy²) (at least Σ|y|), Σy² within 1e-5 of itself
    n = N * HW
    assert bool(((s1 - ref_s1).abs() <= 1e-5 * (n * ref_s2).sqrt()).all())
    assert bool(((s2 - ref_s2).abs() <= 1e-5 * ref_s2).all())


@pytest.mark.parametrize("C,HW,O", [(512, 49, 2048), (1024, 196, 256),
                                    (64, 3136, 256), (72, 49, 80)])
def test_conv1x1_stats_kernel_is_deterministic(card, C, HW, O):
    # one owner per scratch element and a fixed-order reduction: two
    # launches on the same inputs give the same bits in y, s1 and s2
    x, w = _conv_inputs(card, 4, C, HW, O, torch.bfloat16)
    first = tcs.fused_conv1x1_stats(x, w)
    second = tcs.fused_conv1x1_stats(x, w)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_conv1x1_stats_kernel_raises_on_what_it_does_not_take(card):
    x = torch.zeros(2, 8, 10, device=card)
    w = torch.zeros(4, 8, device=card)
    before = tcs.conv1x1_stats_launches
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        tcs.fused_conv1x1_stats(x.double(), w.double())
    with pytest.raises(ValueError, match="contiguous"):
        tcs.fused_conv1x1_stats(x.transpose(0, 1).contiguous()
                                .transpose(0, 1), w)
    with pytest.raises(ValueError, match="different devices"):
        tcs.fused_conv1x1_stats(x, w.cpu())
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(2 * 8 * 10 + 1, device=card)
        tcs.fused_conv1x1_stats(flat[1:].view(2, 8, 10), w)
    assert tcs.conv1x1_stats_launches == before


def test_resnet_training_step_through_kernel(card):
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    kw = dict(classes=10, thumbnail=True, stride_on_3x3=True)
    args = (resnet.BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128])
    tmx.random.seed(0)
    net = resnet.ResNetV1(*args, device=card, **kw)
    cpu = resnet.ResNetV1(*args, device="cpu", **kw)
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(4, 3, 16, 16).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 4).astype(np.float32))
    with tmx.autograd.pause():          # the stems take their width
        net(x[:1].to(card))
        cpu(x[:1])
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "momentum": 0.9,
                                 "wd": 1e-4})
    before = tcs.conv1x1_stats_launches
    with tmx.autograd.record():
        loss = loss_fn(net(x.to(card)), y.to(card))
    tmx.autograd.backward(loss)
    torch.cuda.synchronize()
    # conv1 and conv3 of 4 bottlenecks and one stride-1 downsample
    assert tcs.conv1x1_stats_launches - before == 9
    with tmx.autograd.record():
        ref = loss_fn(cpu(x), y)
    tmx.autograd.backward(ref)
    assert (loss.cpu() - ref.detach()).abs().max().item() <= 1e-4
    got, want = net.collect_params(), cpu.collect_params()
    gmax = max(p.grad.abs().max().item() for p in want.values()
               if p.requires_grad)
    for name, r in want.items():
        if r.requires_grad:
            # 1e-3 of each gradient's scale, floored at 1e-3 of the largest
            err = (got[name].grad.cpu() - r.grad).abs().max().item()
            assert err <= 1e-3 * max(r.grad.abs().max().item(),
                                     1e-3 * gmax), name
        else:                               # running statistics
            err = (got[name].detach().cpu() - r.detach()).abs().max()
            assert err.item() <= 1e-4 * r.abs().max().item(), name
    trainer.step(4)
    assert all(bool(torch.isfinite(p).all()) for p in net.parameters())


# --- bf16 training and float16 dispatch ------------------------------------

def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (f32 tensor; 7 explicit mantissa
    bits), floored at the spacing at bf16's smallest normal."""
    return 2.0 ** (torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                   - 7)


def _scaled_errs(got, ref):
    """{name: max-abs error over scale} and {name: scale}, a scale being
    the max-abs value floored at 1e-3 of the largest among `ref`."""
    top = max(r.abs().max().item() for r in ref.values())
    scale = {n: max(r.abs().max().item(), 1e-3 * top) for n, r in ref.items()}
    return {n: (got[n].float().cpu() - r).abs().max().item() / scale[n]
            for n, r in ref.items()}, scale


def test_bert_bf16_training_step_through_kernels(card):
    """bert_small + FusedMLMCELoss cast to bf16 on the card: one step's
    loss, final hidden states and gradients against an f32 CPU copy
    holding the same bf16-valued weights, by the kernels (each launched
    once per layer, a bf16 instance) and by the plain route (every flash
    kernel's plain version on the card).  As chip_smoke.py's train_bf16
    holds them: the loss within twice the plain route's error plus 1e-6,
    and each tensor X (the hidden states, every gradient) within
    2 e_plain(X) + one bf16 ulp of X's scale.  Then an Adam step keeps
    every parameter bf16 and finite."""
    from chip_smoke import BF16_ROUTE_FACTOR, _bf16_ulp_share
    tmx.random.seed(0)
    kw = dict(vocab_size=100, max_length=64, dropout=0.0,
              output_hidden=True)
    net = tmx.models.bert_small(**kw).cast("bfloat16")
    head = tmx.models.FusedMLMCELoss(100, 64).cast("bfloat16")
    cpu = tmx.models.bert_small(device="cpu", **kw)
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in net.state_dict().items()})
    cpu_head = tmx.models.FusedMLMCELoss(100, 64, device="cpu")
    cpu_head.load_state_dict({k: v.float().cpu()
                              for k, v in head.state_dict().items()})
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randint(0, 100, (2, 64)))
    y = torch.from_numpy(rs.randint(0, 100, (2, 64)).astype(np.float32))
    params = {**net.collect_params(),
              **{"loss." + n: p for n, p in head.collect_params().items()}}
    with tmx.autograd.record():
        ref_hidden = cpu(x)
        ref = cpu_head(ref_hidden, y)
    tmx.autograd.backward(ref)
    ref_grads = {**{n: p.grad for n, p in cpu.collect_params().items()},
                 **{"loss." + n: p.grad
                    for n, p in cpu_head.collect_params().items()},
                 "hidden": ref_hidden.detach()}

    def step():
        with tmx.autograd.record():
            hidden = net(x.to(card))
            loss = head(hidden, y.to(card))
        tmx.autograd.backward(loss)
        torch.cuda.synchronize()
        got = {n: p.grad for n, p in params.items()}
        got["hidden"] = hidden.detach()
        return (loss.cpu() - ref.detach()).abs().max().item(), \
            _scaled_errs(got, ref_grads)

    saved = tatt.flash_attention_fwd, tatt.flash_attention_bwd
    tatt.flash_attention_fwd = tatt.flash_attention_fwd_plain
    tatt.flash_attention_bwd = tatt.flash_attention_bwd_plain
    try:
        before = _counts()
        plain_loss, (plain, _) = step()
        assert _counts() == before
    finally:
        tatt.flash_attention_fwd, tatt.flash_attention_bwd = saved
    before = _counts()
    kern_loss, (kern, scale) = step()
    assert tuple(a - b for a, b in zip(_counts(), before)) == \
        (2, 2, 2, 0, 0, 0)
    assert kern_loss <= 2.0 * plain_loss + 1e-6, (kern_loss, plain_loss)
    over = {n: kern[n] / (BF16_ROUTE_FACTOR * plain[n]
                          + _bf16_ulp_share(scale[n])) for n in kern}
    worst = max(over, key=over.get)
    assert over[worst] <= 1.0, (worst, kern[worst], plain[worst])
    trainer = tmx.gluon.Trainer(params, "adam", {"learning_rate": 1e-4})
    trainer.step(2)
    for p in params.values():
        assert p.dtype == torch.bfloat16 and bool(torch.isfinite(p).all())


def test_float16_runs_through_the_kernels_on_card(card):
    """float16 activations (amp.init("float16"), a float16 cast): the
    flash kernels' and the conv kernel's f16 instances launch, once each
    per call, and agree with the f32 routes within f16 rounding; the
    wrappers raise on a dtype without an instance (float64)."""
    q, k, v = (torch.randn(2, 4, 64, 64, device=card).half()
               for _ in range(3))
    for t in (q, k, v):
        t.requires_grad_()
    before = _counts()
    out = tatt.flash_attention(q, k, v)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == \
        (1, 1, 1, 0, 0, 0)
    ref_qkv = [t.detach().float().requires_grad_() for t in (q, k, v)]
    ref = tatt.naive_attention(*ref_qkv, 1.0 / 8.0)
    ref.sum().backward()
    assert out.dtype == torch.float16
    # f16 rounding of q, k, v, P and the outputs: a few 2**-11 of scale
    assert (out.float() - ref).abs().max().item() <= \
        2.0 ** -7 * ref.abs().max().item()
    for t, r in zip((q, k, v), ref_qkv):
        assert t.grad.dtype == torch.float16
        assert (t.grad.float() - r.grad).abs().max().item() <= \
            2.0 ** -7 * r.grad.abs().max().item()
    tmx.random.seed(0)
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Conv2D(32, 1, use_bias=False, in_channels=32,
                                device=card),
            tmx.gluon.nn.BatchNorm(in_channels=32, device=card))
    cpu = tmx.gluon.nn.HybridSequential()
    cpu.add(tmx.gluon.nn.Conv2D(32, 1, use_bias=False, in_channels=32,
                                device="cpu"),
            tmx.gluon.nn.BatchNorm(in_channels=32, device="cpu"))
    net.cast("float16")
    cpu.load_state_dict({n: t.float().cpu()
                         for n, t in net.state_dict().items()})
    xb = torch.randn(2, 32, 8, 8, device=card).half()
    before = tcs.conv1x1_stats_launches
    with tmx.autograd.record():
        yb = net(xb)
        yc = cpu(xb.float().cpu())
    torch.cuda.synchronize()
    assert tcs.conv1x1_stats_launches == before + 1
    assert yb.dtype == torch.float16
    assert (yb.float().cpu() - yc).abs().max().item() <= \
        2.0 ** -7 * yc.abs().max().item()
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        tatt.flash_attention_fwd(*(t.detach().double().reshape(8, 64, 64)
                                   for t in (q, k, v)), 0.125)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        tcs.fused_conv1x1_stats(torch.zeros(2, 16, 64, device=card).double(),
                                torch.zeros(32, 16, device=card).double())


def test_adam_bf16_on_card_matches_cpu(card):
    """One Adam step on bf16 tensors on the card against the same step on
    the CPU: both compute in f32 and round once, so they agree but where
    the card's fused multiply-adds tip a rounding (at most one bf16 ulp)."""
    from incubator_mxnet_tpu_torch.ops import optimizer as topt
    rs = np.random.RandomState(0)
    w, g, m = (torch.from_numpy(rs.randn(1 << 16).astype(np.float32))
               .bfloat16() for _ in range(3))
    v = torch.from_numpy(rs.rand(1 << 16).astype(np.float32) * 0.01) \
        .bfloat16()
    kw = dict(lr=1e-3, wd=1e-4, rescale_grad=0.125)
    cpu = [t.clone() for t in (w, g, m, v)]
    dev = [t.to(card) for t in (w, g, m, v)]
    topt.adam_update(*cpu, **kw)
    topt.adam_update(*dev, **kw)
    for a, b in zip(dev, cpu):
        assert a.dtype == torch.bfloat16
        a, b = a.cpu().float(), b.float()
        assert bool(((a - b).abs() <= _bf16_ulp(b)).all())


def test_fused_linear_ce_bf16_on_card_matches_cpu(card):
    """The fused vocab CE on bf16 operands: the card's route (cuBLAS bf16
    GEMMs with f32 output) against the CPU's (operands upcast to f32),
    the same function summed in other orders.  The f32 loss within 1e-5
    of its size; dh, dW and db, rounded to bf16 on both, within one bf16
    ulp of their scale plus 1e-4 of each tensor's largest value."""
    rs = np.random.RandomState(7)
    h = torch.from_numpy(rs.randn(512, 64).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rs.randn(1000, 64).astype(np.float32) * 0.1) \
        .bfloat16()
    b = torch.from_numpy(rs.randn(1000).astype(np.float32)).bfloat16()
    lab = torch.from_numpy(rs.randint(0, 1000, 512).astype(np.float32))
    res = []
    for dev in (card, torch.device("cpu")):
        ts = [t.to(dev).requires_grad_() for t in (h, w, b)]
        loss = tnn.fused_linear_softmax_ce(*ts, lab.to(dev), num_chunks=2)
        loss.sum().backward()
        res.append([loss.detach().cpu()] + [t.grad.cpu() for t in ts])
    (loss_c, *grads_c), (loss_h, *grads_h) = res
    assert loss_c.dtype == torch.float32
    assert (loss_c - loss_h).abs().max().item() <= 1e-5 * loss_h.abs().max()
    for a, r in zip(grads_c, grads_h):
        assert a.dtype == torch.bfloat16
        a, r = a.float(), r.float()
        assert bool(((a - r).abs()
                     <= _bf16_ulp(r) + 1e-4 * r.abs().max()).all())


# --- the Gluon core surface on the card -------------------------------------

def _small_cnn():
    nn = tmx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, activation="relu"),
            nn.Conv2D(16, 1, use_bias=False), nn.BatchNorm(),
            nn.Activation("relu"), nn.GlobalAvgPool2D(), nn.Dense(10))
    return net


def test_deferred_init_onto_the_card_runs_the_fused_pair(card):
    from incubator_mxnet_tpu_torch.gluon.parameter import is_deferred
    net = _small_cnn()
    net.initialize(tmx.init.MSRAPrelu(), ctx=tmx.gpu(0))
    params = net.collect_params()
    assert all(is_deferred(p) for n, p in params.items()
               if "weight" in n)
    trainer = tmx.gluon.Trainer(params, "nag", {
        "learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(4, 3, 16, 16).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 4).astype(np.float32))
    before = tcs.conv1x1_stats_launches
    with tmx.autograd.record():
        loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(net(x.to(card)),
                                                        y.to(card))
    tmx.autograd.backward(loss)
    torch.cuda.synchronize()
    assert tcs.conv1x1_stats_launches - before == 1
    assert not any(is_deferred(p) for p in params.values())
    assert {p.device for p in params.values()} == {card}
    w = params["1.weight"].detach().clone()
    trainer.step(4)
    assert not torch.equal(w, params["1.weight"].detach())
    assert all(s.device == card for s in trainer._updater.states.values())


def test_bf16_save_load_round_trip_on_card(card, tmp_path):
    net = _small_cnn()
    net.initialize(ctx=card)
    with tmx.autograd.pause():
        net(torch.zeros(1, 3, 16, 16, device=card))
    net.cast("bfloat16")
    path = str(tmp_path / "bf16.params")
    net.save_parameters(path)
    back = _small_cnn()
    back.cast("bfloat16")
    back.load_parameters(path, ctx=tmx.gpu(0))
    got = back.collect_params()
    for n, p in net.collect_params().items():
        assert got[n].dtype == torch.bfloat16 and got[n].device == card
        assert torch.equal(got[n].view(torch.int16), p.view(torch.int16))


def test_metric_update_does_not_sync(card):
    acc, top = tmx.metric.Accuracy(), tmx.metric.TopKAccuracy(5)
    rs = np.random.RandomState(1)
    pred = torch.from_numpy(rs.randn(64, 100).astype(np.float32)).to(card)
    label = torch.from_numpy(rs.randint(0, 100, 64).astype(np.float32))
    label = label.to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for m in (acc, top):
            m.update([label], [pred.bfloat16()])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    want = (pred.bfloat16().argmax(1) == label.long()).float().mean()
    assert acc.get()[1] == pytest.approx(want.item())


# -- hybridize(): captured CUDA graphs ----------------------------------------

def _graphed_run(build, data, hybrid, steps=4):
    """`steps` training steps of build() = (net, loss, trainer), eager or
    hybridized; the losses, the final parameters and the objects."""
    net, loss, trainer = build()
    if hybrid:
        net.hybridize(static_alloc=True, static_shape=True)
        loss.hybridize()
    *x, y = data
    losses = []
    for _ in range(steps):
        with tmx.autograd.record():
            lv = loss(net(*x), y)
        tmx.autograd.backward(lv)
        trainer.step(x[0].shape[0])
        losses.append(lv.detach())
    torch.cuda.synchronize()
    return losses, [p.detach().clone() for p in trainer._params], \
        (net, loss, trainer)


def _kernel_calls(fn):
    """{kernel name: launches} of the port's kernels over one call of
    `fn`, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    calls = {}
    for ev in prof.key_averages():
        m = re.search(r"::(flash_\w+_kernel|conv1x1_stats\w*_kernel)\b",
                      ev.key)
        if m:
            calls[m.group(1)] = calls.get(m.group(1), 0) + ev.count
    return calls


def _mlm_small(card, dtype, nmt=False):
    def build():
        tmx.random.seed(0)
        if nmt:
            net = tmx.models.transformer_nmt_small(
                200, 200, units=128, hidden_size=256, num_heads=2,
                dropout=0.0, output_hidden=True, device=card)
        else:
            net = tmx.models.bert_small(
                vocab_size=200, units=128, hidden_size=256, num_heads=2,
                dropout=0.0, output_hidden=True, device=card)
        head = tmx.models.FusedMLMCELoss(200, 128, device=card)
        net.cast(dtype)
        head.cast(dtype)
        params = dict(net.collect_params())
        params.update({"l." + n: p for n, p in head.collect_params().items()})
        return net, head, tmx.gluon.Trainer(params, "adam",
                                            {"learning_rate": 1e-3})
    rs = np.random.RandomState(0)
    ids = [torch.from_numpy(rs.randint(0, 200, (4, 64))).to(card)
           for _ in range(2 if nmt else 1)]
    lab = torch.from_numpy(rs.randint(0, 200, (4, 64)).astype(np.float32))
    return build, (*ids, lab.to(card))


@pytest.mark.parametrize("nmt,dtype", [(False, torch.bfloat16),
                                       (True, torch.float32)],
                         ids=["bert_bf16", "nmt_f32"])
def test_captured_step_equals_its_eager_twin(card, nmt, dtype):
    """Forward, backward and Adam's update replayed from CUDA graphs give
    the eager step's bits.  The wrappers count the launches of the eager
    first step and of the capture, none of the replays; a replayed step
    runs each flash kernel once per attention layer, in the profiler's
    names."""
    build, data = _mlm_small(card, dtype, nmt)
    eager = _graphed_run(build, data, False)
    before = _counts()
    hyb = _graphed_run(build, data, True)
    launched = [a - b for a, b in zip(_counts(), before)]
    for a, b in zip(eager[0], hyb[0]):
        assert torch.equal(a, b)
    for a, b in zip(eager[1], hyb[1]):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    net, loss, trainer = hyb[2]
    assert (trainer.captures, trainer.replays) == (1, 2)
    assert net._cached_graph.replays == 4       # 2 steps x (fwd, bwd)
    layers = 2 * 2 if nmt else 2
    want = [2 * layers] * 3 + ([2 * 2] * 3 if nmt else [0] * 3)
    assert launched == want
    *x, y = data

    def step():
        with tmx.autograd.record():
            lv = loss(net(*x), y)
        tmx.autograd.backward(lv)
        trainer.step(x[0].shape[0])
    before = _counts()
    assert _kernel_calls(step) == {"flash_fwd_kernel": layers,
                                   "flash_bwd_dq_kernel": layers,
                                   "flash_bwd_dkv_kernel": layers}
    assert _counts() == before


def test_dropout_draws_new_masks_on_each_replay(card):
    tmx.random.seed(0)
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Dense(4096, in_units=64), tmx.gluon.nn.Dropout(0.3))
    net.initialize(ctx=card)
    net.hybridize()
    x = torch.ones(8, 64, device=card, requires_grad=True)
    masks = []
    for _ in range(5):
        with tmx.autograd.record():
            out = net(x)
        tmx.autograd.backward(out)
        masks.append(out != 0)
    assert net._cached_graph.replays >= 6
    n = masks[0].numel()
    for a, b in zip(masks, masks[1:]):
        assert not torch.equal(a, b)
    for m in masks:
        rate = m.float().mean().item()
        assert abs(rate - 0.7) <= 3 * (0.7 * 0.3 / n) ** 0.5


def test_a_replay_runs_the_port_kernels(card):
    build, data = _mlm_small(card, torch.bfloat16)
    *_, (net, loss, trainer) = _graphed_run(build, data, True, steps=3)
    tcs.conv1x1_stats_launches = 0
    tmx.random.seed(0)
    cnn = tmx.gluon.nn.HybridSequential()
    cnn.add(tmx.gluon.nn.Conv2D(64, 1, in_channels=32, use_bias=False),
            tmx.gluon.nn.BatchNorm(in_channels=64))
    cnn.initialize(ctx=card)
    cnn.cast("bfloat16")
    cnn.hybridize()
    xb = torch.randn(8, 32, 16, 16, device=card,
                     generator=torch.Generator(card).manual_seed(0)) \
        .bfloat16()

    def step():
        with tmx.autograd.record():
            lv = loss(net(data[0]), data[1]).sum() + cnn(xb).float().sum()
        tmx.autograd.backward(lv)
        trainer.step(4)
    for _ in range(3):
        step()
    # the eager first call and the capture; the replays run no wrapper
    assert tcs.conv1x1_stats_launches == 2
    assert _kernel_calls(step) == {"flash_fwd_kernel": 2,
                                   "flash_bwd_dq_kernel": 2,
                                   "flash_bwd_dkv_kernel": 2,
                                   "conv1x1_stats_tc_kernel": 1}
    assert tcs.conv1x1_stats_launches == 2


class _HostReadBlock(tmx.gluon.HybridBlock):
    def forward(self, x):
        return x * x.sum().item()


def test_a_capture_that_reads_the_device_raises(card):
    from incubator_mxnet_tpu_torch import graph_capture
    block = _HostReadBlock()
    block.hybridize()
    x = torch.ones(16, device=card)
    block(x)
    with pytest.raises(graph_capture.CaptureError,
                       match="_local_scalar_dense"):
        block(x)
    # the generators the capture held draw again
    torch.rand(4, device=card)
    tmx.ops.nn.dropout(x, 0.5, training=True,
                       generator=tmx.random.generator(card))


def test_generation_engine_replays_its_programs_on_card(card):
    # transformer_nmt_small behind GenerationEngine on cuda:0: warmup
    # captures one prefill per bucket, the join and the decode step as
    # CUDA graphs; traffic only replays them, on the same cache storage,
    # and each request's tokens are the eager greedy loop's on the card
    from incubator_mxnet_tpu_torch.monitor import events
    net, _ = _nmt_pair(card)
    eng = tmx.serving.GenerationEngine(net, bos=1, eos=2, slots=3,
                                       max_len=16, prompt_buckets=(4, 8))
    rs = np.random.RandomState(0)
    prompts = [rs.randint(3, 40, (n,)).astype(np.int32)
               for n in (3, 8, 5, 1, 7)]
    before = _counts()
    try:
        t0 = events.get("serve.traces")
        eng.warmup()
        assert events.get("serve.traces") - t0 == 4
        ptrs = {k: t.data_ptr() for k, t in eng._state.leaves().items()}
        copies = events.get("gen.donation_copy")
        streams = [eng.submit(p, max_new_tokens=10) for p in prompts]
        got = [s.result(timeout=120) for s in streams]
        assert events.get("serve.traces") - t0 == 4
        assert {k: t.data_ptr()
                for k, t in eng._state.leaves().items()} == ptrs
        assert eng._donation_checked
        assert events.get("gen.donation_copy") == copies
    finally:
        eng.close()
    # masked attention and the cached step are unfused: no port kernel
    assert _counts() == before
    with torch.no_grad():
        for p, g in zip(prompts, got):
            cache = net.init_cache(
                torch.from_numpy(p[None]).to(card),
                torch.tensor([p.size], device=card), max_len=16, mem_len=8)
            tok, ref, gaps = torch.tensor([1], device=card), [], []
            for i in range(10):
                logits, cache = net.decode_step(
                    tok, torch.tensor([i], device=card), cache)
                top = logits[0].topk(2).values
                gaps.append(float(top[0] - top[1]))
                ref.append(int(logits[0].argmax()))
                if ref[-1] == 2:
                    break
                tok = logits[0].argmax().reshape(1)
            g = [int(t) for t in g]
            # near-tie rule: a token may differ only where the eager
            # step's top-2 gap is within the logits tolerance (1e-4,
            # f32 on the card), and the comparison stops there
            diff = next((i for i, (a, b) in enumerate(zip(g, ref))
                         if a != b), None)
            if diff is None:
                assert g == ref
            else:
                print("near tie at step %d, gap %g" % (diff, gaps[diff]))
                assert gaps[diff] <= 1e-4, (g, ref)


# -- mx.nd on the card ------------------------------------------------------

def test_ndarray_defaults_to_the_card(card):
    nd = tmx.nd
    x = nd.array([[1.0, 2.0], [3.0, 4.0]])
    assert x.context == card and x._data.is_cuda
    for y in (nd.zeros((2,)), nd.arange(4), x + 1, nd.dot(x, x),
              nd.random.uniform(shape=(3,)), x.argmax(axis=1)):
        assert y.context == card
    assert (x * 2).asnumpy().tolist() == [[2.0, 4.0], [6.0, 8.0]]
    nd.waitall()


def test_ndarray_write_does_not_reach_views_on_the_card(card):
    x = tmx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
    view, row = x.reshape((4, 3)), x[1]
    x[:] = 0
    x += 2
    assert view.asnumpy().ravel().tolist() == list(range(12))
    assert row.asnumpy().tolist() == [4.0, 5.0, 6.0, 7.0]
    assert (x.asnumpy() == 2).all()


def test_nd_flash_attention_launches_the_kernels(card):
    """nd.contrib.flash_attention on NDArrays with attach_grad: one launch
    of each kernel, output and gradients within the flash rows' bounds of
    the plain route on the card."""
    rs = np.random.RandomState(0)
    arrays = [rs.randn(2, 128, 128).astype(np.float32) for _ in range(3)]
    cot = rs.randn(2, 128, 128).astype(np.float32)

    def run():
        qkv = [tmx.nd.array(a) for a in arrays]
        for a in qkv:
            a.attach_grad()
        with tmx.autograd.record():
            out = tmx.nd.contrib.flash_attention(*qkv, num_heads=2)
        out.backward(tmx.nd.array(cot))
        return out._data, [a.grad._data for a in qkv]

    before = (tatt.flash_fwd_launches, tatt.flash_bwd_dq_launches,
              tatt.flash_bwd_dkv_launches)
    out, grads = run()
    torch.cuda.synchronize()
    assert (tatt.flash_fwd_launches, tatt.flash_bwd_dq_launches,
            tatt.flash_bwd_dkv_launches) == tuple(b + 1 for b in before)
    saved = tatt.flash_attention_fwd, tatt.flash_attention_bwd
    tatt.flash_attention_fwd = tatt.flash_attention_fwd_plain
    tatt.flash_attention_bwd = tatt.flash_attention_bwd_plain
    try:
        ref, ref_grads = run()
    finally:
        tatt.flash_attention_fwd, tatt.flash_attention_bwd = saved
    assert (out - ref).abs().max().item() <= 1e-4
    for g, r in zip(grads, ref_grads):
        assert (g - r).abs().max().item() <= 1e-4 * r.abs().max().item()


def test_nd_second_order_through_flash_raises_on_card(card):
    qkv = [tmx.nd.array(np.random.RandomState(i).randn(1, 64, 64)
                        .astype(np.float32)) for i in range(3)]
    for a in qkv:
        a.attach_grad()
    with pytest.raises(tmx.MXNetError, match="differentiable once"):
        with tmx.autograd.record():
            s = tmx.nd.sum(tmx.nd.square(
                tmx.nd.contrib.flash_attention(*qkv, num_heads=1)))
            tmx.autograd.grad(s, [qkv[0]], create_graph=True)


def test_nd_create_graph_penalty_on_card(card):
    """A gradient penalty by autograd.grad(create_graph=True) on the card
    against torch.autograd.grad over the same tensors."""
    import torch.nn.functional as F
    rs = np.random.RandomState(1)
    xs = rs.randn(4, 16).astype(np.float32)
    ws = [rs.randn(32, 16).astype(np.float32) * 0.1,
          rs.randn(32).astype(np.float32) * 0.1]
    x = tmx.nd.array(xs)
    w, b = (tmx.nd.array(a) for a in ws)
    for a in (x, w, b):
        a.attach_grad()
    with tmx.autograd.record():
        y = tmx.nd.Activation(tmx.nd.FullyConnected(x, w, b, num_hidden=32),
                              act_type="tanh")
        gx, = tmx.autograd.grad(tmx.nd.sum(y), [x], create_graph=True)
        pen = tmx.nd.sum(tmx.nd.square(gx))
    pen.backward()
    tx = torch.tensor(xs, device=card, requires_grad=True)
    tw, tb = (torch.tensor(a, device=card, requires_grad=True) for a in ws)
    tgx, = torch.autograd.grad(torch.tanh(F.linear(tx, tw, tb)).sum(), tx,
                               create_graph=True)
    gw, gb = torch.autograd.grad(tgx.square().sum(), [tw, tb])
    assert torch.allclose(w.grad._data, gw, rtol=1e-5, atol=1e-6)
    assert torch.allclose(b.grad._data, gb, rtol=1e-5, atol=1e-6)


# --- detection: the NMS kernel and a hybridized faster_rcnn_toy step -------

def _nms_inputs(card, B, N, seed, aware=False, ties=False):
    rs = np.random.RandomState(seed)
    ctr = rs.rand(B, N, 2) * 100
    wh = rs.rand(B, N, 2) * 40 + 2
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    if ties:
        rep = boxes[:, 1::3].shape[1]
        boxes[:, 1::3] = boxes[:, 0:-1:3][:, :rep]
    cls = torch.tensor(rs.randint(0, 4, (B, N)).astype(np.float32),
                       device=card) if aware else None
    valid = torch.tensor(rs.rand(B, N) > 0.2, device=card)
    return torch.tensor(boxes, dtype=torch.float32, device=card), cls, valid


@pytest.mark.parametrize("B,N,plus_one,aware,topk,ties", [
    (2, 2000, True, False, 1000, False), (3, 700, False, True, 0, False),
    (2, 130, True, False, 100, True), (4, 64, False, False, 0, True)])
def test_nms_kernel_matches_plain_version(card, B, N, plus_one, aware,
                                          topk, ties):
    from incubator_mxnet_tpu_torch.ops import nms
    boxes, cls, valid = _nms_inputs(card, B, N, N, aware, ties)
    for thresh in (0.3, 0.7):
        before = nms.nms_launches
        got = nms.nms_sorted(boxes, valid, thresh, cls=cls,
                             plus_one=plus_one, topk=topk)
        torch.cuda.synchronize()
        assert nms.nms_launches == before + 1
        ref = nms.nms_sorted_plain(boxes, valid, thresh, cls, plus_one, topk)
        got, ref = ((g,) if topk <= 0 else g for g in (got, ref))
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        assert 0 < int(got[0].sum()) < B * N


def test_nms_kernel_raises_on_what_it_does_not_take(card):
    from incubator_mxnet_tpu_torch.ops import nms
    boxes = torch.zeros(1, 8, 4, device=card)
    with pytest.raises(ValueError, match="float32"):
        nms.nms_sorted(boxes.half(), None, 0.5)
    with pytest.raises(ValueError, match=r"\(B, N, 4\)"):
        nms.nms_sorted(boxes[..., :3], None, 0.5)
    with pytest.raises(ValueError, match="cls"):
        nms.nms_sorted(boxes, None, 0.5, cls=torch.zeros(1, 8))


def _prefix_flags(card, B, N, share, seed):
    """Each image's flags on a sorted prefix of about `share` of its
    boxes, and the longest prefix."""
    ends = np.round(N * np.random.RandomState(seed).uniform(
        0.8 * share, 1.2 * share, B)).astype(np.int64)
    valid = torch.tensor(np.arange(N)[None, :] < ends[:, None], device=card)
    return valid, int(ends.max())


def _interleaved_flags(card, B, N, seed):
    """Every other box and a random third of the rest, none in the last
    tenth: flags that are no prefix."""
    rs = np.random.RandomState(seed)
    flags = (np.arange(N) % 2 == 0)[None, :] | (rs.rand(B, N) < 0.33)
    flags[:, N - N // 10:] = False
    return torch.tensor(flags, device=card)


@pytest.mark.parametrize("B,N,share,plus_one,aware,topk", [
    (8, 24564, 0.013, False, True, 0), (2, 5000, 0.1, True, False, 300)])
def test_nms_kernel_on_a_sparse_prefix_of_flags(card, B, N, share, plus_one,
                                                aware, topk):
    """MultiBoxDetection's shape (flags on 1.3 % of 24,564 anchors) and a
    longer prefix: the kernel's flags equal the plain version's on the
    prefix that holds every valid box, and are False past it."""
    from incubator_mxnet_tpu_torch.ops import nms
    boxes, cls, _ = _nms_inputs(card, B, N, N, aware)
    valid, P = _prefix_flags(card, B, N, share, N)
    for thresh in (0.3, 0.7):
        got = nms.nms_sorted(boxes, valid, thresh, cls=cls,
                             plus_one=plus_one, topk=topk)
        ref = nms.nms_sorted_plain(
            boxes[:, :P], valid[:, :P], thresh,
            None if cls is None else cls[:, :P], plus_one, topk)
        got, ref = ((g,) if topk <= 0 else g for g in (got, ref))
        assert torch.equal(got[0][:, :P], ref[0])
        assert not bool(got[0][:, P:].any()) and 0 < int(got[0].sum())
        if topk:
            assert torch.equal(got[1], ref[1])


@pytest.mark.parametrize("B,N,plus_one,aware,topk", [
    (2, 2000, False, False, 0), (3, 700, True, True, 200)])
def test_nms_kernel_with_interleaved_flags(card, B, N, plus_one, aware,
                                           topk):
    from incubator_mxnet_tpu_torch.ops import nms
    boxes, cls, _ = _nms_inputs(card, B, N, N + 1, aware)
    valid = _interleaved_flags(card, B, N, N)
    for thresh in (0.3, 0.7):
        got = nms.nms_sorted(boxes, valid, thresh, cls=cls,
                             plus_one=plus_one, topk=topk)
        ref = nms.nms_sorted_plain(boxes, valid, thresh, cls, plus_one, topk)
        got, ref = ((g,) if topk <= 0 else g for g in (got, ref))
        for g, r in zip(got, ref):
            assert torch.equal(g, r)
        assert 0 < int(got[0].sum()) < int(valid.sum())


@pytest.mark.parametrize("B,N,topk,flags", [
    (2, 2000, 1000, False), (2, 300, 300, True), (4, 1000, 1, False)])
def test_nms_kernel_positions_only(card, B, N, topk, flags):
    """Proposal's mode: only the first `topk` kept positions, the scan
    ending at the topk-th kept box; as the plain version's positions-only
    mode and its full pass give them (`topk` reached, and not)."""
    from incubator_mxnet_tpu_torch.ops import nms
    boxes, _, valid = _nms_inputs(card, B, N, N + 2)
    valid = valid if flags else None
    for thresh in (0.3, 0.7):
        before = nms.nms_launches
        got = nms.nms_sorted(boxes, valid, thresh, plus_one=True, topk=topk,
                             positions_only=True)
        torch.cuda.synchronize()
        assert nms.nms_launches == before + 1
        ref = nms.nms_sorted_plain(boxes, valid, thresh, plus_one=True,
                                   topk=topk, positions_only=True)
        _, full = nms.nms_sorted(boxes, valid, thresh, plus_one=True,
                                 topk=topk)
        assert torch.equal(got, ref) and torch.equal(got, full)


def test_nms_kernel_in_a_captured_graph_follows_the_flags(card):
    """One captured graph of the NMS kernel, box_nms's form and
    Proposal's positions-only form, replayed as the boxes and the number
    of boxes that take part change: each replay gives the plain version's
    result on the new inputs (n_eff and the early stop are read on the
    device, the grid does not change)."""
    from incubator_mxnet_tpu_torch.ops import nms
    B, N = 4, 3000
    boxes, cls, _ = _nms_inputs(card, B, N, 9, aware=True)
    valid = torch.zeros(B, N, dtype=torch.bool, device=card)

    def calls():
        return (nms.nms_sorted(boxes, valid, 0.5, cls=cls),
                nms.nms_sorted(boxes, None, 0.7, plus_one=True, topk=400,
                               positions_only=True))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        keep, idx = calls()
    before = nms.nms_launches
    for seed, flags in enumerate(("prefix", "all", "none", "interleaved")):
        new, new_cls, _ = _nms_inputs(card, B, N, 20 + seed, aware=True)
        boxes.copy_(new)
        cls.copy_(new_cls)
        if flags == "prefix":
            valid.copy_(_prefix_flags(card, B, N, 0.02, seed)[0])
        elif flags == "interleaved":
            valid.copy_(_interleaved_flags(card, B, N, seed))
        else:
            valid.fill_(flags == "all")
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(keep, nms.nms_sorted_plain(boxes, valid, 0.5,
                                                      cls)), flags
        assert torch.equal(idx, nms.nms_sorted_plain(
            boxes, None, 0.7, plus_one=True, topk=400,
            positions_only=True)), flags
    assert nms.nms_launches == before


def test_faster_rcnn_toy_hybridized_step_on_card(card):
    """One hybridized faster_rcnn_toy training step after its eager and
    capturing ones: Proposal's NMS by the kernel in the eager and the
    capturing step (one launch each), none by a wrapper in the replayed
    one, whose loss is finite and whose labels are sampled classes."""
    from incubator_mxnet_tpu_torch import models
    from incubator_mxnet_tpu_torch.ops import nms
    rs = np.random.RandomState(1)
    x = torch.tensor(rs.randn(2, 3, 64, 64).astype(np.float32), device=card)
    im_info = torch.tensor([[64.0, 64.0, 1.0]] * 2, device=card)
    gt = torch.tensor([[[6, 6, 30, 30, 1], [24, 20, 56, 60, 2]]] * 2,
                      dtype=torch.float32, device=card)
    tmx.random.seed(0)
    net = models.faster_rcnn_toy(classes=3, device=card)
    loss_b = models.RCNNTrainLoss()
    net.hybridize()
    loss_b.hybridize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.01, "momentum": 0.9})
    launches, losses, labels = [], [], []
    for _ in range(3):
        before = nms.nms_launches
        with tmx.autograd.record():
            out = net(x, im_info, gt_boxes=gt, batch_rois=16)
            loss = loss_b(*out[:2], *out[3:6])
        tmx.autograd.backward(loss)
        trainer.step(2)
        torch.cuda.synchronize()
        launches.append(nms.nms_launches - before)
        losses.append(loss.item())
        labels.append(out[3])
    cg = net.__dict__["_cached_graph"]
    assert (cg.eager_calls, cg.captures, cg.replays) == (1, 2, 2)
    # the RPN's parameters take zero gradients in every step, so the
    # update's live set never changes: captured in step 2, replayed in 3
    assert (trainer.eager_updates, trainer.captures,
            trainer.replays) == (1, 1, 1)
    assert launches == [1, 1, 0]
    assert all(np.isfinite(losses)) and (labels[-1] > 0).any()
    assert set(labels[-1].tolist()) <= {-1.0, 0.0, 1.0, 2.0, 3.0}


# -- the optimizers' captured updates ------------------------------------------

def _update_runs(card, name, kw, dtype, steps=5, seed=0, factor=None):
    """`steps` Trainer updates of 3 card parameters from fixed gradients,
    once with the gradients in fresh tensors (every update eager) and
    once in the parameters' persistent buffers (1 eager update, 1
    capture, then replays); the weights after each update, both ways.
    With `factor`, each run has a FactorScheduler(2, factor) of its
    own."""
    rs = np.random.RandomState(seed)
    shapes = ((64, 48), (300,), (7, 5, 3))
    init = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(steps)]
    runs = []
    for stable in (False, True):
        tmx.random.seed(seed)
        params = [tmx.gluon.Parameter("p%d" % i, shape=a.shape, dtype=dtype)
                  for i, a in enumerate(init)]
        for p, a in zip(params, init):
            p.initialize(ctx=card)
            p.set_data(a)
        params[1].wd_mult = 0.0
        own = dict(kw)
        if factor is not None:
            own["lr_scheduler"] = tmx.lr_scheduler.FactorScheduler(
                step=2, factor=factor)
        trainer = tmx.gluon.Trainer(params, name, own)
        seen = []
        for step in range(steps):
            for p, g in zip(params, grads[step]):
                g = torch.from_numpy(g).to(card, dtype)
                if stable:
                    p.grad = tmx.autograd.grad_buffer(p)
                    p.grad.copy_(g)
                else:
                    p.grad = g
            trainer.step(2)
            seen.append([p.detach().clone() for p in params])
        torch.cuda.synchronize()
        runs.append((seen, trainer))
    return runs


@pytest.mark.parametrize("name,kw,dtype", [
    ("lamb", dict(learning_rate=1e-2, wd=0.01, epsilon=1e-6),
     torch.bfloat16),
    ("lamb", dict(learning_rate=1e-2, wd=0.01, lower_bound=0.5,
                  upper_bound=4.0, bias_correction=False), torch.float32),
    ("nadam", dict(learning_rate=1e-2, wd=0.01), torch.float32),
    ("nadam", dict(learning_rate=1e-2, wd=0.01), torch.bfloat16),
])
def test_captured_update_equals_eager_on_card(card, name, kw, dtype):
    """LAMB and Nadam replayed as a CUDA graph under a FactorScheduler:
    bit for bit the eager updates, with every per-step value (bias
    corrections, Nadam's schedule, the lr) read from the hyper vector."""
    (eager, et), (graphed, gt) = _update_runs(card, name, kw, dtype,
                                              factor=0.5)
    assert (et.eager_updates, et.captures) == (5, 0)
    assert (gt.eager_updates, gt.captures, gt.replays) == (1, 1, 3)
    for a, b in zip(eager, graphed):
        for x, y in zip(a, b):
            assert x.dtype == dtype
            assert torch.equal(x.view(torch.int16 if dtype ==
                                      torch.bfloat16 else torch.int32),
                               y.view(torch.int16 if dtype ==
                                      torch.bfloat16 else torch.int32))
    if name == "nadam":
        assert et.optimizer.m_schedule == gt.optimizer.m_schedule


def test_sgld_replays_draw_new_noise_on_card(card):
    """SGLD's noise comes from the port's generator, registered with the
    update's graph: each replay draws anew, and the replayed run is the
    eager run's sequence."""
    kw = dict(learning_rate=1e-2)
    (eager, _), (graphed, gt) = _update_runs(card, "sgld", kw,
                                             torch.float32)
    assert gt.replays == 3
    steps = [[b - a for a, b in zip(x, y)]
             for x, y in zip(graphed[1:], graphed[2:])]
    for d1, d2 in zip(steps, steps[1:]):
        assert not torch.equal(d1[0], d2[0])
    for a, b in zip(eager, graphed):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


# mobilenet_v2_1_0's pointwise sites that take the CUDA-core instance (C
# not a multiple of 32: 16, 24, 144), at their full HW and a small batch
@pytest.mark.parametrize("C,HW,O", [(16, 12544, 96), (24, 3136, 144),
                                    (144, 3136, 24), (144, 784, 32)])
def test_conv1x1_stats_kernel_at_mobilenet_cuda_core_sites(card, C, HW, O):
    N = 4
    assert tcs.conv1x1_stats_path(N, C, HW, O, torch.bfloat16) == \
        "cuda_cores"
    x, w = _conv_inputs(card, N, C, HW, O, torch.bfloat16)
    y, s1, s2 = tcs.fused_conv1x1_stats(x, w)
    ref_y, ref_s1, ref_s2 = tcs.fused_conv1x1_stats_plain(x, w)
    # as test_conv1x1_stats_kernel_matches_plain_version holds bf16
    exact, bound = tcs.conv1x1_y_bound(x, w)
    for got in (y, ref_y):
        assert bool(((got.double() - exact).abs() <= bound).all())
    n = N * HW
    assert bool(((s1 - ref_s1).abs() <= 1e-5 * (n * ref_s2).sqrt()).all())
    assert bool(((s2 - ref_s2).abs() <= 1e-5 * ref_s2).all())


def test_hybrid_concurrent_fuses_within_branches_on_card(card):
    """A HybridConcurrent whose branches each start with a pointwise
    Conv2D → BatchNorm: one kernel launch per branch in a training
    forward (no pair across two branches), and the output and gradients
    of the CPU copy."""
    nn, cnn = tmx.gluon.nn, tmx.gluon.contrib.nn

    def build():
        net = cnn.HybridConcurrent(axis=1)
        for c in (8, 6):
            branch = nn.HybridSequential()
            branch.add(nn.Conv2D(c, 1, use_bias=False), nn.BatchNorm(),
                       nn.Activation("relu"))
            net.add(branch)
        net.add(cnn.Identity())
        return net
    x = torch.from_numpy(np.random.RandomState(0).randn(
        4, 5, 6, 6).astype(np.float32))
    nets = {}
    for dev in (card, "cpu"):
        nets[dev] = build()
        nets[dev].initialize(ctx=dev)
        with tmx.autograd.pause():
            nets[dev](x.to(dev))
    nets[card].load_state_dict(nets["cpu"].state_dict())
    assert tmx.gluon.nn.fused_pairs(nets[card]) == 2
    outs = {}
    for dev, net in nets.items():
        xd = x.to(dev).requires_grad_()
        before = tcs.conv1x1_stats_launches
        with tmx.autograd.record():
            out = net(xd)
        out.sum().backward()
        outs[dev] = (out.detach().cpu(), xd.grad.cpu(),
                     tcs.conv1x1_stats_launches - before)
    assert outs[card][2] == 2 and outs["cpu"][2] == 0
    assert outs[card][0].shape == (4, 8 + 6 + 5, 6, 6)
    for a, b in zip(outs[card][:2], outs["cpu"][:2]):
        assert (a - b).abs().max() <= 1e-4 * max(1.0, b.abs().max())


# -- slice 19: the fused RNN op, GNMT and Seq2Seq generation on the card -----

@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("bi", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("varlen", [False, True], ids=["dense", "varlen"])
def test_rnn_op_on_card_matches_cpu(card, mode, bi, varlen):
    """chip_smoke.py's rnn phase, one case: nd.RNN / nd.RNN_varlen on the
    card against the CPU, f32 outputs and every input's gradient within
    1e-4 of scale, and bf16 by `rnn_bf16_over_rule`."""
    from chip_smoke import (RNN_TOL, _rnn_case_inputs, _rnn_cotangents,
                            _rnn_run, rnn_bf16_over_rule)
    rs = np.random.RandomState(5)
    arrays, lengths = _rnn_case_inputs(mode, bi, varlen, rs)
    cots = _rnn_cotangents(mode, bi, rs)
    card_f32 = _rnn_run(torch, tmx, mode, bi, arrays, lengths, cots, card,
                        torch.float32)
    cpu_f32 = _rnn_run(torch, tmx, mode, bi, arrays, lengths, cots, "cpu",
                       torch.float32)
    for a, b in zip(card_f32, cpu_f32):
        assert (a - b).abs().max() <= RNN_TOL * max(b.abs().max(), 1.0)
    assert rnn_bf16_over_rule(torch, tmx, mode, bi, arrays, lengths, cots,
                              card) <= 1.0


def test_lstm_layer_matches_cudnn_lstm_on_card(card):
    """The port's LSTM layer (2 layers, bidirectional) against
    torch.nn.LSTM on the same weights, f32 on the card: outputs and
    final states within 1e-4 of scale."""
    T, B, I, H = 9, 3, 12, 16
    tmx.random.seed(3)
    port = tmx.gluon.rnn.LSTM(H, num_layers=2, bidirectional=True,
                              input_size=I, device=card)
    ref = torch.nn.LSTM(I, H, num_layers=2, bidirectional=True).to(card)
    flat, off = port.flat_param.detach(), 0
    with torch.no_grad():
        for layer in range(2):
            for sfx in ("", "_reverse"):
                for kind in ("weight_ih", "weight_hh"):
                    w = getattr(ref, "%s_l%d%s" % (kind, layer, sfx))
                    w.copy_(flat[off:off + w.numel()].reshape(w.shape))
                    off += w.numel()
        for layer in range(2):
            for sfx in ("", "_reverse"):
                for kind in ("bias_ih", "bias_hh"):
                    b = getattr(ref, "%s_l%d%s" % (kind, layer, sfx))
                    b.copy_(flat[off:off + b.numel()])
                    off += b.numel()
    assert off == flat.numel()
    x = torch.randn(T, B, I, device=card)
    with torch.no_grad():
        y, (h, c) = port(x, port.begin_state(batch_size=B))
        ry, (rh, rc) = ref(x)
    for a, b in ((y, ry), (h, rh), (c, rc)):
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1.0)


def test_gnmt_small_hybridized_step_on_card(card):
    """A small GNMT + FusedMLMCELoss trained 3 Adam steps on the card,
    eager and hybridized (eager, capture, replay): bit for bit."""
    V, E, H = 40, 16, 32

    def run(hybrid):
        tmx.random.seed(0)
        net = tmx.models.GNMT(V, V, embed_dim=E, hidden=H, enc_layers=3,
                              dec_layers=2, output_hidden=True, device=card)
        head = tmx.models.FusedMLMCELoss(V, H, device=card)
        if hybrid:
            net.hybridize(static_alloc=True, static_shape=True)
        params = dict(net.collect_params())
        params.update({"loss." + n: p
                       for n, p in head.collect_params().items()})
        trainer = tmx.gluon.Trainer(params, "adam", {"learning_rate": 1e-3})
        rs = np.random.RandomState(0)
        src, tgt = (torch.from_numpy(rs.randint(0, V, (4, 7))).to(card)
                    for _ in range(2))
        lab = torch.from_numpy(rs.randint(0, V, (4, 7)).astype(
            np.float32)).to(card)
        losses = []
        for _ in range(3):
            with tmx.autograd.record():
                loss = head(net(src, tgt), lab)
            tmx.autograd.backward(loss)
            trainer.step(4)
            losses.append(loss.detach().cpu())
        return losses, [p.detach().cpu() for p in params.values()], net

    eager, hyb = run(False), run(True)
    assert all(torch.equal(a, b) for a, b in zip(eager[0], hyb[0]))
    assert all(torch.equal(a, b) for a, b in zip(eager[1], hyb[1]))
    assert hyb[2]._cached_graph.replays >= 1


def test_seq2seq_generation_on_card_equals_eager_greedy(card):
    """GenerationEngine over a Seq2Seq on the card: warmup captures
    buckets + 2 programs, traffic none, and each prompt's tokens equal
    the eager greedy loop's."""
    from chip_smoke import _greedy, _near_tie_compare
    tmx.random.seed(0)
    net = tmx.models.Seq2Seq(31, 31, embed_dim=24, hidden=32, device=card)
    net.initialize(tmx.init.Normal(0.5), ctx=card, force_reinit=True)
    eng = tmx.serving.GenerationEngine(net, bos=1, eos=2, ctx=card, slots=2,
                                       max_len=16, prompt_buckets=(4, 8))
    try:
        t0 = events.get("serve.traces")
        eng.warmup()
        assert events.get("serve.traces") - t0 == 4
        rs = np.random.RandomState(1)
        prompts = [rs.randint(3, 31, (n,)).astype(np.int32)
                   for n in (3, 8, 5)]
        t1 = events.get("serve.traces")
        got = [eng.submit(p, max_new_tokens=10).result(timeout=60)
               for p in prompts]
        assert events.get("serve.traces") == t1
    finally:
        eng.close()
    with torch.no_grad():
        for p, g in zip(prompts, got):
            ref, _, gaps = _greedy(torch, net, p, 10, card, max_len=16,
                                   mem_len=8)
            _near_tie_compare(g, ref, gaps, 2e-3)


# -- the input pipeline ----------------------------------------------------

def test_feed_delivers_equal_bytes_behind_a_busy_stream(card):
    """Each batch the DeviceFeed delivers while the consumer's stream is
    held by a long kernel reads back, on that stream after the kernel,
    as the host bytes: the copies ran on the feed's side stream, the
    consumer waited on their events, and the two pinned staging slots
    were refilled only after their copies ended."""
    rs = np.random.RandomState(0)
    host = [(rs.randint(0, 256, (32, 3, 64, 64), dtype=np.uint8),
             rs.rand(32).astype(np.float32)) for _ in range(6)]
    feed = tmx.io.DeviceFeed(host, ctx=card, depth=2)
    sums = []
    for x, y in feed:
        assert x.context == card and x._data.dtype == torch.uint8
        torch.cuda._sleep(20_000_000)
        sums.append((x._data.to(torch.int64).sum(), y._data.sum()))
        np.testing.assert_array_equal(x.asnumpy(), host[len(sums) - 1][0])
    torch.cuda.synchronize()
    assert len(sums) == 6
    for (s, t), (d, l) in zip(sums, host):
        assert s.item() == int(d.astype(np.int64).sum())
        assert t.item() == pytest.approx(float(l.sum()), rel=1e-6)


def test_feed_tensor_carries_record_stream(card):
    """A delivered tensor freed while the consumer's stream still reads it
    is not handed to the feed's stream: its block waits for the
    consumer's work (record_stream), so a new tensor there gets other
    memory; a tensor of that stream freed the same way without the mark
    gives its block back at once (the control)."""
    n = 1 << 22
    feed = tmx.io.DeviceFeed([(np.full((n,), 7, np.uint8),)], ctx=card,
                             depth=1)
    side = None

    def reused(box):
        t = box.pop()                       # the only reference
        ptr = t.data_ptr()
        torch.cuda._sleep(1_000_000_000)    # the consumer's stream is held
        s = t.to(torch.int64).sum()         # reads t after the kernel
        del t
        with torch.cuda.stream(side):
            u = torch.empty(n, dtype=torch.uint8, device=card)
        again = u.data_ptr() == ptr
        torch.cuda.synchronize()
        return again, s.item()
    (x,) = next(iter(feed))
    side = feed._stager.stream
    box = [x._data]
    del x
    again, total = reused(box)
    assert not again and total == 7 * n
    with torch.cuda.stream(side):
        box = [torch.full((n,), 7, dtype=torch.uint8, device=card)]
    torch.cuda.current_stream(card).wait_stream(side)
    again, total = reused(box)
    assert again and total == 7 * n


def test_input_transform_is_captured_on_card(card):
    """A hybridized ResNet v1b with the normalize installed: the replayed
    call runs it inside the graph (one cudaGraphLaunch, no kernel launch,
    the transform not called), equal to the eager call's output."""
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    tmx.random.seed(0)
    net = resnet.ResNetV1(resnet.BottleneckV1, [1, 1, 1, 1],
                          [8, 16, 32, 64, 128], classes=10, device=card)
    calls = [0]
    norm = tmx.io.normalize_transform(127.5, 64.0, "bfloat16")

    def transform(x):
        calls[0] += 1
        return norm(x)
    net.set_input_transform(transform)
    x = torch.from_numpy(np.random.RandomState(1).randint(
        0, 256, (8, 3, 32, 32)).astype(np.uint8)).to(card)
    with tmx.autograd.pause():
        eager = net(x)
        net.hybridize(static_alloc=True, static_shape=True)
        net(x)
        net(x)                          # eager warm-up, then the capture
        assert calls[0] == 3
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = net(x)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert calls[0] == 3
    assert names.count("cudaGraphLaunch") == 1
    assert not [n for n in names if n.startswith("cudaLaunchKernel")]
    assert net._cached_graph.replays == 1
    assert torch.equal(out, eager)


def test_with_gpu_places_arrays_on_the_card(card):
    """F5: `with gpu(0):` is the default device of the entry points, read
    from torch's DeviceContext (private API) on the card's torch; `with
    cpu():` inside it wins, and an explicit ctx= wins over both."""
    from incubator_mxnet_tpu_torch import context as tctx
    with tmx.gpu(0):
        assert tctx._entered_device() == card
        assert tmx.current_context() == card
        assert tmx.nd.zeros((2,)).context == card
        assert tmx.nd.array([1.0, 2.0]).context == card
        dense = tmx.gluon.nn.Dense(3, in_units=2)
        dense.initialize()
        assert dense.weight.device == card
        with tmx.cpu():
            assert tmx.nd.zeros((2,)).context == torch.device("cpu")
        assert tmx.nd.zeros((2,), ctx="cpu").context == torch.device("cpu")
    assert tctx._entered_device() is None
    assert tmx.current_context() == card


def _wd_card_batch(rs, vocab, B, F, device):
    return [torch.from_numpy(a).to(device) for a in (
        rs.randint(0, vocab, (B, F)).astype(np.int32),
        rs.rand(B, F).astype(np.float32),
        rs.randint(0, 2, B).astype(np.float32))]


def test_bucketed_sparse_trainer_captures_once_per_key(card):
    """BucketedSparseTrainer on the card: one eager step and one CUDA
    graph capture per (K, B, F) key, replays only after that; its losses
    and parameters against the same steps on a CPU copy (within
    chip_smoke.WD_SPARSE_TOL, 1e-3, of scale: Adam's eps zone on
    near-cancelling sums, 2.3e-4 at lr 1e-2 in the deep table on the
    H100; the wide table, whose gradient is rounding noise, by Adam's step
    bound, lr a step)."""
    from incubator_mxnet_tpu_torch.contrib.sparse_jit import \
        BucketedSparseTrainer
    vocab, F = 500, 4
    runs = {}
    for device in (card, torch.device("cpu")):
        rs = np.random.RandomState(0)
        tmx.random.seed(0)
        net = tmx.models.WideDeep(vocab, embed_dim=8, hidden=(16,),
                                  classes=2)
        net.initialize(ctx=device)
        idx, vals, _ = _wd_card_batch(rs, vocab, 2, F, device)
        with tmx.autograd.pause():
            net(idx, vals)
        if device == card:
            init = {k: v.cpu() for k, v in net.state_dict().items()}
        else:
            net.load_state_dict(init)
        jt = BucketedSparseTrainer(net, optimizer="adam", lr=1e-2)
        losses, counts = [], []
        for B in (16, 16, 16, 8, 8, 8, 16, 8):
            losses.append(float(jt.step(*_wd_card_batch(rs, vocab, B, F,
                                                        device)).item()))
            counts.append(jt.captures)
        jt.sync_to_net()
        runs[device.type] = (losses, counts, jt, {
            k: v.detach().cpu() for k, v in net.state_dict().items()})
    losses, counts, jt, params = runs["cuda"]
    assert jt.bucket_keys == [(8 * F, 8, F), (16 * F, 16, F)]
    assert counts == [0, 1, 1, 1, 2, 2, 2, 2]
    assert (jt.captures, jt.eager_steps, jt.replays) == (2, 2, 4)
    assert jt.overflow_steps == 0
    np.testing.assert_allclose(losses, runs["cpu"][0], rtol=0, atol=1e-5)
    for k, v in params.items():
        ref = runs["cpu"][3][k]
        err = (v - ref).abs().max().item()
        limit = 1e-2 * len(losses) if k == "wide.weight" else \
            WD_SPARSE_TOL * max(ref.abs().max().item(), 1e-3)
        assert err <= limit, (k, err)


def test_sparse_trainer_update_keeps_the_dense_capture_on_card(card):
    """The Trainer's lazy update of a row_sparse table runs eagerly beside
    the captured update of a hybridized dense head: the captured update's
    key stays the same, 1 capture, then replays."""
    rs = np.random.RandomState(1)
    V, E, B, T, C = 30, 3, 4, 2, 3
    tmx.random.seed(0)
    emb = tmx.gluon.nn.Embedding(V, E, sparse_grad=True, device=card)
    head = tmx.gluon.nn.HybridSequential()
    head.add(tmx.gluon.nn.Flatten(), tmx.gluon.nn.Dense(C))
    head.initialize(ctx=card)

    def ids():
        return torch.from_numpy(rs.randint(0, V, (B, T)).astype(
            np.int32)).to(card)
    head(emb(ids()))
    head.hybridize()
    params = list(emb.collect_params().values()) + \
        list(head.collect_params().values())
    tr = tmx.gluon.Trainer(params, "adam", {"learning_rate": 0.1})
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    keys = []
    for _ in range(5):
        y = torch.from_numpy(rs.randint(0, C, B).astype(
            np.float32)).to(card)
        with tmx.autograd.record():
            loss = loss_fn(head(emb(ids())), y)
        tmx.autograd.backward(loss)
        tr.step(B)
        keys.append(tr._warm_key)
    torch.cuda.synchronize()
    assert (tr.eager_updates, tr.captures, tr.replays,
            tr.sparse_updates) == (1, 1, 3, 5)
    assert all(k == keys[0] for k in keys)
    assert emb.weight.grad.is_sparse


def _dp_mlp(device):
    nn = tmx.gluon.nn
    tmx.random.seed(0)
    net = nn.HybridSequential()
    net.add(nn.Dense(32, activation="relu", in_units=16, device=device),
            nn.Dense(4, in_units=32, device=device))
    return net


@pytest.mark.parametrize("zero", [0, 1, 2, 3])
def test_sharded_trainer_on_card_matches_cpu(card, zero):
    """One replica on the card (eager, captured, replayed steps) against
    the same trainer on the CPU; a 2-replica zero-2 mesh on the card
    against 2 CPU replicas."""
    from incubator_mxnet_tpu_torch import parallel
    rs = np.random.RandomState(0)
    xs = [rs.randn(8, 16).astype(np.float32) for _ in range(4)]
    ys = [rs.randint(0, 4, 8) for _ in range(4)]
    for devs, cpus in ((["cuda:0"], ["cpu"]),
                       (["cuda:0", "cuda:0"], [tmx.cpu(0), tmx.cpu(1)])):
        z = zero if len(devs) == 1 else 2
        runs = []
        card_net = _dp_mlp("cuda:0")
        cpu_net = _dp_mlp("cpu")
        cpu_net.load_state_dict({k: v.cpu() for k, v in
                                 card_net.state_dict().items()})
        for mesh_devs, net in ((devs, card_net), (cpus, cpu_net)):
            t = parallel.ShardedTrainer(
                net, mesh=parallel.make_mesh(devices=mesh_devs),
                zero=z, optimizer="adam", lr=0.01, wd=1e-4)
            losses = [float(t.step(x, y)) for x, y in zip(xs, ys)]
            runs.append((losses, t.params, t))
        (cl, cp, ct), (hl, hp, _) = runs
        np.testing.assert_allclose(cl, hl, rtol=1e-5, atol=1e-6)
        for k, v in hp.items():
            np.testing.assert_allclose(cp[k].cpu().numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-6)
        if len(devs) == 1:
            assert (ct.eager_steps, ct.captures, ct.replays) == (1, 1, 2)


def test_kvstore_paths_on_card_equal_cpu(card):
    from incubator_mxnet_tpu_torch import kvstore
    rs = np.random.RandomState(1)
    vals = [rs.randn(6, 5).astype(np.float32) for _ in range(3)]
    out = {}
    for dev in ("cuda:0", "cpu"):
        kv = kvstore.create("device")
        kv.init("w", tmx.nd.zeros((6, 5), ctx=dev))
        kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9))
        kv.push("w", [tmx.nd.array(v, ctx=dev) for v in vals])
        o = tmx.nd.zeros((6, 5), ctx=dev)
        kv.pull("w", out=o)
        r = tmx.nd.zeros((6, 5), ctx=dev)
        kv.row_sparse_pull("w", out=r, row_ids=tmx.nd.array(
            [4, 1], dtype="int32", ctx=dev))
        a = [tmx.nd.array(v, ctx=dev) for v in vals]
        kv.init("p", tmx.nd.zeros((6, 5), ctx=dev))
        kv.pushpull("p", a, out=a)
        out[dev] = (o.asnumpy(), r.asnumpy(), a[0].asnumpy())
    for got, ref in zip(out["cuda:0"], out["cpu"]):
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_gluon_loop_on_card_with_device_kvstore(card):
    """Parameters on [gpu(0)]: the Gluon loop's kvstore paths bit for bit
    the loop without one."""
    res = []
    for kv in (None, "device"):
        net = _dp_mlp(None)
        net.initialize(ctx=[tmx.gpu(0)])
        tr = tmx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.1, "momentum": 0.9}, kvstore=kv)
        rs = np.random.RandomState(2)
        for _ in range(3):
            x = rs.randn(8, 16).astype(np.float32)
            data = tmx.gluon.utils.split_and_load(x, [tmx.gpu(0)])
            with tmx.autograd.record():
                loss = net(data[0]).square().mean()
            tmx.autograd.backward(loss)
            tr.step(8)
        res.append({k: p.detach().cpu() for k, p in
                    net.collect_params().items()})
    for k in res[0]:
        assert torch.equal(res[0][k], res[1][k]), k
