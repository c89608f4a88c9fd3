"""PyTorch port on the card: the CUDA kernels against their plain versions,
and the serving and training paths (BERT in f32 and bf16, ResNet,
Transformer NMT and its cached decode step) through them, and float16
through the kernels' f16 instances.

Marked `cuda`; each test skips without a CUDA device.  This file imports
neither JAX nor the JAX package, so on a machine with the card (and no
JAX) it runs without the repository's conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.ops import attention as tatt
from incubator_mxnet_tpu_torch.ops import conv_stats as tcs
from incubator_mxnet_tpu_torch.ops import nn as tnn
from chip_smoke import _low_tolerance

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
    futs = [eng.submit(t) for t in toks]
    outs = [f.result(timeout=60) for f in futs]
    assert eng.close(timeout=30)
    st = eng.stats()
    batches = st["batches"] + st["warmup_batches"]
    assert tatt.flash_fwd_launches - before == 2 * batches  # 2 layers
    cpu = tmx.models.bert_small(vocab_size=100, max_length=64,
                                device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    with torch.inference_mode():
        ref = cpu.eval()(torch.from_numpy(toks))
    for o, r in zip(outs, ref):
        assert o.device == card
        assert (o.cpu() - r).abs().max().item() <= 1e-4


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
    net = resnet.ResNetV1(*args, **kw)
    cpu = resnet.ResNetV1(*args, device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(4, 3, 16, 16).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 4).astype(np.float32))
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
    net.add(tmx.gluon.nn.Conv2D(32, 1, use_bias=False, in_channels=32),
            tmx.gluon.nn.BatchNorm(in_channels=32))
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
