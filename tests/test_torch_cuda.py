"""PyTorch port on the card: the CUDA kernels against their plain versions,
and the serving and training paths (BERT, ResNet) through them.

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

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]


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
        # both outputs rounded to bf16, and P rounded against the running
        # max in the kernel but the final max in the plain version:
        # 2**-6 |ref| is at least 2 bf16 ulps of each element, and
        # 2**-6 rms(ref) covers the elements near zero
        tol = 2.0 ** -6 * (ref.abs() + ref.pow(2).mean().sqrt())
    assert bool(((out.float() - ref).abs() <= tol).all())
    # lse comes from f32 scores in both dtypes
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def test_flash_kernel_raises_on_what_it_does_not_take(card):
    q = torch.zeros((2, 16, 48), device=card)
    before = tatt.flash_fwd_launches
    with pytest.raises(ValueError, match="head dim"):
        tatt.flash_attention_fwd(q, q, q, 0.1)
    h = torch.zeros((2, 16, 64), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tatt.flash_attention_fwd(h, h, h, 0.1)
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
            # P and dS rounded at the same points, outputs rounded to
            # bf16: 2**-6 (|ref| + rms(ref)) is at least 2 bf16 ulps
            tol = 2.0 ** -6 * (r.abs() + r.pow(2).mean().sqrt())
        assert bool(((got.float() - r).abs() <= tol).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
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


@pytest.mark.parametrize("N,C,HW,O", [
    (3, 72, 49, 80), (5, 17, 33, 65), (2, 256, 196, 128), (1, 1, 1, 1),
    (4, 64, 3136, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv1x1_stats_kernel_matches_plain_version(card, N, C, HW, O,
                                                    dtype):
    gen = torch.Generator(device=card)
    gen.manual_seed(2)
    x = torch.randn(N, C, HW, device=card, generator=gen).to(dtype)
    w = (torch.randn(O, C, device=card, generator=gen) * 0.05).to(dtype)
    before = tcs.conv1x1_stats_launches
    y, s1, s2 = tcs.fused_conv1x1_stats(x, w)
    torch.cuda.synchronize()
    assert tcs.conv1x1_stats_launches == before + 1
    assert y.dtype == dtype and y.shape == (N, O, HW)
    assert s1.shape == s2.shape == (1, O) and s1.dtype == torch.float32
    ref_y, ref_s1, ref_s2 = tcs.fused_conv1x1_stats_plain(x, w)
    ref = ref_y.float()
    if dtype == torch.float32:
        tol = 1e-4 * ref.abs().max()        # f32 sums over C in another order
    else:
        # both round the f32 accumulator to bf16: one ulp apart at most
        tol = 2.0 ** -7 * ref.abs()
    assert bool(((y.float() - ref).abs() <= tol).all())
    # the sums of N·HW f32 terms in another order: Σy within 1e-5 of
    # sqrt(N·HW·Σy²) (at least Σ|y|), Σy² within 1e-5 of itself
    n = N * HW
    assert bool(((s1 - ref_s1).abs() <= 1e-5 * (n * ref_s2).sqrt()).all())
    assert bool(((s2 - ref_s2).abs() <= 1e-5 * ref_s2).all())


def test_conv1x1_stats_kernel_raises_on_what_it_does_not_take(card):
    x = torch.zeros(2, 8, 10, device=card)
    w = torch.zeros(4, 8, device=card)
    before = tcs.conv1x1_stats_launches
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tcs.fused_conv1x1_stats(x.half(), w.half())
    with pytest.raises(ValueError, match="contiguous"):
        tcs.fused_conv1x1_stats(x.transpose(0, 1).contiguous()
                                .transpose(0, 1), w)
    with pytest.raises(ValueError, match="different devices"):
        tcs.fused_conv1x1_stats(x, w.cpu())
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
