"""PyTorch port on the card: the CUDA kernels against their plain versions,
and the serving and training paths through them.

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

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = prev


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


@pytest.mark.parametrize("BH,T,d,dtype,causal", [
    (8, 512, 64, torch.float32, False),
    (8, 512, 64, torch.float32, True),
    (8, 200, 128, torch.float32, True),
    (8, 77, 16, torch.float32, False),
    (8, 200, 64, torch.bfloat16, True),
    (8, 256, 32, torch.bfloat16, False),
    (4, 130, 128, torch.bfloat16, False),
])
def test_flash_bwd_kernels_match_plain_version(card, BH, T, d, dtype,
                                               causal):
    gen = torch.Generator(device=card)
    gen.manual_seed(1)
    q, k, v, do = (torch.randn(BH, T, d, device=card, generator=gen)
                   .mul_(0.5).to(dtype) for _ in range(4))
    scale = d ** -0.5
    out, lse = tatt.flash_attention_fwd(q, k, v, scale, causal)
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
