"""PyTorch port: flash-attention backward against the JAX package.

On the CPU the port's `flash_attention_bwd` takes its plain version
(`flash_attention_bwd_dq_plain` then `flash_attention_bwd_dkv_plain`).
It is held against the JAX Pallas kernels `_dq_kernel`/`_dkv_kernel`
(`_flash_bwd_pallas`) run in interpret mode with blocks of 128, as
test_attention.py sets them up, and against `jax.grad` of the JAX
`naive_attention` and `_contrib_flash_attention`.  The CUDA kernels run
only on the card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import attention as jatt
from incubator_mxnet_tpu_torch.ops import _kernels
from incubator_mxnet_tpu_torch.ops import attention as tatt

pytestmark = pytest.mark.torch_port

TOL = 1e-5      # f32 against the Pallas kernels: the same sums in another order


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MXNET_FLASH_BLOCK_Q", "128")
    monkeypatch.setenv("MXNET_FLASH_BLOCK_K", "128")


def _arrays(*shape, n=4, seed=7):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*shape) * 0.5).astype(np.float32) for _ in range(n)]


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _pallas_bwd(q, k, v, do, scale, causal):
    """JAX forward kernel, then the Pallas dq/dkv kernels; returns the
    forward's out and (BH, T) lse beside (dq, dk, dv)."""
    q, k, v, do = (jnp.asarray(a) for a in (q, k, v, do))
    out, lse128 = jatt._flash_fwd(q, k, v, scale, causal)
    grads = jatt._flash_bwd_pallas(q, k, v, out, lse128, do, scale, causal)
    return out, lse128[..., 0], grads


# every head dim the CUDA kernels take; d = 32 keeps its first ids
@pytest.mark.parametrize("d,causal", [
    pytest.param(d, causal, id=str(causal) if d == 32 else
                 "d%d-%s" % (d, causal))
    for d in tatt.KERNEL_HEAD_DIMS for causal in (False, True)])
def test_bwd_plain_matches_pallas_kernels(pallas_interpret, d, causal):
    # T = 256 with 128-blocks: a 2 x 2 grid of (q, k) blocks per head, so
    # the Pallas kernels carry their accumulators across blocks
    BH, T = 2, 256
    assert jatt._bwd_block_sizes(T) == (128, 128)
    q, k, v, do = _arrays(BH, T, d)
    scale = 1.0 / np.sqrt(d)
    out, lse, ref = _pallas_bwd(q, k, v, do, scale, causal)
    got = tatt.flash_attention_bwd(*_torch(q, k, v, out, lse, do), scale,
                                   causal)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and g.shape == (BH, T, d)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=TOL,
                                   atol=TOL)


BWD_TOL = 1e-4      # chip_smoke.BWD_TOL: f32 kernels against the plain version


def _tf32(x, nearest=True):
    """x cut to TF32 (10 mantissa bits): to nearest with ties away from
    zero, as the kernels round `big`, or truncated, as the tensor cores
    read `small`."""
    bits = x.contiguous().view(torch.int32)
    return (((bits + 0x1000) if nearest else bits) & ~0x1fff) \
        .view(torch.float32)


def _matmul_3xtf32(a, b):
    """a·b as the f32 kernels compute it on the tensor cores: each operand
    split into big = tf32(x) and small = x - big (read as truncated TF32),
    then big·big + big·small + small·big with f32 accumulation."""
    ab, bb = _tf32(a), _tf32(b)
    as_, bs = _tf32(a - ab, nearest=False), _tf32(b - bb, nearest=False)
    return (torch.matmul(as_, bb) + torch.matmul(ab, bs)
            + torch.matmul(ab, bb))


def _matmul_1xtf32(a, b):
    return torch.matmul(_tf32(a), _tf32(b))


@pytest.mark.parametrize("d", tatt.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("causal", [False, True])
def test_bwd_3xtf32_products_stay_within_f32_tolerance(monkeypatch, d,
                                                       causal):
    # the accuracy argument of the f32 kernels: the plain backward with
    # every product in 3xTF32 stays within BWD_TOL of its largest gradient
    # of the f32 plain backward (about 1e-6 here), where one TF32 product
    # per product (which the parity contract forbids) does not (4e-4 and
    # more), so the tolerance tells the two apart
    q, k, v, do = _torch(*_arrays(2, 96, d, seed=11))
    scale = 1.0 / np.sqrt(d)
    out, lse = tatt.flash_attention_fwd_plain(q, k, v, scale, causal)
    ref = tatt.flash_attention_bwd_plain(q, k, v, out, lse, do, scale, causal)

    def err(matmul):
        monkeypatch.setattr(tatt, "_matmul", matmul)
        got = tatt.flash_attention_bwd_plain(q, k, v, out, lse, do, scale,
                                             causal)
        return max(((g - r).abs().max() / r.abs().max()).item()
                   for g, r in zip(got, ref))

    assert err(_matmul_3xtf32) <= BWD_TOL
    assert err(_matmul_1xtf32) > BWD_TOL


def test_bwd_plain_bf16_matches_pallas_kernels(pallas_interpret):
    # bf16: both round P to dO's dtype before dV and dS to k's/q's dtype
    # before dQ/dK, and round the outputs.  Sums in another f32 order can
    # tip a rounding by one bf16 ulp (2**-8 relative), so each element is
    # held to 2**-6 (|ref| + rms(ref)): at least 2 ulps of itself, and
    # rms(ref) covers the elements near zero
    BH, T, d = 2, 256, 32
    arrays = [jnp.asarray(a, jnp.bfloat16) for a in _arrays(BH, T, d,
                                                              seed=9)]
    scale = 1.0 / np.sqrt(d)
    out, lse, ref = _pallas_bwd(*arrays, scale, True)
    tq, tk, tv, tdo, tout = (torch.from_numpy(np.array(a, np.float32))
                             .to(torch.bfloat16)
                             for a in (*arrays, out))
    got = tatt.flash_attention_bwd(tq, tk, tv, tout,
                                   torch.from_numpy(np.array(lse)), tdo,
                                   scale, True)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        bound = 2.0 ** -6 * (np.abs(r) + np.sqrt(np.mean(r ** 2)))
        assert (np.abs(g.float().numpy() - r) <= bound).all()


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_T_grads_match_jax_naive(causal):
    # T = 200 tiles by neither 64 nor 128: the kernels mask the ragged
    # tile, where the JAX Pallas backward takes only a T that tiles
    q, k, v, w = _arrays(3, 200, 32, seed=5)
    scale = 0.2

    def f(q, k, v):
        return jnp.sum(jatt.naive_attention(q, k, v, scale, causal=causal)
                       * w)

    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    out = tatt.flash_attention(tq[None], tk[None], tv[None], scale, causal)
    (out[0] * torch.from_numpy(w)).sum().backward()
    for t, r in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-4)


def _grad_fn_names(t):
    names, stack, seen = set(), [t.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(n for n, _ in fn.next_functions)
    return names


@pytest.mark.parametrize("causal", [False, True])
def test_contrib_flash_attention_grads_match_jax(causal):
    # the repair: gradients reach query/key/value through the Function on
    # both devices (on the card the forward kernel's outputs had none)
    B, T, H, d = 2, 64, 4, 16
    q, k, v, w = _arrays(B, T, H * d, seed=3)

    def f(q, k, v):
        return jnp.sum(jatt._contrib_flash_attention(
            q, k, v, num_heads=H, causal=causal) * w)

    ref = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    out = tatt._contrib_flash_attention(tq, tk, tv, num_heads=H,
                                        causal=causal)
    assert "_FlashAttentionBackward" in _grad_fn_names(out)
    (out * torch.from_numpy(w)).sum().backward()
    for t, r in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=2e-5)


def test_cpu_backward_launches_nothing(monkeypatch):
    for name in ("flash_fwd_launches", "flash_bwd_dq_launches",
                 "flash_bwd_dkv_launches"):
        monkeypatch.setattr(tatt, name, 0)
    q, k, v, do = _torch(*_arrays(2, 96, 32, seed=17))
    out, lse = tatt.flash_attention_fwd(q, k, v, 0.3, True)
    got = tatt.flash_attention_bwd(q, k, v, out, lse, do, 0.3, True)
    ref = tatt.flash_attention_bwd_plain(q, k, v, out, lse, do, 0.3, True)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    x = q.clone().requires_grad_()
    tatt.flash_attention(x, k, v, 0.3).sum().backward()
    assert x.grad is not None
    assert (tatt.flash_fwd_launches, tatt.flash_bwd_dq_launches,
            tatt.flash_bwd_dkv_launches) == (0, 0, 0)


def test_inference_mode_saves_nothing():
    q = torch.randn(1, 2, 16, 16, requires_grad=True)
    with torch.inference_mode():
        out = tatt.flash_attention(q, q, q)
    assert out.grad_fn is None and not out.requires_grad


@pytest.mark.parametrize("case", ["dtype", "head_dim", "out_shape", "layout",
                                  "lse_dtype", "lse_shape", "device",
                                  "alignment"])
def test_bwd_operand_checks_raise(case):
    q = torch.zeros((2, 16, 64))
    k = v = out = do = q
    lse = delta = torch.zeros((2, 16))
    if case == "dtype":
        q = k = v = out = do = q.half()
    elif case == "head_dim":
        q = k = v = out = do = torch.zeros((2, 16, 48))
    elif case == "out_shape":
        out = torch.zeros((2, 8, 64))
    elif case == "layout":
        do = torch.zeros((2, 64, 16)).transpose(1, 2)
    elif case == "lse_dtype":
        lse = lse.double()
    elif case == "lse_shape":
        delta = torch.zeros((2, 17))
    with pytest.raises(ValueError):
        if case == "device":
            m = torch.empty((2, 16, 64), device="meta")
            tatt.flash_attention_bwd(m, m, m, m, lse, m, 0.1)
        if case == "alignment":
            # 4 bytes past a 16-byte boundary: the cp.async loads refuse it
            flat = torch.zeros(2 * 16 * 64 + 4)
            first = (-flat.data_ptr() // 4) % 4 + 1
            tatt._check_aligned(q, flat[first:first + 2 * 16 * 64]
                                .view(2, 16, 64), name="bwd")
        tatt._check_kernel_operands(q, k, v, out, do, name="bwd")
        tatt._check_row_stats(q, lse, delta, name="bwd")


def test_bwd_kernel_is_registered_for_the_build():
    src, fns = _kernels.SOURCES["flash_attention_bwd"]
    assert src == "flash_attention_bwd.cu"
    assert set(fns) == {"mxt_flash_attention_bwd_dq",
                        "mxt_flash_attention_bwd_dkv"}
    text = (_kernels._CSRC / src).read_text()
    for fn in fns:
        assert 'extern "C" int %s(' % fn in text


@pytest.mark.parametrize("causal", [False, True])
def test_head_dim_without_kernel_takes_naive_attention(monkeypatch, causal):
    # 768 units over 16 heads: d 48 has no kernel instance, so the
    # dispatcher sends it to naive_attention (plain autograd) on both
    # devices, as the JAX package's flash_attention does
    B, T, H, d = 1, 32, 16, 48
    q, k, v, w = _arrays(B, T, H * d, seed=11)
    calls = []
    naive = tatt.naive_attention
    monkeypatch.setattr(tatt, "naive_attention",
                        lambda *a, **kw: calls.append(1) or naive(*a, **kw))

    def f(q, k, v):
        return jatt._contrib_flash_attention(q, k, v, num_heads=H,
                                             causal=causal)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = f(jq, jk, jv)
    ref_grads = jax.grad(lambda *a: jnp.sum(f(*a) * w),
                         argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (t.requires_grad_() for t in _torch(q, k, v))
    out = tatt._contrib_flash_attention(tq, tk, tv, num_heads=H,
                                        causal=causal)
    assert calls == [1]
    assert "_FlashAttentionBackward" not in _grad_fn_names(out)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
    (out * torch.from_numpy(w)).sum().backward()
    for t, r in zip((tq, tk, tv), ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=2e-5,
                                   atol=2e-5)
    # the kernel wrappers themselves still refuse the head dim
    with pytest.raises(ValueError, match="head dim 48"):
        tatt._check_kernel_operands(*(torch.zeros(2, 16, 48),) * 3)
