"""PyTorch port: flash-attention forward against the JAX package.

On the CPU the port's `flash_attention_fwd` takes its plain version; it is
held against the JAX Pallas kernel `_flash_fwd` run in interpret mode
(blocks of 128, as test_attention.py sets it up) and against the JAX
`naive_attention`.  The CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu.ops import attention as jatt
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import _kernels
from incubator_mxnet_tpu_torch.ops import attention as tatt

pytestmark = pytest.mark.torch_port

TOL = 2e-5      # f32, the same sums in another order (test_attention.py)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("MXNET_FLASH_BLOCK_Q", "128")
    monkeypatch.setenv("MXNET_FLASH_BLOCK_K", "128")


def _arrays(*shape, n=3, seed=7):
    rs = np.random.RandomState(seed)
    return [(rs.randn(*shape) * 0.5).astype(np.float32) for _ in range(n)]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_matches_pallas_kernel(pallas_interpret, causal):
    q, k, v = _arrays(4, 256, 64)
    scale = 1.0 / math.sqrt(64)
    jout, jlse = jatt._flash_fwd(*_jax(q, k, v), scale, causal)
    assert jlse.shape == (4, 256, 128)      # lane-replicated on the TPU
    out, lse = tatt.flash_attention_fwd(*_torch(q, k, v), scale, causal)
    assert out.dtype == torch.float32 and lse.shape == (4, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_contrib_flash_attention_matches_jax(causal):
    B, T, H, d = 2, 64, 4, 16
    q, k, v = _arrays(B, T, H * d, seed=3)
    jout = jatt._contrib_flash_attention(*_jax(q, k, v), num_heads=H,
                                         causal=causal)
    out = tatt._contrib_flash_attention(*_torch(q, k, v), num_heads=H,
                                        causal=causal)
    assert out.shape == (B, T, H * d)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_T_matches_jax_naive(causal):
    # T = 200 tiles by neither 64 nor 128: the kernel masks the ragged
    # tile itself instead of falling back as the JAX _tiles_ok does
    q, k, v = _arrays(3, 200, 32, seed=5)
    scale = 0.2
    ref = jatt.naive_attention(*_jax(q, k, v), scale, causal=causal)
    out, lse = tatt.flash_attention_fwd(*_torch(q, k, v), scale, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    if causal:
        s = np.where(np.tril(np.ones((200, 200), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    ref_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=TOL, atol=TOL)


def test_bf16_plain_matches_jax_naive():
    # bf16 rounds P at another point than the naive path (before P·V on
    # unnormalized P vs after softmax): bf16 precision, 2e-2
    q, k, v = _arrays(2, 128, 64, seed=11)
    tq, tk, tv = (t.to(torch.bfloat16) for t in _torch(q, k, v))
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (tq, tk, tv))
    ref = jatt.naive_attention(jq, jk, jv, 0.125)
    out, lse = tatt.flash_attention_fwd(tq, tk, tv, 0.125)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_f16_plain_matches_jax_naive():
    # f16 rounds P at another point than the naive path, as bf16 does
    # above, with 3 more bits: 2e-2 / 8
    q, k, v = _arrays(2, 128, 64, seed=11)
    tq, tk, tv = (t.half() for t in _torch(q, k, v))
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.float16)
                  for t in (tq, tk, tv))
    ref = jatt.naive_attention(jq, jk, jv, 0.125)
    out, lse = tatt.flash_attention_fwd(tq, tk, tv, 0.125)
    assert out.dtype == torch.float16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=2.5e-3, atol=2.5e-3)


def test_flash_attention_with_bias_matches_jax():
    q, k, v = _arrays(2, 2, 64, 16, seed=13)
    bias = _arrays(64, 64, n=1, seed=14)[0]
    ref = jatt.flash_attention(*_jax(q, k, v), bias=jnp.asarray(bias))
    out = tatt.flash_attention(*_torch(q, k, v), bias=torch.from_numpy(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               rtol=TOL, atol=TOL)


def test_cpu_tensor_takes_plain_version_without_launch(monkeypatch):
    q, k, v = _torch(*_arrays(2, 96, 32, seed=17))
    monkeypatch.setattr(tatt, "flash_fwd_launches", 0)
    out, lse = tatt.flash_attention_fwd(q, k, v, 0.3, True)
    ref_out, ref_lse = tatt.flash_attention_fwd_plain(q, k, v, 0.3, True)
    assert tatt.flash_fwd_launches == 0
    assert torch.equal(out, ref_out) and torch.equal(lse, ref_lse)


def test_other_device_raises_instead_of_falling_back():
    q = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tatt.flash_attention_fwd(q, q, q, 0.25)


@pytest.mark.parametrize("case", ["dtype", "head_dim", "layout", "shape"])
def test_kernel_operand_checks_raise(case):
    q = torch.zeros((2, 16, 64))
    k = v = q
    if case == "dtype":
        q = k = v = q.double()
    elif case == "head_dim":
        q = k = v = torch.zeros((2, 16, 48))
    elif case == "layout":
        q = torch.zeros((2, 64, 16)).transpose(1, 2)
        k = v = q.contiguous()
    else:
        k = torch.zeros((2, 8, 64))
    with pytest.raises(ValueError):
        tatt._check_kernel_operands(q, k, v)


def test_kernel_build_command_and_missing_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    cmd = _kernels._command("flash_attention_fwd.cu", "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    monkeypatch.undo()
    # no nvcc anywhere: a clear error at first use, never at import
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_kernels, "_BUILD", tmp_path / "kernels")
    monkeypatch.setattr(_kernels, "_LIBS", {})
    with pytest.raises(MXNetError, match="nvcc not found"):
        _kernels.library("flash_attention_fwd")
