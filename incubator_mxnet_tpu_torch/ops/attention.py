"""Fused (flash) multi-head self-attention of the PyTorch port
(counterpart of incubator_mxnet_tpu/ops/attention.py).

Three functions over (BH, T, d) operands are the kernels that the JAX
package runs in Pallas, each a hand-written CUDA kernel here:

* `flash_attention_fwd(q, k, v, scale, causal) -> (out, lse)`, the
  Pallas `_fwd_kernel`: `csrc/flash_attention_fwd.cu`;
* `flash_attention_bwd_dq(...) -> (dq, delta)`, the Pallas `_dq_kernel`,
  and `flash_attention_bwd_dkv(...) -> (dk, dv)`, the Pallas
  `_dkv_kernel`: `csrc/flash_attention_bwd.cu`.  `delta` is
  D = rowsum(dO * O), (BH, T) f32, which the dQ kernel writes and the
  dK/dV kernel reads.

For each of them:

* a CUDA tensor launches the kernel, or raises `ValueError` for what the
  kernel does not take (dtype, head dim, layout);
* a CPU tensor takes its plain PyTorch version (`*_plain`), with the
  same rounding points;
* there is no fallback between the two and no size threshold.

`_FlashAttention` is the `torch.autograd.Function` that ties them
together: its forward is `flash_attention_fwd` and saves (q, k, v, out,
lse); its backward is `flash_attention_bwd`.  `flash_attention` and
`_contrib_flash_attention` go through it on both devices for the head
dims the kernels take (`KERNEL_HEAD_DIMS`), as the JAX package's
`_pallas_enabled` dispatches by tile shape, and through `naive_attention`
for the others.  Every float dtype of the JAX kernels has an instance
(`KERNEL_DTYPES`: f32, bf16, f16); any other dtype reaches the wrappers
and raises on the card.

`flash_fwd_launches`, `flash_bwd_dq_launches` and `flash_bwd_dkv_launches`
count kernel launches, so a run can show that its attention went through
the kernels; `flash_fwd_causal_launches` and its two siblings count the
causal ones among them.
"""
from __future__ import annotations

import math

import torch

from . import _kernels

__all__ = ["naive_attention", "flash_attention_fwd",
           "flash_attention_fwd_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_bwd_dq",
           "flash_attention_bwd_dq_plain", "flash_attention_bwd_dkv",
           "flash_attention_bwd_dkv_plain", "flash_attention",
           "_contrib_flash_attention", "KERNEL_HEAD_DIMS", "KERNEL_DTYPES"]

_NEG_INF = -1e30

#: head dims the CUDA kernels have template instances for
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
#: operand dtypes the CUDA kernels have template instances for
KERNEL_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_KERNEL_DTYPES = {dt: i for i, dt in enumerate(KERNEL_DTYPES)}

#: the product of the plain versions; a test swaps in an emulation of the
#: f32 kernels' 3xTF32 split to hold its accuracy
_matmul = torch.matmul

#: launches of the CUDA flash-attention kernels in this process
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0
flash_fwd_causal_launches = 0
flash_bwd_dq_causal_launches = 0
flash_bwd_dkv_causal_launches = 0


def naive_attention(q, k, v, scale, causal=False, bias=None):
    """softmax(q k^T * scale [+ bias]) v over (..., T, d) operands, with
    f32 scores and the probabilities cast to the operand dtype."""
    f32 = torch.float32
    s = torch.matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(f32)
    if causal:
        T, S = s.shape[-2], s.shape[-1]
        mask = torch.ones((T, S), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(q.dtype), v)


def _scores(q, k, scale, causal):
    """f32 S = q k^T * scale, -1e30 above the diagonal when causal."""
    f32 = torch.float32
    s = _matmul(q.to(f32), k.to(f32).transpose(-1, -2)) * scale
    if causal:
        T = s.shape[-1]
        mask = torch.ones((T, T), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    return s


def flash_attention_fwd_plain(q, k, v, scale, causal=False):
    """Plain PyTorch version of the forward kernel: (BH, T, d) → out
    (BH, T, d) in the operand dtype and lse (BH, T) f32.  f32 scores,
    masked softmax, unnormalized probabilities rounded to the operand
    dtype before P·V and divided by the row sum after it, as the kernel
    does."""
    f32 = torch.float32
    s = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = _matmul(p.to(q.dtype).to(f32), v.to(f32))
    out = (acc / l).to(q.dtype)
    return out, (m + torch.log(l)).squeeze(-1)


def flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, scale,
                                 causal=False):
    """Plain PyTorch version of the dQ kernel: → dq (BH, T, d) in q's
    dtype and delta = rowsum(dO * O) (BH, T) f32.  P = exp(S - lse),
    dS = P (dO V^T - delta) scale in f32, rounded to k's dtype before
    dQ = dS K."""
    f32 = torch.float32
    do = dout.to(f32)
    delta = (do * out.to(f32)).sum(-1)
    p = torch.exp(_scores(q, k, scale, causal) - lse.unsqueeze(-1))
    dp = _matmul(do, v.to(f32).transpose(-1, -2))
    ds = p * (dp - delta.unsqueeze(-1)) * scale
    dq = _matmul(ds.to(k.dtype).to(f32), k.to(f32))
    return dq.to(q.dtype), delta


def flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, scale,
                                  causal=False):
    """Plain PyTorch version of the dK/dV kernel: → dk, dv (BH, T, d) in
    k's and v's dtype, from `delta` of the dQ step.  P rounded to dO's
    dtype before dV = P^T dO, dS rounded to q's dtype before
    dK = dS^T Q."""
    f32 = torch.float32
    do = dout.to(f32)
    p = torch.exp(_scores(q, k, scale, causal) - lse.unsqueeze(-1))
    dv = _matmul(p.to(dout.dtype).to(f32).transpose(-1, -2), do)
    dp = _matmul(do, v.to(f32).transpose(-1, -2))
    ds = p * (dp - delta.unsqueeze(-1)) * scale
    dk = _matmul(ds.to(q.dtype).to(f32).transpose(-1, -2), q.to(f32))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, out, lse, dout, scale, causal=False):
    """Plain PyTorch version of the whole backward: → dq, dk, dv.  The
    from-lse backward of the JAX package, split as the kernels split it."""
    dq, delta = flash_attention_bwd_dq_plain(q, k, v, out, lse, dout, scale,
                                             causal)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, dout, lse, delta, scale,
                                           causal)
    return dq, dk, dv


def _check_kernel_operands(q, k, v, *more, name="flash_attention_fwd"):
    """q, k, v and the (BH, T, d) tensors in `more` (out, dO) must share
    device, dtype and shape, be contiguous, and have an instance."""
    ops = (q, k, v) + more
    if any(t.device != q.device for t in ops):
        raise ValueError("%s operands lie on different devices: %s"
                         % (name, ", ".join(str(t.device) for t in ops)))
    if q.dtype not in _KERNEL_DTYPES or any(t.dtype != q.dtype for t in ops):
        raise ValueError(
            "%s kernel takes float32, bfloat16 or float16 operands of one "
            "dtype, got %s" % (name, ", ".join(str(t.dtype) for t in ops)))
    if q.ndim != 3 or any(t.shape != q.shape for t in ops):
        raise ValueError("%s needs operands of one shape (BH, T, d), got %s"
                         % (name, ", ".join(str(tuple(t.shape))
                                            for t in ops)))
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError("%s kernel has no instance for head dim %d "
                         "(supported: %s)"
                         % (name, q.shape[-1], KERNEL_HEAD_DIMS))
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("%s kernel needs contiguous (BH, T, d) operands"
                         % name)
    if q.numel() >= 2 ** 31 or q.shape[1] > 65535 * 64:
        raise ValueError("%s kernel takes < 2**31 elements per operand and "
                         "T <= %d" % (name, 65535 * 64))


def _check_aligned(*ops, name):
    """The kernels copy (BH, T, d) rows in 16-byte pieces (cp.async), so
    each operand must start on a 16-byte boundary."""
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError("%s kernel needs (BH, T, d) operands that start on "
                         "16-byte boundaries" % name)


def _check_row_stats(q, *rows, name):
    """Per-row statistics (lse, delta) must be contiguous (BH, T) f32 on
    q's device."""
    for t in rows:
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != tuple(q.shape[:2])
                or not t.is_contiguous()):
            raise ValueError(
                "%s needs contiguous float32 row statistics of shape %s on "
                "%s, got %s %s on %s" % (name, tuple(q.shape[:2]), q.device,
                                         t.dtype, tuple(t.shape), t.device))


def _launched(rc, name):
    if rc != 0:
        raise RuntimeError("%s kernel launch failed with CUDA error %d"
                           % (name, rc))


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _flash_fwd_cuda(q, k, v, scale, causal):
    global flash_fwd_launches, flash_fwd_causal_launches
    _check_kernel_operands(q, k, v)
    _check_aligned(q, k, v, name="flash_attention_fwd")
    BH, T, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    if BH == 0 or T == 0:
        return out, lse
    lib = _kernels.library("flash_attention_fwd")
    with torch.cuda.device(q.device):
        rc = lib.mxt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), BH, T, d, float(scale), int(bool(causal)),
            _KERNEL_DTYPES[q.dtype], _stream(q.device))
    _launched(rc, "flash_attention_fwd")
    flash_fwd_launches += 1
    flash_fwd_causal_launches += bool(causal)
    return out, lse


def _flash_bwd_dq_cuda(q, k, v, out, lse, dout, scale, causal):
    global flash_bwd_dq_launches, flash_bwd_dq_causal_launches
    name = "flash_attention_bwd_dq"
    _check_kernel_operands(q, k, v, out, dout, name=name)
    _check_aligned(q, k, v, out, dout, name=name)
    _check_row_stats(q, lse, name=name)
    BH, T, d = q.shape
    dq = torch.empty_like(q)
    delta = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    if BH == 0 or T == 0:
        return dq, delta
    lib = _kernels.library("flash_attention_bwd")
    with torch.cuda.device(q.device):
        rc = lib.mxt_flash_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
            BH, T, d, float(scale), int(bool(causal)),
            _KERNEL_DTYPES[q.dtype], _stream(q.device))
    _launched(rc, name)
    flash_bwd_dq_launches += 1
    flash_bwd_dq_causal_launches += bool(causal)
    return dq, delta


def _flash_bwd_dkv_cuda(q, k, v, dout, lse, delta, scale, causal):
    global flash_bwd_dkv_launches, flash_bwd_dkv_causal_launches
    name = "flash_attention_bwd_dkv"
    _check_kernel_operands(q, k, v, dout, name=name)
    _check_aligned(q, k, v, dout, name=name)
    _check_row_stats(q, lse, delta, name=name)
    BH, T, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if BH == 0 or T == 0:
        return dk, dv
    lib = _kernels.library("flash_attention_bwd")
    with torch.cuda.device(q.device):
        rc = lib.mxt_flash_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            BH, T, d, float(scale), int(bool(causal)),
            _KERNEL_DTYPES[q.dtype], _stream(q.device))
    _launched(rc, name)
    flash_bwd_dkv_launches += 1
    flash_bwd_dkv_causal_launches += bool(causal)
    return dk, dv


def _route(name, q, kernel, plain):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if q.device.type == "cuda":
        return kernel
    if q.device.type == "cpu":
        return plain
    raise ValueError("%s runs on CUDA or CPU tensors, got a tensor on %s"
                     % (name, q.device))


def flash_attention_fwd(q, k, v, scale, causal=False):
    """(BH, T, d) q, k, v → out (BH, T, d), lse (BH, T) f32."""
    return _route("flash_attention_fwd", q, _flash_fwd_cuda,
                  flash_attention_fwd_plain)(q, k, v, scale, causal)


def flash_attention_bwd_dq(q, k, v, out, lse, dout, scale, causal=False):
    """→ dq (BH, T, d), delta = rowsum(dO * O) (BH, T) f32."""
    return _route("flash_attention_bwd_dq", q, _flash_bwd_dq_cuda,
                  flash_attention_bwd_dq_plain)(q, k, v, out, lse, dout,
                                                scale, causal)


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale, causal=False):
    """→ dk, dv (BH, T, d), from the dQ step's delta."""
    return _route("flash_attention_bwd_dkv", q, _flash_bwd_dkv_cuda,
                  flash_attention_bwd_dkv_plain)(q, k, v, dout, lse, delta,
                                                 scale, causal)


def flash_attention_bwd(q, k, v, out, lse, dout, scale, causal=False):
    """Gradients (dq, dk, dv) of `flash_attention_fwd` from its residuals
    (q, k, v, out, lse) and the output gradient `dout`, all (BH, T, d)
    but lse (BH, T) f32: the dQ kernel, then the dK/dV kernel."""
    dq, delta = flash_attention_bwd_dq(q, k, v, out, lse, dout, scale, causal)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """out = flash_attention_fwd(q, k, v)[0] with the flash backward as its
    gradient.  With no input requiring grad (or under inference mode) it
    saves nothing and only the forward runs."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = flash_attention_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        # autograd may hand over a strided gradient (the head merge in
        # _contrib_flash_attention transposes); the kernels take (BH, T, d)
        # contiguous
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, scale=None, causal=False, bias=None):
    """Fused attention over (B, H, T, d) operands (any leading batch dims).
    Returns (B, H, T, d), differentiable through the flash backward.  An
    additive `bias` is not part of the kernels' function, and a head dim
    outside `KERNEL_HEAD_DIMS` has no kernel instance: both go through
    `naive_attention` (plain autograd) on either device, as the JAX
    package's dispatch sends what its kernel does not take.  The kernel
    wrappers themselves still raise on such a head dim."""
    *lead, T, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if bias is not None or d not in KERNEL_HEAD_DIMS:
        return naive_attention(q, k, v, scale, causal=causal, bias=bias)
    BH = math.prod(lead)
    out = _FlashAttention.apply(
        q.reshape(BH, T, d).contiguous(), k.reshape(BH, T, d).contiguous(),
        v.reshape(BH, T, d).contiguous(), float(scale), bool(causal))
    return out.reshape(*lead, T, d)


def _contrib_flash_attention(query, key, value, num_heads=1, scale=None,
                             causal=False):
    """Multi-head attention core softmax(QK^T/sqrt(d))V over (B, T, C)
    post-projection activations, C = num_heads * d.  Returns (B, T, C)."""
    B, T, C = query.shape
    H = int(num_heads)
    d = C // H

    def split(x):
        return x.reshape(B, T, H, d).transpose(1, 2)

    out = flash_attention(split(query), split(key), split(value),
                          scale=scale, causal=causal)
    return out.transpose(1, 2).reshape(B, T, C)
