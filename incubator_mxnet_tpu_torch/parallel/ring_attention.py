"""Sequence parallelism of the PyTorch port (counterpart of
incubator_mxnet_tpu/parallel/ring_attention.py): ring attention and
Ulysses all-to-all attention over a sequence-sharded mesh axis.

- `ring_attention` (Ring Attention with Blockwise Transformers): the
  K/V blocks rotate around the ring by `spmd.ppermute` while each
  replica's queries stay put; the partial results merge by the
  online-softmax recurrence, so no replica holds the T×T scores.
- `ulysses_attention` (DeepSpeed-Ulysses): `spmd.all_to_all` reshards
  sequence sharding into head sharding, attends over the full sequence
  for H/n heads, and reshards back.

Both are `shard_map` bodies (`parallel.spmd`): call them inside one with
`axis_name` bound to the mesh axis the sequence is split over.  The
products are plain torch in f32, as the JAX bodies are `jnp.einsum`
outside any Pallas kernel; the `-inf` guards of rows that a causal mask
empties are kept as written there.
"""
from __future__ import annotations

import torch

from . import spmd

__all__ = ["ring_attention", "ulysses_attention", "local_attention"]


def local_attention(q, k, v, *, causal=False, q_offset=0, k_offset=0,
                    scale=None):
    """Blockwise attention on local tensors.

    q: (B, Tq, H, D), k/v: (B, Tk, H, D); q_offset/k_offset are the
    global positions of element 0 (for causal masking across shards).
    Returns (unnormalized output, running max (B, Tq, H), denominator
    (B, Tq, H)) for the online-softmax merge."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bqhk", q, k) * scale
    if causal:
        qpos = q_offset + torch.arange(q.shape[1], device=q.device)
        kpos = k_offset + torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]              # (Tq, Tk)
        s = torch.where(mask[None, :, None, :], s,
                        torch.full((), -float("inf"), dtype=s.dtype,
                                   device=s.device))
    m = torch.amax(s, dim=-1)                              # (B, Tq, H)
    # fully-masked rows (causal, early shards): keep exp well-defined
    m_safe = torch.where(torch.isneginf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isneginf(s), torch.zeros_like(p), p)
    l = p.sum(dim=-1)                                      # (B, Tq, H)
    o = torch.einsum("bqhk,bkhd->bqhd", p, v)              # unnormalized
    return o, m_safe, l


def ring_attention(q, k, v, axis_name, *, causal=False, scale=None):
    """Ring attention over a sequence-sharded axis, inside `shard_map`.

    q/k/v: (B, T_local, H, D), the global sequence being the
    concatenation over `axis_name` in axis-index order.  Returns this
    shard's exact softmax attention output (B, T_local, H, D)."""
    n = spmd.psum(1, axis_name)
    idx = spmd.axis_index(axis_name)
    t_local = q.shape[1]
    q_off = idx * t_local

    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:3], -float("inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
    kc, vc = k, v
    q32 = q.float()

    perm = [(i, (i + 1) % n) for i in range(n)]
    for step in range(n):
        # after `step` rotations replica idx holds chunk (idx - step) % n
        src = (idx - step) % n
        k_off = src * t_local
        oi, mi, li = local_attention(
            q32, kc.float(), vc.float(), causal=causal,
            q_offset=q_off, k_offset=k_off, scale=scale)
        # first merge: m is -inf, so exp(-inf - mi) is taken care of
        mm = torch.maximum(m, mi)
        a_prev = torch.where(torch.isneginf(m), torch.zeros_like(m),
                             torch.exp(m - mm))
        a_new = torch.exp(mi - mm)
        o = o * a_prev[..., None] + oi * a_new[..., None]
        l = l * a_prev + li * a_new
        m = mm
        if step != n - 1:
            kc = spmd.ppermute(kc, axis_name, perm)
            vc = spmd.ppermute(vc, axis_name, perm)

    denom = torch.clamp(l, min=1e-20)[..., None]
    return (o / denom).to(q.dtype)


def ulysses_attention(q, k, v, axis_name, *, causal=False, scale=None):
    """DeepSpeed-Ulysses sequence parallelism, inside `shard_map`:
    q/k/v (B, T_local, H, D) with H divisible by the axis size go by
    all_to_all to (B, T_global, H/n, D), attend over the full sequence,
    and come back."""
    def seq_to_head(x):
        return spmd.all_to_all(x, axis_name, split_axis=2, concat_axis=1,
                               tiled=True)

    def head_to_seq(x):
        return spmd.all_to_all(x, axis_name, split_axis=1, concat_axis=2,
                               tiled=True)

    qg, kg, vg = seq_to_head(q), seq_to_head(k), seq_to_head(v)
    o, _m, l = local_attention(qg.float(), kg.float(), vg.float(),
                               causal=causal, scale=scale)
    out = o / torch.clamp(l, min=1e-20)[..., None]
    return head_to_seq(out.to(q.dtype))
