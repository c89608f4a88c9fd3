"""Neural-network ops of the PyTorch port, with the semantics of
incubator_mxnet_tpu/ops/nn.py.  These are XLA ops in the JAX package,
not Pallas kernels, so plain PyTorch is their port.

The two fused softmax cross-entropies are `torch.autograd.Function`s that
keep the JAX package's memory-exact residuals: the logits (or, for the
linear one, nothing row-sized but a per-row lse) and the labels; their
backwards rebuild the softmax from the lse.
"""
from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

__all__ = ["fully_connected", "layer_norm", "embedding", "leaky_relu",
           "dropout", "fused_softmax_ce", "fused_linear_softmax_ce"]


def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    """`data @ weight.T + bias` with weight (num_hidden, in_units); with
    `flatten`, every axis after the first is folded into in_units."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Normalize over the last axis with the biased variance, then scale
    and shift."""
    if axis % data.ndim != data.ndim - 1:
        raise NotImplementedError("layer_norm over axis %d is not yet "
                                  "ported (last axis only)" % axis)
    return F.layer_norm(data, (data.shape[-1],), gamma, beta, eps)


def embedding(data, weight):
    """Rows of `weight` at the indices `data`.  Out-of-range indices are
    clamped into the table (the JAX package's gather clamps too), so a bad
    token id cannot fault the device."""
    idx = data.long().clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


def leaky_relu(data, act_type):
    """Only `gelu`, the exact erf form, is ported."""
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    raise NotImplementedError("leaky_relu act_type=%r is not yet ported"
                              % (act_type,))


def dropout(data, p=0.5, training=False, generator=None):
    """Inverted dropout drawn from `generator`; the identity unless
    `training` and p > 0."""
    if not training or p <= 0.0:
        return data
    keep = 1.0 - p
    mask = torch.rand(data.shape, generator=generator, device=data.device,
                      dtype=torch.float32) < keep
    return data * mask.to(data.dtype) / keep


class _SoftmaxCE(torch.autograd.Function):
    """-log softmax(pred)[label] along the last axis; residuals are the
    logits, the labels and a per-row f32 lse."""

    @staticmethod
    def forward(ctx, pred, label):
        p32 = pred.float()
        lse = torch.logsumexp(p32, dim=-1, keepdim=True)
        idx = label.long().unsqueeze(-1)
        loss = (lse - p32.gather(-1, idx)).squeeze(-1)
        ctx.save_for_backward(pred, idx, lse)
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        pred, idx, lse = ctx.saved_tensors
        # softmax in f32 from the saved lse, minus the one-hot label
        dpred = torch.exp(pred.float() - lse)
        dpred.scatter_add_(-1, idx, torch.full_like(idx, -1.0,
                                                    dtype=dpred.dtype))
        dpred.mul_(dy.float().unsqueeze(-1))
        return dpred.to(pred.dtype), None


def fused_softmax_ce(pred, label, axis=-1):
    """-log softmax(pred)[label] per row, along `axis`; the loss has
    pred's shape without that axis, in f32.  The backward recomputes the
    softmax from the logits and a per-row lse (ref: the JAX package's
    memory-exact custom vjp)."""
    ax = axis % pred.ndim
    last = pred.ndim - 1
    if ax != last:
        pred = pred.movedim(ax, last)
    return _SoftmaxCE.apply(pred, label)


def _chunk_logits(hc, weight, bias):
    """f32 logits of one row chunk: products of the operands' values summed
    in f32, as the JAX package's preferred_element_type=f32 dot."""
    return torch.addmm(bias.float(), hc.float(), weight.float().t())


class _LinearSoftmaxCE(torch.autograd.Function):
    """Per-row -log softmax(hidden @ weight.T + bias)[label] over `nchunk`
    row chunks; the forward keeps only a per-row f32 lse, the backward
    recomputes each chunk's logits and accumulates dW and db in f32."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, label, nchunk):
        lab = label.long()
        losses, lses = [], []
        for hc, lc in zip(hidden.chunk(nchunk), lab.chunk(nchunk)):
            logits = _chunk_logits(hc, weight, bias)
            lse = torch.logsumexp(logits, dim=-1)
            losses.append(lse - logits.gather(-1, lc[:, None]).squeeze(-1))
            lses.append(lse)
        ctx.nchunk = nchunk
        ctx.save_for_backward(hidden, weight, bias, lab, torch.cat(lses))
        return torch.cat(losses)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        hidden, weight, bias, lab, lse = ctx.saved_tensors
        nchunk = ctx.nchunk
        w32 = weight.float()
        dw = torch.zeros(weight.shape, dtype=torch.float32,
                         device=weight.device)
        db = torch.zeros(bias.shape, dtype=torch.float32, device=bias.device)
        dh = []
        for hc, lc, lsec, dyc in zip(hidden.chunk(nchunk), lab.chunk(nchunk),
                                     lse.chunk(nchunk),
                                     dy.float().chunk(nchunk)):
            # in place on the chunk's logits: softmax, minus one-hot, times dy
            dlogits = _chunk_logits(hc, weight, bias)
            dlogits.sub_(lsec[:, None]).exp_()
            dlogits.scatter_add_(-1, lc[:, None], torch.full(
                (lc.shape[0], 1), -1.0, device=dlogits.device))
            dlogits.mul_(dyc[:, None])
            db += dlogits.sum(0)
            dl = dlogits.to(hidden.dtype).float()
            dh.append(torch.matmul(dl, w32).to(hidden.dtype))
            dw.addmm_(dl.t(), hc.float())
        return (torch.cat(dh), dw.to(weight.dtype), db.to(bias.dtype), None,
                None)


def fused_linear_softmax_ce(hidden, weight, bias, label, num_chunks=0):
    """Per-row -log softmax(hidden @ weight.T + bias)[label] without
    materialising the (rows, vocab) logits of more than one row chunk.
    hidden (N, D); weight (V, D); bias (V,); label (N,) integer-valued.
    num_chunks=0 picks the largest chunk size in [256, 2048] that divides
    N (one unchunked pass, with a warning when N > 4096, if there is
    none); N must divide into the chunk count."""
    n = hidden.shape[0]
    nchunk = int(num_chunks)
    if nchunk <= 0:
        nchunk = 1
        for chunk in range(min(n, 2048), 255, -1):
            if n % chunk == 0:
                nchunk = n // chunk
                break
        if nchunk == 1 and n > 4096:
            warnings.warn(
                "_fused_linear_softmax_ce: %d rows have no divisor in "
                "[256, 2048]; computing UNCHUNKED (full logits "
                "materialise) — pass num_chunks explicitly" % n)
    if n % nchunk != 0:
        raise ValueError(
            "_fused_linear_softmax_ce: %d rows not divisible into %d "
            "chunks" % (n, nchunk))
    return _LinearSoftmaxCE.apply(hidden, weight, bias, label, nchunk)
