"""Transformer encoder and BERT of the PyTorch port (counterpart of
incubator_mxnet_tpu/models/transformer.py).

Unmasked attention without live attention dropout is one call of
`ops.attention._contrib_flash_attention`: the flash forward kernel, and
in training its two backward kernels, on the card; their plain versions
on the CPU.  Every layer takes `device` (default `cuda:0`) and `dtype`,
and builds its parameters there.  `FusedMLMCELoss` owns the MLM vocab
projection and fuses it into a chunked softmax cross-entropy.
"""
from __future__ import annotations

import math

import torch

from ..context import resolve_device
from ..gluon import nn
from ..gluon.block import HybridBlock, new_parameter
from ..ops import attention as _att
from ..ops import nn as ops

__all__ = ["MultiHeadAttention", "PositionwiseFFN",
           "TransformerEncoderLayer", "TransformerEncoder", "BERTModel",
           "FusedMLMCELoss", "bert_base", "bert_small"]


class MultiHeadAttention(HybridBlock):
    def __init__(self, units, num_heads, dropout=0.0, seq_parallel=None,
                 device=None, dtype="float32"):
        super().__init__()
        if units % num_heads:
            raise ValueError("units %d is not a multiple of num_heads %d"
                             % (units, num_heads))
        if seq_parallel is not None:
            raise NotImplementedError(
                "MultiHeadAttention(seq_parallel=...) ring attention is not "
                "yet ported")
        self._units = units
        self._num_heads = num_heads
        dev = resolve_device(device)
        kw = dict(flatten=False, in_units=units, device=dev, dtype=dtype)
        self.query = nn.Dense(units, **kw)
        self.key = nn.Dense(units, **kw)
        self.value = nn.Dense(units, **kw)
        self.proj = nn.Dense(units, **kw)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x, mask=None):
        H = self._num_heads
        # fused path: softmax(QK^T)V is one kernel and the score matrix
        # never reaches device memory.  Attention-prob dropout is live
        # only while training, so inference fuses whatever the dropout.
        if mask is None and (self.dropout is None or not self.training):
            ctx = _att._contrib_flash_attention(
                self.query(x), self.key(x), self.value(x), num_heads=H)
            return self.proj(ctx)
        q = _split_heads(self.query(x), H)
        k = _split_heads(self.key(x), H)
        v = _split_heads(self.value(x), H)
        scores = torch.bmm(q, k.transpose(1, 2)) * (
            1.0 / math.sqrt(self._units // H))
        if mask is not None:
            # additive mask broadcasts over (B, H, T, T)
            BH, T, S = scores.shape
            scores = (scores.reshape(BH // H, H, T, S) + mask).reshape(
                BH, T, S)
        attn = torch.softmax(scores, dim=-1)
        if self.dropout is not None:
            attn = self.dropout(attn)
        return self.proj(_merge_heads(torch.bmm(attn, v), H))


class PositionwiseFFN(HybridBlock):
    def __init__(self, units, hidden_size, dropout=0.0, device=None,
                 dtype="float32"):
        super().__init__()
        dev = resolve_device(device)
        self.ffn1 = nn.Dense(hidden_size, flatten=False, in_units=units,
                             device=dev, dtype=dtype)
        self.ffn2 = nn.Dense(units, flatten=False, in_units=hidden_size,
                             device=dev, dtype=dtype)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x):
        h = ops.leaky_relu(self.ffn1(x), act_type="gelu")
        if self.dropout is not None:
            h = self.dropout(h)
        return self.ffn2(h)


class TransformerEncoderLayer(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 seq_parallel=None, device=None, dtype="float32"):
        super().__init__()
        dev = resolve_device(device)
        self.attn = MultiHeadAttention(units, num_heads, dropout,
                                       seq_parallel=seq_parallel,
                                       device=dev, dtype=dtype)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout, device=dev,
                                   dtype=dtype)
        self.ln1 = nn.LayerNorm(in_channels=units, device=dev, dtype=dtype)
        self.ln2 = nn.LayerNorm(in_channels=units, device=dev, dtype=dtype)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x, mask=None):
        h = self.attn(x, mask)
        if self.dropout is not None:
            h = self.dropout(h)
        x = self.ln1(x + h)
        h = self.ffn(x)
        if self.dropout is not None:
            h = self.dropout(h)
        return self.ln2(x + h)


class TransformerEncoder(HybridBlock):
    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, seq_parallel=None, device=None,
                 dtype="float32"):
        super().__init__()
        dev = resolve_device(device)
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerEncoderLayer(
                units, hidden_size, num_heads, dropout,
                seq_parallel=seq_parallel, device=dev, dtype=dtype))

    def forward(self, x, mask=None):
        for layer in self.layers:
            x = layer(x, mask)
        return x


class BERTModel(HybridBlock):
    """Token + position embeddings → encoder → MLM head.  Input (B, T)
    token ids, output (B, T, vocab_size) logits, or the (B, T, units) MLM
    transform with `output_hidden`."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512, dropout=0.1,
                 seq_parallel=None, output_hidden=False, device=None,
                 dtype="float32"):
        super().__init__()
        dev = resolve_device(device)
        self._units = units
        self._max_length = max_length
        kw = dict(device=dev, dtype=dtype)
        self.word_embed = nn.Embedding(vocab_size, units, **kw)
        self.pos_embed = nn.Embedding(max_length, units, **kw)
        self.ln = nn.LayerNorm(in_channels=units, **kw)
        self.dropout = nn.Dropout(dropout) if dropout else None
        self.encoder = TransformerEncoder(num_layers, units, hidden_size,
                                          num_heads, dropout,
                                          seq_parallel=seq_parallel, **kw)
        self.mlm_dense = nn.Dense(units, flatten=False, in_units=units, **kw)
        self.mlm_ln = nn.LayerNorm(in_channels=units, **kw)
        self.decoder = None if output_hidden else nn.Dense(
            vocab_size, flatten=False, in_units=units, **kw)

    def forward(self, tokens):
        _check_max_length(tokens, self._max_length, "BERT")
        x = self.word_embed(tokens) + self.pos_embed(_position_ids(tokens))
        x = self.ln(x)
        if self.dropout is not None:
            x = self.dropout(x)
        x = self.encoder(x)
        h = ops.leaky_relu(self.mlm_dense(x), act_type="gelu")
        h = self.mlm_ln(h)
        return h if self.decoder is None else self.decoder(h)


class FusedMLMCELoss(HybridBlock):
    """Vocab projection fused into the softmax cross-entropy, chunked over
    rows so the (B·T, vocab) logits of more than one chunk never exist
    (`ops.nn.fused_linear_softmax_ce`).  Owns the projection's `weight`
    (vocab, in_units) and `bias` (vocab,): pair it with
    `BERTModel(output_hidden=True)`.

    forward(h, label): h (B, T, D) or (N, D); label (B, T) or (N,).
    Returns the per-row loss (N,).
    """

    def __init__(self, vocab_size, in_units, num_chunks=0, dtype="float32",
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self._nchunk = num_chunks
        self.weight = new_parameter("weight", (vocab_size, in_units), None,
                                    dev, dtype)
        self.bias = new_parameter("bias", (vocab_size,), "zeros", dev, dtype)

    def forward(self, h, label):
        h2 = h if h.ndim == 2 else h.reshape(-1, h.shape[-1])
        return ops.fused_linear_softmax_ce(h2, self.weight, self.bias,
                                           label.reshape(-1),
                                           num_chunks=self._nchunk)


def bert_base(vocab_size=30522, **kwargs):
    return BERTModel(vocab_size=vocab_size, units=768, hidden_size=3072,
                     num_layers=12, num_heads=12, **kwargs)


def bert_small(vocab_size=1000, **kwargs):
    kwargs.setdefault("units", 64)
    kwargs.setdefault("hidden_size", 128)
    kwargs.setdefault("num_layers", 2)
    kwargs.setdefault("num_heads", 4)
    kwargs.setdefault("max_length", 128)
    return BERTModel(vocab_size=vocab_size, **kwargs)


def _position_ids(tokens):
    """(B, T) tokens → (T,) position indices."""
    return torch.arange(tokens.shape[1], device=tokens.device)


def _check_max_length(tokens, max_length, where):
    """Fail fast when a sequence exceeds the positional table, whose
    lookup would otherwise clamp and reuse the last position vector."""
    if tokens.shape[1] > max_length:
        raise ValueError(
            "%s sequence length %d exceeds max_length=%d (positional "
            "embedding table)" % (where, tokens.shape[1], max_length))


def _split_heads(t, num_heads):
    """(B, T, C) → (B·H, T, d)."""
    B, T, C = t.shape
    return t.reshape(B, T, num_heads, C // num_heads).transpose(1, 2) \
        .reshape(B * num_heads, T, C // num_heads)


def _merge_heads(t, num_heads):
    """(B·H, T, d) → (B, T, C)."""
    BH, T, d = t.shape
    return t.reshape(BH // num_heads, num_heads, T, d).transpose(1, 2) \
        .reshape(BH // num_heads, T, num_heads * d)
