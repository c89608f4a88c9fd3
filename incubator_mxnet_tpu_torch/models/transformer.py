"""Transformer encoder, BERT and the encoder-decoder Transformer for NMT
of the PyTorch port (counterpart of incubator_mxnet_tpu/models/
transformer.py).

Unmasked attention without live attention dropout is one call of
`ops.attention._contrib_flash_attention`: the flash forward kernel, and
in training its two backward kernels, on the card; their plain versions
on the CPU.  The NMT decoder's self-attention always takes that call
with `causal=True`.  Masked attention, cross-attention and the cached
decode step attend with `torch.bmm`, as the JAX package does with
`batch_dot` outside its kernels.  Every layer takes `device` (default
`cuda:0`) and `dtype`, and builds its parameters there.
`FusedMLMCELoss` owns the vocab projection and fuses it into a chunked
softmax cross-entropy.
"""
from __future__ import annotations

import math
import warnings

import torch

from .. import autograd
from ..context import resolve_device
from ..gluon import nn
from ..gluon.block import HybridBlock, new_parameter
from ..ops import attention as _att
from ..ops import nn as ops

__all__ = ["MultiHeadAttention", "CrossAttention", "PositionwiseFFN",
           "TransformerEncoderLayer", "TransformerEncoder",
           "TransformerDecoderLayer", "TransformerDecoder",
           "TransformerNMT", "transformer_nmt_base",
           "transformer_nmt_small", "BERTModel", "FusedMLMCELoss",
           "bert_base", "bert_small"]


class MultiHeadAttention(HybridBlock):
    def __init__(self, units, num_heads, dropout=0.0, seq_parallel=None,
                 device=None, dtype="float32"):
        super().__init__()
        if units % num_heads:
            raise ValueError("units %d is not a multiple of num_heads %d"
                             % (units, num_heads))
        if seq_parallel is not None:
            raise NotImplementedError(
                "MultiHeadAttention(seq_parallel=...): ring and Ulysses "
                "attention are not yet ported; they come with slice 23 of "
                "the port (ROADMAP Queue 1 item 7)")
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
        # only while training (autograd.is_training()), so inference
        # fuses whatever the dropout.
        if mask is None and (self.dropout is None
                             or not autograd.is_training()):
            ctx = _att._contrib_flash_attention(
                self.query(x), self.key(x), self.value(x), num_heads=H)
            return self.proj(ctx)
        ctx = _scaled_dot_attention(
            _split_heads(self.query(x), H), _split_heads(self.key(x), H),
            _split_heads(self.value(x), H),
            1.0 / math.sqrt(self._units // H), H, mask, self.dropout)
        return self.proj(_merge_heads(ctx, H))


def _scaled_dot_attention(q, k, v, scale, num_heads, mask=None,
                          dropout=None):
    """softmax(q kᵀ · scale [+ mask]) v over (B·H, T, d) q and (B·H, S, d)
    k, v: the one unfused attention body of MultiHeadAttention's masked
    path, CrossAttention and the cached decode step.  `mask` is additive
    and broadcasts over the (B, H, T, S) scores, in their dtype (an f32
    mask does not promote bf16 scores); `dropout` acts on the
    probabilities."""
    scores = torch.bmm(q, k.transpose(1, 2)) * scale
    if mask is not None:
        BH, T, S = scores.shape
        scores = (scores.reshape(BH // num_heads, num_heads, T, S)
                  + mask.to(scores.dtype)).reshape(BH, T, S)
    attn = torch.softmax(scores, dim=-1)
    if dropout is not None:
        attn = dropout(attn)
    return torch.bmm(attn, v)


class CrossAttention(HybridBlock):
    """Encoder-decoder attention: queries from the decoder stream, keys
    and values from the encoder memory.  Unfused, as in the JAX package.
    forward(x, memory, mem_mask): `mem_mask` is an optional additive
    (B, 1, 1, T_mem) mask, 0 to keep and large-negative for source
    padding."""

    def __init__(self, units, num_heads, dropout=0.0, device=None,
                 dtype="float32"):
        super().__init__()
        if units % num_heads:
            raise ValueError("units %d is not a multiple of num_heads %d"
                             % (units, num_heads))
        self._num_heads = num_heads
        self._scale = 1.0 / math.sqrt(units // num_heads)
        kw = dict(flatten=False, in_units=units,
                  device=resolve_device(device), dtype=dtype)
        self.query = nn.Dense(units, **kw)
        self.key = nn.Dense(units, **kw)
        self.value = nn.Dense(units, **kw)
        self.proj = nn.Dense(units, **kw)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x, memory, mem_mask=None):
        H = self._num_heads
        ctx = _scaled_dot_attention(
            _split_heads(self.query(x), H), _split_heads(self.key(memory), H),
            _split_heads(self.value(memory), H), self._scale, H, mem_mask,
            self.dropout)
        return self.proj(_merge_heads(ctx, H))


class _CausalSelfAttention(MultiHeadAttention):
    """Decoder self-attention: the flash kernels run with causal=True, so
    no (T, T) mask is built.  Attention-prob dropout is not applied on
    this path, not even while training (residual and FFN dropout still
    are), as in the JAX package; construction with `dropout` warns."""

    def __init__(self, units, num_heads, dropout=0.0, device=None,
                 dtype="float32"):
        super().__init__(units, num_heads, dropout, device=device,
                         dtype=dtype)
        if dropout:
            warnings.warn(
                "_CausalSelfAttention: attention-prob dropout is not "
                "applied on the fused causal path (residual/FFN dropout "
                "still applies)")

    def forward(self, x, mask=None):
        if mask is not None:
            raise ValueError("_CausalSelfAttention builds its causal mask "
                             "inside the fused kernel; mask= is not "
                             "supported")
        ctx = _att._contrib_flash_attention(
            self.query(x), self.key(x), self.value(x),
            num_heads=self._num_heads, causal=True)
        return self.proj(ctx)


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


class TransformerDecoderLayer(HybridBlock):
    """Post-LN decoder layer: causal self-attention, cross-attention over
    the encoder memory, FFN, each added to its input and normalized."""

    def __init__(self, units, hidden_size, num_heads, dropout=0.0,
                 device=None, dtype="float32"):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.self_attn = _CausalSelfAttention(units, num_heads, dropout, **kw)
        self.cross_attn = CrossAttention(units, num_heads, dropout, **kw)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout, **kw)
        self.ln1 = nn.LayerNorm(in_channels=units, **kw)
        self.ln2 = nn.LayerNorm(in_channels=units, **kw)
        self.ln3 = nn.LayerNorm(in_channels=units, **kw)
        self.dropout = nn.Dropout(dropout) if dropout else None

    def forward(self, x, memory, mem_mask=None):
        h = self.self_attn(x)
        if self.dropout is not None:
            h = self.dropout(h)
        x = self.ln1(x + h)
        h = self.cross_attn(x, memory, mem_mask)
        if self.dropout is not None:
            h = self.dropout(h)
        x = self.ln2(x + h)
        h = self.ffn(x)
        if self.dropout is not None:
            h = self.dropout(h)
        return self.ln3(x + h)


class TransformerDecoder(HybridBlock):
    def __init__(self, num_layers, units, hidden_size, num_heads,
                 dropout=0.0, device=None, dtype="float32"):
        super().__init__()
        dev = resolve_device(device)
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerDecoderLayer(
                units, hidden_size, num_heads, dropout, device=dev,
                dtype=dtype))

    def forward(self, x, memory, mem_mask=None):
        for layer in self.layers:
            x = layer(x, memory, mem_mask)
        return x


class TransformerNMT(HybridBlock):
    """Encoder-decoder Transformer for NMT.

    forward(src, tgt, src_valid_length=None) → (B, T_tgt, tgt_vocab)
    logits, teacher-forced: `tgt` is the decoder input (the shifted
    target), and the decoder's self-attention is causal in the flash
    kernels.  `src_valid_length` (B,) builds one additive mask that keeps
    source padding out of the encoder's self-attention and the decoder's
    cross-attention.  With `output_hidden=True` there is no vocab
    projection and forward returns the (B, T_tgt, units) hidden states,
    for `FusedMLMCELoss(tgt_vocab, units)`.

    `init_cache` and `decode_step` decode one token per call against
    slot-major K/V caches (a later generation engine's contract).
    """

    def __init__(self, src_vocab, tgt_vocab, units=512, hidden_size=2048,
                 num_layers=6, num_heads=8, max_length=1024, dropout=0.1,
                 output_hidden=False, device=None, dtype="float32"):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self._units = units
        self._num_heads = num_heads
        self._max_length = max_length
        self.src_embed = nn.Embedding(src_vocab, units, **kw)
        self.tgt_embed = nn.Embedding(tgt_vocab, units, **kw)
        self.pos_embed = nn.Embedding(max_length, units, **kw)
        self.enc_ln = nn.LayerNorm(in_channels=units, **kw)
        self.dec_ln = nn.LayerNorm(in_channels=units, **kw)
        self.dropout = nn.Dropout(dropout) if dropout else None
        self.encoder = TransformerEncoder(num_layers, units, hidden_size,
                                          num_heads, dropout, **kw)
        self.decoder = TransformerDecoder(num_layers, units, hidden_size,
                                          num_heads, dropout, **kw)
        self.out_proj = None if output_hidden else nn.Dense(
            tgt_vocab, flatten=False, in_units=units, **kw)

    def _embed(self, embed, ln, tokens):
        _check_max_length(tokens, self._max_length, "NMT")
        x = embed(tokens) * math.sqrt(self._units) + \
            self.pos_embed(_position_ids(tokens))
        x = ln(x)
        if self.dropout is not None:
            x = self.dropout(x)
        return x

    def _encode(self, src, mem_mask):
        return self.encoder(self._embed(self.src_embed, self.enc_ln, src),
                            mask=mem_mask)

    def forward(self, src, tgt, src_valid_length=None):
        mem_mask = None if src_valid_length is None \
            else _mem_mask_for(src, src_valid_length)
        h = self.decoder(self._embed(self.tgt_embed, self.dec_ln, tgt),
                         self._encode(src, mem_mask), mem_mask)
        return h if self.out_proj is None else self.out_proj(h)

    def init_cache(self, src, src_valid_len, max_len, mem_len=None):
        """Prefill: encode `src` (B, Ts) under its padding mask, compute
        each decoder layer's cross-attention K and V once, and allocate
        zeroed self-attention K/V buffers (B, max_len, units) for
        `max_len` decode positions.  `mem_len` > Ts pads the memory axis
        with zero rows (masked by `src_len` in `decode_step`), so prompts
        of several lengths share one cache shape."""
        B, Ts = src.shape
        memory = self._encode(src, _mem_mask_for(src, src_valid_len))
        if mem_len is not None and int(mem_len) > Ts:
            memory = torch.cat([memory, memory.new_zeros(
                B, int(mem_len) - Ts, self._units)], dim=1)
        cache = {"src_len": src_valid_len.reshape(-1)}
        zeros = memory.new_zeros(B, int(max_len), self._units)
        for i, layer in enumerate(self.decoder.layers):
            cache["mem_k%d" % i] = layer.cross_attn.key(memory)
            cache["mem_v%d" % i] = layer.cross_attn.value(memory)
            cache["k%d" % i] = zeros
            cache["v%d" % i] = zeros
        return cache

    def decode_step(self, tok, pos, cache):
        """One decode step: token `tok` (B,) at target position `pos` (B,)
        against `cache`.  Returns the (B, tgt_vocab) logits and the updated
        cache.  Each row's new K and V are written at its own position by
        a one-hot masked update, k·(1 − oh) + new·oh; its query attends to
        positions <= pos and to the first `src_len` memory rows through
        -1e9 additive masks."""
        if self.out_proj is None:
            raise ValueError("decode_step needs the vocab projection "
                             "(build TransformerNMT without "
                             "output_hidden=True for generation)")
        H = self._num_heads
        L = cache["k0"].shape[1]
        M = cache["mem_k0"].shape[1]
        scale = 1.0 / math.sqrt(self._units // H)
        x = self.tgt_embed(tok.reshape(-1, 1)) * math.sqrt(self._units) + \
            self.pos_embed(pos.reshape(-1, 1))              # (B, 1, U)
        x = self.dec_ln(x)
        dt, dev = x.dtype, x.device
        steps = torch.arange(L, device=dev)
        self_mask = (steps.reshape(1, 1, 1, L)
                     > pos.reshape(-1, 1, 1, 1)).to(dt) * -1e9
        mem_mask = (torch.arange(M, device=dev).reshape(1, 1, 1, M)
                    >= cache["src_len"].reshape(-1, 1, 1, 1)).to(dt) * -1e9
        # one-hot rows of pos (all zero where pos is outside [0, L), as
        # the JAX one_hot), built without a host round trip
        oh = (steps == pos.reshape(-1, 1)).to(dt).unsqueeze(2)  # (B, L, 1)
        new_cache = dict(cache)

        def attend(q, k, v, mask):
            return _merge_heads(_scaled_dot_attention(
                _split_heads(q, H), _split_heads(k, H), _split_heads(v, H),
                scale, H, mask), H)

        for i, layer in enumerate(self.decoder.layers):
            sa, ca = layer.self_attn, layer.cross_attn
            kc = cache["k%d" % i] * (1.0 - oh) + sa.key(x) * oh
            vc = cache["v%d" % i] * (1.0 - oh) + sa.value(x) * oh
            new_cache["k%d" % i] = kc
            new_cache["v%d" % i] = vc
            x = layer.ln1(x + sa.proj(attend(sa.query(x), kc, vc,
                                             self_mask)))
            x = layer.ln2(x + ca.proj(attend(
                ca.query(x), cache["mem_k%d" % i], cache["mem_v%d" % i],
                mem_mask)))
            x = layer.ln3(x + layer.ffn(x))
        return self.out_proj(x).reshape(x.shape[0], -1), new_cache


def _mem_mask_for(src, src_valid_len):
    """The additive (B, 1, 1, Ts) source-padding mask: 0 where a position
    is below the row's valid length, -1e9 from there on."""
    keep = (_position_ids(src).reshape(1, -1)
            < src_valid_len.reshape(-1, 1)).to(torch.float32)   # (B, Ts)
    return ((keep - 1.0) * 1e9)[:, None, None, :]


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


def transformer_nmt_base(src_vocab, tgt_vocab, **kwargs):
    """The "base" geometry: 6 + 6 layers, 512 units, 8 heads, FFN 2048."""
    return TransformerNMT(src_vocab, tgt_vocab, units=512, hidden_size=2048,
                          num_layers=6, num_heads=8, **kwargs)


def transformer_nmt_small(src_vocab, tgt_vocab, **kwargs):
    kwargs.setdefault("units", 64)
    kwargs.setdefault("hidden_size", 128)
    kwargs.setdefault("num_layers", 2)
    kwargs.setdefault("num_heads", 4)
    kwargs.setdefault("max_length", 128)
    return TransformerNMT(src_vocab, tgt_vocab, **kwargs)


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
