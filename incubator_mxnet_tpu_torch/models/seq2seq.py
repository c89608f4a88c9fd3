"""LSTM sequence-to-sequence NMT of the PyTorch port (counterpart of
incubator_mxnet_tpu/models/seq2seq.py): `Seq2Seq`, the small
encoder-decoder with dot attention that generation serves, and `GNMT`,
the GNMT architecture at reference geometry (`gnmt_large`, bench.py's
config 4).

Every LSTM is a `gluon.rnn.LSTM` over the fused `RNN` op (`ops.rnn`):
one input GEMM per layer and direction, then a step loop of one `addmm`
and the cell's elementwise work, in the parameters' dtype.  Attention is
two `torch.bmm`s and a softmax, as the JAX package's two `batch_dot`s.
Every block takes `device` (default `cuda:0`) and `dtype` and builds its
parameters there, with each LSTM's input width given, so nothing waits
for a first forward.

`gnmt_sym_gen`, the JAX module's Symbol generator for BucketingModule,
waits for the port of `symbol/` (ROADMAP Queue 1, item 9).
"""
from __future__ import annotations

import torch

from ..context import resolve_device
from ..gluon import nn, rnn
from ..gluon.block import HybridBlock
from ..ops import rnn as _rnn

__all__ = ["Seq2Seq", "GNMT", "gnmt_large"]


def _begin(layer, x):
    """`layer`'s zero states for the (T, B, C) input x, on x's device in
    x's dtype."""
    return layer.begin_state(batch_size=x.shape[1], ctx=x.device,
                             dtype=x.dtype)


def _attend(q, k, scale=None, invalid=None):
    """Dot attention of q (B, Tq, H) over k (B, Tk, H), which is also the
    value; `invalid` (B, 1, Tk) marks key positions that take -1e9."""
    scores = torch.bmm(q, k.transpose(1, 2))
    if scale is not None:
        scores = scores * scale
    if invalid is not None:
        scores = scores + invalid.to(scores.dtype) * -1e9
    return torch.bmm(torch.softmax(scores, dim=-1), k)


class Seq2Seq(HybridBlock):
    """Encoder-decoder with dot attention, teacher-forced: src (B, Ts) and
    tgt (B, Tt) token ids → logits (B, Tt, tgt_vocab).  The decoder starts
    from the encoder's final (h, c).

    `init_cache` and `decode_step` are the generation engine's contract.
    Every cache leaf is slot-major: enc_k (B, M, H), src_len (B,), and h
    and c (B, L, H).  The prefill encodes through `RNN_varlen`, so that a
    row's recurrence stops at its valid length (the decoder starts from
    the state at the prompt's real end), and the decode step masks the
    padded memory rows with -1e9: a padded prompt decodes as the unpadded
    one does."""

    def __init__(self, src_vocab, tgt_vocab, embed_dim=32, hidden=64,
                 num_layers=2, device=None, dtype="float32"):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self._hidden = hidden
        self.src_embed = nn.Embedding(src_vocab, embed_dim, **kw)
        self.tgt_embed = nn.Embedding(tgt_vocab, embed_dim, **kw)
        self.encoder = rnn.LSTM(hidden, num_layers=num_layers, layout="TNC",
                                input_size=embed_dim, **kw)
        self.decoder = rnn.LSTM(hidden, num_layers=num_layers, layout="TNC",
                                input_size=embed_dim, **kw)
        self.att_dense = nn.Dense(hidden, flatten=False, use_bias=False,
                                  in_units=hidden, **kw)
        self.proj = nn.Dense(tgt_vocab, flatten=False, in_units=hidden, **kw)

    def _readout(self, q, k, invalid=None):
        return self.proj(self.att_dense(_attend(q, k, invalid=invalid)) + q)

    def forward(self, src, tgt):
        enc_in = self.src_embed(src).transpose(0, 1)          # (Ts, B, E)
        enc_out, enc_states = self.encoder(enc_in, _begin(self.encoder,
                                                          enc_in))
        dec_out, _ = self.decoder(self.tgt_embed(tgt).transpose(0, 1),
                                  enc_states)                 # (Tt, B, H)
        return self._readout(dec_out.transpose(0, 1),
                             enc_out.transpose(0, 1))

    def init_cache(self, src, src_valid_len, max_len=None, mem_len=None):
        """Prefill: encode `src` (B, Ts) with valid lengths `src_valid_len`
        (B,) and return the decode cache.  `mem_len` > Ts pads the memory
        with zero rows, so that every prompt bucket gives one cache shape
        (`max_len` is unused: the LSTM state does not grow)."""
        B, Ts = src.shape
        enc_in = self.src_embed(src).transpose(0, 1)          # (Ts, B, E)
        s0 = _begin(self.encoder, enc_in)
        enc_out, h, c = _rnn.rnn_varlen(
            enc_in, self.encoder.flat_param, s0[0], s0[1], src_valid_len,
            state_size=self._hidden, num_layers=self.encoder._num_layers,
            mode="lstm")
        k = enc_out.transpose(0, 1)                           # (B, Ts, H)
        if mem_len is not None and int(mem_len) > Ts:
            k = torch.cat([k, k.new_zeros(B, int(mem_len) - Ts,
                                          self._hidden)], dim=1)
        return {"enc_k": k, "src_len": src_valid_len.reshape(-1),
                "h": h.transpose(0, 1), "c": c.transpose(0, 1)}

    def decode_step(self, tok, pos, cache):
        """One decode step: token `tok` (B,) at position `pos` (B,; unused,
        the LSTM state carries it) → (next-token logits (B, V), the
        updated cache)."""
        x = self.tgt_embed(tok.reshape(-1, 1)).transpose(0, 1)  # (1, B, E)
        dec_out, (h, c) = self.decoder(
            x, [cache["h"].transpose(0, 1), cache["c"].transpose(0, 1)])
        k = cache["enc_k"]                                    # (B, M, H)
        M = k.shape[1]
        invalid = torch.arange(M, device=k.device).reshape(1, 1, M) \
            >= cache["src_len"].reshape(-1, 1, 1)
        logits = self._readout(dec_out.transpose(0, 1), k, invalid)
        new_cache = dict(cache, h=h.transpose(0, 1), c=c.transpose(0, 1))
        return logits.reshape(logits.shape[0], -1), new_cache


class GNMT(HybridBlock):
    """The GNMT architecture (ref: Sockeye's GNMT config over the fused
    RNN op): a bidirectional bottom encoder layer, unidirectional layers
    above it with residual adds from the second one, a deep decoder whose
    every layer starts from the top encoder layer's final (h, c), and
    scaled dot attention over the encoder outputs.

    forward(src, tgt, src_valid_len=None): src (B, Ts), tgt (B, Tt) ids →
    logits (B, Tt, tgt_vocab), or with `output_hidden=True` the
    (B, Tt, hidden) mix before the vocab projection, for
    `FusedMLMCELoss(tgt_vocab, hidden)`.  `src_valid_len` (B,) keeps the
    source's padded positions out of the attention (-1e9)."""

    def __init__(self, src_vocab, tgt_vocab, embed_dim=1024, hidden=1024,
                 enc_layers=4, dec_layers=4, output_hidden=False,
                 device=None, dtype="float32"):
        super().__init__()
        if enc_layers < 2:
            raise ValueError("GNMT needs a bidirectional bottom layer and "
                             "at least one unidirectional layer")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self._hidden = hidden
        self._dec_layers = dec_layers
        self._output_hidden = output_hidden
        self.src_embed = nn.Embedding(src_vocab, embed_dim, **kw)
        self.tgt_embed = nn.Embedding(tgt_vocab, embed_dim, **kw)
        self.enc_bi = rnn.LSTM(hidden, num_layers=1, bidirectional=True,
                               layout="TNC", input_size=embed_dim, **kw)
        self._uni = []
        for i in range(enc_layers - 1):
            layer = rnn.LSTM(hidden, num_layers=1, layout="TNC",
                             input_size=2 * hidden if i == 0 else hidden,
                             **kw)
            setattr(self, "enc_uni%d" % i, layer)
            self._uni.append(layer)
        self.decoder = rnn.LSTM(hidden, num_layers=dec_layers, layout="TNC",
                                input_size=embed_dim, **kw)
        self.att_dense = nn.Dense(hidden, flatten=False, use_bias=False,
                                  in_units=hidden, **kw)
        self.proj = None if output_hidden else nn.Dense(
            tgt_vocab, flatten=False, in_units=hidden, **kw)

    def forward(self, src, tgt, src_valid_len=None):
        x = self.src_embed(src).transpose(0, 1)               # (Ts, B, E)
        h, _ = self.enc_bi(x, _begin(self.enc_bi, x))         # (Ts, B, 2H)
        states = None
        for i, layer in enumerate(self._uni):
            out, states = layer(h, _begin(layer, h))
            # the first one narrows 2H to H: no residual there
            h = out if i == 0 else out + h
        dh = torch.cat([states[0]] * self._dec_layers, dim=0)
        dc = torch.cat([states[1]] * self._dec_layers, dim=0)
        dec_out, _ = self.decoder(self.tgt_embed(tgt).transpose(0, 1),
                                  [dh, dc])                   # (Tt, B, H)
        q = dec_out.transpose(0, 1)                           # (B, Tt, H)
        k = h.transpose(0, 1)                                 # (B, Ts, H)
        invalid = None
        if src_valid_len is not None:
            Ts = k.shape[1]
            invalid = torch.arange(Ts, device=k.device).reshape(1, 1, Ts) \
                >= src_valid_len.reshape(-1, 1, 1)
        mix = self.att_dense(_attend(q, k, 1.0 / float(self._hidden) ** 0.5,
                                     invalid)) + q
        return mix if self.proj is None else self.proj(mix)


def gnmt_large(src_vocab=32000, tgt_vocab=32000, **kwargs):
    """bench.py's config 4: 4x1024 encoder (bidirectional bottom layer),
    4x1024 decoder, 1024 embeddings, 32k vocab (146 M parameters; 179 M
    with `FusedMLMCELoss(32000, 1024)`)."""
    kwargs.setdefault("embed_dim", 1024)
    kwargs.setdefault("hidden", 1024)
    kwargs.setdefault("enc_layers", 4)
    kwargs.setdefault("dec_layers", 4)
    return GNMT(src_vocab, tgt_vocab, **kwargs)
