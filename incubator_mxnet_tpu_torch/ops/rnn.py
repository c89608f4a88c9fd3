"""The fused `RNN` operator of the PyTorch port (counterpart of
incubator_mxnet_tpu/ops/rnn.py; ref: src/operator/rnn.cc, rnn-inl.h).

One op runs a whole multi-layer, optionally bidirectional LSTM, GRU or
vanilla RNN over the padded sequence, from the cuDNN-style flat
parameter vector.  Packing order: for each layer and direction, W_x then
W_h, each holding every gate (LSTM [i, f, g, o], GRU [r, z, n]); after
all the weights, the biases in the same order (b_x then b_h).

Each layer and direction is one input GEMM over all T steps, then a
Python loop over the steps: `addmm` of the carried h against W_h and the
cell's elementwise work, in the inputs' dtype.  The JAX package leaves
the same recurrence to XLA (`lax.scan`); there is no TPU kernel behind
it, and none here.  GRU's candidate is n = tanh(x_n + r·(W_hn h + b_hn)),
the cuDNN form (torch's `nn.GRU` has the same; its other gates differ in
nothing).

`RNN_varlen` (and `RNN(use_sequence_length=True)`) freezes each row past
its length: the row keeps its carry and emits 0, and the reverse
direction starts at the row's last real token.  Right-padding a prompt
therefore changes none of its outputs or final states (the generation
prefill's exactness contract).
"""
from __future__ import annotations

import torch

from . import nn as _nn
from .registry import register

__all__ = ["rnn_param_size", "rnn", "rnn_varlen"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(mode, num_layers, input_size, state_size,
                   bidirectional=False, projection_size=None):
    """Length of the flat parameter vector (ref: rnn-inl.h
    GetRnnParamSize)."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        size += d * g * (state_size * in_sz + state_size * state_size
                         + 2 * state_size)
    return size


def _unpack(params, mode, num_layers, input_size, state_size, bidirectional):
    """The flat vector as [layer][direction] (W_x, W_h) and (b_x, b_h)
    views, cut by one `split` (whose backward is one concatenation, where
    a slice per piece would add a zero-filled copy of the whole vector
    for each)."""
    G = _GATES[mode] * state_size
    d = 2 if bidirectional else 1
    shapes = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * d
        shapes += [(G, in_sz), (G, state_size)] * d
    shapes += [(G,)] * (2 * d * num_layers)
    sizes = [G * (s[1] if len(s) == 2 else 1) for s in shapes]
    pieces = [p.reshape(s) for p, s in zip(
        torch.split(params, sizes), shapes)]
    nw = 2 * d * num_layers
    ws = [[(pieces[2 * (layer * d + k)], pieces[2 * (layer * d + k) + 1])
           for k in range(d)] for layer in range(num_layers)]
    bs = [[(pieces[nw + 2 * (layer * d + k)],
            pieces[nw + 2 * (layer * d + k) + 1])
           for k in range(d)] for layer in range(num_layers)]
    return ws, bs


def _lstm_cell(gates, c):
    """LSTM gates [i, f, g, o] (B, 4H) and the cell c → (h, c)."""
    H = c.shape[-1]
    sig = torch.sigmoid(gates)
    i, f, o = sig[:, :H], sig[:, H:2 * H], sig[:, 3 * H:]
    g = torch.tanh(gates[:, 2 * H:3 * H])
    c = f * c + i * g
    return o * torch.tanh(c), c


def _gru_cell(xg_t, hg, h):
    """GRU: x-side gates xg_t and h-side gates hg = W_h h + b_h, both
    (B, 3H) as [r, z, n], and h → the new h."""
    H = h.shape[-1]
    rz = torch.sigmoid(xg_t[:, :2 * H] + hg[:, :2 * H])
    r, z = rz[:, :H], rz[:, H:]
    n = torch.tanh(xg_t[:, 2 * H:] + r * hg[:, 2 * H:])
    return (1 - z) * n + z * h


def _run_layer(x, h0, c0, wx, wh, bx, bh, mode, reverse=False,
               seq_len=None):
    """One layer and direction over x (T, B, I): (outputs (T, B, H), hT,
    cT or None).  With `seq_len` (B,) a row's carry freezes past its
    length and its outputs there are 0; the reverse direction, which
    walks the flipped sequence, keeps the steps t >= T - len of it."""
    T = x.shape[0]
    # the input projection of every step at once; for LSTM and the plain
    # RNN b_h joins it, so that each step is one addmm
    bias = bx if mode == "gru" else bx + bh
    xg = torch.matmul(x, wx.t()) + bias                 # (T, B, G*H)
    if reverse:
        xg = xg.flip(0)
    keep = None
    if seq_len is not None:
        t_idx = torch.arange(T, device=x.device).reshape(T, 1)
        sl = seq_len.reshape(1, -1).to(torch.int64)
        keep = ((t_idx >= T - sl) if reverse else (t_idx < sl))[:, :, None]
    wht = wh.t()
    h, c = h0, c0
    ys = []
    # unbind, not xg[t]: a step's select would take back a zero-filled
    # (T, B, G*H) gradient of its own in the backward
    for t, xg_t in enumerate(xg.unbind(0)):
        if mode == "lstm":
            new_h, new_c = _lstm_cell(torch.addmm(xg_t, h, wht), c)
        elif mode == "gru":
            new_h, new_c = _gru_cell(xg_t, torch.addmm(bh, h, wht), h), None
        else:
            pre = torch.addmm(xg_t, h, wht)
            new_h = torch.tanh(pre) if mode == "rnn_tanh" else torch.relu(pre)
            new_c = None
        if keep is not None:
            k = keep[t]
            ys.append(torch.where(k, new_h, torch.zeros_like(new_h)))
            new_h = torch.where(k, new_h, h)
            if new_c is not None:
                new_c = torch.where(k, new_c, c)
        else:
            ys.append(new_h)
        h, c = new_h, new_c
    ys = torch.stack(ys)
    if reverse:
        ys = ys.flip(0)
    return ys, h, c


def _rnn_num_outputs(attrs):
    """y; with `state_outputs` (the default) also h, and c for lstm."""
    so = attrs.get("state_outputs", True)
    if isinstance(so, str):
        so = so.lower() not in ("false", "0")
    if not so:
        return 1
    return 3 if str(attrs.get("mode", "lstm")) == "lstm" else 2


@register("RNN", ndarray_inputs=("data", "parameters", "state", "state_cell"),
          num_outputs=-1, num_outputs_fn=_rnn_num_outputs, needs_rng=True,
          jit=True)
def rnn(data, parameters, state, state_cell=None, state_size=0,
        num_layers=1, bidirectional=False, mode="lstm", p=0.0,
        state_outputs=True, projection_size=None, use_sequence_length=False,
        sequence_length=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, _training=True, _rng_key=None):
    """data (T, B, I) in the TNC layout; state (L·D, B, H), and for lstm
    state_cell.  Returns y (T, B, D·H), and with `state_outputs` the
    final h (and c) (L·D, B, H).  Computes in data's dtype (parameters
    and states are cast to it).  Dropout of rate `p` between layers
    while `_training`, drawn from `_rng_key` (a torch.Generator).
    `use_sequence_length` with `sequence_length` (B,) freezes rows past
    their lengths (module doc).  `projection_size` and
    `lstm_state_clip_*` are accepted and ignored, as in the JAX op."""
    T, B, I = data.shape
    dt = data.dtype
    d = 2 if bidirectional else 1
    ws, bs = _unpack(parameters.to(dt), mode, num_layers, I, state_size,
                     bidirectional)
    h0s = state.to(dt).unbind(0)
    c0s = state_cell.to(dt).unbind(0) if state_cell is not None else None
    seq_len = None
    if use_sequence_length and sequence_length is not None:
        seq_len = sequence_length.reshape(-1)
    hs_out, cs_out = [], []
    x = data
    for layer in range(num_layers):
        outs = []
        for direction in range(d):
            idx = layer * d + direction
            wx, wh = ws[layer][direction]
            bx, bh = bs[layer][direction]
            c0 = c0s[idx] if c0s is not None else None
            ys, hT, cT = _run_layer(x, h0s[idx], c0, wx, wh, bx, bh, mode,
                                    reverse=direction == 1, seq_len=seq_len)
            outs.append(ys)
            hs_out.append(hT)
            if cT is not None:
                cs_out.append(cT)
        x = outs[0] if d == 1 else torch.cat(outs, dim=-1)
        if p > 0.0 and _training and layer < num_layers - 1:
            x = _nn.dropout(x, p, training=True, generator=_rng_key)
    if not state_outputs:
        return x
    outputs = [x, torch.stack(hs_out)]
    if mode == "lstm":
        outputs.append(torch.stack(cs_out))
    return tuple(outputs)


@register("RNN_varlen",
          ndarray_inputs=("data", "parameters", "state", "state_cell",
                          "sequence_length"),
          num_outputs=-1, num_outputs_fn=_rnn_num_outputs, needs_rng=True,
          jit=True)
def rnn_varlen(data, parameters, state, state_cell=None,
               sequence_length=None, state_size=0, num_layers=1,
               bidirectional=False, mode="lstm", p=0.0, state_outputs=True,
               _training=True, _rng_key=None):
    """`RNN` with `sequence_length` (B,) as a positional tensor input and
    the per-row freezing on (module doc); non-lstm modes pass
    `state_cell=None`."""
    return rnn(data, parameters, state, state_cell=state_cell,
               state_size=state_size, num_layers=num_layers,
               bidirectional=bidirectional, mode=mode, p=p,
               state_outputs=state_outputs, use_sequence_length=True,
               sequence_length=sequence_length, _training=_training,
               _rng_key=_rng_key)
