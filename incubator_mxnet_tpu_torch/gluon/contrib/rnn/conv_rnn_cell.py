"""Convolutional recurrent cells of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py): ConvRNN,
ConvLSTM and ConvGRU over 1-, 2- and 3-D channel-first feature maps.

The state is a feature map; the i2h and h2h projections are
convolutions (`ops.nn.convolution`, rank-generic), stride 1, the h2h one
'same'-padded.  `input_shape` (C, *spatial) is required up front, as the
state's spatial shape must be known before the first step.
"""
from __future__ import annotations

import torch

from ...rnn.rnn_cell import RecurrentCell, cell_param
from ....ops import nn as ops

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell"]


def _tup(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _ConvCellBase(RecurrentCell):
    _GATES = 1

    def __init__(self, input_shape, hidden_channels, ndim, i2h_kernel=3,
                 h2h_kernel=3, i2h_pad=None, conv_layout="NCHW",
                 activation="tanh", i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None,
                 device=None, dtype="float32"):
        super().__init__(prefix=prefix, params=params)
        if conv_layout not in ("NCHW", "NCW", "NCDHW"):
            raise NotImplementedError(
                "conv cells support channel-first layouts only, got %r"
                % (conv_layout,))
        self._ndim = ndim
        self._input_shape = tuple(input_shape)     # (C_in, *spatial)
        self._hc = hidden_channels
        self._activation = activation
        self._i2h_kernel = _tup(i2h_kernel, ndim)
        self._h2h_kernel = _tup(h2h_kernel, ndim)
        for k in self._h2h_kernel:
            assert k % 2 == 1, "h2h_kernel must be odd (same-pad)"
        self._i2h_pad = (_tup(i2h_pad, ndim) if i2h_pad is not None
                         else tuple(k // 2 for k in self._i2h_kernel))
        self._h2h_pad = tuple(k // 2 for k in self._h2h_kernel)
        G = self._GATES * hidden_channels
        kw = dict(device=device, dtype=dtype)
        self.i2h_weight = cell_param(
            self, "i2h_weight", (G, self._input_shape[0]) + self._i2h_kernel,
            i2h_weight_initializer, **kw)
        self.h2h_weight = cell_param(
            self, "h2h_weight", (G, hidden_channels) + self._h2h_kernel,
            h2h_weight_initializer, **kw)
        self.i2h_bias = cell_param(self, "i2h_bias", (G,),
                                   i2h_bias_initializer, **kw)
        self.h2h_bias = cell_param(self, "h2h_bias", (G,),
                                   h2h_bias_initializer, **kw)

    def _state_shape(self, batch_size):
        # i2h 'same'-pads by default; with a custom pad the spatial sizes
        # follow the convolution's arithmetic (stride 1, no dilation)
        sp = tuple(s + 2 * p - k + 1
                   for s, p, k in zip(self._input_shape[1:],
                                      self._i2h_pad, self._i2h_kernel))
        return (batch_size, self._hc) + sp

    def state_info(self, batch_size=0):
        return [{"shape": self._state_shape(batch_size)}]

    def _conv(self, x, weight, bias, pad):
        return ops.convolution(x, weight, bias, kernel=weight.shape[2:],
                               num_filter=weight.shape[0], pad=pad,
                               stride=(1,) * self._ndim)

    def _gates(self, inputs, states):
        return (self._conv(inputs, self.i2h_weight, self.i2h_bias,
                           self._i2h_pad),
                self._conv(states[0], self.h2h_weight, self.h2h_bias,
                           self._h2h_pad))

    def _act(self, x):
        return ops.activation(x, act_type=self._activation)


class _ConvRNNCell(_ConvCellBase):
    def forward(self, inputs, states):
        i2h, h2h = self._gates(inputs, states)
        out = self._act(i2h + h2h)
        return out, [out]


class _ConvLSTMCell(_ConvCellBase):
    _GATES = 4

    def state_info(self, batch_size=0):
        return super().state_info(batch_size) * 2

    def forward(self, inputs, states):
        i2h, h2h = self._gates(inputs, states)
        in_g, forget_g, in_t, out_g = torch.chunk(i2h + h2h, 4, dim=1)
        next_c = torch.sigmoid(forget_g) * states[1] + \
            torch.sigmoid(in_g) * self._act(in_t)
        next_h = torch.sigmoid(out_g) * self._act(next_c)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_ConvCellBase):
    _GATES = 3

    def forward(self, inputs, states):
        i2h, h2h = self._gates(inputs, states)
        i2h_r, i2h_z, i2h_n = torch.chunk(i2h, 3, dim=1)
        h2h_r, h2h_z, h2h_n = torch.chunk(h2h, 3, dim=1)
        reset = torch.sigmoid(i2h_r + h2h_r)
        update = torch.sigmoid(i2h_z + h2h_z)
        cand = self._act(i2h_n + reset * h2h_n)
        next_h = (1.0 - update) * cand + update * states[0]
        return next_h, [next_h]


def _make(base, ndim, name):
    class _Cell(base):
        def __init__(self, input_shape, hidden_channels, **kwargs):
            super().__init__(input_shape, hidden_channels, ndim, **kwargs)
    _Cell.__name__ = _Cell.__qualname__ = name
    return _Cell


Conv1DRNNCell = _make(_ConvRNNCell, 1, "Conv1DRNNCell")
Conv2DRNNCell = _make(_ConvRNNCell, 2, "Conv2DRNNCell")
Conv3DRNNCell = _make(_ConvRNNCell, 3, "Conv3DRNNCell")
Conv1DLSTMCell = _make(_ConvLSTMCell, 1, "Conv1DLSTMCell")
Conv2DLSTMCell = _make(_ConvLSTMCell, 2, "Conv2DLSTMCell")
Conv3DLSTMCell = _make(_ConvLSTMCell, 3, "Conv3DLSTMCell")
Conv1DGRUCell = _make(_ConvGRUCell, 1, "Conv1DGRUCell")
Conv2DGRUCell = _make(_ConvGRUCell, 2, "Conv2DGRUCell")
Conv3DGRUCell = _make(_ConvGRUCell, 3, "Conv3DGRUCell")
