"""`gluon.contrib.rnn` cells of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/contrib/rnn/rnn_cell.py):
`VariationalDropoutCell` and `LSTMPCell`."""
from __future__ import annotations

import torch

from ...rnn.rnn_cell import (RecurrentCell, _fc, _keep_mask, _nd_tree,
                             cell_param)
from ...block import materialize
from .... import autograd as _ag

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(RecurrentCell):
    """Variational ("locked") dropout around a base cell: one mask per
    sequence for the inputs, the states and the outputs, drawn at its
    first step while training and reused at every later one (ref: contrib
    VariationalDropoutCell, Gal & Ghahramani 2016).  `unroll` starts a
    sequence (`reset`)."""

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0., prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.base_cell = base_cell
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self._clear_masks()

    def _clear_masks(self):
        self._mask_in = None
        self._mask_states = None
        self._mask_out = None

    def reset(self):
        super().reset()
        self._clear_masks()

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    @staticmethod
    def _mask(like, p):
        """0 or 1/(1-p) per element, as Dropout of ones gives it."""
        return _keep_mask(like, p).to(like.dtype) / (1.0 - p)

    def __call__(self, inputs, states):
        return _nd_tree(self._step, inputs, states)

    def _step(self, inputs, states):
        self._counter += 1
        training = _ag.is_training()
        if training and self.drop_inputs > 0.:
            if self._mask_in is None:
                self._mask_in = self._mask(inputs, self.drop_inputs)
            inputs = inputs * self._mask_in
        if training and self.drop_states > 0.:
            if self._mask_states is None:
                self._mask_states = [self._mask(s, self.drop_states)
                                     for s in states]
            states = [s * m for s, m in zip(states, self._mask_states)]
        out, next_states = self.base_cell(inputs, states)
        if training and self.drop_outputs > 0.:
            if self._mask_out is None:
                self._mask_out = self._mask(out, self.drop_outputs)
            out = out * self._mask_out
        return out, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()        # fresh masks per sequence
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs,
                              valid_length=valid_length)


class LSTMPCell(RecurrentCell):
    """LSTM with a projected hidden state (LSTMP, ref: contrib LSTMPCell;
    Sak et al. 2014): the cell state keeps `hidden_size`, the recurrent
    and output h is projected to `projection_size`."""

    def __init__(self, hidden_size, projection_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None,
                 device=None, dtype="float32"):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        G = 4 * hidden_size
        kw = dict(device=device, dtype=dtype)
        self.i2h_weight = cell_param(self, "i2h_weight", (G, input_size),
                                     i2h_weight_initializer, **kw)
        self.h2h_weight = cell_param(self, "h2h_weight",
                                     (G, projection_size),
                                     h2h_weight_initializer, **kw)
        self.h2r_weight = cell_param(self, "h2r_weight",
                                     (projection_size, hidden_size),
                                     h2r_weight_initializer, **kw)
        self.i2h_bias = cell_param(self, "i2h_bias", (G,),
                                   i2h_bias_initializer, **kw)
        self.h2h_bias = cell_param(self, "h2h_bias", (G,),
                                   h2h_bias_initializer, **kw)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size)},
                {"shape": (batch_size, self._hidden_size)}]

    def infer_shape(self, x, *args):
        materialize(self.i2h_weight, (4 * self._hidden_size, x.shape[-1]))

    def forward(self, inputs, states):
        self.infer_shape(inputs)
        G = 4 * self._hidden_size
        gates = _fc(inputs, self.i2h_weight, self.i2h_bias, G) + \
            _fc(states[0], self.h2h_weight, self.h2h_bias, G)
        in_g, forget_g, in_t, out_g = torch.chunk(gates, 4, dim=-1)
        next_c = torch.sigmoid(forget_g) * states[1] + \
            torch.sigmoid(in_g) * torch.tanh(in_t)
        hidden = torch.sigmoid(out_g) * torch.tanh(next_c)
        next_r = _fc(hidden, self.h2r_weight, None, self._projection_size)
        return next_r, [next_r, next_c]
