"""Gluon RNN cells of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/rnn/rnn_cell.py).

A cell steps one time step: `cell(x, states)` → (output, new states),
and `unroll(length, inputs, ...)` steps it over a sequence.  The cells
compute on tensors; called (or unrolled) with NDArrays, in a state list
too, they return NDArrays.  Parameters come from `self.params.get` as in
the JAX package (so `params=` shares them), with the input width of
`i2h_weight` taken from the first input when `input_size` is 0.  A cell
built with `device=` is initialized there at once.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_map

from ..block import HybridBlock, materialize
from ..parameter import is_deferred
from ... import autograd as _ag
from ... import random as _rnd
from ...base import MXNetError
from ...context import current_device, resolve_device
from ...ndarray.ndarray import NDArray, _wrap, unwrap
from ...ops import nn as ops
from ...ops import tensor as _tensor
from .rnn_layer import param_device

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell", "HybridRecurrentCell"]


def _nd_tree(fn, *args):
    """fn(*args) over tensors: NDArrays anywhere in `args` (a state list
    too) unwrapped, and the result's tensors wrapped back when there was
    one."""
    if not any(isinstance(a, NDArray) for a in tree_flatten(args)[0]):
        return fn(*args)
    out = fn(*tree_map(unwrap, args))
    return tree_map(lambda t: _wrap(t) if isinstance(t, torch.Tensor)
                    else t, out)


def cell_param(block, name, shape, init, device, dtype):
    """`block.params.get(name, ...)`, initialized on `device` at once when
    one is given (or when its shape becomes known)."""
    p = block.params.get(name, shape=shape, init=init, dtype=dtype,
                         allow_deferred_init=True)
    if device is not None and is_deferred(p) and \
            p.__dict__.get("_deferred_init") is None:
        p.initialize(ctx=device)
    return p


class RecurrentCell(HybridBlock):
    """ref: rnn_cell.RecurrentCell: the begin_state/unroll contract."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.reset()

    def reset(self):
        """Reset the step counters, the children's too."""
        self._init_counter = -1
        self._counter = -1
        for cell in self.children():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def _device(self):
        for p in self.params.values():
            dev = param_device(p)
            if dev is not None:
                return dev
        for cell in self.children():
            if isinstance(cell, RecurrentCell):
                return cell._device()
        return current_device()

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """The initial states, zeros by default, on `ctx` (else the cell's
        device) in `dtype` (else float32); `func(shape, **kwargs)` makes
        them instead when given."""
        kw = {k: v for k, v in kwargs.items() if v is not None}
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            if func is not None:
                states.append(func(shape, **info, **kw))
                continue
            ctx = kw.get("ctx")
            states.append(torch.zeros(
                shape, dtype=kw.get("dtype", torch.float32),
                device=resolve_device(ctx) if ctx is not None
                else self._device()))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Step the cell over `length` steps of `inputs` (a tensor in
        `layout`, or a list of (N, C) steps): (outputs, last states).
        Merged (the default for a tensor) the outputs are one tensor, and
        `valid_length` (N,) zeroes each row's steps past its length."""
        return _nd_tree(lambda i, s, v: self._unroll(
            length, i, s, layout, merge_outputs, v),
            inputs, begin_state, valid_length)

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        axis = layout.find("T")
        if isinstance(inputs, (list, tuple)):
            seq = list(inputs)
            batch = seq[0].shape[0]
        else:
            seq = [inputs.select(axis, i) for i in range(length)]
            batch = inputs.shape[layout.find("N")]
        states = begin_state if begin_state is not None else \
            self.begin_state(batch, ctx=seq[0].device, dtype=seq[0].dtype)
        outputs = []
        for i in range(length):
            out, states = self(seq[i], states)
            outputs.append(out)
        if merge_outputs or merge_outputs is None:
            outputs = torch.stack(outputs, dim=axis)
            if valid_length is not None:
                masked = _tensor.sequence_mask(
                    outputs.transpose(0, 1) if axis == 1 else outputs,
                    valid_length, use_sequence_length=True)
                outputs = masked.transpose(0, 1) if axis == 1 else masked
        return outputs, states

    def __call__(self, inputs, states=None, **kwargs):
        self._counter += 1
        args = (inputs,) if states is None else (inputs, states)
        return _nd_tree(lambda *a: HybridBlock.__call__(self, *a, **kwargs),
                        *args)


HybridRecurrentCell = RecurrentCell


def _fc(x, weight, bias, units):
    return ops.fully_connected(x, weight, bias, num_hidden=units)


class _GatedCell(RecurrentCell):
    """i2h/h2h weights (G·H, input) and (G·H, H) and their biases; the
    input width is taken from the first input when not given."""

    _GATES = 1

    def __init__(self, hidden_size, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 prefix=None, params=None, device=None, dtype="float32"):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        G = self._GATES * hidden_size
        kw = dict(device=device, dtype=dtype)
        self.i2h_weight = cell_param(self, "i2h_weight", (G, input_size),
                                     i2h_weight_initializer, **kw)
        self.h2h_weight = cell_param(self, "h2h_weight", (G, hidden_size),
                                     h2h_weight_initializer, **kw)
        self.i2h_bias = cell_param(self, "i2h_bias", (G,),
                                   i2h_bias_initializer, **kw)
        self.h2h_bias = cell_param(self, "h2h_bias", (G,),
                                   h2h_bias_initializer, **kw)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}]

    def infer_shape(self, x, *args):
        materialize(self.i2h_weight, (self._GATES * self._hidden_size,
                                      x.shape[-1]))

    def _projections(self, inputs, h):
        self.infer_shape(inputs)
        G = self._GATES * self._hidden_size
        return (_fc(inputs, self.i2h_weight, self.i2h_bias, G),
                _fc(h, self.h2h_weight, self.h2h_bias, G))


class RNNCell(_GatedCell):
    """ref: rnn_cell.RNNCell: act(W_i x + b_i + W_h h + b_h)."""

    def __init__(self, hidden_size, activation="tanh", input_size=0,
                 **kwargs):
        super().__init__(hidden_size, input_size, **kwargs)
        self._activation = activation

    def forward(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0])
        output = ops.activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """ref: rnn_cell.LSTMCell, gates [i, f, g, o]."""

    _GATES = 4

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size)}] * 2

    def forward(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0])
        in_gate, forget_gate, in_trans, out_gate = torch.chunk(
            i2h + h2h, 4, dim=-1)
        next_c = torch.sigmoid(forget_gate) * states[1] + \
            torch.sigmoid(in_gate) * torch.tanh(in_trans)
        next_h = torch.sigmoid(out_gate) * torch.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """ref: rnn_cell.GRUCell, gates [r, z, n], n = tanh(x_n + r·h_n)."""

    _GATES = 3

    def forward(self, inputs, states):
        i2h, h2h = self._projections(inputs, states[0])
        i2h_r, i2h_z, i2h_n = torch.chunk(i2h, 3, dim=-1)
        h2h_r, h2h_z, h2h_n = torch.chunk(h2h, 3, dim=-1)
        reset = torch.sigmoid(i2h_r + h2h_r)
        update = torch.sigmoid(i2h_z + h2h_z)
        next_h_tmp = torch.tanh(i2h_n + reset * h2h_n)
        next_h = (1.0 - update) * next_h_tmp + update * states[0]
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order, each on its own slice
    of the states."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return sum((c.state_info(batch_size) for c in self.children()), [])

    def __len__(self):
        return len(self._modules)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        pos = 0
        for cell in self.children():
            n = len(cell.state_info())
            state = states[pos:pos + n]
            pos += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def forward(self, *args, **kwargs):
        raise MXNetError("SequentialRNNCell is called step-wise")


class DropoutCell(RecurrentCell):
    """Dropout of the input while `autograd.is_training()`; no state."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        if self._rate > 0:
            inputs = ops.dropout(inputs, self._rate,
                                 training=_ag.is_training(),
                                 generator=_rnd.generator(inputs.device),
                                 axes=self._axes)
        return inputs, states


def _keep_mask(like, p):
    """Dropout of ones: a per-element keep mask (all kept outside
    training)."""
    return ops.dropout(torch.ones_like(like), p, training=_ag.is_training(),
                       generator=_rnd.generator(like.device)) != 0


class ZoneoutCell(RecurrentCell):
    """Zoneout around a base cell: while training each output and state
    element keeps its previous value with probability `zoneout_*`."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.base_cell = base_cell
        self._zoneout_outputs = zoneout_outputs
        self._zoneout_states = zoneout_states
        self._prev_output = None

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def __call__(self, inputs, states):
        return _nd_tree(self._step, inputs, states)

    def _step(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        if self._zoneout_outputs > 0.:
            prev = self._prev_output
            if prev is None:
                prev = torch.zeros_like(next_output)
            next_output = torch.where(
                _keep_mask(next_output, self._zoneout_outputs),
                next_output, prev)
            self._prev_output = next_output
        if self._zoneout_states > 0.:
            next_states = [torch.where(_keep_mask(ns, self._zoneout_states),
                                       ns, s)
                           for ns, s in zip(next_states, states)]
        return next_output, next_states


class ResidualCell(RecurrentCell):
    """The base cell's output plus its input."""

    def __init__(self, base_cell, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    """`l_cell` forward and `r_cell` backward over the sequence, their
    outputs concatenated per step; only `unroll` runs it."""

    def __init__(self, l_cell, r_cell, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.l_cell = l_cell
        self.r_cell = r_cell

    def state_info(self, batch_size=0):
        return self.l_cell.state_info(batch_size) + \
            self.r_cell.state_info(batch_size)

    def __call__(self, inputs, states):
        raise MXNetError("BidirectionalCell cannot be stepped — use unroll")

    def _unroll(self, length, inputs, begin_state, layout, merge_outputs,
                valid_length):
        axis = layout.find("T")
        if not isinstance(inputs, (list, tuple)):
            seq = [inputs.select(axis, i) for i in range(length)]
        else:
            seq = list(inputs)
        states = begin_state if begin_state is not None else \
            self.begin_state(seq[0].shape[0], ctx=seq[0].device,
                             dtype=seq[0].dtype)
        nl = len(self.l_cell.state_info())
        l_states, r_states = states[:nl], states[nl:]
        l_out = []
        for i in range(length):
            o, l_states = self.l_cell(seq[i], l_states)
            l_out.append(o)
        r_out = []
        for i in reversed(range(length)):
            o, r_states = self.r_cell(seq[i], r_states)
            r_out.append(o)
        outs = [torch.cat([l, r], dim=-1)
                for l, r in zip(l_out, r_out[::-1])]
        if merge_outputs or merge_outputs is None:
            outs = torch.stack(outs, dim=axis)
        return outs, list(l_states) + list(r_states)
