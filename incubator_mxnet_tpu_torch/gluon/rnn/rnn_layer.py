"""The fused RNN layers of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/rnn/rnn_layer.py): `RNN`, `LSTM` and `GRU` over
the fused `RNN` op (`ops.rnn`).

A layer holds one flat parameter vector in the cuDNN packing, named
`parameters` as in the JAX package: its key in `collect_params()`,
`state_dict()` and parameter files is `<layer>.parameters`, and its
`Parameter.name` is the prefixed "lstm0_parameters".  On a
`torch.nn.Module`, `parameters` is torch's method, which the port's
`cast`, deferred initialization and serving engines call, so the
attribute stays the method and the vector is `layer.flat_param`
(`Block._register_shadowed`).  Its length is taken from the first
input's width when `input_size` is 0.  The layer's forward runs the op
on tensors: called with NDArrays it returns NDArrays.
"""
from __future__ import annotations

import torch

from ..block import HybridBlock, materialize
from ..parameter import is_deferred
from ... import autograd as _ag
from ... import random as _rnd
from ...base import MXNetError
from ...context import current_device, resolve_device
from ...ndarray.ndarray import unwrap
from ...ops import rnn as _rnn

__all__ = ["RNN", "LSTM", "GRU"]


def param_device(param):
    """The device a parameter lives on, or the one its deferred
    `initialize` named; None before `initialize`."""
    if not is_deferred(param):
        return param.device
    if param.__dict__.get("_deferred_init") is not None:
        return param.data.device
    return None


class _RNNLayer(HybridBlock):
    """The flat vector is initialized whole by `i2h_weight_initializer`
    (default: `initialize`'s); the other initializer arguments are
    accepted and ignored, as in the JAX package."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", prefix=None, params=None,
                 device=None, dtype="float32"):
        super().__init__(prefix=prefix, params=params)
        if layout not in ("TNC", "NTC"):
            raise MXNetError("layout must be TNC or NTC, got %s" % layout)
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._mode = mode
        psize = _rnn.rnn_param_size(mode, num_layers, input_size,
                                    hidden_size, bidirectional) \
            if input_size else 0
        flat = self.params.get("parameters", shape=(psize,),
                               init=i2h_weight_initializer, dtype=dtype,
                               allow_deferred_init=True)
        if device is not None and is_deferred(flat) and \
                flat.__dict__.get("_deferred_init") is None:
            flat.initialize(ctx=device)
        self._register_shadowed("parameters", flat)

    @property
    def flat_param(self):
        """The flat parameter vector (the JAX layer's `parameters`)."""
        return self._parameters["parameters"]

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape}] * (2 if self._mode == "lstm" else 1)

    def begin_state(self, batch_size=0, func=None, ctx=None, **kwargs):
        """The initial states, zeros by default: on `ctx`, else the
        layer's device, in `dtype`, else the layer's.  `func(shape,
        **kwargs)` makes them instead when given (`ctx` passed on)."""
        states = []
        for info in self.state_info(batch_size):
            if func is not None:
                kw = dict(kwargs)
                if ctx is not None:
                    kw["ctx"] = ctx
                states.append(func(info["shape"], **kw))
                continue
            p = self.flat_param
            dev = resolve_device(ctx) if ctx is not None else (
                param_device(p) or current_device())
            states.append(torch.zeros(info["shape"], device=dev,
                                      dtype=kwargs.get("dtype") or p.dtype))
        return states

    def infer_shape(self, x, *args):
        in_sz = x.shape[-1]
        self._input_size = in_sz
        materialize(self.flat_param, (_rnn.rnn_param_size(
            self._mode, self._num_layers, in_sz, self._hidden_size,
            self._dir == 2),))

    def forward(self, inputs, states=None):
        """y (in the layout's order), or (y, new states) when `states`
        is given."""
        self.infer_shape(inputs)
        explicit = states is not None
        if states is None:
            states = self.begin_state(
                inputs.shape[self._layout.find("N")], ctx=inputs.device,
                dtype=inputs.dtype)
        if not isinstance(states, (list, tuple)):
            states = [states]
        states = [unwrap(s) for s in states]
        x = inputs.transpose(0, 1) if self._layout == "NTC" else inputs
        p = self._dropout
        out = _rnn.rnn(x, self.flat_param, *states,
                       state_size=self._hidden_size,
                       num_layers=self._num_layers,
                       bidirectional=self._dir == 2, mode=self._mode, p=p,
                       state_outputs=True, _training=_ag.is_training(),
                       _rng_key=_rnd.generator(x.device) if p else None)
        y, new_states = out[0], list(out[1:])
        if self._layout == "NTC":
            y = y.transpose(0, 1)
        return (y, new_states) if explicit else y


class RNN(_RNNLayer):
    """ref: gluon.rnn.RNN: an Elman RNN, tanh or relu."""

    def __init__(self, hidden_size, num_layers=1, activation="tanh",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        mode = "rnn_relu" if activation == "relu" else "rnn_tanh"
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, mode, **kwargs)


class LSTM(_RNNLayer):
    """ref: gluon.rnn.LSTM (the GNMT and Sockeye workhorse)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    """ref: gluon.rnn.GRU."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
