"""Gluon basic layers of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/nn/basic_layers.py).

As in the JAX package, an input width a layer is not given (`in_units`,
`in_channels` 0) is taken from the first forward's input: the layer
materialises its parameters there (`block.materialize`) on the device
`initialize` named.  A layer built with `device=` is initialized there
at once (`block.new_parameter`); without it, `initialize` does it.

Dropout and BatchNorm follow `autograd.is_training()` (on inside
`autograd.record()`), as the JAX ops do, not `Module.train()`.

`HybridSequential` runs a pointwise `Conv2D` followed by a `BatchNorm`
that takes batch statistics as one fused step: `ops.conv1x1_bn_stats`
(`ops.conv_stats`' kernel) computes the product and the sums Σy, Σy² in
one pass, and the BatchNorm normalizes with statistics from those sums
instead of reading y again.  The children and their parameter names stay
as they are.  A deferred width of either layer is materialised from `x`
before the kernel reads the weight.  The product is called through the
ops module, as every layer calls its ops, so `contrib.amp` casts it as a
Convolution.  The pair fuses for the dtypes the kernel has instances for
(f32, bf16, f16; under amp the op casts only between these).
"""
from __future__ import annotations

import math

import torch

from ..block import HybridBlock, materialize, new_parameter
from .conv_layers import Conv2D
from ... import autograd as _ag
from ... import config as _config
from ... import random as _rnd
from ...ops import conv_stats as _conv_stats
from ...ops import nn as ops

__all__ = ["HybridSequential", "Dense", "Dropout", "Embedding", "LayerNorm",
           "BatchNorm", "Flatten"]


def _fuses(block, nxt, x):
    """A pointwise Conv2D whose BatchNorm takes batch statistics in the
    one-pass form the kernel's sums give, over an activation `x` of a
    dtype the kernel has an instance for."""
    return (isinstance(block, Conv2D) and block.pointwise
            and isinstance(nxt, BatchNorm) and nxt.batch_stats
            and nxt._axis == 1 and not _config.get("MXNET_BN_STABLE_VAR")
            and x.dtype in _conv_stats.KERNEL_DTYPES)


def _conv1x1_bn(conv, bn, x):
    N, _, H, W = x.shape
    conv.infer_shape(x)
    bn.infer_channels(conv.channels)
    y, s1, s2 = ops.conv1x1_bn_stats(x, conv.weight)
    return bn(y, sums=(s1, s2, N * H * W))


class HybridSequential(HybridBlock):
    """Children run in order; they are named "0", "1", ... as the JAX
    package's `register_child` names them.  A pointwise Conv2D followed
    by a BatchNorm taking batch statistics runs fused (module doc)."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def forward(self, x, *args):
        blocks = list(self._modules.values())
        i = 0
        while i < len(blocks):
            nxt = blocks[i + 1] if i + 1 < len(blocks) else None
            if _fuses(blocks[i], nxt, x):
                x = _conv1x1_bn(blocks[i], nxt, x)
                i += 2
            else:
                x = blocks[i](x)
                i += 1
        return x

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]


class Dense(HybridBlock):
    """ref: nn.Dense → FullyConnected, then `activation` if given.
    weight (units, in_units), bias zeros; `in_units=0` takes the input's
    width (its last axis without `flatten`, else all but the first)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, device=None):
        super().__init__()
        self._units = units
        self._flatten = flatten
        self.act = activation
        self.weight = new_parameter("weight", (units, in_units),
                                    weight_initializer, device, dtype)
        self.bias = new_parameter("bias", (units,), bias_initializer,
                                  device, dtype) if use_bias else None

    def infer_shape(self, x):
        in_units = x.shape[-1] if not self._flatten else \
            int(math.prod(x.shape[1:]))
        materialize(self.weight, (self._units, in_units))

    def forward(self, x):
        self.infer_shape(x)
        out = ops.fully_connected(x, self.weight, self.bias,
                                  num_hidden=self._units,
                                  no_bias=self.bias is None,
                                  flatten=self._flatten)
        if self.act is not None:
            out = ops.activation(out, act_type=self.act)
        return out


class Dropout(HybridBlock):
    """Inverted dropout while `autograd.is_training()`, else the identity;
    the mask comes from the input device's generator."""

    def __init__(self, rate, axes=()):
        super().__init__()
        if axes:
            raise NotImplementedError("Dropout(axes=...) is not yet ported")
        self._rate = rate

    def forward(self, x):
        if not _ag.is_training():
            return x
        return ops.dropout(x, self._rate, training=True,
                           generator=_rnd.generator(x.device))


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, device=None):
        super().__init__()
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = new_parameter("weight", (input_dim, output_dim),
                                    weight_initializer, device, dtype)

    def forward(self, x):
        return ops.embedding(x, self.weight)


class LayerNorm(HybridBlock):
    """ref: nn.LayerNorm over `axis`; `in_channels=0` takes the input's
    width on that axis."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, dtype="float32"):
        super().__init__()
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = new_parameter("gamma", (in_channels,),
                                   gamma_initializer, device, dtype,
                                   grad_req="write" if scale else "null")
        self.beta = new_parameter("beta", (in_channels,), beta_initializer,
                                  device, dtype,
                                  grad_req="write" if center else "null")

    def forward(self, x):
        for p in (self.gamma, self.beta):
            materialize(p, (x.shape[self._axis],))
        return ops.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                              eps=self._epsilon)


class BatchNorm(HybridBlock):
    """ref: nn.BatchNorm.  gamma, beta and the running statistics
    (`running_mean`, `running_var`: parameters without gradient, grad_req
    'null' in the JAX package) over channel `axis`.  While
    `autograd.is_training()` and not `use_global_stats` it normalizes
    with the batch statistics and updates the running ones as
    running * momentum + batch * (1 - momentum), with the biased batch
    variance; otherwise it normalizes with the running ones."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 device=None, dtype="float32"):
        super().__init__()
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        shape = (in_channels,)
        self.gamma = new_parameter("gamma", shape, gamma_initializer,
                                   device, dtype,
                                   grad_req="write" if scale else "null")
        self.beta = new_parameter("beta", shape, beta_initializer, device,
                                  dtype,
                                  grad_req="write" if center else "null")
        self.running_mean = new_parameter(
            "running_mean", shape, running_mean_initializer, device, dtype,
            grad_req="null")
        self.running_var = new_parameter(
            "running_var", shape, running_variance_initializer, device,
            dtype, grad_req="null")

    def infer_channels(self, channels):
        """Materialise deferred parameters for `channels` channels."""
        for p in (self.gamma, self.beta, self.running_mean,
                  self.running_var):
            materialize(p, (channels,))

    @property
    def batch_stats(self):
        """Whether a call now normalizes with batch statistics."""
        return _ag.is_training() and not self._use_global_stats

    def forward(self, x, sums=None):
        """`sums` = (Σx, Σx², n) per channel, computed elsewhere (the
        fused pointwise convolution), stands in for reading x for the
        batch statistics."""
        self.infer_channels(x.shape[self._axis])
        batch = self.batch_stats
        out, mean, var = ops.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            eps=self._epsilon, fix_gamma=not self._scale,
            use_global_stats=self._use_global_stats, axis=self._axis,
            training=batch, sums=sums)
        if batch:
            m = self._momentum
            with torch.no_grad():
                for run, stat in ((self.running_mean, mean),
                                  (self.running_var, var)):
                    run.copy_(run * m + stat * (1 - m))
        return out


class Flatten(HybridBlock):
    """ref: nn.Flatten: (N, ...) → (N, prod(...))."""

    def forward(self, x):
        return ops.flatten(x)
