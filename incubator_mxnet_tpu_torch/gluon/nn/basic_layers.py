"""Gluon basic layers of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/nn/basic_layers.py).

The JAX layers defer input widths to the first forward; here a layer
with parameters takes its input width (`in_units`, `in_channels`) when
it is built, so its parameters exist and are initialized at once.

Dropout and BatchNorm follow `autograd.is_training()` (on inside
`autograd.record()`), as the JAX ops do, not `Module.train()`.

`HybridSequential` runs a pointwise `Conv2D` followed by a `BatchNorm`
that takes batch statistics as one fused step: `ops.conv1x1_bn_stats`
(`ops.conv_stats`' kernel) computes the product and the sums Σy, Σy² in
one pass, and the BatchNorm normalizes with statistics from those sums
instead of reading y again.  The children and their parameter names stay
as they are.  The product is called through the ops module, as every
layer calls its ops, so `contrib.amp` casts it as a Convolution.  The
pair fuses for the dtypes the kernel has instances for (f32, bf16, f16;
under amp the op casts only between these).
"""
from __future__ import annotations

import torch

from ..block import HybridBlock, new_parameter
from .conv_layers import Conv2D
from ... import autograd as _ag
from ... import config as _config
from ... import random as _rnd
from ...context import resolve_device
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
    """ref: nn.Dense → FullyConnected.  weight (units, in_units), bias
    zeros."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, device=None):
        super().__init__()
        if in_units <= 0:
            raise ValueError("Dense in the PyTorch port needs in_units > 0 "
                             "(widths are not deferred)")
        if activation is not None:
            raise NotImplementedError("Dense(activation=%r) is not yet "
                                      "ported" % (activation,))
        self._units = units
        self._flatten = flatten
        dev = resolve_device(device)
        self.weight = new_parameter("weight", (units, in_units),
                                    weight_initializer, dev, dtype)
        self.bias = new_parameter("bias", (units,), bias_initializer, dev,
                                  dtype) if use_bias else None

    def forward(self, x):
        return ops.fully_connected(x, self.weight, self.bias,
                                   num_hidden=self._units,
                                   no_bias=self.bias is None,
                                   flatten=self._flatten)


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
    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, dtype="float32"):
        super().__init__()
        if in_channels <= 0:
            raise ValueError("LayerNorm in the PyTorch port needs "
                             "in_channels > 0 (widths are not deferred)")
        self._axis = axis
        self._epsilon = epsilon
        dev = resolve_device(device)
        self.gamma = new_parameter("gamma", (in_channels,),
                                   gamma_initializer, dev, dtype)
        self.beta = new_parameter("beta", (in_channels,), beta_initializer,
                                  dev, dtype)
        self.gamma.requires_grad_(bool(scale))
        self.beta.requires_grad_(bool(center))

    def forward(self, x):
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
        if in_channels <= 0:
            raise ValueError("BatchNorm in the PyTorch port needs "
                             "in_channels > 0 (widths are not deferred)")
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        dev = resolve_device(device)
        shape = (in_channels,)
        self.gamma = new_parameter("gamma", shape, gamma_initializer, dev,
                                   dtype)
        self.beta = new_parameter("beta", shape, beta_initializer, dev,
                                  dtype)
        self.running_mean = new_parameter(
            "running_mean", shape, running_mean_initializer, dev, dtype)
        self.running_var = new_parameter(
            "running_var", shape, running_variance_initializer, dev, dtype)
        self.gamma.requires_grad_(bool(scale))
        self.beta.requires_grad_(bool(center))
        self.running_mean.requires_grad_(False)
        self.running_var.requires_grad_(False)

    @property
    def batch_stats(self):
        """Whether a call now normalizes with batch statistics."""
        return _ag.is_training() and not self._use_global_stats

    def forward(self, x, sums=None):
        """`sums` = (Σx, Σx², n) per channel, computed elsewhere (the
        fused pointwise convolution), stands in for reading x for the
        batch statistics."""
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
