"""Gluon basic layers of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/nn/basic_layers.py).

As in the JAX package, an input width a layer is not given (`in_units`,
`in_channels` 0) is taken from the first forward's input: the layer
materialises its parameters there (`block.materialize`) on the device
`initialize` named.  A layer built with `device=` is initialized there
at once (`block.new_parameter`); without it, `initialize` does it.

Dropout and BatchNorm follow `autograd.is_training()` (on inside
`autograd.record()`), as the JAX ops do, not `Module.train()`.

`HybridSequential` (and `Sequential`) runs a pointwise `Conv2D` followed
by a `BatchNorm` that takes batch statistics as one fused step:
`ops.conv1x1_bn_stats` (`ops.conv_stats`' kernel) computes the product
and the sums Σy, Σy² in one pass, and the BatchNorm normalizes with statistics from those sums
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

from ..block import (Block, HybridBlock, call_on_ndarrays, materialize,
                     new_parameter)
from .conv_layers import Conv2D
from ... import autograd as _ag
from ... import config as _config
from ... import random as _rnd
from ...ops import conv_stats as _conv_stats
from ...ops import nn as ops

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "Embedding", "LayerNorm", "BatchNorm", "Flatten", "InstanceNorm",
           "GroupNorm", "Lambda", "HybridLambda", "fused_pairs"]


def _pair(block, nxt):
    """A pointwise Conv2D followed by a BatchNorm over its channels that
    can take batch statistics."""
    return (isinstance(block, Conv2D) and block.pointwise
            and isinstance(nxt, BatchNorm) and nxt._axis == 1
            and not nxt._use_global_stats)


def _fuses(block, nxt, x):
    """A pair (`_pair`) whose BatchNorm now takes batch statistics in the
    one-pass form the kernel's sums give, over an activation `x` of a
    dtype the kernel has an instance for."""
    return (_pair(block, nxt) and nxt.batch_stats
            and not _config.get("MXNET_BN_STABLE_VAR")
            and x.dtype in _conv_stats.KERNEL_DTYPES)


def fused_pairs(net):
    """The pointwise Conv2D → BatchNorm pairs of `net`'s sequential
    blocks, as their forwards pair them, that run fused in a training
    step (f32, bf16 or f16 activations, MXNET_BN_STABLE_VAR off): read
    from the block tree.  A block that runs its children otherwise (a
    HybridConcurrent's branches) pairs none of them."""
    return sum(bn is not None for m in net.modules()
               if isinstance(m, _Chain) and type(m).forward is _Chain.forward
               for _, bn in m._steps(_pair))


def _conv1x1_bn(conv, bn, x):
    N, _, H, W = x.shape
    conv.infer_shape(x)
    bn.infer_channels(conv.channels)
    y, s1, s2 = ops.conv1x1_bn_stats(x, conv.weight)
    return bn(y, sums=(s1, s2, N * H * W))


class _Chain:
    """The children of a sequential block run in order; they are named
    "0", "1", ... as the JAX package's `register_child` names them.  A
    pointwise Conv2D followed by a BatchNorm taking batch statistics runs
    fused (module doc)."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def _steps(self, pairs):
        """The children in order as (block, the BatchNorm it runs with, or
        None): a child pairs with the next where `pairs(block, nxt)`
        holds, asked only as the walk reaches it."""
        blocks = list(self._modules.values())
        i = 0
        while i < len(blocks):
            if i + 1 < len(blocks) and pairs(blocks[i], blocks[i + 1]):
                yield blocks[i], blocks[i + 1]
                i += 2
            else:
                yield blocks[i], None
                i += 1

    def forward(self, x, *args):
        # the walk asks `_fuses` of each child with the x it gets
        for block, bn in self._steps(lambda b, nxt: _fuses(b, nxt, x)):
            x = block(x) if bn is None else _conv1x1_bn(block, bn, x)
        return x

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, key):
        """The child at `key`, or for a slice a new block of the same type
        holding those children."""
        layers = list(self._modules.values())[key]
        if not isinstance(layers, list):
            return layers
        net = type(self)()
        net.add(*layers)
        return net


class Sequential(_Chain, Block):
    """ref: nn.Sequential."""


class HybridSequential(_Chain, HybridBlock):
    """ref: nn.HybridSequential."""


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
    the mask comes from the input device's generator and is shared along
    `axes`."""

    def __init__(self, rate, axes=()):
        super().__init__()
        self._rate = rate
        self._axes = tuple(axes)

    def forward(self, x):
        if not _ag.is_training():
            return x
        return ops.dropout(x, self._rate, training=True,
                           generator=_rnd.generator(x.device),
                           axes=self._axes)


class Embedding(HybridBlock):
    """ref: nn.Embedding.  With `sparse_grad=True` the weight's gradient
    is row_sparse (`grad_stype`): only the looked-up rows, which the
    optimizers update lazily."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, device=None):
        super().__init__()
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = sparse_grad
        self.weight = new_parameter(
            "weight", (input_dim, output_dim), weight_initializer, device,
            dtype, grad_stype="row_sparse" if sparse_grad else "default")

    def forward(self, x):
        return ops.embedding(x, self.weight, sparse_grad=self._sparse_grad)


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


class _ChannelNorm(HybridBlock):
    """gamma and beta (C,) over the channel axis 1 of its input."""

    def __init__(self, epsilon, center, scale, beta_initializer,
                 gamma_initializer, in_channels, device, dtype):
        super().__init__()
        self._epsilon = epsilon
        self.gamma = new_parameter("gamma", (in_channels,),
                                   gamma_initializer, device, dtype,
                                   grad_req="write" if scale else "null")
        self.beta = new_parameter("beta", (in_channels,), beta_initializer,
                                  device, dtype,
                                  grad_req="write" if center else "null")

    def infer_shape(self, x):
        for p in (self.gamma, self.beta):
            materialize(p, (x.shape[1],))


class InstanceNorm(_ChannelNorm):
    """ref: nn.InstanceNorm: each (example, channel) normalized over its
    spatial axes; gamma learned only with `scale` (off by default)."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, dtype="float32"):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, device, dtype)

    def forward(self, x):
        self.infer_shape(x)
        return ops.instance_norm(x, self.gamma, self.beta,
                                 eps=self._epsilon)


class GroupNorm(_ChannelNorm):
    """ref: nn.GroupNorm: each example's `num_groups` channel groups
    normalized; gamma and beta per channel, as in the JAX package
    (`ops.nn.group_norm`)."""

    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, dtype="float32"):
        super().__init__(epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, device, dtype)
        self._num_groups = num_groups

    def forward(self, x):
        self.infer_shape(x)
        return ops.group_norm(x, self.gamma, self.beta,
                              num_groups=self._num_groups,
                              eps=self._epsilon)


def _nd_function(function):
    """`function`, or the `mx.nd` op a string names."""
    if isinstance(function, str):
        from ... import ndarray as nd
        return getattr(nd, function)
    return function


class Lambda(Block):
    """ref: nn.Lambda: a block over `function`, or over the `mx.nd` op a
    string names, called with NDArrays."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func = _nd_function(function)

    def forward(self, *args):
        return call_on_ndarrays(self._func, *args)


class HybridLambda(HybridBlock):
    """ref: nn.HybridLambda: `function(x, *args)` over NDArrays, as the
    JAX package calls it (upstream MXNet passes `F` first), or the `F`
    op a string names."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func_name, self._func = function, None
        else:
            self._func_name, self._func = function.__name__, function

    def hybrid_forward(self, F, x, *args):
        fn = self._func or getattr(F, self._func_name)
        return fn(x, *args)
