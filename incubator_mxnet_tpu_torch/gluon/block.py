"""`Block` and `HybridBlock` of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/block.py) as `torch.nn.Module` subclasses.

Parameters are `nn.Parameter`s created and initialized when a layer is
built, on the layer's device, from that device's generator
(`random.generator`).  `collect_params()` names them structurally, as
the JAX package's `_collect_params_with_prefix()` does
(`encoder.layers.0.attn.query.weight`), which is also their
`named_parameters()` name.

`cast(dtype)` converts every parameter of the tree in place, keeping
each `nn.Parameter` object, so a `Trainer` built before or after the
cast updates the cast tensors.
"""
from __future__ import annotations

import re
from collections import OrderedDict

import torch
from torch import nn

from .. import initializer as init_mod
from .. import random as _rnd
from ..base import torch_dtype
from ..context import resolve_device

__all__ = ["Block", "HybridBlock", "new_parameter", "cast_parameter"]


def new_parameter(name, shape, init, device, dtype):
    """An initialized `nn.Parameter` of `shape` on `device`; `init` is an
    Initializer, one of its names, or None for the default `Uniform()`."""
    dev = resolve_device(device)
    data = torch.empty(tuple(shape), device=dev, dtype=torch_dtype(dtype))
    init_mod.create(init)(name, data, _rnd.generator(dev))
    return nn.Parameter(data)


@torch.no_grad()
def cast_parameter(param, dtype):
    """Cast `param` in place to `dtype`, keeping the `nn.Parameter`
    object: its data is replaced and its gradient dropped (ref:
    Parameter.cast)."""
    dt = torch_dtype(dtype)
    if param.dtype != dt:
        param.data = param.data.to(dt)
        param.grad = None


class Block(nn.Module):
    """ref: gluon.Block — a composable layer; the PyTorch module protocol
    (`forward`, `train()`/`eval()`, `state_dict`) applies as is."""

    def collect_params(self, select=None):
        """OrderedDict of structural parameter names → parameters, for the
        names matching the regular expression `select` if given."""
        pattern = re.compile(select) if select is not None else None
        return OrderedDict(
            (name, p) for name, p in self.named_parameters()
            if pattern is None or pattern.match(name))

    def hybridize(self, active=True, static_alloc=False, static_shape=False,
                  inline_limit=2, forward_bulk_size=None,
                  backward_bulk_size=None, remat=False, remat_policy=None):
        """Takes the JAX package's arguments and stays eager: capturing
        a CUDA graph per shape is later work."""

    def cast(self, dtype):
        """Cast every parameter of the tree to `dtype` ("bfloat16",
        "float16", "float32" or a torch dtype), BatchNorm's running
        statistics included, as the JAX `Block.cast` does (only
        `contrib.amp.convert_hybrid_block` keeps norm parameters f32).
        Each `nn.Parameter` keeps its identity; its data is replaced and
        its gradient dropped.  Returns the block."""
        for p in self.parameters():
            cast_parameter(p, dtype)
        return self

    def to_device(self, device=None):
        """Move the parameters to `device` (default `cuda:0`)."""
        return self.to(resolve_device(device))


class HybridBlock(Block):
    """ref: gluon.HybridBlock."""

    def inference_engine(self, **kwargs):
        """Build a `serving.InferenceEngine` over this block; keyword
        arguments go to `InferenceEngine` (device, buckets, max_batch,
        queue_cap, example_shape, wire_dtype, ...)."""
        from ..serving import InferenceEngine
        return InferenceEngine(self, **kwargs)
