"""`Block` and `HybridBlock` of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/block.py) as `torch.nn.Module` subclasses.

Parameters are the port's `gluon.Parameter`s (`nn.Parameter`s with the
JAX package's attributes).  A layer built without `device=` has
parameters without data until `initialize(init, ctx)`; a layer built
with `device=` is initialized there at construction with the default
initializer, as the JAX package's `get_resnet(ctx=...)` does.  An input
width a layer is not given (`Dense(in_units=0)`, `Conv2D(in_channels=0)`,
`BatchNorm`, `LayerNorm`) is taken from the first forward's input, which
then materialises and fills the parameter on its `initialize` device.
`collect_params()` returns a `ParameterDict` keyed by structural names,
as the JAX package's `_collect_params_with_prefix()` names them
(`encoder.layers.0.attn.query.weight`), which are also their
`named_parameters()` names and the keys of `save_parameters` files.

`cast(dtype)` converts every parameter of the tree in place, keeping
each parameter object (one not yet materialised records the dtype), so
a `Trainer` built before or after the cast updates the cast tensors.
"""
from __future__ import annotations

import re

from torch import nn

from .parameter import (Parameter, ParameterDict, cast_parameter,
                        is_deferred)
from ..base import MXNetError
from ..context import resolve_device

__all__ = ["Block", "HybridBlock", "new_parameter", "cast_parameter",
           "materialize"]


def new_parameter(name, shape, init, device, dtype, grad_req="write"):
    """A `Parameter` of `shape` (0 for a width the first input gives);
    `init` is an Initializer, one of its names, or None for the default
    `Uniform()`.  With a `device` it is initialized there at once (or
    when its shape becomes known); without one it waits for
    `initialize`."""
    p = Parameter(name, grad_req=grad_req, shape=shape, dtype=dtype,
                  init=init, allow_deferred_init=True)
    if device is not None:
        p.initialize(ctx=device)
    return p


def materialize(param, shape):
    """Give a deferred `param` its full `shape` and complete its
    initialization; a parameter that has data is left as it is."""
    if is_deferred(param):
        param._set_shape(shape)
        param._finish_deferred_init()


class Block(nn.Module):
    """ref: gluon.Block — a composable layer; the PyTorch module protocol
    (`forward`, `train()`/`eval()`, `state_dict`) applies as is."""

    def collect_params(self, select=None):
        """`ParameterDict` of structural parameter names → parameters,
        for the names matching the regular expression `select` if
        given."""
        pattern = re.compile(select) if select is not None else None
        ret = ParameterDict()
        ret.update({name: p for name, p in self.named_parameters()
                    if pattern is None or pattern.match(name)})
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter on `ctx` (default `cuda:0`), with
        `init` as the default initializer (ref: Block.initialize)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def zero_grad(self):
        """Zero every parameter's gradient (ref: Block.zero_grad)."""
        self.collect_params().zero_grad()

    def save_parameters(self, filename, deduplicate=False):
        """Save the materialised parameters, keyed by structural name, in
        the JAX package's file format (`ndarray.save`)."""
        from .. import ndarray as nd
        nd.save(filename, {k: v for k, v in self.collect_params().items()
                           if not is_deferred(v)})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Load a `save_parameters` file (the port's or the JAX
        package's).  Keys may carry the reference's `arg:`/`aux:`
        prefixes.  Each tensor is copied into its parameter in the
        parameter's dtype; a parameter without data takes the file's
        shape and is allocated on `ctx`, else on its `initialize` device,
        else on `cuda:0`.  A materialised parameter missing from the
        file raises unless `allow_missing`, a name the block lacks unless
        `ignore_extra`; nothing is written before these checks.
        `cast_dtype` and `dtype_source` are accepted and, as in the JAX
        package, change nothing."""
        from .. import ndarray as nd
        loaded = nd.load(filename, ctx="cpu")
        loaded = {(k.split(":", 1)[1] if k.startswith(("arg:", "aux:"))
                   else k): v for k, v in loaded.items()}
        params = self.collect_params()
        if not allow_missing:
            for name, p in params.items():
                if name not in loaded and not is_deferred(p):
                    raise MXNetError("parameter %s missing in file" % name)
        if not ignore_extra:
            for name in loaded:
                if name not in params:
                    raise MXNetError("parameter %s not in block" % name)
        for name, data in loaded.items():
            if name in params:
                params[name]._load_and_set(data, ctx)

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
        Each parameter keeps its identity; its data is replaced and its
        gradient dropped.  Returns the block."""
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
