"""Operator registry of the PyTorch port (counterpart of
incubator_mxnet_tpu/ops/registry.py; ref: the nnvm op registry and the
Python stubs generated from it, python/mxnet/ndarray/register.py).

Every operator is a function over torch tensors,

    out = fn(*tensor_args, **params)

with the JAX package's metadata: the names of its tensor inputs, whether
it is differentiable, its outputs, whether it draws random numbers
(`_rng_key` in its signature, a `torch.Generator` here) or reads the
training flag (`_training`), and the positions of inputs that take no
gradient.  `mx.nd`'s generated stubs, `NDArray`'s methods and
`contrib.amp` all go through these entries.

`jit=True` composites run eagerly, as every other op does; the JAX
package compiles them to one XLA program, which has no counterpart here.
"""
from __future__ import annotations

import inspect
from typing import Callable, Dict, Optional, Sequence

__all__ = ["OpDef", "register", "get", "list_ops", "alias"]


class OpDef:
    """Metadata record for one operator."""

    __slots__ = ("name", "fn", "ndarray_inputs", "differentiable",
                 "num_outputs", "visible_outputs", "num_outputs_fn",
                 "doc", "needs_rng", "needs_training", "nograd_argnums",
                 "sparse_invoke")

    def __init__(self, name: str, fn: Callable, *,
                 ndarray_inputs: Optional[Sequence[str]] = None,
                 differentiable: bool = True,
                 num_outputs: int = 1,
                 visible_outputs: Optional[int] = None,
                 num_outputs_fn: Optional[Callable] = None,
                 needs_rng: bool = False,
                 nograd_argnums: Sequence[int] = (),
                 jit: bool = False):
        self.name = name
        self.fn = fn
        self.ndarray_inputs = tuple(ndarray_inputs) if ndarray_inputs else None
        self.differentiable = differentiable
        self.num_outputs = num_outputs
        self.visible_outputs = (num_outputs if visible_outputs is None
                                else visible_outputs)
        self.num_outputs_fn = num_outputs_fn
        try:
            params = inspect.signature(fn).parameters
        except (TypeError, ValueError):
            params = {}
        self.needs_rng = needs_rng or "_rng_key" in params
        self.needs_training = "_training" in params
        self.nograd_argnums = tuple(nograd_argnums)
        # the FComputeEx analogue: `sparse_invoke(args, kwargs)` on
        # NDArrays is offered each imperative call first and returns
        # NotImplemented to leave it to `fn` (ref: storage-type dispatch,
        # src/imperative/imperative_utils.h; `ndarray.sparse` sets
        # Embedding's)
        self.sparse_invoke = None
        self.doc = fn.__doc__

    def __repr__(self):
        return "OpDef(%s)" % self.name


_REGISTRY: Dict[str, OpDef] = {}


def register(name: Optional[str] = None, **meta):
    """Decorator: register an operator function over torch tensors."""
    def deco(fn):
        opname = name or fn.__name__
        if opname in _REGISTRY:
            raise ValueError("operator %r already registered" % opname)
        _REGISTRY[opname] = OpDef(opname, fn, **meta)
        return fn
    return deco


def alias(existing: str, *names: str):
    """Register extra names for an existing op (one shared `OpDef`)."""
    od = _REGISTRY[existing]
    for n in names:
        if n in _REGISTRY:
            raise ValueError("operator %r already registered" % n)
        _REGISTRY[n] = od


def get(name: str) -> OpDef:
    return _REGISTRY[name]


def list_ops():
    return sorted(_REGISTRY.keys())
