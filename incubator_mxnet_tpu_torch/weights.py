"""Carry weights from the JAX package into the PyTorch port.

`load_reference_params(module, params, device)` takes the arrays of a
JAX block's `_collect_params_with_prefix()` as numpy, keyed by the
same structural names the port's `collect_params()` uses, and copies
them into the port's module.  Names must match one to one and shapes
exactly; there is no fuzzy matching.  BatchNorm's running statistics
are parameters without gradient on both sides (`running_mean`,
`running_var`), so they are carried like any other.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device
from .gluon.parameter import Parameter, is_deferred

__all__ = ["load_reference_params"]


def load_reference_params(module, params, device=None):
    """Copy `params` ({structural name: numpy array}) into `module`'s
    parameters, after moving the module to `device` when one is given.
    A parameter without data (a deferred width, or a block built without
    a device) takes its shape from the array and is allocated on
    `device`, else on its `initialize` device, else on `cuda:0`.
    Raises MXNetError on a missing or extra name or a shape mismatch,
    before any parameter is written.  Returns the module."""
    if device is not None:
        device = resolve_device(device)
        module.to(device)
    own = module.collect_params()
    missing = sorted(set(own) - set(params))
    extra = sorted(set(params) - set(own))
    if missing or extra:
        raise MXNetError("reference parameters do not match the module: "
                         "missing %s, extra %s" % (missing, extra))
    arrays = {}
    for name, p in own.items():
        arr = np.asarray(params[name])
        if not _fits(p, arr.shape):
            raise MXNetError("parameter %s: reference shape %s != module "
                             "shape %s" % (name, tuple(arr.shape),
                                           tuple(p.shape or ())))
        # through float32: numpy has no bfloat16, and every parameter of
        # the ported layers is floating point
        arrays[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    with torch.no_grad():
        for name, p in own.items():
            if isinstance(p, Parameter):
                p._load_and_set(arrays[name], device)
            else:
                p.copy_(arrays[name])
    return module


def _fits(param, shape):
    """Whether an array of `shape` fits `param`: equal shapes, or for a
    parameter without data its known widths (a deferred one is 0)."""
    own = param.shape
    if not is_deferred(param):
        return tuple(own) == tuple(shape)
    return own is None or (len(own) == len(shape) and all(
        s in (0, a) for s, a in zip(own, shape)))
