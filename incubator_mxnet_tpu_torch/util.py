"""Misc utilities of the PyTorch port (counterpart of
incubator_mxnet_tpu/util.py; ref: python/mxnet/util.py, the np-shape and
np-array flags).  The port has no `mx.np`: `set_np` keeps its flag, as
the JAX one does, and `use_np` only sets it around the call."""
from __future__ import annotations

import functools
import inspect
import os

__all__ = ["is_np_array", "set_np", "reset_np", "use_np", "makedirs"]

_NP_ARRAY = False


def is_np_array() -> bool:
    return _NP_ARRAY


def set_np(shape=True, array=True):
    global _NP_ARRAY
    _NP_ARRAY = bool(array)


def reset_np():
    global _NP_ARRAY
    _NP_ARRAY = False


def use_np(func):
    """Decorator: run `func` (or every method of a class, a Gluon block's
    inherited `__call__` included) with the np array flag on."""
    if inspect.isclass(func):
        for name, m in list(vars(func).items()):
            if name.startswith("__"):
                continue
            if isinstance(m, staticmethod):
                setattr(func, name, staticmethod(use_np(m.__func__)))
            elif isinstance(m, classmethod):
                setattr(func, name, classmethod(use_np(m.__func__)))
            elif callable(m):
                setattr(func, name, use_np(m))
        call = getattr(func, "__call__", None)
        if call is not None and "__call__" not in vars(func):
            setattr(func, "__call__", use_np(call))
        return func

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        global _NP_ARRAY
        prev = _NP_ARRAY
        _NP_ARRAY = True
        try:
            return func(*args, **kwargs)
        finally:
            _NP_ARRAY = prev
    return wrapper


def makedirs(d):
    os.makedirs(d, exist_ok=True)
