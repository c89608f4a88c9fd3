"""Devices of the PyTorch port (counterpart of incubator_mxnet_tpu/context.py).

`cpu()` and `gpu(i)` return `torch.device`s, which stand in for the JAX
package's `Context` wherever an entry point takes `ctx=` or `device=`
(`initialize(ctx=mx.gpu(0))`, `load_parameters(..., ctx=...)`,
`split_and_load`).  The default device is `cuda:0`: with no CUDA device
present, `gpu()`, `current_device()` (alias `current_context()`) and
every entry point that defaults to them raise instead of carrying on
on the CPU.  A caller that wants the CPU says so with `device="cpu"`.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "current_device", "current_context", "num_gpus",
           "resolve_device"]


def cpu(device_id: int = 0) -> torch.device:
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    """`cuda:<device_id>`; raises when that CUDA device does not exist."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly")
    n = torch.cuda.device_count()
    if not 0 <= device_id < n:
        raise MXNetError("cuda:%d does not exist (%d CUDA device(s))"
                         % (device_id, n))
    return torch.device("cuda", device_id)


def current_device() -> torch.device:
    """The default device of every entry point: `cuda:0`."""
    return gpu(0)


current_context = current_device


def num_gpus() -> int:
    """The number of CUDA devices (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def resolve_device(device=None) -> torch.device:
    """`device` as a `torch.device`; None means `current_device()`.  A
    CUDA device is checked to exist."""
    if device is None:
        return current_device()
    dev = torch.device(device)
    if dev.type == "cuda":
        return gpu(0 if dev.index is None else dev.index)
    return dev

