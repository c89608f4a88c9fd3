"""Devices of the PyTorch port (counterpart of incubator_mxnet_tpu/context.py).

`cpu()` and `gpu(i)` return `torch.device`s, which stand in for the JAX
package's `Context` wherever an entry point takes `ctx=` or `device=`
(`initialize(ctx=mx.gpu(0))`, `load_parameters(..., ctx=...)`,
`split_and_load`).  The default device is the one of the innermost
`with cpu():` / `with gpu(i):` the calling thread is in, as the JAX
package's `with mx.cpu():` sets it, else `cuda:0`: with no CUDA device
present, `gpu()`, `current_device()` (alias `current_context()`) and
every entry point that defaults to them raise instead of carrying on
on the CPU.  A caller that wants the CPU says so with `device="cpu"` or
`with cpu():`.

Data-parallel replicas need contexts that stay apart.  On the card a
replica is its device, `cuda:i`.  On the CPU every tensor lives on
`cpu`, so `cpu(i)` for i > 0 is `torch.device("cpu", i)`: a distinct
context, on which tensors are still made on `cpu` (`cpu()` and `cpu(0)`
stay `torch.device("cpu")`).  `tag_replica(t, ctx)` marks a CPU tensor
with its replica's context and `replica_of(t)` reads it back (a tensor's
device where it carries no mark), which is how `split_and_load`'s
slices tell a block whose parameter copies to take.

A `torch.device` used as a context manager enters torch's own
`DeviceContext`, a function mode that also places torch's factory
functions called without `device=` on that device; `current_device()`
reads that mode back.
"""
from __future__ import annotations

import torch
from torch.utils._device import DeviceContext

from .base import MXNetError

__all__ = ["cpu", "gpu", "current_device", "current_context", "num_gpus",
           "resolve_device", "tag_replica", "replica_of"]


def cpu(device_id: int = 0) -> torch.device:
    """`cpu` for device 0, `cpu:<device_id>` (a replica's context whose
    tensors live on `cpu`) otherwise."""
    return torch.device("cpu") if not device_id else \
        torch.device("cpu", int(device_id))


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


def _entered_device():
    """The device of the innermost `with <torch.device>:` on this thread,
    or None.  torch keeps each as a `DeviceContext` on its (thread-local)
    torch-function mode stack, the innermost nearest the top; that stack
    and the class are private API (torch._C, torch.utils._device), so
    `tests/test_torch_context.py` and a card test hold this reading."""
    for i in range(torch._C._len_torch_function_stack() - 1, -1, -1):
        mode = torch._C._get_function_stack_at(i)
        if isinstance(mode, DeviceContext):
            return mode.device
    return None


def current_device() -> torch.device:
    """The default device of every entry point: that of the innermost
    `with cpu():` / `with gpu(i):` on this thread, else `cuda:0` (which
    raises without CUDA)."""
    dev = _entered_device()
    if dev is None:
        return gpu(0)
    if dev.type == "cuda":
        return gpu(0 if dev.index is None else dev.index)
    return dev


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


def _norm(ctx):
    """`ctx` as a device with `cpu:0` read as `cpu`."""
    dev = torch.device(ctx)
    return torch.device("cpu") if dev.type == "cpu" and not dev.index \
        else dev


def tag_replica(t, ctx):
    """Mark CPU tensor `t` as replica `ctx`'s (a context other than
    `cpu`); returns `t`."""
    ctx = _norm(ctx)
    if ctx.type == "cpu" and ctx.index:
        t._mx_ctx = ctx
    return t


def replica_of(t):
    """The replica context of tensor `t`: its mark, else its device."""
    return getattr(t, "_mx_ctx", None) or _norm(t.device)

