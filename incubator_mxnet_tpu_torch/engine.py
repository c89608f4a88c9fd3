"""The dispatch layer ("engine") of the PyTorch port (counterpart of
incubator_mxnet_tpu/engine.py).

Torch's CUDA streams order each device's work as the reference's
threaded engine ordered each variable's, so there is no scheduler here
either.  What the framework keeps:

- naive mode (`MXNET_ENGINE_TYPE=NaiveEngine`, `set_naive_mode`): each
  `invoke` of the op registry and each replay of a hybridized block's
  captured program synchronizes its device before it returns, so that
  an asynchronous fault shows at the op that caused it;
- dispatch listeners (`add_dispatch_listener(fn)`): `fn(name, ctx,
  seconds)` after each `invoke` (the op's name, its device, host
  seconds) and each replayed program (the block's name + "_cachedop",
  or "_cachedop_backward"), as the JAX package calls them around its
  dispatches.  Without a listener nothing is timed;
- `wait_all()`, every device's queued work finished (`nd.waitall`);
- `bulk(size)` / `set_bulk_size`, recorded and changing nothing, as in
  the JAX package.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, List

import torch

from . import config as _cfg

__all__ = ["naive_mode", "set_naive_mode", "wait_all",
           "add_dispatch_listener", "remove_dispatch_listener",
           "has_listeners", "bulk", "set_bulk_size"]

_NAIVE = _cfg.get("MXNET_ENGINE_TYPE") == "NaiveEngine"

#: callables (name, ctx, elapsed seconds)
_LISTENERS: List[Callable] = []


def naive_mode() -> bool:
    return _NAIVE


def set_naive_mode(flag: bool) -> bool:
    """Turn naive mode on or off; returns the previous setting."""
    global _NAIVE
    prev = _NAIVE
    _NAIVE = bool(flag)
    return prev


def add_dispatch_listener(fn: Callable):
    _LISTENERS.append(fn)


def remove_dispatch_listener(fn: Callable):
    if fn in _LISTENERS:
        _LISTENERS.remove(fn)


def has_listeners() -> bool:
    return bool(_LISTENERS)


def _sync(device):
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dispatched(name, device, call):
    """`call()` as one dispatch named `name` on `device`: timed for the
    listeners, and in naive mode followed by a device synchronize.  The
    callers test `_LISTENERS or _NAIVE` first, so that a dispatch that
    nobody watches costs nothing here."""
    t0 = time.perf_counter()
    out = call()
    if _NAIVE:
        _sync(device)
    dt = time.perf_counter() - t0
    for fn in list(_LISTENERS):
        fn(name, device, dt)
    return out


def replay(program, name, device):
    """`program.replay()` (a captured program of graph_capture) as a
    dispatch (`dispatched`)."""
    if not (_LISTENERS or _NAIVE):
        program.replay()
        return
    dispatched(name, device, program.replay)


def wait_all():
    """Wait for the work queued on every card of this process (ref:
    Engine::WaitForAll); nothing to wait for on the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


_BULK_SIZE = int(_cfg.get("MXNET_EXEC_BULK_EXEC_MAX_NODE_TRAIN"))


def set_bulk_size(size: int) -> int:
    """Record `size`; returns the previous one."""
    global _BULK_SIZE
    prev, _BULK_SIZE = _BULK_SIZE, int(size)
    return prev


@contextlib.contextmanager
def bulk(size: int):
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)
