"""Device memory introspection of the PyTorch port (the part of
incubator_mxnet_tpu/storage.py that the serving tier reads).

`memory_info(device)` is the card's (bytes in use, bytes total) from
`torch.cuda.mem_get_info`; `memory_events()` samples each card's
allocator statistics (`torch.cuda.memory_stats`) onto `monitor.events`.
A CPU device has no allocator statistics: `memory_info` raises for it
and `memory_events` reports nothing for it.  Neither ever invents a
number.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["memory_info", "memory_events", "device_key"]


def device_key(device) -> str:
    """Canonical ``type:index`` key of a device (``cuda:0``, ``cpu:0``)."""
    d = torch.device(device) if not isinstance(device, torch.device) \
        else device
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return "%s:%d" % (d.type, d.index or 0)


def _cuda(device):
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    elif isinstance(device, int):
        device = torch.device("cuda", device)
    else:
        device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise MXNetError("memory_info: %s has no allocator statistics "
                         "(only a CUDA card reports them)" % device)
    return device


def memory_info(device=None):
    """(bytes in use on the card, the card's total bytes) — the in-use
    figure counts every process and context on the card, as the card
    reports it (ref: mx.context.gpu_memory_info).  Raises `MXNetError`
    for a device without allocator statistics."""
    device = _cuda(device)
    free, total = torch.cuda.mem_get_info(device)
    return int(total - free), int(total)


def memory_events(devices=None, counters=None):
    """Sample each card's allocator onto `monitor.events` as the
    ``mem.bytes_in_use`` / ``mem.peak_bytes`` series and return one dict
    per card: {device, bytes_in_use, peak_bytes, bytes_limit} from
    `torch.cuda.memory_stats` (allocated bytes, current and peak, this
    process's) and `mem_get_info` (the card's total).  CPU devices, or a
    host without CUDA, contribute nothing."""
    if counters is None:
        from .monitor import events as counters
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())] \
            if torch.cuda.is_available() else []
    out = []
    for d in devices:
        d = torch.device(d) if not isinstance(d, torch.device) else d
        if d.type != "cuda" or not torch.cuda.is_available():
            continue
        stats = torch.cuda.memory_stats(d)
        used = int(stats.get("allocated_bytes.all.current", 0))
        peak = int(stats.get("allocated_bytes.all.peak", used))
        _, total = torch.cuda.mem_get_info(d)
        counters.observe("mem.bytes_in_use", used)
        counters.observe("mem.peak_bytes", max(peak, used))
        out.append({"device": device_key(d), "bytes_in_use": used,
                    "peak_bytes": max(peak, used),
                    "bytes_limit": int(total)})
    return out
