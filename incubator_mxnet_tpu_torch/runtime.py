"""Runtime feature introspection of the PyTorch port (counterpart of
incubator_mxnet_tpu/runtime.py; ref: python/mxnet/runtime.py,
`mx.runtime.Features()`).

The features are read from this process: CUDA (`torch.cuda.is_available`),
CUDNN, NCCL, the port's CUDA kernels (KERNELS: built, or buildable: an
`nvcc` found and a card of capability 9.0, the kernels' `sm_90a`), BF16,
DIST_KVSTORE (torch.distributed), MULTIHOST (a process group of more
than one rank), OPENCV, PIL.  The JAX package's names that have no
meaning here (TPU, XLA, PALLAS, MKLDNN) report False.
"""
from __future__ import annotations

from collections import namedtuple

Feature = namedtuple("Feature", ["name", "enabled"])

__all__ = ["Features", "feature_list"]


def feature_list():
    import torch
    feats = []

    def add(name, enabled):
        feats.append(Feature(name, bool(enabled)))

    cuda = torch.cuda.is_available()
    add("TPU", False)
    add("CPU", True)
    add("CUDA", cuda)
    add("CUDNN", cuda and torch.backends.cudnn.is_available())
    add("NCCL", cuda and _has_nccl())
    add("KERNELS", cuda and _kernels_usable())
    add("MKLDNN", False)
    add("XLA", False)
    add("PALLAS", False)
    add("BF16", True)
    add("INT64_TENSOR_SIZE", True)
    add("DIST_KVSTORE", _distributed())
    add("SIGNAL_HANDLER", False)
    add("PROFILER", True)
    add("OPENCV", _has_module("cv2"))
    add("PIL", _has_module("PIL"))
    add("MULTIHOST", _world_size() > 1)
    return feats


def _has_nccl():
    import torch
    try:
        import torch.distributed as dist
        return dist.is_available() and dist.is_nccl_available() and \
            bool(torch.cuda.nccl.version())
    except Exception:       # noqa: BLE001 — a build without NCCL
        return False


def _kernels_usable():
    """The port's kernels are built, or can be: a card of capability 9.0
    and an `nvcc` to build them."""
    import torch
    from .ops import _kernels
    if torch.cuda.get_device_capability(0) != (9, 0):
        return False
    if all(_kernels._lib_path(n)[1].exists() for n in _kernels.SOURCES):
        return True
    try:
        _kernels._nvcc()
        return True
    except Exception:       # noqa: BLE001 — no nvcc on this host
        return False


def _distributed():
    import torch.distributed as dist
    return dist.is_available()


def _world_size():
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def _has_module(name):
    import importlib.util
    return importlib.util.find_spec(name) is not None


class Features(dict):
    """ref: mx.runtime.Features — dict-like with is_enabled."""

    def __init__(self):
        super().__init__([(f.name, f) for f in feature_list()])

    def is_enabled(self, name):
        return self[name].enabled

    def __repr__(self):
        return "[%s]" % ", ".join(
            "✔ %s" % n if f.enabled else "✖ %s" % n
            for n, f in self.items())
