"""Base utilities of the PyTorch port: the framework's error type, the
dtype names the port accepts and the start of a distributed job
(counterpart of incubator_mxnet_tpu/base.py)."""
from __future__ import annotations

import os

import torch

__all__ = ["MXNetError", "torch_dtype", "nd_dtype", "ensure_distributed"]


def ensure_distributed(backend=None):
    """Join the `torch.distributed` process group that the reference's
    DMLC_* environment describes (DMLC_NUM_WORKER, DMLC_WORKER_ID or
    DMLC_RANK, DMLC_PS_ROOT_URI, DMLC_PS_ROOT_PORT), as the JAX package's
    `ensure_jax_distributed` joins jax.distributed.  Worker 0 hosts the
    rendezvous store, the role the reference's scheduler had; a process
    whose DMLC_ROLE is not "worker" (a server or scheduler) returns
    without joining, and so does a job of one worker.  `backend` is
    torch's backend string; by default "cpu:gloo,cuda:nccl" where a CUDA
    device is present (each collective takes the backend of its
    tensors' device: NCCL for card tensors, gloo for host ones), else
    "gloo".  With NCCL each rank takes card `rank % device_count`.
    Returns whether the process is in a group."""
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    nworkers = int(os.environ.get("DMLC_NUM_WORKER", "1"))
    if nworkers <= 1 or os.environ.get("DMLC_ROLE", "worker") != "worker":
        return False
    rank = int(os.environ.get("DMLC_WORKER_ID",
                              os.environ.get("DMLC_RANK", "0")))
    uri = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
    port = os.environ.get("DMLC_PS_ROOT_PORT", "9000")
    if backend is None:
        backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() \
            else "gloo"
    if "nccl" in backend:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method="tcp://%s:%s" % (uri, port),
                            world_size=nworkers, rank=rank)
    return True


class MXNetError(RuntimeError):
    """Framework error type (ref: python/mxnet/base.py MXNetError)."""


_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "int32": torch.int32,
           "int64": torch.int64}


def torch_dtype(dtype):
    """A torch dtype from a torch dtype or one of the JAX package's names."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError("unsupported dtype %r (one of %s)"
                         % (dtype, ", ".join(_DTYPES))) from None


#: every dtype name `mx.nd` takes -> its torch dtype
_ND_DTYPES = {"float32": torch.float32, "float64": torch.float64,
              "float16": torch.float16, "bfloat16": torch.bfloat16,
              "uint8": torch.uint8, "int8": torch.int8,
              "int16": torch.int16, "int32": torch.int32,
              "int64": torch.int64, "bool": torch.bool,
              "uint16": torch.uint16, "uint32": torch.uint32,
              "uint64": torch.uint64}
#: the JAX package runs with 64-bit types off: a 64-bit dtype asked for
#: is its 32-bit sibling
_X64_OFF = {torch.float64: torch.float32, torch.int64: torch.int32,
            torch.uint64: torch.uint32}


def nd_dtype(dtype):
    """The torch dtype `mx.nd` gives for `dtype` (a name, a numpy dtype or
    type, a Python type or a torch dtype), 64-bit types narrowed to 32
    bits as the JAX package's arrays are."""
    if dtype is None:
        return None
    if not isinstance(dtype, torch.dtype):
        if dtype is float:
            dtype = "float32"
        elif dtype is int:
            dtype = "int32"
        elif dtype is bool:
            dtype = "bool"
        name = getattr(dtype, "__name__", None) if isinstance(dtype, type) \
            else None
        name = name or getattr(dtype, "name", None) or str(dtype)
        try:
            dtype = _ND_DTYPES[name.replace("torch.", "")]
        except KeyError:
            raise TypeError("unknown dtype %r" % (dtype,)) from None
    return _X64_OFF.get(dtype, dtype)
