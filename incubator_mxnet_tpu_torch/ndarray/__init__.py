"""`mx.nd` of the PyTorch port (counterpart of
incubator_mxnet_tpu/ndarray/__init__.py): `NDArray`, one generated
function per registered operator (as the JAX package and the reference's
register.py generate them), the creation helpers, `waitall`, the
`nd.random`, `nd.contrib` and `nd.sparse` (row_sparse and csr storage)
namespaces, DLPack exchange and the JAX
package's parameter file format.

Every generated function dispatches through `invoke`, so `nd.dot(a, b)`,
`a.dot(b)` and `a @ b` run the same registry entry.  `nd.contrib.
flash_attention` is `_contrib_flash_attention`, the three CUDA kernels
on the card.

File layout (`save`/`load`): magic 0x112 (u64), version 1 (u64), the
length of a JSON header (u64), the header `{"names", "dtypes",
"shapes"}` (numpy dtype names), then each tensor's raw little-endian
bytes in order.  bfloat16 travels as its raw 2-byte words, read back
through `np.uint16` and `Tensor.view(torch.bfloat16)`, so no numpy
bfloat16 type is needed.  `save` takes NDArrays or tensors; `load`
returns NDArrays, as the JAX package does (`_load_tensors` is the
tensors' form, which the parameter loaders read).
"""
from __future__ import annotations

import functools as _functools
import json
import struct
import sys as _sys
import types as _types

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..ops import registry as _registry
# every module that registers operators, before the stubs are generated
from ..ops import tensor as _tensor, nn as _nn, optimizer as _optimizer  # noqa: F401
from ..ops import random as _random_ops, attention as _attention  # noqa: F401
from ..ops import contrib as _contrib_ops, rcnn as _rcnn  # noqa: F401
from ..ops import rnn as _rnn_ops  # noqa: F401
from .ndarray import NDArray, invoke, apply_fn, array, unwrap, _wrap

__all__ = ["NDArray", "array", "invoke", "apply_fn", "zeros", "ones",
           "full", "empty", "arange", "linspace", "eye", "save", "load",
           "waitall", "concat", "stack", "random", "contrib", "sparse",
           "to_dlpack_for_read", "to_dlpack_for_write", "from_dlpack"]

_MAGIC = 0x112
# numpy dtype name <-> torch dtype, and the numpy type of the raw words
_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int8": torch.int8, "uint8": torch.uint8, "int32": torch.int32,
           "int64": torch.int64, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}
_RAW = {torch.bfloat16: (np.uint16, torch.int16)}


def _to_bytes(t):
    t = t.detach().cpu().contiguous()
    if t.dtype in _RAW:
        t = t.view(_RAW[t.dtype][1])
    return t.numpy().tobytes()


def save(fname, data):
    """Save a tensor or NDArray, a list of them or a {name: array}
    dict."""
    if isinstance(data, (torch.Tensor, NDArray)):
        names, arrays = [""], [data]
    elif isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
    else:
        names, arrays = [""] * len(data), list(data)
    arrays = [unwrap(a) for a in arrays]
    for a in arrays:
        if a.dtype not in _NAMES:
            raise MXNetError("cannot save dtype %s" % a.dtype)
    header = {"names": names,
              "dtypes": [_NAMES[a.dtype] for a in arrays],
              "shapes": [list(a.shape) for a in arrays]}
    hb = json.dumps(header).encode()
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQQ", _MAGIC, 1, len(hb)))
        f.write(hb)
        for a in arrays:
            f.write(_to_bytes(a))


def load(fname, ctx=None):
    """The arrays of a file `save` wrote (or the JAX package's
    `nd.save`) as NDArrays on `ctx` (default `cuda:0`): a dict if they
    are named, else a list."""
    loaded = _load_tensors(fname, ctx)
    if isinstance(loaded, dict):
        return {k: _wrap(v) for k, v in loaded.items()}
    return [_wrap(v) for v in loaded]


def _load_tensors(fname, ctx=None):
    """`load`, with torch tensors in place of NDArrays."""
    dev = resolve_device(ctx)
    with open(fname, "rb") as f:
        magic, _version, hlen = struct.unpack("<QQQ", f.read(24))
        if magic != _MAGIC:
            raise MXNetError("invalid NDArray file %r" % fname)
        header = json.loads(f.read(hlen).decode())
        arrays = []
        for dt, shp in zip(header["dtypes"], header["shapes"]):
            if dt not in _DTYPES:
                raise MXNetError("%r holds dtype %s, which the port does "
                                 "not read" % (fname, dt))
            tdt = _DTYPES[dt]
            raw = _RAW.get(tdt, (None, None))[0]
            npdt = np.dtype(raw or dt).newbyteorder("<")
            n = int(np.prod(shp)) if shp else 1
            buf = f.read(n * npdt.itemsize)
            if len(buf) != n * npdt.itemsize:
                raise MXNetError("%r is truncated" % fname)
            a = torch.from_numpy(np.frombuffer(buf, dtype=npdt).copy())
            if raw is not None:
                a = a.view(tdt)
            arrays.append(a.reshape(shp).to(dev))
    names = header["names"]
    if any(names):
        return dict(zip(names, arrays))
    return arrays


# ---------------------------------------------------------------------------
# DLPack exchange (ref: python/mxnet/dlpack.py)
# ---------------------------------------------------------------------------

def to_dlpack_for_read(data):
    """The array's tensor, for DLPack consumers (it carries
    `__dlpack__`); the producing stream is waited for first."""
    data.wait_to_read()
    return data._data.detach()


def to_dlpack_for_write(data):
    """As `to_dlpack_for_read`: a write through the export is seen by
    the tensor, not by an array rebound since."""
    return to_dlpack_for_read(data)


def from_dlpack(capsule):
    """An NDArray over a DLPack capsule or an object with `__dlpack__`,
    sharing its memory."""
    return _wrap(torch.from_dlpack(capsule))


# ---------------------------------------------------------------------------
# generated op stubs (ref: _make_ndarray_function in register.py)
# ---------------------------------------------------------------------------

def _make_stub(opname):
    od = _registry.get(opname)

    @_functools.wraps(od.fn)
    def stub(*args, **kwargs):
        return invoke(opname, *args, **kwargs)
    stub.__name__ = opname
    stub.__qualname__ = opname
    stub.__doc__ = od.doc
    return stub


_this = _sys.modules[__name__]
for _opname in _registry.list_ops():
    if not hasattr(_this, _opname):
        setattr(_this, _opname, _make_stub(_opname))


# ---------------------------------------------------------------------------
# creation helpers (ctx defaults to cuda:0)
# ---------------------------------------------------------------------------

def _tuple(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32"):
    return invoke("_zeros", shape=_tuple(shape), dtype=dtype, ctx=ctx)


def ones(shape, ctx=None, dtype="float32"):
    return invoke("_ones", shape=_tuple(shape), dtype=dtype, ctx=ctx)


def full(shape, val, ctx=None, dtype="float32"):
    return invoke("_full", shape=_tuple(shape), value=val, dtype=dtype,
                  ctx=ctx)


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    return invoke("_arange", start=start, stop=stop, step=step,
                  repeat=repeat, dtype=dtype, ctx=ctx)


def linspace(start, stop, num, endpoint=True, ctx=None, dtype="float32"):
    return invoke("_linspace", start=start, stop=stop, num=num,
                  endpoint=endpoint, dtype=dtype, ctx=ctx)


def eye(N, M=0, k=0, ctx=None, dtype="float32"):
    return invoke("_eye", N=N, M=M, k=k, dtype=dtype, ctx=ctx)


def waitall():
    """Wait for all work queued on the card (ref: nd.waitall)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def uniform(low=0.0, high=1.0, shape=(), ctx=None, dtype="float32", **kw):
    return invoke("_random_uniform", low=low, high=high, shape=_tuple(shape),
                  dtype=dtype, ctx=ctx, **kw)


def normal(loc=0.0, scale=1.0, shape=(), ctx=None, dtype="float32", **kw):
    return invoke("_random_normal", loc=loc, scale=scale,
                  shape=_tuple(shape), dtype=dtype, ctx=ctx, **kw)


# ---------------------------------------------------------------------------
# nd.random namespace (ref: python/mxnet/ndarray/random.py)
# ---------------------------------------------------------------------------

random = _types.ModuleType(__name__ + ".random")


def _rand_stub(public, internal, sample_internal=None):
    def fn(*args, **kwargs):
        arr_args = [a for a in args if isinstance(a, NDArray)] \
            or [v for v in kwargs.values() if isinstance(v, NDArray)]
        if sample_internal is not None and arr_args:
            return invoke(sample_internal, *args, **kwargs)
        if "shape" in kwargs:
            kwargs["shape"] = _tuple(kwargs["shape"])
        return invoke(internal, *args, **kwargs)
    fn.__name__ = public
    return fn


random.uniform = _rand_stub("uniform", "_random_uniform", "_sample_uniform")
random.normal = _rand_stub("normal", "_random_normal", "_sample_normal")
random.gamma = _rand_stub("gamma", "_random_gamma", "_sample_gamma")
random.exponential = _rand_stub("exponential", "_random_exponential")
random.poisson = _rand_stub("poisson", "_random_poisson")
random.negative_binomial = _rand_stub("negative_binomial",
                                      "_random_negative_binomial")
random.generalized_negative_binomial = _rand_stub(
    "generalized_negative_binomial",
    "_random_generalized_negative_binomial")
random.randint = _rand_stub("randint", "_random_randint")
random.multinomial = _rand_stub("multinomial", "_sample_multinomial")
random.shuffle = _rand_stub("shuffle", "_shuffle")
_sys.modules[random.__name__] = random

# nd.contrib namespace (ref: python/mxnet/ndarray/contrib.py): the contrib
# ops, registered flat, under the JAX package's list, and the fused
# attention core
contrib = _types.ModuleType(__name__ + ".contrib")
for _opname in ["box_iou", "box_nms", "box_encode", "box_decode",
                "bipartite_matching", "MultiBoxPrior", "MultiBoxTarget",
                "MultiBoxDetection", "ROIAlign", "BilinearResize2D",
                "AdaptiveAvgPooling2D", "count_sketch", "index_copy",
                "getnnz", "boolean_mask", "arange_like",
                "interleaved_matmul_selfatt_qk",
                "interleaved_matmul_selfatt_valatt"]:
    setattr(contrib, _opname, getattr(_this, _opname))
contrib.flash_attention = getattr(_this, "_contrib_flash_attention")
# upstream's contrib names of SyncBatchNorm and the CTC loss
contrib.SyncBatchNorm = getattr(_this, "_contrib_SyncBatchNorm")
contrib.CTCLoss = contrib.ctc_loss = getattr(_this, "CTCLoss")
_sys.modules[contrib.__name__] = contrib

# nd.sparse namespace: row_sparse and csr storage, and Embedding's sparse
# gradient path in the registry
from . import sparse  # noqa: E402,F401
