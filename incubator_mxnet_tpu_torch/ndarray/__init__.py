"""`mx.nd` of the PyTorch port: the JAX package's parameter file format
(counterpart of `save`/`load` in incubator_mxnet_tpu/ndarray/__init__.py).
The `NDArray` class itself is not yet ported; files hold torch tensors.

Layout: magic 0x112 (u64), version 1 (u64), the length of a JSON header
(u64), the header `{"names", "dtypes", "shapes"}` (numpy dtype names),
then each tensor's raw little-endian bytes in order.  bfloat16 travels
as its raw 2-byte words, read back through `np.uint16` and
`Tensor.view(torch.bfloat16)`, so no numpy bfloat16 type is needed.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device

__all__ = ["save", "load"]

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
    """Save a tensor, a list of tensors or a {name: tensor} dict."""
    if isinstance(data, torch.Tensor):
        names, arrays = [""], [data]
    elif isinstance(data, dict):
        names, arrays = list(data.keys()), list(data.values())
    else:
        names, arrays = [""] * len(data), list(data)
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
    """The tensors of a file `save` wrote (or the JAX package's
    `nd.save`), on `ctx` (default `cuda:0`): a dict if they are named,
    else a list."""
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
