"""Gluon utilities of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/utils.py): `split_data`, `split_and_load`,
`clip_global_norm`, `check_sha1` and `download`.
"""
from __future__ import annotations

import hashlib
import os
import urllib.request
import warnings

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device, tag_replica

__all__ = ["split_data", "split_and_load", "clip_global_norm",
           "check_sha1", "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """`num_slice` slices of `data` along `batch_axis`; the last takes
    the remainder unless `even_split` requires none."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            "data size %d cannot be evenly split into %d slices"
            % (size, num_slice))
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.narrow(batch_axis, begin, end - begin))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """`data` (a tensor, an NDArray or an array) split along
    `batch_axis` into one slice per context of `ctx_list`, each a tensor
    on its context's device (`split_data`); a CPU replica's slice
    carries its context (`context.tag_replica`), so that a block called
    on it runs on that context's parameter copies."""
    from ..ndarray.ndarray import NDArray
    if not isinstance(ctx_list, (list, tuple)):
        ctx_list = [ctx_list]
    if isinstance(data, NDArray):
        data = data._data
    if not isinstance(data, torch.Tensor):
        data = torch.as_tensor(np.asarray(data))
    if len(ctx_list) == 1:
        return [data.to(resolve_device(ctx_list[0]))]
    out = []
    for piece, ctx in zip(split_data(data, len(ctx_list), batch_axis,
                                     even_split), ctx_list):
        dev = resolve_device(ctx)
        out.append(tag_replica(piece.to(dev, copy=True), dev))
    return out


@torch.no_grad()
def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale `arrays` in place so that their joint 2-norm is at most
    `max_norm`; returns the norm before scaling (a host float, so it
    reads the device)."""
    if not arrays:
        raise MXNetError("arrays must be non-empty")
    total = torch.sqrt(sum(torch.sum(torch.square(a.float()))
                           for a in arrays))
    total_f = float(total)
    if check_isfinite and not np.isfinite(total_f):
        warnings.warn("nan or inf found in gradients")
        return total_f
    scale = max_norm / (total_f + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a.mul_(scale)
    return total_f


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 is `sha1_hash`."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1 << 20)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """Fetch `url` to a file and return its path, as the JAX package's
    `download` does: the file is `path` (or, for a directory or None,
    the URL's last part inside it, or in "."); an existing file is kept
    unless `overwrite`, or unless `sha1_hash` is given and does not match.
    The fetch is `urllib.request.urlretrieve`, once (`retries` and
    `verify_ssl` are taken and, as there, change nothing); a failure
    raises an MXNetError that names the URL and the path to place the
    file at by hand."""
    fname = path if path and not os.path.isdir(path) else \
        os.path.join(path or ".", url.split("/")[-1])
    if os.path.exists(fname) and not overwrite and \
            (not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    try:
        urllib.request.urlretrieve(url, fname)
    except Exception as e:
        raise MXNetError(
            "download of %s failed (%s) — this environment has no egress; "
            "place the file at %s manually" % (url, e, fname))
    return fname
