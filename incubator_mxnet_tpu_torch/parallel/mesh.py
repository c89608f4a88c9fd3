"""Device meshes of the PyTorch port (counterpart of
incubator_mxnet_tpu/parallel/mesh.py).

The JAX package takes `Mesh`, `NamedSharding` and `PartitionSpec` from
jax.sharding; the port has its own small classes with the same reading:
a `Mesh` is a grid of replica contexts with named axes, a `P` names the
mesh axis each tensor dimension is split along (None: not split), and a
`NamedSharding(mesh, spec)` pairs them.  Nothing places itself: the
sharded trainer and `io.DeviceFeed(sharding=)` read these and put each
replica's rows or shards on its device.

The devices of a mesh are replica contexts: `cuda:i` on the card,
`cpu(i)` on the CPU (`context.cpu`: distinct contexts whose tensors all
live on `cpu`).  `make_mesh()` takes every card, and raises without one
unless the caller is inside `with cpu():`; a CPU mesh of n replicas is
`make_mesh(devices=[cpu(i) for i in range(n)])`.  `Shards` is a list of per-replica tensors that a feed or
a caller has placed already, which the trainer takes as it is.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as _np
import torch

__all__ = ["make_mesh", "Mesh", "NamedSharding", "P", "replicated",
           "batch_sharded", "default_dp_mesh", "replica_contexts",
           "mesh_devices", "surviving_mesh", "Shards"]


class P(tuple):
    """A partition spec: per tensor dimension, the mesh axis it is split
    along, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)


class Mesh:
    """Replica contexts laid out in a grid with named axes."""

    def __init__(self, devices, axis_names):
        from ..context import _norm
        arr = _np.empty(_np.shape(devices), dtype=object)
        for idx, d in _np.ndenumerate(_np.asarray(devices, dtype=object)):
            arr[idx] = _norm(d)
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError("a %d-d mesh needs %d axis names, got %r"
                             % (arr.ndim, arr.ndim, self.axis_names))

    @property
    def shape(self):
        """{axis name: size}."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return "Mesh(%s, %s)" % (dict(self.shape), list(self.devices.flat))


class NamedSharding:
    """`spec` over `mesh`."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec if isinstance(spec, P) else P(*spec)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            other.mesh is self.mesh and other.spec == self.spec

    def __hash__(self):
        return hash((id(self.mesh), self.spec))

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


class Shards(list):
    """One tensor per replica of a mesh, in replica order, each on its
    replica's device: a batch placed already."""


def _default_devices():
    """Every card; without one, the device of an enclosing `with cpu():`
    (else `current_device()` raises)."""
    from ..context import current_device
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [current_device()]


def make_mesh(shape: Sequence[int] = None,
              axis_names: Sequence[str] = ("data",),
              devices=None) -> Mesh:
    """A mesh over `devices` (default: every card, `_default_devices`).

    make_mesh() is a 1-d "data" mesh over them all; make_mesh((4, 2),
    ("data", "model")) a 4 x 2 grid of the first eight."""
    devices = list(devices) if devices is not None else _default_devices()
    if shape is None:
        shape = (len(devices),)
    n = int(_np.prod(shape))
    if n > len(devices):
        raise ValueError("a mesh of shape %s needs %d devices, %d given"
                         % (tuple(shape), n, len(devices)))
    arr = _np.empty(len(devices[:n]), dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def default_dp_mesh() -> Mesh:
    return make_mesh()


def mesh_devices(mesh: Mesh):
    """The mesh's devices as a flat list, in replica order."""
    return list(mesh.devices.flat)


def surviving_mesh(devices, lost=(), axis_names=("data",)) -> Mesh:
    """A 1-d data mesh over `devices` less the replicas at the indices in
    `lost`, in their order (the same survivors always give the same
    mesh)."""
    lost = set(int(i) for i in lost)
    keep = [d for i, d in enumerate(devices) if i not in lost]
    if not keep:
        raise ValueError("no surviving devices (lost=%s of %d)"
                         % (sorted(lost), len(list(devices))))
    return make_mesh((len(keep),), axis_names, devices=keep)


def replica_contexts(mesh: Optional[Mesh] = None):
    """The mesh's devices (default: `make_mesh()`'s) as the contexts a
    `serving.InferenceEngine` round-robins across."""
    return mesh_devices(mesh if mesh is not None else make_mesh())


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharded(mesh: Mesh, axis: str = "data",
                  batch_dim: int = 0) -> NamedSharding:
    spec = [None] * (batch_dim + 1)
    spec[batch_dim] = axis
    return NamedSharding(mesh, P(*spec))
