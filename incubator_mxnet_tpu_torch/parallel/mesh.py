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

`process_mesh()` is the mesh of a `torch.distributed` group: one
replica per rank, along one axis or laid out in a grid (`shape=`), of
which this process drives its own (`Mesh.in_process` False), with a
subgroup per slice of each axis (`axis_group`);
`parallel.spmd.shard_map` runs one body per rank over it.
`squeeze_stage_axis` strips the leading size-1 axis of a stacked tree's
per-replica slice inside a `shard_map` body; `mark_varying` is the
identity (the port has no replication types) and
stays so that bodies read as the JAX package's do.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as _np
import torch

__all__ = ["make_mesh", "Mesh", "NamedSharding", "P", "replicated",
           "batch_sharded", "default_dp_mesh", "replica_contexts",
           "mesh_devices", "surviving_mesh", "Shards", "process_mesh",
           "squeeze_stage_axis", "mark_varying", "axis_group"]


class P(tuple):
    """A partition spec: per tensor dimension, the mesh axis it is split
    along, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)


class Mesh:
    """Replica contexts laid out in a grid with named axes.
    `in_process` False: the replicas are the ranks of a process group
    (`process_mesh`)."""

    in_process = True

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


def process_mesh(axis_names=("data",), device=None, shape=None) -> Mesh:
    """A mesh over the ranks of the default `torch.distributed` group,
    this process being replica `get_rank()` on `device` (default
    `cuda:<rank % cards>`, which raises without a card unless inside
    `with cpu():`, where it is `cpu(rank)`); the other entries name the
    other ranks' devices of the same kind, `cuda:<r % cards>` or
    `cpu(r)`.  `shape` (default: one axis of every rank) lays the ranks
    out in row-major order, (2, 2) with ("data", "model") putting ranks
    0, 1 on data index 0.  Every rank must call it, in one order with
    its other group calls: over a mesh of several axes it creates one
    subgroup per slice of each axis (`axis_group`)."""
    import torch.distributed as dist
    from ..context import cpu, current_device, resolve_device
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group: start it "
                           "with base.ensure_distributed()")
    n, rank = dist.get_world_size(), dist.get_rank()
    shape = (n,) if shape is None else tuple(int(s) for s in shape)
    if int(_np.prod(shape)) != n:
        raise ValueError("a process mesh of shape %s needs %d ranks, the "
                         "group has %d" % (shape, int(_np.prod(shape)), n))
    mine = resolve_device(device) if device is not None else None
    on_card = (mine or current_device()).type == "cuda"

    def dev(r):
        if r == rank and mine is not None:
            return mine
        if on_card:
            return torch.device("cuda", r % torch.cuda.device_count())
        return cpu(r)
    mesh = make_mesh(shape, axis_names, devices=[dev(r) for r in range(n)])
    mesh.in_process = False
    mesh._axis_groups = {}
    ranks = _np.arange(n).reshape(shape)
    for a, name in enumerate(mesh.axis_names):
        lines = _np.moveaxis(ranks, a, -1).reshape(-1, shape[a])
        for line in lines:
            members = [int(r) for r in line]
            # one axis spanning the group is the default group
            group = None if len(shape) == 1 else dist.new_group(members)
            for r in members:
                mesh._axis_groups[(name, r)] = (group, members)
    return mesh


def axis_group(mesh: Mesh, name, rank):
    """(torch.distributed group, its global ranks in axis order) of
    `rank`'s slice along axis `name` of a `process_mesh`; the group is
    None (the default group) on a one-axis mesh."""
    try:
        return mesh._axis_groups[(name, int(rank))]
    except (AttributeError, KeyError):
        raise ValueError("no %r axis group for rank %s of %r (a "
                         "process_mesh has them)" % (name, rank, mesh))


def squeeze_stage_axis(tree):
    """Strip the leading size-1 axis that a P('<axis>')-sharded stacked
    tree carries inside a shard_map body (each replica sees its own
    slice)."""
    if isinstance(tree, dict):
        return {k: squeeze_stage_axis(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(squeeze_stage_axis(v) for v in tree)
    if getattr(tree, "ndim", 0) and tree.shape[0] == 1:
        return tree[0]
    return tree


def mark_varying(x, axis_name):
    """The identity: the JAX package tags a value as device-varying for
    shard_map's type system, which the port has not."""
    return x
