"""The replica group of the PyTorch port: the collectives that the JAX
package gets from XLA (psum, psum_scatter, all_gather inside its jitted
steps) on the replicas of a data-parallel mesh.

Two forms offer one interface (`size`, `local`, `rank_offset`,
`all_reduce`, `reduce_scatter`, `all_gather`, `broadcast` and
`lockstep_all_reduce`).  The list methods take one tensor per replica
that this process drives (`local`), in replica order, and return one
result per such replica, each on its replica's device:

* `ReplicaGroup(devices)`, the in-process form: one process drives every
  replica, as the JAX single controller does.  CPU replicas (and
  replicas that share a card) are summed in replica order with f32
  arithmetic, each result rounded once into the inputs' dtype.  Replicas
  on distinct cards go through `torch.cuda.nccl`.  A group of one does
  no work.
* `ProcessReplicaGroup(device)`, the process-group form: one replica
  per process over `torch.distributed` (`base.ensure_distributed`
  starts it from the DMLC_* environment).  Each collective takes the
  backend of its tensors' device: gloo for host tensors, NCCL for card
  tensors.  `reduce_scatter` is the backend's reduce-scatter, so a rank
  receives its shard's sums only.  Low-precision tensors are summed in
  f32 here too.

`lockstep_all_reduce(local_rank, tensor)` is the reduction in the middle
of a forward (BatchNorm's moments across replicas): in the in-process
form every replica's thread calls it at the same point
(`dispatch.DispatchPool.lockstep`) and each gets the sum; a replica that
fails breaks the group's barrier, so that the others raise instead of
waiting.  `replica_sync(group, local_rank)` makes the group the current
one of the calling thread, which `ops.nn.batch_norm` reads
(`current_sync()`).
"""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["ReplicaGroup", "ProcessReplicaGroup", "replica_sync",
           "current_sync"]

#: dtypes whose sums the group takes in f32
LOW_PRECISION = (torch.bfloat16, torch.float16)

_LOCAL = threading.local()


@contextlib.contextmanager
def replica_sync(group, local_rank):
    """Inside: BatchNorm's batch statistics on this thread span `group`'s
    replicas, this thread being replica `local_rank` of this process."""
    prev = getattr(_LOCAL, "sync", None)
    _LOCAL.sync = (group, int(local_rank))
    try:
        yield
    finally:
        _LOCAL.sync = prev


def current_sync():
    """(group, local rank) of the calling thread's `replica_sync`, or
    None."""
    return getattr(_LOCAL, "sync", None)


def _acc(t):
    return t.float() if t.dtype in LOW_PRECISION else t


def _ordered_sum(tensors, device):
    """The sum of `tensors` in order, on `device`, accumulated in f32 for
    low-precision inputs and rounded once into their dtype."""
    acc = _acc(tensors[0]).to(device, copy=True)
    for t in tensors[1:]:
        acc.add_(_acc(t).to(device))
    return acc.to(tensors[0].dtype)


class ReplicaGroup:
    """The in-process form (module doc) over replica contexts `devices`
    (`cpu`, `cpu(i)`, `cuda:i`)."""

    in_process = True
    rank_offset = 0

    def __init__(self, devices):
        from ..context import _norm
        self.local = [_norm(d) for d in devices]
        self.size = len(self.local)
        cards = [d for d in self.local if d.type == "cuda"]
        self._nccl = len(cards) == self.size > 1 and \
            len({d.index for d in cards}) == self.size
        self._slots = [None] * self.size
        self._barrier = threading.Barrier(self.size) if self.size > 1 \
            else None

    def _dev(self, r):
        d = self.local[r]
        return torch.device("cpu") if d.type == "cpu" else d

    def all_reduce(self, tensors):
        """The sum over replicas, one copy per replica."""
        if self.size == 1:
            return list(tensors)
        if self._nccl and tensors[0].dtype not in LOW_PRECISION:
            out = [t.contiguous().clone() for t in tensors]
            torch.cuda.nccl.all_reduce(out)
            return out
        total = _ordered_sum(tensors, self._dev(0))
        return [total if r == 0 else total.to(self._dev(r), copy=True)
                for r in range(self.size)]

    def reduce_scatter(self, tensors, dim=0):
        """Replica r's shard (along `dim`, 1/size of it) of the sum."""
        if self.size == 1:
            return list(tensors)
        span = tensors[0].shape[dim] // self.size
        if self._nccl and dim == 0 and \
                tensors[0].dtype not in LOW_PRECISION:
            outs = [torch.empty((span,) + tuple(t.shape[1:]), dtype=t.dtype,
                                device=t.device) for t in tensors]
            torch.cuda.nccl.reduce_scatter(
                [t.contiguous() for t in tensors], outs)
            return outs
        return [_ordered_sum([t.narrow(dim, r * span, span) for t in tensors],
                             self._dev(r)) for r in range(self.size)]

    def all_gather(self, shards, dim=0):
        """The shards concatenated along `dim`, one copy per replica."""
        if self.size == 1:
            return list(shards)
        return [torch.cat([s.to(self._dev(r)) for s in shards], dim)
                for r in range(self.size)]

    def broadcast(self, tensors, root=0):
        """Replica `root`'s tensor, one copy per replica."""
        src = tensors[root]
        return [src if r == root else src.to(self._dev(r), copy=True)
                for r in range(self.size)]

    def lockstep_all_reduce(self, local_rank, tensor):
        """Called by every replica's thread at the same point: the sum of
        their `tensor`s, on the caller's device."""
        if self.size == 1:
            return tensor
        if tensor.is_cuda:
            torch.cuda.current_stream(tensor.device).synchronize()
        self._slots[local_rank] = tensor
        self._barrier.wait()
        try:
            return _ordered_sum(list(self._slots), tensor.device)
        finally:
            self._barrier.wait()

    def abort(self):
        """Break the barrier: replicas waiting in `lockstep_all_reduce`
        raise `threading.BrokenBarrierError`."""
        if self._barrier is not None:
            self._barrier.abort()

    def reset(self):
        """Ready the barrier for the next step after an `abort`."""
        if self._barrier is not None:
            self._barrier.reset()
        self._slots = [None] * self.size


class ProcessReplicaGroup:
    """The process-group form (module doc): this process is replica
    `torch.distributed.get_rank()` of `get_world_size()`, on `device`."""

    in_process = False

    def __init__(self, device):
        import torch.distributed as dist
        from ..context import _norm
        if not dist.is_initialized():
            raise RuntimeError("no torch.distributed process group: start "
                               "it with base.ensure_distributed()")
        self._dist = dist
        self.local = [_norm(device)]
        self.size = dist.get_world_size()
        self.rank_offset = dist.get_rank()

    def all_reduce(self, tensors):
        (t,) = tensors
        acc = _acc(t).clone()
        self._dist.all_reduce(acc)
        return [acc.to(t.dtype)]

    def reduce_scatter(self, tensors, dim=0):
        """This rank's shard (1/size along `dim`) of the sum: each rank
        sends its slices and receives only its own shard's sums."""
        (t,) = tensors
        acc = _acc(t)
        parts = [p.contiguous() for p in acc.chunk(self.size, dim)]
        out = torch.empty_like(parts[self.rank_offset])
        self._dist.reduce_scatter(out, parts)
        return [out.to(t.dtype)]

    def all_gather(self, shards, dim=0):
        (s,) = shards
        parts = [torch.empty_like(s) for _ in range(self.size)]
        self._dist.all_gather(parts, s.contiguous())
        return [torch.cat(parts, dim)]

    def broadcast(self, tensors, root=0):
        out = tensors[0].clone()
        self._dist.broadcast(out, root)
        return [out]

    def lockstep_all_reduce(self, local_rank, tensor):
        return self.all_reduce([tensor])[0]

    def abort(self):
        """Nothing to break: each rank fails on its own."""

    def reset(self):
        """Nothing to ready."""
