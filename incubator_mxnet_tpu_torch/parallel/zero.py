"""ZeRO bucket planning of the PyTorch port (counterpart of
incubator_mxnet_tpu/parallel/zero.py).

`BucketPlan` splits a parameter tree two ways, byte for byte as the JAX
plan does for the same shapes, replica count and knobs:

- **solo set** — parameters with a dimension divisible by the replica
  count and at least ``MXNET_ZERO_SOLO_KB`` bytes: each is
  reduce-scattered on its own along that dimension;
- **concat buckets** — everything else, flattened and concatenated into
  buckets of at most ``MXNET_ZERO_BUCKET_MB`` (a parameter above the cap
  is a bucket of its own), each summed by one all-reduce and updated
  replicated.

What each level keeps where (`parallel.trainer.ShardedTrainer`):

====  ======================  =========================  ==============
zero  gradients               optimizer state            parameters
====  ======================  =========================  ==============
0     all-reduced             replicated                 replicated
1     all-reduced             sharded (first divisible   replicated;
                              dim)                       all-gather of
                                                         the updated
                                                         shards
2     reduce-scattered        sharded (solo dims)        replicated;
      (solo), all-reduced                                all-gather of
      per bucket                                         the updated
                                                         shards
3     as zero 2               sharded (solo dims)        solo set STORED
                                                         sharded; all-
                                                         gathered at
                                                         step start
====  ======================  =========================  ==============

Global shapes are kept: a checkpoint written at one level and replica
count restores at another.  With ``MXNET_ZERO_BUCKET_MB`` 0 the cap is
the JAX package's cold-history rule: 1/32 of the parameter bytes,
clamped to [1, 16] MB (the port keeps no tuning history).
The port's step launches every collective after the backward: the JAX
package's "trail" schedule, which `overlap_schedule` returns and the
plan records.  ``MXNET_ZERO_OVERLAP`` "bwd" (collectives inside the
backward) is not ported and raises.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as _np
import torch

from .. import config as _cfg
from ..monitor import events
from ..telemetry import costs as _costs
from ..telemetry import flightrec as _bb

__all__ = ["BucketPlan", "zero_level_default", "overlap_schedule",
           "record_plan"]


def zero_level_default(zero):
    """A ShardedTrainer `zero=`: None reads MXNET_ZERO_LEVEL; anything
    else is checked and returned."""
    if zero is None:
        zero = _cfg.get("MXNET_ZERO_LEVEL")
    zero = int(zero)
    if not 0 <= zero <= 3:
        raise ValueError("zero=%r: ZeRO level must be 0..3" % (zero,))
    return zero


def overlap_schedule(devices):
    """The schedule the step runs on these replica devices: "trail" for
    MXNET_ZERO_OVERLAP "auto" or "trail" (module doc); "bwd" raises."""
    mode = str(_cfg.get("MXNET_ZERO_OVERLAP"))
    if mode == "bwd":
        raise NotImplementedError(
            "MXNET_ZERO_OVERLAP=bwd (collectives inside the backward) is "
            "not ported: the step launches them after the backward; set "
            "it to 'trail' or 'auto'")
    if mode not in ("auto", "trail"):
        raise ValueError("MXNET_ZERO_OVERLAP=%r: 'bwd', 'trail' or "
                         "'auto'" % mode)
    return "trail"


def _auto_cap_mb(total_bytes):
    if total_bytes <= 0:
        return 4.0
    return float(min(16.0, max(1.0, total_bytes / 32.0 / 1e6)))


class BucketPlan:
    """Collective plan for one parameter tree on an n-replica mesh.

    ``solo``: {name: dim} — reduce-scattered and all-gathered along dim.
    ``buckets``: lists of names — each concatenated and all-reduced."""

    def __init__(self, shapes: Dict[str, tuple], n_shards: int,
                 cap_mb: Optional[float] = None,
                 solo_min_kb: Optional[int] = None,
                 order: Optional[List[str]] = None,
                 itemsize: int = 4, label: Optional[str] = None):
        self.n_shards = int(n_shards)
        cap_mb = float(cap_mb if cap_mb is not None
                       else _cfg.get("MXNET_ZERO_BUCKET_MB"))
        total = sum(int(_np.prod(s)) * itemsize for s in shapes.values())
        if cap_mb <= 0:
            cap_mb = _auto_cap_mb(total)
        self.cap_bytes = int(cap_mb * 1e6)
        self.cap_mb = cap_mb
        solo_min = int(solo_min_kb if solo_min_kb is not None
                       else _cfg.get("MXNET_ZERO_SOLO_KB")) * 1024
        self.solo: Dict[str, int] = {}
        self.buckets: List[List[str]] = []
        # reverse layer order: the last layer's gradients are ready first
        names = list(order if order is not None else shapes)[::-1]
        cur, cur_bytes = [], 0
        for n in names:
            shape = tuple(shapes[n])
            nbytes = int(_np.prod(shape)) * itemsize if shape else itemsize
            ax = None
            if self.n_shards > 1:
                for i, d in enumerate(shape):
                    if d % self.n_shards == 0 and d >= self.n_shards:
                        ax = i
                        break
            if ax is not None and nbytes >= solo_min:
                self.solo[n] = ax
                continue
            if cur and cur_bytes + nbytes > self.cap_bytes:
                self.buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(n)
            cur_bytes += nbytes
        if cur:
            self.buckets.append(cur)
        self._shapes = {n: tuple(shapes[n]) for n in shapes}
        self._itemsize = itemsize
        self._cost_keys = []

    def bytes_of(self, names):
        return sum(int(_np.prod(self._shapes[n])) * self._itemsize
                   for n in names)

    def describe(self):
        """Summary dict for records and dumps."""
        return {
            "n_shards": self.n_shards,
            "bucket_cap_mb": round(self.cap_mb, 3),
            "solo_params": len(self.solo),
            "solo_bytes": self.bytes_of(self.solo),
            "concat_buckets": len(self.buckets),
            "concat_bytes": sum(self.bytes_of(b) for b in self.buckets),
        }

    def register_cost_rows(self, label):
        """One kind="collective" row per solo reduce-scatter and
        all-gather and per concat bucket (`telemetry.costs`)."""
        if self._cost_keys or self.n_shards <= 1:
            return self._cost_keys
        for n in self.solo:
            b = self.bytes_of([n])
            self._cost_keys.append(_costs.note_collective(
                "%s:rs:%s" % (label, n), "reduce_scatter", b,
                self.n_shards))
            self._cost_keys.append(_costs.note_collective(
                "%s:ag:%s" % (label, n), "all_gather", b, self.n_shards))
        for i, names in enumerate(self.buckets):
            self._cost_keys.append(_costs.note_collective(
                "%s:psum[b%d]" % (label, i), "psum", self.bytes_of(names),
                self.n_shards))
        return self._cost_keys

    def invoke_cost_rows(self):
        """Bump every row's invocation count (once per step, when the
        flight recorder is on)."""
        if not _bb.enabled():
            return
        for k in self._cost_keys:
            _costs.invoke(k)

    # -- the step's collectives over a parallel.collectives group -------
    def gather_params(self, group, shards):
        """ZeRO-3 at step start: [{name: tensor}] per local replica with
        every solo parameter all-gathered back to its full shape."""
        full = [dict(s) for s in shards]
        for n, ax in self.solo.items():
            for r, t in enumerate(group.all_gather([s[n] for s in shards],
                                                   ax)):
                full[r][n] = t
        return full

    def reduce_scatter_grads(self, group, grads):
        """Per local replica: {solo name: its shard of the summed
        gradient} and [(names, the summed flat) of each bucket], over the
        names `grads` holds (a parameter without gradient is left out)."""
        solo = [{} for _ in grads]
        for n, ax in self.solo.items():
            if n not in grads[0]:
                continue
            for r, t in enumerate(group.reduce_scatter([g[n] for g in grads],
                                                       ax)):
                solo[r][n] = t
        flats = [[] for _ in grads]
        for bucket in self.buckets:
            names = [n for n in bucket if n in grads[0]]
            if not names:
                continue
            per = [torch.cat([g[n].reshape(-1) for n in names])
                   for g in grads]
            for r, t in enumerate(group.all_reduce(per)):
                flats[r].append((names, t))
        return solo, flats

    def split_bucket(self, flat, names):
        """A bucket's flat back into {name: tensor of its shape}."""
        out, off = {}, 0
        for n in names:
            shape = self._shapes[n]
            size = int(_np.prod(shape)) if shape else 1
            out[n] = flat[off:off + size].reshape(shape)
            off += size
        return out


def record_plan(label, plan, zero, schedule):
    """Flight-recorder record of the plan a trainer built."""
    events.incr("zero.plans")
    _bb.record("zero", "plan", label=label, level=int(zero),
               schedule=schedule, **plan.describe())
