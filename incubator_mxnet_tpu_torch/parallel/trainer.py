"""The sharded training step of the PyTorch port (counterpart of
incubator_mxnet_tpu/parallel/trainer.py).

`ShardedTrainer` trains a Gluon block data-parallel over the replicas of
a `Mesh` (in-process: one process drives every replica) or over the
ranks of a `torch.distributed` group (one replica per process; with
`mesh=process_mesh(...)`, the ranks laid out on its axes), through
`parallel.collectives`.  Each replica holds its own copy of the
parameters, keyed by the block's structural `collect_params()` names
(`params`), and of the optimizer state; the block itself is read once
and written by `sync_to_block()`.

Tensor parallelism: a mesh axis other than `batch_axis` of size > 1
("model") with a `param_spec_fn(name, shape)` whose specs name it, at
zero 0 and 1.  The function is called with each parameter's MXNet name
(`Parameter.name`, "dense0_weight"), as the JAX trainer calls it.  Each
replica stores only its model coordinate's shard of a sharded parameter
and of its optimizer state (zero 1 splits the state along the data axis
on top, as the JAX `_zero_spec` does); checkpoints stay at global
shapes.  The step runs each replica's forward as a body of
`spmd.run_replicas` under the `tensor_parallel.Plan` derived from the
specs and the block (column and row parallel Dense, attention on local
heads, gathered parameters), then one backward over the local replicas'
losses; each gradient is then summed over the data axis only, among the
replicas of its model coordinate (`collectives.AxisGroups` in one
process, a data-axis subgroup over a process group).

A step splits the global batch by rows, one slice per replica (a
process-group rank passes its own rows), and per replica runs the
forward and backward through `functional.functionalize`, then reduces
the gradients and updates as the ZeRO level says (`parallel/zero.py`):

* zero 0 — gradients all-reduced, every replica updates the whole
  tree;
* zero 1 — gradients all-reduced, each replica updates its shard (the
  first dimension divisible by the replica count) with its shard of the
  optimizer state, and the updated shards are all-gathered;
* zero 2 — the bucket plan's solo parameters have their gradients
  reduce-scattered and update on shards, all-gathered after; the concat
  buckets are all-reduced and update replicated;
* zero 3 — as zero 2, but the solo parameters stay stored sharded (1/N
  of their bytes per replica), all-gathered at the start of each step.

The gradient each replica's loss gives is of its own rows' mean, so the
reduced sum is rescaled by 1/N (`scale`) in the update.  BatchNorm
follows the JAX package: at zero 0 and 1 its batch statistics are those
of the global batch (there XLA makes a plain BatchNorm's moments global
in the one jitted step), so with N > 1 replicas each replica runs on a
thread of its own (`dispatch.DispatchPool.lockstep`) inside
`collectives.replica_sync`, and each BatchNorm sums its moments and
backward sums across them; at zero 2 and 3 the statistics stay local,
as in the JAX shard_map body, and the running statistics are averaged
across replicas after the step.

`sgd_momentum_tree` and `adam_tree` update {name: tensor} trees with
f32 arithmetic, each weight rounded once into its dtype, as the JAX
ones do; the momentum and Adam moments are kept in f32 (the JAX SGD
state starts in the weight's dtype and is f32 from the first update on,
with the same values).  In the trainer, lr, wd and the rescale are read
from a device vector per replica (`_hyper`), so `set_learning_rate`
reaches a captured step.

A guarded step (`parallel.ResilientTrainer`) runs the same body with a
device vector per replica [poison, spike threshold, loss scale]: the
loss is scaled, the loss and gradients are multiplied by the poison,
`ok` (a finite loss at or below the threshold, every gradient finite,
over all replicas) is computed on the device, the gradients are
unscaled in the update, and the new parameters, optimizer state and
running statistics are committed by `torch.where(ok, new, old)`: a bad
step leaves all three bit for bit as they were.  With poison and scale
1 it is the unguarded step, bit for bit.

Capture: with one replica the whole step (forward, backward, update) is
one program of `graph_capture.capture`, a CUDA graph on the card: the
first step of a batch signature runs eagerly, the second captures, the
later ones copy the batch into the program's static inputs and replay
(`captures`, `replays`, `eager_steps` count them).  So does each rank of
a process group on a card, its NCCL collectives inside the graph (the
eager first step sets up every communicator the step uses); a rank on
the host (gloo) steps eagerly.  A step over several in-process replicas
runs uncaptured: its replicas meet on host barriers (BatchNorm's
lockstep sums, `spmd`'s meetings), which a graph cannot record.  A
guarded step is a program of its own.

Checkpoints are `torch.save` files of host tensors (`checkpoint.pt` in
the directory `path`) holding the tree {params, opt_state, n_step} at
global shapes, where the JAX package writes an orbax checkpoint; they
restore onto a mesh of another size and another ZeRO level.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as _np
import torch

from .. import config as _config
from .. import graph_capture as _capture
from ..context import current_device
from ..monitor import events
from ..telemetry import flightrec as _bb
from . import collectives as _coll
from .dispatch import DispatchPool
from .functional import extract_params, functionalize, load_params, \
    replica_shell
from .mesh import Mesh, NamedSharding, P, Shards, axis_group, make_mesh, \
    mesh_devices
from .zero import BucketPlan, overlap_schedule, record_plan, \
    zero_level_default

__all__ = ["ShardedTrainer", "softmax_ce_loss", "sgd_momentum_tree",
           "adam_tree"]

#: the file of a `save_checkpoint` directory
CHECKPOINT_FILE = "checkpoint.pt"


def softmax_ce_loss(logits, labels):
    """Mean softmax cross-entropy with integer labels, in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long().reshape(-1, 1)).mean()


def sgd_momentum_tree(lr, momentum=0.9, wd=0.0):
    """(init, update) of SGD with momentum over {name: tensor} trees:
    m = momentum * m - lr * (g * scale + wd * w); w += m, in f32.  `lr`
    and `wd` may be device scalars."""

    def init(params):
        return {n: torch.zeros(w.shape, dtype=torch.float32,
                               device=w.device) for n, w in params.items()}

    def update(params, grads, state, scale=1.0):
        new_p, new_s = {}, {}
        for n, w in params.items():
            w32 = w.float()
            g = grads[n].float() * scale + wd * w32
            m = momentum * state[n] - lr * g
            new_p[n] = (w32 + m).to(w.dtype)
            new_s[n] = m
        return new_p, new_s

    return init, update


def adam_tree(lr, beta1=0.9, beta2=0.999, eps=1e-8, wd=0.0):
    """(init, update) of Adam over {name: tensor} trees, in f32, with the
    bias corrections of the step count `t` (a device int32)."""

    def init(params):
        dev = next(iter(params.values())).device
        return {"m": {n: torch.zeros(w.shape, dtype=torch.float32,
                                     device=w.device)
                      for n, w in params.items()},
                "v": {n: torch.zeros(w.shape, dtype=torch.float32,
                                     device=w.device)
                      for n, w in params.items()},
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(params, grads, state, scale=1.0):
        t = state["t"] + 1
        tf = t.float()
        b1t = 1.0 - torch.pow(beta1, tf)
        b2t = 1.0 - torch.pow(beta2, tf)
        new_p, new_m, new_v = {}, {}, {}
        for n, w in params.items():
            w32 = w.float()
            g = grads[n].float() * scale + wd * w32
            m = beta1 * state["m"][n] + (1 - beta1) * g
            v = beta2 * state["v"][n] + (1 - beta2) * g.square()
            new_p[n] = (w32 - lr * (m / b1t) /
                        (torch.sqrt(v / b2t) + eps)).to(w.dtype)
            new_m[n], new_v[n] = m, v
        return new_p, {"m": new_m, "v": new_v, "t": t}

    return init, update


def _clone(out):
    return tuple(t.clone() for t in out) if isinstance(out, tuple) \
        else out.clone()


def _map_named(tree, names, fn):
    """`tree` with fn(name, leaf) at each leaf of a dict keyed by
    parameter names, fn(None, leaf) at every other leaf."""
    if isinstance(tree, dict):
        if tree and set(tree) <= names:
            return {n: fn(n, v) for n, v in tree.items()}
        return {k: _map_named(v, names, fn) for k, v in tree.items()}
    return fn(None, tree)


def _restrict(tree, names, keep):
    """`tree` with its parameter-keyed dicts restricted to `keep`."""
    if isinstance(tree, dict):
        if tree and set(tree) <= names:
            return {n: v for n, v in tree.items() if n in keep}
        return {k: _restrict(v, names, keep) for k, v in tree.items()}
    return tree


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _commit(dst, new, ok=None):
    """`dst` := `new`, or where the device bool `ok` is given,
    `torch.where(ok, new, dst)` (the old value is read before it is
    written)."""
    dst.copy_(new if ok is None else torch.where(ok, new.to(dst.dtype), dst))


def _copy_tree(dst, src, ok=None):
    """Write `src` into `dst` in place, leaf by leaf (the same
    structure; a parameter-keyed dict of `src` may hold a subset), each
    leaf committed by `_commit`."""
    if isinstance(dst, dict):
        for k, v in src.items():
            _copy_tree(dst[k], v, ok)
    else:
        _commit(dst, src, ok)


class ShardedTrainer:
    """Data-parallel training of `block` over a mesh (module doc).

    block: a Gluon block whose parameters are initialized (run one
        forward first where widths are deferred)
    loss_fn: (outputs, labels) -> scalar mean loss
    optimizer: "sgd" | "adam" | an (init, update) pair over trees
    mesh: a `Mesh` of replica contexts (default: every card; `device=`
        for a one-replica mesh on that device).  Inside a
        `torch.distributed` group with no mesh given, the trainer is one
        rank of the group, on `device` (default `cuda:<rank>` where
        there are cards, else `current_device()`, which raises outside
        a `with cpu():`); a `process_mesh` makes it this rank's replica
        of that mesh.
    param_spec_fn: (MXNet name, shape) -> P over the mesh's model axis
        (tensor parallelism, module doc); None replicates everything
    zero: the ZeRO level 0..3, or None for MXNET_ZERO_LEVEL; levels 2
        and 3 need a 1-d data mesh and no `param_spec_fn`
    preprocess: a function of each replica's batch rows run inside the
        step (a uint8 batch to its normalized compute dtype, say)
    amp: "bfloat16"/"float16" turns `contrib.amp`'s cast policy on for
        the step (None: MXNET_AMP_DTYPE)
    """

    def __init__(self, block, loss_fn=softmax_ce_loss, optimizer="sgd",
                 lr=0.01, momentum=0.9, wd=0.0,
                 mesh: Optional[Mesh] = None, batch_axis="data",
                 param_spec_fn=None, zero=None, preprocess=None, amp=None,
                 device=None):
        import torch.distributed as dist
        from ..contrib import amp as _amp_mod
        self.amp = _amp_mod.normalize_dtype(
            amp if amp is not None else _config.get("MXNET_AMP_DTYPE"))
        if self.amp:
            _amp_mod.init(self.amp)
            events.incr("amp.trainer_init")
        self.block = block
        self.loss_fn = loss_fn
        self.batch_axis = batch_axis
        self.zero = zero_level_default(zero)
        self._preprocess = preprocess
        self._lr, self._wd = float(lr), float(wd)
        self._rank = 0
        if mesh is not None and not mesh.in_process:
            # one rank of a `process_mesh`: its replica of the mesh
            self._rank = dist.get_rank()
            device = mesh.devices.flat[self._rank]
            self.mesh = mesh
            self.group = _coll.ProcessReplicaGroup(
                device, *axis_group(mesh, batch_axis, self._rank))
        elif mesh is None and dist.is_initialized():
            if device is None:
                device = torch.device(
                    "cuda", dist.get_rank() % torch.cuda.device_count()) \
                    if torch.cuda.is_available() else current_device()
            self._rank = dist.get_rank()
            self.mesh = make_mesh(devices=[device])
            self.group = _coll.ProcessReplicaGroup(device)
        else:
            if mesh is None:
                mesh = make_mesh(devices=[device]) if device is not None \
                    else make_mesh()
            self.mesh = mesh
            self.group = None
        self._mesh_layout(batch_axis)
        if self.zero >= 2:
            if len(self.mesh.axis_names) != 1 or \
                    self.mesh.axis_names[0] != batch_axis:
                raise ValueError(
                    "zero=%d needs a 1-d %r data mesh (got axes %s); "
                    "combine tensor parallelism with zero<=1"
                    % (self.zero, batch_axis, tuple(self.mesh.axis_names)))
            if param_spec_fn is not None:
                raise ValueError(
                    "zero=%d shards params itself — param_spec_fn "
                    "(tensor parallel) requires zero<=1" % self.zero)
        full = {n: v.detach().clone()
                for n, v in extract_params(block).items()}
        specs = self._param_specs(block, param_spec_fn, full)
        self._local = list(self.group.local)
        self._n = self.group.size
        self._optimizer = optimizer
        self._momentum = momentum
        self.captures = self.replays = self.eager_steps = 0
        self._n_step = 0
        self._dispatch = DispatchPool(self._local) \
            if self.group.in_process else None
        # one replica captures its step: in one process, or as one rank
        # of a group on a card (NCCL inside the graph; gloo cannot be
        # captured, so a rank on the host steps eagerly)
        self._capture = len(self._local) == 1 and (
            self._local[0].type == "cuda" or
            (self.group.in_process and self._n == 1 and self._tp == 1))
        self._names = list(block.collect_params().keys())
        self._stateful = {n for n, p in block.collect_params().items()
                          if not p.requires_grad}
        if self._tp > 1 and self.group.in_process and self._stateful and \
                self.zero <= 1:
            raise ValueError(
                "tensor parallelism in one process runs one backward over "
                "every replica, which cannot meet BatchNorm's sums across "
                "replicas in its middle; run one rank a card "
                "(process_mesh)")
        # global batch statistics are BatchNorm's: a block without
        # running statistics has nothing to sum across replicas
        self._sync_bn = self.zero <= 1 and self._n > 1 and \
            bool(self._stateful)
        cards = [d for d in self._local if d.type == "cuda"]
        if self._sync_bn and len(set(cards)) < len(cards):
            raise ValueError(
                "zero=%d sums BatchNorm statistics across replicas in the "
                "middle of the backward, which replicas sharing a card "
                "cannot do (their backwards run on one autograd thread); "
                "use one replica per card, or zero>=2" % self.zero)
        self._shells = [block] + [replica_shell(block)
                                  for _ in self._local[1:]]
        self._fwd = [functionalize(b, training=True) for b in self._shells]
        self._tpplan = None
        if self._tp > 1:
            from .tensor_parallel import Plan
            self._tpplan = Plan(block, specs, self._tp_axis,
                                self._tp).bind(self._shells)
        self._hyper = [torch.tensor([lr, wd, 1.0 / self._n],
                                    dtype=torch.float32, device=self._dev(r))
                       for r in range(len(self._local))]
        self._opt_fns = [self._make_opt(h) for h in self._hyper]
        self._opt_init = self._opt_fns[0][0]
        self._build_layout({n: tuple(v.shape) for n, v in full.items()})
        self._place_params(full)
        self.opt_state = self._opt_fns[0][0](full)

    # -- layout ------------------------------------------------------
    def _mesh_layout(self, batch_axis):
        """The mesh's model axis (`_tp_axis`, of size `_tp`; None and 1
        without one), each local replica's data and model index
        (`_didx`, `_midx`), the data group where the constructor left
        none (in one process: a group over the mesh, or one per model
        coordinate), and a process rank's model-axis group (`_mgroup`)."""
        mesh = self.mesh
        if batch_axis not in mesh.axis_names:
            raise ValueError("the mesh %s has no batch axis %r"
                             % (tuple(mesh.axis_names), batch_axis))
        others = [ax for ax, size in mesh.shape.items()
                  if ax != batch_axis and size > 1]
        if len(others) > 1:
            raise NotImplementedError(
                "mesh axes %s besides %r: the port shards parameters over "
                "one model axis" % (others, batch_axis))
        self._tp_axis = others[0] if others else None
        self._tp = mesh.shape[self._tp_axis] if others else 1
        coords = [dict(zip(mesh.axis_names, idx))
                  for idx in _np.ndindex(*mesh.devices.shape)]
        self._mgroup = None
        if self.group is None:
            devs = mesh_devices(mesh)
            self._didx = [c[batch_axis] for c in coords]
            self._midx = [c.get(self._tp_axis, 0) for c in coords]
            if self._tp == 1:
                self.group = _coll.ReplicaGroup(devs)
            else:
                self.group = _coll.AxisGroups(devs, [
                    [r for r in range(len(devs)) if self._midx[r] == m]
                    for m in range(self._tp)])
        elif mesh.in_process:
            self._didx, self._midx = [self.group.rank_offset], [0]
        else:
            self._didx = [coords[self._rank][batch_axis]]
            self._midx = [coords[self._rank].get(self._tp_axis, 0)]
            if self._tp > 1:
                self._mgroup = _coll.ProcessReplicaGroup(
                    self.group.local[0],
                    *axis_group(mesh, self._tp_axis, self._rank))

    def _param_specs(self, block, spec_fn, full):
        """{structural name: spec over the model axis} from
        `spec_fn(name, shape)`, called with each parameter's MXNet name
        (`Parameter.name`, "dense0_weight") as the JAX trainer calls it;
        an entry over an axis of size 1 shards nothing.  A sharded
        dimension the model axis does not divide raises ValueError."""
        if spec_fn is None:
            return {}
        pd = block.collect_params()
        specs = {}
        for n, v in full.items():
            spec = tuple(spec_fn(pd[n].name, tuple(v.shape)))
            for d, a in enumerate(spec):
                if a is None or self.mesh.shape.get(a, 0) == 1:
                    continue
                if a not in self.mesh.shape:
                    raise ValueError("parameter %s (%s): no mesh axis %r "
                                     "(axes %s)" % (pd[n].name, n, a,
                                                    tuple(self.mesh.shape)))
                if a == self.batch_axis:
                    raise NotImplementedError(
                        "parameter %s (%s) sharded over the batch axis %r"
                        % (pd[n].name, n, a))
                if v.shape[d] % self._tp:
                    raise ValueError(
                        "parameter %s (%s): dimension %d of size %d does "
                        "not split over the %r axis of size %d"
                        % (pd[n].name, n, d, v.shape[d], a, self._tp))
            specs[n] = P(*[a if a is not None and
                           self.mesh.shape.get(a, 0) > 1 else None
                           for a in spec])
        return specs

    def _dev(self, r):
        d = self._local[r]
        return torch.device("cpu") if d.type == "cpu" else d

    def _make_opt(self, hyper):
        lr, wd = hyper[0], hyper[1]
        if self._optimizer == "sgd":
            return sgd_momentum_tree(lr, self._momentum, wd)
        if self._optimizer == "adam":
            return adam_tree(lr, wd=wd)
        return self._optimizer

    def _build_layout(self, shapes):
        """Per parameter, the dim its optimizer state (zero >= 1) and its
        stored value (zero 3) are sharded along over the data axis, or
        None; and (`_tp_dim`) the dim a tensor-parallel spec shards it
        along over the model axis, which the state follows."""
        n = self._n
        self._plan = None
        self._tp_dim = dict(self._tpplan.tp_dim) if self._tpplan else {}
        self._state_dim = {}
        if self.zero >= 2:
            self._plan = BucketPlan(shapes, n, order=list(shapes),
                                    label="sharded.zstep")
            self._state_dim = dict(self._plan.solo) if n > 1 else {}
            self._plan.register_cost_rows("sharded.zstep")
            record_plan("sharded.zstep", self._plan, self.zero,
                        overlap_schedule(self._local))
        elif self.zero == 1 and n > 1:
            for name, shape in shapes.items():
                for i, d in enumerate(shape):
                    if i != self._tp_dim.get(name) and d % n == 0 and \
                            d >= n:
                        self._state_dim[name] = i
                        break
        self._param_dim = dict(self._state_dim) if self.zero >= 3 else {}
        self._shapes = dict(shapes)

    def _shard(self, value, dim, r):
        """Local replica r's shard of `value` along `dim` over the data
        axis."""
        if dim is None:
            return value
        span = value.shape[dim] // self._n
        return value.narrow(dim, self._didx[r] * span, span)

    def _tp_shard(self, value, name, r):
        """Local replica r's shard of global `value` by parameter
        `name`'s tensor-parallel spec (None: `value`)."""
        dim = None if name is None else self._tp_dim.get(name)
        if dim is None:
            return value
        span = value.shape[dim] // self._tp
        return value.narrow(dim, self._midx[r] * span, span)

    def _place_params(self, full):
        """Store global `full` ({name: tensor}) on every local replica as
        the level and the specs say (zero 3: solo parameters as shards;
        a tensor-parallel parameter: its model coordinate's shard)."""
        self._rparams = [
            {nm: self._shard(self._tp_shard(v, nm, r),
                             self._param_dim.get(nm), r)
             .to(self._dev(r), copy=True).contiguous()
             for nm, v in full.items()}
            for r in range(len(self._local))]
        self._program = self._warm = None

    def _gather(self, per_replica, dims):
        """Global {name: tensor} from local replica shards, along `dims`
        over the data axis, then along the specs' dims over the model
        axis (host side for checkpoints and `params`; a process-group
        rank gathers from the other ranks)."""
        out = {}
        for nm, v in per_replica[0].items():
            dim, mdim = dims.get(nm), self._tp_dim.get(nm)
            if not self.group.in_process:
                if dim is not None:
                    v = self.group.all_gather([v], dim)[0]
                if mdim is not None:
                    v = self._mgroup.all_gather([v], mdim)[0]
                out[nm] = v
                continue

            def coordinate(m):
                reps = [r for r in range(len(per_replica))
                        if self._midx[r] == m]
                if dim is None:
                    return per_replica[reps[0]][nm].to(v.device)
                return torch.cat([per_replica[r][nm].to(v.device)
                                  for r in reps], dim)
            out[nm] = coordinate(0) if mdim is None else \
                torch.cat([coordinate(m) for m in range(self._tp)], mdim)
        return out

    @property
    def params(self):
        """{name: tensor} at global shapes (replica 0's copy)."""
        return self._gather(self._rparams, self._param_dim)

    @params.setter
    def params(self, value):
        """Replace the parameters (cast them, say) on every replica; the
        optimizer state is kept (assign `opt_state` to rebuild it)."""
        names = set(self._shapes)
        if set(value) != names:
            raise ValueError("params must have the trainer's names")
        self._place_params({n: v.detach() for n, v in value.items()})

    @property
    def opt_state(self):
        """The optimizer state at global shapes."""
        return self._gather_state(self._opt)

    @opt_state.setter
    def opt_state(self, tree):
        names = set(self._shapes)
        self._opt = [
            _map_named(tree, names, lambda nm, v, r=r: self._place_leaf(
                v, None if nm is None else self._state_dim.get(nm), r, nm))
            for r in range(len(self._local))]
        self._program = self._warm = None

    def _place_leaf(self, v, dim, r, name=None):
        v = torch.as_tensor(v)
        return self._shard(self._tp_shard(v, name, r), dim, r) \
            .to(self._dev(r), copy=True).contiguous()

    def _gather_state(self, per_replica):
        names = set(self._shapes)

        def walk(trees):
            first = trees[0]
            if isinstance(first, dict):
                if first and set(first) <= names:
                    return self._gather([{n: t[n] for n in first}
                                         for t in trees], self._state_dim)
                return {k: walk([t[k] for t in trees]) for k in first}
            return first
        return walk(per_replica)

    def replica_param_bytes(self):
        """Bytes of the parameters each local replica stores."""
        return [sum(t.numel() * t.element_size() for t in p.values())
                for p in self._rparams]

    @property
    def data_parallel_size(self) -> int:
        """Replicas along the batch axis (every rank of a group)."""
        return self._n

    @property
    def writer(self) -> bool:
        """Whether this process writes checkpoints (a process group's
        rank 0)."""
        return self._rank == 0

    def set_learning_rate(self, lr):
        """The lr of the next steps, a captured step's included."""
        self._lr = float(lr)
        for h in self._hyper:
            h[0].fill_(self._lr)

    # -- the step ----------------------------------------------------
    def _split(self, arr):
        """Local replica row slices of a global batch (a process-group
        rank's `arr` is its own rows), each on its replica's device."""
        from ..ndarray.ndarray import NDArray
        if isinstance(arr, Shards):
            return [a._data if isinstance(a, NDArray) else a for a in arr]
        if isinstance(arr, NDArray):
            arr = arr._data
        if self._tp > 1 and self.group.in_process:
            # the model replicas of one data coordinate take its rows
            t = arr if isinstance(arr, torch.Tensor) else \
                torch.as_tensor(arr)
            if t.shape[0] % self._n:
                raise ValueError("a batch of %d rows does not split over "
                                 "%d data replicas" % (t.shape[0], self._n))
            rows = t.shape[0] // self._n
            return [t[self._didx[r] * rows:(self._didx[r] + 1) * rows]
                    .to(self._dev(r)) for r in range(len(self._local))]
        if not self.group.in_process or len(self._local) == 1:
            t = arr if isinstance(arr, torch.Tensor) else \
                torch.as_tensor(arr)
            return [t.to(self._dev(0))]
        if isinstance(arr, torch.Tensor) and arr.device.type != "cpu":
            n = len(self._local)
            rows = arr.shape[0] // n
            if arr.shape[0] % n:
                raise ValueError("a batch of %d rows does not split over "
                                 "%d replicas" % (arr.shape[0], n))
            return [arr[r * rows:(r + 1) * rows].to(self._dev(r))
                    for r in range(n)]
        return self._dispatch.place(arr if isinstance(arr, torch.Tensor)
                                    else torch.as_tensor(arr))

    def _replica_grads(self, r, x, y, params, guard=None):
        """Loss, {name: gradient} and running-statistic updates of local
        replica r over its rows; a guarded step's loss is scaled, and
        the loss and gradients are multiplied by the poison (module
        doc)."""
        if self._preprocess is not None:
            x = self._preprocess(x)
        leaves = {n: (v.detach().requires_grad_(True)
                      if n not in self._stateful else v)
                  for n, v in params.items()}
        with torch.enable_grad():
            out, states = self._fwd[r](leaves, x)
            loss = self.loss_fn(out, y)
            if guard is not None:
                loss = loss * guard[r][2]
            train = [n for n in self._names if n not in self._stateful]
            grads = torch.autograd.grad(loss, [leaves[n] for n in train],
                                        allow_unused=True)
        grads = {n: torch.zeros_like(leaves[n]) if g is None else g
                 for n, g in zip(train, grads)}
        loss = loss.detach()
        if guard is not None:
            poison = guard[r][0]
            loss = loss * poison
            grads = {n: g * poison.to(g.dtype) for n, g in grads.items()}
        return loss, grads, states

    def _tp_forward_backward(self, xs, ys, full, guard=None):
        """Per local replica (loss, grads, states) of a tensor-parallel
        step: each replica's forward a body of `spmd.run_replicas` with
        the plan active (parallel/tensor_parallel.py), its gathered
        parameters all-gathered first, then ONE backward over every
        local replica's loss (in one process the collectives' backwards
        are one node over all replicas, which a backward per replica
        could not run)."""
        from . import spmd
        from . import tensor_parallel as _tpm
        plan, nl = self._tpplan, len(self._local)
        train = [n for n in self._names if n not in self._stateful]
        leaves = [{n: (v.detach().requires_grad_(True)
                       if n not in self._stateful else v)
                   for n, v in full[r].items()} for r in range(nl)]

        def body(r):
            x = xs[r]
            if self._preprocess is not None:
                x = self._preprocess(x)
            sync = _coll.replica_sync(self.group, r) if self._sync_bn \
                else contextlib.nullcontext()
            with _tpm.active(plan), sync:
                p = {n: (_tpm.gather_from(v, plan.tp_dim[n])
                         if n in plan.gathered else v)
                     for n, v in leaves[r].items()}
                out, states = self._fwd[r](p, x)
                loss = self.loss_fn(out, ys[r])
            if guard is not None:
                loss = loss * guard[r][2]
            return loss, states
        with torch.enable_grad():
            results = spmd.run_replicas(body, self.mesh)
            losses = [res[0] for res in results]
            gs = torch.autograd.grad(
                losses, [leaves[r][n] for r in range(nl) for n in train],
                allow_unused=True)
        out = []
        for r in range(nl):
            part = gs[r * len(train):(r + 1) * len(train)]
            grads = {n: torch.zeros_like(leaves[r][n]) if g is None else g
                     for n, g in zip(train, part)}
            loss = losses[r].detach()
            if guard is not None:
                poison = guard[r][0]
                loss = loss * poison
                grads = {n: g * poison.to(g.dtype)
                         for n, g in grads.items()}
            out.append((loss, grads, results[r][1]))
        return out

    def _mean_loss(self, losses):
        """The mean of the local replicas' losses on replica 0's device,
        over one model coordinate (the model replicas hold one loss)."""
        mine = [l for r, l in enumerate(losses)
                if self._midx[r] == self._midx[0]]
        return mine[0] if len(mine) == 1 else torch.stack(
            [l.to(self._dev(0)) for l in mine]).mean()

    def _forward_backward(self, xs, ys, full, guard=None):
        """Per local replica (loss, grads, states), in lockstep when
        BatchNorm's statistics span the replicas."""
        if self._tpplan is not None:
            return self._tp_forward_backward(xs, ys, full, guard)

        def one(r):
            return self._replica_grads(r, xs[r], ys[r], full[r], guard)

        def synced(r):
            with _coll.replica_sync(self.group, r):
                return one(r)
        if len(self._local) == 1:
            return [synced(0) if self._sync_bn else one(0)]
        if self._sync_bn:
            return self._dispatch.lockstep(synced, self.group)
        if len(set(self._local)) < len(self._local):
            # replicas that share a card share its stream (and the
            # kernels' scratch buffers): they run in turn
            return [one(r) for r in range(len(self._local))]
        return self._dispatch.run(one, range(len(self._local)))

    def _verdict(self, losses, grads, guard):
        """A guarded step's (unscaled mean loss on replica 0's device,
        [ok on each local replica's device]): the loss finite and at most
        the spike threshold, every gradient of every replica finite."""
        group, nl = self.group, len(self._local)
        dev0 = self._dev(0)
        fin = [torch.isfinite(torch.stack(
            [n.float() for n in torch._foreach_norm(
                list(grads[r].values()), float("inf"))]
            + [losses[r].float()])).all().to(dev0) for r in range(nl)]
        fin = torch.stack(fin).all()
        loss = self._mean_loss(losses)
        if not group.in_process and self._n > 1:
            both = group.all_reduce([torch.stack(
                [loss.float(), (~fin).float()])])[0]
            loss, fin = both[0] / self._n, both[1] == 0
        if self._mgroup is not None:
            # a non-finite shard on any model rank stops every rank
            fin = self._mgroup.all_reduce([(~fin).float()])[0] == 0
        loss = loss / guard[0][2]
        ok = fin & torch.isfinite(loss) & (loss <= guard[0][1])
        return loss, [ok if r == 0 else ok.to(self._dev(r))
                      for r in range(nl)]

    def _body(self, xs, ys, guard=None):
        """One step on the local replicas' rows; returns the mean loss
        (on replica 0's device), and with a guard (a device vector per
        local replica, module doc) (loss, ok)."""
        group, nl = self.group, len(self._local)
        plan = self._plan
        full = self._rparams
        if self._param_dim:
            full = plan.gather_params(group, self._rparams)
        results = self._forward_backward(xs, ys, full, guard)
        losses = [res[0] for res in results]
        grads = [res[1] for res in results]
        ok = None
        if guard is not None:
            gloss, ok = self._verdict(losses, grads, guard)
        train = list(grads[0])
        # the gradient each replica updates with: (name -> tensor), the
        # shard of it where the state is sharded
        g_up = [{} for _ in range(nl)]
        w_up = [{} for _ in range(nl)]
        if plan is not None and self._n > 1:
            solo_g, flats = plan.reduce_scatter_grads(group, grads)
            for r in range(nl):
                for nm in solo_g[r]:
                    g_up[r][nm] = solo_g[r][nm]
                    w_up[r][nm] = self._rparams[r][nm] \
                        if self.zero >= 3 else \
                        self._shard(full[r][nm], plan.solo[nm], r)
                for names, flat in flats[r]:
                    for nm, g in plan.split_bucket(flat, names).items():
                        g_up[r][nm] = g
                        w_up[r][nm] = full[r][nm]
        else:
            for nm in train:
                for r, g in enumerate(group.all_reduce(
                        [grads[r][nm] for r in range(nl)])):
                    dim = self._state_dim.get(nm)
                    g_up[r][nm] = self._shard(g, dim, r)
                    w_up[r][nm] = self._shard(full[r][nm], dim, r)
        names = set(self._shapes)
        for r in range(nl):
            init, update = self._opt_fns[r]
            state = _restrict(self._opt[r], names, set(g_up[r]))
            scale = self._hyper[r][2] if guard is None else \
                self._hyper[r][2] / guard[r][2]
            new_w, new_s = update(w_up[r], g_up[r], state, scale=scale)
            with torch.no_grad():
                _copy_tree(state, new_s, None if ok is None else ok[r])
                for nm, v in new_w.items():
                    _commit(w_up[r][nm], v, None if ok is None else ok[r])
        self._write_back(results, w_up, ok)
        if guard is not None:
            return gloss, ok[0]
        loss = self._mean_loss(losses)
        if not group.in_process and self._n > 1:
            loss = group.all_reduce([loss])[0] / self._n
        return loss

    @torch.no_grad()
    def _write_back(self, results, w_up, ok=None):
        """The updated shards all-gathered into the stored parameters, and
        the running statistics folded in (where `ok`, a guarded step's
        verdict per replica, holds)."""
        group, nl = self.group, len(self._local)
        for nm in self._shapes:
            dim = self._state_dim.get(nm)
            if dim is None or nm in self._param_dim or nm not in w_up[0]:
                continue
            for r, t in enumerate(group.all_gather(
                    [w_up[r][nm] for r in range(nl)], dim)):
                self._rparams[r][nm].copy_(t)
        for nm in results[0][2]:
            vals = [res[2][nm] for res in results]
            if not self._sync_bn and self._n > 1:
                vals = [v.float() / self._n for v in group.all_reduce(
                    [v.float() for v in vals])]
            for r, v in enumerate(vals):
                dst = self._rparams[r][nm]
                dim = self._param_dim.get(nm)
                _commit(dst, self._shard(v, dim, r).to(dst.dtype),
                        None if ok is None else ok[r])

    def step(self, batch, labels, rng_bits=None, guard=None,
             on_capture=None):
        """One step over the global batch (a process-group rank: its own
        rows); returns the mean loss, a device scalar.  A guarded step
        (module doc; `guard` holds one device vector [poison, spike
        threshold, loss scale] per local replica) returns (unscaled mean
        loss, ok), device scalars, and the step counter moves either
        way; `on_capture(program, seconds)` is told of a new program."""
        if rng_bits is not None:
            raise NotImplementedError(
                "rng_bits: the port's dropout draws from its generator "
                "(random.seed)")
        t0 = time.perf_counter()
        xs, ys = self._split(batch), self._split(labels)
        if not self._capture:
            self.eager_steps += 1
            out = self._body(xs, ys, guard)
        else:
            out = self._captured(xs[0], ys[0], guard, on_capture)
        self._n_step += 1
        if self._plan is not None:
            self._plan.invoke_cost_rows()
        _bb.record("step", "sharded", step=self._n_step - 1,
                   us=int((time.perf_counter() - t0) * 1e6))
        return out

    def _captured(self, x, y, guard=None, on_capture=None):
        """The one-replica step: eager at a signature's first call,
        captured at its second, replayed after.  A guarded step (`guard`
        the replica's device vector, written before each call) is a
        program of its own and returns (loss, ok); `on_capture(program,
        seconds)` is told of a new program."""
        sig = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
               guard is not None)
        prog = self._program
        if prog is not None and prog[0] == sig:
            _, program, sx, sy, out = prog
            with torch.no_grad():
                sx.copy_(x)
                sy.copy_(y)
            program.replay()
            self.replays += 1
            return _clone(out)
        if self._warm != sig:
            self._warm = sig
            self.eager_steps += 1
            return self._body([x], [y], guard)
        sx, sy = x.clone(), y.clone()
        t0 = time.perf_counter()
        program, out = _capture.capture(
            lambda: self._body([sx], [sy], guard), self._dev(0))
        self.captures += 1
        if on_capture is not None:
            on_capture(program, time.perf_counter() - t0)
        if not program.ran:
            program.replay()
        self._program = (sig, program, sx, sy, out)
        return _clone(out)

    # -- around the step ---------------------------------------------
    def device_feed(self, source, depth=None, transform=None):
        """An `io.DeviceFeed` placing each (batch, labels) pair's rows on
        the replicas while the current step runs; `step` takes what it
        yields as it is."""
        from ..io.device_feed import DeviceFeed
        return DeviceFeed(source, sharding=NamedSharding(
            self.mesh, P(self.batch_axis)), depth=depth, transform=transform)

    def sync_to_block(self):
        """Write the trained parameters into the Gluon block."""
        load_params(self.block, self.params)

    def serve(self, **kwargs):
        """`sync_to_block()`, then a `serving.InferenceEngine` over the
        block with one replica per mesh device (`devices=` overrides)."""
        from ..serving import InferenceEngine
        self.sync_to_block()
        kwargs.setdefault("devices", mesh_devices(self.mesh))
        return InferenceEngine(self.block, **kwargs)

    def release(self):
        """Drop the parameters, optimizer state and captured step; the
        trainer is unusable afterwards."""
        self._rparams = []
        self._opt = []
        self._program = None
        if self._dispatch is not None:
            self._dispatch.shutdown()

    # -- checkpoints -------------------------------------------------
    def save_checkpoint(self, path):
        """Write {params, opt_state, n_step} at global shapes, as host
        tensors, to `path`/checkpoint.pt (`path` a directory); returns
        that host tree (every rank of a process group gathers it, rank 0
        writes it)."""
        params, opt = self.params, self.opt_state
        tree = {"params": {n: v.detach().cpu() for n, v in params.items()},
                "opt_state": _map_named(opt, set(self._shapes),
                                        lambda n, v: v.detach().cpu()),
                "n_step": self._n_step}
        if not self.writer:
            return tree
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp.%d" % os.getpid())
        torch.save(tree, tmp)
        os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))
        return tree

    def load_checkpoint(self, path):
        """Restore a `save_checkpoint` onto this trainer's mesh and ZeRO
        level; a name, shape or dtype mismatch raises ValueError, a
        missing checkpoint FileNotFoundError."""
        f = os.path.join(path, CHECKPOINT_FILE)
        if not os.path.exists(f):
            raise FileNotFoundError("no checkpoint at %s" % path)
        tree = torch.load(f, map_location="cpu", weights_only=True)
        params = tree["params"]
        own = self.params
        if set(params) != set(own):
            raise ValueError(
                "checkpoint/trainer param name mismatch: only in "
                "checkpoint %s; only in trainer %s"
                % (sorted(set(params) - set(own))[:5],
                   sorted(set(own) - set(params))[:5]))
        for n, v in params.items():
            if tuple(v.shape) != tuple(own[n].shape):
                raise ValueError(
                    "checkpoint param %s has shape %s but trainer expects "
                    "%s" % (n, tuple(v.shape), tuple(own[n].shape)))
            if v.dtype != own[n].dtype:
                raise ValueError(
                    "checkpoint param %s has dtype %s but trainer expects "
                    "%s (mixed-precision config drift?)"
                    % (n, v.dtype, own[n].dtype))
        mine = self.opt_state
        if [tuple(t.shape) for t in _leaves(tree["opt_state"])] != \
                [tuple(t.shape) for t in _leaves(mine)]:
            raise ValueError("checkpoint at %s does not match this "
                             "trainer's optimizer state tree" % path)
        self._place_params(params)
        self.opt_state = tree["opt_state"]
        self._n_step = int(tree["n_step"])
