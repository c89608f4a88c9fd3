"""The sharded training step of the PyTorch port (counterpart of
incubator_mxnet_tpu/parallel/trainer.py).

`ShardedTrainer` trains a Gluon block data-parallel over the replicas of
a `Mesh` (in-process: one process drives every replica) or over the
ranks of a `torch.distributed` group (one replica per process), through
`parallel.collectives`.  Each replica holds its own copy of the
parameters, keyed by the block's structural `collect_params()` names
(`params`), and of the optimizer state; the block itself is read once
and written by `sync_to_block()`.

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

Capture: with one replica the whole step (forward, backward, update) is
one program of `graph_capture.capture`, a CUDA graph on the card: the
first step of a batch signature runs eagerly, the second captures, the
later ones copy the batch into the program's static inputs and replay
(`captures`, `replays`, `eager_steps` count them).  A step over several
in-process replicas runs uncaptured.

Checkpoints are `torch.save` files of host tensors (`checkpoint.pt` in
the directory `path`) holding the tree {params, opt_state, n_step} at
global shapes, where the JAX package writes an orbax checkpoint; they
restore onto a mesh of another size and another ZeRO level.
"""
from __future__ import annotations

import os
import time
from typing import Optional

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
from .mesh import Mesh, NamedSharding, P, Shards, make_mesh, mesh_devices
from .zero import BucketPlan, overlap_schedule, record_plan, \
    zero_level_default

__all__ = ["ShardedTrainer", "softmax_ce_loss", "sgd_momentum_tree",
           "adam_tree"]

_CKPT = "checkpoint.pt"


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


def _copy_tree(dst, src):
    """Write `src` into `dst` in place, leaf by leaf (the same
    structure; a parameter-keyed dict of `src` may hold a subset)."""
    if isinstance(dst, dict):
        for k, v in src.items():
            _copy_tree(dst[k], v)
    else:
        dst.copy_(src)


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
        a `with cpu():`).
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
        if mesh is None and dist.is_initialized():
            if device is None:
                device = torch.device(
                    "cuda", dist.get_rank() % torch.cuda.device_count()) \
                    if torch.cuda.is_available() else current_device()
            self.mesh = make_mesh(devices=[device])
            self.group = _coll.ProcessReplicaGroup(device)
        else:
            if mesh is None:
                mesh = make_mesh(devices=[device]) if device is not None \
                    else make_mesh()
            self.mesh = mesh
            if any(size > 1 for ax, size in mesh.shape.items()
                   if ax != batch_axis):
                raise NotImplementedError(
                    "a mesh axis other than %r of size > 1 (tensor "
                    "parallelism) is not ported" % batch_axis)
            self.group = _coll.ReplicaGroup(mesh_devices(mesh))
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
        if param_spec_fn is not None:
            specs = {n: param_spec_fn(n, tuple(v.shape))
                     for n, v in extract_params(block).items()}
            if any(any(a is not None for a in s) for s in specs.values()):
                raise NotImplementedError(
                    "param_spec_fn with a sharded spec (tensor "
                    "parallelism) is not ported")
        self._local = list(self.group.local)
        self._n = self.group.size
        self._optimizer = optimizer
        self._momentum = momentum
        self.captures = self.replays = self.eager_steps = 0
        self._n_step = 0
        self._dispatch = DispatchPool(self._local) \
            if self.group.in_process else None
        self._sync_bn = self.zero <= 1 and self._n > 1
        cards = [d for d in self._local if d.type == "cuda"]
        if self._sync_bn and len(set(cards)) < len(cards):
            raise ValueError(
                "zero=%d sums BatchNorm statistics across replicas in the "
                "middle of the backward, which replicas sharing a card "
                "cannot do (their backwards run on one autograd thread); "
                "use one replica per card, or zero>=2" % self.zero)
        self._capture = self._n == 1
        self._names = list(block.collect_params().keys())
        self._stateful = {n for n, p in block.collect_params().items()
                          if not p.requires_grad}
        self._shells = [block] + [replica_shell(block)
                                  for _ in self._local[1:]]
        self._fwd = [functionalize(b, training=True) for b in self._shells]
        self._hyper = [torch.tensor([lr, wd, 1.0 / self._n],
                                    dtype=torch.float32, device=self._dev(r))
                       for r in range(len(self._local))]
        self._opt_fns = [self._make_opt(h) for h in self._hyper]
        self._opt_init = self._opt_fns[0][0]
        full = {n: v.detach().clone()
                for n, v in extract_params(block).items()}
        self._build_layout({n: tuple(v.shape) for n, v in full.items()})
        self._place_params(full)
        self.opt_state = self._opt_fns[0][0](full)

    # -- layout ------------------------------------------------------
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
        stored value (zero 3) are sharded along, or None."""
        n = self._n
        self._plan = None
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
                    if d % n == 0 and d >= n:
                        self._state_dim[name] = i
                        break
        self._param_dim = dict(self._state_dim) if self.zero >= 3 else {}
        self._shapes = dict(shapes)

    def _shard(self, value, dim, r):
        """Local replica r's shard of a global `value` along `dim`."""
        if dim is None:
            return value
        span = value.shape[dim] // self._n
        return value.narrow(dim, (self.group.rank_offset + r) * span, span)

    def _place_params(self, full):
        """Store global `full` ({name: tensor}) on every local replica as
        the level says (zero 3: solo parameters as shards)."""
        self._rparams = [
            {nm: self._shard(v, self._param_dim.get(nm), r)
             .to(self._dev(r), copy=True).contiguous()
             for nm, v in full.items()}
            for r in range(len(self._local))]
        self._program = self._warm = None

    def _gather(self, per_replica, dims):
        """Global {name: tensor} from local replica shards (host side for
        checkpoints and `params`; a process-group rank gathers from the
        other ranks)."""
        out = {}
        for nm, v in per_replica[0].items():
            dim = dims.get(nm)
            if dim is None:
                out[nm] = v
            elif self.group.in_process:
                out[nm] = torch.cat([p[nm].to(v.device)
                                     for p in per_replica], dim)
            else:
                out[nm] = self.group.all_gather([v], dim)[0]
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
                v, None if nm is None else self._state_dim.get(nm), r))
            for r in range(len(self._local))]
        self._program = self._warm = None

    def _place_leaf(self, v, dim, r):
        v = torch.as_tensor(v)
        return self._shard(v, dim, r).to(self._dev(r), copy=True) \
            .contiguous()

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

    def _replica_grads(self, r, x, y, params):
        """Loss, {name: gradient} and running-statistic updates of local
        replica r over its rows."""
        if self._preprocess is not None:
            x = self._preprocess(x)
        leaves = {n: (v.detach().requires_grad_(True)
                      if n not in self._stateful else v)
                  for n, v in params.items()}
        with torch.enable_grad():
            out, states = self._fwd[r](leaves, x)
            loss = self.loss_fn(out, y)
            train = [n for n in self._names if n not in self._stateful]
            grads = torch.autograd.grad(loss, [leaves[n] for n in train],
                                        allow_unused=True)
        return loss.detach(), {
            n: torch.zeros_like(leaves[n]) if g is None else g
            for n, g in zip(train, grads)}, states

    def _forward_backward(self, xs, ys, full):
        """Per local replica (loss, grads, states), in lockstep when
        BatchNorm's statistics span the replicas."""
        def one(r):
            return self._replica_grads(r, xs[r], ys[r], full[r])

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

    def _body(self, xs, ys):
        """One step on the local replicas' rows; returns the mean loss
        (on replica 0's device)."""
        group, nl = self.group, len(self._local)
        plan = self._plan
        full = self._rparams
        if self._param_dim:
            full = plan.gather_params(group, self._rparams)
        results = self._forward_backward(xs, ys, full)
        losses = [res[0] for res in results]
        grads = [res[1] for res in results]
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
            new_w, new_s = update(w_up[r], g_up[r], state,
                                  scale=self._hyper[r][2])
            with torch.no_grad():
                _copy_tree(state, new_s)
                for nm, v in new_w.items():
                    w_up[r][nm].copy_(v)
        self._write_back(results, w_up)
        loss = losses[0] if nl == 1 else torch.stack(
            [l.to(self._dev(0)) for l in losses]).mean()
        if not group.in_process and self._n > 1:
            loss = group.all_reduce([loss])[0] / self._n
        return loss

    @torch.no_grad()
    def _write_back(self, results, w_up):
        """The updated shards all-gathered into the stored parameters, and
        the running statistics folded in."""
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
                dst.copy_(self._shard(v, dim, r).to(dst.dtype))

    def step(self, batch, labels, rng_bits=None):
        """One step over the global batch (a process-group rank: its own
        rows); returns the mean loss, a device scalar."""
        if rng_bits is not None:
            raise NotImplementedError(
                "rng_bits: the port's dropout draws from its generator "
                "(random.seed)")
        t0 = time.perf_counter()
        xs, ys = self._split(batch), self._split(labels)
        if not self._capture:
            self.eager_steps += 1
            loss = self._body(xs, ys)
        else:
            loss = self._captured(xs[0], ys[0])
        self._n_step += 1
        if self._plan is not None:
            self._plan.invoke_cost_rows()
        _bb.record("step", "sharded", step=self._n_step - 1,
                   us=int((time.perf_counter() - t0) * 1e6))
        return loss

    def _captured(self, x, y):
        """The one-replica step: eager at a signature's first call,
        captured at its second, replayed after."""
        sig = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype)
        prog = self._program
        if prog is not None and prog[0] == sig:
            _, program, sx, sy, sloss = prog
            with torch.no_grad():
                sx.copy_(x)
                sy.copy_(y)
            program.replay()
            self.replays += 1
            return sloss.clone()
        if self._warm != sig:
            self._warm = sig
            self.eager_steps += 1
            return self._body([x], [y])
        sx, sy = x.clone(), y.clone()
        program, sloss = _capture.capture(lambda: self._body([sx], [sy]),
                                          self._dev(0))
        self.captures += 1
        if not program.ran:
            program.replay()
        self._program = (sig, program, sx, sy, sloss)
        return sloss.clone()

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
        tensors, to `path`/checkpoint.pt (`path` a directory)."""
        params, opt = self.params, self.opt_state
        tree = {"params": {n: v.detach().cpu() for n, v in params.items()},
                "opt_state": _map_named(opt, set(self._shapes),
                                        lambda n, v: v.detach().cpu()),
                "n_step": self._n_step}
        if not self.group.in_process and self.group.rank_offset != 0:
            return
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, _CKPT + ".tmp.%d" % os.getpid())
        torch.save(tree, tmp)
        os.replace(tmp, os.path.join(path, _CKPT))

    def load_checkpoint(self, path):
        """Restore a `save_checkpoint` onto this trainer's mesh and ZeRO
        level; a name, shape or dtype mismatch raises ValueError, a
        missing checkpoint FileNotFoundError."""
        f = os.path.join(path, _CKPT)
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
