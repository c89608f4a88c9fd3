"""`shard_map` and the axis collectives of the PyTorch port: what the JAX
package takes from jax (`shard_map`, `lax.axis_index`, `lax.psum`,
`lax.pmean`, `lax.ppermute`, `lax.all_to_all`) for the bodies of
ring_attention.py, pipeline.py and moe.py.

``shard_map(fn, mesh, in_specs, out_specs)(*args)`` splits each tensor
argument along the dimensions its `P` spec names (an argument that is a
dict, list or tuple of tensors takes its spec for every leaf), places
each replica's piece on that replica's device, runs `fn` once per
replica and reassembles the outputs by their specs: a named dimension is
concatenated over its mesh axis, and `P()` (replicated) takes replica
0's value.  Inside `fn`, `axis_index(name)` and `axis_size(name)` are
Python ints and the collectives have jax's semantics:

* `psum(x, name)` sums over the axis (`psum(1, name)` is its size), in
  f32 for bf16/f16 tensors, rounded once; `pmean` divides by the size;
* `ppermute(x, name, perm)` sends each replica's `x` along the
  (source, destination) pairs of `perm`; a replica that receives
  nothing gets zeros;
* `all_to_all(x, name, split_axis, concat_axis, tiled)` splits `x` into
  axis-size chunks along `split_axis` (untiled: that dimension is the
  axis size and is removed), sends chunk j to replica j, and joins what
  it receives, in source order, along `concat_axis` (untiled: a new
  dimension there).

`run_replicas(fn, mesh)` runs `fn` as each replica's body without
splitting or assembling anything (`ShardedTrainer`'s tensor-parallel
step, whose layers issue the collectives of `tensor_parallel`: "tp_copy"
and "tp_sum", Megatron's f and g, and "gather" and "split" along a
dimension).

Gradients flow through every collective: each is a
`torch.autograd.Function` whose backward is the transposed collective
(psum of the cotangents, `ppermute` by the inverse permutation,
`all_to_all` with split and concat swapped).  A replicated output takes
replica 0's value, so the transposed psum hands its cotangent to every
replica, as jax transposes a psum into a replicated output.

Two forms:

* **in-process** (a `Mesh` of replica contexts): one thread per
  replica, from the calling thread's `DispatchPool` (`lockstep`).  Each collective is ONE autograd node over every replica's
  tensor: the threads meet at the collective, the last to arrive
  applies the `Function` to all n inputs, and each takes its own
  output.  The node's backward then gets every replica's cotangent at
  once and meets nobody, which matters because torch runs the CPU
  nodes of a backward on one thread: a collective whose backward
  waited for the other replicas' backward would deadlock there.
  Replicas that share a device run in turn between collectives (each
  holds its device's lock while it computes).  Each thread takes the
  caller's grad mode and `autograd` recording and training state, and
  a body that raises breaks the meeting, so the other threads raise
  instead of waiting.
* **process group** (`mesh.process_mesh()`): one body per rank; each
  rank passes the global arguments and takes its own slice; sums by
  `dist.all_reduce`, `ppermute` by `dist.batch_isend_irecv`,
  `all_to_all` by `dist.all_to_all_single`, each on the subgroup of its
  axis (`mesh.axis_group`; the default group on a one-axis mesh) and on
  the backend of its tensors' device (gloo for host tensors, NCCL for
  card tensors).  An
  output's named dimensions are all-gathered, so every rank holds the
  global value; its gradient is this rank's slice of the cotangent.  A
  replicated output is each rank's own, and only rank 0's cotangent
  flows back through it, as only replica 0's does in-process: every
  rank computing the same loss then gives the in-process gradients.
  Every rank's backward must run its collectives in one order, so a
  body is one program on every rank: it selects by `axis_index`
  (`torch.where`) rather than branching on it, as the JAX bodies do.
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

from .. import autograd as _ag
from .collectives import LOW_PRECISION, _ordered_sum
from .dispatch import DispatchPool
from .mesh import Mesh, P, axis_group, make_mesh

__all__ = ["shard_map", "axis_index", "axis_size", "psum", "pmean",
           "ppermute", "all_to_all", "run_replicas"]

_LOCAL = threading.local()


def _ctx():
    ctx = getattr(_LOCAL, "ctx", None)
    if ctx is None:
        raise RuntimeError("axis collectives run inside a shard_map body")
    return ctx


def _host(d):
    """The torch device a replica context's tensors live on."""
    return torch.device("cpu") if d.type == "cpu" else d


class _Axes:
    """The mesh geometry a body sees: axis sizes, each replica's
    coordinates, and the groups a named axis partitions the replicas
    into."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = tuple(mesh.axis_names)
        self.sizes = dict(zip(self.names, mesh.devices.shape))
        self.coords = [dict(zip(self.names, idx))
                       for idx in _np.ndindex(*mesh.devices.shape)]
        self.n = len(self.coords)

    def _check(self, name):
        if name not in self.sizes:
            raise ValueError("no mesh axis %r (axes %s)" % (name, self.names))

    def group(self, name, r):
        """The replicas of `r`'s group along `name`, by axis index."""
        self._check(name)
        me = self.coords[r]
        members = [s for s, c in enumerate(self.coords)
                   if all(c[a] == me[a] for a in self.names if a != name)]
        return sorted(members, key=lambda s: self.coords[s][name])


class _Ctx:
    """One replica's view inside the body."""

    def __init__(self, axes, r, meet):
        self.axes, self.r, self.meet = axes, r, meet

    def index(self, name):
        self.axes._check(name)
        return int(self.axes.coords[self.r][name])

    def size(self, name):
        self.axes._check(name)
        return int(self.axes.sizes[name])


def axis_index(name) -> int:
    """This replica's index along mesh axis `name`."""
    return _ctx().index(name)


def axis_size(name) -> int:
    """The size of mesh axis `name`."""
    return _ctx().size(name)


# -- the collectives as linear maps over the replicas ------------------

def _sum(ts, dev):
    return _ordered_sum(list(ts), dev)


def _apply_op(op, name, args, xs, devs, axes):
    """The collective `op` over the n replicas' tensors `xs` (each on its
    replica's device `devs[r]`): one output per replica."""
    out = [None] * len(xs)
    done = set()
    for r in range(len(xs)):
        if r in done:
            continue
        members = axes.group(name, r)
        done.update(members)
        vals = [xs[s] for s in members]
        if op in ("psum", "tp_sum"):
            total = _sum(vals, devs[members[0]])
            for s in members:
                out[s] = total.to(devs[s], copy=True)
            continue
        for i, s in enumerate(members):
            out[s] = _group_op(op, args, vals, i, devs[s])
    return out


def _group_op(op, args, vals, i, dev):
    """Member i's output of `op` over its group's tensors `vals`."""
    n = len(vals)
    if op == "tp_copy":
        return vals[i].clone()
    if op == "gather":
        return torch.cat([v.to(dev) for v in vals], args[0])
    if op == "split":
        span = vals[i].shape[args[0]] // n
        return vals[i].narrow(args[0], i * span, span).clone()
    if op == "ppermute":
        src = [s for s, d in args[0] if d == i]
        if not src:
            return torch.zeros_like(vals[i])
        return vals[src[0]].to(dev, copy=True)
    if op == "all_to_all":
        split_axis, concat_axis, tiled = args
        return _a2a_assemble([_a2a_chunk(v, i, n, split_axis, tiled)
                              .to(dev) for v in vals], concat_axis, tiled)
    raise ValueError(op)


def _a2a_chunk(x, j, n, split_axis, tiled):
    """Chunk j of `x` for an all_to_all over n replicas."""
    if tiled:
        span = x.shape[split_axis] // n
        return x.narrow(split_axis, j * span, span)
    if x.shape[split_axis] != n:
        raise ValueError("all_to_all(tiled=False): dimension %d has size "
                         "%d, not the axis size %d"
                         % (split_axis, x.shape[split_axis], n))
    return x.select(split_axis, j)


def _a2a_assemble(chunks, concat_axis, tiled):
    return torch.cat(chunks, concat_axis) if tiled else \
        torch.stack(chunks, concat_axis)


#: the tensor-parallel collectives (`parallel.tensor_parallel`) and the
#: ones their backwards run: "tp_copy" is the identity whose transpose
#: sums over the axis, "tp_sum" the sum whose transpose is the identity
#: (Megatron's f and g: every replica of the axis holds the same loss),
#: "gather" concatenates the axis's pieces along a dimension and
#: "split" takes this replica's piece of it
_TP_TRANSPOSE = {"tp_copy": "tp_sum", "tp_sum": "tp_copy",
                 "gather": "split", "split": "gather"}


def _transpose(op, args):
    """(op, args) of the transposed collective."""
    if op in _TP_TRANSPOSE:
        return _TP_TRANSPOSE[op], args
    if op == "ppermute":
        return op, ([(d, s) for s, d in args[0]],)
    if op == "all_to_all":
        split_axis, concat_axis, tiled = args
        return op, (concat_axis, split_axis, tiled)
    return op, args


class _Collective(torch.autograd.Function):
    """One collective over every replica's tensor (in-process form)."""

    @staticmethod
    def forward(ctx, op, name, args, axes, devs, *xs):
        ctx.spec = (op, name, args, axes, devs)
        return tuple(_apply_op(op, name, args, list(xs), devs, axes))

    @staticmethod
    def backward(ctx, *cts):
        op, name, args, axes, devs = ctx.spec
        top, targs = _transpose(op, args)
        return (None,) * 5 + tuple(_apply_op(top, name, targs, cts, devs,
                                             axes))


class _Meeting:
    """The in-process rendezvous of one shard_map call: every replica
    deposits its tensor, the last to arrive applies the collective, and
    each takes its output."""

    def __init__(self, axes, devs):
        self.axes, self.devs = axes, devs
        n = axes.n
        self.slots = [None] * n
        self.out = None
        self.error = None
        self.barrier = threading.Barrier(n, action=self._apply)
        self.locks = {}
        for d in devs:
            self.locks.setdefault(d, threading.Lock())

    def _apply(self):
        specs = {s[:3] for s in self.slots}
        if len(specs) != 1:
            self.error = RuntimeError(
                "shard_map replicas called different collectives at one "
                "point: %s" % sorted(str(s[:2]) for s in specs))
            raise self.error
        op, name, args = self.slots[0][:3]
        xs = [s[3] for s in self.slots]
        self.out = _Collective.apply(op, name, args, self.axes, self.devs,
                                     *xs)

    def collective(self, r, op, name, args, x):
        self.slots[r] = (op, name, args, x)
        lock = self.locks[self.devs[r]]
        lock.release()
        try:
            self.barrier.wait()
        finally:
            lock.acquire()
        return self.out[r]

    def abort(self):
        """Break the meeting: replicas waiting at it raise
        `threading.BrokenBarrierError` (`DispatchPool.lockstep`)."""
        self.barrier.abort()

    def reset(self):
        self.barrier.reset()


class _ProcessFn(torch.autograd.Function):
    """One collective of this rank in the process-group form, over `grp`
    ((torch.distributed group, its global ranks in axis order))."""

    @staticmethod
    def forward(ctx, op, args, grp, x):
        ctx.spec = (op, args, grp)
        return _process_op(op, args, grp, x)

    @staticmethod
    def backward(ctx, ct):
        op, args, grp = ctx.spec
        top, targs = _transpose(op, args)
        return None, None, None, _process_op(top, targs, grp,
                                             ct.contiguous())


def _process_op(op, args, grp, x):
    import torch.distributed as dist
    group, ranks = grp
    n, me = len(ranks), ranks.index(dist.get_rank())
    if op in ("psum", "tp_sum"):
        acc = (x.float() if x.dtype in LOW_PRECISION else x).clone()
        dist.all_reduce(acc, group=group)
        return acc.to(x.dtype)
    if op == "tp_copy":
        return x.view_as(x)
    if op == "gather":
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, args[0])
    if op == "split":
        span = x.shape[args[0]] // n
        return x.narrow(args[0], me * span, span).contiguous()
    if op == "ppermute":
        perm = args[0]
        ops, recv = [], None
        for s, d in perm:
            if s == me and d == me:
                recv = x.clone()
            elif s == me:
                ops.append(dist.P2POp(dist.isend, x.contiguous(), ranks[d],
                                      group=group))
            elif d == me:
                recv = torch.empty_like(x)
                ops.append(dist.P2POp(dist.irecv, recv, ranks[s],
                                      group=group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return torch.zeros_like(x) if recv is None else recv
    if op == "all_to_all":
        split_axis, concat_axis, tiled = args
        chunks = [_a2a_chunk(x, j, n, split_axis, tiled).contiguous()
                  for j in range(n)]
        send = torch.cat([c.reshape(-1) for c in chunks])
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        got = [p.reshape(chunks[0].shape)
               for p in recv.split(chunks[0].numel())]
        return _a2a_assemble(got, concat_axis, tiled)
    raise ValueError(op)


def _collective(op, name, args, x):
    ctx = _ctx()
    if isinstance(ctx.meet, _Meeting):
        return ctx.meet.collective(ctx.r, op, name, args, x)
    ctx.axes._check(name)
    return _ProcessFn.apply(op, args, axis_group(ctx.axes.mesh, name, ctx.r),
                            x)


def psum(x, axis_name):
    """The sum of `x` over mesh axis `axis_name` (a Python number: times
    the axis size)."""
    if not isinstance(x, torch.Tensor):
        return x * axis_size(axis_name)
    return _collective("psum", axis_name, (), x)


def pmean(x, axis_name):
    """The mean of `x` over mesh axis `axis_name`."""
    n = axis_size(axis_name)
    if not isinstance(x, torch.Tensor):
        return x
    return psum(x, axis_name) / n


def ppermute(x, axis_name, perm):
    """`x` sent along the (source, destination) axis-index pairs of
    `perm`; zeros where nothing is received."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if len({d for _, d in perm}) != len(perm):
        raise ValueError("ppermute: a destination appears twice in %r"
                         % (perm,))
    return _collective("ppermute", axis_name, (perm,), x)


def all_to_all(x, axis_name, split_axis, concat_axis, tiled=False):
    """jax's `lax.all_to_all` (module doc)."""
    nd = x.dim()
    split_axis, concat_axis = split_axis % nd, concat_axis % nd
    return _collective("all_to_all", axis_name,
                       (int(split_axis), int(concat_axis), bool(tiled)), x)


# -- shard_map ---------------------------------------------------------

def _leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_leaves(v, fn) for v in tree)
    return fn(tree)


def _norm_specs(specs, n):
    if isinstance(specs, P) or specs is None:
        return (specs,) * n if n != 1 else (specs,)
    return tuple(specs)


def _piece(t, spec, coord, sizes):
    """Replica `coord`'s slice of global tensor `t` by `spec`."""
    if not isinstance(t, torch.Tensor) or not spec:
        return t
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n, i = 1, 0
        for a in axes:
            i = i * sizes[a] + coord[a]
            n *= sizes[a]
        if t.shape[dim] % n:
            raise ValueError("dimension %d of size %d does not split over "
                             "mesh axes %s of size %d"
                             % (dim, t.shape[dim], axes, n))
        span = t.shape[dim] // n
        t = t.narrow(dim, i * span, span)
    return t


def _assemble(pieces, spec, axes, dev):
    """The global value from per-replica outputs by `spec`."""
    if not isinstance(pieces[0], torch.Tensor):
        return pieces[0]
    spec = tuple(spec or ())
    named = [(d, a) for d, a in enumerate(spec) if a is not None]
    for _, a in named:
        if isinstance(a, tuple):
            raise NotImplementedError("an out_spec dimension over several "
                                      "mesh axes")
    by = {tuple(sorted(c.items())): r for r, c in enumerate(axes.coords)}

    def rec(k, coord):
        if k == len(named):
            full = {a: coord.get(a, 0) for a in axes.names}
            return pieces[by[tuple(sorted(full.items()))]].to(dev)
        d, a = named[k]
        return torch.cat([rec(k + 1, dict(coord, **{a: i}))
                          for i in range(axes.sizes[a])], d)
    return rec(0, {})


def _tree_map2(fn, tree, specs):
    """fn(leaf, spec) over the leaves of `tree`, `specs` a spec or a tree
    of specs of `tree`'s shape."""
    if isinstance(specs, P) or specs is None:
        return _leaves(tree, lambda t: fn(t, specs))
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, tree[k], specs[k]) for k in tree}
    return type(tree)(_tree_map2(fn, t, s) for t, s in zip(tree, specs))


def _flatten(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(like, flat):
    it = iter(flat)

    def rec(t):
        if isinstance(t, dict):
            return {k: rec(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rec(v) for v in t)
        return next(it)
    return rec(like)


def _spec_leaves(out, specs):
    """One spec per output leaf."""
    if isinstance(specs, P) or specs is None:
        return [specs] * len(_flatten(out))
    if isinstance(out, dict):
        return [s for k in out for s in _spec_leaves(out[k], specs[k])]
    if isinstance(out, (list, tuple)):
        return [s for o, sp in zip(out, specs) for s in _spec_leaves(o, sp)]
    return [specs]


class _Rank0(torch.autograd.Function):
    """A replicated output (process form): the identity, whose gradient
    is rank 0's cotangent (zeros on the other ranks)."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist
        ctx.first = dist.get_rank() == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct if ctx.first else torch.zeros_like(ct)


class _Gather(torch.autograd.Function):
    """A rank's output slice all-gathered along `dim` over `grp` (its
    axis's group and ranks; process form); its gradient is this rank's
    slice of the cotangent."""

    @staticmethod
    def forward(ctx, x, dim, grp):
        import torch.distributed as dist
        group, ranks = grp
        ctx.dim = dim
        ctx.index = ranks.index(dist.get_rank())
        ctx.span = x.shape[dim]
        parts = [torch.empty_like(x) for _ in ranks]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, ct):
        return ct.narrow(ctx.dim, ctx.index * ctx.span, ctx.span), None, \
            None


def shard_map(fn, mesh: Mesh = None, in_specs=None, out_specs=None):
    """`fn` mapped over the replicas of `mesh` (module doc); `mesh=None`
    is `make_mesh()`, every card (which raises without one unless inside
    `with cpu():`)."""
    if mesh is None:
        mesh = make_mesh()

    def mapped(*args):
        specs = _norm_specs(in_specs, len(args))
        if len(specs) != len(args):
            raise ValueError("shard_map: %d in_specs for %d arguments"
                             % (len(specs), len(args)))
        axes = _Axes(mesh)
        if not mesh.in_process:
            return _run_process(fn, mesh, axes, args, specs, out_specs)
        return _run_threads(fn, mesh, axes, args, specs, out_specs)
    mapped.__name__ = getattr(fn, "__name__", "shard_map")
    return mapped


def _pool(devs):
    """This thread's `DispatchPool` over `devs`: one per calling thread,
    so that a body that calls shard_map, or two threads that call it at
    once, never wait on each other's replica threads."""
    pools = getattr(_LOCAL, "pools", None)
    if pools is None:
        pools = _LOCAL.pools = {}
    key = tuple(devs)
    if key not in pools:
        pools[key] = DispatchPool(devs)
    return pools[key]


def _run_threads(fn, mesh, axes, args, specs, out_specs):
    from ..context import _norm
    devs = [_host(_norm(d)) for d in mesh.devices.flat]
    per = [[_tree_map2(lambda t, s, r=r: _place(
        _piece(t, s, axes.coords[r], axes.sizes), devs[r]), a, sp)
        for a, sp in zip(args, specs)] for r in range(axes.n)]
    results = _threads(lambda r: fn(*per[r]), axes, devs)
    outs = results[0]
    flat = [_flatten(o) for o in results]
    spec_l = _spec_leaves(outs, out_specs)
    return _unflatten(outs, [
        _assemble([f[i] for f in flat], spec_l[i], axes, devs[0])
        for i in range(len(flat[0]))])


def run_replicas(fn, mesh: Mesh):
    """[fn(i) for each replica i of `mesh` that this process drives],
    each inside a body's context, so that the axis collectives work: in
    one process a thread per replica as in `shard_map`, i being the
    replica's index; over a `process_mesh` this rank's one, called with
    0.  The caller places each replica's inputs."""
    from ..context import _norm
    axes = _Axes(mesh)
    if not mesh.in_process:
        import torch.distributed as dist
        r = dist.get_rank()
        return [_in_body(axes, r, None, _host(_norm(mesh.devices.flat[r])),
                         lambda: fn(0))]
    return _threads(fn, axes, [_host(_norm(d)) for d in mesh.devices.flat])


def _in_body(axes, r, meet, dev, call):
    """`call()` as replica r inside its body's context (the process
    form's; the threads set their own)."""
    prev = getattr(_LOCAL, "ctx", None)
    _LOCAL.ctx = _Ctx(axes, r, meet)
    try:
        with _device_scope(dev):
            return call()
    finally:
        _LOCAL.ctx = prev


def _threads(fn, axes, devs):
    """[fn(r) for every replica r], a thread each, meeting at each
    collective (module doc)."""
    meet = _Meeting(axes, devs)
    grad, rec, train = torch.is_grad_enabled(), _ag.is_recording(), \
        _ag.is_training()

    def run(r):
        lock = meet.locks[devs[r]]
        lock.acquire()
        prev = getattr(_LOCAL, "ctx", None)
        _LOCAL.ctx = _Ctx(axes, r, meet)
        prev_rec, prev_train = _ag.set_recording(rec), _ag.set_training(train)
        try:
            with torch.set_grad_enabled(grad), _device_scope(devs[r]):
                return fn(r)
        finally:
            _ag.set_recording(prev_rec)
            _ag.set_training(prev_train)
            _LOCAL.ctx = prev
            lock.release()
    return _pool(devs).lockstep(run, meet)


def _place(t, dev):
    return t.to(dev) if isinstance(t, torch.Tensor) else t


class _device_scope:
    """`torch.cuda.device(dev)` for a card, nothing for the CPU."""

    def __init__(self, dev):
        self.cm = torch.cuda.device(dev) if dev.type == "cuda" else None

    def __enter__(self):
        if self.cm is not None:
            self.cm.__enter__()

    def __exit__(self, *exc):
        if self.cm is not None:
            self.cm.__exit__(*exc)


def _run_process(fn, mesh, axes, args, specs, out_specs):
    import torch.distributed as dist
    from ..context import _norm
    r = dist.get_rank()
    dev = _host(_norm(mesh.devices.flat[r]))
    mine = [_tree_map2(lambda t, s: _place(_piece(t, s, axes.coords[r],
                                                  axes.sizes), dev), a, sp)
            for a, sp in zip(args, specs)]
    out = _in_body(axes, r, None, dev, lambda: fn(*mine))
    flat = _flatten(out)
    spec_l = _spec_leaves(out, out_specs)
    gathered = []
    for t, spec in zip(flat, spec_l):
        if isinstance(t, torch.Tensor):
            named = [(d, a) for d, a in enumerate(tuple(spec or ()))
                     if a is not None]
            if not named:
                t = _Rank0.apply(t)
            for d, a in named:
                t = _Gather.apply(t, d, axis_group(mesh, a, r))
        gathered.append(t)
    return _unflatten(out, gathered)
