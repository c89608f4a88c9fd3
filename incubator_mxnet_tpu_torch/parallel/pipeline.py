"""Pipeline parallelism of the PyTorch port (counterpart of
incubator_mxnet_tpu/parallel/pipeline.py): the GPipe schedule over a
mesh axis.

Every stage lives on one replica of the `pipe` axis; all stages compute
at once on different microbatches, and activations hop stage to stage
by one `spmd.ppermute` per step: S + M - 1 steps for S stages and M
microbatches, a bubble of (S - 1)/(S + M - 1).  The backward is
autograd's: the transpose of a `ppermute` is the reverse one, so the
reverse schedule is derived, not written.

`stage_fn(stage_params, x) -> y` must keep the activation's shape and
dtype (transformer-block stages): the hop buffer is one shape across
stages.  The check runs `stage_fn` on meta tensors before any step.
"""
from __future__ import annotations

import torch

from . import spmd
from .mesh import mark_varying, squeeze_stage_axis

__all__ = ["pipeline_apply", "split_microbatches", "stack_stage_params"]


def split_microbatches(x, n_microbatches):
    """(B, ...) -> (M, B/M, ...), the microbatch axis of
    `pipeline_apply`."""
    B = x.shape[0]
    if B % n_microbatches:
        raise ValueError("batch %d not divisible into %d microbatches"
                         % (B, n_microbatches))
    return x.reshape((n_microbatches, B // n_microbatches)
                     + tuple(x.shape[1:]))


def stack_stage_params(per_stage_params):
    """[stage0 tree, stage1 tree, ...] -> one tree with a leading stage
    axis; shard it with P('pipe') so that shard_map hands each replica
    its own stage's slice."""
    first = per_stage_params[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage_params])
                for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params([p[i] for p in
                                               per_stage_params])
                           for i in range(len(first)))
    return torch.stack(list(per_stage_params))


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_meta(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree


def pipeline_apply(stage_fn, stage_params, x_mb, axis_name):
    """Run the pipeline inside a shard_map body.

    stage_params: this replica's stage parameters (a stacked tree
        sharded P('pipe') arrives with a leading axis of size 1, which
        is squeezed here).
    x_mb: (M, mb, ...) microbatches, replicated across the pipe axis.
    Returns the (M, mb, ...) outputs, replicated (the last stage's,
    masked and summed over the axis)."""
    n_stages = spmd.psum(1, axis_name)
    idx = spmd.axis_index(axis_name)
    M = x_mb.shape[0]
    params = squeeze_stage_axis(stage_params)

    with torch.no_grad():
        out_meta = stage_fn(_meta(params), torch.empty(
            tuple(x_mb.shape[1:]), dtype=x_mb.dtype, device="meta"))
    if tuple(out_meta.shape) != tuple(x_mb.shape[1:]):
        raise ValueError("stage_fn must preserve activation shape, got %s "
                         "-> %s" % (tuple(x_mb.shape[1:]),
                                    tuple(out_meta.shape)))

    n_steps = n_stages + M - 1
    # partial permutation: stage 0 always takes the next microbatch, so
    # the last -> 0 hop would be a dead transfer; ppermute zero-fills it
    perm = [(i, i + 1) for i in range(n_stages - 1)]
    # the carries become per-replica values (the JAX body tags them for
    # shard_map's type system; here the tag is the identity)
    state = mark_varying(torch.zeros(tuple(x_mb.shape[1:]),
                                     dtype=x_mb.dtype, device=x_mb.device),
                         axis_name)
    outs = [mark_varying(torch.zeros(tuple(out_meta.shape),
                                     dtype=out_meta.dtype,
                                     device=x_mb.device), axis_name)
            for _ in range(M)]
    # one program on every replica (selects, not branches on the
    # replica's index), so that the backward's collectives run in the
    # same order on every rank of a process group
    first = torch.tensor(idx == 0, device=x_mb.device)
    last = torch.tensor(idx == n_stages - 1, device=x_mb.device)
    for t in range(n_steps):
        # stage 0 takes microbatch t (clipped: steps past M feed a repeat
        # that never reaches the output window)
        cur = torch.where(first, x_mb[min(t, M - 1)], state)
        y = stage_fn(params, cur)
        # the last stage emits microbatch t - (S - 1) at step t
        pos = t - (n_stages - 1)
        if pos >= 0:
            outs[pos] = y
        state = spmd.ppermute(y, axis_name, perm)
    stacked = torch.stack(outs)
    # only the last stage holds real outputs: mask and sum to replicate
    stacked = torch.where(last, stacked, torch.zeros_like(stacked))
    return spmd.psum(stacked, axis_name)
