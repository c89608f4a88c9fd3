"""A Gluon block as a function of its parameters (counterpart of
incubator_mxnet_tpu/parallel/functional.py).

`functionalize(block, training)` returns `pure(params, *inputs)` →
(outputs, running-statistics updates): the block's forward over the
tensors of `params` ({structural name: tensor}) through
`torch.func.functional_call`.  The block's own parameters are neither
read nor written.  A parameter without gradient (BatchNorm's running
statistics) is given to the forward as a copy; the copies the forward
wrote come back as the second result, as the JAX function returns
its recorded state updates.  Gradients flow to the tensors of `params`
that require grad.  As in the JAX package the call bypasses every
hybridized program of the tree (the forward runs as plain code, in a
program scope: `gluon.block._ProgramScope`).

`functional_call` swaps a module's parameters while it runs, so one
module cannot serve two threads at once; `replica_shell(block)` is a
copy of the module tree that shares the block's parameter objects (no
parameter is copied) for another thread to call.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict

import torch

from ..gluon.parameter import is_deferred, touch

__all__ = ["functionalize", "extract_params", "load_params",
           "replica_shell"]


def extract_params(block) -> Dict[str, torch.Tensor]:
    """{structural name: tensor} of the block's parameters (their data on
    their first context; a deferred one whose shape is known is
    materialised first)."""
    out = {}
    for name, p in block.collect_params().items():
        if is_deferred(p):
            p._finish_deferred_init()
        out[name] = p.detach()
    return out


@torch.no_grad()
def load_params(block, params: Dict[str, torch.Tensor]):
    """Write `params` into the block's parameters, every context's copy,
    each in its own dtype."""
    pd = block.collect_params()
    for name, val in params.items():
        p = pd[name]
        for copy_ in p.list_data():
            copy_.copy_(val.to(copy_.device))
        touch(p)


def functionalize(block, training: bool = False) -> Callable:
    """pure(params, *inputs) -> (outputs, {name: updated running
    statistic}) (module doc)."""
    from ..gluon.block import _ProgramScope
    names = list(block.collect_params().keys())
    stateful = {n for n, p in block.collect_params().items()
                if not p.requires_grad}

    def pure(pvals, *ivals):
        call, copies = {}, {}
        for n in names:
            v = pvals[n]
            if n in stateful:
                v = v.detach().clone()
                copies[n] = (v, v._version)
            call[n] = v
        with _ProgramScope(training, torch.is_grad_enabled()):
            out = torch.func.functional_call(block, call, tuple(ivals))
        return out, {n: v for n, (v, ver) in copies.items()
                     if v._version != ver}

    return pure


def replica_shell(block):
    """A copy of `block`'s module tree sharing its parameter objects and
    without its hybridized programs (module doc)."""
    memo = {id(p): p for p in block.parameters()}
    for m in block.modules():
        graph = m.__dict__.get("_cached_graph")
        if graph is not None:
            memo[id(graph)] = None
    return copy.deepcopy(block, memo)
