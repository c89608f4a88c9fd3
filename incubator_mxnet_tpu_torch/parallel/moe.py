"""Expert parallelism of the PyTorch port (counterpart of
incubator_mxnet_tpu/parallel/moe.py): a switch-routed Mixture of
Experts over a mesh axis.

Tokens live sharded over the axis and experts one or more per replica;
dispatch and return ride two `spmd.all_to_all` collectives.  Routing is
the capacity-factored top-1 einsum dispatch (fixed shapes, no sorting);
tokens past an expert's capacity are dropped (a residual outside passes
them through, the Switch behaviour).  Every function is a `shard_map`
body (`parallel.spmd`); gradients flow through the all_to_all and the
products.  Several experts on one replica are one `torch.func.vmap` of
the expert over the expert axis, where the JAX package vmaps: its
products become one batched product each.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..context import resolve_device
from . import spmd
from .mesh import squeeze_stage_axis

__all__ = ["switch_route", "moe_apply", "moe_ffn"]


def switch_route(router_logits, capacity):
    """Top-1 capacity-factored routing of this replica's tokens.

    router_logits: (T, E).  Returns (dispatch (T, E, C) one-hot, combine
    (T, E, C) probability-weighted, the Switch load-balancing aux
    loss)."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)
    expert = torch.argmax(probs, dim=-1)                   # (T,)
    mask = torch.nn.functional.one_hot(expert, E).float()  # (T, E)
    # position of each token in its expert's queue, 1-based
    pos = torch.cumsum(mask, dim=0) * mask
    keep = (pos <= capacity).float() * mask                # (T, E)
    pos_idx = (pos - 1.0) * keep                           # 0-based
    dispatch = keep[..., None] * torch.nn.functional.one_hot(
        pos_idx.long(), capacity).float()
    gate = (probs * keep).sum(dim=-1, keepdim=True)        # (T, 1)
    combine = dispatch * gate[..., None]
    # E * sum_e fraction_tokens_e * mean_prob_e
    frac = mask.mean(dim=0)
    mean_prob = probs.mean(dim=0)
    aux = E * (frac * mean_prob).sum()
    return dispatch, combine, aux


def moe_apply(x, router_w, expert_fn, expert_params, axis_name,
              capacity_factor=1.25):
    """Expert-parallel switch MoE layer (a shard_map body).

    x: (T_local, d) this replica's tokens.
    router_w: (d, E_total) router weights (replicated).
    expert_fn(params, tokens) -> tokens: one expert's computation;
        `expert_params` are this replica's experts' parameters (a tree
        sharded P('expert') outside; a leading axis of 1 is squeezed;
        several local experts are vmapped over their leading axis).
    Returns the (T_local, d) combined outputs and the aux loss, averaged
    over the axis."""
    n_dev = spmd.psum(1, axis_name)
    T, d = x.shape
    E = router_w.shape[-1]
    if E % n_dev:
        raise ValueError("experts %d not divisible by axis size %d"
                         % (E, n_dev))
    e_local = E // n_dev
    capacity = int(max(1, (T * capacity_factor) // E))
    eparams = squeeze_stage_axis(expert_params)

    logits = x.float() @ router_w.float()
    dispatch, combine, aux = switch_route(logits, capacity)

    # this replica's dispatched tokens: (E, C, d)
    expert_in = torch.einsum("tec,td->ecd", dispatch, x.float())
    # all_to_all over the expert axis: replica e receives
    # (n_dev, e_local*C, d), every replica's tokens for its experts
    expert_in = expert_in.reshape(n_dev, e_local * capacity, d)
    recv = spmd.all_to_all(expert_in, axis_name, split_axis=0,
                           concat_axis=0, tiled=False)
    recv = recv.reshape(n_dev, e_local, capacity, d) \
        .permute(1, 0, 2, 3).reshape(e_local, n_dev * capacity, d)
    if e_local == 1:
        out = expert_fn(eparams, recv[0].to(x.dtype))[None]
    else:
        out = torch.func.vmap(expert_fn)(eparams, recv.to(x.dtype))
    out = out.float()
    back = out.reshape(e_local, n_dev, capacity, d) \
        .permute(1, 0, 2, 3).reshape(n_dev, e_local * capacity, d)
    sent = spmd.all_to_all(back, axis_name, split_axis=0, concat_axis=0,
                           tiled=False)
    sent = sent.reshape(E, capacity, d)
    # back to token order, weighted by the router gate
    y = torch.einsum("tec,ecd->td", combine, sent)
    return y.to(x.dtype), spmd.pmean(aux, axis_name)


def moe_ffn(d_model, d_hidden, n_experts, key=None, device=None):
    """Per-expert FFN parameters stacked on the expert axis (shard with
    P('expert')), drawn from `numpy.random.RandomState(key or 0)` as the
    JAX package draws them, and the matching expert_fn.  The parameters
    go to `device`, by default `current_device()` (which raises on a
    host without a card outside `with cpu():`)."""
    device = resolve_device(device)
    rs = _np.random.RandomState(0 if key is None else key)
    params = {
        "w1": torch.from_numpy((rs.randn(n_experts, d_model, d_hidden)
                                * (1.0 / _np.sqrt(d_model)))
                               .astype(_np.float32)).to(device),
        "w2": torch.from_numpy((rs.randn(n_experts, d_hidden, d_model)
                                * (1.0 / _np.sqrt(d_hidden)))
                               .astype(_np.float32)).to(device),
    }

    def expert_fn(p, t):
        h = torch.relu(t @ p["w1"])
        return h @ p["w2"]

    return params, expert_fn
