"""Optimizer update ops of the PyTorch port (counterpart of
incubator_mxnet_tpu/ops/optimizer.py): SGD, SGD with momentum, their
multi-tensor forms, and Adam.

The JAX ops are pure functions that return the new state; here the
update runs in place on the weight and state tensors, which saves a copy
of every parameter per step.  `rescale_grad`, `clip_gradient` and `wd`
follow the reference: grad * rescale_grad, clipped, then wd * weight
added.  The multi-tensor forms update a list of tensors with torch's
`_foreach_*` ops, a few launches for the whole list where the JAX
package folds the list into one executable.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "multi_sgd_update",
           "multi_sgd_mom_update", "adam_update"]


def _prep_grad(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp_(-clip_gradient, clip_gradient)
    return g


@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """w -= lr (g + wd w), in place, with g the prepared gradient."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    g.add_(weight, alpha=wd)
    weight.sub_(g.mul_(lr))


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom = momentum mom - lr (g + wd w);  w += mom, both in place."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    g.add_(weight, alpha=wd)
    mom.mul_(momentum).sub_(g.mul_(lr))
    weight.add_(mom)


def _multi_prep(weights, grads, wds, rescale_grad, clip_gradient):
    """[g_i * rescale_grad, clipped, + wd_i w_i] for the lists."""
    g = torch._foreach_mul(grads, rescale_grad)
    if clip_gradient is not None and clip_gradient > 0:
        torch._foreach_clamp_min_(g, -clip_gradient)
        torch._foreach_clamp_max_(g, clip_gradient)
    torch._foreach_add_(g, torch._foreach_mul(weights, list(wds)))
    return g


@torch.no_grad()
def multi_sgd_update(weights, grads, lrs, wds, rescale_grad=1.0,
                     clip_gradient=-1.0):
    """`sgd_update` of every (weight, grad) pair, lr and wd per pair."""
    g = _multi_prep(weights, grads, wds, rescale_grad, clip_gradient)
    torch._foreach_sub_(weights, torch._foreach_mul(g, list(lrs)))


@torch.no_grad()
def multi_sgd_mom_update(weights, grads, moms, lrs, wds, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """`sgd_mom_update` of every (weight, grad, mom), lr and wd per
    triple."""
    g = _multi_prep(weights, grads, wds, rescale_grad, clip_gradient)
    torch._foreach_mul_(moms, momentum)
    torch._foreach_sub_(moms, torch._foreach_mul(g, list(lrs)))
    torch._foreach_add_(weights, moms)


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """One Adam step in place on `weight`, `mean` and `var`:
    m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2,
    w -= lr m / (sqrt(v) + eps), with g the prepared gradient plus
    wd * weight.  `lr` carries any bias correction."""
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    if wd:
        g.add_(weight, alpha=wd)
    mean.mul_(beta1).add_(g, alpha=1.0 - beta1)
    var.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
    weight.addcdiv_(mean, var.sqrt().add_(epsilon), value=-lr)
