"""Optimizer update ops of the PyTorch port (counterpart of
incubator_mxnet_tpu/ops/optimizer.py), limited to what Adam needs.

The JAX ops are pure functions that return the new state; here the
update runs in place on the weight and state tensors, which saves a copy
of every parameter per step.  `rescale_grad`, `clip_gradient` and `wd`
follow the reference: grad * rescale_grad, clipped, then wd * weight
added.
"""
from __future__ import annotations

import torch

__all__ = ["adam_update"]


def _prep_grad(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp_(-clip_gradient, clip_gradient)
    return g


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
