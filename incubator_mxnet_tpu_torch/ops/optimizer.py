"""Optimizer update ops of the PyTorch port (counterpart of
incubator_mxnet_tpu/ops/optimizer.py): SGD, SGD with momentum, their
multi-tensor forms, their f32-master-weight forms (`mp_*`), and Adam.

The JAX ops are pure functions that return the new state; here the
update runs in place on the weight and state tensors, which saves a copy
of every parameter per step.  `rescale_grad`, `clip_gradient` and `wd`
follow the reference: grad * rescale_grad, clipped, then wd * weight
added.  The multi-tensor forms update a list of tensors with torch's
`_foreach_*` ops, a few launches for the whole list where the JAX
package folds the list into one executable.

Every update is dtype-preserving as in the JAX package, whose f32
hyper-parameter arrays promote the arithmetic to f32 and whose outputs
are cast back to each buffer's dtype once (`_fused`, `_update_one`): a
weight or state that is not f32 is updated through an f32 copy that is
written back once, so a bf16 step rounds once and not after every op.
f32 tensors are updated in place as they are.
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "multi_sgd_update",
           "multi_sgd_mom_update", "mp_sgd_update", "mp_sgd_mom_update",
           "adam_update"]


def _f32(t):
    """`t` itself if it is f32, else an f32 copy of it."""
    return t if t.dtype == torch.float32 else t.float()


def _write_back(pairs):
    """Round each f32 result into its own buffer, once; a buffer that was
    updated in place (f32) is its own result."""
    for dst, src in pairs:
        if src is not dst:
            dst.copy_(src)


def _prep_grad(grad, rescale_grad, clip_gradient):
    g = _f32(grad) * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = g.clamp_(-clip_gradient, clip_gradient)
    return g


@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    """w -= lr (g + wd w), in place, with g the prepared gradient."""
    w = _f32(weight)
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    g.add_(w, alpha=wd)
    w.sub_(g.mul_(lr))
    _write_back(((weight, w),))


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom = momentum mom - lr (g + wd w);  w += mom, both in place."""
    w, m = _f32(weight), _f32(mom)
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    g.add_(w, alpha=wd)
    m.mul_(momentum).sub_(g.mul_(lr))
    w.add_(m)
    _write_back(((weight, w), (mom, m)))


@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """`sgd_update` of the f32 master copy `weight32` from the gradient in
    f32, then `weight` (float16) = weight32 rounded, both in place."""
    sgd_update(weight32, grad, lr=lr, wd=wd, rescale_grad=rescale_grad,
               clip_gradient=clip_gradient)
    weight.copy_(weight32)


@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    """`sgd_mom_update` of the f32 master copy `weight32` and the f32
    momentum `mom`, then `weight` = weight32 rounded, all in place."""
    sgd_mom_update(weight32, grad, mom, lr=lr, momentum=momentum, wd=wd,
                   rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    weight.copy_(weight32)


def _multi_prep(weights, grads, wds, rescale_grad, clip_gradient):
    """[g_i * rescale_grad, clipped, + wd_i w_i] for the lists, in f32."""
    g = torch._foreach_mul([_f32(t) for t in grads], rescale_grad)
    if clip_gradient is not None and clip_gradient > 0:
        torch._foreach_clamp_min_(g, -clip_gradient)
        torch._foreach_clamp_max_(g, clip_gradient)
    torch._foreach_add_(g, torch._foreach_mul(weights, list(wds)))
    return g


@torch.no_grad()
def multi_sgd_update(weights, grads, lrs, wds, rescale_grad=1.0,
                     clip_gradient=-1.0):
    """`sgd_update` of every (weight, grad) pair, lr and wd per pair."""
    ws = [_f32(w) for w in weights]
    g = _multi_prep(ws, grads, wds, rescale_grad, clip_gradient)
    torch._foreach_sub_(ws, torch._foreach_mul(g, list(lrs)))
    _write_back(zip(weights, ws))


@torch.no_grad()
def multi_sgd_mom_update(weights, grads, moms, lrs, wds, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """`sgd_mom_update` of every (weight, grad, mom), lr and wd per
    triple."""
    ws, ms = [_f32(w) for w in weights], [_f32(m) for m in moms]
    g = _multi_prep(ws, grads, wds, rescale_grad, clip_gradient)
    torch._foreach_mul_(ms, momentum)
    torch._foreach_sub_(ms, torch._foreach_mul(g, list(lrs)))
    torch._foreach_add_(ws, ms)
    _write_back(zip(list(weights) + list(moms), ws + ms))


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """One Adam step in place on `weight`, `mean` and `var`:
    m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2,
    w -= lr m / (sqrt(v) + eps), with g the prepared gradient plus
    wd * weight.  `lr` carries any bias correction."""
    w, m, v = _f32(weight), _f32(mean), _f32(var)
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    if wd:
        g.add_(w, alpha=wd)
    m.mul_(beta1).add_(g, alpha=1.0 - beta1)
    v.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
    w.addcdiv_(m, v.sqrt().add_(epsilon), value=-lr)
    _write_back(((weight, w), (mean, m), (var, v)))
