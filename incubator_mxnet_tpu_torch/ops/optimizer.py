"""Optimizer update ops of the PyTorch port (counterpart of
incubator_mxnet_tpu/ops/optimizer.py): SGD, SGD with momentum, their
multi-tensor forms, their f32-master-weight forms (`mp_*`), NAG's
momentum update, and Adam.

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

`lr`, `wd` and `rescale_grad` are Python numbers or 0-dim f32 tensors on
the weight's device.  The optimizers pass tensors (`optimizer.Optimizer`
writes each step's values into them), so that an update captured in a
CUDA graph reads each replay's values instead of the ones frozen at
capture; a tensor `wd` is always applied, with no branch on its value.
Numbers stay, as the JAX ops take them: a direct caller of these ops
gets the arithmetic they always had, which the JAX parity tests hold:
`g + wd w` as one `add` with alpha (one rounding where the kernel fuses
it) and Adam's step as one `addcdiv`.  With tensors `wd w` and Adam's
`m / d` are rounded on their own, the same arithmetic whether captured
or not.  The multi-tensor forms take a list of numbers per pair, or one
tensor lr and one tensor wd for the whole list (the optimizers call them
once per group of parameters that share both).
"""
from __future__ import annotations

import torch

__all__ = ["sgd_update", "sgd_mom_update", "multi_sgd_update",
           "multi_sgd_mom_update", "mp_sgd_update", "mp_sgd_mom_update",
           "nag_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update", "ftrl_update", "adagrad_update",
           "signsgd_update", "signum_update", "lamb_update_phase1",
           "lamb_update_phase2"]


def _f32(t):
    """`t` itself if it is f32, else an f32 copy of it."""
    return t if t.dtype == torch.float32 else t.float()


def _write_back(pairs):
    """Round each f32 result into its own buffer, once; a buffer that was
    updated in place (f32) is its own result."""
    for dst, src in pairs:
        if src is not dst:
            dst.copy_(src)


def _add_wd_(g, w, wd):
    """g += wd w in place: one `add` with alpha for a number, a product
    and a sum for a tensor."""
    if isinstance(wd, torch.Tensor):
        return g.add_(w * wd)
    return g.add_(w, alpha=wd)


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
    _add_wd_(g, w, wd)
    w.sub_(g.mul_(lr))
    _write_back(((weight, w),))


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    """mom = momentum mom - lr (g + wd w);  w += mom, both in place."""
    w, m = _f32(weight), _f32(mom)
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    _add_wd_(g, w, wd)
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
    torch._foreach_add_(g, torch._foreach_mul(weights, wds))
    return g


def _one_or_list(h):
    return h if isinstance(h, torch.Tensor) else list(h)


@torch.no_grad()
def multi_sgd_update(weights, grads, lrs, wds, rescale_grad=1.0,
                     clip_gradient=-1.0, moms=None, momentum=0.0):
    """`sgd_update` (with `moms`, `sgd_mom_update`) of every (weight,
    grad): `lrs` and `wds` are lists of numbers, one per pair, or one
    0-dim tensor each for all the pairs, whose `_foreach_*` products
    round as the per-tensor ops' do."""
    lrs, wds = _one_or_list(lrs), _one_or_list(wds)
    ws = [_f32(w) for w in weights]
    g = _multi_prep(ws, grads, wds, rescale_grad, clip_gradient)
    if moms is None:
        torch._foreach_sub_(ws, torch._foreach_mul(g, lrs))
        _write_back(zip(weights, ws))
        return
    ms = [_f32(m) for m in moms]
    torch._foreach_mul_(ms, momentum)
    torch._foreach_sub_(ms, torch._foreach_mul(g, lrs))
    torch._foreach_add_(ws, ms)
    _write_back(zip(list(weights) + list(moms), ws + ms))


def multi_sgd_mom_update(weights, grads, moms, lrs, wds, momentum=0.0,
                         rescale_grad=1.0, clip_gradient=-1.0):
    """`sgd_mom_update` of every (weight, grad, mom); `lrs` and `wds` as
    in `multi_sgd_update`."""
    multi_sgd_update(weights, grads, lrs, wds, rescale_grad, clip_gradient,
                     moms=moms, momentum=momentum)


@torch.no_grad()
def nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """Nesterov momentum, in place: g = the prepared gradient + wd w,
    mom = momentum mom + g,  w -= lr (g + momentum mom)."""
    w, m = _f32(weight), _f32(mom)
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    _add_wd_(g, w, wd)
    m.mul_(momentum).add_(g)
    w.sub_(g.add_(m, alpha=momentum).mul_(lr))
    _write_back(((weight, w), (mom, m)))


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """One Adam step in place on `weight`, `mean` and `var`:
    m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2,
    w -= lr m / (sqrt(v) + eps), with g the prepared gradient plus
    wd * weight.  `lr` carries any bias correction."""
    w, m, v = _f32(weight), _f32(mean), _f32(var)
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    if isinstance(wd, torch.Tensor) or wd:
        _add_wd_(g, w, wd)
    m.mul_(beta1).add_(g, alpha=1.0 - beta1)
    v.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
    denom = v.sqrt().add_(epsilon)
    if isinstance(lr, torch.Tensor):
        w.sub_(torch.div(m, denom).mul_(lr))
    else:
        w.addcdiv_(m, denom, value=-lr)
    _write_back(((weight, w), (mean, m), (var, v)))


# -- registry entries -------------------------------------------------------
# The JAX package's 16 update ops, functional as there: each returns the
# new weight (and states) and leaves its inputs as they were; `nd`'s
# `out=` writes the results back.  The nine above run on copies of the
# weight and states; the other eight are plain elementwise functions in
# the inputs' dtype, as the JAX bodies are.

from .registry import register  # noqa: E402


def _copies(*ts):
    return tuple(t.clone() for t in ts)


@register("sgd_update", ndarray_inputs=("weight", "grad"),
          differentiable=False)
def _sgd_update_op(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    w, = _copies(weight)
    sgd_update(w, grad, lr, wd, rescale_grad, clip_gradient)
    return w


@register("sgd_mom_update", ndarray_inputs=("weight", "grad", "mom"),
          differentiable=False, num_outputs=2)
def _sgd_mom_update_op(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    w, m = _copies(weight, mom)
    sgd_mom_update(w, grad, m, lr, momentum, wd, rescale_grad, clip_gradient)
    return w, m


@register("mp_sgd_update", ndarray_inputs=("weight", "grad", "weight32"),
          differentiable=False, num_outputs=2)
def _mp_sgd_update_op(weight, grad, weight32, lr=0.01, wd=0.0,
                      rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    w, w32 = _copies(weight, weight32)
    mp_sgd_update(w, grad, w32, lr, wd, rescale_grad, clip_gradient)
    return w, w32


@register("mp_sgd_mom_update",
          ndarray_inputs=("weight", "grad", "mom", "weight32"),
          differentiable=False, num_outputs=3)
def _mp_sgd_mom_update_op(weight, grad, mom, weight32, lr=0.01,
                          momentum=0.0, wd=0.0, rescale_grad=1.0,
                          clip_gradient=-1.0, lazy_update=True):
    w, m, w32 = _copies(weight, mom, weight32)
    mp_sgd_mom_update(w, grad, m, w32, lr, momentum, wd, rescale_grad,
                      clip_gradient)
    return w, m, w32


@register("nag_mom_update", ndarray_inputs=("weight", "grad", "mom"),
          differentiable=False, num_outputs=2)
def _nag_mom_update_op(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    w, m = _copies(weight, mom)
    nag_mom_update(w, grad, m, lr, momentum, wd, rescale_grad, clip_gradient)
    return w, m


@register("adam_update", ndarray_inputs=("weight", "grad", "mean", "var"),
          differentiable=False, num_outputs=3)
def _adam_update_op(weight, grad, mean, var, lr=0.001, beta1=0.9,
                    beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, lazy_update=True):
    w, m, v = _copies(weight, mean, var)
    adam_update(w, grad, m, v, lr, beta1, beta2, epsilon, wd, rescale_grad,
                clip_gradient)
    return w, m, v


@register("multi_sgd_update", ndarray_inputs=None, differentiable=False,
          num_outputs=-1)
def _multi_sgd_update_op(*arrays, lrs=(), wds=(), rescale_grad=1.0,
                         clip_gradient=-1.0, num_weights=1):
    ws = _copies(*arrays[0:2 * num_weights:2])
    multi_sgd_update(ws, arrays[1:2 * num_weights:2], list(lrs), list(wds),
                     rescale_grad, clip_gradient)
    return ws


@register("multi_sgd_mom_update", ndarray_inputs=None, differentiable=False,
          num_outputs=-1)
def _multi_sgd_mom_update_op(*arrays, lrs=(), wds=(), momentum=0.0,
                             rescale_grad=1.0, clip_gradient=-1.0,
                             num_weights=1):
    n3 = 3 * num_weights
    ws = _copies(*arrays[0:n3:3])
    ms = _copies(*arrays[2:n3:3])
    multi_sgd_mom_update(ws, arrays[1:n3:3], ms, list(lrs), list(wds),
                         momentum, rescale_grad, clip_gradient)
    return tuple(t for pair in zip(ws, ms) for t in pair)


def _prep(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w


@register("rmsprop_update", ndarray_inputs=("weight", "grad", "n"),
          differentiable=False, num_outputs=2)
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.9, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1.0 - gamma1) * torch.square(g)
    w = weight - lr * g / torch.sqrt(new_n + epsilon)
    return _clip_weights(w, clip_weights), new_n


@register("rmspropalex_update",
          ndarray_inputs=("weight", "grad", "n", "g", "delta"),
          differentiable=False, num_outputs=4)
def rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    gr = _prep(grad, rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1.0 - gamma1) * torch.square(gr)
    new_g = gamma1 * g + (1.0 - gamma1) * gr
    new_delta = gamma2 * delta - lr * gr / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    w = _clip_weights(weight + new_delta, clip_weights)
    return w, new_n, new_g, new_delta


@register("ftrl_update", ndarray_inputs=("weight", "grad", "z", "n"),
          differentiable=False, num_outputs=3)
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        -(new_z - torch.sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return w, new_z, new_n


@register("adagrad_update", ndarray_inputs=("weight", "grad", "history"),
          differentiable=False, num_outputs=2)
def adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_h = history + torch.square(g)
    w = weight - lr * (g / (torch.sqrt(new_h) + epsilon) + wd * weight)
    return w, new_h


@register("signsgd_update", ndarray_inputs=("weight", "grad"),
          differentiable=False)
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    return weight - lr * (torch.sign(g) + wd * weight)


@register("signum_update", ndarray_inputs=("weight", "grad", "mom"),
          differentiable=False, num_outputs=2)
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    new_mom = momentum * mom - (1.0 - momentum) * g
    w = weight + lr * (torch.sign(new_mom) - wd_lh * weight) \
        - lr * wd * weight
    return w, new_mom


@register("lamb_update_phase1",
          ndarray_inputs=("weight", "grad", "mean", "var"),
          differentiable=False, num_outputs=3)
def lamb_update_phase1(weight, grad, mean, var, beta1=0.9, beta2=0.999,
                       epsilon=1e-6, t=1, bias_correction=True, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0):
    g = _prep(grad, rescale_grad, clip_gradient)
    m = beta1 * mean + (1.0 - beta1) * g
    v = beta2 * var + (1.0 - beta2) * torch.square(g)
    if bias_correction:
        mh = m / (1.0 - beta1 ** t)
        vh = v / (1.0 - beta2 ** t)
    else:
        mh, vh = m, v
    return mh / (torch.sqrt(vh) + epsilon) + wd * weight, m, v


@register("lamb_update_phase2", ndarray_inputs=("weight", "g", "r1", "r2"),
          differentiable=False)
def lamb_update_phase2(weight, g, r1, r2, lr=0.01, lower_bound=-1.0,
                       upper_bound=-1.0):
    r1c = r1
    if lower_bound is not None and lower_bound > 0:
        r1c = torch.clamp_min(r1c, lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1c = torch.clamp_max(r1c, upper_bound)
    ratio = torch.where((r1c > 0) & (r2 > 0), r1c / r2, torch.ones_like(r1c))
    return weight - lr * ratio * g
