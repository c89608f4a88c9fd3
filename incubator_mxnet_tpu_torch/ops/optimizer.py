"""Optimizer update ops of the PyTorch port (counterpart of
incubator_mxnet_tpu/ops/optimizer.py): SGD, SGD with momentum, their
multi-tensor forms, their f32-master-weight forms (`mp_*`), NAG's
momentum update and Adam; the in-place device forms of the other
optimizers (`adagrad_update_`, `adadelta_update_`, `rmsprop_update_`,
`rmspropalex_update_`, `ftrl_update_`, `signsgd_update_`,
`signum_update_`, `lamb_update_phase1_`/`lamb_norm`/
`lamb_update_phase2_`, `adamax_update_`, `nadam_update_`,
`sgld_update_`, `test_update_`), which take every hyper that changes
from step to step as a tensor; and the registry's functional forms of
the JAX package's 16 update ops.

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

import numpy as np
import torch

__all__ = ["sgd_update", "sgd_mom_update", "multi_sgd_update",
           "multi_sgd_mom_update", "mp_sgd_update", "mp_sgd_mom_update",
           "nag_mom_update", "adam_update", "rmsprop_update",
           "rmspropalex_update", "ftrl_update", "adagrad_update",
           "signsgd_update", "signum_update", "lamb_update_phase1",
           "lamb_update_phase2", "adagrad_update_", "adadelta_update_",
           "rmsprop_update_", "rmspropalex_update_", "ftrl_update_",
           "signsgd_update_", "signum_update_", "lamb_update_phase1_",
           "lamb_norm", "lamb_update_phase2_", "adamax_update_",
           "nadam_update_", "sgld_update_", "test_update_"]


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


# -- in-place device forms of the other optimizers ---------------------------
# What `optimizer.Optimizer._device_one` runs for AdaGrad, AdaDelta,
# RMSProp, Ftrl, Signum, SignSGD, LAMB, Adamax, Nadam, SGLD and Test.  They
# take `lr`, `wd`, `rescale_grad` and the per-step values (bias
# corrections, Nadam's schedule, SGLD's sqrt(lr)) as 0-dim f32 tensors and
# branch on none of them, so that a captured update reads each replay's
# values; the other hypers are constants of the optimizer.  Each computes
# in f32 and rounds once into each buffer that is not f32 (`_f32`,
# `_write_back`).  The formulas and their order are the JAX package's:
# its update ops (incubator_mxnet_tpu/ops/optimizer.py) for the first six,
# its optimizer classes for AdaDelta, Adamax, Nadam, SGLD and Test.

def _one_minus(x):
    """1 - x as the JAX update ops compute it from an f32 hyper array:
    in f32 (1 - f32(0.999) is 0.000999987, not 0.001)."""
    return float(np.float32(1.0) - np.float32(x))


def _clip_(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        w.clamp_(-clip_weights, clip_weights)


@torch.no_grad()
def adagrad_update_(weight, grad, history, lr, wd, rescale_grad,
                    epsilon=1e-7, clip_gradient=None):
    """h += g^2;  w -= lr (g / (sqrt(h) + eps) + wd w); g the prepared
    gradient, without wd."""
    w, h = _f32(weight), _f32(history)
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    h.addcmul_(g, g)
    step = g.div_(h.sqrt().add_(epsilon))
    _add_wd_(step, w, wd)
    w.sub_(step.mul_(lr))
    _write_back(((weight, w), (history, h)))


@torch.no_grad()
def adadelta_update_(weight, grad, acc_g, acc_delta, wd, rescale_grad,
                     rho=0.9, epsilon=1e-5, clip_gradient=None):
    """g = the prepared gradient + wd w;  acc_g = rho acc_g + (1 - rho)
    g^2;  delta = sqrt(acc_delta + eps) / sqrt(acc_g + eps) g;
    acc_delta = rho acc_delta + (1 - rho) delta^2;  w -= delta."""
    w, ag, ad = _f32(weight), _f32(acc_g), _f32(acc_delta)
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    _add_wd_(g, w, wd)
    ag.mul_(rho).addcmul_(g, g, value=1.0 - rho)
    delta = ad.add(epsilon).sqrt_().div_(ag.add(epsilon).sqrt_()).mul_(g)
    ad.mul_(rho).addcmul_(delta, delta, value=1.0 - rho)
    w.sub_(delta)
    _write_back(((weight, w), (acc_g, ag), (acc_delta, ad)))


@torch.no_grad()
def rmsprop_update_(weight, grad, n, lr, wd, rescale_grad, gamma1=0.9,
                    epsilon=1e-8, clip_gradient=None, clip_weights=None):
    """g = the prepared gradient + wd w;  n = gamma1 n + (1 - gamma1) g^2;
    w -= lr g / sqrt(n + eps), clipped to +-clip_weights."""
    w, n32 = _f32(weight), _f32(n)
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    _add_wd_(g, w, wd)
    n32.mul_(gamma1).addcmul_(g, g, value=_one_minus(gamma1))
    w.sub_(g.mul_(lr).div_(n32.add(epsilon).sqrt_()))
    _clip_(w, clip_weights)
    _write_back(((weight, w), (n, n32)))


@torch.no_grad()
def rmspropalex_update_(weight, grad, n, g, delta, lr, wd, rescale_grad,
                        gamma1=0.95, gamma2=0.9, epsilon=1e-8,
                        clip_gradient=None, clip_weights=None):
    """Centered RMSProp (Graves): gr = the prepared gradient + wd w;
    n = gamma1 n + (1 - gamma1) gr^2;  g = gamma1 g + (1 - gamma1) gr;
    delta = gamma2 delta - lr gr / sqrt(n - g^2 + eps);  w += delta,
    clipped to +-clip_weights."""
    w, n32, g32, d32 = _f32(weight), _f32(n), _f32(g), _f32(delta)
    gr = _prep_grad(grad, rescale_grad, clip_gradient)
    _add_wd_(gr, w, wd)
    n32.mul_(gamma1).addcmul_(gr, gr, value=_one_minus(gamma1))
    g32.mul_(gamma1).add_(gr, alpha=_one_minus(gamma1))
    denom = torch.sub(n32, g32.square()).add_(epsilon).sqrt_()
    d32.mul_(gamma2).sub_(gr.mul_(lr).div_(denom))
    w.add_(d32)
    _clip_(w, clip_weights)
    _write_back(((weight, w), (n, n32), (g, g32), (delta, d32)))


@torch.no_grad()
def ftrl_update_(weight, grad, z, n, lr, wd, rescale_grad, lamda1=0.01,
                 beta=1.0, clip_gradient=None):
    """FTRL-proximal: g the prepared gradient (no wd);  sigma = (sqrt(n +
    g^2) - sqrt(n)) / lr;  z += g - sigma w;  n += g^2;  w = 0 where
    |z| <= lamda1, else -(z - sign(z) lamda1) / ((beta + sqrt(n)) / lr
    + wd)."""
    w, z32, n32 = _f32(weight), _f32(z), _f32(n)
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    new_n = torch.addcmul(n32, g, g)
    sq = new_n.sqrt()
    sigma = torch.sub(sq, n32.sqrt()).div_(lr)
    z32.add_(g).sub_(sigma.mul_(w))
    n32.copy_(new_n)
    denom = sq.add_(beta).div_(lr).add_(wd)
    shrunk = torch.sign(z32).mul_(lamda1).neg_().add_(z32).neg_()
    w.copy_(torch.where(z32.abs() <= lamda1, torch.zeros_like(w),
                        shrunk.div_(denom)))
    _write_back(((weight, w), (z, z32), (n, n32)))


@torch.no_grad()
def signsgd_update_(weight, grad, lr, wd, rescale_grad, clip_gradient=None):
    """w -= lr (sign(g) + wd w), g the prepared gradient."""
    w = _f32(weight)
    step = _prep_grad(grad, rescale_grad, clip_gradient).sign_()
    _add_wd_(step, w, wd)
    w.sub_(step.mul_(lr))
    _write_back(((weight, w),))


@torch.no_grad()
def signum_update_(weight, grad, mom, lr, wd, rescale_grad, momentum=0.9,
                   wd_lh=0.0, clip_gradient=None):
    """mom = momentum mom - (1 - momentum) g;  w += lr (sign(mom) - wd_lh
    w) - lr wd w, g the prepared gradient."""
    w, m = _f32(weight), _f32(mom)
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    m.mul_(momentum).sub_(g, alpha=_one_minus(momentum))
    decay = w * (lr * wd)
    step = torch.sign(m).sub_(w * wd_lh).mul_(lr)
    w.add_(step).sub_(decay)
    _write_back(((weight, w), (mom, m)))


@torch.no_grad()
def lamb_update_phase1_(weight, grad, mean, var, wd, rescale_grad,
                        beta1=0.9, beta2=0.999, epsilon=1e-6, bias1=None,
                        bias2=None, clip_gradient=None):
    """LAMB's first phase, in place on `mean` and `var`:
    m = beta1 m + (1 - beta1) g,  v = beta2 v + (1 - beta2) g^2, and
    returns g' = m^ / (sqrt(v^) + eps) + wd w in the gradient's dtype,
    with m^ = m / bias1 and v^ = v / bias2 (bias1 = 1 - beta1^t and
    bias2 = 1 - beta2^t as tensors), or m and v when they are None
    (no bias correction).  g' is a new tensor: it aliases no input."""
    w, m, v = _f32(weight), _f32(mean), _f32(var)
    g = _prep_grad(grad, rescale_grad, clip_gradient)
    m.mul_(beta1).add_(g, alpha=_one_minus(beta1))
    v.mul_(beta2).addcmul_(g, g, value=_one_minus(beta2))
    _write_back(((mean, m), (var, v)))
    mh = m if bias1 is None else m / bias1
    vh = v if bias2 is None else v / bias2
    gp = torch.div(mh, vh.sqrt().add_(epsilon))
    _add_wd_(gp, w, wd)
    return gp.to(grad.dtype)


def lamb_norm(t):
    """The 2-norm of `t` in its own dtype, as the JAX package's
    `jnp.linalg.norm` gives it on the CPU: the squares and their sum in
    f32, the sum rounded to `t`'s dtype, then its square root rounded
    to that dtype (for bf16, measured over 300 random vectors: every
    one equal to this, 50 of them unlike an f32 square root of the
    unrounded sum)."""
    s = torch.sum(torch.square(_f32(t)))
    if t.dtype != torch.float32:
        s = s.to(t.dtype).float()
    return s.sqrt().to(t.dtype)


@torch.no_grad()
def lamb_update_phase2_(weight, g, r1, r2, lr, lower_bound=None,
                        upper_bound=None):
    """LAMB's second phase, in place: r1 = ||w|| bounded to
    [lower_bound, upper_bound] where given, ratio = r1 / r2 where both
    are positive, else 1, in the norms' dtype;  w -= (lr ratio) g'."""
    r1c = r1
    if lower_bound is not None and lower_bound > 0:
        r1c = torch.clamp_min(r1c, lower_bound)
    if upper_bound is not None and upper_bound > 0:
        r1c = torch.clamp_max(r1c, upper_bound)
    ratio = torch.where((r1c > 0) & (r2 > 0), r1c / r2,
                        torch.ones_like(r1c))
    w = _f32(weight)
    w.sub_(_f32(g) * (lr * ratio.float()))
    _write_back(((weight, w),))


@torch.no_grad()
def adamax_update_(weight, grad, m, u, lr, wd, rescale_grad, beta1=0.9,
                   beta2=0.999, clip_gradient=None):
    """g = grad rescale_grad + wd w, then clipped (wd before the clip, as
    the JAX class has it);  m = beta1 m + (1 - beta1) g;  u = max(beta2
    u, |g|);  w -= lr m / (u + 1e-8).  `lr` carries the bias correction
    1 / (1 - beta1^t)."""
    w, m32, u32 = _f32(weight), _f32(m), _f32(u)
    g = _f32(grad) * rescale_grad
    _add_wd_(g, w, wd)
    if clip_gradient is not None and clip_gradient > 0:
        g.clamp_(-clip_gradient, clip_gradient)
    m32.mul_(beta1).add_(g, alpha=1.0 - beta1)
    torch.maximum(u32.mul_(beta2), g.abs_(), out=u32)
    w.sub_((m32 * lr).div_(u32.add(1e-8)))
    _write_back(((weight, w), (m, m32), (u, u32)))


@torch.no_grad()
def nadam_update_(weight, grad, m, v, lr, wd, rescale_grad, one_minus_mu,
                  mu_next, one_minus_sched, one_minus_sched_next, bias2,
                  beta1=0.9, beta2=0.999, epsilon=1e-8, clip_gradient=None):
    """Nadam with the per-step values as tensors: one_minus_mu = 1 -
    momentum_t, mu_next = momentum_{t+1}, one_minus_sched = 1 -
    m_schedule, one_minus_sched_next = 1 - m_schedule momentum_{t+1},
    bias2 = 1 - beta2^t.  g = grad rescale_grad + wd w, then clipped;
    m = beta1 m + (1 - beta1) g;  v = beta2 v + (1 - beta2) g^2;
    m_bar = (1 - momentum_t) g / (1 - m_schedule) + momentum_{t+1} m /
    (1 - m_schedule_next);  w -= lr m_bar / (sqrt(v / bias2) + eps)."""
    w, m32, v32 = _f32(weight), _f32(m), _f32(v)
    g = _f32(grad) * rescale_grad
    _add_wd_(g, w, wd)
    if clip_gradient is not None and clip_gradient > 0:
        g.clamp_(-clip_gradient, clip_gradient)
    m32.mul_(beta1).add_(g, alpha=1.0 - beta1)
    v32.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
    m_bar = (g / one_minus_sched).mul_(one_minus_mu).add_(
        (m32 / one_minus_sched_next).mul_(mu_next))
    denom = (v32 / bias2).sqrt_().add_(epsilon)
    w.sub_(m_bar.mul_(lr).div_(denom))
    _write_back(((weight, w), (m, m32), (v, v32)))


@torch.no_grad()
def sgld_update_(weight, grad, lr, wd, rescale_grad, sqrt_lr, generator,
                 clip_gradient=None):
    """Stochastic gradient Langevin dynamics: g = grad rescale_grad + wd
    w, then clipped;  w += -lr / 2 g + N(0, 1) sqrt(lr), the noise drawn
    in f32 from `generator` (a captured update registers it with its
    graph, so that every replay draws anew)."""
    w = _f32(weight)
    g = _f32(grad) * rescale_grad
    _add_wd_(g, w, wd)
    if clip_gradient is not None and clip_gradient > 0:
        g.clamp_(-clip_gradient, clip_gradient)
    noise = torch.randn(w.shape, generator=generator, device=w.device,
                        dtype=torch.float32)
    w.sub_(g.mul_(lr * 0.5)).add_(noise.mul_(sqrt_lr))
    _write_back(((weight, w),))


@torch.no_grad()
def test_update_(weight, grad, lr, rescale_grad):
    """The JAX package's `Test` optimizer: w -= lr g rescale_grad, with
    no weight decay and no clipping."""
    w = _f32(weight)
    w.sub_(_f32(grad).mul(lr).mul_(rescale_grad))
    _write_back(((weight, w),))


# -- registry entries -------------------------------------------------------
# The JAX package's 16 update ops, functional as there: each returns the
# new weight (and states) and leaves its inputs as they were; `nd`'s
# `out=` writes the results back.  The nine above run on copies of the
# weight and states; the other eight are plain elementwise functions in
# the inputs' dtype, as the JAX bodies are.  Those eight are not the
# arithmetic of their in-place forms above (f32 with f32 constants, one
# rounding): tests/test_torch_optimizers.py holds each to the JAX op and
# bounds its difference from the in-place form.

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
