"""Optimizers of the PyTorch port (counterpart of
incubator_mxnet_tpu/optimizer/optimizer.py): the `Optimizer` base with
its registry, `SGD`, `Adam`, and the `Updater` that keeps per-index
state.

Weights, gradients and states are torch tensors; an update writes the
weight and its state in place (`ops.optimizer`), in the weight's and
the state's own dtype.  With `multi_precision=True` a float16 weight is
updated through an f32 master copy kept in its state, exactly as the
JAX condition `weight.dtype == float16` says; any other dtype (bf16
included) takes the plain update.  An optimizer with
`aggregatable = True` (SGD) also has `update_multi`, which the Trainer
calls once for all its parameters.  The other optimizers of the JAX
package are not yet ported.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..ops import optimizer as _ops

__all__ = ["Optimizer", "SGD", "Adam", "register", "create", "get_updater",
           "Updater"]

_OPT_REGISTRY = {}


def register(klass):
    _OPT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Optimizer):
        return name
    key = name.lower()
    if key not in _OPT_REGISTRY:
        raise MXNetError("unknown optimizer %r (ported: %s)"
                         % (name, ", ".join(sorted(_OPT_REGISTRY))))
    return _OPT_REGISTRY[key](**kwargs)


class Optimizer:
    """ref: mx.optimizer.Optimizer."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, begin_num_update=0,
                 multi_precision=False, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = dict(param_dict or {})

    @property
    def learning_rate(self):
        return self.lr

    def set_learning_rate(self, lr):
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def _update_count(self, index):
        if not isinstance(index, (list, tuple)):
            index = [index]
        for idx in index:
            self._index_update_count.setdefault(idx, self.begin_num_update)
            self._index_update_count[idx] += 1
            self.num_update = max(self._index_update_count[idx],
                                  self.num_update)

    def _get_mult(self, index, attr, mults):
        """A parameter's own `lr_mult`/`wd_mult` attribute, else the
        multiplier set for its index or its name, else 1."""
        if index in self.param_dict:
            return getattr(self.param_dict[index], attr, 1.0)
        if index in mults:
            return mults[index]
        if index in self.idx2name:
            return mults.get(self.idx2name[index], 1.0)
        return 1.0

    def _get_lr(self, index):
        return self.learning_rate * self._get_mult(index, "lr_mult",
                                                   self.lr_mult)

    def _get_wd(self, index):
        return self.wd * self._get_mult(index, "wd_mult", self.wd_mult)

    def create_state(self, index, weight):
        return None

    def _master_copy(self, weight):
        """Whether `weight` is updated through an f32 master copy."""
        return self.multi_precision and weight.dtype == torch.float16

    def create_state_multi_precision(self, index, weight):
        """`create_state`, or for a master-copied weight
        (create_state(f32 copy), f32 copy)."""
        if self._master_copy(weight):
            w32 = weight.float()
            return self.create_state(index, w32), w32
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        """`update`, or for a master-copied weight the update of its f32
        copy from the f32 gradient, rounded into `weight`."""
        if self._master_copy(weight):
            inner, w32 = state
            self.update(index, w32, grad.float(), inner)
            weight.copy_(w32)
        else:
            self.update(index, weight, grad, state)

    #: whether `update_multi` updates a list of parameters at once
    aggregatable = False


@register
class SGD(Optimizer):
    """ref: optimizer.SGD → sgd_update / sgd_mom_update, and
    multi_sgd(_mom)_update on the aggregated path.  Gradients are dense
    here, so `lazy_update` (the JAX package's row-sparse path) is
    accepted and changes nothing."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def _step_kwargs(self, index):
        """Counts an update of `index` and returns its op arguments."""
        self._update_count(index)
        return dict(lr=self._get_lr(index), wd=self._get_wd(index),
                    rescale_grad=self.rescale_grad,
                    clip_gradient=self.clip_gradient)

    def update(self, index, weight, grad, state):
        kw = self._step_kwargs(index)
        if state is None:
            _ops.sgd_update(weight, grad, **kw)
        else:
            _ops.sgd_mom_update(weight, grad, state, momentum=self.momentum,
                                **kw)

    def update_multi_precision(self, index, weight, grad, state):
        """`update`, or for a master-copied weight mp_sgd_update /
        mp_sgd_mom_update: the same update of the f32 copy, rounded into
        `weight`."""
        if not self._master_copy(weight):
            return self.update(index, weight, grad, state)
        mom, w32 = state
        kw = self._step_kwargs(index)
        if mom is None:
            _ops.mp_sgd_update(weight, grad, w32, **kw)
        else:
            _ops.mp_sgd_mom_update(weight, grad, mom, w32,
                                   momentum=self.momentum, **kw)

    aggregatable = True

    def update_multi(self, indices, weights, grads, states):
        """One multi-tensor update of the parameters at `indices`."""
        for i in indices:
            self._update_count(i)
        lrs = [self._get_lr(i) for i in indices]
        wds = [self._get_wd(i) for i in indices]
        kw = dict(rescale_grad=self.rescale_grad,
                  clip_gradient=self.clip_gradient)
        if self.momentum == 0.0:
            _ops.multi_sgd_update(weights, grads, lrs, wds, **kw)
        else:
            _ops.multi_sgd_mom_update(weights, grads, states, lrs, wds,
                                      momentum=self.momentum, **kw)


@register
class Adam(Optimizer):
    """ref: optimizer.Adam → adam_update, with the bias correction folded
    into the learning rate from each index's own update count t."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        t = self._index_update_count[index]
        lr = self._get_lr(index)
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        _ops.adam_update(weight, grad, mean, var, lr=lr, beta1=self.beta1,
                         beta2=self.beta2, epsilon=self.epsilon,
                         wd=self._get_wd(index),
                         rescale_grad=self.rescale_grad,
                         clip_gradient=self.clip_gradient)


class Updater:
    """Per-index optimizer state, created at an index's first update
    (ref: optimizer.get_updater)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
