"""Optimizers of the PyTorch port (counterpart of
incubator_mxnet_tpu/optimizer/optimizer.py): the `Optimizer` base with
its registry, `Adam`, and the `Updater` that keeps per-index state.

Weights, gradients and states are torch tensors; an update writes the
weight and its state in place (`ops.optimizer`).  SGD and the other
optimizers of the JAX package are not yet ported.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from ..ops import optimizer as _ops

__all__ = ["Optimizer", "Adam", "register", "create", "get_updater",
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
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
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

    def update(self, index, weight, grad, state):
        raise NotImplementedError


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
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
