"""Gluon `Trainer` of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/trainer.py).

`Trainer(params, optimizer, optimizer_params)` takes a `ParameterDict`
(`net.collect_params()`), a dict or a list of parameters on one device.
`step(batch_size)` sets the optimizer's `rescale_grad` to
`1 / batch_size` and updates, in place, every parameter that requires
grad from the gradient the last backward wrote.  A parameter with
grad_req 'null' (`requires_grad=False`, such as BatchNorm's running
statistics) is kept in the list and never updated, and gets no
optimizer state; so is a deferred parameter the first forward has not
materialised yet, which a Trainer built before that forward updates
from then on.  The optimizer reads each parameter's `lr_mult` and
`wd_mult` through `param_dict` (`collect_params(...).setattr("wd_mult",
0.0)`).  An aggregatable optimizer (SGD) updates all the
parameters in one `update_multi` call, as the JAX Trainer's aggregated
path does, unless it keeps master weights (`multi_precision`): then each
parameter takes `update_multi_precision`.  `contrib.amp.scale_loss`
sets `_scale` to the loss scale's inverse, which `update` folds into
`rescale_grad`.  `save_states`/`load_states` write and read the
optimizer's states with the optimizer itself (scheduler and update
counts included), as the JAX Trainer does; after `load_states`,
`trainer.optimizer` is the loaded one.  With one device there is no
kvstore; parameters on several devices, or a `dist` kvstore, raise
"not yet ported".
"""
from __future__ import annotations

from torch import nn

from .. import optimizer as opt_mod
from ..base import MXNetError
from ..optimizer.optimizer import _map_state
from .parameter import Parameter, is_deferred

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError("params must be a dict or a list of Parameters")
        for p in params:
            if not isinstance(p, nn.Parameter):
                raise MXNetError("invalid parameter %r" % (p,))
        self._params = list(params)
        devices = {d for p in self._params
                   for d in (p.list_ctx() if isinstance(p, Parameter)
                             else [p.device])}
        if len(devices) > 1:
            raise NotImplementedError(
                "Trainer over parameters on several devices (%s) needs a "
                "kvstore, which is not yet ported"
                % ", ".join(sorted(map(str, devices))))
        if isinstance(kvstore, str) and kvstore.startswith("dist"):
            raise NotImplementedError("kvstore %r is not yet ported"
                                      % kvstore)
        if compression_params or update_on_kvstore:
            raise NotImplementedError("gradient compression and "
                                      "update_on_kvstore are not yet ported")
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params and set(optimizer_params) != {"rescale_grad"}:
                raise MXNetError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = dict(enumerate(self._params))
        self._updater = opt_mod.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @learning_rate.setter
    def learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale gradients by 1 / batch_size and update (ref:
        Trainer.step; with one device there is nothing to allreduce)."""
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """One device: nothing to reduce."""

    def update(self, batch_size, ignore_stale_grad=False):
        """Update every parameter that requires grad.  A parameter that no
        backward reached has no gradient: that raises, or is skipped with
        `ignore_stale_grad`."""
        self._optimizer.rescale_grad = self._scale / batch_size
        live = []
        for i, p in enumerate(self._params):
            if not p.requires_grad or is_deferred(p):
                continue
            if p.grad is None:
                if ignore_stale_grad:
                    continue
                raise MXNetError(
                    "parameter #%d %s has no gradient: run backward first, "
                    "or pass ignore_stale_grad=True"
                    % (i, tuple(p.shape)))
            live.append(i)
        updater = self._updater
        opt = self._optimizer
        if not opt.aggregatable or opt.multi_precision:
            for i in live:
                updater(i, self._params[i].grad, self._params[i].data)
            return
        for i in live:
            if i not in updater.states:
                updater.states[i] = opt.create_state_multi_precision(
                    i, self._params[i].data)
        if live:
            opt.update_multi(
                live, [self._params[i].data for i in live],
                [self._params[i].grad for i in live],
                [updater.states[i] for i in live])

    def save_states(self, fname):
        """Write the optimizer's states and the optimizer to `fname`."""
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read a `save_states` file: the states go to their parameters'
        devices, bit for bit in their saved dtypes, and the loaded
        optimizer (its scheduler and update counts) replaces this one,
        bound to this Trainer's parameters."""
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
        states = self._updater.states
        for i in states:
            dev = self._params[i].device
            states[i] = _map_state(lambda t, dev=dev: t.to(dev), states[i])
