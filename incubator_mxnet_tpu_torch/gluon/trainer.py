"""Gluon `Trainer` of the PyTorch port (counterpart of
incubator_mxnet_tpu/gluon/trainer.py).

`Trainer(params, optimizer, optimizer_params)` takes a `ParameterDict`
(`net.collect_params()`), a dict or a list of parameters on one device.
`step(batch_size)` sets the optimizer's `rescale_grad` to
`1 / batch_size` and updates, in place, every parameter that requires
grad from the gradient the last backward wrote; one that no backward
reached is updated with a zero gradient, as in the JAX package, so that
an eager step and a hybridized one (whose captured backward writes
zeros there) update the same parameters.  A parameter with
grad_req 'null' (`requires_grad=False`, such as BatchNorm's running
statistics) is kept in the list and never updated, and gets no
optimizer state; so is a deferred parameter the first forward has not
materialised yet, which a Trainer built before that forward updates
from then on.  The optimizer reads each parameter's `lr_mult` and
`wd_mult` through `param_dict` (`collect_params(...).setattr("wd_mult",
0.0)`).  An aggregatable optimizer (SGD, Adam) updates all the
parameters in one `update_multi` call, as the JAX Trainer's aggregated
path does, unless it keeps master weights (`multi_precision`): then each
parameter takes `update_multi_precision`; every other optimizer of the
registry (NAG, AdaGrad, AdaDelta, RMSProp, Ftrl, Signum, SignSGD, LAMB,
Adamax, Nadam, SGLD, Test) updates parameter by parameter in the
Trainer's order, as there.  `contrib.amp.scale_loss`
sets `_scale` to the loss scale's inverse, which `update` folds into
`rescale_grad`.  `save_states`/`load_states` write and read the
optimizer's states with the optimizer itself (scheduler and update
counts included), as the JAX Trainer does; after `load_states`,
`trainer.optimizer` is the loaded one.

Parameters on several contexts (`initialize(ctx=[...])`) must all have
the same ones.  As in the JAX Trainer, a kvstore (`kvstore`, by default
"device"; see `kvstore.create`) is made at the first step when there
are several contexts or the kvstore is a `dist` one; with one context
and an in-process kvstore there is none.  `step` then sums each
parameter's gradients over its copies (and the workers) with
`pushpull` (`allreduce_grads`), updates the first context's copy as
below and copies the result to the others, which is what the JAX
Trainer's per-context updaters compute.  With `update_on_kvstore=True`
the store runs the optimizer: `step` pushes the gradients and pulls the
updated weight into every copy (the store's update is the optimizer's
per-parameter one).  `compression_params` go to the dist store's
`set_gradient_compression`.

Each `step` runs the optimizer's host bookkeeping (`Optimizer._hypers`:
update counts, the scheduler's lr, the multipliers, and the per-step
extras: Adam's and Adamax's bias corrections folded into the lr, LAMB's
1 - beta^t, Nadam's schedule values, SGLD's sqrt(lr)) and writes the lr,
the wd, the extras and the `rescale_grad` into one static f32 vector on
the device (`optimizer.Hypers`), one slot per distinct (lr, wd, extras),
from which the device update reads them.
When every live parameter's gradient is in its persistent buffer (a
hybridized block's backward put it there, `autograd.grad_buffer`), the
device update is one captured program (`graph_capture`, a CUDA graph on
the card), keyed by the live parameters, the storage and dtypes of
their weights, gradients and states, and the optimizer's constants: it
is captured once an eager update has run with the same key but the
gradients' storage (which loaded its kernels), and replayed from then
on, so that an lr a scheduler or `set_learning_rate` changes, and
every per-step extra, reach every replay with no capture; SGLD's noise
comes from the port's generator, which the capture registers with its
graph, so each replay draws anew.  A change of a constant the update
holds as a number (`Optimizer._static_key`: momentum, betas, epsilon,
RMSProp's gamma1/gamma2/centered/clip_weights, Ftrl's lamda1/beta, LAMB's
bounds and bias_correction, ...) captures again.  Otherwise
the update runs eagerly, the same code on the same hyper vector: with
gradients a backward left in new storage, under `contrib.amp`'s loss
scaler (whose overflow check reads the device on the host), and for an
optimizer with only `update` (every registered optimizer has a device
update).
`captures`, `replays` and `eager_updates` count the three.
`load_states` drops the captured update.

A parameter whose gradient is row_sparse (`grad_stype`, an
`Embedding(sparse_grad=True)` weight) takes its optimizer's lazy update
(`Optimizer._sparse_update`) every step, eagerly and before the dense
ones, from the rows the last backward gave it (none when no backward
reached it); it is never part of the captured update, whose key the
dense parameters alone make, so it stays the same from step to step.
`sparse_updates` counts the steps that ran lazy updates.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import autograd as _ag
from .. import graph_capture as _capture
from .. import optimizer as opt_mod
from ..base import MXNetError
from ..optimizer.optimizer import Hypers, _map_state
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
        contexts = None
        for p in self._params:
            ctx = p.list_ctx() if isinstance(p, Parameter) else [p.device]
            if contexts is not None and contexts != ctx:
                raise MXNetError("all Parameters must live on the same "
                                 "contexts (%s and %s)" % (contexts, ctx))
            contexts = ctx
        self._contexts = contexts or []
        self._kvstore_type = kvstore
        self._compression_params = compression_params
        self._update_on_kvstore = update_on_kvstore
        self._kvstore = None
        self._kv_initialized = False
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
        self._hypers = Hypers()
        self._program = None        # (key, captured update)
        self._warm_key = None
        self.captures = self.replays = self.eager_updates = 0
        self.sparse_updates = 0

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

    def _init_kvstore(self):
        """The kvstore, as the JAX Trainer makes it (module doc)."""
        from .. import kvstore as kv_mod
        kind = self._kvstore_type
        is_dist = isinstance(kind, str) and kind.startswith("dist")
        if kind is None or (len(self._contexts) <= 1 and not is_dist):
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            self._kvstore = kind if isinstance(kind, kv_mod.KVStore) else \
                kv_mod.create(kind if isinstance(kind, str) else "device")
            if self._compression_params:
                self._kvstore.set_gradient_compression(
                    self._compression_params)
            self._update_on_kvstore = bool(self._update_on_kvstore)
            if self._update_on_kvstore:
                self._kvstore.set_optimizer(self._optimizer)
            for i, p in enumerate(self._params):
                if not is_deferred(p):
                    self._kvstore.init(i, p)
        self._kv_initialized = True

    def _live(self, p):
        return p.requires_grad and not is_deferred(p)

    def _grads(self, i, p):
        """Every copy's gradient of parameter `i` (zeros where no backward
        reached it), with the store holding its key."""
        if i not in self._kvstore._store:
            self._kvstore.init(i, p)
        copies = p.list_data() if isinstance(p, Parameter) else [p]
        for t in copies:
            if t.grad is None:
                t.grad = _ag.grad_buffer(t).zero_() if t is p \
                    else torch.zeros_like(t)
        return [t.grad for t in copies]

    def step(self, batch_size, ignore_stale_grad=False):
        """Rescale gradients by 1 / batch_size, sum them over the
        contexts and workers (`allreduce_grads`) and update (ref:
        Trainer.step)."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._update_on_kvstore:
            # with the update in the store, the store sums the pushes
            self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Each parameter's gradients summed over its copies (and the
        workers), written back into every copy (`pushpull`)."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._kvstore is None:
            return
        for i, p in enumerate(self._params):
            if self._live(p) and getattr(p, "grad_stype",
                                         "default") == "default":
                grads = self._grads(i, p)
                self._kvstore.pushpull(i, grads, out=grads)

    def update(self, batch_size, ignore_stale_grad=False):
        """Update every parameter that requires grad.  A parameter that no
        backward reached is updated with a zero gradient, its persistent
        buffer zeroed, as the JAX Trainer updates it from its zero-filled
        gradient; `ignore_stale_grad` changes nothing, as there.  The
        other contexts' copies take the first's result."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        if self._update_on_kvstore and self._kvstore is not None:
            for i, p in enumerate(self._params):
                if self._live(p):
                    self._kvstore.push(i, self._grads(i, p))
                    with torch.no_grad():
                        self._kvstore.pull(i, out=p.list_data() if
                                           isinstance(p, Parameter) else p)
            return
        self._update_first()
        if len(self._contexts) > 1:
            with torch.no_grad():
                for p in self._params:
                    if self._live(p):
                        for t in p.list_data()[1:]:
                            t.copy_(p)

    def _update_first(self):
        """The update of the first context's copies (module doc)."""
        live, sparse = [], []
        for i, p in enumerate(self._params):
            if not p.requires_grad or is_deferred(p):
                continue
            if getattr(p, "grad_stype", "default") == "row_sparse" or (
                    p.grad is not None and p.grad.is_sparse):
                sparse.append(i)
                continue
            if p.grad is None:
                p.grad = _ag.grad_buffer(p).zero_()
            live.append(i)
        opt = self._optimizer
        params = self._params
        if sparse:
            self._sparse_update(sparse)
        if not live:
            return
        if opt._device_one is None:
            self.eager_updates += 1
            for i in live:
                self._updater(i, params[i].grad, params[i].data)
            return
        states = self._updater.states
        for i in live:
            if i not in states:
                states[i] = opt.create_state_multi_precision(
                    i, params[i].data)
        lrs, wds, extras = opt._hypers(live)
        weights = [params[i].data for i in live]
        grads = [params[i].grad for i in live]
        sts = [states[i] for i in live]
        hypers = self._hypers.write(lrs, wds, opt.rescale_grad,
                                    weights[0].device, extras)

        def run():
            opt._device_update(live, weights, grads, sts, hypers)

        warm = self._update_key(live, weights, sts, hypers)
        if (getattr(self, "_amp_loss_scaler", None) is not None
                or not all(_ag.has_stable_grad(params[i]) for i in live)
                or self._warm_key != warm):
            if self._warm_key != warm:
                self._program = None
            self.eager_updates += 1
            self._warm_key = warm
            run()
            return
        key = (warm, tuple(g.data_ptr() for g in grads))
        if self._program is not None and self._program[0] == key:
            self._program[1].replay()
            self.replays += 1
            return
        program, _ = _capture.capture(run, weights[0].device)
        self._program = (key, program)
        self.captures += 1
        if not program.ran:
            program.replay()

    def _sparse_update(self, indices):
        """The lazy updates of the parameters at `indices`, whose
        gradients are row_sparse, before the dense ones (the JAX
        optimizers' `update_multi` order): eagerly, since the rows they
        touch depend on the data."""
        self.sparse_updates += 1
        opt = self._optimizer
        states = self._updater.states
        for i in indices:
            p = self._params[i]
            if i not in states:
                states[i] = opt.create_state_multi_precision(i, p.data)
            grad = p.list_grad()[0] if isinstance(p, Parameter) else p.grad
            opt._sparse_update(i, p.data, grad, states[i])

    def _update_key(self, live, weights, states, hypers):
        """What a captured update depends on, but the gradients' storage:
        an eager update with the same key loads every kernel that its
        capture launches."""
        flat = []
        for s in states:
            _map_state(lambda t: flat.append((t.data_ptr(), t.dtype)), s)
        params = self._params
        return (tuple(live), hypers.layout, hypers.vec.data_ptr(),
                self._optimizer._static_key(),
                tuple((w.data_ptr(), w.dtype,
                       params[i].__dict__.get("_graph_version", 0))
                      for i, w in zip(live, weights)),
                tuple(flat))

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
        self._program = self._warm_key = None
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
        states = self._updater.states
        for i in states:
            dev = self._params[i].device
            states[i] = _map_state(lambda t, dev=dev: t.to(dev), states[i])
