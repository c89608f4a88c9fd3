"""Optimizers of the PyTorch port (counterpart of
incubator_mxnet_tpu/optimizer/optimizer.py): the `Optimizer` base with
its registry, `SGD`, `NAG`, `Adam`, and the `Updater` that keeps
per-index state and saves and restores it with the optimizer.

With an `lr_scheduler`, the learning rate is the scheduler's at the
optimizer's `num_update` (counted before an update reads it, so the
k-th update takes `lr_scheduler(k)`), and `set_learning_rate` raises.

Weights, gradients and states are torch tensors; an update writes the
weight and its state in place (`ops.optimizer`), in the weight's and
the state's own dtype.  With `multi_precision=True` a float16 weight is
updated through an f32 master copy kept in its state, exactly as the
JAX condition `weight.dtype == float16` says; any other dtype (bf16
included) takes the plain update.  An optimizer with
`aggregatable = True` (SGD, Adam) also has `update_multi`, which the
Trainer takes for all its parameters at once, as the JAX Trainer's
aggregated path does; NAG updates tensor by tensor, as in the JAX
package.  The other optimizers of the JAX package are not yet ported.

Each update is split in two, so that a `gluon.Trainer` can capture the
device part once and replay it (`graph_capture`):

* host bookkeeping, `_hypers(indices)`: the update counts, the
  scheduler's learning rate, the lr and wd multipliers and Adam's bias
  correction, as Python numbers, every step;
* the device update, `_device_update(..., hypers)`, which reads the
  lr, wd and `rescale_grad` as 0-dim f32 tensors and branches on no
  hyper value.  `Hypers` holds them: one f32 vector on the device
  (`_hyper_array`, the counterpart of the JAX package's `_hyper_array`,
  "so schedules don't recompile") with one slot per distinct (lr, wd)
  pair, and the parameters grouped by slot, which the multi-tensor
  updates take one group at a time.

`update`, `update_multi_precision` and `update_multi` run both parts,
with the values put on the weight's device each call.
"""
from __future__ import annotations

import math
import pickle

import torch

from ..base import MXNetError
from ..ops import optimizer as _ops

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "register", "create",
           "get_updater", "Updater"]

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
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            lr_scheduler.base_lr = learning_rate
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
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("an lr_scheduler is set; the learning rate "
                             "cannot be set directly")
        self.lr = lr

    def __getstate__(self):
        """Pickled without `param_dict`, which holds the parameters: the
        Trainer that loads the state binds its own."""
        state = self.__dict__.copy()
        state["param_dict"] = {}
        return state

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

    def _index_lr(self, index):
        """The lr that an update of `index` takes, its count already
        taken."""
        return self._get_lr(index)

    def _hypers(self, indices):
        """Host bookkeeping of one update of each of `indices`, in order:
        count it, then read its lr and wd.  Returns ([lr], [wd])."""
        lrs, wds = [], []
        for i in indices:
            self._update_count(i)
            lrs.append(self._index_lr(i))
            wds.append(self._get_wd(i))
        return lrs, wds

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

    #: the device update of one tensor, (index, weight, grad, state, lr,
    #: wd, rescale_grad) with 0-dim tensor hypers; None for an optimizer
    #: that has only `update`
    _device_one = None

    def _device_one_mp(self, index, weight, grad, state, lr, wd, rescale):
        """`_device_one`, or for a master-copied weight the update of its
        f32 copy from the f32 gradient, rounded into `weight`."""
        if self._master_copy(weight):
            inner, w32 = state
            self._device_one(index, w32, grad.float(), inner, lr, wd,
                             rescale)
            weight.copy_(w32)
        else:
            self._device_one(index, weight, grad, state, lr, wd, rescale)

    def _device_multi(self, indices, weights, grads, states, hypers):
        """The aggregated device update: tensor by tensor here."""
        for pos, args in enumerate(zip(indices, weights, grads, states)):
            self._device_one(*args, *hypers.at(pos))

    def _device_update(self, indices, weights, grads, states, hypers):
        """The device part of one update of `indices`, with their hypers
        (`Hypers`, in the same order): the aggregated path for an
        aggregatable optimizer without master copies, else tensor by
        tensor."""
        if self.aggregatable and not self.multi_precision:
            self._device_multi(indices, weights, grads, states, hypers)
            return
        for pos, args in enumerate(zip(indices, weights, grads, states)):
            self._device_one_mp(*args, *hypers.at(pos))

    def _static_key(self):
        """The constants that a captured device update holds as numbers:
        changing one calls for another capture."""
        return (type(self), self.clip_gradient, self.multi_precision,
                self.aggregatable) + tuple(
                    getattr(self, n, None)
                    for n in ("momentum", "beta1", "beta2", "epsilon"))

    def _run_one(self, device_fn, index, weight, grad, state):
        """Host bookkeeping of one update of `index`, then `device_fn`
        with its hypers on the weight's device."""
        hypers = Hypers().write(*self._hypers([index]), self.rescale_grad,
                                weight.device)
        device_fn(index, weight, grad, state, *hypers.at(0))

    def update(self, index, weight, grad, state):
        if self._device_one is None:
            raise NotImplementedError
        self._run_one(self._device_one, index, weight, grad, state)

    def update_multi_precision(self, index, weight, grad, state):
        """`update`, or for a master-copied weight the update of its f32
        copy from the f32 gradient, rounded into `weight`."""
        if self._device_one is not None:
            self._run_one(self._device_one_mp, index, weight, grad, state)
        elif self._master_copy(weight):
            inner, w32 = state
            self.update(index, w32, grad.float(), inner)
            weight.copy_(w32)
        else:
            self.update(index, weight, grad, state)

    def update_multi(self, indices, weights, grads, states):
        """One aggregated update of the parameters at `indices`."""
        indices = list(indices)
        hypers = Hypers().write(*self._hypers(indices), self.rescale_grad,
                                weights[0].device)
        self._device_multi(indices, weights, grads, states, hypers)

    #: whether `update_multi` updates a list of parameters at once
    aggregatable = False


class Hypers:
    """The lr, wd and `rescale_grad` of one update of a list of
    parameters, as 0-dim f32 views of one vector on the device: one slot
    per distinct (lr, wd) pair, in order of first use, then the rescale.
    `write` puts a step's values in, into the same vector while the
    layout (the slot of each position) holds, so that an update captured
    on these views reads each step's values.  `groups` lists (positions,
    lr, wd) per slot; `at(pos)` gives (lr, wd, rescale) of a position."""

    def __init__(self):
        self.layout = self.vec = None

    def write(self, lrs, wds, rescale, device):
        slots = {}
        layout = tuple(slots.setdefault(h, len(slots))
                       for h in zip(lrs, wds))
        values = [lr for lr, _ in slots] + [wd for _, wd in slots] \
            + [rescale]
        if (self.vec is not None and layout == self.layout
                and self.vec.device == torch.device(device)):
            _hyper_array(values, device, out=self.vec)
            return self
        self.layout, self.vec = layout, _hyper_array(values, device)
        m = len(slots)
        views = self.vec.unbind()
        self.lr, self.wd, self.rescale = views[:m], views[m:2 * m], \
            views[2 * m]
        self.groups = [([p for p, k in enumerate(layout) if k == slot],
                        self.lr[slot], self.wd[slot]) for slot in range(m)]
        return self

    def at(self, pos):
        slot = self.layout[pos]
        return self.lr[slot], self.wd[slot], self.rescale


def _hyper_array(values, device, out=None):
    """`values` as one f32 vector on `device` (ref: the JAX package's
    `_hyper_array`), written into `out` when given: from pinned memory
    without waiting on a card, whose caching host allocator keeps the
    pinned block until the copy has run."""
    host = torch.tensor(values, dtype=torch.float32)
    if out is None:
        out = torch.empty_like(host, device=device)
    if out.is_cuda:
        out.copy_(host.pin_memory(), non_blocking=True)
    else:
        out.copy_(host)
    return out


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

    def _device_one(self, index, weight, grad, state, lr, wd, rescale):
        kw = dict(lr=lr, wd=wd, rescale_grad=rescale,
                  clip_gradient=self.clip_gradient)
        if state is None:
            _ops.sgd_update(weight, grad, **kw)
        else:
            _ops.sgd_mom_update(weight, grad, state, momentum=self.momentum,
                                **kw)

    def _device_one_mp(self, index, weight, grad, state, lr, wd, rescale):
        """`_device_one`, or for a master-copied weight mp_sgd_update /
        mp_sgd_mom_update: the same update of the f32 copy, rounded into
        `weight`."""
        if not self._master_copy(weight):
            return self._device_one(index, weight, grad, state, lr, wd,
                                    rescale)
        mom, w32 = state
        kw = dict(lr=lr, wd=wd, rescale_grad=rescale,
                  clip_gradient=self.clip_gradient)
        if mom is None:
            _ops.mp_sgd_update(weight, grad, w32, **kw)
        else:
            _ops.mp_sgd_mom_update(weight, grad, mom, w32,
                                   momentum=self.momentum, **kw)

    aggregatable = True

    def _device_multi(self, indices, weights, grads, states, hypers):
        """One multi-tensor update per group of parameters that share an
        lr and a wd."""
        kw = dict(rescale_grad=hypers.rescale,
                  clip_gradient=self.clip_gradient)
        for pos, lr, wd in hypers.groups:
            ws, gs = [weights[p] for p in pos], [grads[p] for p in pos]
            if self.momentum == 0.0:
                _ops.multi_sgd_update(ws, gs, lr, wd, **kw)
            else:
                _ops.multi_sgd_mom_update(ws, gs, [states[p] for p in pos],
                                          lr, wd, momentum=self.momentum,
                                          **kw)


@register
class NAG(Optimizer):
    """ref: optimizer.NAG → nag_mom_update (Nesterov momentum), or
    sgd_update without momentum; tensor by tensor, as in the JAX
    package."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def _device_one(self, index, weight, grad, state, lr, wd, rescale):
        kw = dict(lr=lr, wd=wd, rescale_grad=rescale,
                  clip_gradient=self.clip_gradient)
        if state is None:
            _ops.sgd_update(weight, grad, **kw)
        else:
            _ops.nag_mom_update(weight, grad, state, momentum=self.momentum,
                                **kw)


@register
class Adam(Optimizer):
    """ref: optimizer.Adam → adam_update, with the bias correction folded
    into the learning rate from each index's own update count t; the
    aggregated path (`update_multi`) as in the JAX package, whose device
    part is the same per-tensor update, so that both paths give the same
    bits."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return torch.zeros_like(weight), torch.zeros_like(weight)

    def _index_lr(self, index):
        t = self._index_update_count[index]
        return (self._get_lr(index) * math.sqrt(1.0 - self.beta2 ** t)
                / (1.0 - self.beta1 ** t))

    def _device_one(self, index, weight, grad, state, lr, wd, rescale):
        mean, var = state
        _ops.adam_update(weight, grad, mean, var, lr=lr, beta1=self.beta1,
                         beta2=self.beta2, epsilon=self.epsilon, wd=wd,
                         rescale_grad=rescale,
                         clip_gradient=self.clip_gradient)

    aggregatable = True


def _map_state(fn, state):
    """`state` (a tensor, None, or tuples of them) with `fn` applied to
    each tensor."""
    if isinstance(state, (tuple, list)):
        return type(state)(_map_state(fn, s) for s in state)
    return None if state is None else fn(state)


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

    def get_states(self, dump_optimizer=False):
        """The states (and the optimizer, its scheduler and update counts
        included) pickled, every tensor as a CPU tensor of its own
        dtype."""
        states = {i: _map_state(lambda t: t.detach().cpu(), s)
                  for i, s in self.states.items()}
        return pickle.dumps((states, self.optimizer) if dump_optimizer
                            else states)

    def set_states(self, states):
        """Restore what `get_states` pickled (only the port's own files:
        the JAX package's pickle JAX arrays).  The tensors stay on the
        CPU; `Trainer.load_states` moves each to its parameter's
        device."""
        obj = pickle.loads(states)
        if isinstance(obj, tuple):
            self.states, self.optimizer = obj
        else:
            self.states = obj


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
