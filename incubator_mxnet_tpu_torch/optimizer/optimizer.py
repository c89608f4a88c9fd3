"""Optimizers of the PyTorch port (counterpart of
incubator_mxnet_tpu/optimizer/optimizer.py): the `Optimizer` base with
its registry, the fourteen optimizers of the JAX package (`SGD`, `NAG`,
`Adam`, `AdaGrad`, `AdaDelta`, `RMSProp` plain and centered, `Ftrl`,
`Signum`, `SignSGD`, `LAMB`, `Adamax`, `Nadam`, `SGLD`, `Test`), each
registered under its lower-case name with its JAX class's defaults,
state layout and state order, and the `Updater` that keeps per-index
state and saves and restores it with the optimizer.

With an `lr_scheduler`, the learning rate is the scheduler's at the
optimizer's `num_update` (counted before an update reads it, so the
k-th update takes `lr_scheduler(k)`), and `set_learning_rate` raises.
`Test` counts no update and reads `lr` as set, as the JAX class does.

Weights, gradients and states are torch tensors; an update writes the
weight and its state in place (`ops.optimizer`), in the weight's and
the state's own dtype, computing in f32 and rounding once into each
buffer.  With `multi_precision=True` a float16 weight is updated
through an f32 master copy kept in its state, exactly as the JAX
condition `weight.dtype == float16` says; any other dtype (bf16
included) takes the plain update.  An optimizer with
`aggregatable = True` (SGD, Adam) also has `update_multi`, which the
Trainer takes for all its parameters at once, as the JAX Trainer's
aggregated path does; the others update tensor by tensor, as in the JAX
package.

A row_sparse gradient (a `RowSparseNDArray`, or torch's sparse COO
gradient of an `Embedding(sparse_grad=True)`) takes the lazy update of
SGD, Adam or AdaGrad (`ndarray.sparse.sparse_*_update`), which reads and
writes only the gradient's rows, eagerly, with the hypers as Python
numbers: `update` and `update_multi_precision` route it there, and
`update_multi` updates the sparse positions first and the dense ones
after (`_split_sparse`), as the JAX package does.  Another optimizer given
one raises, as does a gradient of any other sparse layout.

Each update is split in two, so that a `gluon.Trainer` can capture the
device part once and replay it (`graph_capture`):

* host bookkeeping, `_hypers(indices)`: the update counts, the
  scheduler's learning rate, the lr and wd multipliers, and the values
  that change from step to step, as Python numbers, every step: Adam's
  bias correction and Adamax's 1 / (1 - beta1^t) folded into the lr;
  LAMB's 1 - beta1^t and 1 - beta2^t (with `bias_correction`); Nadam's
  1 - momentum_t, momentum_{t+1}, 1 - m_schedule, 1 - m_schedule_next
  and 1 - beta2^t, whose `m_schedule` is one product on the optimizer,
  multiplied once per index update in the order the indices are updated
  (pickled with the optimizer, so `save_states` carries it); SGLD's
  sqrt(lr).  These are the `extras` of an index (`_index_extras`);
* the device update, `_device_update(..., hypers)`, which reads the
  lr, wd, `rescale_grad` and the extras as 0-dim f32 tensors and
  branches on no hyper value.  `Hypers` holds them: one f32 vector on
  the device (`_hyper_array`, the counterpart of the JAX package's
  `_hyper_array`, "so schedules don't recompile") with one slot per
  distinct (lr, wd, extras), and the parameters grouped by slot, which
  the multi-tensor updates take one group at a time.  The constants
  that a captured update holds as numbers are `_static_key()`; a
  change of one calls for another capture.  SGLD draws its noise from
  the port's generator of the weight's device (`random.generator`),
  which a capture registers with its graph, so every replay draws anew.

`update`, `update_multi_precision` and `update_multi` run both parts,
with the values put on the weight's device each call.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from .. import random as _rnd
from ..base import MXNetError
from ..ndarray import sparse as _sparse
from ..ops import optimizer as _ops

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "AdaDelta",
           "RMSProp", "Ftrl", "Signum", "SignSGD", "LAMB", "Adamax",
           "Nadam", "SGLD", "Test", "register", "create", "get_updater",
           "Updater"]

#: the constants of the optimizers that a captured update holds as
#: numbers (`Optimizer._static_key`)
_STATIC_ATTRS = ("momentum", "beta1", "beta2", "epsilon", "gamma1",
                 "gamma2", "centered", "clip_weights", "rho", "lamda1",
                 "beta", "wd_lh", "lower_bound", "upper_bound",
                 "bias_correction", "schedule_decay", "float_stable_eps")

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

    def _index_extras(self, index):
        """The per-step values other than lr and wd that an update of
        `index` reads as device hypers, its count already taken (called
        once per index update); () for most optimizers."""
        return ()

    def _hypers(self, indices):
        """Host bookkeeping of one update of each of `indices`, in order:
        count it, then read its lr, wd and extras.  Returns ([lr], [wd],
        [extras])."""
        lrs, wds, extras = [], [], []
        for i in indices:
            self._update_count(i)
            lrs.append(self._index_lr(i))
            wds.append(self._get_wd(i))
            extras.append(self._index_extras(i))
        return lrs, wds, extras

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
    #: wd, rescale_grad, *extras) with 0-dim tensor hypers; None for an
    #: optimizer that has only `update`
    _device_one = None

    def _device_one_mp(self, index, weight, grad, state, *hypers):
        """`_device_one`, or for a master-copied weight the update of its
        f32 copy from the f32 gradient, rounded into `weight`."""
        if self._master_copy(weight):
            inner, w32 = state
            self._device_one(index, w32, grad.float(), inner, *hypers)
            weight.copy_(w32)
        else:
            self._device_one(index, weight, grad, state, *hypers)

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
                    getattr(self, n, None) for n in _STATIC_ATTRS)

    def _run_one(self, device_fn, index, weight, grad, state):
        """Host bookkeeping of one update of `index`, then `device_fn`
        with its hypers on the weight's device."""
        lrs, wds, extras = self._hypers([index])
        hypers = Hypers().write(lrs, wds, self.rescale_grad, weight.device,
                                extras)
        device_fn(index, weight, grad, state, *hypers.at(0))

    def update(self, index, weight, grad, state):
        if _is_row_sparse(grad):
            return self._sparse_update(index, weight, grad, state)
        if self._device_one is None:
            raise NotImplementedError
        self._run_one(self._device_one, index, weight, grad, state)

    #: the lazy update of one row_sparse gradient, (index, weight,
    #: RowSparseNDArray, state, lr, wd) with Python-number hypers; None
    #: for an optimizer that has none
    _sparse_one = None

    def _sparse_update(self, index, weight, grad, state):
        """Host bookkeeping of one update of `index`, then the lazy update
        from the row_sparse `grad`."""
        if self._sparse_one is None:
            raise MXNetError("%s has no lazy update for a row_sparse "
                             "gradient" % type(self).__name__)
        rsp = _as_row_sparse(grad)
        lrs, wds, _ = self._hypers([index])
        with torch.no_grad():
            self._sparse_one(index, weight, rsp, state, lrs[0], wds[0])

    @staticmethod
    def _split_sparse(grads):
        """(dense positions, sparse positions) of a batch of updates: a
        row_sparse gradient takes the lazy update."""
        dense, sparse = [], []
        for k, g in enumerate(grads):
            (sparse if _is_row_sparse(g) else dense).append(k)
        return dense, sparse

    def update_multi_precision(self, index, weight, grad, state):
        """`update`, or for a master-copied weight the update of its f32
        copy from the f32 gradient, rounded into `weight`."""
        if _is_row_sparse(grad):
            return self._sparse_update(index, weight, grad, state)
        if self._device_one is not None:
            self._run_one(self._device_one_mp, index, weight, grad, state)
        elif self._master_copy(weight):
            inner, w32 = state
            self.update(index, w32, grad.float(), inner)
            weight.copy_(w32)
        else:
            self.update(index, weight, grad, state)

    def update_multi(self, indices, weights, grads, states):
        """One aggregated update of the parameters at `indices`: the
        row_sparse gradients' lazy updates first, then the dense ones."""
        dense, sparse = self._split_sparse(grads)
        for k in sparse:
            self._sparse_update(indices[k], weights[k], grads[k], states[k])
        if not dense:
            return
        indices = [indices[k] for k in dense]
        weights = [weights[k] for k in dense]
        grads = [grads[k] for k in dense]
        states = [states[k] for k in dense]
        lrs, wds, extras = self._hypers(indices)
        hypers = Hypers().write(lrs, wds, self.rescale_grad,
                                weights[0].device, extras)
        self._device_multi(indices, weights, grads, states, hypers)

    #: whether `update_multi` updates a list of parameters at once
    aggregatable = False


def _is_row_sparse(grad):
    """Whether `grad` is a row_sparse gradient; a gradient of another
    sparse layout raises."""
    if getattr(grad, "stype", None) == "row_sparse":
        return True
    if not isinstance(grad, torch.Tensor) or grad.layout == torch.strided:
        return False
    if grad.layout == torch.sparse_coo:
        return True
    raise MXNetError("a %s gradient has no update: gradients are dense or "
                     "row_sparse" % (grad.layout,))


def _as_row_sparse(grad):
    from ..ndarray import sparse
    return grad if isinstance(grad, sparse.RowSparseNDArray) else \
        sparse.from_torch_sparse(grad)


class Hypers:
    """The lr, wd, `rescale_grad` and extras (the other per-step values,
    `Optimizer._index_extras`) of one update of a list of parameters, as
    0-dim f32 views of one vector on the device: one slot per distinct
    (lr, wd, extras), in order of first use, each slot's extras after
    all the lrs and wds, then the rescale.  `write` puts a step's values
    in, into the same vector while the layout (the slot of each position
    and the number of extras) holds, so that an update captured on these
    views reads each step's values.  `groups` lists (positions, lr, wd)
    per slot; `at(pos)` gives (lr, wd, rescale, *extras) of a
    position."""

    def __init__(self):
        self.layout = self.vec = None

    def write(self, lrs, wds, rescale, device, extras=None):
        if extras is None:
            extras = [()] * len(lrs)
        slots = {}
        layout = tuple(slots.setdefault((lr, wd) + tuple(ex), len(slots))
                       for lr, wd, ex in zip(lrs, wds, extras))
        layout += (len(extras[0]) if extras else 0,)
        values = [k[0] for k in slots] + [k[1] for k in slots] \
            + [v for k in slots for v in k[2:]] + [rescale]
        if (self.vec is not None and layout == self.layout
                and self.vec.device == torch.device(device)):
            _hyper_array(values, device, out=self.vec)
            return self
        self.layout, self.vec = layout, _hyper_array(values, device)
        m, n_ex = len(slots), layout[-1]
        views = self.vec.unbind()
        self.lr, self.wd, self.rescale = views[:m], views[m:2 * m], \
            views[-1]
        self.extras = [views[2 * m + s * n_ex:2 * m + (s + 1) * n_ex]
                       for s in range(m)]
        self.groups = [([p for p, k in enumerate(layout[:-1]) if k == slot],
                        self.lr[slot], self.wd[slot]) for slot in range(m)]
        return self

    def at(self, pos):
        slot = self.layout[pos]
        return (self.lr[slot], self.wd[slot], self.rescale) \
            + tuple(self.extras[slot])


def _hyper_array(values, device, out=None):
    """`values` as one f32 vector on `device` (ref: the JAX package's
    `_hyper_array`), written into `out` when given: from pinned memory
    without waiting on a card, whose caching host allocator keeps the
    pinned block until the copy has run."""
    host = torch.tensor(values, dtype=torch.float32, device="cpu")
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
    multi_sgd(_mom)_update on the aggregated path.  A row_sparse gradient
    takes `sparse_sgd_update`, which touches only its rows and, as in the
    JAX package, no momentum (`lazy_update` is kept for the API)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def _sparse_one(self, index, weight, grad, state, lr, wd):
        _sparse.sparse_sgd_update(weight, grad, lr, wd, self.rescale_grad,
                                  self.clip_gradient, self.lazy_update)

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
    into the learning rate from each index's own update count t (a
    row_sparse gradient: `sparse_adam_update`, lazy); the
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

    def _sparse_one(self, index, weight, grad, state, lr, wd):
        mean, var = state
        _sparse.sparse_adam_update(weight, grad, mean, var, lr, self.beta1,
                                   self.beta2, self.epsilon, wd,
                                   self.rescale_grad, self.clip_gradient)

    def _device_one(self, index, weight, grad, state, lr, wd, rescale):
        mean, var = state
        _ops.adam_update(weight, grad, mean, var, lr=lr, beta1=self.beta1,
                         beta2=self.beta2, epsilon=self.epsilon, wd=wd,
                         rescale_grad=rescale,
                         clip_gradient=self.clip_gradient)

    aggregatable = True


def _zeros(weight, n):
    """`n` fresh zero states of `weight`'s shape, dtype and device, each
    its own tensor."""
    return tuple(torch.zeros_like(weight) for _ in range(n))


def _pow_f32(base, t):
    """base**t as the JAX package computes `beta ** t` of an f32 hyper
    array and an integer t on the device (`lax.integer_pow`: f32
    products by binary exponentiation), as a Python number."""
    x, acc = np.float32(base), None
    while t > 0:
        if t & 1:
            acc = x if acc is None else np.float32(acc * x)
        t >>= 1
        if t > 0:
            x = np.float32(x * x)
    return float(np.float32(1.0) if acc is None else acc)


@register
class AdaGrad(Optimizer):
    """ref: optimizer.AdaGrad → adagrad_update (`ops.optimizer.
    adagrad_update_`); state: the squared-gradient history.  A row_sparse
    gradient takes `sparse_adagrad_update`, which updates the history and
    the weight on its rows only."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def _sparse_one(self, index, weight, grad, state, lr, wd):
        _sparse.sparse_adagrad_update(weight, grad, state, lr,
                                      self.float_stable_eps, wd,
                                      self.rescale_grad, self.clip_gradient)

    def _device_one(self, index, weight, grad, state, lr, wd, rescale):
        _ops.adagrad_update_(weight, grad, state, lr, wd, rescale,
                             epsilon=self.float_stable_eps,
                             clip_gradient=self.clip_gradient)


@register
class AdaDelta(Optimizer):
    """ref: optimizer.AdaDelta (no learning rate); state (acc_g,
    acc_delta)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _device_one(self, index, weight, grad, state, lr, wd, rescale):
        acc_g, acc_delta = state
        _ops.adadelta_update_(weight, grad, acc_g, acc_delta, wd, rescale,
                              rho=self.rho, epsilon=self.epsilon,
                              clip_gradient=self.clip_gradient)


@register
class RMSProp(Optimizer):
    """ref: optimizer.RMSProp → rmsprop_update, or with `centered`
    rmspropalex_update; state (n,) or, centered, (n, g, delta)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        return _zeros(weight, 3 if self.centered else 1)

    def _device_one(self, index, weight, grad, state, lr, wd, rescale):
        kw = dict(gamma1=self.gamma1, epsilon=self.epsilon,
                  clip_gradient=self.clip_gradient,
                  clip_weights=self.clip_weights)
        if self.centered:
            n, g, delta = state
            _ops.rmspropalex_update_(weight, grad, n, g, delta, lr, wd,
                                     rescale, gamma2=self.gamma2, **kw)
        else:
            _ops.rmsprop_update_(weight, grad, state[0], lr, wd, rescale,
                                 **kw)


@register
class Ftrl(Optimizer):
    """ref: optimizer.Ftrl → ftrl_update; state (z, n)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _device_one(self, index, weight, grad, state, lr, wd, rescale):
        z, n = state
        _ops.ftrl_update_(weight, grad, z, n, lr, wd, rescale,
                          lamda1=self.lamda1, beta=self.beta,
                          clip_gradient=self.clip_gradient)


@register
class Signum(Optimizer):
    """ref: optimizer.Signum → signum_update; with momentum 0 the state
    is None and the update signsgd_update."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros_like(weight)

    def _device_one(self, index, weight, grad, state, lr, wd, rescale):
        if state is None:
            _ops.signsgd_update_(weight, grad, lr, wd, rescale,
                                 clip_gradient=self.clip_gradient)
        else:
            _ops.signum_update_(weight, grad, state, lr, wd, rescale,
                                momentum=self.momentum, wd_lh=self.wd_lh,
                                clip_gradient=self.clip_gradient)


@register
class SignSGD(Signum):
    """ref: optimizer.SignSGD: Signum with momentum 0 by default."""

    def __init__(self, **kwargs):
        kwargs.setdefault("momentum", 0.0)
        super().__init__(**kwargs)


@register
class LAMB(Optimizer):
    """ref: optimizer.LAMB → lamb_update_phase1, the norms, then
    lamb_update_phase2; state (mean, var).  Phase 1 returns g' in the
    gradient's dtype (the JAX `_fused(..., out_ref_idx=(1, 2, 3))`
    rounds it so), r1 = ||w|| and r2 = ||g'|| are taken on the device in
    the weight's and g''s dtypes (`ops.optimizer.lamb_norm`), and phase 2
    reads the weight again, which nothing phase 1 writes aliases.  The
    bias corrections 1 - beta^t are extras, computed as the JAX op
    computes them in f32 (`_pow_f32`)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _index_extras(self, index):
        if not self.bias_correction:
            return ()
        t = self._index_update_count[index]
        one = np.float32(1.0)
        return (float(one - np.float32(_pow_f32(self.beta1, t))),
                float(one - np.float32(_pow_f32(self.beta2, t))))

    def _device_one(self, index, weight, grad, state, lr, wd, rescale,
                    *bias):
        mean, var = state
        gp = _ops.lamb_update_phase1_(
            weight, grad, mean, var, wd, rescale, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon,
            bias1=bias[0] if bias else None,
            bias2=bias[1] if bias else None,
            clip_gradient=self.clip_gradient)
        r1, r2 = _ops.lamb_norm(weight), _ops.lamb_norm(gp)
        _ops.lamb_update_phase2_(weight, gp, r1, r2, lr,
                                 lower_bound=self.lower_bound,
                                 upper_bound=self.upper_bound)


@register
class Adamax(Optimizer):
    """ref: optimizer.Adamax; state (m, u); the bias correction
    1 / (1 - beta1^t) folded into the lr."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _index_lr(self, index):
        t = self._index_update_count[index]
        return self._get_lr(index) / (1.0 - self.beta1 ** t)

    def _device_one(self, index, weight, grad, state, lr, wd, rescale):
        m, u = state
        _ops.adamax_update_(weight, grad, m, u, lr, wd, rescale,
                            beta1=self.beta1, beta2=self.beta2,
                            clip_gradient=self.clip_gradient)


@register
class Nadam(Optimizer):
    """ref: optimizer.Nadam; state (m, v).  `m_schedule` is multiplied
    by momentum_t once per index update, on the host, in the order the
    indices are updated, as the JAX class does; its per-step values
    reach the device as extras (module doc)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return _zeros(weight, 2)

    def _index_extras(self, index):
        t = self._index_update_count[index]
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96 ** (
            (t + 1) * self.schedule_decay))
        self.m_schedule *= momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        return (1.0 - momentum_t, momentum_t_1, 1.0 - self.m_schedule,
                1.0 - m_schedule_next, 1.0 - self.beta2 ** t)

    def _device_one(self, index, weight, grad, state, lr, wd, rescale,
                    *extras):
        m, v = state
        _ops.nadam_update_(weight, grad, m, v, lr, wd, rescale, *extras,
                           beta1=self.beta1, beta2=self.beta2,
                           epsilon=self.epsilon,
                           clip_gradient=self.clip_gradient)


@register
class SGLD(Optimizer):
    """ref: optimizer.SGLD (stochastic gradient Langevin dynamics); no
    state.  The noise N(0, 1) sqrt(lr) is drawn from the port's
    generator of the weight's device, so it is not the JAX package's
    threefry stream: the update is held by its moments."""

    def create_state(self, index, weight):
        return None

    def _index_extras(self, index):
        return (math.sqrt(self._get_lr(index)),)

    def _device_one(self, index, weight, grad, state, lr, wd, rescale,
                    sqrt_lr):
        _ops.sgld_update_(weight, grad, lr, wd, rescale, sqrt_lr,
                          _rnd.generator(weight.device),
                          clip_gradient=self.clip_gradient)


@register
class Test(Optimizer):
    """ref: optimizer.Test: w -= lr g rescale_grad with the `lr` as set
    (no scheduler, no multipliers, no wd) and no update counted; its
    state is zeros that no update reads."""

    def create_state(self, index, weight):
        return torch.zeros_like(weight)

    def _hypers(self, indices):
        n = len(indices)
        return [self.lr] * n, [0.0] * n, [()] * n

    def _device_one(self, index, weight, grad, state, lr, wd, rescale):
        _ops.test_update_(weight, grad, lr, rescale)


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
