"""`Parameter`, `Constant` and `ParameterDict` of the PyTorch port
(counterpart of incubator_mxnet_tpu/gluon/parameter.py).

A `Parameter` is a `torch.nn.Parameter` that also carries the JAX
package's attributes: `name`, `grad_req`, `lr_mult`, `wd_mult`, `init`,
and the methods `initialize`, `set_data`, `list_data`, `list_grad`,
`list_ctx`, `zero_grad`, `reset_ctx` and `cast`.  Torch code sees an
ordinary parameter (`p.grad`, `p.dtype`, `p.detach()`, optimizers,
`state_dict`).

One name collides: MXNet's `param.data()` and `param.grad()` are methods,
torch's `.data` and `.grad` are attributes.  The port keeps torch's;
MXNet's meaning is `list_data()[0]` and `list_grad()[0]` (the latter
after a backward: torch allocates a gradient at the first backward).

Life cycle, as in the JAX package:

* Created, a parameter holds no data (torch's lazy-parameter mechanism,
  `UninitializedTensorMixin`): using it raises, `MXNetError` before
  `initialize` and `DeferredInitializationError` after it while its
  shape is unknown.  A shape may contain 0 for a width taken from the
  first input (`Dense(in_units=0)`).
* `initialize(init, ctx)` with a known shape allocates the tensor on
  `ctx` (default `cuda:0`) and fills it; with an unknown shape it records
  the initializer and the device, and the layer's first forward
  completes it (`_finish_deferred_init`).  The object keeps its
  identity throughout, so a `Trainer` built before the first forward
  updates the tensor the forward materialises.
* `cast(dtype)` before materialisation records the dtype to allocate.

`grad_stype="row_sparse"` (an `Embedding(sparse_grad=True)` weight): the
layer's backward gives torch's COO gradient, which `.grad` holds and
`list_grad()` reads as a `RowSparseNDArray`; `zero_grad` empties it.

`grad_req`: 'write' (the default) has each `autograd.backward` overwrite
the gradient; 'add' keeps adding to it until `zero_grad()`; 'null' is
`requires_grad=False`, and the Trainer neither updates it nor creates
optimizer state for it.

Several contexts (`initialize(ctx=[gpu(0), gpu(1)])`, or CPU replicas
`[cpu(0), ..., cpu(3)]`): the parameter itself is the copy on the first
context and each other context has a copy of its own, a leaf tensor
that `replica(ctx)` returns (with its `.grad`).  `list_data`,
`list_grad` and `list_ctx` list every copy in context order; `set_data`,
`zero_grad`, `cast` and loading write every copy.  A block called with
inputs of another context (`gluon.utils.split_and_load`'s slices) runs
on that context's copies (`gluon.block`), and a `Trainer` sums the
copies' gradients through its kvstore.

`set_data`, `cast`, `reset_ctx`, materialisation and a forced
re-initialization mark the parameter (`touch`), so that the captured
programs that read it (`HybridBlock.hybridize`, `Trainer`) are captured
again.
"""
from __future__ import annotations

import contextlib
import copy
import threading
import warnings
from collections import OrderedDict

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedTensorMixin

from .. import initializer as init_mod
from .. import random as _rnd
from ..base import MXNetError, torch_dtype
from ..context import current_device, resolve_device

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError", "is_deferred", "cast_parameter",
           "shape_pass", "in_shape_pass"]

_GRAD_REQS = ("write", "add", "null")


class DeferredInitializationError(MXNetError):
    """A parameter was used before its (deferred) shape became known."""


def is_deferred(param):
    """Whether `param` holds no data yet (not initialized, or waiting for
    its shape)."""
    return isinstance(param, _DeferredParameter)


_SHAPE_PASS = threading.local()


@contextlib.contextmanager
def shape_pass():
    """A shape-only forward on the meta device (`HybridBlock.infer_shape`):
    inside it a parameter without data whose shape is known stands in as
    an empty meta tensor of that shape, and `block.materialize` records a
    shape without allocating."""
    prev = getattr(_SHAPE_PASS, "on", False)
    _SHAPE_PASS.on = True
    try:
        yield
    finally:
        _SHAPE_PASS.on = prev


def in_shape_pass():
    return getattr(_SHAPE_PASS, "on", False)


def touch(param):
    """Mark `param`'s data as replaced or rewritten outside training: a
    hybridized block's and a Trainer's captured programs that read it are
    captured again (`gluon.block`, `gluon.trainer`)."""
    param.__dict__["_graph_version"] = \
        param.__dict__.get("_graph_version", 0) + 1


@torch.no_grad()
def cast_parameter(param, dtype):
    """Cast `param` (any `nn.Parameter`) in place to `dtype`, keeping the
    object: its data is replaced and its gradient dropped (ref:
    Parameter.cast)."""
    dt = torch_dtype(dtype)
    if param.dtype != dt:
        param.data = param.data.to(dt)
        param.grad = None
        touch(param)


def _contexts(ctx):
    """The contexts of `ctx` (a device, its name, or a list of them) as a
    list; None means [`current_device()`]."""
    from ..context import _norm
    if ctx is None:
        return [current_device()]
    ctxs = list(ctx) if isinstance(ctx, (list, tuple)) else [ctx]
    if not ctxs:
        raise MXNetError("ctx must name at least one device")
    out = [_norm(resolve_device(c)) for c in ctxs]
    if len(set(out)) != len(out):
        raise MXNetError("ctx lists a context twice: %s" % out)
    return out


def _one_device(ctx):
    """The first device of `ctx`; None means `current_device()`."""
    dev = _contexts(ctx)[0]
    return torch.device("cpu") if dev.type == "cpu" else dev


class Parameter(nn.Parameter):
    """ref: gluon.Parameter (module doc).  `Parameter(name, grad_req,
    shape, dtype, lr_mult, wd_mult, init, allow_deferred_init,
    differentiable)` makes a parameter without data."""

    def __new__(cls, name="", grad_req="write", shape=None,
                dtype="float32", lr_mult=1.0, wd_mult=1.0, init=None,
                allow_deferred_init=False, differentiable=True,
                stype="default", grad_stype="default"):
        req = grad_req if differentiable else "null"
        if stype != "default" or grad_stype not in ("default",
                                                     "row_sparse"):
            raise MXNetError("parameter %s: stype %r / grad_stype %r: a "
                             "parameter's data is dense, its gradient "
                             "dense or row_sparse" % (name, stype,
                                                      grad_stype))
        if req not in _GRAD_REQS:
            raise ValueError("grad_req must be one of %s, got %r"
                             % (_GRAD_REQS, grad_req))
        if isinstance(shape, int):
            shape = (shape,)
        obj = torch.Tensor._make_subclass(
            _DeferredParameter, torch.empty(0, dtype=torch_dtype(dtype)),
            req != "null")
        obj.__dict__.update(
            _name=name, _grad_req=req, lr_mult=lr_mult, wd_mult=wd_mult,
            init=init, allow_deferred_init=allow_deferred_init,
            _shape=tuple(shape) if shape is not None else None,
            _deferred_init=None, _final_cls=cls, _grad_stype=grad_stype)
        return obj

    def __init__(self, *args, **kwargs):
        """Everything is set in `__new__`."""

    # torch's Tensor has a read-only `name`; the port's parameter has
    # the JAX package's writable one
    @property
    def name(self):
        return self.__dict__.get("_name", "")

    @name.setter
    def name(self, value):
        self.__dict__["_name"] = value

    @property
    def grad_req(self):
        return self.__dict__.get("_grad_req", "write")

    @grad_req.setter
    def grad_req(self, req):
        if req not in _GRAD_REQS:
            raise ValueError("grad_req must be one of %s, got %r"
                             % (_GRAD_REQS, req))
        self.__dict__["_grad_req"] = req
        if req == "null":
            self.grad = None
        self.requires_grad = req != "null"

    @property
    def stype(self):
        """The data's storage type: always "default"."""
        return "default"

    @property
    def grad_stype(self):
        """The gradient's storage type, "default" or "row_sparse" (an
        `Embedding(sparse_grad=True)` weight)."""
        return self.__dict__.get("_grad_stype", "default")

    def _shape_known(self):
        shape = self.__dict__.get("_shape")
        return shape is not None and all(s > 0 for s in shape)

    def _set_shape(self, shape):
        """Fill the unknown (0) entries of the shape; a known entry must
        agree."""
        shape = tuple(int(s) for s in shape)
        old = self.__dict__.get("_shape")
        if old is not None and (len(old) != len(shape) or any(
                a not in (0, -1, b) for a, b in zip(old, shape))):
            raise MXNetError("cannot reset shape of parameter %s from %s "
                             "to %s" % (self.name, old, shape))
        self.__dict__["_shape"] = shape

    # -- initialization ----------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Allocate on `ctx` (default `cuda:0`) and fill with `init`, else
        the parameter's own `init`, else `default_init` (default
        `Uniform()`).  With an unknown shape the fill waits for the first
        forward.  An initialized parameter warns and keeps its data
        unless `force_reinit`."""
        default_init = default_init or init_mod.Uniform()
        ctxs = _contexts(ctx)
        dev = _one_device(ctxs)
        if not is_deferred(self):
            if not force_reinit:
                warnings.warn("parameter %s is already initialized, "
                              "ignoring; set force_reinit=True to "
                              "re-initialize" % self.name, stacklevel=2)
                return
            if self.device != dev:
                self.data = self.data.to(dev)
                self.grad = None
            self._fill(init, default_init)
            self._set_contexts(ctxs)
            touch(self)
            return
        self._note_contexts(ctxs)
        if not self._shape_known():
            if not self.allow_deferred_init:
                raise MXNetError(
                    "cannot initialize parameter %s: shape %s is unknown "
                    "and deferred initialization is not allowed"
                    % (self.name, self._shape))
            # the placeholder's device is where the forward allocates
            self.__dict__["_deferred_init"] = (init, default_init)
            self.data = torch.empty(0, device=dev, dtype=self.dtype)
            return
        self._materialize(dev)
        self._fill(init, default_init)
        self._set_contexts(ctxs)

    @torch.no_grad()
    def _set_contexts(self, ctxs):
        """Keep a copy of the data on each context after the first."""
        self._note_contexts(ctxs)
        reps = {}
        for c in ctxs[1:]:
            dev = torch.device("cpu") if c.type == "cpu" else c
            reps[c] = self.detach().to(dev, copy=True).requires_grad_(
                self.requires_grad)
        self.__dict__["_replicas"] = reps

    def _note_contexts(self, ctxs):
        """Record several contexts (one is the tensor's own device, which
        `list_ctx` reads, so that a move of the module stays seen)."""
        if len(ctxs) > 1:
            self.__dict__["_ctx_list"] = list(ctxs)
        else:
            self.__dict__.pop("_ctx_list", None)

    def _copies(self):
        """[this tensor] and its copies on the other contexts."""
        return [self] + list(self.__dict__.get("_replicas", {}).values())

    def replica(self, ctx):
        """The copy on context `ctx` (this tensor for the first
        context); its `.grad` is that copy's gradient (MXNet's
        `data(ctx)` and `grad(ctx)`)."""
        from ..context import _norm
        self._check_initialized()
        c = _norm(resolve_device(ctx))
        ctxs = self.list_ctx()
        if c == ctxs[0]:
            return self
        reps = self.__dict__.get("_replicas", {})
        if c not in reps:
            raise MXNetError("parameter %s has no copy on %s (its contexts: "
                             "%s)" % (self.name, c, ctxs))
        return reps[c]

    def _materialize(self, dev):
        """Allocate the tensor (uninitialized values) on `dev` and become
        the final class."""
        self.data = torch.empty(self._shape, device=dev, dtype=self.dtype)
        touch(self)
        self.__dict__["_deferred_init"] = None
        self.__class__ = self.__dict__["_final_cls"]
        self.requires_grad_(self.grad_req != "null")

    @torch.no_grad()
    def _fill(self, init, default_init):
        chosen = init or self.init or default_init
        if not callable(chosen):
            chosen = init_mod.create(chosen)
        chosen(self.name, self.data, _rnd.generator(self.device))

    def _finish_deferred_init(self):
        """Complete a deferred `initialize` once the shape is known."""
        if not is_deferred(self):
            return
        self._check_initialized()
        if not self._shape_known():
            raise DeferredInitializationError(
                "parameter %s has unknown shape %s"
                % (self.name, self._shape))
        init, default_init = self._deferred_init
        self._materialize(self.data.device)
        self._fill(init, default_init)
        self._set_contexts(self.__dict__.get("_ctx_list")
                           or [self.device])

    def _check_initialized(self):
        if not is_deferred(self):
            return
        if self.__dict__.get("_deferred_init") is not None:
            if self._shape_known():
                return
            raise DeferredInitializationError(
                "parameter %s has not been initialized yet: its shape %s "
                "is taken from the first forward's input"
                % (self.name, self._shape))
        raise MXNetError("parameter %s has not been initialized; call "
                         "initialize() first" % self.name)

    # -- data --------------------------------------------------------------
    def list_data(self):
        """[the tensor] (MXNet's `data()`; torch's `.data` is kept)."""
        self._check_initialized()
        return self._copies()

    def list_grad(self):
        """[the gradient], or [] for grad_req 'null' or before the first
        backward (MXNet's `grad()`; torch's `.grad` is kept).  A
        row_sparse gradient is read from the live `.grad` (torch's COO
        tensor, coalesced in place) as a `RowSparseNDArray`, an empty one
        before any backward."""
        self._check_initialized()
        if self.grad_stype == "row_sparse" and self.grad_req != "null":
            return [self._row_sparse_grad()]
        copies = self._copies()
        if len(copies) > 1 and self.grad_req != "null":
            for t in copies:
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
            return [t.grad for t in copies]
        return [] if self.grad is None else [self.grad]

    def _row_sparse_grad(self):
        from ..ndarray import sparse
        from ..ndarray.ndarray import _wrap
        g = self.grad
        if g is None:
            return sparse.zeros_row_sparse(self.shape, self.dtype,
                                           ctx=self.device)
        if not g.is_sparse:
            return sparse.cast_storage(_wrap(g), "row_sparse")
        if not g.is_coalesced():
            g = self.grad = g.coalesce()
        return sparse.from_torch_sparse(g)

    def list_ctx(self):
        ctxs = self.__dict__.get("_ctx_list")
        if is_deferred(self) and self._deferred_init is not None:
            return list(ctxs) if ctxs else [self.data.device]
        self._check_initialized()
        return list(ctxs) if ctxs else [self.device]

    def zero_grad(self):
        """Zero the gradient; a row_sparse one becomes empty (no rows)."""
        if self.grad_stype == "row_sparse" and self.grad_req != "null" \
                and not is_deferred(self):
            from ..ndarray.sparse import empty_coo
            self.grad = empty_coo(self.shape, self.dtype, self.device)
        else:
            for t in self._copies():
                if t.grad is not None:
                    t.grad.zero_()

    @torch.no_grad()
    def set_data(self, data):
        """Copy `data` (a tensor or an array) in, in the parameter's dtype;
        completes a deferred initialization from its shape."""
        data = torch.as_tensor(np.asarray(data)) \
            if not isinstance(data, torch.Tensor) else data
        self._set_shape(data.shape)
        if is_deferred(self):
            if self._deferred_init is None:
                raise MXNetError("parameter %s has not been initialized"
                                 % self.name)
            self._materialize(self.data.device)
            self._set_contexts(self.__dict__.get("_ctx_list")
                               or [self.device])
        for t in self._copies():
            t.data.copy_(data)
        touch(self)

    def _load_and_set(self, data, ctx=None):
        """Set from a loaded tensor; a parameter without data takes its
        shape and is allocated on `ctx`, else on its initialize()
        device, else `cuda:0` (ref: parameter.py _load_and_set)."""
        if is_deferred(self):
            self._set_shape(data.shape)
            if ctx is not None:
                ctxs = _contexts(ctx)
            elif self._deferred_init is not None:
                ctxs = self.__dict__.get("_ctx_list") or [self.data.device]
            else:
                ctxs = [current_device()]
            self._materialize(_one_device(ctxs))
            self._set_contexts(ctxs)
        self.set_data(data)

    def reset_ctx(self, ctx):
        """Move the data (or the recorded device of a deferred one) to
        `ctx`."""
        ctxs = _contexts(ctx)
        if is_deferred(self) and self._deferred_init is None:
            self._check_initialized()
        self.data = self.data.to(_one_device(ctxs))
        self.grad = None
        if is_deferred(self):
            self._note_contexts(ctxs)
        else:
            self._set_contexts(ctxs)
        touch(self)

    def cast(self, dtype):
        """Cast in place to `dtype`, keeping the object; its gradient is
        dropped.  Before materialisation, the dtype to allocate."""
        cast_parameter(self, dtype)
        if not is_deferred(self) and self.__dict__.get("_replicas"):
            self._set_contexts(self.list_ctx())

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        result = torch.Tensor._make_subclass(
            type(self), self.data.clone(memory_format=torch.preserve_format),
            self.requires_grad)
        memo[id(self)] = result
        result.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return result

    def __repr__(self):
        shape = self._shape if is_deferred(self) else tuple(self.shape)
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, shape, str(self.dtype).replace("torch.", ""))


class _DeferredParameter(UninitializedTensorMixin, Parameter):
    """A `Parameter` without data; it becomes its final class when it is
    materialised (module doc)."""

    @property
    def shape(self):
        """The JAX package's view: the known widths, 0 for a deferred
        one."""
        return self.__dict__.get("_shape")

    @shape.setter
    def shape(self, shape):
        """Fill the unknown widths, as a block's `infer_shape` does (ref:
        Parameter.shape's setter)."""
        self._set_shape(shape)

    __repr__ = Parameter.__repr__

    def _meta(self):
        return torch.empty(self._shape, dtype=self.dtype, device="meta")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in cls._allowed_methods or \
                func.__class__.__name__ == "method-wrapper":
            return super().__torch_function__(func, types, args, kwargs)
        kwargs = kwargs or {}
        if in_shape_pass() and all(
                a._shape_known() for a in list(args) + list(kwargs.values())
                if isinstance(a, _DeferredParameter)):
            def meta(a):
                return a._meta() if isinstance(a, _DeferredParameter) else a
            return func(*[meta(a) for a in args],
                        **{k: meta(v) for k, v in kwargs.items()})
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, _DeferredParameter):
                a._check_initialized()
                raise DeferredInitializationError(
                    "parameter %s has no data yet; run a forward to "
                    "complete its deferred initialization" % a.name)
        raise DeferredInitializationError("a parameter has no data yet")


class Constant(Parameter):
    """ref: gluon.Constant: a parameter with grad_req 'null' that
    initializes to `value`."""

    def __new__(cls, name, value):
        value = value.detach().cpu() if isinstance(value, torch.Tensor) \
            else torch.as_tensor(np.asarray(value))
        if value.dtype == torch.float64:     # the JAX package's default
            value = value.float()
        obj = super().__new__(cls, name, grad_req="null",
                              shape=tuple(value.shape),
                              dtype=str(value.dtype).replace("torch.", ""),
                              init=_ValueInit(value))
        obj.__dict__["value"] = value
        return obj


class _ValueInit(init_mod.Initializer):
    """Fills with a fixed value, whatever the parameter's name."""

    def __init__(self, value):
        super().__init__()
        self.value = value

    @torch.no_grad()
    def __call__(self, name, tensor, generator=None):
        tensor.copy_(self.value)


class ParameterDict(OrderedDict):
    """ref: gluon.ParameterDict: an ordered {name: Parameter} mapping,
    which `Block.collect_params()` returns keyed by structural names.
    It is a dict, so `dict(net.collect_params())` and `.values()` work as
    on any dict."""

    def __init__(self, prefix="", shared=None):
        super().__init__()
        self._prefix = prefix
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def get(self, name, **kwargs):
        """The parameter `prefix + name`, created with `kwargs` if it does
        not exist; an existing one takes a given shape or dtype."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            OrderedDict.__setitem__(self, name, param)
            return param
        for k, v in kwargs.items():
            if k == "shape" and v is not None:
                param._set_shape((v,) if isinstance(v, int) else v)
            elif k == "dtype" and v is not None:
                param.cast(v)
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise MXNetError("constant %s not found" % name)
            param = Constant(name, value)
            OrderedDict.__setitem__(self, name, param)
        return param

    def _get_impl(self, name):
        if name in self:
            return self[name]
        if self._shared is not None and name in self._shared:
            OrderedDict.__setitem__(self, name, self._shared[name])
            return self[name]
        return None

    def update(self, other):
        """Add `other`'s entries; a name bound to another parameter
        raises."""
        for k, v in other.items():
            if k in self and self[k] is not v:
                raise MXNetError("duplicate parameter name %s" % k)
            OrderedDict.__setitem__(self, k, v)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """`initialize` every parameter, with `init` as the default
        initializer (each parameter's own `init` comes first)."""
        for param in self.values():
            param.initialize(None, ctx, default_init=init,
                             force_reinit=force_reinit)

    def zero_grad(self):
        for param in self.values():
            param.zero_grad()

    def reset_ctx(self, ctx):
        for param in self.values():
            param.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set attribute `name` (lr_mult, wd_mult, grad_req, ...) of every
        parameter."""
        for param in self.values():
            setattr(param, name, value)

    def save(self, fname, strip_prefix=""):
        """Save the materialised parameters under their keys, less
        `strip_prefix`, in the JAX package's file format."""
        from .. import ndarray as nd
        out = OrderedDict()
        for name, param in self.items():
            if is_deferred(param):
                continue
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            out[name] = param
        nd.save(fname, out)

    def load(self, fname, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from .. import ndarray as nd
        loaded = nd._load_tensors(fname, ctx="cpu")
        if restore_prefix:
            loaded = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self:
                if name not in loaded:
                    raise MXNetError("parameter %s missing in file" % name)
        if not ignore_extra:
            extra = set(loaded) - set(self.keys())
            if extra:
                raise MXNetError("extra parameters in file: %s" % extra)
        for name, param in self.items():
            if name in loaded:
                param._load_and_set(loaded[name], ctx)

    def __repr__(self):
        return "ParameterDict(%s)" % ", ".join(self.keys())
