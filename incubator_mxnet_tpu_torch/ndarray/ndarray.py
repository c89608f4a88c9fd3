"""NDArray of the PyTorch port (counterpart of
incubator_mxnet_tpu/ndarray/ndarray.py; ref: include/mxnet/ndarray.h).

An `NDArray` wraps a torch tensor (`_data`); it is not a `torch.Tensor`
subclass, because MXNet's `size`, `dtype`, `reshape`, `flatten`,
`split`, `sort`, `max(axis=)`, `__eq__` and `grad` mean other things than
torch's.  Its methods and operators dispatch through the op registry
(`invoke`), as `mx.nd`'s generated functions do.

* **Mutation is rebinding**, as in the JAX package: `x += y`, `x[i] = v`,
  `copyto` and an op's `out=` give the array a new tensor and never write
  the old one, so an array made from x before the write (a reshape, a
  slice, which torch may answer with a view of the same storage) does not
  see it.
* **Recording**: an op records (builds torch's graph) only inside
  `autograd.record()` and only if it is differentiable; elsewhere it runs
  with torch's grad mode off.  Inputs at an op's `nograd_argnums` are
  detached.
* **Gradients**: `attach_grad()` makes the array a leaf (a tensor that
  requires grad and names the array as its owner); a backward through it
  writes the array's `.grad`, an NDArray, per `grad_req` ('write',
  'add', 'null'), and leaves torch's `Tensor.grad` empty.  A write to an
  attached array (`x[:] = 0`, `out=x`) keeps it a leaf with its gradient.
* **Dtypes** follow the JAX package with 64-bit types off: a Python list
  or a float64 source becomes float32, an int64 source int32, and an op
  result of a 64-bit type its 32-bit sibling.
"""
from __future__ import annotations

import weakref

import numpy as _np
import torch

from .. import autograd as _ag
from .. import engine as _engine
from .. import random as _rnd
from ..base import nd_dtype
from ..context import resolve_device, tag_replica
from ..ops import registry as _registry
from ..ops.tensor import _take_slice

__all__ = ["NDArray", "invoke", "apply_fn", "array", "unwrap"]

numeric_types = (float, int, _np.generic)
_X64 = {torch.float64: torch.float32, torch.int64: torch.int32,
        torch.uint64: torch.uint32}
_REGISTRY = _registry._REGISTRY


def _wrap(t):
    """An NDArray over tensor `t`, as it is."""
    nd = NDArray.__new__(NDArray)
    nd._data = t
    nd._grad = None
    nd._grad_req = None
    return nd


def _narrow(t):
    dt = _X64.get(t.dtype)
    return t if dt is None else t.to(dt)


def unwrap(x):
    """`x`'s tensor if it is an NDArray, else `x`."""
    return x._data if isinstance(x, NDArray) else x


def _symbol_error(name):
    return NotImplementedError("%s on a Symbol: the symbol front end is "
                               "not yet ported" % (name or "op"))


def apply_fn(fn, nd_args, kwargs, *, name="", differentiable=True,
             ctx=None, nograd_argnums=()):
    """Core imperative dispatch (the analogue of Imperative::Invoke).

    `nd_args` are positional arguments, NDArray items the tensor inputs
    (NDArray keyword values are tensor inputs too).  `fn` runs on their
    tensors; it records only while `autograd` records and the op is
    differentiable.  A 64-bit result is narrowed to 32 bits.  `out=`
    (an NDArray, or a tuple of them for several outputs) takes the
    results by rebinding and is returned."""
    out_nd = kwargs.pop("out", None) if kwargs else None
    raw = []
    has_tensor = False
    for i, a in enumerate(nd_args):
        if isinstance(a, NDArray):
            has_tensor = True
            a = a._data
            if i in nograd_argnums:
                a = a.detach()
        elif type(a).__name__ == "Symbol":
            raise _symbol_error(name)
        raw.append(a)
    for k, v in kwargs.items():
        if isinstance(v, NDArray):
            has_tensor = True
            kwargs[k] = v._data
        elif type(v).__name__ == "Symbol":
            raise _symbol_error(name)
    if not has_tensor:
        with torch.device(resolve_device(ctx)), torch.no_grad():
            out = fn(*raw, **kwargs)
    elif differentiable and _ag.is_recording():
        out = fn(*raw, **kwargs)
    else:
        # torch.no_grad() as a context manager costs more than the op
        prev = torch.is_grad_enabled()
        torch._C._set_grad_enabled(False)
        try:
            out = fn(*raw, **kwargs)
        finally:
            torch._C._set_grad_enabled(prev)
    if not isinstance(out, (tuple, list)):
        res = _wrap(_narrow(out))
        if out_nd is None:
            return res
        out_nd._rebind(res._data)
        return out_nd
    wrapped = tuple(_wrap(_narrow(o)) for o in out)
    if out_nd is None:
        return wrapped
    dsts = out_nd if isinstance(out_nd, (tuple, list)) else (out_nd,)
    for dst, src in zip(dsts, wrapped):
        dst._rebind(src._data)
    return out_nd


def invoke(opname, *args, **kwargs):
    """Invoke a registered operator imperatively (the generated stubs'
    entry, ref: _imperative_invoke).  `ctx=` places an op without tensor
    inputs (default `cuda:0`); a sampling op draws from its device's
    generator and a BatchNorm or Dropout reads `autograd.is_training()`,
    unless the caller passes `_rng_key` or `_training`.  An op with a
    sparse path (`OpDef.sparse_invoke`) is offered the call first.  A
    Symbol argument raises "not yet ported"."""
    od = _REGISTRY[opname]
    if od.sparse_invoke is not None:
        res = od.sparse_invoke(args, kwargs)
        if res is not NotImplemented:
            return res
    ctx = None
    if kwargs:
        ctx = kwargs.pop("ctx", None)
        if ctx is None:
            ctx = kwargs.pop("context", None)
    if od.needs_rng and "_rng_key" not in kwargs:
        kwargs["_rng_key"] = _rnd.generator(_device_of(args, kwargs, ctx))
    if od.needs_training and "_training" not in kwargs:
        kwargs["_training"] = _ag.is_training()
    if _engine._LISTENERS or _engine._NAIVE:
        return _engine.dispatched(
            od.name, _device_of(args, kwargs, ctx), lambda: apply_fn(
                od.fn, args, kwargs, name=od.name,
                differentiable=od.differentiable, ctx=ctx,
                nograd_argnums=od.nograd_argnums))
    return apply_fn(od.fn, args, kwargs, name=od.name,
                    differentiable=od.differentiable, ctx=ctx,
                    nograd_argnums=od.nograd_argnums)


def _device_of(args, kwargs, ctx):
    for a in args:
        if isinstance(a, NDArray):
            return a._data.device
    for a in kwargs.values():
        if isinstance(a, NDArray):
            return a._data.device
    return resolve_device(ctx)


def _index(data, key):
    """data[key], a slice of negative step included (which torch's
    indexing does not take) when key is basic (ints and slices)."""
    parts = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in parts):
        return data[key]
    out, dim = data, 0
    for k in parts:
        if isinstance(k, slice):
            out = _take_slice(out, dim, k.start, k.stop, k.step)
            dim += 1
        elif isinstance(k, int):
            out = out.select(dim, k)
        else:
            raise IndexError("a negative-step slice combined with %r is "
                             "not supported" % (k,))
    return out


class NDArray:
    """Multi-dimensional array on a device (ref: mx.nd.NDArray)."""

    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")
    # numpy scalars defer to NDArray's reflected operators
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        dt = nd_dtype(dtype)
        if isinstance(data, torch.Tensor):
            if ctx is None:
                ctx = getattr(data, "_mx_ctx", None)
            t = data.detach()
            dev = t.device if ctx is None else resolve_device(ctx)
            t = t.to(device=dev, dtype=_X64.get(t.dtype, t.dtype)
                     if dt is None else dt, copy=True)
        else:
            src_has_dtype = hasattr(data, "dtype")
            npd = _np.asarray(data)
            if dt is None and (not src_has_dtype
                               or npd.dtype == _np.float64) \
                    and npd.dtype != _np.bool_:
                dt = torch.float32
            t = torch.from_numpy(_np.array(npd, copy=True))
            t = t.to(device=resolve_device(ctx),
                     dtype=_X64.get(t.dtype, t.dtype) if dt is None else dt)
        if ctx is not None:
            tag_replica(t, torch.device(ctx))
        self._data = t
        self._grad = None
        self._grad_req = None

    def _rebind(self, t):
        """Give the array the tensor `t` (a write, as the JAX package's
        buffer rebinding).  An array with a gradient attached stays a leaf
        when `t` is not itself recorded."""
        if self._grad_req not in (None, "null") and t.grad_fn is None \
                and t.dtype.is_floating_point:
            t = t.detach().requires_grad_(True)
            t._mx_owner = weakref.ref(self)
        self._data = t

    # ------------------------------------------------------------------
    # properties
    # ------------------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype (bfloat16, which numpy lacks, as
        `torch.bfloat16`)."""
        dt = self._data.dtype
        if dt == torch.bfloat16:
            return dt
        return _np.dtype(str(dt).replace("torch.", ""))

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self):
        """The array's device, or the replica context (`cpu(i)`) its
        tensor was marked with (`context.tag_replica`)."""
        return getattr(self._data, "_mx_ctx", None) or self._data.device

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        return invoke("transpose", self)

    # ------------------------------------------------------------------
    # sync / conversion
    # ------------------------------------------------------------------
    def asnumpy(self) -> _np.ndarray:
        """A host copy; bfloat16 comes back as float32 (numpy has no
        bfloat16)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("ambiguous truth value of multi-element NDArray")

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of 0-d NDArray")
        return self.shape[0]

    def tolist(self):
        return self.asnumpy().tolist()

    def wait_to_read(self):
        """Wait for the work that writes this array (the card's stream)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def copy(self):
        return _wrap(self._data.detach().clone())

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._rebind(self._data.detach().to(other._data.device,
                                                 copy=True))
            return other
        return _wrap(self._data.detach().to(resolve_device(other),
                                            copy=True))

    def as_in_context(self, ctx):
        dev = resolve_device(ctx)
        if dev == self.context:
            return self
        return _wrap(tag_replica(self._data.detach().to(dev, copy=True),
                                 dev))

    as_in_ctx = as_in_context

    def as_np_ndarray(self):
        return self

    def astype(self, dtype, copy=True):
        if not copy and self._data.dtype == nd_dtype(dtype):
            return self
        return invoke("cast", self, dtype=dtype)

    # ------------------------------------------------------------------
    # autograd (ref: MXNDArrayAttachGrad / MXAutogradBackward)
    # ------------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Make the array a leaf with a zero gradient buffer `.grad` (with
        `stype="row_sparse"` an empty `RowSparseNDArray`, which a backward
        replaces by the rows it reaches; any other stype is dense, as in
        the JAX package); a recorded history no longer flows through
        it."""
        t = self._data.detach()
        if grad_req != "null" and t.dtype.is_floating_point:
            t.requires_grad_(True)
            t._mx_owner = weakref.ref(self)
        self._data = t
        if stype == "row_sparse":
            from .sparse import zeros_row_sparse
            self._grad = zeros_row_sparse(t.shape, t.dtype, ctx=t.device)
        else:
            self._grad = _wrap(torch.zeros_like(t))
        self._grad_req = grad_req

    def detach(self):
        return _wrap(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _ag.backward([self], [out_grad] if out_grad is not None else None,
                     retain_graph=retain_graph, train_mode=train_mode)

    # ------------------------------------------------------------------
    # shape ops as methods
    # ------------------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return invoke("reshape", self, shape=shape, **kwargs)

    def reshape_like(self, other):
        return invoke("reshape_like", self, other)

    def expand_dims(self, axis):
        return invoke("expand_dims", self, axis=axis)

    def squeeze(self, axis=None):
        return invoke("squeeze", self, axis=axis)

    def flatten(self):
        return invoke("Flatten", self)

    def transpose(self, axes=None):
        return invoke("transpose", self, axes=axes)

    def swapaxes(self, dim1, dim2):
        return invoke("swapaxes", self, dim1=dim1, dim2=dim2)

    def flip(self, axis):
        return invoke("flip", self, axis=axis)

    def tile(self, reps):
        return invoke("tile", self, reps=reps)

    def repeat(self, repeats, axis=None):
        return invoke("repeat", self, repeats=repeats, axis=axis)

    def broadcast_to(self, shape):
        return invoke("broadcast_to", self, shape=shape)

    def broadcast_like(self, other):
        return invoke("broadcast_like", self, other)

    def slice(self, begin, end, step=None):
        return invoke("slice", self, begin=begin, end=end, step=step or ())

    def slice_axis(self, axis, begin, end):
        return invoke("slice_axis", self, axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return invoke("take", self, indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False):
        return invoke("pick", self, index, axis=axis, keepdims=keepdims)

    def one_hot(self, depth, **kw):
        return invoke("one_hot", self, depth=depth, **kw)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke("split", self, num_outputs=num_outputs, axis=axis,
                      squeeze_axis=squeeze_axis)

    # ------------------------------------------------------------------
    # math as methods (through the registry, so that they record)
    # ------------------------------------------------------------------
    def sum(self, axis=None, keepdims=False, **kw):
        return invoke("sum", self, axis=axis, keepdims=keepdims, **kw)

    def mean(self, axis=None, keepdims=False, **kw):
        return invoke("mean", self, axis=axis, keepdims=keepdims, **kw)

    def prod(self, axis=None, keepdims=False, **kw):
        return invoke("prod", self, axis=axis, keepdims=keepdims, **kw)

    def max(self, axis=None, keepdims=False, **kw):
        return invoke("max", self, axis=axis, keepdims=keepdims, **kw)

    def min(self, axis=None, keepdims=False, **kw):
        return invoke("min", self, axis=axis, keepdims=keepdims, **kw)

    def norm(self, **kw):
        return invoke("norm", self, **kw)

    def argmax(self, axis=None, keepdims=False):
        return invoke("argmax", self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return invoke("argmin", self, axis=axis, keepdims=keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        return invoke("argsort", self, axis=axis, is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return invoke("sort", self, axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, **kw):
        return invoke("topk", self, axis=axis, k=k, **kw)

    def abs(self):
        return invoke("abs", self)

    def sign(self):
        return invoke("sign", self)

    def sqrt(self):
        return invoke("sqrt", self)

    def square(self):
        return invoke("square", self)

    def exp(self):
        return invoke("exp", self)

    def log(self):
        return invoke("log", self)

    def relu(self):
        return invoke("relu", self)

    def sigmoid(self):
        return invoke("sigmoid", self)

    def tanh(self):
        return invoke("tanh", self)

    def softmax(self, axis=-1):
        return invoke("softmax", self, axis=axis)

    def log_softmax(self, axis=-1):
        return invoke("log_softmax", self, axis=axis)

    def clip(self, a_min, a_max):
        return invoke("clip", self, a_min=a_min, a_max=a_max)

    def dot(self, other, **kw):
        return invoke("dot", self, other, **kw)

    def zeros_like(self):
        return invoke("zeros_like", self)

    def ones_like(self):
        return invoke("ones_like", self)

    def tostype(self, stype):
        """This array in storage `stype` ("default", "row_sparse",
        "csr"; `sparse.cast_storage`)."""
        if stype == "default":
            return self
        from .sparse import cast_storage
        return cast_storage(self, stype)

    # ------------------------------------------------------------------
    # operators
    # ------------------------------------------------------------------
    def _binary(self, other, op, scalar_op, rscalar_op=None, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke(op, a, b)
        if isinstance(other, numeric_types):
            if reverse and rscalar_op is not None:
                return invoke(rscalar_op, self, scalar=other)
            return invoke(scalar_op, self, scalar=other)
        return NotImplemented

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar",
                            "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar",
                            "_rdiv_scalar", reverse=True)

    def __mod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar",
                            "_rmod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar",
                            "_rpower_scalar", reverse=True)

    def __matmul__(self, o):
        return invoke("dot", self, o)

    def __neg__(self):
        return invoke("negative", self)

    def __abs__(self):
        return invoke("abs", self)

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    __hash__ = object.__hash__

    # in place: rebind the tensor, as the JAX package rebinds its buffer
    def __iadd__(self, o):
        self._rebind(self.__add__(o)._data)
        return self

    def __isub__(self, o):
        self._rebind(self.__sub__(o)._data)
        return self

    def __imul__(self, o):
        self._rebind(self.__mul__(o)._data)
        return self

    def __itruediv__(self, o):
        self._rebind(self.__truediv__(o)._data)
        return self

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------
    @staticmethod
    def _conv_index(key):
        if isinstance(key, NDArray):
            return key._data
        if isinstance(key, tuple):
            return tuple(k._data if isinstance(k, NDArray) else k
                         for k in key)
        return key

    def __getitem__(self, key):
        tkey = self._conv_index(key)
        return apply_fn(lambda d: _index(d, tkey), [self], {},
                        name="getitem")

    def __setitem__(self, key, value):
        tkey = self._conv_index(key)
        new = self._data.detach().clone()
        if isinstance(value, NDArray):
            value = value._data.detach()
        elif not isinstance(value, numeric_types):
            value = torch.as_tensor(_np.asarray(value))
        if isinstance(value, torch.Tensor):
            value = value.to(device=new.device, dtype=new.dtype)
        new[tkey] = value
        self._rebind(new)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(map(str, self.shape)), self.context)

    # numpy interop
    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # pickling (optimizer and trainer states)
    def __reduce__(self):
        return (_unpickle, (self._data.detach().cpu(), str(self.context)))


def _unpickle(tensor, device):
    return _wrap(tensor.to(device))


def array(source, ctx=None, dtype=None):
    """mx.nd.array: an NDArray from any array-like (a copy), on `ctx`
    (default `cuda:0`; a torch tensor stays on its device)."""
    return NDArray(source, ctx=ctx, dtype=dtype)
