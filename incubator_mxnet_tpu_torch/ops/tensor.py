"""Tensor and math operators of the PyTorch port (counterpart of
incubator_mxnet_tpu/ops/tensor.py; ref: src/operator/tensor/
elemwise_binary_{op,broadcast_op}*, elemwise_unary_op*,
broadcast_reduce_op*, matrix_op*, indexing_op*, ordering_op*, init_op*,
dot-inl.h).

Every body is a function over torch tensors with the JAX op's name,
signature and result dtype.  These are XLA ops in the JAX package, not
Pallas kernels, so plain PyTorch is their port; products stay
`torch.matmul`, as the JAX package leaves them to XLA.

What differs from torch's own meaning and is kept as the JAX package has
it:

* a scalar operand takes the array's dtype first (`_scalar`), so an
  int32 array plus 1.5 stays int32 and a bf16 array meets a bf16 scalar;
* comparisons return the operands' dtype (1.0/0.0), not bool;
* integer reductions give int32 and the index ops (`argmax`, `argsort`,
  `topk`) float32 by default (`dtype=`), as the JAX package's arrays
  with 64-bit types off;
* `mod` is the floor modulo (`torch.remainder`), `round` and `rint` round
  half to even, as `jnp.round` does;
* gathers clip or wrap their indices (`take`, `pick`, `Embedding`), as
  the JAX package's clamping gathers do, so no index faults the device;
* `reshape` takes MXNet's codes 0, -1, -2, -3 and -4 and `reverse`.

A result may share storage with its input (a torch view): `NDArray`
never writes a tensor in place, so no array sees another's write.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import nd_dtype
from .registry import register, alias

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _norm_axis(axis, ndim, exclude=False):
    """MXNet reduce-axis semantics: None = all axes; exclude inverts."""
    if axis is None:
        ax = tuple(range(ndim))
        return ax if not exclude else ()
    if isinstance(axis, int):
        axis = (axis,)
    ax = tuple(a % ndim for a in axis) if ndim else ()
    if exclude:
        ax = tuple(a for a in range(ndim) if a not in ax)
    return ax


def _scalar(data, value):
    """`value` as the JAX package's `jnp.asarray(value, data.dtype)` has
    it, as a Python number torch combines with `data` in data's dtype.
    A 16-bit float is rounded (to nearest, ties to even) without a torch
    op, so that a captured program, which may read no tensor on the
    host, can call it."""
    dt = data.dtype
    if dt.is_floating_point:
        if dt in (torch.float32, torch.float64):
            return float(value)
        if dt in (torch.float16, torch.bfloat16):
            # through f32, as torch converts a Python float
            with np.errstate(over="ignore"):
                v32 = np.float32(value)
                if dt == torch.float16:
                    return float(np.float16(v32))
            bits = int(v32.view(np.uint32))
            bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
            return float(np.uint32(bits).view(np.float32))
        return torch.tensor(float(value), dtype=dt).item()
    if dt == torch.bool:
        return bool(value)
    return int(value)


def _promote(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _is_float(t):
    return t.dtype.is_floating_point


# ---------------------------------------------------------------------------
# binary elementwise / broadcast family
# ---------------------------------------------------------------------------


def _cmp(fn):
    def body(a, b):
        return fn(a, b).to(torch.result_type(a, b))
    return body


def _hypot(a, b):
    a, b = _promote(a, b)
    if not _is_float(a):
        a, b = a.float(), b.float()
    return torch.hypot(a, b)


_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.true_divide, "mod": torch.remainder, "power": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "hypot": _hypot,
    "equal": _cmp(torch.eq), "not_equal": _cmp(torch.ne),
    "greater": _cmp(torch.gt), "greater_equal": _cmp(torch.ge),
    "lesser": _cmp(torch.lt), "lesser_equal": _cmp(torch.le),
    "logical_and": _cmp(torch.logical_and),
    "logical_or": _cmp(torch.logical_or),
    "logical_xor": _cmp(torch.logical_xor),
}

for _name, _tf in _BINARY.items():
    def _make(tf):
        def body(lhs, rhs):
            return tf(lhs, rhs)
        return body
    _b = _make(_tf)
    _b.__name__ = "broadcast_" + _name
    register("broadcast_" + _name, ndarray_inputs=("lhs", "rhs"))(_b)

alias("broadcast_add", "elemwise_add", "_plus", "_add")
alias("broadcast_sub", "elemwise_sub", "_minus", "_sub")
alias("broadcast_mul", "elemwise_mul", "_mul")
alias("broadcast_div", "elemwise_div", "_div")
alias("broadcast_mod", "_mod")
alias("broadcast_power", "_power", "pow")
alias("broadcast_maximum", "_maximum")
alias("broadcast_minimum", "_minimum")
alias("broadcast_hypot", "_hypot")
alias("broadcast_equal", "_equal")
alias("broadcast_not_equal", "_not_equal")
alias("broadcast_greater", "_greater")
alias("broadcast_greater_equal", "_greater_equal")
alias("broadcast_lesser", "_lesser")
alias("broadcast_lesser_equal", "_lesser_equal")


# scalar variants (the NDArray operator overloads lower to them)
@register("_plus_scalar", ndarray_inputs=("data",))
def _plus_scalar(data, scalar=0.0):
    return data + _scalar(data, scalar)


@register("_minus_scalar", ndarray_inputs=("data",))
def _minus_scalar(data, scalar=0.0):
    return data - _scalar(data, scalar)


@register("_rminus_scalar", ndarray_inputs=("data",))
def _rminus_scalar(data, scalar=0.0):
    return _scalar(data, scalar) - data


@register("_mul_scalar", ndarray_inputs=("data",))
def _mul_scalar(data, scalar=1.0):
    return data * _scalar(data, scalar)


@register("_div_scalar", ndarray_inputs=("data",))
def _div_scalar(data, scalar=1.0):
    out = data / _scalar(data, scalar)
    return out if _is_float(data) else out.to(torch.float32)


@register("_rdiv_scalar", ndarray_inputs=("data",))
def _rdiv_scalar(data, scalar=1.0):
    out = _scalar(data, scalar) / data
    return out if _is_float(data) else out.to(torch.float32)


@register("_power_scalar", ndarray_inputs=("data",))
def _power_scalar(data, scalar=1.0):
    return torch.pow(data, _scalar(data, scalar))


@register("_rpower_scalar", ndarray_inputs=("data",))
def _rpower_scalar(data, scalar=1.0):
    return torch.pow(_scalar(data, scalar), data)


@register("_mod_scalar", ndarray_inputs=("data",))
def _mod_scalar(data, scalar=1.0):
    return torch.remainder(data, _scalar(data, scalar))


@register("_rmod_scalar", ndarray_inputs=("data",))
def _rmod_scalar(data, scalar=1.0):
    return torch.remainder(
        torch.full_like(data, _scalar(data, scalar)), data)


@register("_maximum_scalar", ndarray_inputs=("data",))
def _maximum_scalar(data, scalar=0.0):
    return torch.clamp_min(data, _scalar(data, scalar))


@register("_minimum_scalar", ndarray_inputs=("data",))
def _minimum_scalar(data, scalar=0.0):
    return torch.clamp_max(data, _scalar(data, scalar))


for _cmpname, _fn in [("_equal_scalar", torch.eq),
                      ("_not_equal_scalar", torch.ne),
                      ("_greater_scalar", torch.gt),
                      ("_greater_equal_scalar", torch.ge),
                      ("_lesser_scalar", torch.lt),
                      ("_lesser_equal_scalar", torch.le)]:
    def _mk(fn):
        def body(data, scalar=0.0):
            return fn(data, scalar).to(data.dtype)
        return body
    _f = _mk(_fn)
    _f.__name__ = _cmpname
    register(_cmpname, ndarray_inputs=("data",), differentiable=False)(_f)


# ---------------------------------------------------------------------------
# unary elementwise family
# ---------------------------------------------------------------------------


def _float_in(fn):
    """`fn` over data converted to float32 when it is an integer array,
    as jnp's float-valued functions promote integers."""
    def body(x):
        return fn(x if _is_float(x) else x.float())
    return body


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "rint": torch.round,
    "ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc,
    "fix": torch.trunc, "square": torch.square,
    "sqrt": _float_in(torch.sqrt), "rsqrt": _float_in(torch.rsqrt),
    "cbrt": _float_in(_cbrt),
    "rcbrt": _float_in(lambda x: 1.0 / _cbrt(x)),
    "exp": _float_in(torch.exp), "expm1": _float_in(torch.expm1),
    "log": _float_in(torch.log), "log10": _float_in(torch.log10),
    "log2": _float_in(torch.log2), "log1p": _float_in(torch.log1p),
    "sin": _float_in(torch.sin), "cos": _float_in(torch.cos),
    "tan": _float_in(torch.tan), "arcsin": _float_in(torch.asin),
    "arccos": _float_in(torch.acos), "arctan": _float_in(torch.atan),
    "degrees": _float_in(torch.rad2deg), "radians": _float_in(torch.deg2rad),
    "sinh": _float_in(torch.sinh), "cosh": _float_in(torch.cosh),
    "tanh": _float_in(torch.tanh), "arcsinh": _float_in(torch.asinh),
    "arccosh": _float_in(torch.acosh), "arctanh": _float_in(torch.atanh),
    "reciprocal": _float_in(torch.reciprocal),
    "negative": torch.neg,
    "erf": _float_in(torch.erf),
    "erfinv": _float_in(torch.erfinv),
    "gamma": _float_in(lambda x: torch.exp(torch.lgamma(x))),
    "gammaln": _float_in(torch.lgamma),
    "relu": torch.relu,
    "sigmoid": _float_in(torch.sigmoid),
    "softsign": _float_in(F.softsign),
}

for _name, _tf in _UNARY.items():
    def _mku(tf):
        def body(data):
            return tf(data)
        return body
    _u = _mku(_tf)
    _u.__name__ = _name
    register(_name, ndarray_inputs=("data",))(_u)


@register("logical_not", ndarray_inputs=("data",), differentiable=False)
def logical_not(data):
    return torch.logical_not(data).to(data.dtype)


@register("round", ndarray_inputs=("data",), differentiable=False)
def round_(data):
    return torch.round(data)


@register("BlockGrad", ndarray_inputs=("data",))
def block_grad(data):
    """Identity forward, zero gradient (ref: BlockGrad)."""
    return data.detach()


alias("BlockGrad", "stop_gradient")


@register("identity", ndarray_inputs=("data",))
def identity(data):
    return data


alias("identity", "_copy")


@register("cast", ndarray_inputs=("data",))
def cast(data, dtype="float32"):
    return data.to(nd_dtype(dtype))


alias("cast", "Cast")


@register("amp_cast", ndarray_inputs=("data",))
def amp_cast(data, dtype="float32"):
    """The cast the AMP pass inserts: floating inputs only (ref:
    amp_cast.cc); integer indices and labels pass through."""
    if not _is_float(data):
        return data
    return data.to(nd_dtype(dtype))


def _amp_multicast_nout(attrs):
    return int(attrs.get("num_outputs", 1))


@register("amp_multicast", ndarray_inputs=None, num_outputs=-1,
          num_outputs_fn=_amp_multicast_nout)
def amp_multicast(*data, num_outputs=1, cast_narrow=False):
    """Common-dtype cast across inputs: the widest floating dtype wins
    (the narrowest with cast_narrow); non-float inputs pass through."""
    fdts = [d.dtype for d in data if _is_float(d)]
    if not fdts:
        return tuple(data) if len(data) > 1 else data[0]
    if cast_narrow:
        target = min(fdts, key=lambda t: t.itemsize)
    else:
        target = functools.reduce(torch.promote_types, fdts)
    outs = tuple(d.to(target) if _is_float(d) else d for d in data)
    return outs if len(outs) > 1 else outs[0]


@register("clip", ndarray_inputs=("data",))
def clip(data, a_min=0.0, a_max=1.0):
    return torch.clamp(data, _scalar(data, a_min), _scalar(data, a_max))


# ---------------------------------------------------------------------------
# init ops: no tensor input; they build on the default device that
# `invoke` sets from ctx
# ---------------------------------------------------------------------------


@register("zeros_like", ndarray_inputs=("data",))
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like", ndarray_inputs=("data",))
def ones_like(data):
    return torch.ones_like(data)


def _shape(shape):
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


@register("_zeros", ndarray_inputs=(), differentiable=False)
def _zeros(shape=(), dtype="float32"):
    return torch.zeros(_shape(shape), dtype=nd_dtype(dtype))


@register("_ones", ndarray_inputs=(), differentiable=False)
def _ones(shape=(), dtype="float32"):
    return torch.ones(_shape(shape), dtype=nd_dtype(dtype))


@register("_full", ndarray_inputs=(), differentiable=False)
def _full(shape=(), value=0.0, dtype="float32"):
    dt = nd_dtype(dtype)
    return torch.full(_shape(shape), _scalar(torch.empty(0, dtype=dt),
                                             value), dtype=dt)


def _arange_values(start, stop, step, dt):
    """np.arange's values in `dt`: the count ceil((stop - start) / step),
    element i = start + i * step, as jnp.arange computes them."""
    if stop is None:
        start, stop = 0.0, start
    n = max(0, int(math.ceil((stop - start) / step)))
    if dt.is_floating_point:
        return (torch.arange(n, dtype=torch.float64) * step
                + start).to(dt)
    return torch.arange(int(start), int(start) + n * int(step), int(step),
                        dtype=dt)[:n]


@register("_arange", ndarray_inputs=(), differentiable=False)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32"):
    out = _arange_values(start, stop, step, nd_dtype(dtype))
    if repeat != 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register("_linspace", ndarray_inputs=(), differentiable=False)
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32"):
    num = int(num)
    div = (num - 1) if endpoint else num
    step = (stop - start) / div if div > 0 else 0.0
    vals = torch.arange(num, dtype=torch.float64) * step + start
    if endpoint and num > 1:
        vals[-1] = stop
    return vals.to(nd_dtype(dtype))


@register("_eye", ndarray_inputs=(), differentiable=False)
def _eye(N=1, M=0, k=0, dtype="float32"):
    N, M, k = int(N), int(M) or int(N), int(k)
    rows = torch.arange(N).unsqueeze(1)
    cols = torch.arange(M).unsqueeze(0)
    return (cols - rows == k).to(nd_dtype(dtype))


@register("arange_like", ndarray_inputs=("data",), differentiable=False)
def arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    if axis is None:
        n, shape = data.numel(), data.shape
    else:
        n = data.shape[axis]
        shape = (n,)
    out = (torch.arange(n, dtype=torch.float64, device=data.device) * step
           + start).to(data.dtype)
    if repeat != 1:
        out = torch.repeat_interleave(out, int(repeat))[:n]
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------


def _int32(out, data):
    """Integer and bool sums and products are int32, as the JAX
    package's (torch widens them to int64)."""
    return out.to(torch.int32) if out.dtype == torch.int64 \
        and data.dtype != torch.int64 else out


def _nanprod(x, dim=None, keepdim=False):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x),
                 dim=dim, keepdim=keepdim)


def _prod(x, dim=None, keepdim=False):
    if dim is None:
        out = torch.prod(x)
        return out.reshape((1,) * x.ndim) if keepdim else out
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _mean(x, dim=None, keepdim=False):
    if not _is_float(x):
        x = x.float()
    return torch.mean(x, dim=dim, keepdim=keepdim)


def _sum(x, dim=None, keepdim=False):
    return torch.sum(x, dim=dim, keepdim=keepdim)


def _nansum(x, dim=None, keepdim=False):
    return torch.nansum(x, dim=dim, keepdim=keepdim) if _is_float(x) \
        else torch.sum(x, dim=dim, keepdim=keepdim)


def _amax(x, dim=None, keepdim=False):
    return torch.amax(x, dim=() if dim is None else dim, keepdim=keepdim)


def _amin(x, dim=None, keepdim=False):
    return torch.amin(x, dim=() if dim is None else dim, keepdim=keepdim)


def _reduce(tf):
    def body(data, axis=None, keepdims=False, exclude=False):
        ax = _norm_axis(axis, data.ndim, exclude)
        if ax == () and axis is not None:
            return data
        out = tf(data, dim=ax if ax else None, keepdim=keepdims)
        return _int32(out, data)
    return body


for _name, _tf in [("sum", _sum), ("mean", _mean), ("prod", _prod),
                   ("nansum", _nansum), ("nanprod", _nanprod),
                   ("max", _amax), ("min", _amin)]:
    _r = _reduce(_tf)
    _r.__name__ = _name
    register(_name, ndarray_inputs=("data",))(_r)

alias("sum", "sum_axis")
alias("max", "max_axis")
alias("min", "min_axis")


@register("norm", ndarray_inputs=("data",))
def norm(data, ord=2, axis=None, keepdims=False, out_dtype=None):
    ax = None if axis is None else (tuple(axis) if isinstance(
        axis, (tuple, list)) else (axis,))
    if ord == 2:
        out = torch.sqrt(_sum(torch.square(data), dim=ax, keepdim=keepdims))
    elif ord == 1:
        out = _sum(torch.abs(data), dim=ax, keepdim=keepdims)
    else:
        raise ValueError("norm only supports ord=1|2 (ref parity)")
    if out_dtype is not None:
        out = out.to(nd_dtype(out_dtype))
    return out


def _arg(tf, data, axis, keepdims, dtype):
    if axis is None:
        out = tf(data.reshape(-1))
    else:
        out = tf(data, dim=axis, keepdim=bool(keepdims))
    return out.to(nd_dtype(dtype))


@register("argmax", ndarray_inputs=("data",), differentiable=False)
def argmax(data, axis=None, keepdims=False, dtype="float32"):
    """First index of the maximum; float32 indices by default (MXNet)."""
    return _arg(torch.argmax, data, axis, keepdims, dtype)


@register("argmin", ndarray_inputs=("data",), differentiable=False)
def argmin(data, axis=None, keepdims=False, dtype="float32"):
    return _arg(torch.argmin, data, axis, keepdims, dtype)


@register("argmax_channel", ndarray_inputs=("data",), differentiable=False)
def argmax_channel(data):
    return torch.argmax(data, dim=-1).to(torch.float32)


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


@register("reshape", ndarray_inputs=("data",))
def reshape(data, shape=None, reverse=False):
    """MXNet's codes 0 (copy dim), -1 (infer), -2 (copy rest), -3 (merge
    two), -4 (split one in two) (ref: matrix_op-inl.h ReshapeShape)."""
    shape = tuple(shape)
    if not any(s in (0, -2, -3, -4) for s in shape):
        return torch.reshape(data, shape)
    src = list(data.shape[::-1] if reverse else data.shape)
    out = []
    i = 0
    shape_l = list(shape[::-1] if reverse else shape)
    k = 0
    while k < len(shape_l):
        s = shape_l[k]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = shape_l[k + 1], shape_l[k + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            k += 2
        else:
            out.append(s)
            i += 1
        k += 1
    if reverse:
        out = out[::-1]
    return torch.reshape(data, tuple(out))


alias("reshape", "Reshape")


@register("reshape_like", ndarray_inputs=("lhs", "rhs"))
def reshape_like(lhs, rhs):
    return torch.reshape(lhs, rhs.shape)


@register("shape_array", ndarray_inputs=("data",), differentiable=False)
def shape_array(data):
    return torch.tensor(tuple(data.shape), dtype=torch.int32,
                        device=data.device)


@register("size_array", ndarray_inputs=("data",), differentiable=False)
def size_array(data):
    return torch.tensor([data.numel()], dtype=torch.int32,
                        device=data.device)


@register("Flatten", ndarray_inputs=("data",))
def flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


alias("Flatten", "flatten")


@register("expand_dims", ndarray_inputs=("data",))
def expand_dims(data, axis=0):
    return torch.unsqueeze(data, axis)


@register("squeeze", ndarray_inputs=("data",))
def squeeze(data, axis=None):
    if axis is None:
        return torch.squeeze(data)
    return torch.squeeze(data, tuple(axis) if isinstance(
        axis, (tuple, list)) else axis)


@register("transpose", ndarray_inputs=("data",))
def transpose(data, axes=None):
    if axes is None or len(axes) == 0:
        axes = tuple(range(data.ndim))[::-1]
    return data.permute(*axes)


@register("swapaxes", ndarray_inputs=("data",))
def swapaxes(data, dim1=0, dim2=0):
    return torch.swapaxes(data, dim1, dim2)


alias("swapaxes", "SwapAxis")


@register("flip", ndarray_inputs=("data",))
def flip(data, axis=0):
    axis = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
    return torch.flip(data, axis)


alias("flip", "reverse")


@register("tile", ndarray_inputs=("data",))
def tile(data, reps=()):
    return torch.tile(data, tuple(reps))


@register("repeat", ndarray_inputs=("data",))
def repeat(data, repeats=1, axis=None):
    if axis is None:
        return torch.repeat_interleave(data.reshape(-1), int(repeats))
    return torch.repeat_interleave(data, int(repeats), dim=axis)


@register("broadcast_to", ndarray_inputs=("data",))
def broadcast_to(data, shape=()):
    shape = tuple(int(data.shape[i]) if s == 0 else int(s)
                  for i, s in enumerate(shape))
    return data.expand(shape)


@register("broadcast_like", ndarray_inputs=("lhs", "rhs"))
def broadcast_like(lhs, rhs, lhs_axes=None, rhs_axes=None):
    if lhs_axes is None:
        return lhs.expand(rhs.shape)
    shape = list(lhs.shape)
    for la, ra in zip(lhs_axes, rhs_axes):
        shape[la] = rhs.shape[ra]
    return lhs.expand(tuple(shape))


@register("broadcast_axis", ndarray_inputs=("data",))
def broadcast_axis(data, axis=(), size=()):
    if isinstance(axis, int):
        axis = (axis,)
        size = (size,)
    shape = list(data.shape)
    for a, s in zip(axis, size):
        shape[a] = s
    return data.expand(tuple(shape))


alias("broadcast_axis", "broadcast_axes")


@register("concat", ndarray_inputs=None)
def concat(*data, dim=1):
    return torch.cat(data, dim=dim)


alias("concat", "Concat")


@register("stack", ndarray_inputs=None)
def stack(*data, axis=0):
    dt = functools.reduce(torch.promote_types, [d.dtype for d in data])
    return torch.stack([d.to(dt) for d in data], dim=axis)


@register("split", ndarray_inputs=("data",), num_outputs=-1)
def split(data, num_outputs=1, axis=1, squeeze_axis=False):
    n = int(num_outputs)
    if data.shape[axis] % n:
        raise ValueError("array split does not result in an equal division")
    parts = torch.split(data, data.shape[axis] // n, dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, axis) for p in parts]
    return tuple(parts)


alias("split", "SliceChannel")


def _take_slice(data, dim, b, e, s):
    """data[..., b:e:s, ...] along `dim`, a negative step included (which
    torch's slicing does not take)."""
    if s is None or s > 0:
        idx = [slice(None)] * data.ndim
        idx[dim] = slice(b, e, s)
        return data[tuple(idx)]
    rows = range(*slice(b, e, s).indices(data.shape[dim]))
    return data.index_select(dim, torch.tensor(list(rows), dtype=torch.long,
                                               device=data.device))


@register("slice", ndarray_inputs=("data",))
def slice_(data, begin=(), end=(), step=()):
    step = tuple(step) if step else (None,) * len(begin)
    out = data
    for dim, (b, e, s) in enumerate(zip(begin, end, step)):
        out = _take_slice(out, dim, b, e, s)
    return out


@register("slice_axis", ndarray_inputs=("data",))
def slice_axis(data, axis=0, begin=0, end=None):
    return _take_slice(data, axis % data.ndim, begin, end, None)


@register("slice_like", ndarray_inputs=("data", "shape_like"))
def slice_like(data, shape_like, axes=()):
    idx = [slice(None)] * data.ndim
    axes = axes or range(min(data.ndim, shape_like.ndim))
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return data[tuple(idx)]


def _pad_index(n, lo, hi, mode, device):
    """Source rows of an edge- or reflect-padded axis of length n."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    i = i.abs()
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


@register("pad", ndarray_inputs=("data",))
def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(len(pad_width) // 2)]
    if mode == "constant":
        flat = []
        for lo, hi in reversed(pw):
            flat.extend((lo, hi))
        return F.pad(data, flat, value=_scalar(data, constant_value))
    if mode not in ("edge", "reflect"):
        raise KeyError(mode)
    out = data
    for dim, (lo, hi) in enumerate(pw):
        if lo or hi:
            out = out.index_select(dim, _pad_index(out.shape[dim], lo, hi,
                                                   mode, data.device))
    return out


alias("pad", "Pad")


@register("depth_to_space", ndarray_inputs=("data",))
def depth_to_space(data, block_size=1):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth", ndarray_inputs=("data",))
def space_to_depth(data, block_size=1):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


# ---------------------------------------------------------------------------
# indexing / gather / scatter
# ---------------------------------------------------------------------------


def _idx(indices):
    """Integer positions of an index array (float indices truncate, as
    the JAX package's int32 cast does)."""
    return indices.to(torch.long)


@register("take", ndarray_inputs=("a", "indices"), nograd_argnums=(1,))
def take(a, indices, axis=0, mode="clip"):
    axis = axis % a.ndim
    n = a.shape[axis]
    idx = _idx(indices)
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("pick", ndarray_inputs=("data", "index"), nograd_argnums=(1,))
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    idx = _idx(index).clamp(0, data.shape[axis] - 1)
    out = torch.take_along_dim(data, idx.unsqueeze(axis), dim=axis)
    if not keepdims:
        out = torch.squeeze(out, axis)
    return out


@register("gather_nd", ndarray_inputs=("data", "indices"),
          nograd_argnums=(1,))
def gather_nd(data, indices):
    """indices (M, ...) index the first M axes of data (ref:
    GatherNDForward)."""
    return data[tuple(_idx(indices))]


@register("scatter_nd", ndarray_inputs=("data", "indices"),
          nograd_argnums=(1,))
def scatter_nd(data, indices, shape=()):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(_idx(indices)), data)


@register("_scatter_set_nd", ndarray_inputs=("lhs", "rhs", "indices"),
          nograd_argnums=(2,))
def _scatter_set_nd(lhs, rhs, indices, shape=()):
    return lhs.index_put(tuple(_idx(indices)), rhs.to(lhs.dtype))


@register("one_hot", ndarray_inputs=("indices",), differentiable=False)
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    d = nd_dtype(dtype)
    cls = torch.arange(int(depth), device=indices.device)
    oh = (indices.to(torch.int32).unsqueeze(-1) == cls).to(d)
    on = torch.tensor(on_value, dtype=d).item()
    off = torch.tensor(off_value, dtype=d).item()
    return oh * on + (1 - oh) * off


@register("where", ndarray_inputs=("condition", "x", "y"),
          nograd_argnums=(0,))
def where(condition, x, y):
    return torch.where(condition.to(torch.bool), x, y)


@register("boolean_mask", ndarray_inputs=("data", "index"),
          differentiable=False)
def boolean_mask(data, index, axis=0):
    """Rows of data where index is nonzero (a data-dependent shape)."""
    rows = torch.nonzero(index.to(torch.bool).reshape(-1)).reshape(-1)
    return data.index_select(axis, rows)


@register("diag", ndarray_inputs=("data",))
def diag(data, k=0, axis1=0, axis2=1):
    if data.ndim == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=axis1, dim2=axis2)


# ---------------------------------------------------------------------------
# linear algebra
# ---------------------------------------------------------------------------


def _reverse_axes(t):
    return t.permute(*range(t.ndim - 1, -1, -1))


@register("dot", ndarray_inputs=("lhs", "rhs"))
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """MXNet dot: 2-D product, and for N-D operands the last axis of lhs
    contracted with the first of rhs (ref: dot-inl.h)."""
    a = _reverse_axes(lhs) if transpose_a else lhs
    b = _reverse_axes(rhs) if transpose_b else rhs
    a, b = _promote(a, b)
    if a.ndim > 2 or b.ndim > 2:
        return torch.tensordot(a, b, dims=([a.ndim - 1], [0]))
    return torch.matmul(a, b)


@register("batch_dot", ndarray_inputs=("lhs", "rhs"))
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = torch.swapaxes(lhs, -1, -2) if transpose_a else lhs
    b = torch.swapaxes(rhs, -1, -2) if transpose_b else rhs
    a, b = _promote(a, b)
    return torch.matmul(a, b)


@register("khatri_rao", ndarray_inputs=None)
def khatri_rao(*mats):
    out = mats[0]
    for m in mats[1:]:
        out = torch.einsum("i...,j...->ij...", out, m).reshape(
            out.shape[0] * m.shape[0], *out.shape[1:])
    return out


@register("L2Normalization", ndarray_inputs=("data",))
def l2_normalization(data, eps=1e-10, mode="instance"):
    if mode == "instance":
        ax = tuple(range(1, data.ndim))
    elif mode == "channel":
        ax = (1,)
    elif mode == "spatial":
        ax = tuple(range(2, data.ndim))
    else:
        raise ValueError(mode)
    nrm = torch.sqrt(torch.sum(torch.square(data), dim=ax, keepdim=True)
                     + eps)
    return data / nrm


# ---------------------------------------------------------------------------
# ordering
# ---------------------------------------------------------------------------


@register("sort", ndarray_inputs=("data",))
def sort(data, axis=-1, is_ascend=True):
    out = torch.sort(data, dim=axis, stable=True).values
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out


@register("argsort", ndarray_inputs=("data",), differentiable=False)
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.argsort(data, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(nd_dtype(dtype))


@register("topk", ndarray_inputs=("data",), differentiable=False)
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    k = int(k)
    vals, idxs = torch.topk(data, k, dim=axis, largest=not is_ascend,
                            sorted=True)
    if ret_typ == "indices":
        return idxs.to(nd_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return (vals, idxs.to(nd_dtype(dtype)))
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(axis, idxs, 1)
    raise ValueError(ret_typ)


# ---------------------------------------------------------------------------
# sequence ops (ref: src/operator/sequence_*.cc)
# ---------------------------------------------------------------------------


@register("SequenceMask", ndarray_inputs=("data", "sequence_length"),
          nograd_argnums=(1,))
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[axis], device=data.device)
    length = sequence_length.to(torch.long)
    # (T, B) layout when axis=0, (B, T) when axis=1
    if axis == 0:
        mask = steps[:, None] < length[None, :]
    else:
        mask = steps[None, :] < length[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, data, torch.full_like(data, _scalar(data,
                                                                 value)))


@register("SequenceLast", ndarray_inputs=("data", "sequence_length"),
          nograd_argnums=(1,))
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    last = sequence_length.to(torch.long) - 1
    d = torch.movedim(data, axis, 0)          # (T, B, ...)
    idx = last.reshape((1, -1) + (1,) * (d.ndim - 2)).expand(
        (1,) + d.shape[1:])
    return torch.gather(d, 0, idx).squeeze(0)


@register("SequenceReverse", ndarray_inputs=("data", "sequence_length"),
          nograd_argnums=(1,))
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (0,))
    T = data.shape[0]
    steps = torch.arange(T, device=data.device)[:, None]
    L = sequence_length.to(torch.long)[None, :]
    src = torch.where(steps < L, L - 1 - steps, steps)    # (T, B)
    idx = src.reshape(src.shape + (1,) * (data.ndim - 2)).expand(data.shape)
    return torch.gather(data, 0, idx)
