"""Test utilities of the PyTorch port (counterpart of
incubator_mxnet_tpu/test_utils.py; ref: python/mxnet/test_utils.py):
array comparison with dtype-keyed tolerances, random arrays and shapes,
and the central-difference gradient check, over `mx.nd` NDArrays.

`default_context()` is `cuda:0`, or the device `MXNET_TEST_DEVICE` names
(`cpu`, `gpu`, `gpu:1`).
"""
from __future__ import annotations

import os

import numpy as _np
import torch

from .base import nd_dtype
from .context import cpu, gpu, current_context
from .ndarray.ndarray import NDArray
from . import ndarray as nd

__all__ = ["default_context", "assert_almost_equal", "almost_equal", "same",
           "rand_ndarray", "rand_shape_nd", "rand_shape_2d", "rand_shape_3d",
           "check_numeric_gradient", "numeric_grad", "assert_exception"]

_DEFAULT_RTOL = {
    _np.dtype(_np.float16): 1e-2,
    _np.dtype(_np.float32): 1e-4,
    _np.dtype(_np.float64): 1e-5,
}
_DEFAULT_ATOL = {
    _np.dtype(_np.float16): 1e-3,
    _np.dtype(_np.float32): 1e-5,
    _np.dtype(_np.float64): 1e-7,
}


def default_context():
    """The device of tests: `MXNET_TEST_DEVICE` (cpu, gpu, gpu:<i>),
    else `cuda:0`."""
    dev = os.environ.get("MXNET_TEST_DEVICE", "")
    if dev.startswith("cpu"):
        return cpu()
    if dev.startswith("gpu"):
        return gpu(int(dev.split(":")[-1]) if ":" in dev else 0)
    return current_context()


def _as_np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return _np.asarray(x)


def same(a, b):
    return _np.array_equal(_as_np(a), _as_np(b))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    a, b = _as_np(a), _as_np(b)
    rtol = rtol if rtol is not None else _DEFAULT_RTOL.get(a.dtype, 1e-5)
    atol = atol if atol is not None else _DEFAULT_ATOL.get(a.dtype, 1e-7)
    return _np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    a_raw = _as_np(a)
    a_np, b_np = a_raw.astype(_np.float64), _as_np(b).astype(_np.float64)
    rtol = rtol if rtol is not None else _DEFAULT_RTOL.get(a_raw.dtype, 1e-4)
    atol = atol if atol is not None else _DEFAULT_ATOL.get(a_raw.dtype, 1e-5)
    if not _np.allclose(a_np, b_np, rtol=rtol, atol=atol,
                        equal_nan=equal_nan):
        err = _np.abs(a_np - b_np)
        rel = err / (_np.abs(b_np) + atol)
        raise AssertionError(
            "%s and %s differ: max abs err %g, max rel err %g "
            "(rtol=%g atol=%g)\n%r\nvs\n%r"
            % (names[0], names[1], err.max(), rel.max(), rtol, atol,
               a_np.ravel()[:8], b_np.ravel()[:8]))


def rand_shape_nd(ndim, dim=10, allow_zero_size=False):
    low = 0 if allow_zero_size else 1
    return tuple(_np.random.randint(low, dim + 1, size=ndim).tolist())


def rand_shape_2d(dim0=10, dim1=10):
    return (_np.random.randint(1, dim0 + 1), _np.random.randint(1, dim1 + 1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (_np.random.randint(1, dim0 + 1), _np.random.randint(1, dim1 + 1),
            _np.random.randint(1, dim2 + 1))


def rand_ndarray(shape, stype="default", density=None, dtype="float32",
                 ctx=None):
    """An array of uniform(-1, 1) values on `ctx` (default
    `default_context()`); a "row_sparse" or "csr" one keeps each value
    with probability `density` (default 0.5), the others zero, in that
    storage (ref: rand_ndarray)."""
    ctx = ctx or default_context()
    a = _np.random.uniform(-1, 1, size=shape).astype(_np.float32)
    if stype == "default":
        return nd.array(a, ctx=ctx, dtype=nd_dtype(dtype))
    density = 0.5 if density is None else density
    a = a * (_np.random.rand(*shape) < density)
    from .ndarray.sparse import cast_storage
    return cast_storage(nd.array(a, ctx=ctx, dtype=nd_dtype(dtype)), stype)


def numeric_grad(f, x, eps=1e-4):
    """Central-difference gradient of scalar-valued f at numpy x."""
    x = x.astype(_np.float64)
    grad = _np.zeros_like(x)
    it = _np.nditer(x, flags=["multi_index"])
    while not it.finished:
        idx = it.multi_index
        orig = x[idx]
        x[idx] = orig + eps
        fp = f(x)
        x[idx] = orig - eps
        fm = f(x)
        x[idx] = orig
        grad[idx] = (fp - fm) / (2 * eps)
        it.iternext()
    return grad


def check_numeric_gradient(fn, inputs, rtol=1e-2, atol=1e-3, eps=1e-3,
                           argnums=None, ctx=None):
    """Compare autograd gradients of `fn` (NDArrays to an NDArray, summed
    to a scalar) against central differences, on `ctx` (default
    `default_context()`)."""
    from . import autograd as ag
    ctx = ctx or default_context()
    nds = [nd.array(x.astype(_np.float64).astype(_np.float32), ctx=ctx)
           for x in inputs]
    check = range(len(nds)) if argnums is None else argnums
    for i in check:
        nds[i].attach_grad()
    with ag.record():
        loss = fn(*nds).sum()
    loss.backward()

    for i in check:
        def scalar_f(x_np, i=i):
            args = [n.asnumpy().astype(_np.float64) for n in nds]
            args[i] = x_np
            vals = [nd.array(a.astype(_np.float32), ctx=ctx) for a in args]
            return float(fn(*vals).sum().asscalar())
        num = numeric_grad(scalar_f, inputs[i].astype(_np.float64), eps)
        sym = nds[i].grad.asnumpy()
        assert_almost_equal(sym, num, rtol=rtol, atol=atol,
                            names=("autograd", "numeric"))


def assert_exception(f, exception_type, *args, **kwargs):
    try:
        f(*args, **kwargs)
    except exception_type:
        return
    raise AssertionError("did not raise %s" % exception_type)
