"""Sparse NDArrays of the PyTorch port (counterpart of
incubator_mxnet_tpu/ndarray/sparse.py; ref: include/mxnet/ndarray.h
kRowSparseStorage/kCSRStorage, src/operator/tensor/cast_storage-inl.h).

A `RowSparseNDArray` is an (indices, data) pair of NDArrays: `data[i]` is
the dense row `indices[i]`, the indices sorted and unique, as `np.unique`
gives them.  A `CSRNDArray` is the (data, indices, indptr) triple of a
2-D matrix.  Index arrays are int32 NDArrays, as the JAX package's are
with 64-bit types off; the functions here take them as int64 where torch
indexes with them.

The kernels are gathers and segment sums (`index_select`, `index_add_`)
in the JAX package's arithmetic, not `torch.sparse`'s: `dot` of a CSR
matrix (transposed or not) and a dense one, `add` (the union of rows),
`retain`, the row_sparse gradient of an Embedding lookup
(`embedding_grad_rsp`) and the lazy optimizer updates
`sparse_sgd_update`, `sparse_adagrad_update` and `sparse_adam_update`,
which read and write only the gradient's rows.  No TPU kernel lies behind
any of them: the JAX package leaves them to XLA.

Under `autograd.record()`, `nd.Embedding(..., sparse_grad=True)` on an
array with a gradient attached runs `F.embedding(..., sparse=True)`
(`_embedding_sparse_invoke`, the registry's `sparse_invoke` hook of
Embedding), whose torch gradient is a COO tensor; `autograd` turns it into
a `RowSparseNDArray` at the leaf (`from_torch_sparse`).
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import MXNetError
from ..ops import nn as _nn_ops
from ..ops import registry as _registry
from .ndarray import NDArray, _wrap, unwrap

__all__ = ["RowSparseNDArray", "CSRNDArray", "cast_storage",
           "row_sparse_array", "csr_matrix", "dot", "add", "retain",
           "zeros_row_sparse", "embedding_grad_rsp", "embedding_grad",
           "sparse_sgd_update", "sparse_adagrad_update",
           "sparse_adam_update", "from_torch_sparse", "empty_coo"]


def _index_nd(x, ctx):
    """An int32 index NDArray from an NDArray, a tensor or an array."""
    if isinstance(x, NDArray):
        return x
    if isinstance(x, torch.Tensor):
        return _wrap(x.detach().to(torch.int32))
    return NDArray(_np.asarray(x, dtype=_np.int64), ctx=ctx, dtype="int32")


def _value_nd(x, ctx):
    if isinstance(x, NDArray):
        return x
    if isinstance(x, torch.Tensor):
        return _wrap(x.detach())
    return NDArray(x, ctx=ctx)


class RowSparseNDArray:
    """(indices, data): `data[i]` is the dense row `indices[i]` (ref:
    RowSparse storage, the storage of embedding gradients and of the lazy
    optimizer updates)."""

    stype = "row_sparse"

    def __init__(self, indices, values, shape, ctx=None):
        self.data = _value_nd(values, ctx)
        self.indices = _index_nd(indices, self.data.context)
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def context(self):
        return self.data.context

    ctx = context

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            vals = self.data._data
            dense = torch.zeros(self._shape, dtype=vals.dtype,
                                device=vals.device)
            dense[self.indices._data.long()] = vals
            return _wrap(dense)
        raise MXNetError("unsupported stype %r" % stype)

    def asnumpy(self):
        return self.tostype("default").asnumpy()

    def __repr__(self):
        return "<RowSparseNDArray %s, %d stored rows>" % (
            "x".join(map(str, self._shape)), self.indices.shape[0])


class CSRNDArray:
    """CSR matrix: (data, indices, indptr) (ref: kCSRStorage)."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape, ctx=None):
        self.data = _value_nd(data, ctx)
        self.indices = _index_nd(indices, self.data.context)
        self.indptr = _index_nd(indptr, self.data.context)
        self._shape = tuple(int(s) for s in shape)

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def context(self):
        return self.data.context

    ctx = context

    def _rows(self):
        """The row of each stored value."""
        indptr = self.indptr._data.long()
        n = self._shape[0]
        return torch.repeat_interleave(
            torch.arange(n, device=indptr.device), indptr[1:] - indptr[:-1],
            output_size=self.data.shape[0])

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            vals = self.data._data
            dense = torch.zeros(self._shape, dtype=vals.dtype,
                                device=vals.device)
            dense[self._rows(), self.indices._data.long()] = vals
            return _wrap(dense)
        raise MXNetError("unsupported stype %r" % stype)

    def asnumpy(self):
        return self.tostype("default").asnumpy()

    def __repr__(self):
        return "<CSRNDArray %s, nnz=%d>" % (
            "x".join(map(str, self._shape)), self.data.shape[0])


def cast_storage(arr, stype):
    """ref: the cast_storage op.  A dense array keeps the rows (row_sparse)
    or the entries (csr, 2-D only) that are not zero, in order."""
    if isinstance(arr, (RowSparseNDArray, CSRNDArray)):
        return arr.tostype(stype)
    if stype == "default":
        return arr
    a = unwrap(arr).detach()
    if stype == "row_sparse":
        nz = (a != 0).reshape(a.shape[0], -1).any(1).nonzero().reshape(-1)
        return RowSparseNDArray(_wrap(nz.to(torch.int32)), _wrap(a[nz]),
                                a.shape)
    if stype == "csr":
        if a.ndim != 2:
            raise MXNetError("csr requires 2-D")
        rows, cols = (a != 0).nonzero(as_tuple=True)
        counts = torch.bincount(rows, minlength=a.shape[0])
        indptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        return CSRNDArray(_wrap(a[rows, cols]), _wrap(cols.to(torch.int32)),
                          _wrap(indptr.to(torch.int32)), a.shape)
    raise MXNetError("unknown stype %r" % stype)


# ---------------------------------------------------------------------------
# sparse compute (ref: the FComputeEx paths -- dot-inl.h csr cases,
# optimizer_op.cc row_sparse updates, indexing_op.h sparse Embedding grad)
# ---------------------------------------------------------------------------


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot (ref: dot FComputeEx): csr × dense and csrᵀ ×
    dense as a gather and a segment sum over the stored values, in the
    JAX package's order; dense × dense is the registry's `dot`."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray):
        n, k = lhs.shape
        r = rhs._data
        values = lhs.data._data
        indices = lhs.indices._data.long()
        indptr = lhs.indptr._data.long()
        nnz = values.shape[0]
        rows = torch.searchsorted(
            indptr, torch.arange(nnz, device=indptr.device), right=True) - 1
        if transpose_a:
            out = torch.zeros((k, r.shape[1]), dtype=r.dtype,
                              device=r.device)
            out.index_add_(0, indices, r[rows] * values[:, None])
            return _wrap(out)
        out = torch.zeros((n, r.shape[1]), dtype=r.dtype, device=r.device)
        out.index_add_(0, rows, r[indices] * values[:, None])
        return _wrap(out)
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        from .ndarray import invoke
        return invoke("dot", lhs, rhs, transpose_a=transpose_a,
                      transpose_b=transpose_b)
    raise MXNetError("unsupported sparse dot combination")


def zeros_row_sparse(shape, dtype, ctx=None):
    """An empty row_sparse gradient container (no stored rows)."""
    from ..base import torch_dtype
    from ..context import resolve_device
    dev = resolve_device(ctx)
    return RowSparseNDArray(
        _wrap(torch.zeros((0,), dtype=torch.int32, device=dev)),
        _wrap(torch.zeros((0,) + tuple(shape[1:]), dtype=torch_dtype(dtype),
                          device=dev)),
        tuple(shape))


def embedding_grad_rsp(idx, cot, vocab_size, ctx=None):
    """The row_sparse cotangent of an Embedding lookup: the sorted unique
    rows of `idx` (any shape) and the per-row sums of `cot` (shape
    idx.shape + (dim,)), summed in the order of the lookups (ref:
    EmbeddingOpBackwardEx, kRowSparseStorage)."""
    cot = unwrap(cot)
    idx = unwrap(idx)
    idx = idx.reshape(-1).long() if isinstance(idx, torch.Tensor) else \
        torch.from_numpy(_np.asarray(idx).astype(_np.int64).reshape(-1))
    idx = idx.to(cot.device)
    uniq, inv = torch.unique(idx, sorted=True, return_inverse=True)
    dim = cot.shape[-1]
    vals = torch.zeros((uniq.shape[0], dim), dtype=cot.dtype,
                       device=cot.device)
    vals.index_add_(0, inv, cot.reshape(-1, dim))
    return RowSparseNDArray(_wrap(uniq.to(torch.int32)), _wrap(vals),
                            (int(vocab_size), int(dim)))


def embedding_grad(indices, out_grad, vocab_size):
    """The row_sparse gradient of an Embedding lookup: a front over
    `embedding_grad_rsp` that takes NDArrays, tensors or arrays."""
    return embedding_grad_rsp(indices, out_grad, vocab_size)


def empty_coo(shape, dtype, device):
    """torch's sparse COO tensor of `shape` with no stored rows: an empty
    row_sparse gradient as torch holds one in `.grad`."""
    return torch.sparse_coo_tensor(
        torch.empty((1, 0), dtype=torch.long, device=device),
        torch.empty((0,) + tuple(shape[1:]), dtype=dtype, device=device),
        tuple(shape), is_coalesced=True, check_invariants=True)


def from_torch_sparse(g):
    """A torch COO gradient (what `F.embedding(..., sparse=True)`'s
    backward gives, duplicates unsummed) as a RowSparseNDArray: coalesced,
    so its rows are sorted and unique.  A COO tensor sparse in more than
    its first dimension is taken by rows."""
    if g.sparse_dim() != 1:
        g = g.to_dense().to_sparse(1)
    g = g.coalesce()
    return RowSparseNDArray(_wrap(g.indices()[0].to(torch.int32)),
                            _wrap(g.values()), tuple(g.shape))


def _embedding_sparse_invoke(args, kwargs):
    """The registry's `sparse_invoke` hook of Embedding: active only with
    `sparse_grad=True`, while recording, on a weight NDArray that takes a
    gradient, passed by position; otherwise the dense path runs."""
    from .. import autograd as _ag
    if not (kwargs.get("sparse_grad") and _ag.is_recording()
            and len(args) >= 2 and isinstance(args[1], NDArray)
            and args[1]._data.requires_grad):
        return NotImplemented
    return sparse_embedding_invoke(args[0], args[1])


def sparse_embedding_invoke(data, weight):
    """Embedding whose weight gradient is torch's COO gradient, turned
    into a RowSparseNDArray at the leaf (`autograd.backward`): the
    vocabulary-sized dense gradient never exists.  A weight that is not a
    leaf (recorded history flows into it) takes the dense gradient, as
    only leaves keep a sparse one (`ops.nn.embedding`)."""
    return _wrap(_nn_ops.embedding(unwrap(data), weight._data,
                                   sparse_grad=True))


_registry.get("Embedding").sparse_invoke = _embedding_sparse_invoke


# -- lazy optimizer updates --------------------------------------------------

def _tensor(x):
    return x._data if isinstance(x, NDArray) else x


def _rows_of(grad_rsp, w):
    return grad_rsp.indices._data.to(device=w.device, dtype=torch.long)


def _prep(grad_rsp, rescale_grad, clip_gradient):
    g = grad_rsp.data._data * rescale_grad
    if clip_gradient is not None and clip_gradient > 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _set_rows(dst, rows, new_rows):
    """Write `new_rows` into rows `rows` of `dst`: in place on a tensor
    (a parameter, a state), by rebinding on an NDArray, whose writes never
    touch the old tensor."""
    if isinstance(dst, NDArray):
        t = dst._data.detach().clone()
        t[rows] = new_rows.to(t.dtype)
        dst._data = t
    else:
        with torch.no_grad():
            dst[rows] = new_rows.to(dst.dtype)


def sparse_sgd_update(weight, grad_rsp, lr, wd=0.0, rescale_grad=1.0,
                      clip_gradient=None, lazy_update=True):
    """Row-sparse SGD (ref: sgd_update FComputeEx with lazy_update): only
    the gradient's rows are touched.  `weight` is an NDArray or a tensor
    (written in place)."""
    w = _tensor(weight).detach()
    rows = _rows_of(grad_rsp, w)
    g = _prep(grad_rsp, rescale_grad, clip_gradient)
    wr = w[rows]
    _set_rows(weight, rows, wr - lr * (g + wd * wr))


def sparse_adagrad_update(weight, grad_rsp, history, lr, epsilon=1e-7,
                          wd=0.0, rescale_grad=1.0, clip_gradient=None):
    """ref: _sparse_adagrad_update: the history is updated only on the
    gradient's rows."""
    w = _tensor(weight).detach()
    rows = _rows_of(grad_rsp, w)
    g = _prep(grad_rsp, rescale_grad, clip_gradient)
    hr = _tensor(history)[rows] + torch.square(g)
    _set_rows(history, rows, hr)
    wr = w[rows]
    _set_rows(weight, rows,
              wr - lr * (g / (torch.sqrt(hr) + epsilon) + wd * wr))


def sparse_adam_update(weight, grad_rsp, mean, var, lr, beta1=0.9,
                       beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=None, lazy_update=True):
    """ref: adam_update FComputeEx, lazy path: mean, var and weight change
    only on the gradient's rows; `lr` carries the bias correction."""
    w = _tensor(weight).detach()
    rows = _rows_of(grad_rsp, w)
    g = _prep(grad_rsp, rescale_grad, clip_gradient)
    wr = w[rows]
    g = g + wd * wr
    mr = beta1 * _tensor(mean)[rows] + (1 - beta1) * g
    vr = beta2 * _tensor(var)[rows] + (1 - beta2) * torch.square(g)
    _set_rows(mean, rows, mr)
    _set_rows(var, rows, vr)
    _set_rows(weight, rows, wr - lr * mr / (torch.sqrt(vr) + epsilon))


def add(lhs, rhs):
    """Elementwise add (ref: FComputeEx add): two row_sparse arrays give
    the row_sparse sum over the union of their rows; otherwise the dense
    sum."""
    if isinstance(lhs, RowSparseNDArray) and \
            isinstance(rhs, RowSparseNDArray):
        li = lhs.indices._data.long()
        ri = rhs.indices._data.long().to(li.device)
        idx = torch.unique(torch.cat([li, ri]), sorted=True)
        lv = lhs.data._data
        dense = torch.zeros((idx.shape[0],) + tuple(lv.shape[1:]),
                            dtype=lv.dtype, device=lv.device)
        dense.index_add_(0, torch.searchsorted(idx, li), lv)
        dense.index_add_(0, torch.searchsorted(idx, ri),
                         rhs.data._data.to(lv.device))
        return RowSparseNDArray(_wrap(idx.to(torch.int32)), _wrap(dense),
                                lhs.shape)
    left = lhs if isinstance(lhs, NDArray) else lhs.tostype("default")
    right = rhs if isinstance(rhs, NDArray) else rhs.tostype("default")
    return left + right


def retain(rsp, indices):
    """ref: the _retain op: only the requested rows are kept."""
    have = rsp.indices._data.long()
    want = unwrap(indices)
    want = want.long().to(have.device) if isinstance(want, torch.Tensor) \
        else torch.from_numpy(_np.asarray(want).astype(_np.int64)).to(
            have.device)
    keep = torch.isin(have, want).nonzero().reshape(-1)
    return RowSparseNDArray(_wrap(have[keep].to(torch.int32)),
                            _wrap(rsp.data._data[keep]), rsp.shape)


def row_sparse_array(arg, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from (values, indices) and `shape`, or from a
    dense array-like."""
    if isinstance(arg, tuple) and len(arg) == 2:
        values, indices = arg
        return RowSparseNDArray(indices, values, shape, ctx=ctx)
    return cast_storage(NDArray(arg, ctx=ctx, dtype=dtype), "row_sparse")


def csr_matrix(arg, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from (data, indices, indptr) and `shape`, or from a
    dense array-like."""
    if isinstance(arg, tuple) and len(arg) == 3:
        data, indices, indptr = arg
        return CSRNDArray(data, indices, indptr, shape, ctx=ctx)
    return cast_storage(NDArray(arg, ctx=ctx, dtype=dtype), "csr")
