"""PyTorch port: `mx.nd.NDArray`, its autograd and the Gluon boundary
against the JAX package on the CPU.

The same numpy inputs go through both packages' NDArrays; values and
dtypes (by name) are held to the JAX package's: exactly where the
operation is exact, within 1e-6 relative elsewhere, and the BERT logits
within 2e-5.  The behaviours that differ from torch's are pinned here:
the JAX package's dtype rules (float64 and lists to float32, int64 to
int32, a scalar taking the array's dtype), a write rebinding the array so
that an array made before it does not see it, recording only inside
`record()`, and `attach_grad`'s 'write'/'add'/'null'.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu.contrib import amp as jamp
from incubator_mxnet_tpu.gluon import nn as jgnn
from incubator_mxnet_tpu.gluon.block import nameless_scope
from incubator_mxnet_tpu.models import transformer as jtr

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.contrib import amp as tamp

pytestmark = pytest.mark.torch_port

CPU = "cpu"


def _t(a, **kw):
    return tnd.array(a, ctx=CPU, **kw)


def _dt(x):
    return str(x.dtype).replace("torch.", "")


def _same(t, j, rtol=0.0):
    """Port NDArray `t` equals JAX NDArray `j`: dtype name, shape, values
    (exactly, or within `rtol` relative)."""
    assert _dt(t) == str(j.dtype), (t.dtype, j.dtype)
    a, b = t.asnumpy().astype(np.float64), j.asnumpy().astype(np.float64)
    assert a.shape == b.shape
    if rtol:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol)
    else:
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# creation, dtypes, properties
# ---------------------------------------------------------------------------

_SOURCES = {
    "list": [[1, 2], [3, 4]],
    "float_list": [1.5, -2.0],
    "float64": np.arange(6.0).reshape(2, 3),
    "float32": np.arange(6, dtype=np.float32),
    "int64": np.arange(4, dtype=np.int64),
    "int32": np.arange(4, dtype=np.int32),
    "bool": np.array([True, False]),
    "scalar": 3.0,
}


@pytest.mark.parametrize("kind", sorted(_SOURCES))
def test_array_dtype_rules_match_jax(kind):
    src = _SOURCES[kind]
    _same(_t(src), jnd.array(src))


@pytest.mark.parametrize("dtype", ["float16", "int32", "uint8", "float64",
                                   "int64", np.float32])
def test_array_explicit_dtype_matches_jax(dtype):
    _same(_t([[1, 2, 3]], dtype=dtype), jnd.array([[1, 2, 3]], dtype=dtype))


def test_creation_helpers_match_jax():
    for name, args, kw in [("zeros", ((2, 3),), {}), ("ones", (4,), {}),
                           ("full", ((2, 2), 7.5), {}),
                           ("empty", ((3,),), {}),
                           ("arange", (1.0, 7.0, 1.5), {}),
                           ("arange", (5,), {"dtype": "int32"}),
                           ("linspace", (0.0, 1.0, 5), {}),
                           ("eye", (3, 4, 1), {}),
                           ("zeros", ((2,),), {"dtype": "int32"})]:
        _same(getattr(tnd, name)(*args, ctx=CPU, **kw),
              getattr(jnd, name)(*args, **kw))


def test_properties_match_jax():
    a = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    t, j = _t(a), jnd.array(a)
    assert (t.shape, t.size, t.ndim, t.stype, len(t)) == \
        (j.shape, j.size, j.ndim, j.stype, len(j))
    assert t.dtype == np.float32 and t.context == torch.device("cpu")
    assert t.ctx == t.context and t.grad is None
    _same(t.T, j.T)
    assert t.asnumpy().tolist() == j.tolist() == t.tolist()
    assert float(_t([2.5])) == 2.5 and int(_t([3.0])) == 3
    assert _t([4.0]).asscalar() == 4.0 and _t([[1.0]]).item() == 1.0
    with pytest.raises(ValueError):
        t.asscalar()
    assert [x.shape for x in t] == [(3, 4), (3, 4)]
    assert np.asarray(t).shape == (2, 3, 4) and "NDArray 2x3x4" in repr(t)


def test_array_without_ctx_needs_cuda():
    """No ctx means cuda:0: without a card it raises (no silent CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (lambda: tnd.array([1.0, 2.0]), lambda: tnd.zeros((2,)),
                 lambda: tnd.random.uniform(shape=(2,))):
        with pytest.raises(MXNetError, match="no CUDA device"):
            make()


# ---------------------------------------------------------------------------
# arithmetic, comparisons, methods
# ---------------------------------------------------------------------------

_BIN = [lambda x, y: x + y, lambda x, y: x - y, lambda x, y: x * y,
        lambda x, y: x / y, lambda x, y: x % y, lambda x, y: x ** y,
        lambda x, y: x == y, lambda x, y: x != y, lambda x, y: x > y,
        lambda x, y: x >= y, lambda x, y: x < y, lambda x, y: x <= y]


@pytest.mark.parametrize("k", range(len(_BIN)))
def test_binary_operators_match_jax(k):
    """NDArray op NDArray (broadcasting), NDArray op scalar, scalar op
    NDArray, and an int32 array with a float scalar (the scalar takes the
    array's dtype)."""
    f = _BIN[k]
    rs = np.random.RandomState(k)
    a = rs.uniform(0.5, 2, (3, 4)).astype(np.float32)
    b = rs.uniform(0.5, 2, (1, 4)).astype(np.float32)
    i = rs.randint(1, 5, (3, 4)).astype(np.int32)
    ta, tb, ti = _t(a), _t(b), _t(i)
    ja, jb, ji = jnd.array(a), jnd.array(b), jnd.array(i)
    _same(f(ta, tb), f(ja, jb), rtol=1e-6)
    _same(f(ta, 1.5), f(ja, 1.5), rtol=1e-6)
    _same(f(1.5, ta), f(1.5, ja), rtol=1e-6)
    _same(f(ti, 2.5), f(ji, 2.5), rtol=1e-6)
    # a numpy scalar defers to the NDArray (the JAX NDArray lets numpy
    # take it: its result is a numpy array)
    assert torch.equal(f(np.float32(1.5), ta)._data, f(1.5, ta)._data)


_METHODS = [
    ("negative", lambda x: -x, {}), ("abs", abs, {}),
    ("sum", lambda x: x.sum(axis=1), {"axis": 1}),
    ("mean", lambda x: x.mean(), {}),
    ("max", lambda x: x.max(axis=(0, 2)), {"axis": (0, 2)}),
    ("min", lambda x: x.min(axis=2, keepdims=True),
     {"axis": 2, "keepdims": True}),
    ("prod", lambda x: x.prod(), {}), ("norm", lambda x: x.norm(), {}),
    ("argmax", lambda x: x.argmax(axis=1), {"axis": 1}),
    ("argmin", lambda x: x.argmin(), {}),
    ("argsort", lambda x: x.argsort(axis=2), {"axis": 2}),
    ("sort", lambda x: x.sort(axis=0, is_ascend=False),
     {"axis": 0, "is_ascend": False}),
    ("topk", lambda x: x.topk(axis=2, k=2), {"axis": 2, "k": 2}),
    ("sqrt", lambda x: x.sqrt(), {}), ("square", lambda x: x.square(), {}),
    ("exp", lambda x: x.exp(), {}), ("log", lambda x: x.log(), {}),
    ("sigmoid", lambda x: x.sigmoid(), {}), ("tanh", lambda x: x.tanh(), {}),
    ("relu", lambda x: x.relu(), {}), ("softmax", lambda x: x.softmax(), {}),
    ("log_softmax", lambda x: x.log_softmax(axis=1), {"axis": 1}),
    ("clip", lambda x: x.clip(0.8, 1.5), {"a_min": 0.8, "a_max": 1.5}),
    ("sign", lambda x: x.sign(), {}),
    ("reshape", lambda x: x.reshape(4, -1), {"shape": (4, -1)}),
    ("reshape", lambda x: x.reshape((0, -3)), {"shape": (0, -3)}),
    ("expand_dims", lambda x: x.expand_dims(1), {"axis": 1}),
    ("Flatten", lambda x: x.flatten(), {}),
    ("transpose", lambda x: x.transpose((2, 0, 1)), {"axes": (2, 0, 1)}),
    ("swapaxes", lambda x: x.swapaxes(0, 2), {"dim1": 0, "dim2": 2}),
    ("flip", lambda x: x.flip(1), {"axis": 1}),
    ("tile", lambda x: x.tile((1, 2, 1)), {"reps": (1, 2, 1)}),
    ("repeat", lambda x: x.repeat(2, axis=0), {"repeats": 2, "axis": 0}),
    ("slice", lambda x: x.slice((0, 1), (2, 3)),
     {"begin": (0, 1), "end": (2, 3)}),
    ("slice_axis", lambda x: x.slice_axis(2, 1, 3),
     {"axis": 2, "begin": 1, "end": 3}),
    ("zeros_like", lambda x: x.zeros_like(), {}),
    ("ones_like", lambda x: x.ones_like(), {}),
    ("cast", lambda x: x.astype("int32"), {"dtype": "int32"}),
    ("squeeze", lambda x: x.squeeze(), {}),
    ("broadcast_to", lambda x: x.broadcast_to((3, 2, 3, 4)),
     {"shape": (3, 2, 3, 4)}),
]


def test_methods_dispatch_to_their_ops():
    """Each method gives its registry op's result (the op is held to the
    JAX package in test_torch_op_sweep.py); those with MXNet-specific
    meanings (reshape codes, axis tuples, descending sort, topk indices,
    astype) are held to the JAX methods too."""
    a = np.random.RandomState(1).uniform(0.5, 2, (2, 3, 4)).astype(
        np.float32)
    t, j = _t(a), jnd.array(a)
    for op, method, kw in _METHODS:
        got, ref = method(t), getattr(tnd, op)(t, **kw)
        assert torch.equal(got._data, ref._data), op
    for f in (lambda x: x.max(axis=(0, 2)), lambda x: x.reshape((0, -3)),
              lambda x: x.sort(axis=0, is_ascend=False),
              lambda x: x.topk(axis=2, k=2), lambda x: x.astype("int32"),
              lambda x: x.split(2, axis=2)[1],
              lambda x: x.reshape(6, 4) @ x.reshape(4, 6),
              lambda x: x.pick(x.argmax(axis=2), axis=2),
              lambda x: x.argmax(axis=2).one_hot(4)):
        _same(f(t), f(j), rtol=1e-6)


def test_getitem_matches_jax():
    a = np.arange(60, dtype=np.float32).reshape(3, 4, 5)
    t, j = _t(a), jnd.array(a)
    idx = np.array([2, 0], np.int32)
    for key in (1, -1, slice(1, 3), (slice(None), 2), (0, slice(None, None,
                                                                 -1)),
                slice(None, None, -2), (1, 2, 3), (Ellipsis, 1)):
        _same(t[key], j[key])
    _same(t[_t(idx)], j[jnd.array(idx)])
    _same(t[_t(idx), 1], j[jnd.array(idx), 1])


def test_setitem_matches_jax():
    a = np.arange(20, dtype=np.float32).reshape(4, 5)
    t, j = _t(a), jnd.array(a)
    for key, val in ((0, 7.0), ((slice(1, 3), 2), -1.0),
                     (slice(None), np.arange(5, dtype=np.float32)),
                     ((3, slice(0, 2)), "nd")):
        nd_val = isinstance(val, str)
        tv = _t([9.0, 8.0]) if nd_val else val
        jv = jnd.array([9.0, 8.0]) if nd_val else val
        t[key] = tv
        j[key] = jv
        _same(t, j)


def test_write_does_not_reach_arrays_made_before_it():
    """Torch answers reshape, slice, transpose and expand_dims with views;
    a write rebinds the array (as the JAX package rebinds its buffer), so
    those arrays keep the values they had, in both packages."""
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    results = []
    for nd in (tnd, jnd):
        x = nd.array(a, ctx=CPU) if nd is tnd else nd.array(a)
        made = [x.reshape((4, 3)), x[1:], x.T, x.expand_dims(0), x[0],
                x.split(2, axis=1)[0], x.copy()]
        x[:] = 0
        x += 1
        x *= 3
        results.append([m.asnumpy() for m in made] + [x.asnumpy()])
    for r_t, r_j in zip(*results):
        np.testing.assert_array_equal(r_t, r_j)
    np.testing.assert_array_equal(results[0][0], a.reshape(4, 3))
    np.testing.assert_array_equal(results[0][-1], np.full((3, 4), 3.0))


def test_copyto_astype_as_in_context_waitall():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t, j = _t(a), jnd.array(a)
    dst_t, dst_j = tnd.zeros((2, 3), ctx=CPU), jnd.zeros((2, 3))
    view = dst_t.reshape((3, 2))
    assert t.copyto(dst_t) is dst_t and j.copyto(dst_j) is dst_j
    _same(dst_t, dst_j)
    assert (view.asnumpy() == 0).all()
    _same(t.copyto(tmx.cpu()), j.copyto(jmx.cpu()))
    _same(t.astype("int32"), j.astype("int32"))
    assert t.astype("float32", copy=False) is t
    assert t.as_in_context(tmx.cpu()) is t
    tnd.waitall()
    t.wait_to_read()
    _same(t.copy(), j.copy())
    assert t.copy()._data.data_ptr() != t._data.data_ptr()


def test_concat_stack_and_generated_functions():
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    t, j = _t(a), jnd.array(a)
    _same(tnd.concat(t, t, dim=0), jnd.concat(j, j, dim=0))
    _same(tnd.stack(t, t, axis=1), jnd.stack(j, j, axis=1))
    _same(tnd.broadcast_add(t, t), jnd.broadcast_add(j, j))
    _same(tnd.dot(t, t, transpose_b=True), jnd.dot(j, j, transpose_b=True),
          rtol=1e-6)
    assert tnd.dot.__name__ == "dot" and tnd.contrib.flash_attention
    _same(tnd.contrib.arange_like(t), jnd.contrib.arange_like(j))


def test_out_writes_results_and_dlpack_roundtrip():
    w, g = _t([1.0, 2.0]), _t([0.5, -0.5])
    m, v = tnd.zeros((2,), ctx=CPU), tnd.zeros((2,), ctx=CPU)
    jw, jg = jnd.array([1.0, 2.0]), jnd.array([0.5, -0.5])
    jm, jv = jnd.zeros((2,)), jnd.zeros((2,))
    assert tnd.adam_update(w, g, m, v, out=(w, m, v), lr=0.1)[0] is w
    jnd.adam_update(jw, jg, jm, jv, out=(jw, jm, jv), lr=0.1)
    for a, b in ((w, jw), (m, jm), (v, jv)):
        _same(a, b, rtol=1e-6)
    w2 = _t([1.0, 2.0])
    assert tnd.sgd_update(w2, g, out=w2, lr=1.0) is w2
    np.testing.assert_allclose(w2.asnumpy(), [0.5, 2.5])
    back = tnd.from_dlpack(tnd.to_dlpack_for_read(w))
    assert (back.asnumpy() == w.asnumpy()).all()


def test_save_takes_ndarrays(tmp_path):
    f = str(tmp_path / "a.params")
    tnd.save(f, {"x": _t([1.0, 2.0]), "y": torch.ones(2)})
    got = tnd.load(f, ctx=CPU)
    assert set(got) == {"x", "y"} and isinstance(got["x"], tnd.NDArray)
    assert jnd.load(f)["x"].asnumpy().tolist() == [1.0, 2.0]


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def _both(fn):
    """fn(nd, autograd, array) run with each package."""
    return (fn(tnd, tag, lambda a: _t(a)),
            fn(jnd, jag, lambda a: jnd.array(a)))


def test_recording_only_inside_record():
    def run(nd, ag, arr):
        x = arr([1.0, 2.0])
        x.attach_grad()
        y = x * 2
        with pytest.raises(Exception, match="cannot differentiate"):
            y.backward()
        with ag.pause():
            pass
        with ag.record():
            z = x * x
            with ag.pause():
                w = x * 3
        with pytest.raises(Exception, match="cannot differentiate"):
            w.backward()
        z.backward()
        return x.grad.asnumpy()
    t, j = _both(run)
    np.testing.assert_array_equal(t, j)
    x = _t([1.0])
    x.attach_grad()
    assert not (x * 2)._data.requires_grad     # no graph outside record


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_attach_grad_requests_match_jax(req):
    def run(nd, ag, arr):
        x = arr([1.0, -2.0, 3.0])
        x.attach_grad(grad_req=req)
        grads = []
        for k in (1.0, 2.0):
            with ag.record():
                y = (x * x * k).sum() + x.sum()
            if req == "null":
                with pytest.raises(Exception, match="cannot differentiate"):
                    y.backward()
            else:
                y.backward()
            grads.append(x.grad.asnumpy().copy())
        return grads
    t, j = _both(run)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_attached_array_stays_a_leaf_after_a_write():
    def run(nd, ag, arr):
        x = arr([1.0, 2.0])
        x.attach_grad()
        x[:] = 3.0
        x += 1.0
        with ag.record():
            y = (x * x).sum()
        y.backward()
        return x.grad.asnumpy()
    t, j = _both(run)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, [8.0, 8.0])


def test_head_gradients_and_retain_graph():
    def run(nd, ag, arr):
        x = arr([1.0, 2.0, 3.0])
        x.attach_grad()
        with ag.record():
            y = x * x
        y.backward(arr([1.0, 0.5, -1.0]), retain_graph=True)
        first = x.grad.asnumpy().copy()
        ag.backward([y], [arr([2.0, 2.0, 2.0])])
        return first, x.grad.asnumpy()
    t, j = _both(run)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_grad_first_and_second_order_of_cube():
    """d(x^3)/dx without create_graph (no .grad written), and d2/dx2 by a
    backward through the create_graph gradient."""
    def run(nd, ag, arr):
        x = arr([0.5, -1.0, 2.0])
        x.attach_grad()
        with ag.record():
            y = x * x * x
        g1, = ag.grad(y, [x])
        untouched = x.grad.asnumpy().copy()
        with ag.record():
            y = x * x * x
            g, = ag.grad(y, [x], create_graph=True)
            s = g.sum()
        s.backward()
        return g1.asnumpy(), untouched, g.asnumpy(), x.grad.asnumpy()
    t, j = _both(run)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_allclose(t[3], 6 * np.array([0.5, -1.0, 2.0]))
    assert (t[1] == 0).all()


def test_gradient_penalty_on_dense_net_matches_jax():
    """||d sum(net(x)) / dx||^2 of a two-layer Dense net (tanh), its
    gradient w.r.t. every weight and x by a second backward, against the
    JAX package on the same weights."""
    rs = np.random.RandomState(5)
    xs = rs.randn(4, 5).astype(np.float32)
    with nameless_scope():
        jnet = jgnn.HybridSequential()
        jnet.add(jgnn.Dense(8, in_units=5, activation="tanh"),
                 jgnn.Dense(3, in_units=8))
        jnet.initialize()
    tnet = tmx.gluon.nn.HybridSequential()
    tnet.add(tmx.gluon.nn.Dense(8, in_units=5, activation="tanh",
                                device=CPU),
             tmx.gluon.nn.Dense(3, in_units=8, device=CPU))
    jparams = [p for _, p in sorted(jnet._collect_params_with_prefix()
                                    .items())]
    tparams = [p for _, p in sorted(tnet.collect_params().items())]
    for tp, jp in zip(tparams, jparams):
        tp.set_data(jp.data().asnumpy())

    def run(nd, ag, net, arr):
        x = arr(xs)
        x.attach_grad()
        with ag.record():
            y = net(x)
            gx, = ag.grad(y.sum(), [x], create_graph=True)
            pen = (gx * gx).sum()
        pen.backward()
        return y, gx, pen, x.grad
    ty, tgx, tpen, txg = run(tnd, tag, tnet, _t)
    jy, jgx, jpen, jxg = run(jnd, jag, jnet, jnd.array)
    assert isinstance(ty, tnd.NDArray)
    for a, b in ((ty, jy), (tgx, jgx), (tpen, jpen), (txg, jxg)):
        _same(a, b, rtol=2e-6)
    for tp, jp in zip(tparams, jparams):
        # the last bias does not reach the penalty: torch leaves its
        # .grad None where the JAX buffer stays zero
        tg = torch.zeros_like(tp) if tp.grad is None else tp.grad
        np.testing.assert_allclose(tg.numpy(), jp.grad().asnumpy(),
                                   rtol=2e-5, atol=2e-6)


def test_function_sigmoid_matches_jax():
    """The JAX docstring's custom sigmoid: forward and backward run
    paused; the call is one recorded node."""
    def run(nd, ag, arr):
        class sigmoid(ag.Function):
            def forward(self, x):
                y = 1 / (1 + nd.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)

        x = arr([-1.0, 0.0, 2.0])
        x.attach_grad()
        with ag.record():
            y = sigmoid()(x)
            z = (y * arr([1.0, 2.0, 3.0])).sum()
        z.backward()
        out = sigmoid()(x)          # not recording: the forward only
        return y.asnumpy(), x.grad.asnumpy(), out.asnumpy()
    t, j = _both(run)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_function_under_create_graph_raises():
    class double(tag.Function):
        def forward(self, x):
            return x * 2

        def backward(self, dy):
            return dy * 2

    x = _t([1.0])
    x.attach_grad()
    with pytest.raises(MXNetError, match="differentiable once"):
        with tag.record():
            tag.grad(double()(x) * x, [x], create_graph=True)


def test_mark_variables_matches_jax():
    def run(nd, ag, arr):
        x, gx = arr([1.0, 2.0]), arr([0.0, 0.0])
        w, gw = arr([3.0, -1.0]), arr([10.0, 10.0])
        ag.mark_variables([x, w], [gx, gw], grad_reqs=["write", "add"])
        with ag.record():
            y = (x * w).sum()
        y.backward()
        return x.grad.asnumpy(), gw.asnumpy(), x.grad is gx
    t, j = _both(run)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    assert t[2] and j[2]


# ---------------------------------------------------------------------------
# Gluon boundary, metric, amp
# ---------------------------------------------------------------------------

KW = dict(vocab_size=1000, max_length=64, dropout=0.0)


def test_bert_small_fed_ndarray_matches_tensor_and_jax():
    """bert_small called with an NDArray returns an NDArray bit for bit
    the same call fed the tensor, within 2e-5 of the JAX model's logits;
    a loss block and a metric take NDArrays too."""
    tokens = np.random.RandomState(3).randint(0, 1000, (2, 32)) \
        .astype(np.int32)
    with nameless_scope():
        jnet = jtr.bert_small(**KW)
        jnet.initialize()
    jnet.hybridize()        # one XLA program: quicker to build here
    ref = jnet(jnd.array(tokens, dtype="int32")).asnumpy()
    params = {name: p.data().asnumpy()
              for name, p in jnet._collect_params_with_prefix().items()}
    net = tmx.models.bert_small(device=CPU, **KW)
    tmx.weights.load_reference_params(net, params)
    x = _t(tokens, dtype="int32")
    with tag.pause():
        out = net(x)
        plain = net(torch.from_numpy(tokens))
    assert isinstance(out, tnd.NDArray) and isinstance(plain, torch.Tensor)
    assert torch.equal(out._data, plain)
    assert np.abs(out.asnumpy() - ref).max() <= 2e-5 * max(
        1.0, np.abs(ref).max())
    labels = _t(np.random.RandomState(4).randint(0, 1000, (2, 32)))
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tag.record():
        loss = loss_fn(net(x), labels)
    assert isinstance(loss, tnd.NDArray) and loss.shape == (2,)
    loss.backward()
    assert net.collect_params()["word_embed.weight"].grad is not None
    acc = tmx.metric.Accuracy(axis=-1)
    acc.update([labels], [out])
    assert 0.0 <= acc.get()[1] <= 1.0


def test_amp_wraps_registry_ops_like_jax():
    """Under amp.init('bfloat16'), nd.dot (a TARGET op) runs in bf16 and
    nd.exp (an FP32 op) casts bf16 up, in both packages; turn_off
    restores them."""
    rs = np.random.RandomState(6)
    a, b = rs.randn(4, 8).astype(np.float32), rs.randn(8, 3).astype(
        np.float32)
    tamp.init("bfloat16")
    jamp.init("bfloat16")
    try:
        td, jd = tnd.dot(_t(a), _t(b)), jnd.dot(jnd.array(a), jnd.array(b))
        assert _dt(td) == str(jd.dtype) == "bfloat16"
        np.testing.assert_allclose(td.asnumpy(), jd.asnumpy().astype(
            np.float32), rtol=1e-2, atol=1e-2)
        tb = tnd.exp(td)
        jb = jnd.exp(jd)
        assert _dt(tb) == str(jb.dtype) == "float32"
        np.testing.assert_allclose(tb.asnumpy(), jb.asnumpy(), rtol=1e-5)
        assert _dt(tnd.exp(_t(a))) == "float32"
    finally:
        tamp.turn_off()
        jamp.turn_off()
    assert _dt(tnd.dot(_t(a), _t(b))) == "float32"


def test_test_utils(monkeypatch):
    """The port's test_utils on NDArrays: comparisons, random arrays on
    the test device, the numeric gradient check (against the JAX
    package's on the same function) and assert_exception."""
    from incubator_mxnet_tpu import test_utils as jtu
    tu = tmx.test_utils
    monkeypatch.setenv("MXNET_TEST_DEVICE", "cpu")
    assert tu.default_context() == torch.device("cpu")
    a = tu.rand_ndarray((3, 4))
    assert a.shape == (3, 4) and a.context == torch.device("cpu")
    assert -1 <= a.asnumpy().min() and a.asnumpy().max() <= 1
    assert tu.same(a, a.asnumpy()) and tu.almost_equal(a, a + 1e-7)
    assert not tu.almost_equal(a, a + 1.0)
    with pytest.raises(AssertionError, match="differ"):
        tu.assert_almost_equal(a, a + 1.0)
    tu.assert_exception(lambda: _t([1.0]).nonexistent,
                        AttributeError)
    with pytest.raises(AssertionError, match="did not raise"):
        tu.assert_exception(lambda: None, ValueError)
    assert all(1 <= n <= 5 for n in tu.rand_shape_nd(3, dim=5))
    assert len(tu.rand_shape_2d()) == 2 and len(tu.rand_shape_3d()) == 3
    x = np.random.RandomState(2).uniform(0.5, 1.5, (3, 4)).astype(np.float32)
    for utils, nd in ((tu, tnd), (jtu, jnd)):
        utils.check_numeric_gradient(lambda v: nd.log(v) * nd.tanh(v), [x])
