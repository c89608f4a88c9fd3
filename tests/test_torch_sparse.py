"""PyTorch port: sparse storage (`nd.sparse`) against the JAX package.

Every function of incubator_mxnet_tpu/ndarray/sparse.py is run in both
packages on the same numpy inputs made from seeds: the storage round
trips (`cast_storage`, `tostype`, `row_sparse_array`, `csr_matrix`,
`rand_ndarray(stype=...)`), `dot` of a CSR matrix with and without
`transpose_a`, `add`, `retain`, `embedding_grad_rsp` / `embedding_grad`
and the three lazy updates.  Indices must be equal, values within 1e-6
of the reference's scale (the same sums in another order).  Then the
paths that produce and consume row_sparse gradients: `attach_grad(stype=
"row_sparse")` with `nd.Embedding(sparse_grad=True)` ('write', 'add',
`autograd.grad`), the Gluon `Embedding(sparse_grad=True)` and
`SparseEmbedding` gradients (the same rows), and a `Trainer` with SGD,
Adam and AdaGrad over 3 steps (within 2e-6 of each tensor's scale of the
JAX Trainer, rows no batch touched bit for bit their initial values),
eager and hybridized (whose recorded calls then run eagerly).  Torch runs
on one thread.
"""
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd as jnd
from incubator_mxnet_tpu import random as jrandom
from incubator_mxnet_tpu import test_utils as jtu
from incubator_mxnet_tpu.gluon.block import nameless_scope
from incubator_mxnet_tpu.gluon.contrib import nn as jcnn
from incubator_mxnet_tpu.ndarray import sparse as jsp
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import autograd as tag
from incubator_mxnet_tpu_torch import nd as tnd
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ndarray import sparse as tsp

pytestmark = pytest.mark.torch_port

# one function on the same inputs: sums in another order
TOL = 1e-6
# 3 optimizer steps of a small net, both packages: the gradients' sums in
# another order, then each update's arithmetic (the optimizer tests'
# 2e-6)
TRAIN_TOL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x.asnumpy() if hasattr(x, "asnumpy") else x)


def _close(got, ref, tol=TOL, what=""):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def _same_rsp(got, ref, tol=TOL, what=""):
    assert got.stype == ref.stype == "row_sparse"
    assert tuple(got.shape) == tuple(ref.shape), what
    np.testing.assert_array_equal(_np(got.indices), _np(ref.indices),
                                  err_msg=what)
    _close(got.data, ref.data, tol, what)


def _sparse_dense(rs, shape, density):
    a = rs.uniform(-1, 1, shape).astype(np.float32)
    return a * (rs.rand(*shape) < density)


@pytest.mark.parametrize("shape,density", [((7, 3), 0.3), ((5, 2, 4), 0.5),
                                           ((6, 5), 0.0), ((4, 4), 1.0)])
def test_row_sparse_round_trip_matches_jax(shape, density):
    a = _sparse_dense(np.random.RandomState(0), shape, density)
    t = tnd.array(a, ctx="cpu").tostype("row_sparse")
    j = jnd.array(a).tostype("row_sparse")
    _same_rsp(t, j)
    assert t.indices.dtype == np.int32
    np.testing.assert_array_equal(t.asnumpy(), a)
    np.testing.assert_array_equal(t.tostype("default").asnumpy(),
                                  j.tostype("default").asnumpy())
    np.testing.assert_array_equal(
        tsp.cast_storage(t, "default").asnumpy(), a)
    rows = _np(j.indices)
    t2 = tsp.row_sparse_array((a[rows], rows), shape=shape, ctx="cpu")
    j2 = jsp.row_sparse_array((a[rows], rows), shape=shape)
    _same_rsp(t2, j2)
    _same_rsp(tsp.row_sparse_array(a, ctx="cpu"), jsp.row_sparse_array(a))


@pytest.mark.parametrize("shape,density", [((7, 5), 0.3), ((4, 9), 0.6),
                                           ((3, 3), 0.0)])
def test_csr_round_trip_matches_jax(shape, density):
    a = _sparse_dense(np.random.RandomState(1), shape, density)
    t = tnd.array(a, ctx="cpu").tostype("csr")
    j = jnd.array(a).tostype("csr")
    assert t.stype == "csr" and t.shape == j.shape
    for part in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(_np(getattr(t, part)),
                                      _np(getattr(j, part)), err_msg=part)
    np.testing.assert_array_equal(t.asnumpy(), a)
    parts = (_np(j.data), _np(j.indices), _np(j.indptr))
    t2 = tsp.csr_matrix(parts, shape=shape, ctx="cpu")
    np.testing.assert_array_equal(t2.asnumpy(),
                                  jsp.csr_matrix(parts, shape=shape)
                                  .asnumpy())
    np.testing.assert_array_equal(tsp.csr_matrix(a, ctx="cpu").asnumpy(), a)
    with pytest.raises(MXNetError, match="2-D"):
        tnd.array(np.ones((2, 2, 2), np.float32), ctx="cpu").tostype("csr")


@pytest.mark.parametrize("transpose_a", [False, True])
def test_csr_dot_matches_jax(transpose_a):
    rs = np.random.RandomState(2)
    a = _sparse_dense(rs, (6, 8), 0.4)
    b = rs.randn(6 if transpose_a else 8, 5).astype(np.float32)
    t = tsp.dot(tnd.array(a, ctx="cpu").tostype("csr"),
                tnd.array(b, ctx="cpu"), transpose_a=transpose_a)
    j = jsp.dot(jnd.array(a).tostype("csr"), jnd.array(b),
                transpose_a=transpose_a)
    _close(t, j)
    _close(t, (a.T if transpose_a else a) @ b, 1e-5)
    dense = tsp.dot(tnd.array(a, ctx="cpu"), tnd.array(b, ctx="cpu"),
                    transpose_a=transpose_a)
    _close(dense, jsp.dot(jnd.array(a), jnd.array(b),
                          transpose_a=transpose_a))


def test_add_and_retain_match_jax():
    rs = np.random.RandomState(3)
    a, b = (_sparse_dense(rs, (9, 3), 0.4) for _ in range(2))
    ta, tb = (tnd.array(x, ctx="cpu").tostype("row_sparse") for x in (a, b))
    ja, jb = (jnd.array(x).tostype("row_sparse") for x in (a, b))
    _same_rsp(tsp.add(ta, tb), jsp.add(ja, jb))
    _close(tsp.add(ta, tnd.array(b, ctx="cpu")), jsp.add(ja, jnd.array(b)))
    want = np.array([0, 2, 5, 8], np.int64)
    _same_rsp(tsp.retain(ta, want), jsp.retain(ja, want))
    _same_rsp(tsp.retain(ta, tnd.array(want, ctx="cpu", dtype="int32")),
              jsp.retain(ja, jnd.array(want, dtype="int32")))


def test_embedding_grad_matches_jax():
    rs = np.random.RandomState(4)
    idx = rs.randint(0, 12, (5, 3))
    cot = rs.randn(5, 3, 4).astype(np.float32)
    t = tsp.embedding_grad_rsp(idx, torch.from_numpy(cot), 12)
    j = jsp.embedding_grad_rsp(idx, jnd.array(cot)._data, 12)
    _same_rsp(t, j)
    _same_rsp(tsp.embedding_grad(tnd.array(idx, ctx="cpu", dtype="int32"),
                                 tnd.array(cot, ctx="cpu"), 12),
              jsp.embedding_grad(jnd.array(idx, dtype="int32"),
                                 jnd.array(cot), 12))
    empty = tsp.zeros_row_sparse((7, 2), "float32", ctx="cpu")
    assert empty.shape == (7, 2) and empty.indices.shape == (0,)
    np.testing.assert_array_equal(empty.asnumpy(), np.zeros((7, 2)))


def _rsp_grad(rs, rows, shape):
    g = np.zeros(shape, np.float32)
    g[rows] = rs.randn(len(rows), *shape[1:]).astype(np.float32)
    return g


@pytest.mark.parametrize("kind", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("clip", [None, 0.3])
def test_lazy_updates_match_jax(kind, clip):
    """Three lazy updates of a (9, 4) weight by gradients on differing
    rows: the touched rows within TOL of JAX, the others bit for bit."""
    rs = np.random.RandomState(5)
    shape = (9, 4)
    w0 = rs.randn(*shape).astype(np.float32)
    tw, jw = tnd.array(w0, ctx="cpu"), jnd.array(w0)
    ts = [tnd.array(np.zeros(shape, np.float32), ctx="cpu")
          for _ in range(2)]
    js = [jnd.array(np.zeros(shape, np.float32)) for _ in range(2)]
    touched = set()
    for rows in ([1, 4], [4, 6, 7], [0]):
        touched.update(rows)
        g = _rsp_grad(rs, rows, shape)
        tg = tnd.array(g, ctx="cpu").tostype("row_sparse")
        jg = jnd.array(g).tostype("row_sparse")
        kw = dict(wd=0.01, rescale_grad=0.5, clip_gradient=clip)
        if kind == "sgd":
            tsp.sparse_sgd_update(tw, tg, 0.1, **kw)
            jsp.sparse_sgd_update(jw, jg, 0.1, **kw)
        elif kind == "adagrad":
            tsp.sparse_adagrad_update(tw, tg, ts[0], 0.1, epsilon=1e-7, **kw)
            jsp.sparse_adagrad_update(jw, jg, js[0], 0.1, epsilon=1e-7, **kw)
        else:
            tsp.sparse_adam_update(tw, tg, ts[0], ts[1], 0.01, 0.9, 0.999,
                                   1e-8, **kw)
            jsp.sparse_adam_update(jw, jg, js[0], js[1], 0.01, 0.9, 0.999,
                                   1e-8, **kw)
        _close(tw, jw, what=kind)
        for a, b in zip(ts, js):
            _close(a, b, what=kind + " state")
    untouched = sorted(set(range(shape[0])) - touched)
    np.testing.assert_array_equal(tw.asnumpy()[untouched], w0[untouched])


def test_lazy_update_writes_a_tensor_in_place():
    """The optimizers hand the lazy updates tensors (a parameter's data,
    its state), which are written in place."""
    w = torch.ones(5, 2)
    ptr = w.data_ptr()
    g = tsp.RowSparseNDArray(np.array([3]), np.ones((1, 2), np.float32),
                             (5, 2), ctx="cpu")
    tsp.sparse_sgd_update(w, g, 0.5)
    assert w.data_ptr() == ptr
    np.testing.assert_array_equal(w.numpy()[:, 0], [1, 1, 1, 0.5, 1])


def test_rand_ndarray_sparse_matches_jax():
    for stype in ("row_sparse", "csr"):
        np.random.seed(7)
        t = tmx.test_utils.rand_ndarray((6, 5), stype, density=0.4,
                                        ctx="cpu")
        np.random.seed(7)
        j = jtu.rand_ndarray((6, 5), stype, density=0.4)
        assert t.stype == j.stype == stype
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def _ids(rs, V, shape):
    return rs.randint(0, V, shape).astype(np.int32)


def test_nd_embedding_sparse_grad_matches_jax():
    """attach_grad(stype="row_sparse") and nd.Embedding(sparse_grad=True):
    'write' gives the rows of the last backward, 'add' their union over
    two backwards, `autograd.grad` a RowSparseNDArray; a dense gradient
    buffer takes the dense gradient."""
    rs = np.random.RandomState(8)
    V, E = 11, 3
    w0 = rs.randn(V, E).astype(np.float32)
    batches = [_ids(rs, V, (4, 2)), _ids(rs, V, (3, 2))]
    cots = [rs.randn(*b.shape, E).astype(np.float32) for b in batches]

    def run(nd_mod, ag, req, stype, **ctx):
        w = nd_mod.array(w0, **ctx)
        w.attach_grad(req, stype=stype)
        for b, c in zip(batches, cots):
            with ag.record():
                out = nd_mod.Embedding(nd_mod.array(b, dtype="int32", **ctx),
                                       w, input_dim=V, output_dim=E,
                                       sparse_grad=True)
                loss = (out * nd_mod.array(c, **ctx)).sum()
            loss.backward()
        return w.grad
    for req in ("write", "add"):
        t = run(tnd, tag, req, "row_sparse", ctx="cpu")
        j = run(jnd, jag, req, "row_sparse")
        _same_rsp(t, j, what=req)
    dense = run(tnd, tag, "write", None, ctx="cpu")
    _close(dense, run(jnd, jag, "write", None))
    w = tnd.array(w0, ctx="cpu")
    w.attach_grad(stype="row_sparse")
    with tag.record():
        out = tnd.Embedding(tnd.array(batches[0], ctx="cpu", dtype="int32"),
                            w, input_dim=V, output_dim=E, sparse_grad=True)
        loss = (out * tnd.array(cots[0], ctx="cpu")).sum()
    g, = tag.grad(loss, [w])
    assert g.stype == "row_sparse"
    np.testing.assert_array_equal(_np(g.indices), np.unique(batches[0]))


def _gluon_pair(V, E, cls="embedding"):
    """(port block, JAX block) with the same weights: an Embedding with
    sparse_grad, or a SparseEmbedding."""
    with nameless_scope():
        j = jgluon.nn.Embedding(V, E, sparse_grad=True) \
            if cls == "embedding" else jcnn.SparseEmbedding(V, E)
    jrandom.seed(0)
    j.initialize()
    t = tmx.gluon.nn.Embedding(V, E, sparse_grad=True) \
        if cls == "embedding" else tmx.gluon.contrib.nn.SparseEmbedding(V, E)
    t.initialize(ctx="cpu")
    # the JAX SparseEmbedding lists its one table twice, as the attribute
    # `_embedding` and the child "embedding"; the port names it once
    params = {n: p.data().asnumpy()
              for n, p in j._collect_params_with_prefix().items()
              if n in t.collect_params()}
    tmx.weights.load_reference_params(t, params)
    return t, j


@pytest.mark.parametrize("cls", ["embedding", "sparse_embedding"])
@pytest.mark.parametrize("req", ["write", "add"])
def test_gluon_embedding_sparse_grad_matches_jax(cls, req):
    """Two backwards: 'write' keeps the rows of the second, 'add' their
    union with the sums (torch accumulates its COO gradients)."""
    rs = np.random.RandomState(9)
    V, E = 13, 4
    t, j = _gluon_pair(V, E, cls)
    tw = next(iter(t.collect_params().values()))
    jw = next(iter(j.collect_params().values()))
    tw.grad_req = jw.grad_req = req
    assert tw.grad_stype == "row_sparse"
    empty = tw.list_grad()[0]
    assert empty.stype == "row_sparse" and empty.indices.shape == (0,)
    for B in (5, 2):
        idx = _ids(rs, V, (B, 3))
        cot = rs.randn(B, 3, E).astype(np.float32)
        with tag.record():
            loss = (t(tnd.array(idx, ctx="cpu", dtype="int32"))
                    * tnd.array(cot, ctx="cpu")).sum()
        tag.backward(loss)
        with jag.record():
            jl = (j(jnd.array(idx, dtype="int32")) * jnd.array(cot)).sum()
        jl.backward()
    _same_rsp(tw.list_grad()[0], jw.grad())
    assert tw.grad.is_sparse
    tw.zero_grad()
    assert tw.list_grad()[0].indices.shape == (0,)


def _net(mx, sparse, V, E, classes, jax_side, device=None):
    nn = mx.gluon.nn
    if jax_side:
        with nameless_scope():
            net = nn.HybridSequential()
            net.add(nn.Embedding(V, E, sparse_grad=sparse), nn.Flatten(),
                    nn.Dense(classes))
        return net
    net = nn.HybridSequential()
    net.add(nn.Embedding(V, E, sparse_grad=sparse), nn.Flatten(),
            nn.Dense(classes))
    return net


@pytest.mark.parametrize("opt,kw", [
    ("sgd", dict(learning_rate=0.5, wd=0.01)),
    ("adam", dict(learning_rate=0.05, wd=0.01)),
    ("adagrad", dict(learning_rate=0.05, wd=0.01, clip_gradient=0.05)),
])
@pytest.mark.parametrize("hybrid", [False, True])
def test_trainer_sparse_steps_match_jax(opt, kw, hybrid):
    """An Embedding(sparse_grad=True) → Flatten → Dense net trained 3
    steps with SoftmaxCrossEntropyLoss: the port's Trainer (lazy updates
    for the table, eagerly) against the JAX Trainer.  A bias's gradient is
    a near-cancelling sum over the batch, 1e-5 apart in relative terms
    between the packages; Adam and AdaGrad divide it by its own history,
    so a step moves the bias by lr times that difference: lr 0.05 keeps
    it within TRAIN_TOL (at lr 0.5 AdaGrad's bias read 4.7e-6)."""
    import incubator_mxnet_tpu as jmx
    rs = np.random.RandomState(10)
    V, E, B, T, C = 40, 3, 6, 2, 3
    jrandom.seed(10)
    jnet = _net(jmx, True, V, E, C, True)
    jnet.initialize()
    batches = [(_ids(rs, V // 2, (B, T)) + 0, rs.randint(0, C, B)
                .astype(np.float32)) for _ in range(3)]
    jnet(jnd.array(batches[0][0], dtype="int32"))
    params = {n: p.data().asnumpy()
              for n, p in jnet._collect_params_with_prefix().items()}
    tnet = _net(tmx, True, V, E, C, False)
    tmx.weights.load_reference_params(tnet, params, device="cpu")
    if hybrid:
        tnet.hybridize()
    jt = jgluon.Trainer(jnet.collect_params(), opt, dict(kw))
    tt = tmx.gluon.Trainer(tnet.collect_params(), opt, dict(kw))
    jl, tl = jgluon.loss.SoftmaxCrossEntropyLoss(), \
        tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    for idx, y in batches:
        with jag.record():
            a = jl(jnet(jnd.array(idx, dtype="int32")), jnd.array(y))
        a.backward()
        jt.step(B)
        with tag.record():
            b = tl(tnet(tnd.array(idx, ctx="cpu", dtype="int32")),
                   tnd.array(y, ctx="cpu"))
        tag.backward(b)
        tt.step(B)
        _close(b, a, TRAIN_TOL, "loss")
    assert tt.sparse_updates == 3
    if hybrid:
        assert tnet._cached_graph.eager_calls == 3
        assert tnet._cached_graph.captures == 0
    jp = {n: p.data().asnumpy()
          for n, p in jnet._collect_params_with_prefix().items()}
    for n, p in tnet.collect_params().items():
        _close(p, jp[n], TRAIN_TOL, n)
    table = "0.weight"
    untouched = sorted(set(range(V)) - set(
        np.concatenate([i.ravel() for i, _ in batches]).tolist()))
    assert untouched
    np.testing.assert_array_equal(
        tnet.collect_params()[table].detach().numpy()[untouched],
        params[table][untouched])


def test_adagrad_takes_a_row_sparse_gradient_as_jax():
    """optimizer.AdaGrad.update given a RowSparseNDArray and given torch's
    COO tensor of the same rows: the JAX AdaGrad's lazy update."""
    from incubator_mxnet_tpu import optimizer as jopt
    from incubator_mxnet_tpu.ndarray.ndarray import NDArray
    rs = np.random.RandomState(11)
    w0 = rs.randn(8, 3).astype(np.float32)
    kw = dict(learning_rate=0.1, wd=1e-3, rescale_grad=0.5)
    jo = jopt.create("adagrad", **kw)
    jw = NDArray(w0)
    jst = jo.create_state(0, jw)
    outs = []
    for form in ("rsp", "coo"):
        o = tmx.optimizer.create("adagrad", **kw)
        w = torch.from_numpy(w0.copy())
        st = o.create_state(0, w)
        outs.append((o, w, st))
    for rows in ([2, 5], [5, 7]):
        g = _rsp_grad(rs, rows, w0.shape)
        jo.update(0, jw, jnd.array(g).tostype("row_sparse"), jst)
        for (o, w, st), form in zip(outs, ("rsp", "coo")):
            grad = tnd.array(g, ctx="cpu").tostype("row_sparse") \
                if form == "rsp" else torch.from_numpy(g).to_sparse()
            o.update(0, w, grad, st)
            _close(w, jw, TRAIN_TOL, form)
            _close(st, jst, TRAIN_TOL, form + " history")
    np.testing.assert_array_equal(outs[0][1].numpy()[[0, 1, 3, 4, 6]],
                                  w0[[0, 1, 3, 4, 6]])


def test_amp_scale_loss_reads_row_sparse_gradients():
    """contrib.amp's loss scaler checks and unscales a row_sparse
    gradient through its values: a scaled step equals the unscaled one,
    and an inf in the sparse gradient skips the step's update and backs
    the scale off."""
    from incubator_mxnet_tpu_torch.contrib import amp
    rs = np.random.RandomState(12)
    V, E, B, T, C = 20, 3, 4, 2, 3
    idx = tnd.array(_ids(rs, V, (B, T)), ctx="cpu", dtype="int32")
    y = tnd.array(rs.randint(0, C, B).astype(np.float32), ctx="cpu")

    def build():
        tmx.random.seed(0)
        net = _net(tmx, True, V, E, C, False)
        net.initialize(ctx="cpu")
        net(idx)
        return net, tmx.gluon.Trainer(net.collect_params(), "sgd",
                                      {"learning_rate": 0.5})
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    plain, pt = build()
    with tag.record():
        loss = loss_fn(plain(idx), y)
    tag.backward(loss)
    pt.step(B)
    scaled, st = build()
    amp.init_trainer(st, amp.LossScaler(init_scale=8.0))
    with tag.record():
        loss = loss_fn(scaled(idx), y)
        with amp.scale_loss(loss, st) as sl:
            tag.backward(sl)
    st.step(B)
    for (n, a), b in zip(plain.collect_params().items(),
                         scaled.collect_params().values()):
        _close(b, a, 1e-6, n)
    before = [p.detach().clone() for p in scaled.parameters()]
    with tag.record():
        loss = loss_fn(scaled(idx), y)
        with amp.scale_loss(loss, st) as sl:
            tag.backward(sl)
            table = scaled.collect_params()["0.weight"]
            table.grad._values()[0, 0] = float("inf")
    st.step(B)
    assert st._amp_loss_scaler.loss_scale == 4.0
    for a, b in zip(before, scaled.parameters()):
        np.testing.assert_array_equal(a.numpy(), b.detach().numpy())


def test_other_sparse_gradients_are_refused():
    o = tmx.optimizer.create("nag", momentum=0.9)
    w = torch.zeros(4, 3)
    g = tsp.RowSparseNDArray(np.array([1]), np.ones((1, 3), np.float32),
                             (4, 3), ctx="cpu")
    with pytest.raises(MXNetError, match="no lazy update"):
        o.update(0, w, g, o.create_state(0, w))
    csr = torch.sparse_csr_tensor(torch.tensor([0, 0, 0, 0, 0]),
                                  torch.zeros(0, dtype=torch.long),
                                  torch.zeros(0), (4, 3))
    with pytest.raises(MXNetError, match="dense or row_sparse"):
        tmx.optimizer.create("sgd").update(0, w, csr, None)
    with pytest.raises(MXNetError, match="grad_stype"):
        tmx.gluon.Parameter("p", shape=(2, 2), grad_stype="csr")


def _split_net(V, E, C, device):
    """An Embedding(sparse_grad=True) that runs eagerly and a hybridized
    Dense head of its own, as a user who keeps the dense part captured
    writes it."""
    tmx.random.seed(0)
    emb = tmx.gluon.nn.Embedding(V, E, sparse_grad=True, device=device)
    head = tmx.gluon.nn.HybridSequential()
    head.add(tmx.gluon.nn.Flatten(), tmx.gluon.nn.Dense(C))
    head.initialize(ctx=device)
    return emb, head


def test_sparse_update_keeps_the_dense_capture():
    """The Trainer updates the row_sparse table lazily and eagerly every
    step, and the hybridized head's parameters through one captured
    update, whose key the table does not change: 1 eager update, 1
    capture, then replays, the same as a dense-only run's."""
    rs = np.random.RandomState(13)
    V, E, B, T, C = 30, 3, 4, 2, 3
    emb, head = _split_net(V, E, C, "cpu")
    head(emb(tnd.array(_ids(rs, V, (B, T)), ctx="cpu", dtype="int32")))
    head.hybridize()
    params = list(emb.collect_params().values()) + \
        list(head.collect_params().values())
    tr = tmx.gluon.Trainer(params, "adam", {"learning_rate": 0.1})
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    keys = []
    for _ in range(5):
        idx = tnd.array(_ids(rs, V, (B, T)), ctx="cpu", dtype="int32")
        y = tnd.array(rs.randint(0, C, B).astype(np.float32), ctx="cpu")
        with tag.record():
            loss = loss_fn(head(emb(idx)), y)
        tag.backward(loss)
        tr.step(B)
        keys.append(tr._warm_key)
    assert (tr.eager_updates, tr.captures, tr.replays,
            tr.sparse_updates) == (1, 1, 3, 5)
    assert all(k == keys[0] for k in keys)
    assert emb.weight.grad.is_sparse
