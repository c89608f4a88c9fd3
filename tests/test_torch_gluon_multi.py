"""PyTorch port: Gluon on several contexts against the JAX package on its
virtual CPU devices.

`initialize(ctx=[cpu(0), ..., cpu(3)])` keeps a copy per context;
`split_and_load` gives each context its slice; the user's loop records
one forward per replica, and `Trainer(kvstore="device")` sums the
copies' gradients and updates every copy (in the store with
`update_on_kvstore=True`).  The port's CPU replicas are `cpu(i)`
contexts whose tensors live on `cpu` (`context.cpu`).  Nets are tiny;
inputs come from `np.random.RandomState`; the port takes the JAX net's
weights.  Trajectories are held to 1e-5 of scale.
"""
import functools

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import parallel as tpar

pytestmark = pytest.mark.torch_port

TOL = 1e-5
B = 8
STEPS = 3


def _err(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-6))


@pytest.fixture(scope="module")
def jmx():
    """The JAX package, under block-name counters of its own."""
    import incubator_mxnet_tpu as jmx
    from incubator_mxnet_tpu.gluon.block import nameless_scope
    with nameless_scope():
        yield jmx


def _net(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=3, use_bias=False),
            nn.BatchNorm(in_channels=4), nn.Activation("relu"),
            nn.Flatten(), nn.Dense(5, in_units=4 * 6 * 6))
    return net


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return ([rs.randn(B, 3, 6, 6).astype(np.float32) for _ in range(STEPS)],
            [rs.randint(0, 5, B).astype(np.float32) for _ in range(STEPS)])


@functools.lru_cache(maxsize=None)
def _jax_loop(n, update_on_kvstore):
    """The JAX package's multi-device loop: initial weights, and per step
    the losses and every context's parameters."""
    import incubator_mxnet_tpu as jmx
    from incubator_mxnet_tpu.gluon.block import nameless_scope
    with nameless_scope():
        jmx.random.seed(7)
        ctx = [jmx.cpu(i) for i in range(n)]
        net = _net(jmx)
        net.initialize(ctx=ctx)
        params = net._collect_params_with_prefix()
        start = {k: p.data().asnumpy() for k, p in params.items()}
        # the JAX package draws each context's copy on its own; MXNet
        # (and the port) copy one draw to every context
        for k, p in params.items():
            p.set_data(jmx.nd.array(start[k]))
        tr = jmx.gluon.Trainer(net.collect_params(), "sgd", {
            "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
            kvstore="device", update_on_kvstore=update_on_kvstore)
        loss_fn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
        xs, ys = _data()
        out = []
        for x, y in zip(xs, ys):
            data = jmx.gluon.utils.split_and_load(jmx.nd.array(x), ctx)
            label = jmx.gluon.utils.split_and_load(jmx.nd.array(y), ctx)
            with jmx.autograd.record():
                losses = [loss_fn(net(d), l) for d, l in zip(data, label)]
            jmx.autograd.backward(losses)
            tr.step(B)
            out.append(([l.asnumpy() for l in losses],
                        {k: [a.asnumpy() for a in p.list_data()]
                         for k, p in params.items()}))
        return start, out


def _port_loop(n, update_on_kvstore, hybridize, start):
    ctx = [tmx.cpu(i) for i in range(n)]
    net = _net(tmx)
    net.initialize(ctx=ctx)
    tmx.weights.load_reference_params(net, start)
    if hybridize:
        net.hybridize()
    tr = tmx.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        kvstore="device", update_on_kvstore=update_on_kvstore)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    xs, ys = _data()
    out = []
    for x, y in zip(xs, ys):
        data = tmx.gluon.utils.split_and_load(x, ctx)
        label = tmx.gluon.utils.split_and_load(y, ctx)
        with tmx.autograd.record():
            losses = [loss_fn(net(d), l) for d, l in zip(data, label)]
        tmx.autograd.backward(losses)
        tr.step(B)
        out.append(([l.detach().numpy() for l in losses],
                    {k: [a.detach().numpy().copy() for a in p.list_data()]
                     for k, p in net.collect_params().items()}))
    return net, tr, out


@pytest.mark.parametrize("update_on_kvstore", [False, True])
@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_gluon_loop_matches_jax(jmx, n, hybridize, update_on_kvstore):
    """Losses and trained parameters of every context within 1e-5 of
    scale of the JAX loop's.  BatchNorm's running statistics are each
    context's own in the port, as in MXNet, where the JAX package writes
    one replica's update into every copy (ROADMAP Queue 3, R7); they
    do not enter a training-mode forward."""
    start, ref = _jax_loop(n, update_on_kvstore)
    net, tr, got = _port_loop(n, update_on_kvstore, hybridize, start)
    for step, ((tl, tp), (jl, jp)) in enumerate(zip(got, ref)):
        for r in range(n):
            assert _err(tl[r], jl[r]) <= TOL, (step, r)
        for k in jp:
            assert len(tp[k]) == n
            if "running" in k:
                assert _err(tp[k][1], tp[k][0]) > TOL, k
                continue
            for r in range(n):
                assert _err(tp[k][r], jp[k][r]) <= TOL, (step, k, r)
    assert tr._kvstore is not None
    assert tr._update_on_kvstore == update_on_kvstore
    if hybridize:
        graphs = net.__dict__.get("_replica_graphs", {})
        assert set(graphs) == {tmx.cpu(i) for i in range(1, n)}
        assert all(g.replays > 0 for g in graphs.values())


def test_initialize_on_four_contexts(jmx, tmp_path):
    ctx = [tmx.cpu(i) for i in range(4)]
    p = tmx.gluon.Parameter("w", shape=(3, 5))
    p.initialize(tmx.init.Xavier(), ctx=ctx)
    assert p.list_ctx() == ctx
    copies = p.list_data()
    assert len(copies) == 4 and copies[0] is p
    for c in copies[1:]:
        assert torch.equal(c, p.detach())
    assert p.replica(tmx.cpu(2)) is copies[2]
    p.set_data(torch.ones(3, 5))
    assert all(torch.equal(c, torch.ones(3, 5)) for c in p.list_data())
    for c in p.list_data():
        c.grad = torch.ones_like(c)
    p.zero_grad()
    assert all(float(g.abs().sum()) == 0 for g in p.list_grad())
    with pytest.raises(tmx.MXNetError, match="no copy"):
        p.replica(tmx.cpu(5))
    # the JAX package's copies (each context's its own draw there, one
    # draw copied in MXNet and the port), through a parameter file
    jnet = _net(jmx)
    jnet.initialize(ctx=[jmx.cpu(i) for i in range(4)])
    f = str(tmp_path / "p.params")
    jnet.save_parameters(f)
    tnet = _net(tmx)
    tnet.load_parameters(f, ctx=ctx)
    for k, jp in jnet._collect_params_with_prefix().items():
        tp = tnet.collect_params()[k]
        assert tp.list_ctx() == ctx
        assert len(tp.list_data()) == len(jp.list_data()) == 4
        for ta in tp.list_data():
            np.testing.assert_array_equal(ta.detach().numpy(),
                                          jp.data().asnumpy())


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("even_split", [True, False])
def test_split_and_load_matches_jax(jmx, n, even_split):
    x = np.arange(10 * 2, dtype=np.float32).reshape(10, 2)
    jctx = [jmx.cpu(i) for i in range(n)]
    tctx = [tmx.cpu(i) for i in range(n)]
    if even_split and 10 % n:
        with pytest.raises(tmx.MXNetError):
            tmx.gluon.utils.split_and_load(x, tctx, even_split=even_split)
        with pytest.raises(jmx.MXNetError):
            jmx.gluon.utils.split_and_load(jmx.nd.array(x), jctx,
                                           even_split=even_split)
        return
    got = tmx.gluon.utils.split_and_load(x, tctx, even_split=even_split)
    ref = jmx.gluon.utils.split_and_load(jmx.nd.array(x), jctx,
                                         even_split=even_split)
    assert len(got) == len(ref) == n
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(g.numpy(), r.asnumpy())
        assert tmx.context.replica_of(g) == tctx[i]
        assert tmx.nd.NDArray(g).context == tctx[i] or i == 0


def test_sync_batch_norm_matches_jax_shard_map(jmx):
    """SyncBatchNorm(num_devices=4, axis_name) in the threads of a
    4-replica group == the JAX op under a 4-device shard_map axis:
    outputs, moments and the input and parameter gradients."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from incubator_mxnet_tpu.ops import registry
    n = 4
    rs = np.random.RandomState(5)
    x = rs.randn(8, 3, 2, 2).astype(np.float32) * 2 + 1
    dy = rs.randn(8, 3, 2, 2).astype(np.float32)
    g = rs.rand(3).astype(np.float32) + 0.5
    b = rs.randn(3).astype(np.float32)
    fn = registry.get("_contrib_SyncBatchNorm").fn
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("d",))

    def body(xs, gs, bs, dys):
        def f(xs, gs, bs):
            out, mean, var = fn(xs, gs, bs, jnp.zeros(3), jnp.ones(3),
                                eps=1e-5, fix_gamma=False, axis_name="d",
                                _training=True)
            return out, (mean, var)
        out, vjp, (mean, var) = jax.vjp(f, xs, gs, bs, has_aux=True)
        # the JAX op's backward sums dgamma and dbeta over the axis; the
        # port's replicas give their own parts, which the trainer sums
        dx, dg, db = vjp(dys)
        return out, mean, var, dx, dg, db
    jout = shard_map(body, mesh=mesh, in_specs=(P("d"), P(), P(), P("d")),
                     out_specs=(P("d"), P(), P(), P("d"), P(), P()))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), jnp.asarray(dy))

    from incubator_mxnet_tpu_torch.ops import nn as tnn
    group = tpar.ReplicaGroup([tmx.cpu(i) for i in range(n)])
    pool = tpar.DispatchPool(group.local)
    rows = 8 // n

    def replica(r):
        xs = torch.from_numpy(x[r * rows:(r + 1) * rows]).requires_grad_()
        gs = torch.from_numpy(g).requires_grad_()
        bs = torch.from_numpy(b).requires_grad_()
        with tpar.replica_sync(group, r):
            out, mean, var = tnn.sync_batch_norm(
                xs, gs, bs, torch.zeros(3), torch.ones(3), eps=1e-5,
                fix_gamma=False, ndev=n, axis_name="data")
        dx, dg, db = torch.autograd.grad(
            out, [xs, gs, bs], torch.from_numpy(dy[r * rows:(r + 1) * rows]))
        return out, mean, var, dx, dg, db
    res = pool.lockstep(replica, group)
    got = (torch.cat([r[0] for r in res]), res[0][1], res[0][2],
           torch.cat([r[3] for r in res]), sum(r[4] for r in res),
           sum(r[5] for r in res))
    for name, t, j in zip(("out", "mean", "var", "dx", "dgamma", "dbeta"),
                          got, jout):
        assert _err(t.detach().numpy(), np.asarray(j)) <= TOL, name
    for r in res[1:]:
        assert torch.equal(r[1], res[0][1]) and torch.equal(r[2], res[0][2])
    pool.shutdown()
    # the layer: BatchNorm outside a group, and with an axis name it
    # refuses to run outside one
    layer = tmx.gluon.contrib.nn.SyncBatchNorm(num_devices=4, in_channels=3,
                                               device="cpu")
    with tmx.autograd.record():
        layer(torch.from_numpy(x))
    named = tmx.gluon.contrib.nn.SyncBatchNorm(axis_name="data",
                                               in_channels=3, device="cpu")
    with pytest.raises(tmx.MXNetError, match="outside a replica group"):
        with tmx.autograd.record():
            named(torch.from_numpy(x))


def test_device_feed_delivers_each_replicas_rows():
    ctx = [tmx.cpu(i) for i in range(4)]
    mesh = tpar.make_mesh(devices=ctx)
    rs = np.random.RandomState(0)
    batches = [(rs.randn(8, 3).astype(np.float32), np.arange(8) + 10 * i)
               for i in range(3)]
    feed = tmx.io.DeviceFeed(batches, sharding=tpar.batch_sharded(mesh))
    seen = 0
    for (x, y), (hx, hy) in zip(feed, batches):
        assert isinstance(x, tpar.Shards) and len(x) == 4
        for r in range(4):
            assert x[r].context == ctx[r]
            np.testing.assert_array_equal(x[r].asnumpy(),
                                          hx[2 * r:2 * r + 2])
            np.testing.assert_array_equal(y[r].asnumpy(),
                                          hy[2 * r:2 * r + 2])
        seen += 1
    assert seen == 3
    whole = tmx.io.DeviceFeed(batches[:1], sharding=tpar.replicated(mesh))
    (x, _), = list(whole)
    for r in range(4):
        np.testing.assert_array_equal(x[r].asnumpy(), batches[0][0])
    with pytest.raises(ValueError, match="does not split"):
        list(tmx.io.DeviceFeed([(np.zeros((6, 2)),)],
                               sharding=tpar.batch_sharded(mesh)))


def test_multi_context_parameters_save_and_load_into_one(tmp_path):
    ctx = [tmx.cpu(i) for i in range(3)]
    net = _net(tmx)
    net.initialize(ctx=ctx)
    f = str(tmp_path / "m.params")
    net.save_parameters(f)
    one = _net(tmx)
    one.load_parameters(f, ctx="cpu")
    for k, p in net.collect_params().items():
        q = one.collect_params()[k]
        assert q.list_ctx() == [tmx.cpu()]
        assert torch.equal(q.detach(), p.detach())
