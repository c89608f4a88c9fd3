"""PyTorch port: data-parallel training (`parallel/`) against the JAX
package on its 8-device virtual CPU mesh.

CPU replicas are `cpu(0..N-1)` (`context.cpu`), one process driving
them all; the JAX side is the same net on `make_mesh` over its first N
devices.  Nets are tiny (a few thousand parameters); inputs come from
`np.random.RandomState` and the port takes the JAX net's initial
weights (`weights.load_reference_params`).  Tolerances are relative to
each tensor's largest value ("of scale"): 1e-5 for trajectories of a
few steps (the packages sum in other orders), 1e-6 where the port is
held against itself.  The JAX package's zero 2/3 path cannot run on
this jax (its shard_map call), so zero 2/3 are held against the JAX
zero-0 trajectory, which on a BatchNorm-free net is the same function.

Run as a script (`python tests/test_torch_parallel.py worker OUT`) the
file is one rank of the process-group test, started by the port's
launcher.
"""
import os
import sys

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import parallel as tpar

pytestmark = pytest.mark.torch_port

TOL = 1e-5
SELF_TOL = 1e-6
B = 8


def _err(got, ref):
    """max |got - ref| over max |ref| (floored at 1e-6)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def _cpus(n):
    return [tmx.cpu(i) for i in range(n)]


def _port_mlp(hidden=16, classes=4, units=6):
    nn = tmx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(hidden, activation="relu", in_units=units,
                     device="cpu"),
            nn.Dense(classes, in_units=hidden, device="cpu"))
    return net


def _port_bn_net():
    """A bias before BatchNorm has a zero gradient in exact arithmetic,
    which rounding noise moves, so the convolution has none (as in a
    ResNet)."""
    nn = tmx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=3, use_bias=False,
                      device="cpu"),
            nn.BatchNorm(in_channels=4, device="cpu"),
            nn.Activation("relu"), nn.Flatten(),
            nn.Dense(5, in_units=4 * 6 * 6, device="cpu"))
    return net


def _jax_mlp(jgluon, hidden=16, classes=4, units=6):
    nn = jgluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(hidden, activation="relu", in_units=units),
            nn.Dense(classes, in_units=hidden))
    net.initialize()
    return net


def _jax_bn_net(jgluon):
    nn = jgluon.nn
    net = nn.HybridSequential()
    net.add(nn.Conv2D(4, 3, padding=1, in_channels=3, use_bias=False),
            nn.BatchNorm(in_channels=4), nn.Activation("relu"),
            nn.Flatten(), nn.Dense(5, in_units=4 * 6 * 6))
    net.initialize()
    return net


@pytest.fixture(scope="module")
def jax_env():
    """The JAX package's modules, under block-name counters of their
    own (the JAX tests sharing this process read names in order)."""
    import jax
    from incubator_mxnet_tpu import gluon, parallel
    from incubator_mxnet_tpu.gluon.block import nameless_scope
    with nameless_scope():
        yield dict(jax=jax, gluon=gluon, parallel=parallel)


def _twin(jnet, tnet):
    """Give `tnet` the JAX net's weights; {structural name: JAX name}."""
    jp = jnet._collect_params_with_prefix()
    tmx.weights.load_reference_params(
        tnet, {k: p.data().asnumpy() for k, p in jp.items()})
    return {k: p.name for k, p in jp.items()}


def _jax_trainer(env, jnet, n, **kw):
    mesh = env["parallel"].make_mesh(devices=env["jax"].devices()[:n])
    return env["parallel"].ShardedTrainer(jnet, mesh=mesh, **kw)


def _port_trainer(tnet, n, **kw):
    return tpar.ShardedTrainer(
        tnet, mesh=tpar.make_mesh(devices=_cpus(n)), **kw)


def _run(trainer, batches, labels):
    return [float(trainer.step(x, y)) for x, y in zip(batches, labels)]


def _params_err(tparams, jparams, names):
    return {k: _err(tparams[k].float().numpy(), np.asarray(jparams[jn]))
            for k, jn in names.items()}


def _data(shape, classes, steps, seed=0):
    rs = np.random.RandomState(seed)
    xs = [rs.randn(*shape).astype(np.float32) for _ in range(steps)]
    ys = [rs.randint(0, classes, shape[0]).astype(np.int32)
          for _ in range(steps)]
    return xs, ys


# -- meshes and functionalize ----------------------------------------------

def test_mesh_creation(jax_env):
    mesh = tpar.make_mesh(devices=_cpus(8))
    jmesh = jax_env["parallel"].make_mesh()
    assert mesh.devices.size == jmesh.devices.size == 8
    assert mesh.shape == dict(jmesh.shape)
    grid = tpar.make_mesh((4, 2), ("data", "model"), devices=_cpus(8))
    jgrid = jax_env["parallel"].make_mesh((4, 2), ("data", "model"))
    assert grid.axis_names == jgrid.axis_names
    assert grid.shape == dict(jgrid.shape)
    assert tpar.mesh_devices(mesh) == _cpus(8)
    surv = tpar.surviving_mesh(_cpus(4), lost=[1])
    assert tpar.mesh_devices(surv) == [tmx.cpu(0), tmx.cpu(2), tmx.cpu(3)]
    assert tpar.batch_sharded(mesh).spec == ("data",)
    assert tpar.replicated(mesh).spec == ()
    with pytest.raises(ValueError, match="no surviving"):
        tpar.surviving_mesh(_cpus(2), lost=[0, 1])
    if not torch.cuda.is_available():
        # the default mesh is every card: without one it raises
        with pytest.raises(tmx.MXNetError):
            tpar.make_mesh()
        with tmx.cpu():
            assert tpar.mesh_devices(tpar.make_mesh()) == [tmx.cpu()]


def test_functionalize_matches_jax(jax_env):
    jnet = _jax_bn_net(jax_env["gluon"])
    tnet = _port_bn_net()
    names = _twin(jnet, tnet)
    x = np.random.RandomState(3).randn(4, 3, 6, 6).astype(np.float32)
    jpure = jax_env["parallel"].functionalize(jnet, training=True)
    jout, jstates = jpure(jax_env["parallel"].extract_params(jnet), x)
    pure = tpar.functionalize(tnet, training=True)
    before = {k: v.clone() for k, v in tpar.extract_params(tnet).items()}
    out, states = pure(tpar.extract_params(tnet), torch.from_numpy(x))
    assert _err(out.detach().numpy(), np.asarray(jout)) <= SELF_TOL
    assert sorted(names[k] for k in states) == sorted(jstates)
    # the one-pass variance E[x²] - E[x]² cancels: its f32 rounding in
    # another order of sums reaches ~1e-6 of the running variance's scale
    for k, v in states.items():
        assert _err(v.numpy(), np.asarray(jstates[names[k]])) <= \
            2 * SELF_TOL, k
    # the block itself is neither read for its running statistics nor
    # written
    for k, v in tpar.extract_params(tnet).items():
        assert torch.equal(v, before[k])
    # inference: no state updates
    out, states = tpar.functionalize(tnet)(tpar.extract_params(tnet),
                                           torch.from_numpy(x))
    assert states == {}


# -- zero 0 and 1 against the JAX mesh --------------------------------------

def test_zero0_step_matches_jax_mesh_and_gluon_trainer(jax_env):
    """One DP step on 4 replicas == the JAX 4-device step == one
    large-batch gluon.Trainer step on one device."""
    jnet = _jax_mlp(jax_env["gluon"])
    tnet = _port_mlp()
    names = _twin(jnet, tnet)
    xs, ys = _data((B, 6), 4, 1)
    jt = _jax_trainer(jax_env, jnet, 4, optimizer="sgd", lr=0.1,
                      momentum=0.0, zero=0)
    jt.step(xs[0], ys[0])
    ref_net = _port_mlp()
    ref_net.load_state_dict(tnet.state_dict())
    t = _port_trainer(tnet, 4, optimizer="sgd", lr=0.1, momentum=0.0,
                      zero=0)
    assert t.data_parallel_size == 4
    t.step(xs[0], ys[0])
    errs = _params_err(t.params, jt.params, names)
    assert max(errs.values()) <= TOL, errs
    gt = tmx.gluon.Trainer(ref_net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        loss = loss_fn(ref_net(torch.from_numpy(xs[0])),
                       torch.from_numpy(ys[0]).float()).mean()
    tmx.autograd.backward(loss)
    gt.step(1)
    for k, p in ref_net.collect_params().items():
        assert _err(t.params[k].numpy(), p.detach().numpy()) <= TOL, k


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_bn_net_zero01_global_statistics_match_jax_mesh(jax_env, optimizer):
    """Conv -> BatchNorm -> Dense on 4 replicas at zero 0 and 1: the
    parameters, running statistics and losses of 3 steps lie within
    1e-5 of scale of the JAX 4-device mesh's, whose BatchNorm moments
    are global.  Replica-local statistics miss it by far more."""
    steps = 3
    xs, ys = _data((B, 3, 6, 6), 5, steps, seed=1)
    kw = dict(optimizer=optimizer, lr=0.05, wd=1e-4)
    jnet = _jax_bn_net(jax_env["gluon"])
    jt = _jax_trainer(jax_env, jnet, 4, zero=0, **kw)
    jlosses = _run(jt, xs, ys)
    jparams = {k: np.asarray(v) for k, v in jt.params.items()}
    start = _port_bn_net()
    names = _twin(jnet, start)
    runs = {}
    for zero, local in ((0, False), (1, False), (0, True)):
        tnet = _port_bn_net()
        tnet.load_state_dict(start.state_dict())
        t = _port_trainer(tnet, 4, zero=zero, **kw)
        if local:
            t._sync_bn = False      # what the trainer must not do
        runs[(zero, local)] = (_run(t, xs, ys),
                               _params_err(t.params, jparams, names))
    for zero in (0, 1):
        losses, errs = runs[(zero, False)]
        assert _err(losses, jlosses) <= TOL, (zero, losses, jlosses)
        assert max(errs.values()) <= TOL, (zero, errs)
        assert any("running" in k for k in errs)
    losses, errs = runs[(0, True)]
    assert max(errs.values()) > 10 * TOL, errs


def test_zero1_equals_zero0():
    xs, ys = _data((B, 3, 6, 6), 5, 3, seed=2)
    start = _port_bn_net()
    out = {}
    for zero in (0, 1):
        tnet = _port_bn_net()
        tnet.load_state_dict(start.state_dict())
        t = _port_trainer(tnet, 4, zero=zero, optimizer="adam", lr=0.01)
        out[zero] = (_run(t, xs, ys), t.params, t.opt_state)
    assert _err(out[1][0], out[0][0]) <= SELF_TOL
    for k, v in out[0][1].items():
        assert _err(out[1][1][k].numpy(), v.numpy()) <= SELF_TOL, k
    m0, m1 = out[0][2]["m"], out[1][2]["m"]
    assert set(m0) == set(m1)
    for k in m0:
        assert m1[k].shape == m0[k].shape


# -- zero 2 and 3 -----------------------------------------------------------

@pytest.mark.parametrize("n", [4, 3])
@pytest.mark.parametrize("zero", [2, 3])
def test_zero23_matches_jax_zero0_trajectory(jax_env, monkeypatch, zero, n):
    """A BatchNorm-free MLP at zero 2/3, on 4 replicas and on the
    indivisible 3: 5 steps within 1e-5 of scale of the JAX zero-0 mesh.
    A small solo threshold puts the big weights in the solo set."""
    monkeypatch.setenv("MXNET_ZERO_SOLO_KB", "1")
    steps = 5
    xs, ys = _data((4 * n, 24), 4, steps, seed=3)
    jnet = _jax_mlp(jax_env["gluon"], hidden=48, units=24)
    jt = _jax_trainer(jax_env, jnet, n, optimizer="sgd", lr=0.1,
                      momentum=0.9, wd=1e-4, zero=0)
    jlosses = _run(jt, xs, ys)
    tnet = _port_mlp(hidden=48, units=24)
    names = _twin(jnet, tnet)
    t = _port_trainer(tnet, n, optimizer="sgd", lr=0.1, momentum=0.9,
                      wd=1e-4, zero=zero)
    assert t._plan.solo, "no parameter took the solo path"
    losses = _run(t, xs, ys)
    assert _err(losses, jlosses) <= TOL, (losses, jlosses)
    errs = _params_err(t.params, jt.params, names)
    assert max(errs.values()) <= TOL, errs


def test_zero3_params_persist_sharded(monkeypatch):
    monkeypatch.setenv("MXNET_ZERO_SOLO_KB", "1")
    n = 4
    tnet = _port_mlp(hidden=64, units=32)
    total = sum(p.numel() * 4 for p in tnet.parameters())
    t = _port_trainer(tnet, n, zero=3)
    solo = t._plan.bytes_of(t._plan.solo)
    replicated = total - solo
    xs, ys = _data((B, 32), 4, 1)
    t.step(xs[0], ys[0])
    for nbytes in t.replica_param_bytes():
        assert nbytes <= solo / n + replicated
    assert solo > total / 2
    # params reads the global shapes
    for k, v in t.params.items():
        assert tuple(v.shape) == tuple(tnet.collect_params()[k].shape)


@pytest.mark.parametrize("case", [
    dict(shapes={"a": (64, 32), "b": (64,), "c": (32, 16), "d": (10,),
                 "e": (128, 8)}, n=4, cap=0.001, solo=1),
    dict(shapes={"a": (64, 32), "b": (64,), "c": (33, 17), "d": (10,)},
         n=3, cap=0.004, solo=2),
    dict(shapes={"w%d" % i: (i + 1, 16) for i in range(12)}, n=8,
         cap=0.0005, solo=256),
    dict(shapes={"x": (512, 512), "y": (512,), "z": (3, 3)}, n=2,
         cap=0.0, solo=256),
])
def test_bucket_plan_matches_jax(jax_env, monkeypatch, case):
    from incubator_mxnet_tpu.parallel import zero as jzero
    monkeypatch.setenv("MXNET_ZERO_BUCKET_MB", str(case["cap"]))
    monkeypatch.setenv("MXNET_ZERO_SOLO_KB", str(case["solo"]))
    if case["cap"] <= 0:
        monkeypatch.setenv("MXNET_AUTOTUNE", "0")
    order = list(case["shapes"])
    jp = jzero.BucketPlan(case["shapes"], case["n"], order=order)
    tp = tpar.BucketPlan(case["shapes"], case["n"], order=order)
    assert tp.solo == jp.solo
    assert tp.buckets == jp.buckets
    assert tp.cap_bytes == jp.cap_bytes
    assert tp.describe() == jp.describe()


# -- checkpoints ------------------------------------------------------------

def test_checkpoint_resume_and_reshard(tmp_path):
    xs, ys = _data((B, 3, 6, 6), 5, 4, seed=4)
    start = _port_bn_net()

    def trainer(n, zero):
        tnet = _port_bn_net()
        tnet.load_state_dict(start.state_dict())
        return _port_trainer(tnet, n, zero=zero, optimizer="adam", lr=0.01)
    straight = trainer(4, 2)
    _run(straight, xs, ys)
    first = trainer(4, 2)
    _run(first, xs[:2], ys[:2])
    first.save_checkpoint(str(tmp_path / "ck"))
    resumed = trainer(4, 2)
    resumed.load_checkpoint(str(tmp_path / "ck"))
    assert resumed._n_step == 2
    _run(resumed, xs[2:], ys[2:])
    for k, v in straight.params.items():
        assert torch.equal(resumed.params[k], v), k
    # another level on a smaller mesh: the same state, placed anew
    small = trainer(2, 3)
    small.load_checkpoint(str(tmp_path / "ck"))
    for k, v in first.params.items():
        assert torch.equal(small.params[k], v), k
    for k, v in first.opt_state["m"].items():
        assert torch.equal(small.opt_state["m"][k], v), k
    one = trainer(1, 0)
    one.load_checkpoint(str(tmp_path / "ck"))
    one.step(xs[2], ys[2])
    with pytest.raises(FileNotFoundError):
        one.load_checkpoint(str(tmp_path / "missing"))


def test_checkpoint_mismatches_raise(tmp_path):
    t = _port_trainer(_port_mlp(), 2, zero=1)
    t.save_checkpoint(str(tmp_path / "ck"))
    wider = _port_trainer(_port_mlp(hidden=8), 2)
    with pytest.raises(ValueError, match="shape"):
        wider.load_checkpoint(str(tmp_path / "ck"))
    other = _port_trainer(_port_bn_net(), 2)
    with pytest.raises(ValueError, match="name mismatch"):
        other.load_checkpoint(str(tmp_path / "ck"))
    half = _port_mlp()
    half.cast("bfloat16")
    with pytest.raises(ValueError, match="dtype"):
        _port_trainer(half, 2).load_checkpoint(str(tmp_path / "ck"))


def test_zero23_refuse_what_they_cannot_shard():
    grid = tpar.make_mesh((2, 1), ("data", "model"), devices=_cpus(2))
    with pytest.raises(ValueError, match="1-d"):
        tpar.ShardedTrainer(_port_mlp(), mesh=grid, zero=2)
    with pytest.raises(ValueError, match="param_spec_fn"):
        _port_trainer(_port_mlp(), 2, zero=3,
                      param_spec_fn=lambda n, s: tpar.P())
    with pytest.raises(ValueError, match="ZeRO level"):
        _port_trainer(_port_mlp(), 2, zero=4)


@pytest.mark.parametrize("mode,want", [
    ("auto", "trail"), ("trail", "trail"), ("bwd", NotImplementedError),
    ("soon", ValueError)])
def test_zero_overlap_schedule_is_what_the_step_runs(monkeypatch, mode,
                                                     want):
    monkeypatch.setenv("MXNET_ZERO_OVERLAP", mode)
    if isinstance(want, str):
        assert tpar.overlap_schedule(_cpus(2)) == want
    else:
        with pytest.raises(want, match="MXNET_ZERO_OVERLAP"):
            tpar.overlap_schedule(_cpus(2))


def test_one_replica_step_is_captured_and_feeds():
    """One replica: the second step captures, later steps replay, and a
    `device_feed` batch is taken as placed."""
    xs, ys = _data((B, 6), 4, 4, seed=5)
    ref = _port_mlp()
    tnet = _port_mlp()
    tnet.load_state_dict(ref.state_dict())
    eager = _port_trainer(ref, 1, optimizer="adam", lr=0.01)
    eager._capture = False
    t = _port_trainer(tnet, 1, optimizer="adam", lr=0.01)
    feed = t.device_feed(list(zip(xs, ys)))
    losses = [float(t.step(x, y)) for x, y in feed]
    assert (t.eager_steps, t.captures, t.replays) == (1, 1, 2)
    assert losses == _run(eager, xs, ys)
    for k, v in eager.params.items():
        assert torch.equal(t.params[k], v), k
    t.set_learning_rate(0.0)
    before = {k: v.clone() for k, v in t.params.items()}
    t.step(xs[0], ys[0])
    assert t.replays == 3
    for k, v in before.items():
        assert torch.equal(t.params[k], v), k
    t.sync_to_block()
    for k, p in tnet.collect_params().items():
        assert torch.equal(p.detach(), t.params[k]), k


def test_preprocess_runs_inside_the_step():
    """A uint8 batch normalized by `preprocess` inside the step trains as
    the batch normalized beforehand."""
    rs = np.random.RandomState(7)
    raw = [rs.randint(0, 256, (B, 6)).astype(np.uint8) for _ in range(3)]
    ys = [rs.randint(0, 4, B) for _ in range(3)]
    start = _port_mlp()
    runs = []
    for pre in (True, False):
        tnet = _port_mlp()
        tnet.load_state_dict(start.state_dict())
        t = _port_trainer(tnet, 2, zero=1, preprocess=(
            lambda x: (x.float() - 127.5) / 64.0) if pre else None)
        xs = raw if pre else [(r.astype(np.float32) - 127.5) / 64.0
                              for r in raw]
        runs.append((_run(t, xs, ys), t.params))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[1][1].items():
        assert torch.equal(runs[0][1][k], v), k


# -- the process-group form -------------------------------------------------

def _worker(out):
    """One rank: the 2-replica zero-2 step of the in-process test over a
    gloo group, its rank's rows only."""
    assert tmx.base.ensure_distributed(backend="gloo")
    import torch.distributed as dist
    rank = dist.get_rank()
    tmx.random.seed(0)
    tnet = _port_mlp()
    tnet.load_state_dict(torch.load(out + ".start", weights_only=True))
    t = tpar.ShardedTrainer(tnet, device="cpu", zero=int(
        os.environ["ZERO"]), optimizer="sgd", lr=0.1, wd=1e-4)
    assert t.data_parallel_size == 2
    xs, ys = _data((B, 6), 4, 3, seed=6)
    half = B // 2
    losses = [float(t.step(x[rank * half:(rank + 1) * half],
                            y[rank * half:(rank + 1) * half]))
              for x, y in zip(xs, ys)]
    params = t.params
    # the group's reduce-scatter: this rank's shard of the sum, along any
    # dim, summed in f32 for bf16
    base = torch.arange(24, dtype=torch.float32).reshape(3, 8)
    for dt in (torch.float32, torch.bfloat16):
        (shard,) = t.group.reduce_scatter([(base * (rank + 1)).to(dt)], 1)
        assert shard.dtype == dt and torch.equal(
            shard, (base * 3)[:, rank * 4:(rank + 1) * 4].to(dt)), shard
    if rank == 0:
        torch.save({"losses": losses, "params": params}, out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.parametrize("zero", [0, 2])
def test_process_group_trainer_matches_in_process_mesh(tmp_path, zero,
                                                       monkeypatch):
    from incubator_mxnet_tpu_torch.tools import launch
    monkeypatch.setenv("MXNET_ZERO_SOLO_KB", "1")
    start = _port_mlp()
    out = str(tmp_path / "rank0.pt")
    torch.save(start.state_dict(), out + ".start")
    here = os.path.abspath(__file__)
    repo = os.path.dirname(os.path.dirname(here))
    env = {"PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                           ""),
           "ZERO": str(zero), "OMP_NUM_THREADS": "1"}
    log = open(str(tmp_path / "log"), "w")
    rc = launch.launch(2, [sys.executable, here, "worker", out], env=env,
                       timeout=120, out=log)
    log.close()
    assert rc == 0, open(str(tmp_path / "log")).read()[-3000:]
    got = torch.load(out, weights_only=True)
    tnet = _port_mlp()
    tnet.load_state_dict(start.state_dict())
    t = _port_trainer(tnet, 2, zero=zero, optimizer="sgd", lr=0.1, wd=1e-4)
    xs, ys = _data((B, 6), 4, 3, seed=6)
    losses = _run(t, xs, ys)
    assert _err(got["losses"], losses) <= SELF_TOL
    for k, v in t.params.items():
        assert _err(got["params"][k].numpy(), v.numpy()) <= SELF_TOL, k


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv[2])
