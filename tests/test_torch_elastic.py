"""PyTorch port: `parallel.ElasticTrainer` and `ReplicaHealth`, each case
a counterpart of tests/python/unittest/test_elastic.py, on CPU replica
contexts `cpu(0..N-1)`, and bench.py's elastic scenario at 4 replicas
against the JAX package's on 4 virtual devices (the same transitions,
final losses within 1e-5 of scale).

Failures are injected only at the heartbeat source (`mesh.replica_down`
/ `mesh.replica_slow` suppress the victim's beats); everything after it
is the production path: kvstore heartbeats, staleness, membership
generations and the atomic-checkpoint restore.  The shrunk run is held
bit for bit against a run built on the survivors from the same
checkpoint.  Each test that starts replica threads runs under a
`signal.alarm` of its own.
"""
import json
import math
import os
import signal

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import config, fault
from incubator_mxnet_tpu_torch import parallel as tpar
from incubator_mxnet_tpu_torch.kvstore import StaleMembership, create
from incubator_mxnet_tpu_torch.monitor import events

pytestmark = pytest.mark.torch_port

N = 4
BATCH = N * (N - 1)          # divisible by every mesh a shrink visits
TOL = 1e-5
ALARM_S = 120


@pytest.fixture(autouse=True)
def _alarm():
    def on_alarm(signum, frame):
        raise TimeoutError("elastic test exceeded %d s" % ALARM_S)
    prev = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(ALARM_S)
    fault.clear()
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)
    fault.clear()
    config.unset("MXNET_FAULT_PLAN")


def _cpus(n=N):
    return [tmx.cpu(i) for i in range(n)]


def _err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def _factory(start=None, in_dim=8, hidden=16, classes=4):
    """build_trainer, pure in (mesh, lr_factor): the same initial weights
    every build (all trained state comes from the checkpoint)."""
    def build(mesh, lr_factor):
        nn = tmx.gluon.nn
        tmx.random.seed(11)
        net = nn.HybridSequential()
        net.add(nn.Dense(hidden, activation="relu", in_units=in_dim,
                         device="cpu"),
                nn.Dense(classes, in_units=hidden, device="cpu"))
        if start is not None:
            tmx.weights.load_reference_params(net, start)
        return tpar.ShardedTrainer(net, optimizer="adam",
                                   lr=1e-2 * lr_factor, mesh=mesh)
    return build


def _data_fn(in_dim=8, classes=4, batch=BATCH):
    def data(step, n_replicas):
        rs = np.random.RandomState(1000 + step)
        return (rs.randn(batch, in_dim).astype(np.float32),
                rs.randint(0, classes, batch))
    return data


def _plan(spec):
    config.set("MXNET_FAULT_PLAN", spec)
    fault.reset_from_config()


def _elastic(tmp_path, **kw):
    kw = dict(dict(ckpt_dir=str(tmp_path / "ck"), ckpt_interval=2, seed=5,
                   devices=_cpus(), handle_sigterm=False), **kw)
    return tpar.ElasticTrainer(_factory(), **kw)


# -- meshes, generations, heartbeats -----------------------------------------

def test_surviving_mesh_keeps_the_order():
    devs = _cpus(6)
    kept = tpar.mesh_devices(tpar.surviving_mesh(devs, lost=[3]))
    assert kept == [d for i, d in enumerate(devs) if i != 3]
    assert tpar.mesh_devices(tpar.surviving_mesh(devs, lost=[3])) == kept
    with pytest.raises(ValueError):
        tpar.surviving_mesh(devs, lost=range(6))


def test_replica_health_verdicts():
    kv = create("local")
    h = tpar.ReplicaHealth(kv, 4, stale_steps=1, down_steps=2)
    active = range(4)
    h.beat_all(0, active)
    assert h.poll(0, active) == {r: "healthy" for r in active}
    h.suppress(3)
    down0 = events.get("mesh.replica_down")
    slow0 = events.get("mesh.replica_slow")
    h.beat_all(1, active)
    assert h.poll(1, active)[3] == "slow"
    h.beat_all(2, active)
    v = h.poll(2, active)
    assert v[3] == "down" and all(v[r] == "healthy" for r in range(3))
    h.poll(2, active)
    assert events.get("mesh.replica_down") == down0 + 1
    assert events.get("mesh.replica_slow") == slow0 + 1


def test_replica_health_rejects_a_stale_generation():
    kv = create("local")
    h = tpar.ReplicaHealth(kv, 2, stale_steps=1, down_steps=2)
    assert h.beat(0, step=0)
    kv.advance_generation("shrink")
    h.set_generation(kv.generation)
    stale0 = events.get("mesh.stale_rank_beat")
    assert not h.beat(1, step=1, generation=0)
    assert events.get("mesh.stale_rank_beat") == stale0 + 1
    assert h.poll(1, [1])[1] != "healthy"
    assert h.beat(1, step=1)
    with pytest.raises(StaleMembership):
        kv._barrier(generation=0)


# -- the supervisor ------------------------------------------------------------

def test_replica_slow_is_observed_not_shrunk(tmp_path):
    _plan("mesh.replica_slow@2")
    et = _elastic(tmp_path, ckpt_interval=3)
    slow0 = events.get("mesh.replica_slow")
    down0 = events.get("mesh.replica_down")
    et.run(_data_fn(), 6)
    assert events.get("mesh.replica_slow") == slow0 + 1
    assert events.get("mesh.replica_down") == down0
    assert et.n_replicas == N and not et.transitions
    assert et.state == "healthy"


def test_shrink_below_min_replicas_raises(tmp_path):
    _plan("mesh.replica_down@1")
    et = _elastic(tmp_path, min_replicas=N)
    with pytest.raises(RuntimeError, match="min_replicas"):
        et.run(_data_fn(), 6)


def test_shrunk_run_equals_a_from_checkpoint_run(tmp_path):
    """replica_down@2 shrinks 4 -> 3; the losses after the shrink equal,
    bit for bit, a 3-replica run built on the survivors and restored
    from the checkpoint the shrink resumed from; the dump names the lost
    replica."""
    ck = str(tmp_path / "ck")
    n_steps = 8
    _plan("mesh.replica_down@2")
    et = _elastic(tmp_path, keep=50)
    shrinks0 = events.get("mesh.shrinks")
    losses = et.run(_data_fn(), n_steps)
    assert et.n_replicas == N - 1
    assert events.get("mesh.shrinks") == shrinks0 + 1
    [tr] = [t for t in et.transitions if t["kind"] == "shrink"]
    assert tr["lost"] == [N - 1]
    resumed = tr["resumed_step"]
    assert tr["steps_lost"] == tr["step"] - resumed >= 0
    dump = json.load(open(et.last_blackbox))
    assert dump["reason"] == "mesh.shrink"
    mesh_ev = {e["name"]: e for e in dump["events"]
               if e.get("kind") == "mesh"}
    assert mesh_ev["shrink"]["lost"] == [N - 1]
    assert mesh_ev["shrink"]["survivors"] == N - 1
    assert "cpu:%d" % (N - 1) in mesh_ev["shrink"]["devices"][0]
    assert mesh_ev["replica_down"]["replica"] == N - 1
    assert et.kv.generation == 1
    with pytest.raises(StaleMembership):
        et.kv._barrier(generation=0)
    control = _factory()(tpar.surviving_mesh(_cpus(), lost=[N - 1]),
                         (N - 1) / float(N))
    rc = tpar.ResilientTrainer(control, ckpt_dir=ck, seed=5,
                               ckpt_interval=0, handle_sigterm=False)
    assert rc._restore_from(rc._ckpt_name(resumed))
    for s in range(resumed, n_steps):
        x, y = _data_fn()(s, N - 1)
        loss, ok = rc.step(x, y)
        assert ok and loss == losses[s], s


def test_readmission_at_the_epoch_boundary(tmp_path):
    from incubator_mxnet_tpu_torch.telemetry import flightrec
    _plan("mesh.replica_down@2")
    et = _elastic(tmp_path, steps_per_epoch=6)
    grows0 = events.get("mesh.grows")
    et.run(_data_fn(), 10)
    assert [t["kind"] for t in et.transitions] == ["shrink", "grow"]
    grow = et.transitions[1]
    assert grow["step"] % 6 == 0 and grow["readmitted"] == [N - 1]
    assert et.n_replicas == N and et.state == "healthy"
    assert events.get("mesh.grows") == grows0 + 1
    assert et.kv.generation == 2
    assert any(e["name"] == "grow" and e.get("readmitted") == [N - 1]
               for e in flightrec.ring_snapshot() if e.get("kind") == "mesh")


def test_default_devices_are_the_cards():
    if torch.cuda.is_available():
        pytest.skip("the default mesh has cards here")
    with pytest.raises(tmx.MXNetError):
        tpar.ElasticTrainer(_factory(), ckpt_dir=None)


# -- bench.py's scenario against the JAX package --------------------------------

SCEN = dict(kill_at=6, steps=16, steps_per_epoch=8, in_dim=32, hidden=64,
            classes=8)


def _scenario_batch(n):
    return n * (n - 1) // math.gcd(n, n - 1)


@pytest.fixture(scope="module")
def jax_scenario(tmp_path_factory):
    """bench.py's `_elastic_scenario` setup on the JAX package's first 4
    virtual devices: transitions, losses and the initial weights."""
    import jax
    import incubator_mxnet_tpu as mx
    from incubator_mxnet_tpu import config as jcfg, fault as jfault, \
        gluon, nd, parallel
    from incubator_mxnet_tpu.gluon.block import nameless_scope
    s = SCEN
    start = {}

    def build(mesh, lr_factor):
        mx.random.seed(11)
        net = gluon.nn.HybridSequential(prefix="bel_")
        net.add(gluon.nn.Dense(s["hidden"], in_units=s["in_dim"],
                               activation="relu", prefix="bel_d1_"),
                gluon.nn.Dense(s["classes"], in_units=s["hidden"],
                               prefix="bel_d2_"))
        net.initialize(force_reinit=True)
        net(nd.ones((2, s["in_dim"])))
        if not start:
            start.update({k: p.data().asnumpy() for k, p in
                          net._collect_params_with_prefix().items()})
        return parallel.ShardedTrainer(net, optimizer="adam",
                                       lr=1e-2 * lr_factor, mesh=mesh)
    data = _data_fn(s["in_dim"], s["classes"], _scenario_batch(N))
    jcfg.set("MXNET_FAULT_PLAN", "mesh.replica_down@%d" % s["kill_at"])
    jfault.reset_from_config()
    try:
        with nameless_scope():
            et = parallel.ElasticTrainer(
                build, ckpt_dir=str(tmp_path_factory.mktemp("jel")),
                devices=jax.devices()[:N],
                steps_per_epoch=s["steps_per_epoch"], ckpt_interval=2,
                seed=5, handle_sigterm=False)
            losses = et.run(data, s["steps"])
    finally:
        jfault.clear()
        jcfg.unset("MXNET_FAULT_PLAN")
    return dict(start=start, losses=losses, transitions=et.transitions,
                replicas=et.n_replicas)


def _transition_keys(ts):
    return [(t["kind"], t["step"], tuple(t.get("lost", ())),
             t.get("steps_lost"), tuple(t.get("readmitted", ())))
            for t in ts]


def test_bench_scenario_matches_jax(jax_scenario, tmp_path):
    s = SCEN
    _plan("mesh.replica_down@%d" % s["kill_at"])
    et = tpar.ElasticTrainer(
        _factory(jax_scenario["start"], s["in_dim"], s["hidden"],
                 s["classes"]), ckpt_dir=str(tmp_path / "ck"),
        devices=_cpus(), steps_per_epoch=s["steps_per_epoch"],
        ckpt_interval=2, seed=5, handle_sigterm=False)
    losses = et.run(_data_fn(s["in_dim"], s["classes"],
                             _scenario_batch(N)), s["steps"])
    assert _transition_keys(et.transitions) == \
        _transition_keys(jax_scenario["transitions"])
    assert [t["kind"] for t in et.transitions] == ["shrink", "grow"]
    assert et.n_replicas == jax_scenario["replicas"] == N
    steps = sorted(jax_scenario["losses"])
    assert sorted(losses) == steps
    assert _err([losses[k] for k in steps],
                [jax_scenario["losses"][k] for k in steps]) <= TOL
    block = et.fleet.block()
    assert sorted(block["replicas"]) == [str(r) for r in range(N)]
