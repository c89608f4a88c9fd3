"""PyTorch port: the checkpoint half of `integrity` and the fleet
telemetry, against the JAX package.

- `named_leaves` and `write_manifest` give the same leaf names and
  per-leaf CRCs as the JAX functions for the same parameters and
  optimizer state (f32 and bf16 leaves);
- `verify_checkpoint` names a file with one flipped bit, and the leaves
  where the checkpoint file still loads;
- `audit_replicas` over CPU replicas: clean, then the
  `mesh.replica_divergence` site names the highest replica and a leaf,
  through a kvstore round trip too;
- `telemetry.fleet`: `robust_threshold` and `StragglerDetector` give the
  JAX functions' values and verdicts on the same series, and the
  reporter/view round trip through the port's kvstore.
"""
import json
import os

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import fault, integrity
from incubator_mxnet_tpu_torch import parallel as tpar
from incubator_mxnet_tpu_torch.kvstore import create
from incubator_mxnet_tpu_torch.monitor import events
from incubator_mxnet_tpu_torch.telemetry import fleet, flightrec

pytestmark = pytest.mark.torch_port


def _tree():
    rs = np.random.RandomState(3)
    params = {"w": rs.randn(5, 3).astype(np.float32),
              "b": rs.randn(3).astype(np.float32),
              "gamma": rs.randn(4).astype(np.float32)}
    opt = {"m": {k: rs.randn(*v.shape).astype(np.float32)
                 for k, v in params.items()},
           "t": np.asarray(3, np.int32)}
    return params, opt


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leaf_digests_match_jax(tmp_path, dtype):
    import jax.numpy as jnp
    from incubator_mxnet_tpu import integrity as jint
    params, opt = _tree()
    jparams = {k: jnp.asarray(v, dtype if k != "gamma" else "float32")
               for k, v in params.items()}
    jopt = {"m": {k: jnp.asarray(v) for k, v in opt["m"].items()},
            "t": jnp.asarray(opt["t"])}
    tdt = getattr(torch, dtype)
    tparams = {k: torch.from_numpy(v).to(tdt if k != "gamma"
                                          else torch.float32)
               for k, v in params.items()}
    topt = {"m": {k: torch.from_numpy(v) for k, v in opt["m"].items()},
            "t": torch.tensor(3, dtype=torch.int32)}
    jl = jint.named_leaves(jparams, jopt)
    tl = integrity.named_leaves(tparams, topt)
    assert [n for n, _ in tl] == [n for n, _ in jl]
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    jdoc = json.load(open(jint.write_manifest(str(jdir), leaves=jl)))
    tdoc = json.load(open(integrity.write_manifest(str(tdir), leaves=tl)))
    assert tdoc["algo"] == jdoc["algo"]
    assert tdoc["leaves"] == jdoc["leaves"]
    assert tdoc["schema"] == jdoc["schema"]


def _trainer(n=1):
    nn = tmx.gluon.nn
    tmx.random.seed(7)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8, device="cpu"),
            nn.Dense(4, in_units=16, device="cpu"))
    mesh = tpar.make_mesh(devices=[tmx.cpu(i) for i in range(n)])
    return tpar.ShardedTrainer(net, optimizer="adam", lr=1e-2, mesh=mesh)


def _steps(t, n, seed=0):
    rs = np.random.RandomState(seed)
    for _ in range(n):
        t.step(rs.randn(8, 8).astype(np.float32), rs.randint(0, 4, 8))


def _manifest_ckpt(tmp_path):
    t = _trainer()
    _steps(t, 2)
    ck = str(tmp_path / "ck")
    tree = t.save_checkpoint(ck)
    integrity.write_manifest(ck, leaves=integrity.named_leaves(
        tree["params"], tree["opt_state"]))
    return ck


def test_verify_checkpoint_names_a_flipped_bit(tmp_path):
    ck = _manifest_ckpt(tmp_path)
    rep = integrity.verify_checkpoint(ck)
    assert rep["verified"] and rep["files"] == 1 and rep["leaves"] > 4
    pos = fault.flip_file_bit(os.path.join(ck, "checkpoint.pt"))
    assert pos > 0
    c0 = events.get("integrity.ckpt_corrupt")
    with pytest.raises(integrity.CheckpointCorrupt) as e:
        integrity.verify_checkpoint(ck)
    assert e.value.files == {"checkpoint.pt": "crc mismatch"}
    assert events.get("integrity.ckpt_corrupt") == c0 + 1


def test_verify_checkpoint_names_the_leaf(tmp_path):
    """A checkpoint file rewritten with one leaf changed loads: the
    failure names that leaf."""
    ck = _manifest_ckpt(tmp_path)
    f = os.path.join(ck, "checkpoint.pt")
    tree = torch.load(f, weights_only=True)
    name = sorted(tree["params"])[0]
    tree["params"][name] = tree["params"][name] + 1.0
    torch.save(tree, f)
    with pytest.raises(integrity.CheckpointCorrupt) as e:
        integrity.verify_checkpoint(ck)
    assert e.value.leaves == ["params/%s" % name]
    assert "params/%s" % name in str(e.value)


def test_unverified_and_missing(tmp_path):
    t = _trainer()
    ck = str(tmp_path / "bare")
    t.save_checkpoint(ck)
    assert integrity.verify_checkpoint(ck)["verified"] is False
    with pytest.raises(integrity.CheckpointCorrupt, match="missing"):
        integrity.verify_checkpoint(str(tmp_path / "nothing"))
    with open(os.path.join(ck, integrity.MANIFEST), "w") as fh:
        fh.write("{not json")
    with pytest.raises(integrity.CheckpointCorrupt) as e:
        integrity.verify_checkpoint(ck)
    assert e.value.kind == "manifest"


def test_audit_replicas_and_divergence(tmp_path):
    t = _trainer(4)
    _steps(t, 2)
    rep = integrity.audit_replicas(t, step=2, kv=create("local"),
                                   inject=False)
    assert rep.ok and rep.groups > 0
    assert sorted(rep.digests) == [0, 1, 2, 3]
    c0 = events.get("integrity.sdc")
    fault.install("mesh.replica_divergence", steps=[7], times=1)
    try:
        rep2 = integrity.audit_replicas(t, step=7)
    finally:
        fault.clear()
    assert not rep2.ok and rep2.victims() == [3] and rep2.leaves()
    assert events.get("integrity.sdc") == c0 + 1
    # a replica whose bytes really differ is named by its leaf
    with torch.no_grad():
        name = sorted(t._rparams[1])[0]
        t._rparams[1][name].add_(1.0)
    rep3 = integrity.audit_replicas(t, step=8, rid_of={0: 10, 1: 11, 2: 12,
                                                       3: 13})
    assert rep3.victims() == [11]
    assert rep3.leaves() == ["params/%s" % name]


def test_resilient_audit_rolls_back_or_raises(tmp_path):
    rt = tpar.ResilientTrainer(_trainer(4), ckpt_dir=str(tmp_path / "ck"),
                               seed=3, handle_sigterm=False,
                               audit_interval=0)
    rs = np.random.RandomState(0)
    for _ in range(2):
        rt.step(rs.randn(8, 8).astype(np.float32), rs.randint(0, 4, 8))
    fault.install("mesh.replica_divergence", steps=[97], times=1)
    try:
        rep = rt.audit(step=97)
    finally:
        fault.clear()
    assert rep.victims() == [3] and rt.trainer._n_step == 0
    bare = tpar.ResilientTrainer(_trainer(2), ckpt_dir=None, seed=3,
                                 handle_sigterm=False, audit_interval=0)
    fault.install("mesh.replica_divergence", steps=[11], times=1)
    try:
        with pytest.raises(integrity.SDCDetected):
            bare.audit(step=11)
    finally:
        fault.clear()


# -- fleet telemetry ---------------------------------------------------------

def test_robust_threshold_matches_jax():
    from incubator_mxnet_tpu.telemetry import fleet as jfleet
    rs = np.random.RandomState(4)
    for n in (2, 3, 5, 8):
        vals = list(rs.rand(n) * 1000.0)
        for sigma in (1.0, 4.0):
            assert fleet.robust_threshold(vals, sigma) == \
                jfleet.robust_threshold(vals, sigma)
    assert fleet.FIELDS == jfleet.FIELDS


def test_straggler_detector_matches_jax():
    from incubator_mxnet_tpu.telemetry import fleet as jfleet
    rs = np.random.RandomState(5)
    ours = fleet.StragglerDetector(window=3, sigma=4.0)
    theirs = jfleet.StragglerDetector(window=3, sigma=4.0)
    verdicts = []
    for s in range(24):
        slow = 8 <= s < 16
        per = {r: float(1000.0 + rs.rand() * 30.0
                        + (3000.0 if slow and r == 2 else 0.0))
               for r in range(4)}
        a, b = ours.observe(s, per), theirs.observe(s, per)
        assert a == b, s
        verdicts.append(a)
    assert [2] in verdicts and verdicts[-1] == []
    assert any(e["kind"] == "mesh" and e["name"] == "straggler"
               and e["replica"] == 2 for e in flightrec.ring_snapshot())


def test_fleet_round_trip_and_block():
    kv = create("local")
    view = fleet.FleetView(kv)
    for rid in range(3):
        fleet.FleetReporter(kv, rid).publish(
            {"step": 7, "step_us": 1000.0 * (rid + 1),
             "dispatch_us": 10 * rid})
    merged = view.refresh(range(4))
    assert sorted(merged) == [0, 1, 2]
    assert merged[1]["step_us"] == 2000.0 and merged[0]["step"] == 7
    ft = fleet.FleetTelemetry(kv, 4, window=2, sigma=4.0, publish_steps=1)
    strag = []
    for s in range(6):
        strag = ft.update(s, {r: (8000.0 if (r == 3 and s >= 2) else 2000.0)
                              for r in range(4)})
    assert strag == [3]
    assert ft.block()["stragglers"] == [3]
    assert flightrec.fleet_block()["stragglers"] == [3]
    path = flightrec.dump_blackbox(path=None, reason="fleet-test")
    try:
        assert json.load(open(path))["fleet"]["stragglers"] == [3]
    finally:
        os.remove(path)
