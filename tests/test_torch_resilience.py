"""PyTorch port: `parallel.ResilientTrainer` against the JAX package, and
the port's own recovery paths, each a counterpart of a case of
tests/python/unittest/test_resilience.py.

An MLP (8 -> 16 -> 4, Adam) trains under both wrappers with `grad_nan`
at step 2 and `loss_spike` at step 4: the same `ok` sequence and loss
scale trajectory, the losses and the final parameters within 1e-5 of
scale (the packages sum in other orders).  The JAX run is made once per
module.  The port's own cases hold bit for bit: a skipped step leaves
the parameters, the optimizer state and BatchNorm's running statistics
as they were, and a preempted run resumes into the uninterrupted one.
Inputs come from `np.random.RandomState`; no seed is shared between the
packages.
"""
import os
import shutil
import signal

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import fault, integrity
from incubator_mxnet_tpu_torch import parallel as tpar
from incubator_mxnet_tpu_torch.contrib.amp.loss_scaler import LossScaler
from incubator_mxnet_tpu_torch.monitor import events

pytestmark = pytest.mark.torch_port

TOL = 1e-5
STEPS = 6
PLAN = (("grad_nan", 2), ("loss_spike", 4))


def _err(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-6))


def _data(n, batch=8, seed=0):
    rs = np.random.RandomState(seed)
    return ([rs.randn(batch, 8).astype(np.float32) for _ in range(n)],
            [rs.randint(0, 4, batch) for _ in range(n)])


def _port_net(bn=False):
    nn = tmx.gluon.nn
    tmx.random.seed(7)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation="relu", in_units=8, device="cpu"))
    if bn:
        net.add(nn.BatchNorm(in_channels=16, device="cpu"))
    net.add(nn.Dense(4, in_units=16, device="cpu"))
    return net


def _trainer(net=None, n=1, **kw):
    net = net if net is not None else _port_net()
    kw = dict(dict(optimizer="adam", lr=1e-2), **kw)
    if n == 1:
        return tpar.ShardedTrainer(net, device="cpu", **kw)
    return tpar.ShardedTrainer(net, mesh=tpar.make_mesh(
        devices=[tmx.cpu(i) for i in range(n)]), **kw)


def _resilient(ckpt_dir, trainer=None, **kw):
    kw = dict(dict(seed=123, handle_sigterm=False), **kw)
    return tpar.ResilientTrainer(trainer or _trainer(), ckpt_dir=ckpt_dir,
                                 **kw)


def _state(t):
    """Host copies of the parameters and the optimizer state."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return tree.detach().cpu().clone()
    return walk(t.params), walk(t.opt_state)


def _same(a, b):
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.fixture(autouse=True)
def _no_faults():
    fault.clear()
    yield
    fault.clear()


# -- against the JAX package -----------------------------------------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX ResilientTrainer's run of the plan, and its initial
    weights."""
    import jax
    from incubator_mxnet_tpu import fault as jfault, gluon, nd, parallel
    from incubator_mxnet_tpu.contrib.amp.loss_scaler import \
        LossScaler as JScaler
    from incubator_mxnet_tpu.gluon.block import nameless_scope
    xs, ys = _data(STEPS)
    with nameless_scope():
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(16, in_units=8, activation="relu"),
                gluon.nn.Dense(4, in_units=16))
        net.initialize()
        net(nd.ones((2, 8)))
        start = {k: p.data().asnumpy()
                 for k, p in net._collect_params_with_prefix().items()}
        names = {k: p.name
                 for k, p in net._collect_params_with_prefix().items()}
        mesh = parallel.make_mesh(devices=jax.devices()[:1])
        rt = parallel.ResilientTrainer(
            parallel.ShardedTrainer(net, optimizer="adam", lr=1e-2,
                                    mesh=mesh),
            ckpt_dir=str(tmp_path_factory.mktemp("jck")), seed=123,
            spike_factor=5.0, loss_scaler=JScaler(init_scale=256.0),
            handle_sigterm=False)
        jfault.clear()
        for site, step in PLAN:
            jfault.install(site, steps=[step], times=1)
        try:
            run = []
            for i in range(STEPS):
                loss, ok = rt.step(xs[i], ys[i])
                run.append((loss, ok, rt.scaler.loss_scale))
        finally:
            jfault.clear()
        params = {k: np.asarray(rt.trainer.params[names[k]])
                  for k in names}
    return dict(start=start, run=run, params=params)


def test_guarded_run_matches_jax(jax_run, tmp_path):
    net = _port_net()
    tmx.weights.load_reference_params(net, jax_run["start"])
    rt = _resilient(str(tmp_path / "ck"), _trainer(net), spike_factor=5.0,
                    loss_scaler=LossScaler(init_scale=256.0))
    for site, step in PLAN:
        fault.install(site, steps=[step], times=1)
    xs, ys = _data(STEPS)
    run = []
    for i in range(STEPS):
        loss, ok = rt.step(xs[i], ys[i])
        run.append((loss, ok, rt.scaler.loss_scale))
    want = jax_run["run"]
    assert [r[1] for r in run] == [r[1] for r in want] == \
        [True, True, False, True, False, True]
    assert [r[2] for r in run] == [r[2] for r in want]
    losses = np.array([r[0] for r in run])
    jlosses = np.array([r[0] for r in want])
    assert np.array_equal(np.isnan(losses), np.isnan(jlosses))
    fin = np.isfinite(jlosses)
    assert _err(losses[fin], jlosses[fin]) <= TOL
    params = rt.trainer.params
    for k, v in jax_run["params"].items():
        assert _err(params[k].numpy(), v) <= TOL, k
    # one replica: eager, one capture, then replays only
    assert (rt.trainer.eager_steps, rt.trainer.captures,
            rt.trainer.replays) == (1, 1, STEPS - 2)


# -- the guarded step ------------------------------------------------------

@pytest.mark.parametrize("replicas", [1, 2])
def test_bad_steps_leave_state_bit_for_bit(tmp_path, replicas):
    """A poisoned step leaves the parameters, the optimizer state and the
    running statistics as they were, on a replayed program (one replica)
    and uncaptured (two, BatchNorm statistics across them)."""
    xs, ys = _data(6)
    rt = _resilient(str(tmp_path / "ck"),
                    _trainer(_port_net(bn=True), n=replicas,
                             optimizer="sgd", lr=0.1), spike_factor=5.0)
    fault.install("grad_nan", steps=[3], times=1)
    fault.install("loss_spike", steps=[4], times=1)
    oks = []
    for i in range(6):
        before = _state(rt.trainer)
        _, ok = rt.step(xs[i], ys[i])
        oks.append(ok)
        after = _state(rt.trainer)
        assert _same(before, after) == (not ok), i
    assert oks == [True, True, True, False, False, True]
    t = rt.trainer
    if replicas == 1:
        assert (t.eager_steps, t.captures, t.replays) == (1, 1, 4)
    else:
        assert t.captures == 0 and t.eager_steps == 6
    assert rt.step_number == 6


def test_unpoisoned_guarded_step_is_the_plain_step():
    """With poison and loss scale 1 the guarded step is the sharded
    trainer's step, bit for bit (eager, captured and replayed)."""
    xs, ys = _data(4)
    plain = _trainer()
    guarded = _trainer()
    guard = [torch.tensor([1.0, float("inf"), 1.0])]
    for x, y in zip(xs, ys):
        a = plain.step(x, y)
        b, ok = guarded.step(x, y, guard=guard)
        assert bool(ok) and torch.equal(a, b)
    assert _same(_state(plain), _state(guarded))


def test_loss_scaler_backoff_on_bad_step(tmp_path):
    xs, ys = _data(3)
    rt = _resilient(str(tmp_path / "ck"),
                    loss_scaler=LossScaler(init_scale=256.0))
    fault.install("grad_nan", steps=[1], times=1)
    rt.step(xs[0], ys[0])
    assert rt.scaler.loss_scale == 256.0
    _, ok = rt.step(xs[1], ys[1])
    assert not ok and rt.scaler.loss_scale == 128.0


def test_rollback_after_consecutive_bad_steps(tmp_path):
    xs, ys = _data(8)
    rt = _resilient(str(tmp_path / "ck"), ckpt_interval=100,
                    rollback_after=2)
    rollbacks0 = events.get("resilience.rollback")
    rt.step(xs[0], ys[0])
    rt.step(xs[1], ys[1])
    fault.install("grad_nan", steps=[2], times=1)
    fault.install("grad_nan", steps=[3], times=1)
    _, ok = rt.step(xs[2], ys[2])
    assert not ok and rt.step_number == 3
    _, ok = rt.step(xs[3], ys[3])
    assert not ok
    assert events.get("resilience.rollback") == rollbacks0 + 1
    assert rt.step_number == 0 and rt.bad_steps == 0
    fresh = _resilient(str(tmp_path / "fresh"))
    for i in range(4):
        loss, ok = rt.step(xs[i], ys[i])
        assert ok and loss == fresh.step(xs[i], ys[i])[0]


def test_step_retries_transient_collective_failure(tmp_path):
    xs, ys = _data(2)
    rt = _resilient(str(tmp_path / "ck"))
    fault.install("collective", at_calls=[1], times=1)
    retries0 = events.get("resilience.retry")
    loss, ok = rt.step(xs[0], ys[0])
    assert ok and np.isfinite(loss)
    assert events.get("resilience.retry") == retries0 + 1


# -- preemption and resume ---------------------------------------------------

def test_preemption_resume_matches_uninterrupted(tmp_path):
    """A SIGTERM injected at step 5 through the real signal path: the
    resumed run's losses and parameters are the uninterrupted run's, bit
    for bit."""
    n = 10
    xs, ys = _data(n)
    rt_a = _resilient(str(tmp_path / "a"))
    losses_a = [rt_a.step(xs[i], ys[i])[0] for i in range(n)]
    params_a = rt_a.trainer.params
    dir_b = str(tmp_path / "b")
    rt_b = _resilient(dir_b, handle_sigterm=True)
    try:
        fault.install("preempt", steps=[5], times=1)
        preempted_at = None
        try:
            for i in range(n):
                rt_b.step(xs[i], ys[i])
        except fault.Preempted as e:
            preempted_at = e.step
        assert preempted_at == 6
        assert tpar.ResilientTrainer.was_preempted(dir_b)
    finally:
        rt_b.uninstall_sigterm()
    assert signal.getsignal(signal.SIGTERM) is not None
    rt_c = _resilient(dir_b)
    assert rt_c.resume()
    assert rt_c.step_number == 6
    assert not tpar.ResilientTrainer.was_preempted(dir_b)
    losses_c = [rt_c.step(xs[i], ys[i])[0] for i in range(6, n)]
    assert losses_c == losses_a[6:]
    for k, v in rt_c.trainer.params.items():
        assert torch.equal(v, params_a[k]), k


def test_sigterm_during_checkpoint_write_stays_atomic(tmp_path):
    """A SIGTERM during a checkpoint write: the write publishes whole,
    the preemption lands at the next step's end, and resume loads it."""
    ck = str(tmp_path / "ck")
    xs, ys = _data(6)
    rt = _resilient(ck, ckpt_interval=2, handle_sigterm=True)
    try:
        orig = rt.trainer.save_checkpoint
        fired = []

        def save_with_sigterm(path):
            if "step_00000002" in path and not fired:
                fired.append(1)
                os.kill(os.getpid(), signal.SIGTERM)
            return orig(path)
        rt.trainer.save_checkpoint = save_with_sigterm
        preempted_at = None
        try:
            for i in range(6):
                rt.step(xs[i], ys[i])
        except fault.Preempted as e:
            preempted_at = e.step
        assert preempted_at == 3
    finally:
        rt.uninstall_sigterm()
    names = sorted(os.listdir(ck))
    assert not any(n.startswith(".tmp_") for n in names), names
    assert "step_00000002" in names and "step_00000003" in names
    with open(os.path.join(ck, "LATEST")) as f:
        assert f.read().strip() == "step_00000003"
    assert tpar.ResilientTrainer.was_preempted(ck)
    rt2 = _resilient(ck)
    assert rt2.resume() and rt2.step_number == 3
    assert not tpar.ResilientTrainer.was_preempted(ck)


def test_death_mid_checkpoint_write_keeps_previous_good(tmp_path):
    ck = str(tmp_path / "ck")
    xs, ys = _data(6)
    rt = _resilient(ck, ckpt_interval=2, keep=2)
    for i in range(5):
        rt.step(xs[i], ys[i])
    orig = rt.trainer.save_checkpoint

    def dying_save(path):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "partial.bin"), "wb") as f:
            f.write(b"\x00" * 64)
        raise RuntimeError("process died mid-write")
    rt.trainer.save_checkpoint = dying_save
    with pytest.raises(RuntimeError, match="mid-write"):
        rt.checkpoint()
    rt.trainer.save_checkpoint = orig
    assert sorted(n for n in os.listdir(ck) if n.startswith("step_")) == \
        ["step_00000002", "step_00000004"]
    with open(os.path.join(ck, "LATEST")) as f:
        assert f.read().strip() == "step_00000004"
    rt2 = _resilient(ck)
    assert rt2.resume() and rt2.step_number == 4
    loss, ok = rt2.step(xs[4], ys[4])
    assert ok and np.isfinite(loss)


# -- checkpoints -------------------------------------------------------------

def test_keep_k_garbage_collection(tmp_path):
    xs, ys = _data(7)
    ck = str(tmp_path / "ck")
    rt = _resilient(ck, ckpt_interval=2, keep=2)
    for i in range(7):
        rt.step(xs[i], ys[i])
    assert sorted(d for d in os.listdir(ck) if d.startswith("step_")) == \
        ["step_00000004", "step_00000006"]
    assert not any(d.startswith(".tmp_") for d in os.listdir(ck))
    step = os.path.join(ck, "step_00000006")
    assert sorted(os.listdir(step)) == [
        "checkpoint.pt", integrity.MANIFEST, "resilience_meta.json"]
    assert integrity.verify_checkpoint(step)["verified"]


@pytest.mark.parametrize("damage", ["partial", "bitflip"])
def test_corrupt_checkpoint_falls_back_to_previous(tmp_path, damage):
    """The newest checkpoint emptied (a write that never finished) or one
    bit of it flipped (`ckpt.bitflip`): `verify_checkpoint` refuses the
    flipped one, and resume restores the previous."""
    xs, ys = _data(6)
    ck = str(tmp_path / "ck")
    rt = _resilient(ck, ckpt_interval=2, keep=3)
    if damage == "bitflip":
        fault.install("ckpt.bitflip", steps=[6], times=1)
    for i in range(6):
        rt.step(xs[i], ys[i])
    newest = os.path.join(ck, "step_00000006")
    if damage == "partial":
        shutil.rmtree(newest)
        os.makedirs(newest)
    else:
        with pytest.raises(integrity.CheckpointCorrupt) as e:
            integrity.verify_checkpoint(newest)
        assert "checkpoint.pt" in e.value.files
    fallback0 = events.get("resilience.restore_fallback")
    rt2 = _resilient(ck)
    assert rt2.resume()
    assert rt2.step_number == 4
    assert events.get("resilience.restore_fallback") == fallback0 + 1
    _, ok = rt2.step(xs[4], ys[4])
    assert ok


def test_resume_on_empty_dir_and_wrong_seed(tmp_path):
    rt = _resilient(str(tmp_path / "empty"))
    assert not rt.resume() and rt.step_number == 0
    xs, ys = _data(1)
    ck = str(tmp_path / "ck")
    rt = _resilient(ck)
    rt.step(xs[0], ys[0])
    rt.checkpoint()
    assert not _resilient(ck, seed=999).resume()
    assert _resilient(ck).resume()


def test_guarded_program_is_registered(tmp_path):
    from incubator_mxnet_tpu_torch.telemetry import costs
    xs, ys = _data(3)
    rt = _resilient(str(tmp_path / "ck"))
    for i in range(3):
        rt.step(xs[i], ys[i])
    rows = [r for r in costs.table() if r["label"] == "resilient.gstep"]
    assert rows and rows[-1]["kind"] == "train"
    assert rows[-1]["invocations"] >= 2
