"""Elastic data-parallel training of the PyTorch port (counterpart of
incubator_mxnet_tpu/parallel/elastic.py): survive replica loss and
re-admission mid-run.

``ElasticTrainer`` is a supervisor around the ``ShardedTrainer`` /
``ResilientTrainer`` pair that walks the state machine

    healthy → draining → shrunk → (re-admitting → healthy)

1. **Detection**: every active replica posts a per-step heartbeat to the
   kvstore, tagged with the store's membership generation
   (`ReplicaHealth`); the poll marks a replica SLOW after
   ``MXNET_ELASTIC_STALE_STEPS`` missed beats and DOWN after
   ``MXNET_ELASTIC_DOWN_STEPS``.  The fault sites ``mesh.replica_down`` /
   ``mesh.replica_slow`` only suppress the victim's beats: detection
   always runs the real staleness path.  Fleet telemetry
   (`telemetry.fleet`) publishes each replica's step time through the
   same store, and its straggler detector reports an alive but slow
   replica as "slow (observed)".
2. **Shrink**: drain the step in flight (synchronize the replicas'
   devices), leave a ``mesh.shrink`` black-box dump naming the lost
   replica, advance the store's generation (a stale rank cannot rejoin:
   `kvstore.StaleMembership`), release the old trainer, form the
   survivors' mesh in their order (`surviving_mesh`), rebuild the
   trainer through the caller's factory and resume from the last atomic
   checkpoint.  Parameters and optimizer state come from the checkpoint,
   the per-step random stream is a pure function of (seed, step) and the
   survivors keep their order, so the shrunk run equals a
   from-checkpoint run on the survivors bit for bit.
3. **Re-admission**: at the next epoch boundary the supervisor probes
   the down replicas (a tensor made and synchronized on the device); a
   recovered one is re-admitted by checkpointing at the current step,
   advancing the generation and rebuilding on the grown mesh.

Heartbeats, telemetry vectors and audit digests are host float64
arrays in the store.  Every transition is counted on `monitor.events`
(``mesh.*``) and recorded in the flight recorder (kind ``mesh``).
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import numpy as _np
import torch

from .. import fault
from .. import integrity
from ..monitor import events
from ..telemetry import flightrec as _bb
from ..telemetry import spans as _tele
from ..telemetry.fleet import FleetTelemetry
from .mesh import default_dp_mesh, mesh_devices, surviving_mesh
from .resilience import ResilientTrainer

__all__ = ["ElasticTrainer", "ReplicaHealth"]

log = logging.getLogger(__name__)

_HB_KEY = "__mesh__/hb/%d"


def _host_array(values):
    from ..ndarray.ndarray import array
    return array(_np.asarray(values, _np.float64), ctx="cpu",
                 dtype="float64")


class ReplicaHealth:
    """Heartbeat/health layer on the kvstore.

    Each active replica posts a per-step heartbeat — a kvstore key
    ``__mesh__/hb/<rid>`` holding ``[step, generation]`` — and the
    supervisor polls staleness: ``step - last_beat >= stale_steps`` →
    SLOW (observed, counted), ``>= down_steps`` → DOWN (the mesh
    shrinks).  Beats tagged with an old membership generation are
    REJECTED (``mesh.stale_rank_beat``): a rank the mesh re-formed
    without cannot heartbeat its way back in — re-admission is the
    supervisor's explicit, epoch-boundary decision.

    Failure *injection* is deliberately indirect: the fault sites
    ``mesh.replica_down`` / ``mesh.replica_slow`` suppress the victim's
    beats (the victim is the highest active rid — deterministic), and
    detection then runs the same staleness arithmetic a really-dead
    replica would trip.
    """

    def __init__(self, kv, n_replicas: int, stale_steps=None,
                 down_steps=None):
        from .. import config
        self.kv = kv
        self.n = int(n_replicas)
        self.stale = int(stale_steps if stale_steps is not None
                         else config.get("MXNET_ELASTIC_STALE_STEPS"))
        self.down = int(down_steps if down_steps is not None
                        else config.get("MXNET_ELASTIC_DOWN_STEPS"))
        self.generation = int(getattr(kv, "generation", 0))
        self._suppressed = set()        # rids whose beats stopped (down)
        self._slow_until = {}           # rid -> step beats resume
        self._state = {}                # rid -> last reported verdict
        self._observed_slow = set()     # rids the fleet telemetry
        #                                 (straggler detector) flagged
        for rid in range(self.n):
            kv.init(_HB_KEY % rid, _host_array([-1.0, 0.0]))

    # -- beats ----------------------------------------------------------
    def set_generation(self, generation: int):
        self.generation = int(generation)

    def suppress(self, rid: int):
        """Stop a replica's beats (it died).  Cleared by `restore`."""
        self._suppressed.add(int(rid))

    def restore(self, rid: int):
        """The replica came back (re-admission): beats resume."""
        self._suppressed.discard(int(rid))
        self._slow_until.pop(int(rid), None)
        self._state.pop(int(rid), None)
        self._observed_slow.discard(int(rid))

    # -- fleet-telemetry feed ------------------------------------------
    def note_observed_slow(self, rid: int, step: int,
                           source: str = "straggler") -> None:
        """Feed the "slow (observed)" state from TELEMETRY rather than
        heartbeat staleness: the straggler detector saw this replica's
        published step times skew while its beats are still fresh —
        the alive-but-slow case staleness alone can never see.  The
        verdict is sticky across polls until `clear_observed_slow`
        (otherwise every fresh beat would flip it healthy and the next
        detector round would re-count the same degradation)."""
        rid = int(rid)
        self._observed_slow.add(rid)
        if self._state.get(rid) != "slow":
            self._state[rid] = "slow"
            events.incr("mesh.replica_slow")
            _bb.record_mesh("replica_slow", replica=rid,
                            step=int(step), source=source)

    def clear_observed_slow(self, rid: int) -> None:
        """The detector reports the replica back under the line; the
        next poll may return it to "healthy" (no event — recovery to
        steady state is not a transition worth a counter)."""
        self._observed_slow.discard(int(rid))

    def beat(self, rid: int, step: int, generation=None) -> bool:
        """Post one heartbeat for `rid` (tagged with the CURRENT
        generation unless overridden — the stale-rank test path).
        Returns False when the beat was suppressed or rejected."""
        gen = self.generation if generation is None else int(generation)
        if gen != int(getattr(self.kv, "generation", self.generation)):
            # a rank from a previous mesh generation is heartbeating:
            # reject — it must re-enter through explicit re-admission
            events.incr("mesh.stale_rank_beat")
            _bb.record_mesh("stale_rank_beat", replica=int(rid),
                            gen=gen, step=int(step))
            return False
        if rid in self._suppressed:
            return False
        if step < self._slow_until.get(rid, -1):
            return False
        # the beat is a kvstore push tagged (replica, step, gen): on
        # the merged cross-process timeline a replica's heartbeats are
        # attributable spans, not anonymous store traffic
        with _tele.span("kv.heartbeat", replica=int(rid),
                        step=int(step), gen=gen):
            self.kv.push(_HB_KEY % rid, _host_array([float(step),
                                                     float(gen)]))
        return True

    def beat_all(self, step: int, active, inject: bool = True) -> None:
        """One heartbeat round for every active replica.  The fault
        sites fire HERE (this is where a real replica's beat would
        originate): ``mesh.replica_down`` permanently suppresses the
        victim, ``mesh.replica_slow`` suppresses it for one staleness
        window.  ``inject=False`` skips the fault sites: the elastic
        supervisor passes it for REPLAYED steps (a post-shrink
        checkpoint rewind revisits step numbers at or below the fault
        step — re-evaluating ``site@K`` there would kill a fresh
        victim on every replay pass and cascade the mesh down to
        ``min_replicas``; one planned failure must mean one failure)."""
        active = list(active)
        if inject and active and \
                fault.should_fire("mesh.replica_down", step):
            victim = max(active)
            self.suppress(victim)
            log.warning("fault: replica %d stops heartbeating at step "
                        "%d", victim, step)
        cands = [r for r in active if r not in self._suppressed]
        if inject and cands and \
                fault.should_fire("mesh.replica_slow", step):
            victim = max(cands)
            # miss exactly `stale` beats: enough for the poll to
            # report SLOW (age == stale), one short of DOWN — slow is
            # an observation, never a shrink (age never reaches
            # down_steps > stale_steps)
            self._slow_until[victim] = step + self.stale
        for rid in active:
            self.beat(rid, step)

    # -- verdicts -------------------------------------------------------
    def _last_beat(self, rid: int):
        out = _host_array([0.0, 0.0])
        self.kv.pull(_HB_KEY % rid, out=out)
        step, gen = (float(x) for x in out.asnumpy())
        if int(gen) != self.generation:
            return None             # never beaten under this generation
        return step

    def poll(self, step: int, active) -> dict:
        """{rid: "healthy" | "slow" | "down"} for the active set, from
        heartbeat staleness alone.  Transitions (not steady states) are
        counted and ring-recorded, so the forensic timeline shows WHEN
        each replica degraded, once."""
        out = {}
        for rid in active:
            last = self._last_beat(rid)
            age = self.down if last is None or last < 0 \
                else step - last
            if age >= self.down:
                verdict = "down"
            elif age >= self.stale:
                verdict = "slow"
            else:
                verdict = "healthy"
            if verdict == "healthy" and rid in self._observed_slow:
                # the straggler detector condemned this replica from
                # its published step times; fresh beats don't acquit
                # it — only the detector clearing does
                verdict = "slow"
            if self._state.get(rid) != verdict:
                self._state[rid] = verdict
                if verdict == "down":
                    events.incr("mesh.replica_down")
                    _bb.record_mesh("replica_down", replica=int(rid),
                                    step=int(step), missed=int(age))
                elif verdict == "slow":
                    events.incr("mesh.replica_slow")
                    _bb.record_mesh("replica_slow", replica=int(rid),
                                    step=int(step), missed=int(age))
            out[rid] = verdict
        return out


class ElasticTrainer:
    """Supervisor that keeps a data-parallel run alive across replica
    loss and re-admission (module docstring has the state machine).

    build_trainer: ``(mesh, lr_factor) -> ShardedTrainer`` — the
        caller's factory.  It is re-invoked on every mesh transition
        with the new mesh and ``lr_factor = n_active / n_total`` (the
        linear LR-scaling rule: the global batch shrank with the mesh,
        so the LR follows).  For bit-deterministic shrink semantics the
        factory must be pure in its inputs.
    ckpt_dir: the atomic-checkpoint directory (ResilientTrainer's) —
        the ONLY state channel across mesh transitions.
    devices: replica devices (default: every card,
        ``mesh_devices(default_dp_mesh())``, which raises without one);
        replica id = index into this list.
    steps_per_epoch: epoch boundary cadence — re-admission happens at
        ``step % steps_per_epoch == 0`` (None: never re-admit).
    kv: kvstore carrying heartbeats + membership generation (default: a
        fresh ``local`` store).
    min_replicas / stale_steps / down_steps / ckpt_interval / keep /
    seed / handle_sigterm: see the MXNET_ELASTIC_* / MXNET_CKPT_*
        knobs and ResilientTrainer.
    audit_interval: cross-replica SDC audit cadence
        (MXNET_SDC_AUDIT_STEPS; 0 = off).  Every N steps the
        supervisor hashes replicated state per replica — digests
        round-trip through THIS trainer's kvstore, the heartbeat
        channel — and a divergent replica is EVICTED through the
        shrink path (black-box dump naming replica + leaf first); at
        min_replicas it falls back to checkpoint rollback.  An
        SDC-evicted replica is eligible for re-admission at the next
        epoch boundary like any other down replica: the rebuild
        restores one consistent checkpoint onto every member, so a
        transient flip does not permanently cost a replica (persistent
        flippers get re-evicted by the next audit round).

    Drive it with ``step(data_fn)`` where ``data_fn(step, n_replicas)
    -> (batch, labels)`` is a pure function — after a shrink the step
    counter REWINDS to the restored checkpoint and the lost steps are
    replayed through the same data_fn, which is what makes the
    continuation equal a from-checkpoint (N-1)-way run bit for bit.
    """

    #: factor by which an injected mesh.replica_slow victim's PUBLISHED
    #: step wall is inflated during its suppression window — the
    #: single-controller stand-in for what a genuinely slow replica's
    #: fleet-telemetry snapshot would report (its steps really take
    #: longer); detection then runs the production skew arithmetic
    SLOW_INJECT_FACTOR = 4.0

    def __init__(self, build_trainer: Callable, ckpt_dir: str,
                 devices=None, steps_per_epoch: Optional[int] = None,
                 min_replicas: Optional[int] = None, seed: int = 0,
                 ckpt_interval: Optional[int] = None,
                 keep: Optional[int] = None, kv=None,
                 stale_steps=None, down_steps=None,
                 handle_sigterm: bool = True,
                 audit_interval: Optional[int] = None,
                 fleet: Optional[bool] = None):
        from .. import config
        from ..kvstore import create as kv_create
        self._build = build_trainer
        self.devices = list(devices if devices is not None
                            else mesh_devices(default_dp_mesh()))
        self.n_total = len(self.devices)
        self.active = list(range(self.n_total))
        self.down = {}              # rid -> step it was lost at
        self.min_replicas = int(
            min_replicas if min_replicas is not None
            else config.get("MXNET_ELASTIC_MIN_REPLICAS"))
        self.steps_per_epoch = (int(steps_per_epoch)
                                if steps_per_epoch else None)
        self.seed = int(seed)
        self.ckpt_dir = ckpt_dir
        self.ckpt_interval = ckpt_interval
        self.keep = keep
        self.audit_interval = int(
            audit_interval if audit_interval is not None
            else config.get("MXNET_SDC_AUDIT_STEPS"))
        self._sigterm = handle_sigterm
        self.kv = kv if kv is not None else kv_create("local")
        self.health = ReplicaHealth(self.kv, self.n_total,
                                    stale_steps=stale_steps,
                                    down_steps=down_steps)
        # fleet telemetry: per-replica snapshots through
        # THIS trainer's kvstore + the straggler detector feeding the
        # health layer's slow-(observed) state.  Default on; fleet=False
        # (or MXNET_FLEET_PUBLISH_STEPS=0) disables
        if fleet is None:
            fleet = int(config.get("MXNET_FLEET_PUBLISH_STEPS")) > 0
        self.fleet = FleetTelemetry(self.kv, self.n_total) \
            if fleet else None
        self.state = "healthy"
        self.transitions = []       # [{kind, step, wall_s, ...}]
        self.last_blackbox = None   # newest mesh-shrink dump path
        self._step_hwm = -1         # highest step already driven once
        self.trainer = None
        self.resilient = None
        self._rebuild(resume=True)

    # -- mesh (re)construction -----------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self.active)

    @property
    def step_number(self) -> int:
        return self.trainer._n_step

    def _rebuild(self, resume: bool) -> None:
        """(Re)build the trainer + resilient wrapper on the CURRENT
        active set and restore the newest atomic checkpoint."""
        mesh = surviving_mesh(
            self.devices,
            lost=[i for i in range(self.n_total)
                  if i not in self.active])
        lr_factor = self.n_replicas / float(self.n_total)
        preempted = False
        if self.resilient is not None:
            # a SIGTERM that landed during the transition must survive
            # the rebuild: the flag lives on the wrapper being discarded
            preempted = self.resilient._preempted
            self.resilient.uninstall_sigterm()
        if self.trainer is not None:
            self.trainer.release()
        self.trainer = self._build(mesh, lr_factor)
        # audit_interval=0: the SUPERVISOR owns the SDC audit (its
        # response is eviction, not the wrapper's rollback)
        self.resilient = ResilientTrainer(
            self.trainer, ckpt_dir=self.ckpt_dir,
            ckpt_interval=self.ckpt_interval, keep=self.keep,
            seed=self.seed, handle_sigterm=self._sigterm,
            audit_interval=0)
        if resume:
            self.resilient.resume()
        if preempted:
            self.resilient.request_preemption()
        # the first step on a fresh trainer pays the compile: its wall
        # is not a step time, and publishing it would pollute every
        # replica's straggler window with a seconds-scale outlier
        self._fleet_skip_next = True

    def _drain(self) -> None:
        """Drain in-flight work: block until the device state (params +
        optimizer state) of the current generation is materialized, so
        the checkpoint/teardown below never races a dispatched step."""
        for d in {torch.device(d) for d in self.devices}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- transitions ----------------------------------------------------
    def _shrink(self, lost, stepno: int,
                reason: str = "replica_down") -> None:
        survivors = [r for r in self.active if r not in lost]
        if len(survivors) < self.min_replicas:
            raise RuntimeError(
                "elastic mesh cannot shrink below min_replicas=%d "
                "(lost %s at step %d, %d survivors)"
                % (self.min_replicas, sorted(lost), stepno,
                   len(survivors)))
        self.state = "draining"
        t0 = time.perf_counter()
        self._drain()
        # forensics BEFORE teardown: the dying replica's trail — the
        # replica_down marker from poll() (or the integrity.sdc marker
        # from the audit), this shrink marker, and the step/counter
        # timeline — is still in the ring; the dump names the lost
        # replica, its device, and why it is being removed
        _bb.record_mesh(
            "shrink", step=int(stepno), lost=sorted(int(r) for r in lost),
            devices=[str(self.devices[r]) for r in sorted(lost)],
            survivors=len(survivors), reason=reason)
        self.last_blackbox = _bb.crash_dump("mesh.shrink")
        # membership epoch: every credential of the old mesh dies here
        self.kv.advance_generation("mesh-shrink")
        self.health.set_generation(self.kv.generation)
        for rid in lost:
            self.down[rid] = stepno
            if self.fleet is not None:
                # a removed replica's stale window must not skew the
                # survivors' straggler baseline
                self.fleet.detector.forget(rid)
        self.active = survivors
        old_step = self.trainer._n_step
        self._rebuild(resume=True)
        steps_lost = old_step - self.trainer._n_step
        wall = time.perf_counter() - t0
        events.incr("mesh.shrinks")
        events.incr("mesh.steps_lost", max(0, steps_lost))
        self.transitions.append(
            {"kind": "shrink", "step": int(stepno),
             "reason": reason,
             "lost": sorted(int(r) for r in lost),
             "replicas": self.n_replicas,
             "steps_lost": int(steps_lost),
             "resumed_step": int(self.trainer._n_step),
             "wall_s": round(wall, 4)})
        self.state = "shrunk"
        log.warning("mesh shrank %d->%d at step %d (lost %s); resumed "
                    "from checkpoint step %d (%d step(s) to replay) in "
                    "%.2fs", len(survivors) + len(lost), len(survivors),
                    stepno, sorted(lost), self.trainer._n_step,
                    steps_lost, wall)

    def _probe_recovered(self, rid: int) -> bool:
        """Whether a down replica can rejoin: its device answers a
        trivial computation.  A replica whose beats were suppressed
        answers, which is the point: re-admission is an epoch-boundary
        decision, the probe only keeps out hardware still gone."""
        try:
            dev = torch.device(self.devices[rid])
            dev = torch.device("cpu") if dev.type == "cpu" else dev
            torch.zeros(1, device=dev).add_(1).cpu()
            return True
        except Exception:           # noqa: BLE001 — still dead
            return False

    def _maybe_readmit(self, stepno: int) -> None:
        if not self.down:
            return
        recovered = sorted(r for r in list(self.down)
                           if self._probe_recovered(r))
        if not recovered:
            return
        self.state = "re-admitting"
        t0 = time.perf_counter()
        self._drain()
        # the checkpoint IS the handoff: grow resumes at the SAME step
        self.resilient.checkpoint()
        self.kv.advance_generation("mesh-grow")
        self.health.set_generation(self.kv.generation)
        for rid in recovered:
            self.down.pop(rid, None)
            self.health.restore(rid)
        self.active = sorted(self.active + recovered)
        self._rebuild(resume=True)
        # the re-admitted replicas immediately heartbeat under the new
        # generation so the next poll sees them healthy, not stale
        for rid in recovered:
            self.health.beat(rid, stepno)
        wall = time.perf_counter() - t0
        events.incr("mesh.grows")
        events.incr("mesh.replica_readmitted", len(recovered))
        _bb.record_mesh("grow", step=int(stepno),
                        readmitted=[int(r) for r in recovered],
                        replicas=self.n_replicas)
        self.transitions.append(
            {"kind": "grow", "step": int(stepno),
             "readmitted": [int(r) for r in recovered],
             "replicas": self.n_replicas,
             "wall_s": round(wall, 4)})
        # only a FULL recovery is healthy: with replicas still down
        # (partial re-admission) the mesh stays "shrunk" so callers/
        # monitoring reading `state` see the degradation
        self.state = "healthy" if not self.down else "shrunk"
        log.info("mesh grew to %d replicas at step %d (re-admitted %s) "
                 "in %.2fs%s", self.n_replicas, stepno, recovered, wall,
                 "" if not self.down
                 else " — still down: %s" % sorted(self.down))

    # -- the supervised step -------------------------------------------
    def step(self, data_fn: Callable):
        """One elastic train step.  ``data_fn(step, n_replicas) ->
        (batch, labels)`` must be pure (replay after a shrink calls it
        again for the rewound steps).  Returns ``(loss, ok)`` from the
        guarded resilient step; the step it belongs to is
        ``self.step_number - 1`` after the call (a shrink REWINDS the
        counter to the restored checkpoint first)."""
        stepno = self.trainer._n_step
        if self.steps_per_epoch and stepno % self.steps_per_epoch == 0:
            self._maybe_readmit(stepno)
        # fault sites fire on FIRST-visit steps only: a post-shrink
        # rewind replays step numbers the plan already fired on, and
        # re-injecting there would fell a new victim per replay pass
        # (cascade to min_replicas from one planned failure)
        first_visit = stepno > self._step_hwm
        self._step_hwm = max(self._step_hwm, stepno)
        self.health.beat_all(stepno, self.active, inject=first_visit)
        verdict = self.health.poll(stepno, self.active)
        lost = [r for r in self.active if verdict.get(r) == "down"]
        if lost:
            self._shrink(lost, stepno)
            stepno = self.trainer._n_step
        if self.audit_interval > 0 and stepno > 0 and \
                stepno % self.audit_interval == 0 and \
                self.n_replicas > 1:
            # cross-replica SDC audit through the kvstore; a divergent
            # replica is evicted via the shrink path (rollback when
            # eviction would undershoot min_replicas)
            self._audit(stepno, inject=first_visit)
            stepno = self.trainer._n_step
        batch, labels = data_fn(stepno, self.n_replicas)
        t0 = time.perf_counter()
        loss, ok = self.resilient.step(batch, labels)
        if self.fleet is not None:
            self._fleet_round(stepno, time.perf_counter() - t0)
        return loss, ok

    def _fleet_round(self, stepno: int, wall_s: float) -> None:
        """Publish this step's per-replica telemetry and act on the
        straggler verdicts.  Runs AFTER the step's dispatch returned
        (the device is already busy; the host-side cost is a
        dozen-float kvstore push per replica, at the
        MXNET_FLEET_PUBLISH_STEPS cadence).

        Single-controller stand-in: every replica's wall is the
        measured step wall, except a `mesh.replica_slow` victim — its
        published wall is inflated by SLOW_INJECT_FACTOR for its
        suppression window, which is exactly what a genuinely slow
        replica's own telemetry would report.  Detection and the
        slow-(observed) feed then run the production path."""
        if getattr(self, "_fleet_skip_next", False):
            # compile step (fresh build/rebuild): not a step time
            self._fleet_skip_next = False
            return
        per = {}
        for rid in self.active:
            us = wall_s * 1e6
            if stepno < self.health._slow_until.get(rid, -1):
                us *= self.SLOW_INJECT_FACTOR
            per[rid] = us
        try:
            stragglers = self.fleet.update(stepno, per)
        except Exception:           # noqa: BLE001 — observability must
            return                  # never take the training loop down
        for rid in stragglers:
            if rid in self.active:
                self.health.note_observed_slow(rid, stepno)
        for rid in sorted(self.health._observed_slow):
            if rid not in stragglers:
                self.health.clear_observed_slow(rid)

    def _audit(self, stepno: int, inject: bool = True) -> None:
        rid_of = dict(enumerate(self.active))
        report = integrity.audit_replicas(
            self.trainer, step=stepno, rid_of=rid_of, kv=self.kv,
            inject=inject)
        if report.ok:
            return
        victims = [r for r in report.victims() if r in self.active]
        log.error("cross-replica SDC at step %d: replica(s) %s "
                  "diverge on %s", stepno, victims,
                  report.leaves()[:4])
        if not victims:
            return
        if len(self.active) - len(victims) >= self.min_replicas:
            events.incr("mesh.sdc_evicted", len(victims))
            # eviction: the divergent replica leaves through the same
            # drain → dump → generation++ → rebuild path a dead one
            # does; the restore re-places ONE consistent checkpoint on
            # every survivor, so the divergence cannot outlive the
            # transition
            self._shrink(victims, stepno, reason="sdc")
        else:
            # at min_replicas eviction is not an option: dump, then
            # roll every replica back to the last verifiable
            # checkpoint (the ResilientTrainer SDC response)
            _bb.crash_dump("sdc")
            if not self.resilient.resume():
                raise integrity.SDCDetected(victims, report.leaves(),
                                            stepno)
            events.incr("integrity.sdc_rollback")
            log.warning("SDC response at min_replicas: rolled back to "
                        "step %d", self.trainer._n_step)

    def run(self, data_fn: Callable, n_steps: int) -> dict:
        """Drive `step` until `n_steps` steps are COMPLETE (shrink
        replay included), returning ``{step: loss}`` for the surviving
        timeline — replayed steps overwrite their pre-shrink values,
        so the dict is the run as the final mesh history produced it."""
        losses = {}
        while self.trainer._n_step < n_steps:
            loss, _ok = self.step(data_fn)
            losses[self.trainer._n_step - 1] = float(loss)
        return losses
