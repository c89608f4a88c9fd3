"""Fault-tolerant training of the PyTorch port (counterpart of
incubator_mxnet_tpu/parallel/resilience.py).

`ResilientTrainer` wraps a `ShardedTrainer` and keeps a run alive
through the three failure families that kill long jobs:

1. **Numeric blow-ups**: each step is a guarded step
   (`ShardedTrainer.step(guard=...)`): loss finiteness, gradient finiteness
   and a loss-spike threshold are computed on the device, and the
   update of the parameters, the optimizer state and BatchNorm's running
   statistics is committed by `torch.where(ok, new, old)`, so a bad step
   leaves all three bit for bit as they were.  Fault injection and the
   threshold and loss scale ride in as slots of a device vector written
   before each step, so on one replica a poisoned step replays the one
   captured program and captures nothing new.  Bad steps drive a
   `LossScaler` back-off; after N in a row the trainer rolls back to the
   last checkpoint.
2. **Preemption**: a SIGTERM (real, or injected through the real signal
   path) sets a flag; the step in flight finishes, an atomic checkpoint
   and a ``PREEMPTED`` marker are written, and `fault.Preempted` is
   raised.  `resume()` restores the parameters, the optimizer state and
   the step counter, and the per-step random stream is a pure function
   of (seed, step), so the resumed run is bit for bit an uninterrupted
   one on the same replicas.
3. **Transient failures**: the step's dispatch and the checkpoint
   writes retry with jittered exponential backoff (`retry_transient`).

A checkpoint is written into ``.tmp_step_<n>`` by
`ShardedTrainer.save_checkpoint` (``checkpoint.pt``), with
``resilience_meta.json`` (step, seed, loss EMA, loss scale) and the
integrity manifest (`integrity.write_manifest`, per-file and per-leaf
CRCs) inside it, then published with one `os.replace` as
``step_<n>``; the ``LATEST`` pointer is replaced the same way, and the
last K are kept.  `resume()` verifies before it restores
(``MXNET_CKPT_VERIFY``) and walks back through keep-K to the newest
checkpoint that verifies; it refuses one written under another seed.

The host reads `ok` and the loss once a step: the guard's decisions
(skip accounting, the spike EMA, the scaler, rollback) are host control
flow, as in the JAX wrapper.  The guarded program is registered in
`telemetry.costs` as ``resilient.gstep``.  The JAX wrapper's autotune
probe of the batch size is left out: `compile/autotune.py` is not
ported.  Every recovery is counted on `monitor.events`
(``resilience.*``).
"""
from __future__ import annotations

import json
import logging
import os
import random
import shutil
import signal
import time
from typing import Optional

import numpy as _np
import torch

from .. import config
from .. import fault
from .. import integrity
from .. import random as _rnd
from ..contrib.amp.loss_scaler import LossScaler
from ..monitor import events
from ..telemetry import costs as _costs
from ..telemetry import flightrec as _bb
from ..telemetry import spans as _tele
from ..telemetry.stepstats import StepTelemetry

__all__ = ["ResilientTrainer", "retry_transient"]

_LATEST = "LATEST"
_PREEMPT_MARKER = "PREEMPTED"
_META = "resilience_meta.json"
_STEP_PREFIX = "step_"
_TMP_PREFIX = ".tmp_"

log = logging.getLogger(__name__)


def retry_transient(fn, retries=None, backoff=None, what="operation",
                    retryable=(fault.TransientFault, OSError),
                    non_retryable=(), event="resilience.retry",
                    jitter=True):
    """Call `fn()`, retrying `retries` times with JITTERED exponential
    backoff on transient failures: the window doubles per attempt and
    each sleep is drawn uniformly from [window/2, window], so a fleet
    of workers tripped by the same storage/collective blip does not
    retry in lockstep (the thundering herd that turns one blip into
    three).  `backoff` seeds the window; when None it comes from
    MXNET_RETRY_BACKOFF_MS (milliseconds, when > 0) else
    MXNET_RETRY_BACKOFF (seconds).  `jitter=False` sleeps the full
    window deterministically (tests).  Each retry increments `event`
    on monitor.events (callers pick their own counter so concurrent
    retries in different subsystems don't pollute each other).

    `non_retryable` carves permanent failures out of the retryable
    families: an exception matching it is re-raised immediately even
    when it also matches `retryable`."""
    if retries is None:
        retries = int(config.get("MXNET_RETRY_MAX"))
    if backoff is None:
        ms = float(config.get("MXNET_RETRY_BACKOFF_MS"))
        backoff = ms / 1e3 if ms > 0 else \
            float(config.get("MXNET_RETRY_BACKOFF"))
    attempt = 0
    while True:
        try:
            return fn()
        except retryable as e:
            if non_retryable and isinstance(e, non_retryable):
                raise               # permanent: fail fast, loudly
            attempt += 1
            if attempt > retries:
                raise
            events.incr(event)
            delay = backoff if not jitter else \
                random.uniform(backoff / 2.0, backoff)
            log.warning("%s failed (%s); retry %d/%d in %.3fs",
                        what, e, attempt, retries, delay)
            time.sleep(delay)
            backoff *= 2.0


def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s random stream: a pure function of
    (seed, step), so a checkpoint needs only the step counter for a
    bit-exact resume (the port's own stream, not jax's threefry)."""
    return int(_np.random.SeedSequence([int(seed), int(step)])
               .generate_state(1, _np.uint64)[0] >> 1)


def _history(name, **fields):
    try:
        from ..telemetry import history as _hist
        _hist.note_event(name, **fields)
        _hist.tick()
    except Exception:               # noqa: BLE001 — durability is best
        pass                        # effort, never a failed step


class ResilientTrainer:
    """Resilient wrapper around a `ShardedTrainer` (module doc).

    trainer:        the ShardedTrainer whose state this wrapper owns
    ckpt_dir:       checkpoint directory (created; None disables
                    checkpointing, rollback and preemption saves)
    ckpt_interval:  steps between periodic checkpoints
                    (default MXNET_CKPT_INTERVAL; <= 0: none)
    keep:           checkpoints retained (default MXNET_CKPT_KEEP)
    spike_factor:   skip the update when loss > factor x its running
                    mean (default MXNET_LOSS_SPIKE_FACTOR; 0 = off)
    rollback_after: consecutive bad steps before rolling back to the
                    last checkpoint (default MXNET_BAD_STEP_ROLLBACK;
                    0 = skip only)
    seed:           base seed of the per-step random stream
                    (`step_seed`), which each guarded step seeds the
                    port's generators of its replicas' devices from
    loss_scaler:    a `contrib.amp.LossScaler` (default scale 1, or the
                    amp= default below)
    amp:            the mixed-precision compute dtype, or None for
                    MXNET_AMP_DTYPE (empty: off).  'bfloat16' turns the
                    cast policy on (`contrib.amp.init`); 'float16' also
                    makes the default scaler a dynamic LossScaler(2**16)
                    whose overflow verdict is this trainer's guard
    handle_sigterm: install a SIGTERM handler that turns preemption into
                    checkpoint-and-exit (main thread only;
                    `uninstall_sigterm` restores the previous one)
    audit_interval: cross-replica audit cadence in steps (default
                    MXNET_SDC_AUDIT_STEPS; 0 = off); a divergent replica
                    triggers a black-box dump and a rollback
    """

    def __init__(self, trainer, ckpt_dir: Optional[str] = None,
                 ckpt_interval: Optional[int] = None,
                 keep: Optional[int] = None,
                 spike_factor: Optional[float] = None,
                 rollback_after: Optional[int] = None,
                 seed: int = 0, ema_decay: float = 0.9,
                 loss_scaler: Optional[LossScaler] = None,
                 handle_sigterm: bool = True,
                 audit_interval: Optional[int] = None,
                 amp: Optional[str] = None):
        from ..contrib import amp as _amp_mod
        self.trainer = trainer
        self.amp = _amp_mod.normalize_dtype(
            amp if amp is not None else config.get("MXNET_AMP_DTYPE"))
        if self.amp:
            _amp_mod.init(self.amp)
            if loss_scaler is None:
                loss_scaler = LossScaler(
                    init_scale=2.0 ** 16 if self.amp == "float16" else 1.0)
            events.incr("amp.trainer_init")
            _bb.record("amp", "init", target=self.amp, trainer="resilient")
        self.ckpt_dir = os.path.abspath(ckpt_dir) if ckpt_dir else None
        self.ckpt_interval = int(ckpt_interval if ckpt_interval is not None
                                 else config.get("MXNET_CKPT_INTERVAL"))
        self.keep = int(keep if keep is not None
                        else config.get("MXNET_CKPT_KEEP"))
        self.spike_factor = float(
            spike_factor if spike_factor is not None
            else config.get("MXNET_LOSS_SPIKE_FACTOR"))
        self.rollback_after = int(
            rollback_after if rollback_after is not None
            else config.get("MXNET_BAD_STEP_ROLLBACK"))
        self.audit_interval = int(
            audit_interval if audit_interval is not None
            else config.get("MXNET_SDC_AUDIT_STEPS"))
        self.seed = int(seed)
        self.ema_decay = float(ema_decay)
        self.loss_ema = None               # running mean of good losses
        self.scaler = loss_scaler or LossScaler(init_scale=1.0)
        self.bad_steps = 0                 # consecutive skipped steps
        self._tele = None                  # StepTelemetry, made lazily
        self._trace_count = 0              # this wrapper's programs
        self._cost_key = None
        self._guard = [torch.tensor([1.0, float("inf"), 1.0],
                                    dtype=torch.float32, device=trainer._dev(r))
                       for r in range(len(trainer._local))]
        self._preempted = False
        self._prev_sigterm = None
        # a process group's rank 0 writes the checkpoints
        self._writer = trainer.writer
        if self.ckpt_dir and self._writer:
            os.makedirs(self.ckpt_dir, exist_ok=True)
        self._have_ckpt = bool(self._list_checkpoints())
        if handle_sigterm:
            self._install_sigterm()
        _bb.install_crash_hooks()

    # -- signal / preemption -------------------------------------------
    def _install_sigterm(self):
        def _on_sigterm(signum, frame):
            # flag only: the step in flight finishes, then the loop
            # checkpoints from a consistent state
            self._preempted = True
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            # not the main thread: `request_preemption()` still works
            self._prev_sigterm = None

    def uninstall_sigterm(self):
        """Restore the SIGTERM handler that was there before."""
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._prev_sigterm = None

    def request_preemption(self):
        """The programmatic SIGTERM (tests, cluster agents)."""
        self._preempted = True

    @property
    def step_number(self) -> int:
        return self.trainer._n_step

    # -- the guarded step ----------------------------------------------
    def _on_capture(self, program, seconds):
        """A new guarded program: counted (``train.traces``) and given
        its row in the cost registry."""
        events.incr("train.traces")
        self._trace_count += 1
        t = self.trainer
        self._cost_key = _costs.note_program(
            "train", "resilient.gstep", sig=str(self._trace_count),
            param_bytes=sum(t.replica_param_bytes()),
            pool_bytes=getattr(program, "pool_growth", None),
            capture_s=seconds)

    def _seed_step(self, stepno):
        s = step_seed(self.seed, stepno)
        for dev in {self.trainer._dev(r)
                    for r in range(len(self.trainer._local))}:
            _rnd.generator(dev).manual_seed(s)

    def step(self, batch, labels):
        """One guarded train step.  Returns (loss, ok): `loss` a float
        (NaN on a poisoned step), `ok` whether the update was applied.
        Raises `fault.Preempted` after a preemption was handled (state
        checkpointed and resumable)."""
        t = self.trainer
        stepno = t._n_step
        if self.ckpt_dir and not self._have_ckpt:
            # the rollback target before the first update
            self.checkpoint()
        if fault.should_fire("preempt", stepno):
            # an injected preemption goes through the real signal path
            signal.raise_signal(signal.SIGTERM)
        tele = self._tele
        if tele is None and _tele.enabled():
            tele = self._tele = StepTelemetry(own_traces=self._trace_count)

        poison = 1.0
        if fault.should_fire("grad_nan", stepno):
            poison = float("nan")
        elif fault.should_fire("loss_spike", stepno):
            poison = 1e4
        spike_thresh = float("inf")
        if self.spike_factor > 0 and self.loss_ema is not None:
            spike_thresh = self.spike_factor * self.loss_ema

        _tele.set_global_step(stepno)
        step_span = _tele.span("train.step")
        step_span.start()
        t0 = time.perf_counter()
        try:
            vec = torch.tensor([poison, spike_thresh,
                                self.scaler.loss_scale],
                               dtype=torch.float32)
            with torch.no_grad():
                for g in self._guard:
                    g.copy_(vec)
            self._seed_step(stepno)
            t1 = time.perf_counter()

            def dispatch():
                # a transient collective failure shows at dispatch time
                fault.maybe_raise("collective", stepno)
                return t.step(batch, labels, guard=self._guard,
                              on_capture=self._on_capture)
            loss_t, ok_t = retry_transient(
                dispatch, what="train step %d" % stepno,
                retryable=(fault.TransientFault,))
            if self._cost_key is None:
                self._on_capture(None, None)
            _costs.invoke(self._cost_key)
            # the one host read of the step: the guard's verdict
            loss, ok = torch.stack([loss_t.float().reshape(()),
                                    ok_t.float().reshape(())]).tolist()
            ok = bool(ok)
        except Exception as e:
            from ..telemetry import memwatch as _mw
            _mw.guard_oom("train.step", e)
            raise
        finally:
            step_span.stop()
        t2 = time.perf_counter()
        _bb.record("step", "resilient", step=stepno,
                   loss=(loss if loss == loss else None), ok=ok,
                   us=int((t2 - t0) * 1e6),
                   **({"amp": self.amp} if self.amp else {}))
        if self.amp:
            events.observe_time("train.step_us", t2 - t0,
                                labels={"amp": self.amp})
        if tele is not None:
            tele.record_step(loss=loss, ok=ok, wall_s=t2 - t0,
                             data_wait_s=t1 - t0, compute_s=t2 - t1,
                             traces=self._trace_count)
        self.scaler.update(overflow=not ok)
        if ok:
            self.bad_steps = 0
            self.loss_ema = loss if self.loss_ema is None else \
                self.ema_decay * self.loss_ema + \
                (1.0 - self.ema_decay) * loss
        else:
            self.bad_steps += 1
            events.incr("resilience.step_skipped")
            log.warning("step %d skipped (non-finite or spiking loss); "
                        "%d consecutive bad steps", stepno, self.bad_steps)
            if self.ckpt_dir and self.rollback_after and \
                    self.bad_steps >= self.rollback_after:
                self.rollback()
        if self.audit_interval > 0 and \
                t._n_step % self.audit_interval == 0 and \
                t.data_parallel_size > 1:
            self.audit(t._n_step)
        if self._preempted:
            self._handle_preemption()
        elif self.ckpt_dir and self.ckpt_interval > 0 and \
                t._n_step % self.ckpt_interval == 0:
            self.checkpoint()
        return loss, ok

    # -- cross-replica audit -------------------------------------------
    def audit(self, step: Optional[int] = None, inject: bool = True):
        """One cross-replica audit round (`integrity.audit_replicas`); a
        divergent replica leaves a black-box dump and rolls every
        replica back to the newest checkpoint that verifies (without
        one, `integrity.SDCDetected`).  Returns the `AuditReport`."""
        step = int(step if step is not None else self.trainer._n_step)
        report = integrity.audit_replicas(self.trainer, step=step,
                                          inject=inject)
        if report.ok:
            return report
        log.error("cross-replica SDC at step %d: replica(s) %s diverge "
                  "on %s", step, report.victims(), report.leaves()[:4])
        _bb.crash_dump("sdc")
        if self.ckpt_dir and self._have_ckpt:
            scale = self.scaler.loss_scale
            if self.resume():
                self.scaler.loss_scale = scale
                self.bad_steps = 0
                events.incr("integrity.sdc_rollback")
                _bb.record("integrity", "sdc_rollback", step=step,
                           restored=int(self.trainer._n_step))
                return report
        raise integrity.SDCDetected(report.victims(), report.leaves(), step)

    # -- checkpoints ---------------------------------------------------
    def _ckpt_name(self, step):
        return "%s%08d" % (_STEP_PREFIX, step)

    def _list_checkpoints(self):
        """[(step, dirname)] ascending, of published checkpoints only
        (temp directories are invisible by construction)."""
        if not self.ckpt_dir or not os.path.isdir(self.ckpt_dir):
            return []
        out = []
        for name in os.listdir(self.ckpt_dir):
            if name.startswith(_STEP_PREFIX):
                try:
                    out.append((int(name[len(_STEP_PREFIX):]), name))
                except ValueError:
                    continue
        return sorted(out)

    def checkpoint(self):
        """Atomic checkpoint of the parameters, optimizer state, step and
        run metadata (module doc).  Returns the published directory."""
        if not self.ckpt_dir:
            raise ValueError("ResilientTrainer built without ckpt_dir")
        t = self.trainer
        step = t._n_step
        final = os.path.join(self.ckpt_dir, self._ckpt_name(step))
        if os.path.isdir(final):
            # this step's checkpoint exists (typically right after a
            # rollback): its state is this state, so point LATEST at it,
            # unless it fails its manifest, in which case it is rewritten
            bad = None
            if config.get("MXNET_CKPT_VERIFY"):
                try:
                    integrity.verify_checkpoint(final, name_leaves=False)
                except integrity.CheckpointCorrupt as e:
                    bad = e
            if bad is None:
                if self._writer:
                    self._publish_latest(self._ckpt_name(step))
                self._have_ckpt = True
                return final
            log.warning("existing checkpoint %s is corrupt (%s); "
                        "rewriting it", final, bad)
            if self._writer:
                shutil.rmtree(final, ignore_errors=True)
        tmp = os.path.join(self.ckpt_dir, _TMP_PREFIX + self._ckpt_name(step))

        def write():
            fault.maybe_raise("checkpoint.save", step,
                              exc_type=fault.InjectedIOError)
            if not self._writer:
                t.save_checkpoint(tmp)
                return
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            tree = t.save_checkpoint(tmp)
            meta = {"step": step, "seed": self.seed,
                    "loss_ema": self.loss_ema,
                    "loss_scale": self.scaler.loss_scale,
                    "scaler_unskipped": self.scaler._unskipped,
                    "bad_steps": self.bad_steps,
                    "mesh_devices": t.data_parallel_size}
            with open(os.path.join(tmp, _META), "w") as f:
                json.dump(meta, f)
            # the manifest last, inside the temp directory: covered by
            # the same atomic rename as the data it guards
            integrity.write_manifest(tmp, leaves=integrity.named_leaves(
                tree["params"], tree["opt_state"]))
            os.replace(tmp, final)

        t_ck = time.perf_counter()
        with _tele.span("train.checkpoint"):
            retry_transient(write, what="checkpoint step %d" % step)
            if self._writer:
                self._publish_latest(self._ckpt_name(step))
        if self._writer and fault.should_fire("ckpt.bitflip", step):
            self._inject_ckpt_bitflip(final, step)
        self._have_ckpt = True
        events.incr("resilience.checkpoint_written")
        _bb.record("ckpt", "written", step=step,
                   us=int((time.perf_counter() - t_ck) * 1e6))
        _history("ckpt", step=int(step))
        if _tele.enabled():
            if self._tele is None:
                self._tele = StepTelemetry(own_traces=self._trace_count)
            self._tele.record_checkpoint(time.perf_counter() - t_ck)
        if self._writer:
            self._gc()
        return final

    def _inject_ckpt_bitflip(self, final, step):
        """The ckpt.bitflip site: one bit of the largest file of the
        published checkpoint flips."""
        cands = []
        for root, _dirs, files in os.walk(final):
            for f in files:
                if f == integrity.MANIFEST:
                    continue
                fp = os.path.join(root, f)
                cands.append((os.path.getsize(fp), fp))
        if not cands:
            return
        _size, target = max(cands)
        pos = fault.flip_file_bit(target)
        log.warning("fault: flipped bit at byte %d of %s (checkpoint step "
                    "%d)", pos, target, step)
        _bb.record("fault", "ckpt.bitflip", step=int(step),
                   file=os.path.relpath(target, final))

    def _publish_latest(self, name):
        latest_tmp = os.path.join(self.ckpt_dir, _LATEST + ".tmp")
        with open(latest_tmp, "w") as f:
            f.write(name)
        os.replace(latest_tmp, os.path.join(self.ckpt_dir, _LATEST))

    def _gc(self):
        if self.keep <= 0:
            return
        for _, name in self._list_checkpoints()[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, name),
                          ignore_errors=True)

    def rollback(self):
        """Roll back to the last good checkpoint after `rollback_after`
        bad steps in a row: parameters, optimizer state and step counter
        rewind; the backed-off loss scale is kept."""
        scale = self.scaler.loss_scale
        if not self.resume():
            raise RuntimeError("rollback requested but no usable "
                               "checkpoint in %s" % self.ckpt_dir)
        self.scaler.loss_scale = scale
        self.bad_steps = 0
        events.incr("resilience.rollback")
        _bb.record("rollback", "bad_steps", step=self.trainer._n_step)
        _history("rollback", step=int(self.trainer._n_step))
        _bb.crash_dump("rollback")
        log.warning("rolled back to step %d after repeated bad steps",
                    self.trainer._n_step)

    def _handle_preemption(self):
        self._preempted = False
        step = self.trainer._n_step
        _bb.record("preempt", "sigterm", step=step, ckpt=bool(self.ckpt_dir))
        if self.ckpt_dir:
            self.checkpoint()
            if self._writer:
                marker_tmp = os.path.join(self.ckpt_dir,
                                          _PREEMPT_MARKER + ".tmp")
                with open(marker_tmp, "w") as f:
                    json.dump({"step": step}, f)
                os.replace(marker_tmp,
                           os.path.join(self.ckpt_dir, _PREEMPT_MARKER))
        events.incr("resilience.preemption")
        _history("preemption", step=int(step))
        _bb.crash_dump("preemption")
        log.warning("preemption handled at step %d; checkpoint saved", step)
        raise fault.Preempted(step, self.ckpt_dir)

    @staticmethod
    def was_preempted(ckpt_dir) -> bool:
        return os.path.exists(os.path.join(ckpt_dir, _PREEMPT_MARKER))

    # -- restore -------------------------------------------------------
    def _restore_from(self, name) -> bool:
        path = os.path.join(self.ckpt_dir, name)
        if config.get("MXNET_CKPT_VERIFY"):
            # verify before restoring: a corrupt checkpoint raises
            # CheckpointCorrupt instead of loading flipped bits
            integrity.verify_checkpoint(path)
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        if int(meta.get("seed", self.seed)) != self.seed:
            raise ValueError(
                "checkpoint %s was written with seed %s but this trainer "
                "uses seed %d — resume would not be deterministic"
                % (name, meta.get("seed"), self.seed))
        self.trainer.load_checkpoint(path)
        if int(meta["step"]) != self.trainer._n_step:
            raise ValueError(
                "checkpoint %s metadata step %s != restored step %d"
                % (name, meta["step"], self.trainer._n_step))
        here = self.trainer.data_parallel_size
        wrote = meta.get("mesh_devices")
        if wrote is not None and int(wrote) != here:
            events.incr("resilience.mesh_resize_restore")
            log.info("checkpoint %s written on %s replicas, restored onto "
                     "%d", name, wrote, here)
        self.loss_ema = meta.get("loss_ema")
        self.scaler.loss_scale = float(meta.get("loss_scale", 1.0))
        self.scaler._unskipped = int(meta.get("scaler_unskipped", 0))
        self.bad_steps = int(meta.get("bad_steps", 0))
        return True

    def resume(self) -> bool:
        """Restore the newest checkpoint that verifies, walking back
        through keep-K past corrupt or partial ones (a LATEST naming a
        missing directory is counted and skipped).  True when one was
        restored (any PREEMPTED marker is cleared), False for a fresh
        start.  A restore past a corrupt checkpoint leaves a
        ``ckpt.salvage`` black-box dump."""
        if not self.ckpt_dir:
            return False
        candidates = [name for _, name in reversed(self._list_checkpoints())]
        latest_path = os.path.join(self.ckpt_dir, _LATEST)
        if os.path.exists(latest_path):
            with open(latest_path) as f:
                latest = f.read().strip()
            if latest in candidates:
                candidates.remove(latest)
                candidates.insert(0, latest)
            elif latest:
                events.incr("resilience.latest_dangling")
                _bb.record("integrity", "latest_dangling", latest=latest)
                log.warning("LATEST names %s which does not exist in %s; "
                            "falling back through keep-K", latest,
                            self.ckpt_dir)
        trail, corrupt_seen = [], False
        for name in candidates:
            try:
                self._restore_from(name)
            except integrity.CheckpointCorrupt as e:
                corrupt_seen = True
                trail.append((name, "corrupt: %s" %
                              (e.leaves or sorted(e.files))))
                events.incr("resilience.restore_fallback")
                log.error("checkpoint %s failed integrity verification "
                          "(%s); falling back to the previous one", name, e)
                continue
            except (OSError, ValueError, KeyError, RuntimeError) as e:
                trail.append((name, str(e)[:120]))
                events.incr("resilience.restore_fallback")
                log.warning("checkpoint %s unusable (%s); falling back to "
                            "the previous one", name, e)
                continue
            marker = os.path.join(self.ckpt_dir, _PREEMPT_MARKER)
            if self._writer and os.path.exists(marker):
                os.remove(marker)
            self._have_ckpt = True
            events.incr("resilience.restored")
            if corrupt_seen:
                events.incr("integrity.ckpt_salvaged")
                _bb.record("integrity", "ckpt_salvaged", restored=name,
                           step=int(self.trainer._n_step),
                           skipped=[n for n, _ in trail])
                _bb.crash_dump("ckpt.salvage")
                log.warning("salvaged: restored %s at step %d after "
                            "skipping %s", name, self.trainer._n_step,
                            ["%s (%s)" % x for x in trail])
            log.info("resumed from %s at step %d", name,
                     self.trainer._n_step)
            return True
        if corrupt_seen:
            _bb.crash_dump("ckpt.salvage_failed")
        return False
