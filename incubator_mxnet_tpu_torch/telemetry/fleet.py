"""Fleet telemetry of the PyTorch port (counterpart of
incubator_mxnet_tpu/telemetry/fleet.py): per-replica snapshots through
the kvstore and straggler detection from them.

- `FleetReporter`, one replica's side: every
  ``MXNET_FLEET_PUBLISH_STEPS`` steps it pushes a fixed-schema float64
  vector (`FIELDS`: step id, step/dispatch/collective/data-wait µs, the
  memory watermark, skipped steps...) to ``__mesh__/telemetry/<rid>``,
  the channel of the elastic heartbeats.  The vectors are host arrays.
- `FleetView`, rank 0's side: pulls every replica's vector into one
  ``{rid: {field: value}}`` view, which every black-box dump carries
  as its `fleet` block (`flightrec.set_fleet_provider`).
- `StragglerDetector`: a rolling per-replica median over
  ``MXNET_STRAGGLER_WINDOW`` published step times against the other
  replicas' median + ``MXNET_STRAGGLER_SIGMA`` robust sigmas
  (1.4826·MAD, floored at +50 %); a replica over the line for two
  rounds in a row is a straggler (``mesh.straggler``, a ring event),
  which `ElasticTrainer` reports as "slow (observed)".

`FleetTelemetry` bundles the three for the supervisor.  The JAX
snapshot's aot hit/miss/stale fields stay 0: the port has no AOT cache.
"""
from __future__ import annotations

import statistics
import time
import weakref
from collections import deque

import numpy as _np

from ..monitor import events
from . import flightrec as _bb
from . import spans as _tele

__all__ = ["FIELDS", "FleetReporter", "FleetView", "StragglerDetector",
           "FleetTelemetry", "telemetry_key", "robust_threshold"]


def robust_threshold(values, sigma, rel_floor=0.5):
    """``median + max(sigma·1.4826·MAD, rel_floor·median)`` over
    `values` — the outlier line the straggler detector judges replicas
    against, factored out so the SLO anomaly rules (telemetry/slo.py)
    can point the SAME math at history baselines instead of at other
    replicas.  The MAD term adapts to a naturally-noisy population;
    the relative floor keeps a uniform one (MAD ≈ 0) from flagging
    micro-skew."""
    vals = [float(v) for v in values]
    med = statistics.median(vals)
    mad = statistics.median(abs(x - med) for x in vals)
    return med + max(float(sigma) * 1.4826 * mad,
                     float(rel_floor) * med)

#: the fixed wire schema: one float64 per field, in this order.  A
#: fixed schema (not pickles) keeps the payload a dozen numbers, makes
#: it language/version-agnostic, and lets the kvstore treat it as any
#: other array key.
FIELDS = ("step", "step_us", "dispatch_us", "collective_us",
          "data_wait_us", "hbm_peak_bytes", "aot_hit", "aot_miss",
          "aot_stale", "steps_skipped", "feed_stall_us",
          "decode_batches")

_KEY = "__mesh__/telemetry/%d"


def telemetry_key(rid: int) -> str:
    """The kvstore key replica `rid` publishes under."""
    return _KEY % int(rid)


def _peak_bytes():
    """The largest allocator peak over this process's cards (0 without
    one)."""
    import torch
    if not torch.cuda.is_available():
        return 0
    return max(torch.cuda.max_memory_allocated(i)
               for i in range(torch.cuda.device_count()))


def _counter_sample():
    """The process-level counter fields of a snapshot (cumulative
    totals; per-step rates are the view's job)."""
    return {
        "hbm_peak_bytes": _peak_bytes(),
        "aot_hit": events.get("aot.hit"),
        "aot_miss": events.get("aot.miss"),
        "aot_stale": events.get("aot.stale"),
        "steps_skipped": events.get("train.steps_skipped"),
        "feed_stall_us": events.get("feed.stall_us"),
        "decode_batches": events.get("io.decode.batches"),
    }


class FleetReporter:
    """Publishes ONE replica's compact snapshot vector through the
    kvstore (`telemetry_key(rid)`).  The push is span-wrapped
    (``kv.telemetry`` tagged with generation + rank) so the publish
    itself is visible on the cross-process timeline."""

    def __init__(self, kv, rid: int):
        self.kv = kv
        self.rid = int(rid)
        self._init = False

    def publish(self, sample: dict) -> None:
        """Push one snapshot (`FIELDS` subset; missing fields are 0)."""
        from ..ndarray.ndarray import array
        vec = _np.asarray([float(sample.get(f, 0) or 0)
                           for f in FIELDS], _np.float64)
        key = telemetry_key(self.rid)
        arr = array(vec, ctx="cpu", dtype="float64")
        if not self._init:
            self.kv.init(key, arr)
            self._init = True
        with _tele.span("kv.telemetry", rank=self.rid,
                        gen=int(getattr(self.kv, "generation", 0))):
            self.kv.push(key, arr)


class FleetView:
    """Rank 0's merged per-replica view: pull every published vector
    and decode it back into ``{rid: {field: value}}``."""

    def __init__(self, kv):
        self.kv = kv
        self._last = {}

    def refresh(self, rids) -> dict:
        """Pull the listed replicas' vectors (a replica that never
        published simply contributes no row).  Returns and retains the
        merged view."""
        from ..base import MXNetError
        from ..ndarray.ndarray import array
        out = {}
        for rid in rids:
            buf = array(_np.zeros(len(FIELDS)), ctx="cpu", dtype="float64")
            try:
                with _tele.span("kv.telemetry_pull", rank=int(rid),
                                gen=int(getattr(self.kv, "generation",
                                                0))):
                    self.kv.pull(telemetry_key(int(rid)), out=buf)
            except MXNetError:
                continue            # never published under this store
            vals = buf.asnumpy()
            row = dict(zip(FIELDS, (float(v) for v in vals)))
            if row.get("step", 0) < 0:
                continue            # initialized but never pushed
            out[int(rid)] = row
        self._last = out
        return out

    @property
    def last(self) -> dict:
        return self._last


class StragglerDetector:
    """Rolling per-replica step-time skew detector.

    Per replica: the median over its last `window` published step
    times (robust to one blip).  Across replicas: each candidate is
    judged against the LEAVE-ONE-OUT baseline — the median of the
    OTHER replicas' medians, and the MAD around that.  A replica is a
    straggler when its median exceeds

        med(others) + max(sigma * 1.4826 * MAD(others),
                          0.5 * med(others))

    Self-exclusion matters on small fleets: with 2-4 replicas an
    outlier included in its own baseline inflates both the median and
    the MAD until nothing can ever cross the line (a 2-replica MAD is
    half the outlier's own excess).  The MAD term adapts to a
    naturally-noisy fleet; the +50% floor keeps a uniform fleet
    (MAD ≈ 0) from flagging scheduler jitter; and a replica must be
    over the line for ``CONFIRM_ROUNDS`` CONSECUTIVE rounds before it
    is flagged — a genuinely slow replica stays over for its whole
    degradation, while a one-round median crossing (a compile or GC
    blip transiting the window) resets and never fires.  Transitions
    (not steady states) are counted and ring-recorded:
    ``mesh.straggler`` / ``mesh.straggler_recovered``, labeled and
    named by replica."""

    #: minimum relative excess over the fleet median (a 1.0x-uniform
    #: fleet has MAD ~ 0; without a floor any micro-skew would flag)
    REL_FLOOR = 0.5
    #: consecutive over-the-line rounds before a replica is flagged
    #: (debounce: one transient window crossing must not page anyone)
    CONFIRM_ROUNDS = 2

    def __init__(self, window=None, sigma=None):
        from .. import config as _cfg
        # floor 2: the median needs >= 2 samples, and the clamp lives
        # HERE so the observe() staleness check (`dq.maxlen !=
        # self.window`) compares against the effective value — a
        # window knob of 1 must not rebuild every deque on every call
        self.window = max(2, int(window if window is not None
                                 else _cfg.get(
                                     "MXNET_STRAGGLER_WINDOW")))
        self.sigma = float(sigma if sigma is not None
                           else _cfg.get("MXNET_STRAGGLER_SIGMA"))
        self._win = {}              # rid -> deque of recent step_us
        self._over = {}             # rid -> consecutive rounds over
        self.flagged = set()        # rids currently flagged

    def observe(self, step: int, per_replica_us: dict) -> list:
        """Feed one round of published per-replica step times; returns
        the rids CURRENTLY judged stragglers (transition events fire
        inside).  Needs >= 2 replicas with >= 2 samples each before it
        judges — one sample is noise, one replica has no fleet."""
        for rid, us in per_replica_us.items():
            dq = self._win.get(rid)
            if dq is None or dq.maxlen != self.window:
                dq = self._win[rid] = deque(dq or (),
                                            maxlen=self.window)
            dq.append(float(us))
        stats = {rid: statistics.median(dq)
                 for rid, dq in self._win.items() if len(dq) >= 2}
        if len(stats) < 2:
            return sorted(self.flagged)
        now, baseline = set(), {}
        for rid, v in stats.items():
            others = [x for r, x in stats.items() if r != rid]
            med = statistics.median(others)
            thresh = robust_threshold(others, self.sigma,
                                      rel_floor=self.REL_FLOOR)
            baseline[rid] = (med, thresh)
            if v > thresh:
                self._over[rid] = self._over.get(rid, 0) + 1
                # already-flagged replicas stay flagged while over;
                # new ones must confirm for CONFIRM_ROUNDS rounds
                if rid in self.flagged or \
                        self._over[rid] >= self.CONFIRM_ROUNDS:
                    now.add(rid)
            else:
                self._over.pop(rid, None)
        for rid in sorted(now - self.flagged):
            med, thresh = baseline[rid]
            events.incr("mesh.straggler")
            events.incr("mesh.straggler",
                        labels={"replica": str(rid)})
            _bb.record_mesh("straggler", replica=int(rid),
                            step=int(step),
                            step_us=int(stats[rid]),
                            fleet_median_us=int(med),
                            threshold_us=int(thresh))
        for rid in sorted(self.flagged - now):
            events.incr("mesh.straggler_recovered")
            _bb.record_mesh("straggler_recovered", replica=int(rid),
                            step=int(step),
                            step_us=int(stats.get(rid, 0)))
        self.flagged = now
        return sorted(now)

    def forget(self, rid: int) -> None:
        """Drop a replica's window (it left the mesh)."""
        self._win.pop(int(rid), None)
        self._over.pop(int(rid), None)
        self.flagged.discard(int(rid))


class FleetTelemetry:
    """The supervisor-side bundle: reporters for the replicas this
    process speaks for, the rank-0 merged view, the straggler
    detector, and the dump/export surfaces.

    ``update(step, per_replica_step_us)`` is the one call a supervisor
    makes per step: publish (at the MXNET_FLEET_PUBLISH_STEPS
    cadence), refresh the view, feed the replica-labeled
    ``fleet.step_us`` summary rings (the Prometheus children), run the
    detector, and return the straggler rids.  Publishing happens after
    the step's async dispatch has returned — the device is already
    busy; the host-side cost is a dozen-float kvstore push per
    replica."""

    def __init__(self, kv, n_replicas: int, window=None, sigma=None,
                 publish_steps=None, rank0: bool = True):
        from .. import config as _cfg
        self.kv = kv
        self.n = int(n_replicas)
        self.publish_steps = int(
            publish_steps if publish_steps is not None
            else _cfg.get("MXNET_FLEET_PUBLISH_STEPS"))
        self.reporters = {}         # rid -> FleetReporter (lazy)
        self.view = FleetView(kv) if rank0 else None
        self.detector = StragglerDetector(window=window, sigma=sigma)
        self._last_counts = {}      # publish-delta baselines
        self._last_step = None
        # the newest dump should answer "which replica" even after
        # this object is gone mid-crash — but a dead supervisor must
        # not pin itself through the module hook: weakref provider
        ref = weakref.ref(self)

        def _provider():
            ft = ref()
            return None if ft is None else ft.block()
        _bb.set_fleet_provider(_provider)

    # -- publish -------------------------------------------------------
    def _reporter(self, rid: int) -> FleetReporter:
        rep = self.reporters.get(int(rid))
        if rep is None:
            rep = self.reporters[int(rid)] = FleetReporter(self.kv, rid)
        return rep

    def _step_deltas(self, step: int) -> dict:
        """Per-step averages of the process-level train.* wall
        counters since the last publish (the StepTelemetry deltas the
        snapshot carries)."""
        names = ("train.dispatch_us", "train.collective_us",
                 "train.data_wait_us")
        now = {n: events.get(n) for n in names}
        steps = 1 if self._last_step is None \
            else max(1, step - self._last_step)
        out = {n.split(".", 1)[1]:
               (now[n] - self._last_counts.get(n, 0)) / steps
               for n in names}
        self._last_counts = now
        self._last_step = step
        return out

    def update(self, step: int, per_replica_step_us: dict) -> list:
        """One supervised step's fleet round (see class docstring).
        `per_replica_step_us`: {rid: measured step wall in µs} for the
        replicas this process speaks for.  Returns the straggler rids
        (empty when publishing is disabled or off-cadence)."""
        if self.publish_steps <= 0 or not per_replica_step_us:
            return []
        if step % self.publish_steps != 0:
            return sorted(self.detector.flagged)
        t0 = time.perf_counter()
        base = _counter_sample()
        base.update(self._step_deltas(step))
        for rid, us in per_replica_step_us.items():
            sample = dict(base, step=step, step_us=float(us))
            self._reporter(rid).publish(sample)
        if self.view is None:
            events.observe_time("fleet.publish_us",
                                time.perf_counter() - t0)
            return []
        merged = self.view.refresh(sorted(per_replica_step_us))
        per_us = {}
        for rid, row in merged.items():
            us = row.get("step_us", 0.0)
            per_us[rid] = us
            # the replica-labeled Prometheus children: summary rings
            # keyed {replica=}, rendered by MetricsExporter for free
            events.observe("fleet.step_us", us,
                           labels={"replica": str(rid)})
        out = self.detector.observe(step, per_us)
        # the rank-0 merge is also the durable per-replica record
        #: one history row per replica at publish cadence —
        # already off the step critical path, and a no-op when
        # MXNET_HISTORY_DIR is unset
        try:
            from . import history as _hist
            _hist.record_fleet(merged, step=step, stragglers=out)
        except Exception:           # noqa: BLE001 — durability is
            pass                    # best-effort, never a step cost
        # the fleet layer meters ITSELF: publish+refresh+detect wall
        # per round, so "what does fleet telemetry cost" is a counter
        # you read, not a claim you trust
        events.observe_time("fleet.publish_us",
                            time.perf_counter() - t0)
        return out

    # -- surfaces ------------------------------------------------------
    def block(self) -> dict:
        """The `fleet` block for dumps / bench JSON / teletop: the
        merged per-replica view plus the detector's verdicts."""
        merged = self.view.last if self.view is not None else {}
        return {
            "ts": time.time(),
            "replicas": {str(rid): {k: (int(v) if float(v).is_integer()
                                        else round(float(v), 1))
                                    for k, v in row.items()}
                         for rid, row in sorted(merged.items())},
            "stragglers": sorted(int(r) for r in
                                 self.detector.flagged),
            "straggler_window": self.detector.window,
            "straggler_sigma": self.detector.sigma,
        }
