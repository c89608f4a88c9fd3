"""Declarative SLO / alert rules over the telemetry ledger of the
PyTorch port (counterpart of incubator_mxnet_tpu/telemetry/slo.py).

Rules are evaluated each exporter tick (`evaluate()`) against live
snapshots of `monitor.events` and, for anomaly rules, the on-disk
history baselines.  A FIRING rule is a typed, multi-surface event:

- ``slo.fired`` / ``slo.cleared`` counters, labeled ``{rule=}``;
- a flight-recorder ring event (kind ``slo``) naming the rule;
- the ``mxnet_alert_active{rule="..."}`` Prometheus gauge (1 while
  firing, 0 while clear; `MetricsExporter` renders every rule);
- a proactive black-box dump, reason ``slo:<rule>`` (throttled per
  reason by the flight recorder);
- a durable ``slo`` history row (telemetry/history.py);
- the registered action hooks (`register_action`).

Rule kinds: `ThresholdRule` (a live counter or percentile against a
static bound), `BurnRateRule` (multi-window error-budget burn over
cumulative counters: fires when a FAST and a SLOW window both burn at
>= 1x, clears when the fast window recovers), `AnomalyRule` (the live
tail against a robust history baseline, ``median + max(sigma x 1.4826 x
MAD, floor x median)``), `CostDriftRule` and `MemDriftRule` (the
memwatch attribution join, ledger against allocator).

**Default rules** derive from the serving knobs:
`default_serving_rules` (per lane, a shed burn rule whose budget
follows the lane-quota ladder, and a p99-vs-deadline threshold rule per
lane with an observed deadline), `default_generation_rules` (the same
over ``gen.*``, with a TTFT p99 rule) and `default_memwatch_rules`.

Waiting for later slices: the control-plane watchdog rules (with
``serving/controlplane.py``), and the autotuner whose decisions
`CostDriftRule` re-litigates (``compile/autotune.py``): until it is
ported a `CostDriftRule` gives no verdict.

Nothing here runs on a request path: the periodic exporter calls
`evaluate()` at tick cadence.
"""
from __future__ import annotations

import threading
import time
from collections import deque

import statistics

from .. import config as _cfg
from ..monitor import events
from . import flightrec as _bb

__all__ = ["Rule", "ThresholdRule", "BurnRateRule", "AnomalyRule",
           "CostDriftRule", "MemDriftRule",
           "register_rule", "unregister_rule", "clear_rules", "rules",
           "active_alerts", "evaluate", "block", "register_action",
           "default_serving_rules", "install_default_serving_rules",
           "default_generation_rules",
           "install_default_generation_rules",
           "default_memwatch_rules", "install_memwatch_rules"]


def robust_threshold(values, sigma, rel_floor=0.5):
    """``median + max(sigma·1.4826·MAD, rel_floor·median)`` over
    `values` (the JAX package's `fleet.robust_threshold`, of which the
    port keeps this copy): the MAD term adapts to a noisy population,
    the relative floor keeps a uniform one (MAD ≈ 0) from flagging
    micro-skew."""
    vals = [float(v) for v in values]
    med = statistics.median(vals)
    mad = statistics.median(abs(x - med) for x in vals)
    return med + max(float(sigma) * 1.4826 * mad,
                     float(rel_floor) * med)


# -- metric readers ----------------------------------------------------
def counter_value(name, labels=None) -> float:
    """Cumulative counter value; with ``labels`` the SUM over every
    labelset carrying at least those pairs (``serve.shed{lane=low}``
    sums across its per-reason splits)."""
    if not labels:
        return float(events.get(name))
    want = {str(k): str(v) for k, v in labels.items()}
    total = 0.0
    for row in events.labeled_snapshot().get(name, ()):
        have = row["labels"]
        if all(have.get(k) == v for k, v in want.items()):
            total += row["value"]
    return total


def percentile_value(name, p="p99", labels=None):
    """The live ring's percentile for a series (labeled: the FIRST
    labelset carrying at least the given pairs).  None when nothing
    was observed."""
    pcts = (50, 90, 99)
    if not labels:
        d = events.percentiles(name, pcts)
        return d.get(p) if d else None
    want = {str(k): str(v) for k, v in labels.items()}
    for row in events.labeled_percentiles(name, pcts):
        have = row["labels"]
        if all(have.get(k) == v for k, v in want.items()):
            return row.get(p)
    return None


class Rule:
    """Base: a named predicate over the ledger.  Subclasses implement
    ``check(now) -> (firing, info)`` where ``firing`` may be None
    (not judgeable yet — no samples, cold windows); `evaluate()` owns
    the alert lifecycle around it."""

    kind = "rule"

    def __init__(self, name, description=""):
        self.name = str(name)
        self.description = str(description)

    def check(self, now):           # pragma: no cover — abstract
        raise NotImplementedError

    def describe(self) -> dict:
        return {"rule": self.name, "kind": self.kind,
                "description": self.description}


class ThresholdRule(Rule):
    """Static bound on a live counter or percentile.

    metric: counter/series name.  With ``pct`` ("p50"/"p90"/"p99")
    the value is the live ring's percentile, else the cumulative
    counter.  ``op``: "<=" means the SLO is ``value <= bound`` (the
    rule FIRES on violation); ">=" the reverse (e.g. a liveness
    floor)."""

    kind = "threshold"

    def __init__(self, name, metric, bound, pct=None, labels=None,
                 op="<=", description=""):
        super().__init__(name, description)
        self.metric = str(metric)
        self.bound = float(bound)
        self.pct = pct
        self.labels = dict(labels) if labels else None
        if op not in ("<=", ">="):
            raise ValueError("op must be '<=' or '>=', got %r" % (op,))
        self.op = op

    def check(self, now):
        if self.pct:
            v = percentile_value(self.metric, self.pct,
                                 labels=self.labels)
            if v is None:
                return None, {}
        else:
            v = counter_value(self.metric, labels=self.labels)
        bad = v > self.bound if self.op == "<=" else v < self.bound
        return bool(bad), {"value": float(v), "bound": self.bound,
                           "op": self.op, "metric": self.metric,
                           "pct": self.pct, "labels": self.labels}


class BurnRateRule(Rule):
    """Multi-window error-budget burn over cumulative counters.

    bad:    counter name (or list of names) counting SLO violations —
            summed, labeled reads sum label-subset matches
    total:  counter name (or list) for the DENOMINATOR — pass
            ``["serve.requests", "serve.shed"]`` when the bad events
            are not included in the good counter
    budget: the allowed bad/total ratio (the error budget)
    fast_s / slow_s: the two windows; the rule fires when the burn
            rate ``(bad/total)/budget`` is >= 1 over BOTH, clears
            when the fast window drops back under 1.

    A window without a sample old enough is measured from the oldest
    retained sample (standard cold-start behavior: a fresh process
    under immediate overload should page, not wait an hour)."""

    kind = "burn_rate"

    def __init__(self, name, bad, total, budget, fast_s=None,
                 slow_s=None, labels=None, min_total=1.0,
                 description=""):
        super().__init__(name, description)
        self.bad = [bad] if isinstance(bad, str) else list(bad)
        self.total = [total] if isinstance(total, str) else list(total)
        self.budget = float(budget)
        if not (0.0 < self.budget <= 1.0):
            raise ValueError("budget must be a ratio in (0, 1], got %r"
                             % (budget,))
        self.fast_s = float(fast_s if fast_s is not None
                            else _cfg.get("MXNET_SLO_FAST_S"))
        self.slow_s = float(slow_s if slow_s is not None
                            else _cfg.get("MXNET_SLO_SLOW_S"))
        self.labels = dict(labels) if labels else None
        self.min_total = float(min_total)
        # (ts, bad_cum, total_cum) samples spanning >= the slow window
        self._samples = deque()
        # latched while firing: clearing is judged on the FAST window
        # alone (the slow window jittering across 1.0 under sustained
        # marginal burn must not flap one continuous incident into
        # repeated fired/cleared pairs)
        self._latched = False

    def _read(self, names):
        return sum(counter_value(n, labels=self.labels) for n in names)

    def _window(self, now, window_s):
        """(Δbad, Δtotal) over the trailing window (oldest retained
        sample when the window isn't covered yet)."""
        base = self._samples[0]
        for s in self._samples:
            if s[0] >= now - window_s:
                break
            base = s
        cur = self._samples[-1]
        return cur[1] - base[1], cur[2] - base[2]

    def check(self, now):
        bad, total = self._read(self.bad), self._read(self.total)
        self._samples.append((now, bad, total))
        horizon = now - self.slow_s * 1.5
        while len(self._samples) > 2 and self._samples[1][0] < horizon:
            self._samples.popleft()
        if len(self._samples) < 2:
            return None, {}
        burns = {}
        for tag, win in (("fast", self.fast_s), ("slow", self.slow_s)):
            db, dt = self._window(now, win)
            if dt < self.min_total:
                burns[tag] = 0.0
                continue
            burns[tag] = (db / dt) / self.budget
        # fire on BOTH windows (the slow window de-flakes a blip);
        # once latched, stay firing until the FAST window recovers
        firing = burns["fast"] >= 1.0 and \
            (burns["slow"] >= 1.0 or self._latched)
        self._latched = firing
        return firing, {"burn_fast": round(burns["fast"], 3),
                        "burn_slow": round(burns["slow"], 3),
                        "budget": self.budget,
                        "fast_s": self.fast_s, "slow_s": self.slow_s,
                        "bad": self.bad, "total": self.total,
                        "labels": self.labels}


class AnomalyRule(Rule):
    """Live value vs a robust baseline from the on-disk history
    (telemetry/history.py): fires when the current windowed value
    exceeds ``median + max(sigma·1.4826·MAD, floor·median)`` over the
    baseline rows — the straggler math
    (`fleet.robust_threshold`) pointed at this run's past instead of
    at other replicas.

    series: a sampled series; the LIVE value is its current ring
        percentile (``pct``, default p99); the BASELINE values are
        the history ``pct`` rows of the same name — and the same
        ``labels``, so a per-lane rule judges a lane against ITS OWN
        history, not a mix of every lane — over the trailing
        ``baseline_s`` seconds across OTHER runs.  Self-exclusion is
        load-bearing here exactly as it is for the straggler
        detector: the current run writes its own (possibly degraded)
        values into history every tick, so including them would let
        a sustained degradation normalize its own baseline until the
        rule can never fire.  ``include_self=True`` opts back in
        (single-long-run deployments with no prior history)."""

    kind = "anomaly"

    def __init__(self, name, series, sigma=None, baseline_s=3600.0,
                 pct="p99", labels=None, min_baseline=8,
                 rel_floor=0.5, include_self=False, description=""):
        super().__init__(name, description)
        self.series = str(series)
        self.sigma = float(sigma if sigma is not None
                           else _cfg.get("MXNET_STRAGGLER_SIGMA"))
        self.baseline_s = float(baseline_s)
        self.pct = str(pct)
        self.labels = dict(labels) if labels else None
        self.min_baseline = int(min_baseline)
        self.rel_floor = float(rel_floor)
        self.include_self = bool(include_self)
        self._cache_key = None      # shard (path, mtime, size) stats
        self._cache_rows = None

    def _baseline_rows(self, now):
        """The matching history rows, cached on the shard files'
        (path, mtime, size) stats: evaluation runs every exporter
        tick, and re-parsing every shard in the directory per tick
        per rule is the dominant cost — but other runs' shards are
        immutable once those runs end, so a cheap stat sweep usually
        answers 'nothing changed'.  The time filter applies to the
        cached rows, never busts the cache."""
        import os
        from . import history as _hist
        d = _hist.history_dir()
        me = _hist.get_writer().run if (_hist.enabled()
                                        and not self.include_self) \
            else None
        key = []
        for p in _hist._shards(d):
            if me is not None and os.path.basename(p) == \
                    "history-%s.jsonl" % me:
                continue            # own shard is excluded anyway —
                                    # its every-tick growth must not
                                    # bust the cache
            try:
                st = os.stat(p)
                key.append((p, st.st_mtime_ns, st.st_size))
            except OSError:
                continue
        key = tuple(key)
        if key != self._cache_key:
            rows = _hist.query(self.series, kind="pct",
                               labels=self.labels, directory=d)
            if me is not None:
                rows = [r for r in rows if r.get("run") != me]
            if self.labels is None:
                # an unlabeled rule baselines against the unlabeled
                # aggregate only (labeled children are different
                # series)
                rows = [r for r in rows if not r.get("labels")]
            self._cache_key, self._cache_rows = key, rows
        return [r for r in self._cache_rows
                if r.get("ts", 0) >= now - self.baseline_s]

    def check(self, now):
        cur = percentile_value(self.series, self.pct,
                               labels=self.labels)
        if cur is None:
            return None, {}
        rows = self._baseline_rows(now)
        base = [float(r.get(self.pct, r.get("v", 0))) for r in rows
                if r.get(self.pct) is not None or "v" in r]
        if len(base) < self.min_baseline:
            return None, {"baseline_n": len(base)}
        thresh = robust_threshold(base, self.sigma,
                                  rel_floor=self.rel_floor)
        return bool(cur > thresh), {
            "value": float(cur), "threshold": round(float(thresh), 1),
            "baseline_n": len(base), "sigma": self.sigma,
            "series": self.series, "pct": self.pct}


class CostDriftRule(Rule):
    """Cost-model regression: this run's measured ``kind="cost"`` /
    probe evidence contradicts the evidence a PRIOR run's autotune
    decision was based on (compile/autotune.py records the basis —
    ``best_us`` or ``basis_bytes`` — on every decision row).

    Judged entirely from durable history via
    ``autotune.drift_evidence(knob, label)``: unjudgeable (None) until
    both a prior decision with a recorded basis and fresh current-run
    measurements exist, firing when they disagree beyond
    ``autotune.DRIFT_FACTOR`` in either direction.  Firing also calls
    ``autotune.invalidate(knob, label)`` so the next ``suggest_*`` for
    the key ignores stale cross-run evidence and re-resolves from this
    run's rows — recording a ``drift_refresh`` decision event, which
    makes the rule unjudgeable again (the contradiction is resolved)
    and clears the alert after the debounce rounds."""

    kind = "cost_drift"

    def __init__(self, name, knob, label, description=""):
        super().__init__(
            name, description or
            "measured cost for %s[%s] vs prior-run decision evidence"
            % (knob, label))
        self.knob = str(knob)
        self.label = str(label or "")

    def check(self, now):
        """No verdict: the autotuner whose recorded evidence this rule
        judges (``compile/autotune.py``) is not ported yet."""
        return None, {}


class MemDriftRule(Rule):
    """Ledger-vs-allocator memory drift: the memwatch
    attribution join apportions each device's MEASURED resident bytes
    (PJRT ``memory_stats``, live-arrays fallback) to the tenants that
    COMMITTED bytes for it; this rule fires when the worst tenant's
    measured/committed ratio contradicts its commitment by more than
    ``MXNET_MEMWATCH_DRIFT_FACTOR`` in either direction — a model
    resident far above its admission footprint is eating someone
    else's budget, one far below is hoarding ledger nobody can use.

    The CostDriftRule lifecycle, applied to bytes: unjudgeable (None)
    until a FRESH sample exists (MXNET_MEMWATCH_FRESH_S), and firing
    also re-reconciles the drifting tenant's ledger row
    (`memwatch.reconcile_tenant` → `ModelRegistry.reconcile`), so the
    contradiction resolves and the alert clears on the next judged
    round.  The firing info carries the top-N consumers table
    (``info["top"]`` — rides into active alerts and dumps) plus the
    scalar evidence that survives the ring/history filters.

    ``rows_fn`` / ``reconcile_fn`` inject the attribution and the
    reconcile side-effect for deterministic tests (the fire →
    reconcile → clear drill runs off a hand-built ledger)."""

    kind = "mem_drift"

    def __init__(self, name="mem-drift", factor=None, top=None,
                 rows_fn=None, reconcile_fn=None, description=""):
        super().__init__(
            name, description or
            "measured resident bytes vs ledger commitment per tenant "
            "(memwatch attribution join)")
        self.factor = factor
        self.top = top
        self.rows_fn = rows_fn
        self.reconcile_fn = reconcile_fn

    def check(self, now):
        from . import memwatch as _mw
        if self.rows_fn is not None:
            rows = self.rows_fn()
        elif _mw.fresh_sample() is None:
            return None, {}
        else:
            rows = _mw.attribution()
        if not rows:
            return None, {}
        factor = float(self.factor if self.factor is not None
                       else _cfg.get("MXNET_MEMWATCH_DRIFT_FACTOR"))
        worst, worst_score = None, 0.0
        for r in rows:
            c = int(r.get("committed_bytes", 0))
            if c <= 0:
                continue            # nothing promised, nothing to
            m = int(r.get("measured_bytes", 0))     # contradict
            score = (m / c) if m >= c else \
                (float("inf") if m <= 0 else c / m)
            if score > worst_score:
                worst, worst_score = r, score
        if worst is None:
            return None, {}
        firing = bool(worst_score > factor)
        top_n = int(self.top if self.top is not None
                    else _cfg.get("MXNET_MEMWATCH_TOP"))
        top = {}
        for r in sorted(rows,
                        key=lambda x: -x.get("measured_bytes", 0)
                        )[:max(1, top_n)]:
            top["%s@%s" % (r.get("tenant"), r.get("device"))] = \
                int(r.get("measured_bytes", 0))
        info = {
            "tenant": str(worst.get("tenant")),
            "device": str(worst.get("device")),
            "committed_bytes": int(worst.get("committed_bytes", 0)),
            "measured_bytes": int(worst.get("measured_bytes", 0)),
            "ratio": round(float(worst_score), 3),
            "factor": factor,
            "source": str(worst.get("source", "?")),
            "top": top,
            "labels": {"tenant": str(worst.get("tenant"))}}
        if firing:
            rec = self.reconcile_fn if self.reconcile_fn is not None \
                else _mw.reconcile_tenant
            try:
                info["reconciled"] = bool(rec(worst.get("tenant")))
            except Exception:       # noqa: BLE001 — the side-effect
                info["reconciled"] = False      # is best-effort
        return firing, info


# -- registry + alert lifecycle ----------------------------------------
_LOCK = threading.Lock()
_RULES = {}                 # name -> Rule
_ACTIVE = {}                # name -> info dict while firing
_ACTIONS = []               # callables (rule_name, firing, info)
_UNJUDGED = {}              # name -> consecutive unjudgeable rounds
#: consecutive unjudgeable rounds before an ACTIVE alert is cleared:
#: a firing rule REPLACED mid-incident (install_slo_rules re-run) is
#: unjudgeable for exactly one round while its windows warm — that
#: blip must not emit a cleared+fired pair for one continuous
#: incident, while genuinely evaporated evidence (an aged-out
#: baseline) stays unjudgeable round after round and does clear
UNJUDGED_CLEAR_ROUNDS = 2


def register_rule(rule: Rule) -> Rule:
    """Add (or replace) a rule; it is evaluated from the next tick.
    Replacing a rule whose alert is FIRING keeps the alert active —
    the next evaluation under the new definition either continues the
    incident (no double `slo.fired`) or emits the `cleared`
    transition, so fired/cleared rows always pair up."""
    with _LOCK:
        _RULES[rule.name] = rule
    return rule


def unregister_rule(name) -> None:
    """Remove a rule.  If its alert is FIRING, the cleared transition
    is emitted first — fired/cleared counters, ring events and
    history rows must always pair up, and the gauge's final scrape
    must read 0, not vanish at 1 until Prometheus staleness."""
    with _LOCK:
        _RULES.pop(str(name), None)
        _UNJUDGED.pop(str(name), None)
        prev = _ACTIVE.pop(str(name), None)
    if prev is not None:
        _transition(str(name), False, dict(prev, unregistered=True))


def clear_rules() -> None:
    """Drop every rule (and action hook).  Firing alerts clear with
    paired transitions first (see `unregister_rule`)."""
    with _LOCK:
        active = {k: dict(v) for k, v in _ACTIVE.items()}
        _RULES.clear()
        _ACTIVE.clear()
        _UNJUDGED.clear()
    for name in sorted(active):
        _transition(name, False, dict(active[name],
                                      unregistered=True))
    with _LOCK:
        del _ACTIONS[:]


def rules() -> dict:
    """{name: Rule} snapshot of the registered rules."""
    with _LOCK:
        return dict(_RULES)


def active_alerts() -> dict:
    """{rule name: info} for the rules currently firing — the state
    behind the ``mxnet_alert_active`` gauge."""
    with _LOCK:
        return {k: dict(v) for k, v in _ACTIVE.items()}


def register_action(fn) -> None:
    """Register a hook called as ``fn(rule_name, firing, info)`` on
    every alert TRANSITION (fired and cleared).  Hooks are
    best-effort: a raising hook is counted (slo.action_errors), never
    propagated into the exporter tick."""
    with _LOCK:
        _ACTIONS.append(fn)


def _attach_exemplar(name, info):
    """Attach the worst matching promoted request exemplar
    to a firing serving/generation rule's info, IN PLACE: the full
    waterfall under ``info["exemplar"]`` (rides into the active-alerts
    block, /metrics.json and the proactive dump), plus scalar
    ``exemplar_*`` fields that survive the ring event's and history
    row's scalar filters — the on-call sees the autopsy, not just the
    gauge."""
    if name.startswith("serve-"):
        engine = "serve"
    elif name.startswith("gen-"):
        engine = "gen"
    else:
        return                      # only request-path rules carry one
    try:
        from . import reqtrace as _rt
        ex = _rt.worst_exemplar(
            lane=(info.get("labels") or {}).get("lane"),
            engine=engine)
    except Exception:               # noqa: BLE001 — attachment is
        return                      # garnish, never breaks the alert
    if not ex:
        return
    info["exemplar"] = dict(ex)
    info["exemplar_rid"] = ex.get("rid")
    info["exemplar_e2e_us"] = ex.get("e2e_us")
    info["exemplar_status"] = ex.get("status")
    info["exemplar_phase"] = ex.get("dominant")


def _transition(name, firing, info):
    events.incr("slo.fired" if firing else "slo.cleared")
    events.incr("slo.fired" if firing else "slo.cleared",
                labels={"rule": name})
    _bb.record("slo", "fired" if firing else "cleared", rule=name,
               **{k: v for k, v in info.items()
                  if isinstance(v, (int, float, str, bool))})
    try:
        from . import history as _hist
        _hist.record("slo", name, 1.0 if firing else 0.0,
                     labels={"rule": name},
                     event="fired" if firing else "cleared",
                     **{k: v for k, v in info.items()
                        if k.startswith("exemplar_")})
    except Exception:               # noqa: BLE001
        pass
    if firing:
        # the proactive dump: the black box triggers while the run is
        # still alive, reason names the rule (per-reason throttled)
        _bb.crash_dump("slo:%s" % name)
    with _LOCK:
        hooks = list(_ACTIONS)
    for fn in hooks:
        try:
            fn(name, firing, dict(info))
        except Exception:           # noqa: BLE001 — an alert hook
            events.incr("slo.action_errors")    # must not kill the
                                                # evaluator


def evaluate(now=None) -> list:
    """Evaluate every registered rule (the periodic exporter calls
    this each tick).  Handles fired/cleared transitions; returns the
    sorted names of the rules currently firing.  Never raises — a
    broken rule is counted on ``slo.rule_errors`` and skipped."""
    now = float(now if now is not None else time.time())
    with _LOCK:
        todo = list(_RULES.items())
    fired_now = []
    for name, rule in todo:
        try:
            firing, info = rule.check(now)
        except Exception:           # noqa: BLE001
            events.incr("slo.rule_errors")
            continue
        if firing is None:
            # not judgeable (cold windows, empty ring, baseline aged
            # out).  A rule that STAYS unjudgeable while firing must
            # clear — the evidence evaporated, and an alert nothing
            # can ever re-judge would latch active forever, gauge
            # stuck at 1 with no paired cleared transition.
            # Debounced (UNJUDGED_CLEAR_ROUNDS): a firing rule
            # replaced mid-incident warms up over one round, which
            # must not flap cleared+fired
            with _LOCK:
                active = name in _ACTIVE
                n = _UNJUDGED[name] = _UNJUDGED.get(name, 0) + 1
                prev = _ACTIVE.pop(name, None) \
                    if active and n >= UNJUDGED_CLEAR_ROUNDS else None
            if prev is not None:
                _transition(name, False,
                            dict(prev, unjudgeable=True))
            continue
        _UNJUDGED.pop(name, None)
        if firing:
            _attach_exemplar(name, info)
        with _LOCK:
            was = name in _ACTIVE
            if firing:
                _ACTIVE[name] = dict(info, since=_ACTIVE.get(
                    name, {}).get("since", now))
            else:
                _ACTIVE.pop(name, None)
        if firing and not was:
            _transition(name, True, info)
        elif was and not firing:
            _transition(name, False, info)
        if firing:
            fired_now.append(name)
    return sorted(fired_now)


def block() -> dict:
    """The ``slo`` block for /metrics.json, dumps and teletop: the
    registered rules and the currently-active alerts."""
    with _LOCK:
        if not _RULES and not _ACTIVE:
            return {}
        return {"rules": [r.describe() for _, r in
                          sorted(_RULES.items())],
                "active": {k: dict(v) for k, v in _ACTIVE.items()}}


# -- default serving rules (derived from the serving knobs) ------------
def _lanes_and_quotas():
    """(lanes, {lane: quota fraction}) from MXNET_SERVE_LANES /
    MXNET_SERVE_LANE_QUOTAS — the fraction ladder is the SHARED
    `config.serve_lane_quota_fractions` the engine's enforcement
    also parses through."""
    lanes = [s.strip() for s in
             str(_cfg.get("MXNET_SERVE_LANES") or "").split(",")
             if s.strip()] or ["high"]
    fracs = _cfg.serve_lane_quota_fractions(
        _cfg.get("MXNET_SERVE_LANE_QUOTAS") or "", len(lanes))
    return lanes, dict(zip(lanes, fracs))


def default_serving_rules(targets=None, shed_budget=None, fast_s=None,
                          slow_s=None, lanes=None,
                          quotas=None) -> list:
    """The serving SLO set the lane knobs imply, as rules:

    - per lane, a shed-rate **burn** rule: bad = that lane's sheds,
      total = its requests + sheds; the error budget follows the
      lane-quota ladder — the TOP lane budgets ``shed_budget``
      (MXNET_SLO_SHED_BUDGET), lower lanes are DESIGNED to shed under
      overload and budget ``max(shed_budget, 1 - quota)``
    - per lane with an observed deadline (``targets``: {lane:
      seconds}, from `InferenceEngine.slo_targets()` /
      `ModelRegistry.slo_targets()`), a p99-vs-deadline **threshold**
      rule on the labeled ``serve.e2e_us`` ring

    ``lanes``/``quotas`` override the env knobs — a live engine's
    ``slo_lane_quotas()`` supplies what it actually enforces (a
    programmatic ``lane_quotas=`` engine must not be budgeted off
    the env ladder it isn't using).  Returns the rule list (callers
    register what they keep)."""
    if shed_budget is None:
        shed_budget = float(_cfg.get("MXNET_SLO_SHED_BUDGET"))
    if lanes is None and quotas is not None:
        lanes = list(quotas)        # dict order = priority order
    if lanes is None or quotas is None:
        env_lanes, env_quotas = _lanes_and_quotas()
        lanes = list(lanes) if lanes is not None else env_lanes
        quotas = dict(quotas) if quotas is not None else env_quotas
    out = []
    for lane in lanes:
        budget = max(shed_budget, 1.0 - quotas.get(lane, 1.0))
        out.append(BurnRateRule(
            "serve-shed-%s" % lane,
            bad="serve.shed", total=["serve.requests", "serve.shed"],
            budget=budget, fast_s=fast_s, slow_s=slow_s,
            labels={"lane": lane},
            description="lane %r shed fraction burns its %.0f%% error "
                        "budget over both windows" % (lane,
                                                      budget * 100)))
        t = (targets or {}).get(lane)
        if t:
            out.append(ThresholdRule(
                "serve-p99-%s" % lane,
                metric="serve.e2e_us", pct="p99",
                labels={"lane": lane}, bound=float(t) * 1e6,
                description="lane %r e2e p99 within its observed "
                            "%.3fs deadline" % (lane, float(t))))
    return out


def default_generation_rules(targets=None, shed_budget=None,
                             fast_s=None, slow_s=None, lanes=None,
                             quotas=None) -> list:
    """The generation-serving SLO set: same lane-ladder
    discipline as `default_serving_rules`, pointed at the
    `GenerationEngine`'s own series —

    - per lane, a shed-rate burn rule over ``gen.shed`` /
      (``gen.requests`` + ``gen.shed``) with the lane-quota error
      budget;
    - per lane with an observed deadline target (``targets``: {lane:
      seconds}, from `GenerationEngine.slo_targets()`), a
      **TTFT p99** threshold rule on the labeled ``gen.ttft_us`` ring
      — time-to-first-token is the generation tail users feel; a
      request that will finish in time but starts late is already a
      violation.
    """
    if shed_budget is None:
        shed_budget = float(_cfg.get("MXNET_SLO_SHED_BUDGET"))
    if lanes is None and quotas is not None:
        lanes = list(quotas)
    if lanes is None or quotas is None:
        env_lanes, env_quotas = _lanes_and_quotas()
        lanes = list(lanes) if lanes is not None else env_lanes
        quotas = dict(quotas) if quotas is not None else env_quotas
    out = []
    for lane in lanes:
        budget = max(shed_budget, 1.0 - quotas.get(lane, 1.0))
        out.append(BurnRateRule(
            "gen-shed-%s" % lane,
            bad="gen.shed", total=["gen.requests", "gen.shed"],
            budget=budget, fast_s=fast_s, slow_s=slow_s,
            labels={"lane": lane},
            description="lane %r generation shed fraction burns its "
                        "%.0f%% error budget over both windows"
                        % (lane, budget * 100)))
        t = (targets or {}).get(lane)
        if t:
            out.append(ThresholdRule(
                "gen-ttft-p99-%s" % lane,
                metric="gen.ttft_us", pct="p99",
                labels={"lane": lane}, bound=float(t) * 1e6,
                description="lane %r time-to-first-token p99 within "
                            "its observed %.3fs deadline"
                            % (lane, float(t))))
    return out


def install_default_generation_rules(engine=None, registry=None,
                                     **kw) -> list:
    """Build + register the default generation rules; ``engine`` (a
    GenerationEngine) or ``registry`` supplies the observed per-lane
    deadline targets and enforced quotas.  Returns rule names."""
    targets = kw.pop("targets", None)
    src = engine if engine is not None else registry
    if src is not None:
        if targets is None:
            targets = src.slo_targets()
        if "quotas" not in kw:
            q = src.slo_lane_quotas()
            if q:
                kw["quotas"] = q
    installed = [register_rule(r) for r in
                 default_generation_rules(targets=targets, **kw)]
    return [r.name for r in installed]


def install_default_serving_rules(registry=None, engine=None,
                                  **kw) -> list:
    """Build + register the default serving rules; ``registry`` /
    ``engine`` supply the per-lane deadline targets AND the enforced
    lane quotas (so programmatic lane configs get budgets matching
    their actual enforcement).  Returns the registered rule names."""
    targets = kw.pop("targets", None)
    src = registry if registry is not None else engine
    if src is not None:
        if targets is None:
            targets = src.slo_targets()
        if "quotas" not in kw:
            q = src.slo_lane_quotas()
            if q:
                kw["quotas"] = q
    installed = [register_rule(r) for r in
                 default_serving_rules(targets=targets, **kw)]
    return [r.name for r in installed]


def default_memwatch_rules(**kw) -> list:
    """The memory-drift watchdog: one `MemDriftRule`
    judging the whole attribution join — it fires naming the WORST
    drifting tenant, so one rule covers every tenant the ledgers
    know about (new deploys included, no re-install needed)."""
    return [MemDriftRule(**kw)]


def install_memwatch_rules(**kw) -> list:
    """Build + register the memwatch drift rule.  Returns the
    registered rule names."""
    installed = [register_rule(r) for r in default_memwatch_rules(**kw)]
    return [r.name for r in installed]
