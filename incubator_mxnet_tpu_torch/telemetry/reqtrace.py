"""Per-request lifecycle journal of the PyTorch port, with tail-based
exemplar retention (the core of incubator_mxnet_tpu/telemetry/
reqtrace.py).

- An engine allocates one pre-sized `Record` per request at submit
  (`Journal.start`) and fills its phase stamps from timestamps it
  already takes; generation's ladder is queue -> prefill -> decode ->
  resolution.  Sheds and deadline kills record their termination
  reason and the phase that ate the budget (the first phase whose end
  stamp never landed).
- A bounded per-engine ring (`MXNET_REQTRACE_RING`) keeps the retired
  records.
- At retire time (`Journal.retire`), a request whose e2e lands above
  its lane's rolling p99 (window `MXNET_REQTRACE_WINDOW`; pinned with
  `MXNET_REQTRACE_PIN_P99_US`), and every terminal failure, is
  promoted to an exemplar: its phase waterfall goes to the flight
  recorder's ring, stamped at admission, and to the bounded exemplar
  sets that `block()` and black-box dumps read.

``MXNET_REQTRACE=0`` makes `start()` return None
and every stamp a no-op.

Left out: the JAX package's durable history rows of promoted
exemplars.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import deque

from .. import config as _cfg
from ..monitor import events
from . import flightrec as _bb

__all__ = ["Record", "Journal", "journal", "enabled", "exemplars",
           "worst_exemplar", "block", "PHASES"]

#: per-engine-kind phase ladders: (phase, end-stamp slot) pairs walked
#: in order from ``t_enq``.  A record terminated before a stamp landed
#: charges the remaining wall to that phase — "which phase ate the
#: budget" for sheds and deadline kills.
PHASES = {
    "serve": (("queue", "t_collect"), ("coalesce", "t_exec"),
              ("dispatch", "t_infer0"), ("infer", "t_infer1"),
              ("join", "t_fin"), ("resolve", "t_done")),
    "gen": (("queue", "t_collect"), ("prefill", "t_exec"),
            ("decode", "t_fin"), ("resolve", "t_done")),
}

#: rolling-p99 promotion needs this many completed requests in the
#: lane window first — without the floor, the first request after
#: start would always out-tail an empty window
MIN_WINDOW = 20

#: retire-time p99 cache: re-sort the lane window only every N
#: retires (the tail moves slowly; an exact per-retire sort would be a
#: hidden O(n log n) per request)
_P99_EVERY = 32

def enabled() -> bool:
    """Whether the request journal is armed for this process."""
    return bool(_cfg.get("MXNET_REQTRACE"))


_rids = itertools.count(1)      # CPython-atomic next(); no lock


class Record:
    """One request's lifecycle struct — pre-sized slots, filled by
    plain attribute writes from stamps the engine already takes.
    Monotonic seconds throughout; phase math happens once, at retire
    or render time, never on the submit path."""

    __slots__ = ("rid", "lane", "tenant", "bucket", "n",
                 "t_enq", "t_collect", "t_exec", "t_infer0",
                 "t_infer1", "t_fin", "t_done",
                 "status", "reason", "e2e_us")

    def __init__(self, t_enq, lane, tenant):
        self.rid = next(_rids)
        self.lane = lane
        self.tenant = tenant
        self.bucket = None
        self.n = 1
        self.t_enq = t_enq
        self.t_collect = None
        self.t_exec = None
        self.t_infer0 = None
        self.t_infer1 = None
        self.t_fin = None
        self.t_done = None
        self.status = None
        self.reason = None
        self.e2e_us = None


def _status_of(exc):
    """(status, reason) from the engine's terminal exception — typed
    errors map onto stable status strings the autopsy families key
    on."""
    if exc is None:
        return "ok", None
    name = type(exc).__name__
    msg = str(exc)
    if len(msg) > 120:
        msg = msg[:117] + "..."
    if name == "Shed":
        return "shed", msg
    if name == "DeadlineExceeded":
        return "deadline", msg
    if name == "QueueFull":
        return "queue_full", msg
    if name == "EngineClosed":
        return "closed", msg
    return "error", "%s: %s" % (name, msg)


def _phases(rec, kind):
    """(phase µs dict, budget phase) for one retired record: an exact
    partition of [t_enq, t_done] along the kind's ladder.  A missing
    stamp means the request terminated INSIDE that phase — it is
    charged the remaining wall and named the budget phase; a complete
    record's budget phase is its dominant one."""
    ladder = PHASES.get(kind, PHASES["serve"])
    phases, cur, budget = {}, rec.t_enq, None
    for name, attr in ladder:
        t = getattr(rec, attr)
        if t is None:
            phases[name] = max(0.0, (rec.t_done - cur) * 1e6)
            budget = name
            break
        phases[name] = max(0.0, (t - cur) * 1e6)
        cur = t
    else:
        budget = max(phases, key=phases.get) if phases else None
    return phases, budget


def record_summary(rec, kind):
    """A retired record as a plain dict (ring snapshots)."""
    phases, budget = _phases(rec, kind)
    return {"rid": rec.rid, "lane": rec.lane or "-",
            "tenant": rec.tenant, "bucket": rec.bucket, "n": rec.n,
            "status": rec.status, "reason": rec.reason,
            "e2e_us": round(rec.e2e_us or 0.0, 1),
            "phases": {k: round(v, 1) for k, v in phases.items()},
            "dominant": max(phases, key=phases.get) if phases
            else None,
            "budget_phase": budget}


class Journal:
    """One engine's bounded request journal + per-lane tail tracker.

    Engines call `start()` at submit (None when disabled — every
    later stamp guards on the record), fill stamps as the request
    crosses phases, and `retire()` exactly once at resolution.
    Everything that costs more than an attribute write — phase math,
    the p99 compare, exemplar promotion — happens inside `retire()`,
    off the submit path."""

    def __init__(self, kind, model, version=None, ring=None,
                 window=None, keep=None):
        self.kind = str(kind)
        self.model = str(model)
        self.version = version
        self._ring = deque(maxlen=int(
            ring if ring is not None
            else _cfg.get("MXNET_REQTRACE_RING")))
        self._window = int(window if window is not None
                           else _cfg.get("MXNET_REQTRACE_WINDOW"))
        self._ex = deque(maxlen=int(
            keep if keep is not None
            else _cfg.get("MXNET_REQTRACE_EXEMPLARS")))
        self._lane_e2e = {}         # lane -> deque of completed e2e µs
        self._lane_p99 = {}         # lane -> [cached p99, age]
        self._lock = threading.Lock()
        self.records = 0
        self.promoted = 0

    # -- hot path ------------------------------------------------------
    def start(self, t_enq, lane, tenant=None):
        """A fresh record for an admitted request (None when the
        journal is disabled — stamps and retire() no-op on None)."""
        if not enabled():
            return None
        return Record(t_enq, lane, tenant)

    # -- retire path (off the submit path) -----------------------------
    def retire(self, rec, exc=None, status=None, reason=None,
               t_done=None):
        """Classify one finished record: status from the terminal
        exception (or explicit ``status=``), e2e, ring append, lane
        tail update, and the promotion decision.  Idempotence is the
        CALLER's contract (engines null the request's rec reference
        before calling)."""
        if rec is None:
            return None
        rec.t_done = float(t_done) if t_done is not None \
            else time.monotonic()
        if status is not None:
            rec.status, rec.reason = str(status), reason
        else:
            rec.status, rec.reason = _status_of(exc)
        rec.e2e_us = (rec.t_done - rec.t_enq) * 1e6
        lane = rec.lane or "-"
        promote = rec.status != "ok"
        with self._lock:
            self._ring.append(rec)
            self.records += 1
            if rec.status == "ok":
                dq = self._lane_e2e.get(lane)
                if dq is None:
                    dq = self._lane_e2e[lane] = \
                        deque(maxlen=self._window)
                dq.append(rec.e2e_us)
                promote = rec.e2e_us > self._p99_locked(lane, dq)
        events.incr("reqtrace.records")
        if promote:
            self._promote(rec)
        return rec

    def _p99_locked(self, lane, dq):
        """The lane's promotion threshold: the pinned value when
        `MXNET_REQTRACE_PIN_P99_US` > 0 (deterministic tests), else
        the rolling window's p99, re-sorted every `_P99_EVERY`
        retires.  Infinite until the window has MIN_WINDOW samples."""
        pin = float(_cfg.get("MXNET_REQTRACE_PIN_P99_US") or 0.0)
        if pin > 0.0:
            return pin
        if len(dq) < MIN_WINDOW:
            return float("inf")
        cached = self._lane_p99.get(lane)
        if cached is not None and cached[1] < _P99_EVERY:
            cached[1] += 1
            return cached[0]
        xs = sorted(dq)
        p = xs[min(len(xs) - 1, int(0.99 * len(xs)))]
        self._lane_p99[lane] = [p, 0]
        return p

    def _promote(self, rec):
        """Exemplar promotion: full waterfall into the flight-recorder
        ring (admission-stamped) and the bounded exemplar sets dumps
        read."""
        phases, budget = _phases(rec, self.kind)
        dominant = max(phases, key=phases.get) if phases else None
        # the epoch stamp of the monotonic admission time
        wall0 = time.time() - (time.monotonic() - rec.t_enq)
        ex = {"rid": rec.rid, "engine": self.kind, "model": self.model,
              "lane": rec.lane or "-", "tenant": rec.tenant,
              "bucket": rec.bucket, "n": rec.n,
              "status": rec.status, "reason": rec.reason,
              "e2e_us": round(rec.e2e_us, 1),
              "phases": {k: round(v, 1) for k, v in phases.items()},
              "dominant": dominant, "budget_phase": budget,
              "ts": wall0}
        if self.version is not None:
            ex["version"] = str(self.version)
        with self._lock:
            self._ex.append(ex)
            self.promoted += 1
        with _GLOCK:
            _EXEMPLARS.append(ex)
        events.incr("reqtrace.exemplars")
        events.incr("reqtrace.exemplars", labels={"lane": ex["lane"]})
        # ring event stamped at admission: the dump timeline shows the
        # exemplar where its wait began, so queue growth and the victim
        # line up
        _bb.record_at(wall0, "reqtrace", "exemplar", rid=rec.rid,
                      engine=self.kind, model=self.model,
                      lane=ex["lane"], status=rec.status,
                      e2e_us=int(rec.e2e_us), dominant=str(dominant),
                      **{"%s_us" % k: int(v)
                         for k, v in phases.items()})

    # -- introspection -------------------------------------------------
    def exemplars(self):
        with self._lock:
            return [dict(e) for e in self._ex]

    def snapshot(self):
        """The journal's block for dumps:
        counts, per-lane window p99 + slowest recent request (with its
        waterfall), and the retained exemplars."""
        with self._lock:
            recs = list(self._ring)
            windows = {ln: (len(dq), list(dq))
                       for ln, dq in self._lane_e2e.items()}
            exs = [dict(e) for e in self._ex]
        slow = {}
        for rec in recs:
            ln = rec.lane or "-"
            cur = slow.get(ln)
            if rec.e2e_us is not None and \
                    (cur is None or rec.e2e_us > cur.e2e_us):
                slow[ln] = rec
        lanes = {}
        for ln in set(windows) | set(slow):
            n, vals = windows.get(ln, (0, []))
            entry = {"window_n": n}
            if vals:
                xs = sorted(vals)
                entry["p99_us"] = round(
                    xs[min(len(xs) - 1, int(0.99 * len(xs)))], 1)
            if ln in slow:
                entry["slowest"] = record_summary(slow[ln], self.kind)
            lanes[ln] = entry
        out = {"engine": self.kind, "model": self.model,
               "records": self.records, "promoted": self.promoted,
               "ring": len(recs), "lanes": lanes, "exemplars": exs}
        if self.version is not None:
            out["version"] = str(self.version)
        return out


# -- process-wide registry (dumps) -------------------------------------
_GLOCK = threading.Lock()
_JOURNALS = []                  # weakrefs — journals die with engines
_EXEMPLARS = deque(maxlen=64)   # newest promotions across all engines


def journal(kind, model, version=None, **kw) -> Journal:
    """Create + register one engine's journal.  Held by WEAKREF here:
    a journal lives exactly as long as its engine, and a torn-down
    engine's journal must not pin its ring in every later dump."""
    j = Journal(kind, model, version=version, **kw)
    with _GLOCK:
        _JOURNALS[:] = [r for r in _JOURNALS if r() is not None]
        _JOURNALS.append(weakref.ref(j))
    return j


def _live_journals():
    with _GLOCK:
        refs = list(_JOURNALS)
    return [j for j in (r() for r in refs) if j is not None]


def exemplars(lane=None, engine=None, model=None):
    """Recent promoted exemplars across every engine, oldest first,
    optionally filtered by lane / engine kind / model."""
    with _GLOCK:
        out = list(_EXEMPLARS)
    if lane is not None:
        out = [e for e in out if e.get("lane") == str(lane)]
    if engine is not None:
        out = [e for e in out if e.get("engine") == str(engine)]
    if model is not None:
        out = [e for e in out if e.get("model") == str(model)]
    return out


def worst_exemplar(lane=None, engine=None, model=None):
    """The retained exemplar with the largest e2e matching the filters
    (None when nothing matches): what a firing SLO rule attaches."""
    best = None
    for ex in exemplars(lane=lane, engine=engine, model=model):
        if best is None or ex.get("e2e_us", 0) > best.get("e2e_us", 0):
            best = ex
    return best


def block() -> dict:
    """The ``reqtrace`` block for dumps: every live journal's snapshot
    and the newest cross-engine exemplars.  Empty dict when nothing was
    journaled."""
    js = [j.snapshot() for j in _live_journals()]
    js = [s for s in js if s["records"]]
    with _GLOCK:
        exs = list(_EXEMPLARS)
    if not js and not exs:
        return {}
    return {"journals": js, "exemplars": exs[-16:]}
