"""Durable on-disk metrics history of the PyTorch port (a copy of
incubator_mxnet_tpu/telemetry/history.py, which imports no JAX).

An append-only, bounded, on-disk time series every run contributes to
and every later run can query:

- **One shard file per process** under ``MXNET_HISTORY_DIR`` (or the
  directory a `HistoryWriter` is given): ``history-<runid>.jsonl`` where
  ``runid = <ts>-p<pid>``; concurrent runs write disjoint shards and
  `query()` reads across all of them.
- **Fixed-schema rows**, one JSON object per line, each with ``ts``,
  ``run``, ``kind``, ``name``, ``v`` and optionally ``labels``.  Kinds:
  ``counter`` (per-tick deltas with the cumulative ``total``), ``pct``
  (p50/p90/p99/n of each sampled series, ``v`` = p99), ``cost`` (the
  `telemetry.costs` rows whose invocation count moved), ``marker``
  (`note_event`), ``slo`` (alert transitions, telemetry/slo.py) and
  ``memwatch`` (per-device peak watermarks when they rise,
  telemetry/memwatch.py).
- **Bounded**: a shard past ``MXNET_HISTORY_SHARD_KB`` is compacted in
  place: the newest half of the rows survive, the older half is
  downsampled 2:1, until the shard fits in ~3/4 of the cap.

Nothing here runs per request: rows are written at exporter-tick
cadence (`tick()`) and at marker events.

    from incubator_mxnet_tpu_torch.telemetry import history
    rows = history.query("serve.infer", kind="cost")      # across runs
"""
from __future__ import annotations

import json
import os
import threading
import time

from .. import config as _cfg
from ..monitor import events

__all__ = ["HistoryWriter", "enabled", "history_dir", "get_writer",
           "record", "note_event", "record_fleet", "tick", "query",
           "runs", "flush", "reset"]

SCHEMA = "mxtpu-history/1"

#: rows the compaction floor never drops below (a shard with a handful
#: of giant rows must converge, not loop)
MIN_ROWS = 16


def history_dir() -> str:
    """The shard directory (MXNET_HISTORY_DIR; empty = disabled)."""
    return str(_cfg.get("MXNET_HISTORY_DIR") or "")


def enabled() -> bool:
    return bool(history_dir())


def _new_run_id() -> str:
    return "%s-p%d" % (time.strftime("%Y%m%dT%H%M%S"), os.getpid())


class HistoryWriter:
    """One process's append-only shard with size-capped compaction.

    Thread-safe; every public method is a no-op returning 0/None when
    the directory is unset.  `tick()` is the batch entry point the
    periodic exporter drives; `append()` is the single-row primitive
    markers and alerts use."""

    def __init__(self, directory=None, run=None, shard_kb=None):
        self._dir = directory if directory is not None \
            else history_dir()
        self.run = str(run) if run else _new_run_id()
        self._cap = int(shard_kb if shard_kb is not None
                        else _cfg.get("MXNET_HISTORY_SHARD_KB")) * 1024
        self._lock = threading.Lock()
        # serializes whole tick() bodies (the exporter worker and a
        # checkpointing training thread both tick): the delta
        # baselines below are read-modify-write state, and racing
        # them would write the same counter delta twice.  Separate
        # from _lock because tick() ends in append_rows (which takes
        # _lock itself)
        self._tick_lock = threading.Lock()
        self._bytes = None          # lazily sized from the file
        self._last_counts = {}      # tick counter-delta baseline
        self._last_lcounts = {}     # labeled-counter baseline
        self._last_invocations = {} # cost-row key -> invocations
        self.rows_written = 0

    @property
    def path(self):
        if not self._dir:
            return None
        return os.path.join(self._dir, "history-%s.jsonl" % self.run)

    # -- writing -------------------------------------------------------
    def append(self, kind, name, value, labels=None, ts=None, **fields):
        """Write ONE row (no-op when disabled).  Returns 1 if a row was
        written."""
        if not self._dir:
            return 0
        row = {"ts": float(ts if ts is not None else time.time()),
               "run": self.run, "kind": str(kind), "name": str(name),
               "v": float(value)}
        if labels:
            row["labels"] = {str(k): str(v) for k, v in labels.items()}
        if fields:
            row.update(fields)
        return self.append_rows([row])

    def append_rows(self, rows):
        """Write a batch of pre-built rows under one lock (one open +
        one flush per tick, not per row).  Returns the count."""
        if not self._dir or not rows:
            return 0
        body = "".join(json.dumps(r, sort_keys=True, default=str) + "\n"
                       for r in rows)
        data = body.encode()
        with self._lock:
            os.makedirs(self._dir, exist_ok=True)
            path = self.path
            if self._bytes is None:
                try:
                    self._bytes = os.path.getsize(path)
                except OSError:
                    self._bytes = 0
            with open(path, "a") as f:
                f.write(body)
            self._bytes += len(data)
            self.rows_written += len(rows)
            if self._bytes > self._cap:
                self._compact_locked()
        events.incr("history.rows", len(rows))
        return len(rows)

    def _compact_locked(self):
        """Rewrite the shard under the size cap: newest half kept
        intact, older half downsampled 2:1, repeated until the shard
        fits in ~3/4 of the cap (headroom so the next append doesn't
        immediately re-compact).  Atomic (tmp + os.replace); caller
        holds the lock."""
        path = self.path
        try:
            with open(path) as f:
                lines = [ln for ln in f.read().splitlines() if ln]
        except OSError:
            self._bytes = 0
            return
        target = max(1024, int(self._cap * 0.75))
        dropped = 0

        def size_of(ls):
            return sum(len(ln) + 1 for ln in ls)

        while size_of(lines) > target and len(lines) > MIN_ROWS:
            half = len(lines) // 2
            old, new = lines[:half], lines[half:]
            kept_old = old[1::2]        # downsample 2:1, newest-biased
            dropped += len(old) - len(kept_old)
            lines = kept_old + new
            if not kept_old and size_of(lines) > target:
                # pathological giant rows: shed oldest outright
                dropped += 1
                lines = lines[1:]
        tmp = "%s.tmp.%d.%d" % (path, os.getpid(),
                                threading.get_ident())
        body = "\n".join(lines) + ("\n" if lines else "")
        with open(tmp, "w") as f:
            f.write(body)
        os.replace(tmp, path)
        self._bytes = len(body.encode())
        events.incr("history.compactions")
        if dropped:
            events.incr("history.rows_downsampled", dropped)

    #: counter families the tick never writes: the history layer's own
    #: bookkeeping counters move BECAUSE a tick wrote rows, so
    #: including them would make every tick write at least one row
    #: forever — an idle process must quiesce
    SELF_PREFIXES = ("history.",)

    # -- the exporter-tick batch ---------------------------------------
    def tick(self, now=None):
        """Write one tick's fixed-schema batch: counter deltas (plain +
        labeled), percentile summaries, and cost-registry rows that
        moved.  Returns the number of rows written.  Whole-tick bodies
        are serialized: the delta baselines are read-modify-write
        state."""
        if not self._dir:
            return 0
        with self._tick_lock:
            return self._tick_locked(
                float(now if now is not None else time.time()))

    def _tick_locked(self, now):
        rows = []

        def row(kind, name, v, labels=None, **fields):
            r = {"ts": now, "run": self.run, "kind": kind,
                 "name": name, "v": float(v)}
            if labels:
                r["labels"] = {str(k): str(v_) for k, v_ in
                               labels.items()}
            r.update(fields)
            rows.append(r)

        # counters: deltas since the last tick (rates belong to the
        # reader; the cumulative rides along for exactness).  The
        # delta maps double as the movement gate for the pct rows
        # below, so they must be collected before baselines update
        snap = events.snapshot()
        deltas, ldeltas = {}, {}
        for name in sorted(snap):
            d = snap[name] - self._last_counts.get(name, 0)
            if d:
                deltas[name] = d
                if not name.startswith(self.SELF_PREFIXES):
                    row("counter", name, d, total=snap[name])
            self._last_counts[name] = snap[name]
        for name, lrows in events.labeled_snapshot().items():
            for lr in lrows:
                key = (name,) + tuple(sorted(lr["labels"].items()))
                d = lr["value"] - self._last_lcounts.get(key, 0)
                if d:
                    ldeltas[key] = d
                    if not name.startswith(self.SELF_PREFIXES):
                        row("counter", name, d, labels=lr["labels"],
                            total=lr["value"])
                self._last_lcounts[key] = lr["value"]

        # percentile summaries of the ring's CURRENT window — only
        # for series that SAW samples this tick (the companion
        # '<name>.n' counter moved): an idle process must quiesce,
        # not append identical windows forever (which would also
        # flood anomaly baselines with duplicates, driving MAD to 0)
        for name, p in events.latency_snapshot(pcts=(50, 90, 99)) \
                .items():
            if p and deltas.get(name + ".n"):
                row("pct", name, p.get("p99", 0), p50=p.get("p50"),
                    p90=p.get("p90"), p99=p.get("p99"), n=p.get("n"))
        for name, lrows in events.labeled_latency_snapshot(
                pcts=(50, 90, 99)).items():
            for lr in lrows:
                key = (name + ".n",) + tuple(sorted(
                    lr["labels"].items()))
                if not ldeltas.get(key):
                    continue
                row("pct", name, lr.get("p99", 0),
                    labels=lr["labels"], p50=lr.get("p50"),
                    p90=lr.get("p90"), p99=lr.get("p99"),
                    n=lr.get("n"))

        # cost rows that moved since the last tick: the persisted
        # measured-cost substrate (ROADMAP item 2's autotuner input)
        try:
            from . import costs as _costs
            for r in _costs.table():
                key = r["key"]
                if self._last_invocations.get(key) == r["invocations"] \
                        and key in self._last_invocations:
                    continue
                self._last_invocations[key] = r["invocations"]
                extra = {f: r[f] for f in
                         ("argument_bytes", "output_bytes",
                          "temp_bytes", "pool_bytes") if f in r}
                row("cost", r["label"], r["invocations"],
                    labels={"kind": r["kind"]},
                    flops=r["flops"],
                    bytes_accessed=r["bytes_accessed"],
                    invocations=r["invocations"],
                    compile_wall_s=r["compile_wall_s"],
                    analyzed=bool(r.get("analyzed")), **extra)
        except Exception:           # noqa: BLE001 — cost attribution
            pass                    # is best-effort, never a blocker
        return self.append_rows(rows)

    def flush(self):
        """Durability point (trainers call this at checkpoint
        boundaries): appends already hit the OS on write; this exists
        so callers have an explicit barrier to order against."""
        return self.path


# -- module-level singleton --------------------------------------------
_WRITER = None
_WLOCK = threading.Lock()


def get_writer() -> HistoryWriter:
    """The process-wide writer (created on first use; its run id is
    fixed for the process lifetime)."""
    global _WRITER
    w = _WRITER
    if w is None:
        with _WLOCK:
            if _WRITER is None:
                _WRITER = HistoryWriter()
            w = _WRITER
    return w


def record(kind, name, value, labels=None, **fields):
    """One row through the process writer (no-op when disabled)."""
    if not enabled():
        return 0
    return get_writer().append(kind, name, value, labels=labels,
                               **fields)


def note_event(name, **fields):
    """Durable run marker (checkpoint / rollback / preemption / mesh
    transition): survives the process where the flight-recorder ring
    does not.  No-op when disabled."""
    if not enabled():
        return 0
    return get_writer().append("marker", name, 1.0, **fields)


def record_fleet(replicas, step=None, stragglers=()):
    """Per-replica fleet rows from the rank-0 merge (`FleetTelemetry`
    calls this at its publish cadence); "step" is the merge round, the
    replica's own step is kept as "replica_step".  No-op when
    disabled."""
    if not enabled() or not replicas:
        return 0
    w = get_writer()
    slow = {str(s) for s in (stragglers or ())}
    rows = []
    now = time.time()
    for rid, fr in replicas.items():
        r = dict(fr, replica_step=fr.get("step"))
        r.update(ts=now, run=w.run, kind="fleet", name="replica",
                 v=float(fr.get("step_us", 0)),
                 labels={"replica": str(rid)},
                 straggler=str(rid) in slow)
        if step is not None:
            r["step"] = int(step)
        rows.append(r)
    return w.append_rows(rows)


def tick(now=None):
    """One exporter tick's history batch (no-op when disabled)."""
    if not enabled():
        return 0
    return get_writer().tick(now=now)


def flush():
    if _WRITER is not None:
        return _WRITER.flush()
    return None


def reset():
    """Drop the process writer (tests: a new MXNET_HISTORY_DIR or run
    id takes effect on next use)."""
    global _WRITER
    with _WLOCK:
        _WRITER = None


# -- reading -----------------------------------------------------------
def _shards(directory):
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith("history-")
                       and n.endswith(".jsonl"))
    except OSError:
        return []
    return [os.path.join(directory, n) for n in names]


def runs(directory=None):
    """Run ids with shards in the directory, oldest first: by the
    second-resolution start timestamp the name embeds, ties (two
    processes started in the same second — the pid suffix encodes no
    order) broken by the shard's mtime, so the most recently WRITING
    run sorts newest for `blackbox history --diff`'s default pair."""
    d = directory if directory is not None else history_dir()
    entries = []
    for p in _shards(d):
        rid = os.path.basename(p)[len("history-"):-len(".jsonl")]
        try:
            mt = os.stat(p).st_mtime
        except OSError:
            mt = 0.0
        entries.append((rid.split("-p")[0], mt, rid))
    entries.sort()
    return [rid for _, _, rid in entries]


def query(name=None, labels=None, since=None, run=None, kind=None,
          directory=None, limit=None):
    """Read matching rows across every shard (i.e. across runs) in the
    history directory, oldest first.

    name:   row-name PREFIX (``"serve.infer"`` matches the per-bucket
            ``serve.infer:demo[0]`` cost rows; None = all)
    labels: subset match — a row matches when it carries AT LEAST
            these label pairs
    since:  minimum ``ts`` (epoch seconds)
    run:    restrict to one run id (default: all runs)
    kind:   restrict to one row kind ("counter"/"pct"/"cost"/...)
    limit:  keep only the NEWEST N matches

    Malformed lines (a run killed mid-write) are skipped, never
    raised."""
    d = directory if directory is not None else history_dir()
    if not d:
        return []
    want = {str(k): str(v) for k, v in (labels or {}).items()}
    out = []
    for path in _shards(d):
        if run is not None and ("history-%s.jsonl" % run) != \
                os.path.basename(path):
            continue
        try:
            with open(path) as f:
                lines = f.read().splitlines()
        except OSError:
            continue
        for ln in lines:
            if not ln:
                continue
            try:
                row = json.loads(ln)
            except ValueError:
                continue            # torn tail line of a killed run
            if kind is not None and row.get("kind") != kind:
                continue
            if name is not None and \
                    not str(row.get("name", "")).startswith(str(name)):
                continue
            if since is not None and row.get("ts", 0) < float(since):
                continue
            if want:
                have = row.get("labels") or {}
                if any(have.get(k) != v for k, v in want.items()):
                    continue
            out.append(row)
    out.sort(key=lambda r: (r.get("ts", 0), r.get("run", "")))
    if limit is not None:
        out = out[-int(limit):]
    return out
