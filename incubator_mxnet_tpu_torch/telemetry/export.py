"""Metrics export surface of the PyTorch port (a copy of
incubator_mxnet_tpu/telemetry/export.py, which imports no JAX).

`MetricsExporter` renders the `monitor.events` ledger two ways:

- **Prometheus text format** (`prometheus_text()`):
  every counter as a `counter` metric, every observed sample series as a
  `summary` with p50/p90/p99 quantiles, `_sum` and `_count`; labeled
  splits as labeled children; plus the program cost rows
  (`telemetry.costs`), the ``alert_active`` gauge of every SLO rule,
  the worst request exemplar per (engine, lane) and the memory
  observatory's gauges.
- **JSON** (`json_dict()`, the periodic file).

Serving modes: `export_file(path)` (one atomic snapshot; `.prom`/`.txt`
→ text format, anything else → JSON); `start(path, period_s)` (a
background periodic export, each tick also sampling memwatch, writing a
history batch and evaluating the SLO rules).  `close()` joins.  The
JAX package's HTTP endpoint (`serve_http`) is not ported.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import weakref

from .. import config as _cfg
from ..monitor import events

__all__ = ["MetricsExporter"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(prefix, name):
    return _NAME_RE.sub("_", prefix + name)


def _fmt(v):
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


class MetricsExporter:
    """Render an `EventCounters` ledger (default: the process-wide
    `monitor.events`) as Prometheus text / JSON, with optional periodic
    file export."""

    def __init__(self, counters=None, prefix="mxnet_",
                 pcts=(50, 90, 99)):
        self._c = counters if counters is not None else events
        self._prefix = prefix
        self._pcts = tuple(pcts)
        self._t0 = time.time()
        self._stop = threading.Event()
        self._thread = None
        self._path = None

    # -- rendering -----------------------------------------------------
    def _snapshot(self):
        return self._c.snapshot(), self._c.latency_snapshot(
            pcts=self._pcts)

    @staticmethod
    def _escape_label(v):
        """Prometheus exposition label-value escaping: backslash,
        double quote and newline (an unescaped one invalidates the
        WHOLE scrape, not just the line)."""
        return (str(v).replace("\\", r"\\").replace('"', r"\"")
                .replace("\n", r"\n"))

    @classmethod
    def _labelstr(cls, labels, extra=None):
        """`{k="v",...}` for a labels dict (+ optional extra pairs),
        deterministically ordered; empty string for no labels."""
        items = sorted((labels or {}).items())
        if extra:
            items += list(extra.items())
        if not items:
            return ""
        return "{%s}" % ",".join(
            '%s="%s"' % (cls._escape_label(k), cls._escape_label(v))
            for k, v in items)

    @staticmethod
    def _cost_lines(prefix):
        """The executable cost registry (telemetry.costs) as labeled
        gauge families — flops / bytes-accessed / invocations /
        compile wall per registered executable."""
        from . import costs as _costs
        rows = _costs.table()
        if not rows:
            return []
        lines = []
        fams = (("executable_flops", "flops"),
                ("executable_bytes_accessed", "bytes_accessed"),
                ("executable_invocations", "invocations"),
                ("executable_compile_seconds", "compile_wall_s"))
        for fam, field in fams:
            m = _metric_name(prefix, fam)
            lines.append("# TYPE %s gauge" % m)
            for r in rows:
                # the registry key makes the labelset unique: two
                # trainers/engines in one process produce rows with
                # identical kind+label, and duplicate series make the
                # whole scrape unparseable to Prometheus
                lines.append('%s{kind="%s",label="%s",key="%d"} %s'
                             % (m,
                                MetricsExporter._escape_label(r["kind"]),
                                MetricsExporter._escape_label(r["label"]),
                                r["key"], _fmt(r[field])))
        return lines

    @staticmethod
    def _slo_lines(prefix):
        """The SLO alert gauge: one ``<prefix>alert_active``
        child per REGISTERED rule — 1 while firing, 0 while clear, so
        a scrape sees alerts clear (an active-only family would just
        go stale)."""
        from . import slo as _slo
        names = set(_slo.rules())
        active = set(_slo.active_alerts())
        if not names and not active:
            return []
        m = _metric_name(prefix, "alert_active")
        lines = ["# TYPE %s gauge" % m]
        for name in sorted(names | active):
            lines.append('%s{rule="%s"} %d'
                         % (m, MetricsExporter._escape_label(name),
                            1 if name in active else 0))
        return lines

    @staticmethod
    def _reqtrace_lines(prefix):
        """Exemplar annotations for the labeled latency summaries
       : per (engine, lane), the WORST promoted request
        exemplar rides the scrape as a gauge family whose labels name
        the request — rid, terminal status, dominant phase — so the
        dashboard showing a lane's p99 can link straight to the
        autopsy instead of a faceless quantile.  Guarded on reqtrace
        being ALREADY imported: a scrape never pulls the tracing
        layer in just to say 'no requests'."""
        import sys as _sys
        rt = _sys.modules.get(__package__ + ".reqtrace")
        if rt is None:
            return []
        worst = {}                  # (engine, lane) -> exemplar
        for ex in rt.exemplars():
            key = (ex.get("engine"), ex.get("lane"))
            if key not in worst or \
                    ex.get("e2e_us", 0) > worst[key].get("e2e_us", 0):
                worst[key] = ex
        if not worst:
            return []
        esc = MetricsExporter._escape_label
        m = _metric_name(prefix, "request_exemplar_e2e_us")
        mp = _metric_name(prefix, "request_exemplar_phase_us")
        lines = ["# TYPE %s gauge" % m]
        phase_lines = ["# TYPE %s gauge" % mp]
        for (engine, lane), ex in sorted(
                worst.items(), key=lambda kv: (str(kv[0][0]),
                                               str(kv[0][1]))):
            base = 'engine="%s",lane="%s"' % (esc(engine), esc(lane))
            lines.append(
                '%s{%s,rid="%s",status="%s",phase="%s"} %s'
                % (m, base, ex.get("rid"), esc(ex.get("status")),
                   esc(ex.get("dominant")), _fmt(ex.get("e2e_us", 0))))
            for ph, us in sorted((ex.get("phases") or {}).items()):
                phase_lines.append(
                    '%s{%s,rid="%s",phase="%s"} %s'
                    % (mp, base, ex.get("rid"), esc(ph), _fmt(us)))
        return lines + (phase_lines if len(phase_lines) > 1 else [])

    @staticmethod
    def _memwatch_lines(prefix):
        """The memory observatory as gauge families:
        ``<prefix>hbm_used_bytes{device=,source=}`` from the newest
        sample, ``<prefix>hbm_peak_bytes{device=,phase=}`` from the
        per-phase watermarks, and
        ``<prefix>hbm_committed_bytes{device=,tenant=}`` from the
        attribution join — so a dashboard plots committed vs measured
        vs peak on one axis.  Guarded on memwatch being ALREADY
        imported: a scrape never pulls the observatory in just to say
        'no samples'."""
        import sys as _sys
        mw = _sys.modules.get(__package__ + ".memwatch")
        if mw is None:
            return []
        smp = mw.last_sample()
        if smp is None:
            return []
        esc = MetricsExporter._escape_label
        lines = []
        m = _metric_name(prefix, "hbm_used_bytes")
        lines.append("# TYPE %s gauge" % m)
        for dev, d in sorted(smp.get("devices", {}).items()):
            lines.append('%s{device="%s",source="%s"} %s'
                         % (m, esc(dev), esc(d.get("source", "?")),
                            _fmt(d.get("used_bytes", 0))))
        marks = mw.watermarks()
        if marks:
            mp = _metric_name(prefix, "hbm_peak_bytes")
            lines.append("# TYPE %s gauge" % mp)
            for ph in sorted(marks):
                for dev, b in sorted(marks[ph].items()):
                    lines.append('%s{device="%s",phase="%s"} %s'
                                 % (mp, esc(dev), esc(ph), _fmt(b)))
        rows = mw.attribution()
        if rows:
            mc = _metric_name(prefix, "hbm_committed_bytes")
            lines.append("# TYPE %s gauge" % mc)
            for r in rows:
                lines.append('%s{device="%s",tenant="%s"} %s'
                             % (mc, esc(r.get("device")),
                                esc(r.get("tenant")),
                                _fmt(r.get("committed_bytes", 0))))
        return lines

    def prometheus_text(self) -> str:
        """Prometheus exposition text (version 0.0.4): counters +
        quantile summaries for every observed sample series (labeled
        tenant/lane splits render as labeled children of the same
        family), plus the per-executable cost families."""
        counts, lats = self._snapshot()
        lcounts = self._c.labeled_snapshot()
        llats = self._c.labeled_latency_snapshot(pcts=self._pcts)
        # an empty percentile dict (a reset() racing this scrape
        # between the snapshot's name collection and the per-name
        # percentiles) renders as a plain counter path, never KeyError
        sampled = {n for n, p in lats.items() if p}
        sampled |= {n for n, rows in llats.items() if rows}
        # sampled series render as summaries; their companion counters
        # (the same name = total µs, '<name>.n' = total observations)
        # fold into _sum/_count instead of repeating as bare counters
        folded = sampled | {n + ".n" for n in sampled}
        lines = []
        for name in sorted(set(counts) | sampled | set(lcounts)):
            if name in sampled:
                m = _metric_name(self._prefix, name)
                p = lats.get(name) or {}
                lines.append("# TYPE %s summary" % m)
                for pct in self._pcts:
                    if p:
                        lines.append('%s{quantile="%s"} %s'
                                     % (m, _fmt(pct / 100.0),
                                        _fmt(p["p%g" % pct])))
                    for row in llats.get(name, ()):
                        lines.append("%s%s %s" % (
                            m, self._labelstr(
                                row["labels"],
                                {"quantile": _fmt(pct / 100.0)}),
                            _fmt(row["p%g" % pct])))
                if name in counts:      # observe_time keeps the total
                    lines.append("%s_sum %s" % (m, _fmt(counts[name])))
                if p:
                    lines.append("%s_count %s"
                                 % (m, _fmt(counts.get(name + ".n",
                                                       p["n"]))))
                # labeled _count comes from the CUMULATIVE '<name>.n'
                # labelset counters, not the bounded ring window — a
                # window-size count plateaus at MAX_SAMPLES and reads
                # as rate()==0 to Prometheus while traffic flows
                lcum = {tuple(sorted(r["labels"].items())): r["value"]
                        for r in lcounts.get(name + ".n", ())}
                for row in llats.get(name, ()):
                    key = tuple(sorted(row["labels"].items()))
                    lines.append("%s_count%s %s"
                                 % (m, self._labelstr(row["labels"]),
                                    _fmt(lcum.get(key, row["n"]))))
            elif name not in folded:
                m = _metric_name(self._prefix, name)
                lines.append("# TYPE %s counter" % m)
                if name in counts:
                    lines.append("%s %s" % (m, _fmt(counts[name])))
                for row in lcounts.get(name, ()):
                    lines.append("%s%s %s"
                                 % (m, self._labelstr(row["labels"]),
                                    _fmt(row["value"])))
        if self._c is events:
            # the cost registry is process-wide state: it accompanies
            # the process ledger only — an exporter over a custom
            # EventCounters renders exactly those counters
            try:
                lines += self._cost_lines(self._prefix)
            except Exception:       # noqa: BLE001 — cost attribution
                pass                # must never break a scrape
            try:
                lines += self._slo_lines(self._prefix)
            except Exception:       # noqa: BLE001 — alerting must
                pass                # never break a scrape either
            try:
                lines += self._reqtrace_lines(self._prefix)
            except Exception:       # noqa: BLE001 — exemplars must
                pass                # never break a scrape either
            try:
                lines += self._memwatch_lines(self._prefix)
            except Exception:       # noqa: BLE001 — the memory
                pass                # observatory must not either
        return "\n".join(lines) + "\n"

    def json_dict(self) -> dict:
        counts, lats = self._snapshot()
        out = {"ts": time.time(),
               "uptime_s": round(time.time() - self._t0, 3),
               "counters": counts,
               "percentiles": lats}
        lcounts = self._c.labeled_snapshot()
        llats = self._c.labeled_latency_snapshot(pcts=self._pcts)
        if lcounts or llats:
            out["labeled"] = {"counters": lcounts,
                              "percentiles": llats}
        if self._c is events:
            try:
                from . import costs as _costs
                block = _costs.snapshot()
                if block["rows"]:
                    out["costs"] = block
            except Exception:       # noqa: BLE001
                pass
            # the SLO rule/alert state: teletop renders the
            # alert rows, and a scraped snapshot answers "is anything
            # firing" without the Prometheus surface
            try:
                from . import slo as _slo
                sblock = _slo.block()
                if sblock:
                    out["slo"] = sblock
            except Exception:       # noqa: BLE001
                pass
            # the request journals + promoted slow-request exemplars
            # — same already-imported guard
            try:
                import sys as _sys
                rt = _sys.modules.get(__package__ + ".reqtrace")
                if rt is not None:
                    rblock = rt.block()
                    if rblock:
                        out["reqtrace"] = rblock
            except Exception:       # noqa: BLE001
                pass
            # the memory observatory — same guard; teletop
            # renders the memory pane from this block
            try:
                import sys as _sys
                mw = _sys.modules.get(__package__ + ".memwatch")
                if mw is not None:
                    mblock = mw.block()
                    if mblock:
                        out["memwatch"] = mblock
            except Exception:       # noqa: BLE001
                pass
        return out

    def json_text(self) -> str:
        return json.dumps(self.json_dict(), sort_keys=True)

    # -- file export ---------------------------------------------------
    def export_file(self, path=None) -> str:
        """Write one snapshot atomically (tmp + os.replace).  `.prom` /
        `.txt` suffix → Prometheus text, anything else → JSON.
        Default path: MXNET_TELEMETRY_EXPORT_PATH."""
        path = path or self._path or _cfg.get("MXNET_TELEMETRY_EXPORT_PATH")
        if not path:
            raise ValueError("no export path (argument, start(), or "
                             "MXNET_TELEMETRY_EXPORT_PATH)")
        body = self.prometheus_text() \
            if path.endswith((".prom", ".txt")) else self.json_text()
        # pid+tid: the periodic worker and a manual/close-time export
        # in the same process must not interleave on one temp file
        tmp = "%s.tmp.%d.%d" % (path, os.getpid(),
                                threading.get_ident())
        with open(tmp, "w") as f:
            f.write(body)
        os.replace(tmp, path)
        return path

    @staticmethod
    def _export_loop(ref, stop, period):
        while not stop.wait(period):
            exp = ref()
            if exp is None:
                return
            try:
                exp.export_file()
            except Exception:           # noqa: BLE001 — periodic export
                pass                    # is best-effort, never fatal
            try:
                # the memory observatory samples at exactly this
                # cadence — tick time is its ONLY periodic
                # hook, so MXNET_MEMWATCH never touches a request or
                # step path
                from . import memwatch as _mw
                _mw.sample(tag="export")
            except Exception:           # noqa: BLE001
                pass
            # the durable layer rides the same cadence:
            # one history batch per tick, then the SLO rules judged
            # against the snapshots the batch just captured — both
            # off every hot path by construction.  SEPARATE guards:
            # a full/unwritable history disk raising every tick must
            # not also silence alerting — disk trouble is exactly
            # when the alerts are needed
            try:
                from . import history as _hist
                _hist.tick()
            except Exception:           # noqa: BLE001 — durability is
                pass                    # best-effort
            try:
                from . import slo as _slo
                _slo.evaluate()
            except Exception:           # noqa: BLE001 — and a broken
                pass                    # rule set must not kill export
            del exp

    def start(self, path=None, period_s=None):
        """Begin periodic file export every `period_s` seconds (default
        MXNET_TELEMETRY_EXPORT_S) to `path` (default
        MXNET_TELEMETRY_EXPORT_PATH).  Returns self (chainable)."""
        self._path = path or _cfg.get("MXNET_TELEMETRY_EXPORT_PATH")
        if not self._path:
            raise ValueError("periodic export needs a path (argument "
                             "or MXNET_TELEMETRY_EXPORT_PATH)")
        if period_s is None:
            period_s = float(_cfg.get("MXNET_TELEMETRY_EXPORT_S"))
        # (re)configure: retire any live worker (its Event flips, it
        # exits without a straggler export) and hand the NEW worker a
        # fresh Event with the new period — a second start() must
        # honor new args, and a start() after close() must not inherit
        # the already-set stop Event (the thread would exit on its
        # first wait without ever exporting)
        if (self._thread is not None and self._thread.is_alive()) \
                or self._stop.is_set():
            self._stop.set()
            self._stop = threading.Event()
        self._thread = threading.Thread(
            target=MetricsExporter._export_loop,
            args=(weakref.ref(self), self._stop, float(period_s)),
            daemon=True, name="TelemetryExport")
        self._thread.start()
        return self

    # -- lifecycle -----------------------------------------------------
    def close(self, timeout=5.0):
        """The export thread retires (after one final file snapshot when
        a path is configured).  Idempotent."""
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)
        self._thread = None
        if self._path:
            try:
                self.export_file()      # final state on disk
            except Exception:           # noqa: BLE001
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # flags only — never join threads from a finalizer; the daemon
        # worker sees the stop flag / dead weakref and retires
        self._stop.set()
