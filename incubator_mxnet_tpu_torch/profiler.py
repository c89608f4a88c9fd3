"""Trace-event sink of the PyTorch port (the part of
incubator_mxnet_tpu/profiler.py that telemetry spans write to).

`set_state('run'|'stop')`, `add_trace_event`, and
`dump()`/`dumps()` over the collected events: `dump` writes
chrome://tracing JSON to `set_config(filename=...)`, `dumps` renders an
aggregate table.

Left out: the JAX package's op-dispatch listener (the port has no
dispatch engine to hook; a device timeline comes from `torch.profiler`),
`pause`/`resume`, the Task/Frame/Marker scopes, and
`start_jax_trace`/`stop_jax_trace`.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import defaultdict

__all__ = ["set_config", "set_state", "dump", "dumps", "add_trace_event"]

_CONFIG = {"filename": "profile.json"}
_STATE = {"running": False}
_EVENTS = []
_LOCK = threading.Lock()
_T0 = time.perf_counter()


def add_trace_event(name, cat, t0_s, dur_s, args=None, ph="X",
                    pid=None, tid=None):
    """Append one complete event to the chrome-trace sink.  `t0_s` is a
    `time.perf_counter()` stamp (converted to this module's trace
    origin), `dur_s` seconds; `pid`/`tid` override the event's process
    and thread row.  Dropped while the profiler is stopped: the sink is
    unbounded, and a span that merely started while it was collecting
    must not grow it afterwards."""
    if not _STATE["running"]:
        return
    ev = {"name": name, "cat": cat, "ph": ph,
          "ts": (t0_s - _T0) * 1e6, "dur": dur_s * 1e6,
          "pid": os.getpid() if pid is None else int(pid),
          "tid": (threading.get_ident() % 100000) if tid is None
          else int(tid)}
    if args:
        ev["args"] = dict(args)
    with _LOCK:
        _EVENTS.append(ev)


def set_config(**kwargs):
    _CONFIG.update(kwargs)


def set_state(state="stop", profile_process="worker"):
    """'run' starts collecting; anything else stops."""
    _STATE["running"] = state == "run"


def dump(finished=True, profile_process="worker"):
    with _LOCK:
        events = list(_EVENTS)
    with open(_CONFIG["filename"], "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return _CONFIG["filename"]


def dumps(reset=False, format="table", sort_by="total", ascending=False):
    """Aggregate per-name stats table of the collected events."""
    with _LOCK:
        events = list(_EVENTS)
        if reset:
            _EVENTS.clear()
    agg = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
    for e in events:
        rec = agg[e["name"]]
        rec[0] += 1
        rec[1] += e["dur"]
        rec[2] = min(rec[2], e["dur"])
        rec[3] = max(rec[3], e["dur"])
    rows = sorted(agg.items(),
                  key=lambda kv: kv[1][1] if sort_by == "total" else kv[1][0],
                  reverse=not ascending)
    lines = ["%-40s %8s %12s %12s %12s %12s" %
             ("Name", "Calls", "Total(us)", "Avg(us)", "Min(us)", "Max(us)")]
    for name, (n, total, mn, mx) in rows:
        lines.append("%-40s %8d %12.1f %12.1f %12.1f %12.1f"
                     % (name[:40], n, total, total / n, mn, mx))
    return "\n".join(lines)
