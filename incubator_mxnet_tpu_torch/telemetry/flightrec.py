"""Flight recorder of the PyTorch port: an always-on bounded ring of
structured events and black-box JSON dumps (the core of
incubator_mxnet_tpu/telemetry/flightrec.py).

Subsystems append events to the ring unconditionally: span completions
(spans.py), injected faults (fault.py), the generation engine's slot
joins and retires and its step and join failures, and promoted request
exemplars (reqtrace.py).  `record()` is one enabled-check, one tuple
and one locked deque append; `MXNET_BLACKBOX=0` reduces every hook to a
single bool read.  `dump_blackbox()` writes the ring, the counter
ledger with its percentiles, the request journals and the config-knob
snapshot as one atomic JSON file; `crash_dump()` is its never-raising,
per-reason throttled form, which `install_crash_hooks()` wires into
`sys.excepthook`, `threading.excepthook` and SIGUSR2.

Left out: the JAX package's device-memory watermarks, executable cost
table, fleet, SLO, control-plane, autotune and memory-observatory
blocks of a dump, and `record_mesh`, whose producers are not ported.
"""
from __future__ import annotations

import itertools
import json
import os
import signal
import sys
import threading
import time
from collections import deque

from .. import config as _cfg
from ..monitor import events

__all__ = ["enabled", "record", "record_at", "ring_snapshot", "clear",
           "dump_blackbox", "crash_dump", "install_crash_hooks"]

SCHEMA = "mxtpu-blackbox/1"

_LOCK = threading.Lock()
_RING = None                    # deque of (ts, tid, kind, name, data)
_SEQ = itertools.count(1)       # CPython-atomic; dump filename ordinal
_CRASH_SEEN = {}                # reason -> last crash_dump monotonic time
#: min seconds between crash dumps for the same reason: a persistently
#: failing loop must not fill the disk with one dump per poll
CRASH_DUMP_MIN_GAP_S = 10.0

def enabled() -> bool:
    """Whether the flight recorder is on (default: yes — it exists for
    the runs nobody instrumented in advance)."""
    return bool(_cfg.get("MXNET_BLACKBOX"))


def _ring():
    global _RING
    r = _RING
    if r is None:
        with _LOCK:
            if _RING is None:
                _RING = deque(maxlen=max(
                    16, int(_cfg.get("MXNET_BLACKBOX_RING"))))
            r = _RING
    return r


def record(kind: str, name: str, **data):
    """Append one structured event to the ring.  The HOT path: one
    bool read disabled (checked HERE, before the clock read and the
    delegate call — the MXNET_BLACKBOX=0 contract); enabled, one
    tuple + one locked deque append — no formatting, no serialization
    until dump time."""
    if not enabled():
        return
    record_at(time.time(), kind, name, **data)


def record_at(ts: float, kind: str, name: str, **data):
    """`record()` with an explicit wall-clock stamp (a request
    exemplar is stamped at its admission, not at its retire)."""
    if not enabled():
        return
    ev = (float(ts), threading.get_ident(), kind, name, data or None)
    _ring()                         # ensure it exists (locks itself)
    with _LOCK:
        _RING.append(ev)


def clear():
    with _LOCK:
        if _RING is not None:
            _RING.clear()
        _CRASH_SEEN.clear()


def ring_snapshot(last=None):
    """The retained events, oldest first, as dicts (`last` keeps only
    the newest N)."""
    with _LOCK:
        evs = list(_RING) if _RING is not None else []
    if last is not None:
        evs = evs[-int(last):]
    out = []
    for ts, tid, kind, name, data in evs:
        d = {"ts": ts, "tid": tid % 100000, "kind": kind, "name": name}
        if data:
            d.update(data)
        out.append(d)
    return out


# -- dump --------------------------------------------------------------
def _exc_block(exc):
    if exc is None:
        return None
    import traceback
    try:
        tb = "".join(traceback.format_exception(
            type(exc), exc, getattr(exc, "__traceback__", None)))
    except Exception:               # noqa: BLE001
        tb = ""
    return {"type": type(exc).__name__,
            "message": str(exc)[:500],
            "traceback": tb[-8000:]}


def _config_snapshot():
    out = {}
    for name in _cfg.list_vars():
        try:
            v = _cfg.get(name)
            out[name] = v if isinstance(
                v, (bool, int, float, str, type(None))) else str(v)
        except Exception:           # noqa: BLE001
            out[name] = "<unreadable>"
    return out


def _chrome_view(evs):
    """The event timeline as chrome://tracing JSON: span events render
    as complete ('X') slices, everything else as instants."""
    out = []
    for e in evs:
        base = {"name": "%s:%s" % (e["kind"], e["name"]),
                "cat": e["kind"], "pid": e.get("pid") or os.getpid(),
                "tid": e["tid"]}
        dur = e.get("dur_us")
        if dur is not None:
            base.update(ph="X", ts=(e["ts"] * 1e6) - dur, dur=dur)
        else:
            base.update(ph="i", ts=e["ts"] * 1e6, s="t")
        args = {k: v for k, v in e.items()
                if k not in ("ts", "tid", "kind", "name")}
        if args:
            base["args"] = args
        out.append(base)
    return out


def _slug(s):
    return "".join(c if c.isalnum() or c in "-_." else "-"
                   for c in str(s))[:48] or "dump"


def _resolve_path(path, reason):
    if path:
        path = str(path)
        if not os.path.isdir(path):
            return path             # explicit file
        d = path
    else:
        # the temp dir, never the launch directory
        import tempfile
        d = _cfg.get("MXNET_BLACKBOX_DIR") or tempfile.gettempdir()
        os.makedirs(d, exist_ok=True)
    name = "blackbox-%s-p%d-%03d-%s.json" % (
        time.strftime("%Y%m%dT%H%M%S"), os.getpid(), next(_SEQ),
        _slug(reason))
    return os.path.join(d, name)


def dump_blackbox(path=None, reason="manual", exc=None, last=None):
    """Write the black box: config-knob snapshot, counter ledger and
    percentiles (labeled splits included), the request journals, the
    last-N event timeline and a chrome-trace view of it, as one atomic
    JSON file (tmp + os.replace).  `path` may be a file, a directory,
    or None (MXNET_BLACKBOX_DIR, else the system temp dir; auto-named).
    Returns the written path."""
    counters = events.snapshot()
    pcts = events.latency_snapshot()
    labeled = {"counters": events.labeled_snapshot(),
               "percentiles": events.labeled_latency_snapshot()}
    # the request journals: only when the engine side imported them
    rt_block = None
    rt_mod = sys.modules.get(__package__ + ".reqtrace")
    if rt_mod is not None:
        rt_block = rt_mod.block() or None
    evs = ring_snapshot(last=last)
    doc = {
        "schema": SCHEMA,
        "ts": time.time(),
        "pid": os.getpid(),
        "reason": str(reason),
        "exception": _exc_block(exc),
        "config": _config_snapshot(),
        "counters": counters,
        "percentiles": pcts,
        "labeled": labeled,
        "reqtrace": rt_block,
        "events": evs,
        "trace": {"traceEvents": _chrome_view(evs),
                  "displayTimeUnit": "ms"},
    }
    path = _resolve_path(path, reason)
    tmp = "%s.tmp.%d.%d" % (path, os.getpid(), threading.get_ident())
    with open(tmp, "w") as f:
        json.dump(doc, f, default=str)
    os.replace(tmp, path)
    events.incr("blackbox.dumps")
    record("dump", str(reason), path=path)
    return path


def crash_dump(reason, exc=None):
    """`dump_blackbox` for crash paths: never raises (a failing dump
    in an excepthook, a signal handler or the decode loop's backstop
    must not mask the original failure), and throttled per reason
    (CRASH_DUMP_MIN_GAP_S).  Returns the path,
    or None (disabled / throttled / failed)."""
    if not enabled():
        return None
    now = time.monotonic()
    with _LOCK:
        last = _CRASH_SEEN.get(reason)
        if last is not None and now - last < CRASH_DUMP_MIN_GAP_S:
            return None
        _CRASH_SEEN[reason] = now
    try:
        return dump_blackbox(reason=reason, exc=exc)
    except Exception:               # noqa: BLE001
        return None


# -- crash hooks -------------------------------------------------------
_HOOKS = {"installed": False, "sig_installed": False}


def install_crash_hooks(sigusr2=True):
    """Install the black-box triggers: `sys.excepthook` +
    `threading.excepthook` (CHAINED — the previous hooks still run
    after the dump) and, on the main thread, a SIGUSR2 handler (which
    REPLACES any previous one).  Idempotent, and each trigger arms
    independently: a first call off
    the main thread installs the excepthooks only, and a later
    main-thread call still arms SIGUSR2.  No-op (returns False) when
    the recorder is disabled."""
    if not enabled():
        return False
    did = False
    if not _HOOKS["installed"]:
        prev_sys = sys.excepthook
        prev_thread = threading.excepthook

        def _sys_hook(tp, val, tb):
            if not (tp is SystemExit or tp is KeyboardInterrupt):
                record("fault", "uncaught", where="main",
                       type=getattr(tp, "__name__", str(tp)))
                crash_dump("excepthook", val)
            (prev_sys or sys.__excepthook__)(tp, val, tb)

        def _thread_hook(args):
            if args.exc_type is not SystemExit:
                record("fault", "uncaught",
                       where=getattr(args.thread, "name", "?"),
                       type=getattr(args.exc_type, "__name__", "?"))
                crash_dump("threading.excepthook", args.exc_value)
            prev_thread(args)

        sys.excepthook = _sys_hook
        threading.excepthook = _thread_hook
        _HOOKS["installed"] = True
        did = True
    if sigusr2 and not _HOOKS["sig_installed"] \
            and hasattr(signal, "SIGUSR2"):
        def _usr2_work():
            record("marker", "sigusr2")
            crash_dump("sigusr2")

        def _on_usr2(signum, frame):
            # the handler interrupts the main thread BETWEEN bytecodes
            # — it may hold the ring lock mid-record(), so taking it
            # here would self-deadlock; hand the dump to a thread
            threading.Thread(target=_usr2_work, daemon=True,
                             name="BlackboxUSR2").start()
        try:
            signal.signal(signal.SIGUSR2, _on_usr2)
            _HOOKS["sig_installed"] = True
            did = True
        except (ValueError, OSError):   # not the main thread: a later
            pass                        # main-thread call retries
    return did
