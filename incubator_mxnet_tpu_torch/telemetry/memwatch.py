"""Sampled per-device memory observatory of the PyTorch port (counterpart
of incubator_mxnet_tpu/telemetry/memwatch.py).

It joins what the ledgers COMMITTED (the `ModelRegistry` admission
ledger, any registered source) against what the allocator MEASURED:

- **Sampling.**  `sample()` reads each card's allocator statistics
  (`storage.memory_events`: ``torch.cuda.memory_stats`` allocated bytes,
  current and peak, and the card's total) and tags them
  ``source="memory_stats"``.  A CPU device has no allocator statistics:
  for the CPU devices of the live registries the probe sums the bytes of
  the tensors their engines hold (parameter copies, static buffers,
  caches), tagged ``source="sources"``, which mirrors the JAX package's
  ``live_arrays`` fallback and never runs for a card.  Samples land in a
  bounded ring (MXNET_MEMWATCH_RING) and update per-phase peak
  watermarks (warmup / steady / deploy); a watermark that rises writes a
  durable ``memwatch`` history row (telemetry/history.py).
  `set_sampler()` replaces the probe (tests).
- **Attribution.**  `attribution()` apportions each device's measured
  bytes to its tenants in proportion to their commitments (the live
  registries' ledger rows and the `register_source` rows); bytes nobody
  committed show up as an ``(unattributed)`` row.
- **Drift and OOM forensics.**  `slo.MemDriftRule` judges the
  attribution; `reconcile_tenant` re-reconciles a drifting model's
  ledger row.  `guard_oom(site, exc)` recognises an allocator failure
  (`torch.cuda.OutOfMemoryError`, the JAX package's RESOURCE_EXHAUSTED
  text, a host MemoryError), takes a forced sample and writes a
  black-box dump named ``memwatch:oom:<site>``.

``MXNET_MEMWATCH=0`` makes `sample()` a single bool read; enabled,
sampling happens at exporter-tick cadence, dump time and warmup/deploy
phase transitions, never per request.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import deque

import torch

from .. import config as _cfg
from ..monitor import events
from ..storage import device_key as _storage_key
from . import flightrec as _bb

__all__ = ["enabled", "set_sampler", "sample", "samples",
           "last_sample", "fresh_sample", "fresh_device_bytes",
           "watermarks", "set_phase", "current_phase", "phase",
           "register_source", "unregister_source", "committed_rows",
           "attribution", "top_consumers", "reconcile_tenant", "is_oom",
           "oom_dump", "guard_oom", "block", "reset", "device_key",
           "canon_device"]

#: the phases watermarks are kept per: deploys and warmups spike
#: transient working sets the steady envelope must not absorb
PHASES = ("warmup", "steady", "deploy")

#: text that marks an allocator out-of-memory failure: PyTorch's CUDA
#: allocator ("CUDA out of memory"), the JAX package's PJRT status, a
#: host allocation
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Resource exhausted",
                "out of memory", "Out of memory",
                "Unable to allocate", "MemoryError")

_REGISTRY_MODULE = __name__.rsplit(".", 2)[0] + ".serving.registry"

_LOCK = threading.Lock()
_RING = None                    # deque of sample dicts
_WATERMARKS = {}                # phase -> {device: peak used bytes}
_LAST = {"sample": None}        # newest sample (monotonic "mono" key)
_PHASE = ["steady"]             # current phase (list = mutable cell)
_SAMPLER = [None]               # injected probe for tests
_SOURCES = {}                   # name -> callable -> rows | None


def enabled() -> bool:
    """Whether the observatory is armed for this process."""
    return bool(_cfg.get("MXNET_MEMWATCH"))


def set_sampler(fn):
    """Install a probe override: ``fn()`` returns the per-device dict
    `sample()` would otherwise measure (``{device: {"used_bytes",
    "peak_bytes", "limit_bytes", "source"}}``).  None restores the real
    probe.  Returns the previous override."""
    prev = _SAMPLER[0]
    _SAMPLER[0] = fn
    return prev


# -- device naming -----------------------------------------------------
def device_key(dev) -> str:
    """Canonical ``type:index`` key of a device (``cuda:0``, ``cpu:0``)."""
    return _storage_key(dev)


def canon_device(name) -> str:
    """Normalize a device label to the ``type:index`` key (``cpu(0)``,
    ``cpu`` and ``cpu:0`` all name ``cpu:0``)."""
    s = str(name)
    if s.endswith(")") and "(" in s:
        head, _, tail = s.partition("(")
        return "%s:%s" % (head, tail[:-1])
    if ":" not in s and s in ("cpu", "cuda"):
        return s + ":0"
    return s


# -- sampling ----------------------------------------------------------
def _registries():
    reg_mod = sys.modules.get(_REGISTRY_MODULE)
    return reg_mod.live_registries() if reg_mod is not None else []


def _held_by_device():
    """{device key: bytes} of the distinct tensors every live registry's
    engines hold (storages counted once)."""
    seen, per_dev = set(), {}
    for reg in _registries():
        try:
            with reg._lock:
                entries = [e for e in reg._models.values()
                           if e is not None]
        except Exception:           # noqa: BLE001
            continue
        for e in entries:
            for t in e.engine.held_tensors():
                st = t.untyped_storage()
                key = (str(t.device), st.data_ptr())
                if key in seen:
                    continue
                seen.add(key)
                k = device_key(t.device)
                per_dev[k] = per_dev.get(k, 0) + int(st.nbytes())
    return per_dev


def _registry_devices():
    out = set()
    for reg in _registries():
        out.update(device_key(d) for d in reg._devices)
    return out


def _probe():
    """One real measurement: each card's allocator statistics, and the
    held-tensor sum for the registries' CPU devices.  A card whose
    statistics cannot be read raises: its bytes are never estimated."""
    from ..storage import memory_events
    devs = {}
    for s in memory_events():
        devs[s["device"]] = {
            "used_bytes": int(s["bytes_in_use"]),
            "peak_bytes": int(s.get("peak_bytes", 0)),
            "limit_bytes": int(s.get("bytes_limit", 0)),
            "source": "memory_stats"}
    missing = {k for k in _registry_devices() - set(devs)
               if k.startswith("cpu:")}
    if missing:
        held = _held_by_device()
        for k in sorted(missing):
            used = int(held.get(k, 0))
            devs[k] = {"used_bytes": used, "peak_bytes": used,
                       "limit_bytes": 0, "source": "sources"}
    return devs


def _ring():
    global _RING
    if _RING is None:
        with _LOCK:
            if _RING is None:
                _RING = deque(
                    maxlen=max(1, int(_cfg.get("MXNET_MEMWATCH_RING"))))
    return _RING


def sample(tag="sample", force=False, throttle=True):
    """Take one sample: per-device used/peak/limit bytes with their
    ``source``, stamped with the current phase.  Updates the per-phase
    watermarks (a rising watermark writes a ``memwatch`` history row)
    and appends to the ring.  Returns the sample, or None when disabled.

    Unforced calls within MXNET_MEMWATCH_MIN_S of the previous sample
    return that sample unchanged; ``force=True`` (OOM/dump path) and
    phase transitions (``throttle=False``) always probe."""
    if not (enabled() or force):
        return None
    if throttle and not force:
        min_s = float(_cfg.get("MXNET_MEMWATCH_MIN_S"))
        with _LOCK:
            last = _LAST["sample"]
        if last is not None and min_s > 0 \
                and time.monotonic() - last.get("mono", 0) < min_s:
            return last
    probe = _SAMPLER[0] or _probe
    try:
        devs = probe() or {}
    except Exception:               # noqa: BLE001 — the observatory
        return None                 # must never take the run down
    ph = _PHASE[0]
    s = {"ts": time.time(), "mono": time.monotonic(), "phase": ph,
         "tag": str(tag), "devices": devs,
         "total_bytes": sum(d.get("used_bytes", 0)
                            for d in devs.values())}
    rose = []
    ring = _ring()
    with _LOCK:
        marks = _WATERMARKS.setdefault(ph, {})
        for dev, d in devs.items():
            used = int(d.get("used_bytes", 0))
            if used > marks.get(dev, 0):
                marks[dev] = used
                rose.append((dev, used, d.get("source", "?")))
        ring.append(s)
        _LAST["sample"] = s
    events.incr("memwatch.samples")
    for dev, used, src in rose:
        try:
            from . import history as _hist
            _hist.record("memwatch", "watermark", float(used),
                         labels={"device": dev, "phase": ph,
                                 "source": str(src)})
        except Exception:           # noqa: BLE001 — best-effort
            pass
    return s


def samples():
    """The retained samples, oldest first."""
    with _LOCK:
        return list(_RING) if _RING is not None else []


def last_sample():
    """The newest sample (None before the first)."""
    with _LOCK:
        return _LAST["sample"]


def fresh_sample(max_age_s=None):
    """The newest sample if younger than ``max_age_s``
    (MXNET_MEMWATCH_FRESH_S), else None."""
    s = last_sample()
    if s is None:
        return None
    if max_age_s is None:
        max_age_s = float(_cfg.get("MXNET_MEMWATCH_FRESH_S"))
    if time.monotonic() - s.get("mono", 0.0) > max_age_s:
        return None
    return s


def fresh_device_bytes(max_age_s=None):
    """{device: measured used bytes} from a fresh sample, else None."""
    s = fresh_sample(max_age_s)
    if s is None:
        return None
    return {dev: int(d.get("used_bytes", 0))
            for dev, d in s["devices"].items()}


def watermarks() -> dict:
    """{phase: {device: peak used bytes}} observed so far."""
    with _LOCK:
        return {ph: dict(m) for ph, m in _WATERMARKS.items()}


# -- phases ------------------------------------------------------------
def set_phase(name):
    """Set the current phase; returns the previous one."""
    prev = _PHASE[0]
    _PHASE[0] = str(name)
    return prev


def current_phase() -> str:
    return _PHASE[0]


@contextlib.contextmanager
def phase(name):
    """Scope a phase: watermarks taken inside attribute to ``name``, and
    one sample is taken on exit (never throttled)."""
    prev = set_phase(name)
    try:
        yield
    finally:
        try:
            sample(tag="phase:%s" % name, throttle=False)
        except Exception:           # noqa: BLE001
            pass
        set_phase(prev)


# -- attribution -------------------------------------------------------
def register_source(name, fn):
    """Register a committed-bytes source: ``fn()`` returns rows
    ``{"tenant", "device", "committed_bytes", ...}`` (or None to
    unregister itself)."""
    with _LOCK:
        _SOURCES[str(name)] = fn


def unregister_source(name):
    with _LOCK:
        _SOURCES.pop(str(name), None)


def _registry_rows():
    """One committed row per (model, device) of every live registry at
    its ledger footprint, with the admission basis, the measured
    program bytes (`costs.footprint_bytes`) and a generator's KV split."""
    from . import costs as _costs
    rows = []
    for reg in _registries():
        try:
            with reg._lock:
                entries = [e for e in reg._models.values()
                           if e is not None]
                devices = list(reg._devices)
        except Exception:           # noqa: BLE001
            continue
        for e in entries:
            aot = 0
            try:
                aot = max(_costs.footprint_bytes(fam, kind="serve")
                          for fam in e.cost_labels)
            except Exception:       # noqa: BLE001
                pass
            kv = None
            kv_fn = getattr(e.engine, "kv_cache_bytes", None)
            if callable(kv_fn):
                try:
                    kv = kv_fn()
                except Exception:   # noqa: BLE001
                    kv = None
            for i in e.devices:
                row = {"tenant": e.name,
                       "device": device_key(devices[i]),
                       "committed_bytes": int(e.footprint),
                       "kind": "serve", "basis": e.basis,
                       "origin": "registry"}
                if aot:
                    row["aot_bytes"] = int(aot)
                if kv:
                    row["kv_bytes"] = int(kv.get("total", 0))
                    row["kv_slots"] = int(kv.get("slots", 0))
                rows.append(row)
    return rows


def committed_rows():
    """Every committed-bytes row the observatory can see: registered
    sources first (unregistered when they return None), then the live
    registries' ledgers."""
    with _LOCK:
        srcs = list(_SOURCES.items())
    rows, dead = [], []
    for name, fn in srcs:
        try:
            r = fn()
        except Exception:           # noqa: BLE001
            continue
        if r is None:
            dead.append(name)
            continue
        for x in r:
            rows.append(dict(x, origin=x.get("origin", name)))
    for name in dead:
        unregister_source(name)
    rows.extend(_registry_rows())
    return rows


def attribution(smp=None, top=None, rows=None):
    """Join a sample against the committed rows: each device's measured
    bytes are apportioned to its tenants in proportion to their
    commitments (``measured_bytes``, ``drift`` = measured/committed);
    measured bytes nobody committed become an ``(unattributed)`` row.
    Biggest consumer first; ``top`` caps the list.  [] before the first
    sample."""
    smp = smp if smp is not None else last_sample()
    if not smp:
        return []
    rows = committed_rows() if rows is None else list(rows)
    by_dev = {}
    for r in rows:
        by_dev.setdefault(canon_device(r.get("device")), []).append(r)
    out = []
    for dev, d in sorted(smp.get("devices", {}).items()):
        measured = int(d.get("used_bytes", 0))
        src = d.get("source", "?")
        drows = by_dev.get(dev, [])
        committed = sum(int(r.get("committed_bytes", 0)) for r in drows)
        for r in drows:
            c = int(r.get("committed_bytes", 0))
            share = (measured * c // committed) if committed > 0 else 0
            out.append(dict(
                r, device=dev, measured_bytes=int(share),
                drift=(round(share / c, 4) if c > 0 else None),
                device_used_bytes=measured, source=src))
        if not drows and measured > 0:
            out.append({"tenant": "(unattributed)", "device": dev,
                        "committed_bytes": 0, "measured_bytes": measured,
                        "drift": None, "device_used_bytes": measured,
                        "kind": "?", "origin": "memwatch",
                        "source": src})
    out.sort(key=lambda r: -r.get("measured_bytes", 0))
    if top is not None:
        out = out[:max(1, int(top))]
    return out


def top_consumers(n=None, smp=None, rows=None):
    """{tenant@device: measured bytes} of the top-N attribution rows."""
    if n is None:
        n = int(_cfg.get("MXNET_MEMWATCH_TOP"))
    return {"%s@%s" % (r["tenant"], r["device"]):
            int(r.get("measured_bytes", 0))
            for r in attribution(smp=smp, top=n, rows=rows)}


def reconcile_tenant(tenant) -> bool:
    """Re-reconcile a drifting tenant's ledger row on every live registry
    hosting it (`ModelRegistry.reconcile`).  True if any registry knew
    the tenant."""
    hit = False
    for reg in _registries():
        try:
            with reg._lock:
                known = reg._models.get(tenant) is not None
            if known:
                reg.reconcile(tenant)
                hit = True
        except Exception:           # noqa: BLE001 — best-effort
            continue
    return hit


# -- OOM forensics -----------------------------------------------------
def is_oom(exc) -> bool:
    """Whether an exception is an allocator out-of-memory failure
    (`torch.cuda.OutOfMemoryError`, a host MemoryError, or the text of
    one, the JAX package's RESOURCE_EXHAUSTED included)."""
    if exc is None:
        return False
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    text = "%s: %s" % (type(exc).__name__, exc)
    return any(m in text for m in _OOM_MARKERS)


def oom_dump(site, exc=None):
    """One forced sample, an ``oom`` ring event naming the site, then a
    black-box dump ``memwatch:oom:<site>``.  Never raises; returns the
    dump path (None = disabled/throttled)."""
    try:
        sample(tag="oom", force=True)
    except Exception:               # noqa: BLE001
        pass
    events.incr("memwatch.oom")
    events.incr("memwatch.oom", labels={"site": str(site)})
    _bb.record("memwatch", "oom", site=str(site),
               error=type(exc).__name__ if exc is not None else None)
    return _bb.crash_dump("memwatch:oom:%s" % site, exc)


def guard_oom(site, exc) -> bool:
    """`oom_dump` iff `is_oom(exc)`; returns whether it was an OOM
    (callers re-raise either way)."""
    if not is_oom(exc):
        return False
    oom_dump(site, exc)
    return True


# -- surfaces ----------------------------------------------------------
def _recent_lifecycle_events(last=16):
    names = ("admitted", "evicted", "version_admitted",
             "footprint_reconciled", "footprint_reconcile_large",
             "admission_rejected", "resized", "version_promoted",
             "version_rolled_back")
    out = [e for e in _bb.ring_snapshot()
           if e.get("kind") == "serve" and e.get("name") in names]
    return out[-int(last):]


def block() -> dict:
    """The ``memwatch`` block for dumps and /metrics.json: newest sample,
    per-phase watermarks, the attribution join and the recent lifecycle
    events.  {} before the first sample."""
    s = last_sample()
    if s is None:
        return {}
    top = int(_cfg.get("MXNET_MEMWATCH_TOP"))
    return {"phase": current_phase(),
            "sample": {k: v for k, v in s.items() if k != "mono"},
            "fresh": fresh_sample() is not None,
            "watermarks": watermarks(),
            "attribution": attribution(top=max(top, 8)),
            "events": _recent_lifecycle_events()}


def reset():
    """Drop every sample, watermark, source and override (tests)."""
    global _RING
    with _LOCK:
        _RING = None
        _WATERMARKS.clear()
        _LAST["sample"] = None
        _SOURCES.clear()
    _PHASE[0] = "steady"
    _SAMPLER[0] = None
