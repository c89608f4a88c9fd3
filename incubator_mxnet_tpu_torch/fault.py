"""Deterministic fault injection of the PyTorch port (a copy of the
registry of incubator_mxnet_tpu/fault.py, stdlib only).

A fault is injected at a site, a plain string, at a chosen step number
or call ordinal, so that recovery paths run deterministically on the
CPU.  The sites the port reads:

    serve.enqueue       GenerationEngine.submit: the request is rejected
                        (QueueFull) at enqueue time
    serve.infer         GenerationEngine prefill (the request fails) and
                        decode step (TransientFault, retried through
                        `parallel.resilience.retry_transient` before the
                        step's replay)
    serve.decode_slow   GenerationEngine decode step: the step stalls
                        `seconds` but succeeds (deadline tests)
    serve.oom           GenerationEngine.warmup: raises TransientFault
                        with a "RESOURCE_EXHAUSTED" message
    io.read             RecordIO and reader paths (`MXRecordIO.read`,
                        the native reader, the decode service's pull):
                        raises InjectedIOError
    io.slow             the same reader paths: sleeps `seconds`
    io.corrupt          record readers (decode-service workers and the
                        threaded ImageRecordIter path; call ordinal =
                        record read): the payload gets one bit flipped
                        in flight (`flip_bits`), which the CRC sidecar
                        or the decoder catches and quarantines

Faults install programmatically::

    from incubator_mxnet_tpu_torch import fault
    fault.install("serve.decode_slow", steps=range(100), seconds=0.02)
    fault.install("serve.enqueue", at_calls=[2], times=1)

or from ``MXNET_FAULT_PLAN`` (`reset_from_config`), a semicolon-separated
spec: ``site@step`` for step-triggered faults and ``site#call`` for
call-ordinal faults, with an optional ``xN`` repeat and ``~S`` stall
seconds::

    MXNET_FAULT_PLAN="serve.infer@3;serve.enqueue#2x3"

The registry is process-local, thread-safe, and off unless something was
installed.

Left out: the JAX package's training, mesh and checkpoint sites and
`flip_file_bit`, which wait on the modules that read them.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

__all__ = ["InjectedFault", "TransientFault", "InjectedIOError", "install",
           "clear", "reset_from_config", "should_fire", "maybe_raise",
           "maybe_slow", "fired_count", "active_sites", "flip_bits"]


class InjectedFault(Exception):
    """Base class for every injected failure."""


class TransientFault(InjectedFault):
    """A failure the caller is expected to survive by retrying."""


class InjectedIOError(TransientFault, IOError):
    """An injected I/O failure: an IOError, so that `except (IOError,
    OSError)` handlers treat it as a real one."""


class _Fault:
    __slots__ = ("site", "steps", "at_calls", "times", "seconds",
                 "fired", "calls")

    def __init__(self, site, steps=None, at_calls=None, times=None,
                 seconds=0.0):
        self.site = site
        self.steps = set(int(s) for s in steps) if steps else None
        self.at_calls = set(int(c) for c in at_calls) if at_calls else None
        # default: step-triggered faults fire at every listed step;
        # call-triggered default to the listed ordinals only
        self.times = times
        self.seconds = float(seconds)
        self.fired = 0
        self.calls = 0


_LOCK = threading.Lock()
_FAULTS: Dict[str, List[_Fault]] = {}
_FIRED: Dict[str, int] = {}
# lock-free fast path: hot loops call should_fire on every step, and
# the disarmed case must be a plain attribute read, not a lock acquire
_ARMED = False


def install(site: str, steps=None, at_calls=None, times: Optional[int] = None,
            seconds: float = 0.0):
    """Arm a fault at `site`.

    steps:    step numbers at which the fault fires (the caller passes
              its current step to `should_fire`)
    at_calls: 1-based call ordinals at which the fault fires (for sites
              with no step context, e.g. serve.enqueue)
    times:    max total firings (None = unlimited within steps/at_calls)
    seconds:  stall duration for slow-I/O style sites
    """
    if steps is None and at_calls is None:
        at_calls = [1]
    f = _Fault(site, steps, at_calls, times, seconds)
    global _ARMED
    with _LOCK:
        _FAULTS.setdefault(site, []).append(f)
        _ARMED = True
    return f


def clear(site: Optional[str] = None):
    """Disarm one site, or everything (also zeroes firing counters)."""
    global _ARMED
    with _LOCK:
        if site is None:
            _FAULTS.clear()
            _FIRED.clear()
        else:
            _FAULTS.pop(site, None)
            _FIRED.pop(site, None)
        _ARMED = bool(_FAULTS)


def active_sites():
    with _LOCK:
        return sorted(_FAULTS)


def fired_count(site: str) -> int:
    with _LOCK:
        return _FIRED.get(site, 0)


def _parse_spec(spec: str):
    """``site@step`` / ``site#call`` entries, ``;``-separated, optional
    ``xN`` repeat and ``~S`` stall seconds: ``serve.decode_slow#1~0.2``."""
    out = []
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        idx = max(entry.rfind("@"), entry.rfind("#"))
        if idx < 1:
            raise ValueError(
                "bad MXNET_FAULT_PLAN entry %r: need site@step or "
                "site#call" % entry)
        site, sep, trig = entry[:idx], entry[idx], entry[idx + 1:]
        times, seconds = None, 0.0
        if "~" in trig:
            trig, sec = trig.rsplit("~", 1)
            seconds = float(sec)
        if "x" in trig:
            trig, n = trig.rsplit("x", 1)
            times = int(n)
        kw = dict(site=site, times=times, seconds=seconds)
        kw["steps" if sep == "@" else "at_calls"] = [int(trig)]
        out.append(kw)
    return out


def reset_from_config():
    """Clear the registry and re-arm from ``MXNET_FAULT_PLAN``.
    Returns the list of armed sites (empty plan = clean registry)."""
    from . import config
    clear()
    spec = config.get("MXNET_FAULT_PLAN") or ""
    for kw in _parse_spec(spec):
        install(**kw)
    return active_sites()


def should_fire(site: str, step: Optional[int] = None) -> bool:
    """True exactly when an armed fault at `site` matches this step /
    this call ordinal (and has firings left).  Consumes one firing and
    bumps the monitor's injected-fault counter when it does.

    A call-ordinal fault with a `times` budget fires on CONSECUTIVE
    calls starting at the ordinal (``serve.enqueue#2x3`` → calls 2, 3, 4
    fail) — the shape retry-budget tests need."""
    if not _ARMED:
        return False
    with _LOCK:
        faults = _FAULTS.get(site)
        if not faults:
            return False
        hit = None
        for f in faults:
            f.calls += 1
            if hit is not None or \
                    (f.times is not None and f.fired >= f.times):
                continue
            if f.steps is not None and step is not None and \
                    int(step) in f.steps:
                hit = f
            elif f.at_calls is not None and \
                    (f.calls in f.at_calls or
                     (f.times is not None and f.fired > 0)):
                hit = f
            if hit is not None:
                hit.fired += 1
                _FIRED[site] = _FIRED.get(site, 0) + 1
        if hit is None:
            return False
        seconds = hit.seconds
    from .monitor import events
    events.incr("fault.injected")
    try:
        # every injected fault is a flight-recorder marker: the dump
        # timeline shows WHAT was injected next to what broke
        from .telemetry import flightrec as _bb
        _bb.record("fault", site, step=step)
    except Exception:               # noqa: BLE001 — forensics must not
        pass                        # change fault-injection semantics
    if seconds:
        time.sleep(seconds)
    return True


def maybe_raise(site: str, step: Optional[int] = None,
                exc_type=TransientFault, msg: Optional[str] = None):
    """Raise `exc_type` if a fault at `site` fires (no-op otherwise)."""
    if should_fire(site, step):
        raise exc_type(msg or "injected fault at site %r (step %s)"
                       % (site, step))


def maybe_slow(site: str, step: Optional[int] = None):
    """Stall if a slow-I/O fault at `site` fires (its `seconds` already
    elapsed inside should_fire)."""
    should_fire(site, step)


def flip_bits(buf: bytes, seed: int = 0) -> bytes:
    """`buf` with one bit flipped at a deterministic position (the
    middle of the payload, moved by `seed`); empty input comes back
    empty."""
    if not buf:
        return buf
    b = bytearray(buf)
    pos = (len(b) // 2 + int(seed)) % len(b)
    b[pos] ^= 1 << (int(seed) % 8)
    return bytes(b)
