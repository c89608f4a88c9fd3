"""Cross-thread spans of the PyTorch port (the core of
incubator_mxnet_tpu/telemetry/spans.py).

A span names one interval of framework work on a thread, such as a
generation request's prefill or one decode step:

    with telemetry.span("serve.decode_step"):
        ...

Spans carry a trace id and a span id, with explicit cross-thread parent
propagation (a request's submit and its prefill on the decode loop share
one trace):

    ctx = telemetry.current()           # submitting thread
    with telemetry.span("serve.prefill", parent=ctx):   # loop thread
        ...

With telemetry off (`MXNET_TELEMETRY=0`, the default) `span()` returns a
shared no-op: one bool read, no allocation.  On, a completed span goes
to the profiler's chrome-trace sink while it collects
(`profiler.set_state("run")`) and to the flight recorder's ring
whenever the recorder is armed.

Across processes: `TraceContext` is the serializable form of a span
context (trace id, span id, global step; `to_wire()`/`from_wire()`),
`set_global_step(step)` stamps every span completed while it is set, and
`emit_foreign(...)` records a completed span on behalf of another
process: a decode worker, which runs no telemetry, reports its decode
interval's wall clock in its batch message, and the consumer emits it
with the worker's pid, under the consumer's innermost open span.

Left out: `propagate` and `wall_of`, which serve the JAX package's fleet.
"""
from __future__ import annotations

import itertools
import os
import threading
import time

from .. import config as _cfg
from .. import profiler as _prof
from . import flightrec as _bb

__all__ = ["SpanContext", "TraceContext", "enabled", "enable", "span",
           "current", "set_global_step", "get_global_step", "emit_foreign"]

_ids = itertools.count(1)       # CPython-atomic next(); no lock needed
_tls = threading.local()

# per-process id salt: trace and span ids unique across processes
_PROC = "%08x" % ((os.getpid() << 12 ^ time.time_ns()) & 0xffffffff)


def _new_id(prefix):
    return "%s%s-%06x" % (prefix, _PROC, next(_ids))


# None = follow the MXNET_TELEMETRY knob live; enable() installs an
# explicit process-local override
_enabled = None


def enabled() -> bool:
    """Whether telemetry spans are switched on for this process."""
    if _enabled is not None:
        return _enabled
    return bool(_cfg.get("MXNET_TELEMETRY"))


def enable(flag=True):
    """Flip telemetry instrumentation on/off (None = revert to the
    MXNET_TELEMETRY knob); returns the previous effective state (so
    tests can restore it)."""
    global _enabled
    prev = enabled()
    _enabled = None if flag is None else bool(flag)
    return prev


class SpanContext:
    """Immutable (trace_id, span_id) handle for cross-thread parenting.
    Hand it to a worker thread and open child spans with
    ``span(name, parent=ctx)``."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def __repr__(self):
        return "SpanContext(trace=%s, span=%s)" % (self.trace_id,
                                                   self.span_id)


class TraceContext(SpanContext):
    """A span context that crosses a process boundary: (trace_id,
    span_id, global step).  `to_wire()` is a tuple of primitives, for a
    queue message or JSON; `from_wire()` rebuilds it, a valid `parent=`
    for `span()` and `emit_foreign()`."""

    __slots__ = ("step",)

    def __init__(self, trace_id: str, span_id: str, step=None):
        super().__init__(trace_id, span_id)
        self.step = None if step is None else int(step)

    def to_wire(self):
        return (self.trace_id, self.span_id, self.step)

    @classmethod
    def from_wire(cls, wire):
        """From `to_wire()`'s tuple (or a 2-tuple); None gives None."""
        if wire is None:
            return None
        t = tuple(wire)
        return cls(str(t[0]), str(t[1]), t[2] if len(t) > 2 else None)

    def __repr__(self):
        return "TraceContext(trace=%s, span=%s, step=%s)" % (
            self.trace_id, self.span_id, self.step)


# the process's global step id: every span completed while it is set
# carries it, so that traces of different processes meet on a step
_GSTEP = {"step": None}


def set_global_step(step):
    """Stamp `step` on every span completed from now on (None clears
    it); returns the previous value."""
    prev = _GSTEP["step"]
    _GSTEP["step"] = None if step is None else int(step)
    return prev


def get_global_step():
    """The current global step id (None when unset)."""
    return _GSTEP["step"]


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current():
    """The innermost open span's context on THIS thread (None outside
    any span, or when telemetry is disabled).  Capture it before
    handing work to another thread — that thread's spans pass it as
    `parent=` to join the same trace."""
    if not enabled():
        return None
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


class _NullSpan:
    """Shared no-op for the disabled path — `with` works, nothing is
    recorded, nothing is allocated per call."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def start(self):
        return self

    def stop(self):
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "ctx", "parent_id", "tags", "_t0")

    def __init__(self, name, parent, tags=None):
        if parent is None:
            parent = current()
        if parent is not None:
            trace = parent.trace_id
            self.parent_id = parent.span_id
        else:
            trace = _new_id("t")
            self.parent_id = None
        self.ctx = SpanContext(trace, _new_id("s"))
        self.name = name
        self.tags = tags
        self._t0 = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def start(self):
        self._t0 = time.perf_counter()
        _stack().append(self.ctx)
        return self

    def stop(self):
        if self._t0 is None:
            return
        t0, self._t0 = self._t0, None
        st = _stack()
        if st and st[-1] is self.ctx:
            st.pop()
        elif self.ctx in st:        # mispaired stop(): drop ours only
            st.remove(self.ctx)
        dur = time.perf_counter() - t0
        args = {"trace_id": self.ctx.trace_id,
                "span_id": self.ctx.span_id}
        if self.parent_id is not None:
            args["parent_id"] = self.parent_id
        step = _GSTEP["step"]
        if step is not None:
            args["step"] = step
        if self.tags:
            args.update(self.tags)
        # chrome sink: add_trace_event self-gates on the profiler state
        # (a span that STARTED while collecting must not grow the sink
        # after set_state('stop'))
        _prof.add_trace_event(self.name, "span", t0, dur, args=args)
        # flight-recorder ring: bounded, so span completions survive
        # into black-box dumps with no profiler running
        extra = dict(self.tags) if self.tags else {}
        if step is not None:
            extra["step"] = step
        _bb.record("span", self.name, dur_us=int(dur * 1e6),
                   trace=self.ctx.trace_id, span=self.ctx.span_id,
                   parent=self.parent_id, **extra)


def span(name: str, parent: SpanContext = None, **tags):
    """Open a span (use as a context manager, or `.start()`/`.stop()`).
    `parent` joins an existing trace across threads (a `SpanContext`);
    by default the innermost open span on this thread is the parent.
    Free-form `tags` (e.g. ``slot=3``) ride in the completion's args and
    ring record.  Returns a shared no-op when telemetry is disabled;
    enabled, the completion reaches the chrome sink and/or the
    flight-recorder ring per their own gates (see module docstring)."""
    if not enabled():
        return _NULL
    return _Span(name, parent, tags or None)


def emit_foreign(name, t0_wall, dur_s, parent=None, pid=None, tid=None,
                 **tags):
    """Record a completed span on behalf of another process: `t0_wall`
    is that process's `time.time()` at the start (wall time compares
    across processes of one host), `dur_s` seconds.  The span goes to
    the chrome sink in the process row `pid`, under `parent` (default:
    this thread's innermost open span), stamped with the global step,
    and to the ring at the interval's end.  Returns its `SpanContext`
    (None when telemetry is off)."""
    if not enabled():
        return None
    if parent is None:
        parent = current()
    if parent is not None:
        trace, parent_id = parent.trace_id, parent.span_id
    else:
        trace, parent_id = _new_id("t"), None
    ctx = SpanContext(trace, _new_id("s"))
    args = {"trace_id": trace, "span_id": ctx.span_id}
    if parent_id is not None:
        args["parent_id"] = parent_id
    step = _GSTEP["step"]
    if step is not None:
        args["step"] = step
    if tags:
        args.update(tags)
    # the foreign wall stamp on this process's perf_counter origin (the
    # chrome sink's time base): both clocks run at wall rate
    t0_perf = time.perf_counter() - max(0.0, time.time() - t0_wall)
    _prof.add_trace_event(name, "span", t0_perf, dur_s, args=args,
                          pid=pid, tid=tid)
    extra = dict(tags) if tags else {}
    if step is not None:
        extra["step"] = step
    if pid is not None:
        extra["pid"] = int(pid)
    _bb.record_at(t0_wall + dur_s, "span", name, dur_us=int(dur_s * 1e6),
                  trace=trace, span=ctx.span_id, parent=parent_id, **extra)
    return ctx
