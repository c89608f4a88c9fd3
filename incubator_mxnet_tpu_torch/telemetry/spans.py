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

Left out: the JAX package's cross-process `TraceContext`, `propagate`,
the global step stamp and `emit_foreign`, which serve its multi-process
fleet.
"""
from __future__ import annotations

import itertools
import os
import threading
import time

from .. import config as _cfg
from .. import profiler as _prof
from . import flightrec as _bb

__all__ = ["SpanContext", "enabled", "enable", "span", "current"]

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
        if self.tags:
            args.update(self.tags)
        # chrome sink: add_trace_event self-gates on the profiler state
        # (a span that STARTED while collecting must not grow the sink
        # after set_state('stop'))
        _prof.add_trace_event(self.name, "span", t0, dur, args=args)
        # flight-recorder ring: bounded, so span completions survive
        # into black-box dumps with no profiler running
        extra = dict(self.tags) if self.tags else {}
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
