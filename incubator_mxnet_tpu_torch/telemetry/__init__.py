"""Telemetry of the PyTorch port (the parts of
incubator_mxnet_tpu/telemetry/ that the generation engine reports to):

- `telemetry.span(name, parent=ctx)`: thread-safe spans with explicit
  cross-thread parent propagation, into the profiler's trace sink and
  the flight recorder's ring (spans.py);
- `telemetry.flightrec`: the always-on bounded event ring and the
  black-box JSON dumps (flightrec.py);
- `telemetry.reqtrace`: per-request lifecycle journals with tail-based
  exemplars (reqtrace.py).

Switch spans on with `MXNET_TELEMETRY=1` or `telemetry.enable()`;
disabled, every span is a single bool read.

Left out: the metrics exporter, per-step training telemetry, the cost
registry, fleet views, durable history, SLO rules and the memory
observatory.
"""
from __future__ import annotations

from .spans import SpanContext, current, enable, enabled, span
from . import flightrec
from . import reqtrace
from .flightrec import dump_blackbox, install_crash_hooks

__all__ = ["SpanContext", "span", "current", "enable", "enabled",
           "flightrec", "reqtrace", "dump_blackbox",
           "install_crash_hooks"]
