"""Telemetry of the PyTorch port (the parts of
incubator_mxnet_tpu/telemetry/ that the generation engine reports to):

- `telemetry.span(name, parent=ctx)`: thread-safe spans with explicit
  cross-thread parent propagation, into the profiler's trace sink and
  the flight recorder's ring; `TraceContext`, the global step and
  `emit_foreign` for spans of other processes (spans.py);
- `telemetry.flightrec`: the always-on bounded event ring and the
  black-box JSON dumps (flightrec.py);
- `telemetry.reqtrace`: per-request lifecycle journals with tail-based
  exemplars (reqtrace.py);
- `telemetry.costs`: one measured memory row per captured serving
  program (costs.py);
- `telemetry.history`: the durable on-disk metrics history (history.py);
- `telemetry.memwatch`: the per-device memory observatory, ledger
  against allocator (memwatch.py);
- `telemetry.slo`: declarative SLO rules and alerts (slo.py);
- `MetricsExporter`: Prometheus text and JSON export (export.py).

Switch spans on with `MXNET_TELEMETRY=1` or `telemetry.enable()`;
disabled, every span is a single bool read.

Left out: per-step training telemetry, the training side of the cost
registry (`MeteredJit`) and fleet views.
"""
from __future__ import annotations

from .spans import (SpanContext, TraceContext, current, emit_foreign, enable,
                    enabled, get_global_step, set_global_step, span)
from . import flightrec
from . import reqtrace
from . import costs
from . import history
from . import memwatch
from . import slo
from .export import MetricsExporter
from .flightrec import dump_blackbox, install_crash_hooks

__all__ = ["SpanContext", "TraceContext", "span", "current", "enable",
           "enabled", "emit_foreign", "set_global_step", "get_global_step",
           "flightrec", "reqtrace", "costs", "history", "memwatch", "slo",
           "MetricsExporter", "dump_blackbox",
           "install_crash_hooks"]
