"""Per-step training telemetry of the PyTorch port (counterpart of
incubator_mxnet_tpu/telemetry/stepstats.py).

`StepTelemetry` turns one train step into the `train.*` ledger on
`monitor.events`:

    train.steps             steps recorded
    train.step_us           step wall (counter total + p50/p99 samples)
    train.data_wait_us      batch placement inside the step
    train.compute_us        from the step's launch to its loss and
                            verdict on the host (guarded steps read both
                            once a step, so the wall splits here)
    train.dispatch_us       launch wall where the loss stays on the card
    train.collective_us     collective wall where a caller measures it
    train.loss              loss samples (percentiles; no counter)
    train.steps_skipped     guarded steps whose update was not applied
    train.steps_compiling   steps that captured a new program (the
                            owning trainer's `captures` moved)
    train.checkpoint_us     checkpoint write wall

`ResilientTrainer` makes one when `telemetry.enabled()`; disabled, the
step pays one bool read.
"""
from __future__ import annotations

import math

from ..monitor import events

__all__ = ["StepTelemetry"]


class StepTelemetry:
    """Records per-step training telemetry onto an `EventCounters`
    ledger (default: the process-wide `monitor.events`).  `own_traces`
    is the owning trainer's capture count when it was made: captures
    before then do not mark the first recorded step as compiling."""

    def __init__(self, counters=None, own_traces=0):
        self._c = counters if counters is not None else events
        self._last_own = int(own_traces)
        self._last_global = self._c.get("train.traces")

    def record_step(self, loss=None, ok=True, wall_s=None,
                    data_wait_s=None, compute_s=None,
                    dispatch_s=None, collective_s=None, traces=None):
        """One step's telemetry.  Durations in seconds (None: not
        measured); `loss` a host float (NaN/None is no sample); `ok`
        False counts the step as skipped; `traces` the owning trainer's
        program count (else the process-wide ``train.traces``)."""
        c = self._c
        c.incr("train.steps")
        if wall_s is not None:
            c.observe_time("train.step_us", wall_s)
        if data_wait_s is not None:
            c.observe_time("train.data_wait_us", data_wait_s)
        if compute_s is not None:
            c.observe_time("train.compute_us", compute_s)
        if dispatch_s is not None:
            c.observe_time("train.dispatch_us", dispatch_s)
        if collective_s is not None:
            c.observe_time("train.collective_us", collective_s)
        if loss is not None and math.isfinite(loss):
            c.observe("train.loss", float(loss))
        if not ok:
            c.incr("train.steps_skipped")
        if traces is not None:
            if traces > self._last_own:
                c.incr("train.steps_compiling")
            self._last_own = traces
        else:
            g = c.get("train.traces")
            if g > self._last_global:
                c.incr("train.steps_compiling")
            self._last_global = g

    def record_checkpoint(self, seconds):
        self._c.observe_time("train.checkpoint_us", seconds)
