"""Retries of transient failures in the PyTorch port: `retry_transient`,
a copy of incubator_mxnet_tpu/parallel/resilience.py's.  The generation
engine retries an injected transient fault of its decode step through
it, before the step's replay.

Left out: `ResilientTrainer` (guarded steps, checkpoints, preemption),
which rides on the JAX package's sharded trainer.
"""
from __future__ import annotations

import logging
import random
import time

from .. import config
from .. import fault
from ..monitor import events

__all__ = ["retry_transient"]

log = logging.getLogger(__name__)


def retry_transient(fn, retries=None, backoff=None, what="operation",
                    retryable=(fault.TransientFault, OSError),
                    non_retryable=(), event="resilience.retry",
                    jitter=True):
    """Call `fn()`, retrying `retries` times with JITTERED exponential
    backoff on transient failures: the window doubles per attempt and
    each sleep is drawn uniformly from [window/2, window], so a fleet
    of workers tripped by the same storage/collective blip does not
    retry in lockstep (the thundering herd that turns one blip into
    three).  `backoff` seeds the window; when None it comes from
    MXNET_RETRY_BACKOFF_MS (milliseconds, when > 0) else
    MXNET_RETRY_BACKOFF (seconds).  `jitter=False` sleeps the full
    window deterministically (tests).  Each retry increments `event`
    on monitor.events (callers pick their own counter so concurrent
    retries in different subsystems don't pollute each other).

    `non_retryable` carves permanent failures out of the retryable
    families: an exception matching it is re-raised immediately even
    when it also matches `retryable`."""
    if retries is None:
        retries = int(config.get("MXNET_RETRY_MAX"))
    if backoff is None:
        ms = float(config.get("MXNET_RETRY_BACKOFF_MS"))
        backoff = ms / 1e3 if ms > 0 else \
            float(config.get("MXNET_RETRY_BACKOFF"))
    attempt = 0
    while True:
        try:
            return fn()
        except retryable as e:
            if non_retryable and isinstance(e, non_retryable):
                raise               # permanent: fail fast, loudly
            attempt += 1
            if attempt > retries:
                raise
            events.incr(event)
            delay = backoff if not jitter else \
                random.uniform(backoff / 2.0, backoff)
            log.warning("%s failed (%s); retry %d/%d in %.3fs",
                        what, e, attempt, retries, delay)
            time.sleep(delay)
            backoff *= 2.0
