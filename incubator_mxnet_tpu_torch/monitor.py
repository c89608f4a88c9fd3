"""Event counters of the PyTorch port (the `events` ledger of
incubator_mxnet_tpu/monitor.py, stdlib only).

`events` holds named monotonic counters, labeled counters and bounded
per-name sample rings with nearest-rank percentiles.  The generation
engine (`serving.generation`), the fault registry (`fault`) and the
retry helper (`parallel.resilience`) report here.

Left out: the JAX package's training `Monitor`, which stats tensors at
executable boundaries of its `Module` API (not ported).
"""
from __future__ import annotations

import threading
from collections import deque

__all__ = ["EventCounters", "events"]


class EventCounters:
    """Named monotonic counters, and latency samples kept so that
    p50/p99 are recoverable (`percentiles`/`latency_snapshot`):
    counters alone only give means, and serving SLOs are tail-defined.

    `incr`/`observe` take an optional `labels=` dict: the sample lands
    in a per-labelset ring (and the count on a per-labelset counter)
    next to, never instead of, the unlabeled aggregate the caller
    maintains.  At most `MAX_LABELSETS` distinct labelsets are kept per
    name; the overflow folds into a reserved `{"overflow": "true"}` set.

    Thread-safe; process-local.
    """

    #: per-name latency sample retention (ring buffer) — bounds memory
    #: on long-lived serving hosts while keeping p99 over a recent
    #: window meaningful
    MAX_SAMPLES = 4096
    #: distinct labelsets retained per name — tenant/lane splits are
    #: useful at dashboard cardinality, not at unbounded-userbase
    #: cardinality; excess folds into {"overflow": "true"}
    MAX_LABELSETS = 64
    _OVERFLOW = (("overflow", "true"),)

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = {}
        self._samples = {}
        self._lcounts = {}      # name -> {labelkey: int}
        self._lsamples = {}     # name -> {labelkey: deque}

    @staticmethod
    def _labelkey(labels):
        return tuple(sorted((str(k), str(v)) for k, v in labels.items()))

    def _fold(self, per_name, key):
        """Bound labelset cardinality: a NEW key past MAX_LABELSETS
        lands on the reserved overflow set (callers hold self._lock)."""
        if key in per_name or len(per_name) < self.MAX_LABELSETS:
            return key
        return self._OVERFLOW

    def incr(self, name: str, n: int = 1, labels: dict = None) -> int:
        with self._lock:
            if labels:
                per = self._lcounts.setdefault(name, {})
                key = self._fold(per, self._labelkey(labels))
                per[key] = per.get(key, 0) + int(n)
                return per[key]
            self._counts[name] = self._counts.get(name, 0) + int(n)
            return self._counts[name]

    def add_time(self, name: str, seconds: float) -> int:
        """Accumulate a wall-clock interval on an integer-microsecond
        counter (convention: the name ends in `_us`)."""
        return self.incr(name, int(seconds * 1e6))

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    # -- latency samples / percentiles ---------------------------------
    def observe(self, name: str, value: float, labels: dict = None) \
            -> None:
        """Record one sample (convention: microseconds, name ends in
        `_us`) into a bounded per-name ring buffer; `incr`s the
        companion counter `<name>.n` so sample flow is visible in plain
        snapshots too.  With `labels=` the sample lands in that
        labelset's OWN ring (and `<name>.n` counter) instead — callers
        keep the unlabeled aggregate themselves, so a labeled observe
        is a split, not a double-count."""
        with self._lock:
            if labels:
                per = self._lsamples.setdefault(name, {})
                key = self._fold(per, self._labelkey(labels))
                dq = per.get(key)
                if dq is None:
                    dq = per[key] = deque(maxlen=self.MAX_SAMPLES)
                dq.append(float(value))
                cper = self._lcounts.setdefault(name + ".n", {})
                cper[key] = cper.get(key, 0) + 1
                return
            dq = self._samples.get(name)
            if dq is None:
                dq = self._samples[name] = deque(maxlen=self.MAX_SAMPLES)
            dq.append(float(value))
            self._counts[name + ".n"] = \
                self._counts.get(name + ".n", 0) + 1

    def observe_time(self, name: str, seconds: float,
                     labels: dict = None) -> None:
        """`observe` a wall-clock interval in integer microseconds AND
        accumulate it on the monotonic `name` counter (so totals and
        percentiles stay in one place).  `labels=` splits both sides
        into that labelset (see `observe`)."""
        us = int(seconds * 1e6)
        self.incr(name, us, labels=labels)
        self.observe(name, us, labels=labels)

    @staticmethod
    def _pct_dict(xs, pcts):
        """Nearest-rank percentiles of a pre-sorted window — no numpy
        dependency."""
        n = len(xs)
        out = {"n": n}
        for p in pcts:
            idx = min(n - 1, max(0, int(round(p / 100.0 * n)) - 1))
            out["p%g" % p] = xs[idx]
        return out

    def percentiles(self, name: str, pcts=(50, 90, 99)) -> dict:
        """{'p50': ..., 'p90': ..., 'p99': ..., 'n': samples} over the
        retained window for `name` (empty dict when nothing observed)."""
        with self._lock:
            dq = self._samples.get(name)
            if not dq:
                return {}
            xs = sorted(dq)
        return self._pct_dict(xs, pcts)

    # -- labeled splits ------------------------------------------------
    def labeled_snapshot(self, prefix: str = None) -> dict:
        """{name: [{'labels': {...}, 'value': n}, ...]} for every
        labeled counter (optionally prefix-filtered)."""
        with self._lock:
            out = {}
            for name, per in self._lcounts.items():
                if prefix is not None and not name.startswith(prefix):
                    continue
                out[name] = [{"labels": dict(k), "value": v}
                             for k, v in sorted(per.items())]
        return out

    def labeled_percentiles(self, name: str, pcts=(50, 90, 99)) -> list:
        """[{'labels': {...}, 'p50': ..., 'n': ...}, ...] — one entry
        per labelset observed for `name` (empty list when none)."""
        with self._lock:
            per = self._lsamples.get(name)
            if not per:
                return []
            windows = [(k, sorted(dq)) for k, dq in sorted(per.items())
                       if dq]
        return [dict(self._pct_dict(xs, pcts), labels=dict(k))
                for k, xs in windows]

    def labeled_latency_snapshot(self, prefix: str = None,
                                 pcts=(50, 90, 99)) -> dict:
        """{name: labeled_percentiles(name)} for every labeled sample
        series (optionally prefix-filtered)."""
        with self._lock:
            names = [k for k in self._lsamples
                     if prefix is None or k.startswith(prefix)]
        return {k: self.labeled_percentiles(k, pcts) for k in names}

    def latency_snapshot(self, prefix: str = None, pcts=(50, 90, 99)) \
            -> dict:
        """Percentile summary of every observed series (optionally
        filtered by name prefix): {name: {'p50':..,'p99':..,'n':..}}."""
        with self._lock:
            names = [k for k in self._samples
                     if prefix is None or k.startswith(prefix)]
        return {k: self.percentiles(k, pcts) for k in names}

    def snapshot(self, prefix: str = None) -> dict:
        with self._lock:
            if prefix is None:
                return dict(self._counts)
            return {k: v for k, v in self._counts.items()
                    if k.startswith(prefix)}

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._samples.clear()
            self._lcounts.clear()
            self._lsamples.clear()

#: process-wide event counters
events = EventCounters()
