"""Per-replica host threads of the PyTorch port (counterpart of
incubator_mxnet_tpu/parallel/dispatch.py).

`DispatchPool(devices)` runs work for each replica of a mesh on threads
of its own:

* `place(arr)` splits a host batch by rows, one slice per replica, and
  copies each onto its replica's device from its own thread, timing it
  into ``train.dispatch_replica_us{replica=<i>}`` (when the flight
  recorder is on);
* `run(fn, args)` applies `fn` to each replica's argument, on the pool
  where it is enabled, else in turn;
* `lockstep(fn, group)` runs `fn(r)` for every replica r at once, one
  thread each, for work that meets in a collective in its middle
  (BatchNorm's statistics across replicas,
  `collectives.ReplicaGroup.lockstep_all_reduce`).  A replica that
  raises breaks the group's barrier, so the others raise too, and the
  first error is raised here.

``MXNET_DISPATCH_THREADS``: -1 one thread per replica (at most 8), 0 no
pool (`place` and `run` work in turn), N exactly N.  `lockstep` always
takes one thread per replica: the replicas must all be in flight.
"""
from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as _np
import torch

from .. import config as _cfg
from ..monitor import events
from ..telemetry import flightrec as _bb

__all__ = ["DispatchPool"]


class DispatchPool:
    """Threads for one trainer's replicas; `shutdown()` retires them."""

    def __init__(self, devices, threads: Optional[int] = None):
        self.devices = list(devices)
        n = int(threads if threads is not None
                else _cfg.get("MXNET_DISPATCH_THREADS"))
        if n < 0:
            n = min(len(self.devices), 8)
        self.n_threads = n if len(self.devices) > 1 else 0
        self._pool = None
        self._lock_pool = None

    @property
    def enabled(self):
        return self.n_threads >= 1 and len(self.devices) > 1

    def _ensure_pool(self):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.n_threads, thread_name_prefix="mx-dispatch")
        return self._pool

    def place(self, arr):
        """Host batch (numpy or a CPU tensor) -> one row slice per replica
        on its device (rows must divide evenly)."""
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(_np.ascontiguousarray(arr))
        n = len(self.devices)
        if arr.shape[0] % n:
            raise ValueError("a batch of %d rows does not split over %d "
                             "replicas" % (arr.shape[0], n))
        rows = arr.shape[0] // n
        record = _bb.enabled()

        def upload(i):
            t0 = time.perf_counter()
            dev = self.devices[i]
            piece = arr[i * rows:(i + 1) * rows]
            piece = piece.to("cpu" if dev.type == "cpu" else dev,
                             non_blocking=dev.type == "cuda", copy=True)
            if record:
                events.observe_time("train.dispatch_replica_us",
                                    time.perf_counter() - t0,
                                    labels={"replica": str(i)})
            return piece
        out = self.run(upload, range(n))
        if record:
            _bb.record("step", "dispatch_fanout", replicas=n,
                       bytes=int(arr.numel() * arr.element_size()))
        return out

    def run(self, fn, args_per_replica):
        """[fn(a) for a in args_per_replica], on the pool when enabled."""
        args = list(args_per_replica)
        if not self.enabled:
            return [fn(a) for a in args]
        return list(self._ensure_pool().map(fn, args))

    def lockstep(self, fn, group):
        """[fn(r) for every replica r], all in flight at once (module
        doc)."""
        n = len(self.devices)
        if n == 1:
            return [fn(0)]
        if self._lock_pool is None:
            self._lock_pool = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="mx-replica")

        def guarded(r):
            try:
                return fn(r)
            except BaseException:
                group.abort()
                raise
        futures = [self._lock_pool.submit(guarded, r) for r in range(n)]
        errors, out = [], []
        for f in futures:
            try:
                out.append(f.result())
            except BaseException as e:   # noqa: BLE001 — re-raised below
                errors.append(e)
        group.reset()
        if errors:
            import threading
            real = [e for e in errors
                    if not isinstance(e, threading.BrokenBarrierError)]
            raise (real or errors)[0]
        return out

    def shutdown(self):
        for attr in ("_pool", "_lock_pool"):
            pool = getattr(self, attr)
            setattr(self, attr, None)
            if pool is not None:
                pool.shutdown(wait=False)

    def __del__(self):
        try:
            self.shutdown()
        except Exception:       # noqa: BLE001 — best effort at exit
            pass
