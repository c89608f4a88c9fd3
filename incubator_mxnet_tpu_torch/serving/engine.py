"""Inference serving engine of the PyTorch port: shape-bucketed dynamic
batching over one module on one device (the core of
incubator_mxnet_tpu/serving/engine.py).

* Callers `submit()` single examples or `submit_batch()` small batches
  and get `concurrent.futures.Future`s.
* A dispatcher thread coalesces queued requests into power-of-two batch
  buckets (`MXNET_SERVE_BUCKETS`, default 1, 2, 4, ... up to
  `MXNET_SERVE_MAX_BATCH`), pads the batch with zeros up to its bucket,
  runs the module under `torch.inference_mode()` in `eval()` mode on the
  engine's device, waits for the device, and resolves each request's
  future with its own copy of its rows of the output, on the device.
* The request queue is bounded (`MXNET_SERVE_QUEUE_CAP`): a submit past
  it raises `QueueFull`.  A request whose deadline passes before it
  reaches the device resolves with `DeadlineExceeded`.  `drain()` and
  `close()` resolve every future.
* `warmup()` runs every bucket once before traffic.

The engine's device defaults to `cuda:0`; without CUDA, construction
raises unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import heapq
import itertools
import queue
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from .. import config as _cfg
from ..base import MXNetError
from ..context import resolve_device

__all__ = ["InferenceEngine", "QueueFull", "DeadlineExceeded",
           "EngineClosed", "Shed"]


class QueueFull(MXNetError):
    """The bounded request queue is at capacity: retry later or shed load
    upstream."""


class DeadlineExceeded(MXNetError):
    """The request's deadline expired before it reached the device."""


class EngineClosed(MXNetError):
    """submit() after drain() or close()."""


class Shed(MXNetError):
    """The request was refused by overload policy: its lane is over
    quota, its tenant is over quota, or its deadline was already
    unmeetable.  Unlike `QueueFull` (transient backpressure: retry
    soon), a shed means the engine is deliberately degrading
    low-priority intake to protect higher lanes: back off or re-submit
    on a higher lane."""


class _OverQuota(Exception):
    """Internal: a put would push its lane past quota (the engine
    translates it into the public typed `Shed`)."""

    def __init__(self, lane, depth, cap):
        super().__init__(lane, depth, cap)
        self.lane, self.depth, self.cap = lane, depth, cap


class _LaneQueue:
    """Priority-lane request queue with `queue.Queue`'s accounting
    surface (the subset the engine uses: put_nowait/get/get_nowait/
    task_done/qsize/maxsize/unfinished_tasks/all_tasks_done), so the
    drain()/close() exactly-once contract carries over unchanged.

    `serving.generation.GenerationEngine` admits decode-slot joins
    through this queue (the port's `InferenceEngine` does not use lanes
    yet).

    Ordering: strict priority ACROSS lanes (the dispatcher
    never serves a lower lane while a higher one has work) and
    earliest-deadline-first WITHIN a lane (no-deadline requests keep
    FIFO order after every deadlined one — a request that asked for a
    latency bound outranks one that didn't).  Each lane may carry an
    occupancy cap (its quota share of `maxsize`): a put beyond it
    raises `_OverQuota` so over-quota low-priority work is SHED at
    submit time instead of queueing the whole engine toward uniform
    deadline collapse."""

    def __init__(self, maxsize, lanes, lane_caps):
        self.maxsize = int(maxsize)
        self._lanes = tuple(lanes)
        self._caps = dict(lane_caps)        # lane -> cap (None = none)
        self._heaps = {ln: [] for ln in self._lanes}
        self._seq = itertools.count()       # FIFO tiebreak within EDF
        self._mutex = threading.Lock()
        self._not_empty = threading.Condition(self._mutex)
        self.all_tasks_done = threading.Condition(self._mutex)
        self.unfinished_tasks = 0
        self._size = 0

    def put_nowait(self, req):
        with self._mutex:
            # lane quota BEFORE global fullness: the engine's
            # displacement path relies on queue.Full implying the
            # request's own lane still has quota headroom (so the
            # post-eviction re-put cannot fail)
            h = self._heaps[req.lane]
            cap = self._caps.get(req.lane)
            if cap is not None and len(h) >= cap:
                raise _OverQuota(req.lane, len(h), cap)
            if self._size >= self.maxsize:
                raise queue.Full
            key = (req.deadline if req.deadline is not None
                   else float("inf"), next(self._seq))
            heapq.heappush(h, (key, req))
            self._size += 1
            self.unfinished_tasks += 1
            self._not_empty.notify()

    def _pop_locked(self):
        for lane in self._lanes:            # highest priority first
            h = self._heaps[lane]
            if h:
                _, req = heapq.heappop(h)
                self._size -= 1
                return req
        raise queue.Empty

    def get_nowait(self):
        with self._mutex:
            return self._pop_locked()

    def evict_lowest(self, below):
        """Remove and return the LAST-to-run request (latest deadline,
        newest arrival) of the lowest-priority non-empty lane strictly
        below `below`, or None when every lower lane is empty.  The
        engine uses this to DISPLACE low work when a higher-lane
        submit meets a full queue — without it, lower-lane backlog
        could hold every slot and the top lane would see QueueFull
        under exactly the overload the lanes exist for.  The victim
        stays counted in unfinished_tasks: the caller sheds it through
        the normal resolve path (task_done fires there)."""
        try:
            start = self._lanes.index(below) + 1
        except ValueError:
            return None
        with self._mutex:
            for lane in reversed(self._lanes[start:]):
                h = self._heaps[lane]
                if h:
                    item = max(h)       # latest deadline, newest seq
                    h.remove(item)
                    heapq.heapify(h)
                    self._size -= 1
                    return item[1]
        return None

    def get(self, timeout=None):
        # single-consumer contract (the dispatcher): one wait then one
        # pop attempt; a timeout/spurious wakeup surfaces queue.Empty,
        # which every call site already loops on
        with self._not_empty:
            if not self._size:
                self._not_empty.wait(timeout)
            return self._pop_locked()

    def task_done(self):
        with self.all_tasks_done:
            n = self.unfinished_tasks - 1
            if n < 0:
                raise ValueError("task_done() called too many times")
            self.unfinished_tasks = n
            if n == 0:
                self.all_tasks_done.notify_all()

    def qsize(self):
        with self._mutex:
            return self._size

    def lane_depths(self):
        with self._mutex:
            return {ln: len(h) for ln, h in self._heaps.items()}


def _parse_lanes(spec):
    if spec and isinstance(spec, (list, tuple)):
        names = [str(s).strip() for s in spec if str(s).strip()]
    else:
        names = [s.strip() for s in str(spec or "").split(",")
                 if s.strip()]
    out = []
    for n in names:                         # dedupe, order-preserving
        if n not in out:
            out.append(n)
    if not out:
        raise ValueError("serve lanes spec is empty: %r" % (spec,))
    return tuple(out)


def _parse_lane_quotas(spec, lanes, cap):
    """lane -> occupancy cap (requests) from the quota-fraction spec;
    the top lane defaults to the full queue (None = no lane cap), and
    an explicit fraction >= 1 also means no extra bound (fractions from
    `config.serve_lane_quota_fractions`)."""
    fracs = _cfg.serve_lane_quota_fractions(spec, len(lanes))
    caps = {}
    for lane, f in zip(lanes, fracs):
        caps[lane] = None if f >= 1.0 else max(1, int(f * cap))
    return caps


class _Request:
    __slots__ = ("data", "n", "future", "t_enq", "deadline", "single")

    def __init__(self, data, n, future, deadline, single):
        self.data = data
        self.n = n
        self.future = future
        self.t_enq = time.monotonic()
        self.deadline = None if deadline is None \
            else self.t_enq + float(deadline)
        self.single = single


def _parse_buckets(spec, max_batch):
    if spec and isinstance(spec, (list, tuple, set, frozenset)):
        bs = sorted({int(s) for s in spec})
    elif spec:
        bs = sorted({int(s) for s in str(spec).split(",") if s.strip()})
    else:
        bs, b = [], 1
        while b < max_batch:
            bs.append(b)
            b *= 2
        bs.append(int(max_batch))
        bs = sorted(set(bs))
    if not bs or bs[0] < 1:
        raise ValueError("serve buckets must be positive ints, got %r"
                         % (spec,))
    return tuple(bs)


class InferenceEngine:
    """Concurrent inference over a module with bucketed dynamic batching.

    block: a module whose parameters live on `device`.
    device: where the module runs (default `cuda:0`).
    buckets / max_batch / max_wait_us / queue_cap: see the MXNET_SERVE_*
        knobs in config.py (arguments override).
    example_shape / wire_dtype: per-example shape (no batch dim) and the
        numpy dtype clients submit; `warmup()` needs them before the
        first request has been seen.

    Lifecycle: construct → `warmup()` → submit traffic → `drain()` /
    `close()`.  The dispatcher thread starts on the first submit.
    """

    def __init__(self, block, device=None, buckets=None, max_batch=None,
                 max_wait_us=None, queue_cap=None, example_shape=None,
                 wire_dtype=None):
        self._device = resolve_device(device)
        for name, p in block.named_parameters():
            if p.device != self._device:
                raise ValueError(
                    "parameter %s lives on %s but the engine runs on %s; "
                    "move the block first (block.to_device(...))"
                    % (name, p.device, self._device))
        self._block = block.eval()
        max_batch = int(max_batch if max_batch is not None
                        else _cfg.get("MXNET_SERVE_MAX_BATCH"))
        self._buckets = _parse_buckets(
            buckets if buckets is not None
            else _cfg.get("MXNET_SERVE_BUCKETS"), max_batch)
        self._max_wait = (int(max_wait_us if max_wait_us is not None
                              else _cfg.get("MXNET_SERVE_MAX_WAIT_US"))
                          / 1e6)
        cap = max(1, int(queue_cap if queue_cap is not None
                         else _cfg.get("MXNET_SERVE_QUEUE_CAP")))
        self._q = queue.Queue(maxsize=cap)
        self._example_shape = (tuple(example_shape)
                               if example_shape is not None else None)
        self._wire_dtype = (str(np.dtype(wire_dtype))
                            if wire_dtype is not None else None)
        self._lock = threading.Lock()       # submit/lifecycle state
        self._exec_lock = threading.Lock()  # warmup vs dispatcher
        self._thread = None
        self._carry = None          # request pulled but not yet batched
        self._counts = dict(requests=0, batches=0, warmup_batches=0,
                            examples=0, padded=0, rejected=0, expired=0)
        self._bucket_batches = {b: 0 for b in self._buckets}
        self._e2e_s = deque(maxlen=8192)
        self._draining = False
        self._stop = False
        self._closed = False

    @property
    def buckets(self):
        return self._buckets

    # -- submission ----------------------------------------------------
    def _check_example(self, shape, dtype):
        # one engine serves one example signature; a mismatched request
        # would otherwise break the batch concatenation
        dtype = str(np.dtype(dtype))
        with self._lock:
            if self._example_shape is None:
                self._example_shape = tuple(shape)
                self._wire_dtype = dtype
                return
            if tuple(shape) != self._example_shape:
                raise ValueError(
                    "request example shape %r != engine example shape %r "
                    "(build a second engine for a second signature)"
                    % (tuple(shape), self._example_shape))
            if self._wire_dtype is None:
                self._wire_dtype = dtype
            elif dtype != self._wire_dtype:
                raise ValueError(
                    "request wire dtype %s != engine wire dtype %s "
                    "(convert client-side)" % (dtype, self._wire_dtype))

    def submit(self, x, deadline=None):
        """Enqueue ONE example (no batch dim).  Returns a Future whose
        result is the model output for this example (batch dim
        stripped), a tensor on the engine's device.  `deadline` is
        seconds from now.  Raises QueueFull / DeadlineExceeded /
        EngineClosed synchronously."""
        arr = np.asarray(x)
        return self._submit(arr[None], deadline, single=True)

    def submit_batch(self, x, deadline=None):
        """Enqueue a small batch (leading batch dim, at most the largest
        bucket), dispatched as one unit under one future."""
        arr = np.asarray(x)
        if arr.ndim < 1 or arr.shape[0] < 1:
            raise ValueError("submit_batch needs a leading batch dim")
        if arr.shape[0] > self._buckets[-1]:
            raise ValueError(
                "batch of %d exceeds the largest bucket (%d); chunk it "
                "client-side" % (arr.shape[0], self._buckets[-1]))
        return self._submit(arr, deadline, single=False)

    def _submit(self, arr, deadline, single):
        self._check_example(arr.shape[1:], arr.dtype)
        fut = Future()
        req = _Request(arr, arr.shape[0], fut, deadline, single)
        if req.deadline is not None and req.deadline <= req.t_enq:
            with self._lock:
                self._counts["rejected"] += 1
                self._counts["expired"] += 1
            raise DeadlineExceeded("deadline is not in the future")
        # closed-check and enqueue are atomic against close()'s final
        # flush, so every accepted request is resolved by someone
        with self._lock:
            if self._closed or self._draining:
                self._counts["rejected"] += 1
                raise EngineClosed("engine is draining/closed")
            try:
                self._q.put_nowait(req)
            except queue.Full:
                self._counts["rejected"] += 1
                raise QueueFull(
                    "serve queue at capacity (%d requests); retry later "
                    "or raise MXNET_SERVE_QUEUE_CAP" % self._q.maxsize) \
                    from None
        self._ensure_dispatcher()
        return fut

    def _ensure_dispatcher(self):
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=InferenceEngine._dispatch_loop,
                    args=(weakref.ref(self),), daemon=True,
                    name="ServeDispatcher")
                self._thread.start()

    # -- dispatcher ----------------------------------------------------
    @staticmethod
    def _dispatch_loop(ref):
        """Holds the engine only through a weakref between iterations, so
        an engine dropped without close() is collected and this thread
        retires at its next poll."""
        while True:
            eng = ref()
            if eng is None:
                return
            try:
                reqs = eng._collect()
                if reqs is None:
                    return
                if reqs:
                    eng._execute(reqs)
            except Exception:           # noqa: BLE001 — a dead dispatcher
                # strands every queued future; _execute resolves its own
                # requests, so what escaped here had none in hand
                import logging
                logging.getLogger(__name__).exception(
                    "serve dispatcher error (recovered)")
                time.sleep(0.01)
            finally:
                del eng

    def _finish(self, req, result=None, exc=None):
        """Resolve a request's future and retire its queue slot, tolerant
        of a caller-side cancel()."""
        try:
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(result)
        except Exception:               # noqa: BLE001 — cancelled/done
            pass
        self._q.task_done()

    def _collect(self):
        """Coalesce queued requests into one bucket's worth: pull while
        the queue is non-empty, wait up to max_wait for more once it runs
        dry, stop at the largest bucket.  Returns the request list, [] on
        an idle poll, or None when the dispatcher should retire."""
        max_b = self._buckets[-1]
        reqs, total, edl = [], 0, None
        with self._lock:
            carry, self._carry = self._carry, None
        if carry is not None:
            reqs.append(carry)
            total, edl = carry.n, carry.deadline
        t_first = time.monotonic() if reqs else None
        while total < max_b and not self._stop:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                if not reqs:
                    if self._draining:
                        return None     # intake stopped + queue empty
                    try:                # idle poll (watches stop flags)
                        item = self._q.get(timeout=0.05)
                    except queue.Empty:
                        return []
                else:
                    now = time.monotonic()
                    rem = self._max_wait - (now - t_first)
                    if edl is not None:
                        # a collected request is about to expire: stop
                        # filling and dispatch it promptly
                        rem = min(rem, edl - now)
                    if rem <= 0:
                        break
                    try:
                        item = self._q.get(timeout=min(rem, 0.05))
                    except queue.Empty:
                        continue
            if item.deadline is not None and \
                    time.monotonic() > item.deadline:
                self._expire(item)
                continue
            if total + item.n > max_b:
                with self._lock:
                    self._carry = item  # the next batch starts with it
                break
            reqs.append(item)
            total += item.n
            if item.deadline is not None:
                edl = item.deadline if edl is None \
                    else min(edl, item.deadline)
            if t_first is None:
                t_first = time.monotonic()
        return reqs if reqs else None

    def _expire(self, req):
        with self._lock:
            self._counts["expired"] += 1
        self._finish(req, exc=DeadlineExceeded(
            "request expired after %.3fs in queue"
            % (time.monotonic() - req.t_enq)))

    def _bucket_for(self, n):
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _execute(self, reqs):
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self._expire(r)
            elif not r.future.set_running_or_notify_cancel():
                self._q.task_done()     # cancelled while queued
            else:
                live.append(r)
        if not live:
            return
        total = sum(r.n for r in live)
        bucket = self._bucket_for(total)
        try:
            batch = live[0].data if len(live) == 1 else \
                np.concatenate([r.data for r in live], axis=0)
            if bucket > total:
                pad = np.zeros((bucket - total,) + batch.shape[1:],
                               batch.dtype)
                batch = np.concatenate([batch, pad], axis=0)
            out = self._run(batch)
        except Exception as e:          # noqa: BLE001 — fan the failure
            for r in live:              # out to every caller's future
                self._finish(r, exc=e)
            return
        with self._lock:
            self._counts["batches"] += 1
            self._counts["requests"] += len(live)
            self._counts["examples"] += total
            self._counts["padded"] += bucket - total
            self._bucket_batches[bucket] += 1
        off, e2e = 0, []
        for r in live:
            lo, hi = off, off + r.n
            off = hi
            # a copy, not a view: a held result must not pin the whole
            # padded bucket output
            self._finish(r, result=(out[lo] if r.single
                                    else out[lo:hi]).clone())
            e2e.append(time.monotonic() - r.t_enq)
        with self._lock:            # stats() copies the ring under it
            self._e2e_s.extend(e2e)

    def _run(self, batch_np):
        """One forward of a padded bucket on the engine's device; returns
        once the device has finished it."""
        with self._exec_lock:
            x = torch.from_numpy(np.ascontiguousarray(batch_np)).to(
                self._device)
            with torch.inference_mode():
                out = self._block(x)
            if self._device.type == "cuda":
                torch.cuda.synchronize(self._device)
        return out

    # -- warmup --------------------------------------------------------
    def warmup(self, example_shape=None, wire_dtype=None):
        """Run every bucket once before traffic (first-call allocations,
        kernel builds and library handles happen here, not on a
        request).  Needs the example signature from the constructor, a
        prior request, or the arguments.  Returns a summary dict."""
        if self._example_shape is None and example_shape is None:
            raise ValueError("warmup() before any request needs "
                             "example_shape= (and wire_dtype=)")
        self._check_example(
            tuple(example_shape) if example_shape is not None
            else self._example_shape,
            wire_dtype or self._wire_dtype or "float32")
        dtype = np.dtype(self._wire_dtype)
        t0 = time.monotonic()
        per_bucket = {}
        for b in self._buckets:
            tb = time.monotonic()
            self._run(np.zeros((b,) + self._example_shape, dtype))
            per_bucket[b] = time.monotonic() - tb
            with self._lock:
                self._counts["warmup_batches"] += 1
        return {"buckets": list(self._buckets),
                "wall_s": time.monotonic() - t0,
                "bucket_wall_s": per_bucket}

    # -- lifecycle -----------------------------------------------------
    def drain(self, timeout=30.0):
        """Stop intake (submits raise EngineClosed) and wait until every
        accepted request is resolved.  Returns True when the queue fully
        drained within `timeout`."""
        self._draining = True
        deadline = time.monotonic() + float(timeout)
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                if self._thread is None or not self._thread.is_alive():
                    break               # nothing will drain it
                self._q.all_tasks_done.wait(min(rem, 0.1))
        return self._q.unfinished_tasks == 0

    def close(self, timeout=30.0):
        """drain(), retire the dispatcher (joined within `timeout`) and
        resolve any still-outstanding future with EngineClosed.
        Idempotent.  Returns True when the dispatcher thread is joined."""
        t_end = time.monotonic() + float(timeout)
        self.drain(timeout)
        self._stop = True
        t = self._thread
        if t is not None and t.is_alive():
            t.join(max(0.1, t_end - time.monotonic()))
        leftovers = []
        with self._lock:
            self._closed = True
            if self._carry is not None:
                leftovers.append(self._carry)
                self._carry = None
            while True:
                try:
                    leftovers.append(self._q.get_nowait())
                except queue.Empty:
                    break
        for r in leftovers:
            self._finish(r, exc=EngineClosed("engine closed before "
                                             "dispatch"))
        return t is None or not t.is_alive()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # flags only: never join a thread from a finalizer
        self._draining = True
        self._stop = True
        self._closed = True

    # -- introspection -------------------------------------------------
    def stats(self):
        """Counters, batches per bucket, and end-to-end latency p50/p99
        (ms) over the most recent resolved requests."""
        with self._lock:
            out = dict(self._counts)
            out["bucket_batches"] = dict(self._bucket_batches)
            e2e = np.asarray(self._e2e_s, dtype=np.float64)
        if e2e.size:
            out["e2e_p50_ms"] = float(np.percentile(e2e, 50) * 1e3)
            out["e2e_p99_ms"] = float(np.percentile(e2e, 99) * 1e3)
        return out
