"""Inference serving engine of the PyTorch port: shape-bucketed dynamic
batching over captured programs (counterpart of
incubator_mxnet_tpu/serving/engine.py).

1. **Shape buckets.**  A dispatcher thread coalesces queued requests
   into batch buckets (`MXNET_SERVE_BUCKETS`, default 1, 2, 4, ... up to
   `MXNET_SERVE_MAX_BATCH`) and pads each batch with zeros up to its
   bucket, so the set of programs is closed and known in advance.
2. **A captured program per (replica, bucket).**  Where the JAX engine
   compiles one executable per bucket, this one captures one program
   per replica and bucket with `graph_capture.capture`: a CUDA graph on
   the card, the recorded aten ops on the CPU.  The program reads the
   engine's static input buffer and its own copy of the parameters (one
   copy per replica device, never the caller's block storage) and
   writes static outputs; a batch is copied into the input buffer, the
   program replayed on the replica's CUDA stream, and each request's
   rows copied out of the outputs.  `warmup()` captures every bucket of
   every replica; ``serve.traces`` counts captures, so after warmup it
   equals buckets x replicas and stays flat under traffic.  Each
   program's bytes land in `telemetry.costs` under ``cost_label``.
3. **Weight swap.**  `refresh_params_from(block)` checks the new tree
   (names, else registration order, and shapes) and copies its values
   into the served parameter buffers in place, between batches, under
   the execution lock: the programs keep their addresses and are not
   captured again, and neither block is touched.
4. **Concurrency.**  `submit()`/`submit_batch()` return futures.  With
   several replicas (`devices=[...]`, a device may appear twice) each
   replica gets a single-thread worker, a semaphore bounds in-flight
   batches at the replica count, and a health-aware round-robin routes
   around a replica after `MXNET_SERVE_REPLICA_FAILS` terminal failures,
   probing it again after `MXNET_SERVE_REPLICA_COOLDOWN_S`.  Captures
   hold the device's `graph_capture.gate` alone, and device work holds
   it shared, so engines on one card never launch into another's open
   capture.
5. **Overload.**  Priority lanes (`MXNET_SERVE_LANES`, strict priority
   across, earliest deadline first within), lane and tenant quotas,
   displacement of low-lane work by a higher lane on a full queue, and
   deadline feasibility from a per-bucket service-time EWMA: requests
   that cannot make it are shed with the typed errors (`Shed`,
   `QueueFull`, `DeadlineExceeded`) before they cost device time.
6. **Robustness and observability.**  `drain()`/`close()` resolve every
   future; ``handle_sigterm=True`` drains on SIGTERM; fault sites
   ``serve.enqueue``, ``serve.infer``, ``serve.slow`` and ``serve.oom``
   (`fault.py`); ``serve.*`` counters and percentile rings on
   `monitor.events`, split by lane, tenant and version; the request
   journal of `telemetry.reqtrace`; `degrade()` is the
   ``model.bad_version`` taint.

Not ported: the JAX package's input transform
(`HybridBlock.set_input_transform`), its AOT disk cache and pre-warm
manifest.  A CUDA graph does not serialize, so a restarted server
captures its programs again in `warmup()`.

The engine's device defaults to `cuda:0`; without CUDA, construction
raises unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import heapq
import itertools
import logging
import queue
import signal
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from .. import config as _cfg
from .. import fault
from .. import graph_capture as _gc
from ..base import MXNetError
from ..context import resolve_device
from ..gluon.block import _ProgramScope
from ..gluon.parameter import is_deferred
from ..monitor import events
from ..parallel.resilience import retry_transient
from ..telemetry import costs as _costs
from ..telemetry import flightrec as _bb
from ..telemetry import reqtrace as _reqtrace
from ..telemetry import spans as _tele

__all__ = ["InferenceEngine", "QueueFull", "DeadlineExceeded",
           "EngineClosed", "Shed", "serve_counters"]


class QueueFull(MXNetError):
    """The bounded request queue is at capacity: retry later or shed load
    upstream."""


class DeadlineExceeded(MXNetError):
    """The request's deadline expired before it reached the device."""


class EngineClosed(MXNetError):
    """submit() after drain() or close() (or during a SIGTERM drain)."""


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

    Shared by `InferenceEngine` and `serving.generation.
    GenerationEngine` (decode-slot joins): one admission policy, one set
    of typed errors, two engines.

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


def serve_counters():
    """Snapshot of the `serve.*` counters (µs totals / counts)."""
    return events.snapshot("serve.")


def _model_scope():
    """Where an engine calls the model: no autograd graph, tensors that
    are not inference tensors (whatever mode the caller is in), training
    off, and hybridized children running as plain code."""
    stack = contextlib.ExitStack()
    stack.enter_context(torch.inference_mode(False))
    stack.enter_context(torch.no_grad())
    stack.enter_context(_ProgramScope(False, False))
    return stack


class _Method(torch.nn.Module):
    """`block.<name>(...)` as a module's forward, for `functional_call`."""

    def __init__(self, block, name):
        super().__init__()
        self.block = block
        self._name = name

    def forward(self, *args, **kwargs):
        return getattr(self.block, self._name)(*args, **kwargs)


_PRIMED = threading.local()


def _prime(device):
    """Create this thread's cuBLAS handles on `device` outside any
    capture (a handle created inside one would allocate while
    capturing)."""
    if device.type != "cuda":
        return
    done = getattr(_PRIMED, "devices", None)
    if done is None:
        done = _PRIMED.devices = set()
    if device in done:
        return
    with torch.cuda.device(device), _model_scope():
        x = torch.ones((1, 8), device=device)
        torch.nn.functional.linear(x, x, x[0, :1])
        torch.bmm(x[None], x[None].transpose(1, 2))
    done.add(device)


def _nbytes(t):
    return t.numel() * t.element_size()


#: functional_call swaps a module's attributes while it runs: two
#: captures of one block (two engines, or a registry canary) must not
#: interleave their swaps
_SWAP_LOCK = threading.Lock()


def _meta_call(block, method, args, kwargs=None):
    """`block.<method>(*args, **kwargs)` run on the meta device: the
    block's tensors swapped for meta copies (shapes only, no memory, no
    kernel), under the swap lock."""
    meta = {"block." + n: t.detach().to("meta")
            for n, t in block.state_dict(keep_vars=True).items()}
    with _SWAP_LOCK:
        return torch.func.functional_call(_Method(block, method), meta,
                                          args, kwargs or {})


def _param_tree(block):
    """{name: tensor} of a module's parameters and buffers, in
    registration order (tied parameters once)."""
    out = dict(block.named_parameters())
    for n, b in block.named_buffers():
        out.setdefault(n, b)
    return out


def param_bytes(block):
    """Bytes of one full copy of a module's parameters and buffers."""
    return sum(_nbytes(t) for t in _param_tree(block).values())


class _Request:
    __slots__ = ("data", "n", "future", "t_enq", "deadline", "single",
                 "tele", "lane", "tenant", "rec")

    def __init__(self, data, n, future, deadline, single, lane=None,
                 tenant=None):
        self.data = data
        self.n = n
        self.future = future
        self.t_enq = time.monotonic()
        self.deadline = None if deadline is None \
            else self.t_enq + float(deadline)
        self.single = single
        self.lane = lane
        self.tenant = tenant
        # the submitter's span context: the dispatcher's spans parent
        # onto it across threads
        self.tele = _tele.current()
        self.rec = None         # reqtrace.Record (journal lifecycle)


class _Replica:
    """One replica: its device, its parameter copy, its CUDA stream and
    graph pool, and its programs' static buffers."""

    def __init__(self, device):
        self.device = device
        self.params = None      # {name: tensor}, the engine's own copy
        self.param_bytes = 0
        cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.pool = None        # the replica's shared graph pool
        self.inputs = {}        # bucket -> static input buffer
        self.outputs = {}       # bucket -> flat list of static outputs
        self.spec = {}          # bucket -> output tree spec
        self.rows = {}          # bucket -> cost-row key
        self.gate = _gc.gate(device)

    def on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def after_callers(self, tensors=()):
        """Order this replica's stream after the work the calling thread
        has queued on its current streams: the replica's device's, and
        those of `tensors` on other cards (what a copy onto the replica
        reads)."""
        if self.stream is None:
            return
        devs = {t.device for t in tensors if t.device.type == "cuda"}
        devs.add(self.device)
        for d in devs:
            self.stream.wait_stream(torch.cuda.current_stream(d))


class InferenceEngine:
    """Concurrent inference over a module with bucketed dynamic batching
    through captured programs.

    block: a module (Gluon block or `torch.nn.Module`) with initialized
        parameters, or widths deferred to the first batch.
    device: one device (default `cuda:0`); devices: a list for replica
        round-robin (a device may appear twice).
    buckets / max_batch / max_wait_us / queue_cap: see the MXNET_SERVE_*
        knobs in config.py (arguments override).
    example_shape / wire_dtype: per-example shape (no batch dim) and the
        numpy dtype clients submit; `warmup()` needs them before the
        first request has been seen.
    lanes / lane_quotas / tenant_quota: overload policy (the
        MXNET_SERVE_LANES, _LANE_QUOTAS and _TENANT_QUOTA knobs).
    cost_label / version: the label of this engine's cost rows and
        journal, and the version tag of its labeled serve.* splits.

    Lifecycle: construct → `warmup()` → submit traffic → `drain()` /
    `close()`.  The dispatcher thread starts on the first submit.
    """

    #: headroom on the EWMA service estimate in the deadline check: the
    #: estimate is a mean, the deadline a bound
    _SVC_MARGIN = 1.25

    def __init__(self, block, device=None, devices=None, buckets=None,
                 max_batch=None, max_wait_us=None, queue_cap=None,
                 example_shape=None, wire_dtype=None,
                 handle_sigterm=False, lanes=None, lane_quotas=None,
                 tenant_quota=None, cost_label=None, version=None):
        if devices is None:
            devices = [device]
        elif device is not None:
            raise ValueError("pass device= or devices=, not both")
        if not devices:
            raise ValueError("need at least one serving device")
        if getattr(block, "_input_transform", None) is not None:
            raise NotImplementedError(
                "serving a block with an input transform "
                "(set_input_transform) is not yet ported: serve a block "
                "without one")
        self._block = block.eval()
        self._devices = [resolve_device(d) for d in devices]
        self._reps = [_Replica(d) for d in self._devices]
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
        self._lanes = _parse_lanes(
            lanes if lanes is not None else _cfg.get("MXNET_SERVE_LANES"))
        self._lane_caps = _parse_lane_quotas(
            lane_quotas if lane_quotas is not None
            else _cfg.get("MXNET_SERVE_LANE_QUOTAS"), self._lanes, cap)
        self._q = _LaneQueue(cap, self._lanes, self._lane_caps)
        self._tenant_quota = int(
            tenant_quota if tenant_quota is not None
            else _cfg.get("MXNET_SERVE_TENANT_QUOTA"))
        self._tenant_q = {}         # tenant -> currently-queued count
        self._cost_label = str(cost_label or "serve.infer")
        self._version = str(version) if version is not None else None
        self._journal = _reqtrace.journal(
            "serve",
            self._cost_label.split(":", 1)[1]
            if ":" in self._cost_label else self._cost_label,
            version=self._version)
        self._degrade_s = 0.0
        self._example_shape = (tuple(example_shape)
                               if example_shape is not None else None)
        self._wire_dtype = (str(np.dtype(wire_dtype))
                            if wire_dtype is not None else None)
        self._programs = {}         # (replica, bucket) -> program
        self._param_src = None      # block whose params serve (set by
                                    # refresh_params_from)
        self._param_remap = None    # source name -> serving name

        self._lock = threading.Lock()       # submit/lifecycle state
        self._exec_lock = threading.Lock()  # captures, launches, swaps
        self._lane_deadline_s = {}  # lane -> deque of recent deadlines
        self._thread = None
        self._carry = None          # request pulled but not yet batched
        self._svc_ewma = {}         # bucket -> EWMA batch service s
        self._counts = dict(requests=0, batches=0, warmup_batches=0,
                            examples=0, padded=0, rejected=0, expired=0)
        self._count_lock = threading.Lock()     # _counts only
        self._bucket_batches = {b: 0 for b in self._buckets}
        self._e2e_s = deque(maxlen=8192)
        self._rr = 0
        self._n_batches = 0
        self._dev_batches = [0] * len(self._reps)
        self._n_inflight = 0
        self._max_fails = int(_cfg.get("MXNET_SERVE_REPLICA_FAILS"))
        self._cooldown = float(_cfg.get("MXNET_SERVE_REPLICA_COOLDOWN_S"))
        self._fail_streak = [0] * len(self._reps)
        self._unhealthy_until = [0.0] * len(self._reps)  # 0 = healthy
        if len(self._reps) > 1:
            # one single-thread worker per replica, so replica k+1 runs
            # while replica k is busy; the semaphore bounds in-flight
            # batches at the replica count
            self._pools = [ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ServeReplica%d" % i)
                for i in range(len(self._reps))]
            self._inflight = threading.Semaphore(len(self._reps))
        else:
            self._pools = None
            self._inflight = None
        self._draining = False
        self._stop = False
        self._closed = False
        self._warm = False
        self._prev_sigterm = None
        if not any(is_deferred(p) for p in block.parameters()):
            self.refresh_params()
        if handle_sigterm:
            self._install_sigterm()
        _bb.install_crash_hooks()

    @property
    def buckets(self):
        return self._buckets

    # -- parameters ------------------------------------------------------
    def _source_tree(self):
        src = self._param_src if self._param_src is not None \
            else self._block
        tree = _param_tree(src)
        if self._param_remap:
            tree = {self._param_remap.get(n, n): v
                    for n, v in tree.items()}
        return tree

    def refresh_params(self):
        """(Re-)copy the served block's current parameters onto every
        replica (call after the block was retrained).  After
        `refresh_params_from`, the promoted block is the source.  The
        first call allocates each replica's copy; later calls copy in
        place, between batches, so the captured programs keep reading
        the same storage."""
        with self._exec_lock:
            self._copy_params()

    def _copy_params(self):
        """Caller holds the execution lock."""
        tree = self._source_tree()
        for rep in self._reps:
            with rep.gate.work():
                # the source may still be written on the caller's stream
                # (an initialization, a load, a training step)
                rep.after_callers(tree.values())
                with rep.on_stream(), torch.no_grad():
                    if rep.params is None:
                        rep.params = {
                            n: v.detach().to(rep.device, copy=True)
                            for n, v in tree.items()}
                        rep.param_bytes = sum(
                            _nbytes(t) for t in rep.params.values())
                    else:
                        for n, t in rep.params.items():
                            t.copy_(tree[n])
        self._sync_replicas()

    def _sync_replicas(self):
        for rep in self._reps:
            if rep.stream is not None:
                with rep.gate.work():
                    rep.stream.synchronize()

    def refresh_params_from(self, block, version=None):
        """Promote by weight swap: serve `block`'s parameters through
        this engine's captured programs.  The trees must match: the same
        names and shapes, or (separately built copies of one
        architecture get fresh auto-prefixed names) the same shapes in
        registration order, mapped positionally.  An architecturally
        different version needs a fresh engine.  The values are copied
        into the served buffers in place: no capture, and neither block
        is modified.  Optionally re-tags the version label."""
        new = _param_tree(block)
        cur = self._source_tree()
        remap = None
        if set(new) != set(cur):
            if len(new) != len(cur):
                raise ValueError(
                    "parameter tree mismatch: promote needs an "
                    "identical tree (%d params vs %d serving) — "
                    "architecturally different versions need a fresh "
                    "engine" % (len(new), len(cur)))
            remap = dict(zip(new, cur))
            cur_by_new = {n: cur[remap[n]] for n in new}
        else:
            cur_by_new = cur
        for n in new:
            if tuple(new[n].shape) != tuple(cur_by_new[n].shape):
                raise ValueError(
                    "parameter %r shape %r != serving shape %r — the "
                    "captured programs serve ONE signature"
                    % (n, tuple(new[n].shape),
                       tuple(cur_by_new[n].shape)))
        self._param_src = block
        self._param_remap = remap
        self.refresh_params()
        if version is not None:
            self._version = str(version)
            self._journal.version = self._version
        events.incr("serve.param_swaps")

    def set_version(self, version):
        """Re-tag the version label of this engine's serve.* splits."""
        self._version = str(version) if version is not None else None
        self._journal.version = self._version

    def degrade(self, stall_s):
        """Taint this engine (the model.bad_version fault site): every
        batch stalls `stall_s` seconds and its outputs are sign-flipped.
        0 restores healthy behavior."""
        self._degrade_s = max(0.0, float(stall_s))

    def _materialize_params(self, batch_np):
        """Deferred widths: one small eager forward on the first
        replica's device gives the parameters their shapes; then each
        replica takes its copy.  Caller holds the execution lock."""
        dev = self._devices[0]
        x = torch.from_numpy(np.ascontiguousarray(batch_np[:1])).to(dev)
        with _model_scope():
            self._block(x)
        self._copy_params()

    # -- signal / preemption ---------------------------------------------
    def _install_sigterm(self):
        ref = weakref.ref(self)         # the process-global handler
        state = {}                      # must not pin the engine

        def _on_sigterm(signum, frame):
            eng = ref()
            if eng is not None:
                # flag only (signal-safe): the dispatcher stops intake,
                # completes queued work, and retires
                eng._draining = True
                events.incr("serve.preempted")
                return
            try:                        # engine collected: re-deliver
                signal.signal(signal.SIGTERM,
                              state.get("prev") or signal.SIG_DFL)
                signal.raise_signal(signal.SIGTERM)
            except Exception:           # noqa: BLE001
                pass
        try:
            self._prev_sigterm = signal.signal(signal.SIGTERM,
                                               _on_sigterm)
            state["prev"] = self._prev_sigterm
        except ValueError:          # not the main thread
            self._prev_sigterm = None

    def uninstall_sigterm(self):
        if self._prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass
            self._prev_sigterm = None

    def request_shutdown(self):
        """Programmatic SIGTERM: stop intake and finish queued work in
        the background (pair with `close()` to join)."""
        self._draining = True
        events.incr("serve.preempted")

    # -- submission ----------------------------------------------------
    def _check_example(self, shape, dtype):
        # shape and wire dtype are the programs' signature; locked, so
        # two racing first submits agree on one
        dtype = str(np.dtype(dtype))
        with self._lock:
            if self._example_shape is None:
                self._example_shape = tuple(shape)
                self._wire_dtype = dtype
                return
            if tuple(shape) != self._example_shape:
                raise ValueError(
                    "request example shape %r != engine example shape %r "
                    "(one program set serves ONE signature; build a "
                    "second engine for a second signature)"
                    % (tuple(shape), self._example_shape))
            if self._wire_dtype is None:
                self._wire_dtype = dtype
            elif dtype != self._wire_dtype:
                raise ValueError(
                    "request wire dtype %s != engine wire dtype %s "
                    "(dtype is part of the captured signature; convert "
                    "client-side)" % (dtype, self._wire_dtype))

    def submit(self, x, deadline=None, lane=None, tenant=None):
        """Enqueue ONE example (no batch dim).  Returns a Future whose
        result is the model output for this example (batch dim
        stripped), on the replica's device.  `deadline` is seconds from
        now; `lane` picks the priority lane (default: the top lane);
        `tenant` tags the request for per-tenant quotas and the labeled
        splits.  Raises QueueFull / Shed / DeadlineExceeded /
        EngineClosed synchronously."""
        arr = np.asarray(x)
        return self._submit(arr[None], deadline, single=True, lane=lane,
                            tenant=tenant)

    def submit_batch(self, x, deadline=None, lane=None, tenant=None):
        """Enqueue a small batch (leading batch dim, at most the largest
        bucket), dispatched as one unit under one future."""
        arr = np.asarray(x)
        if arr.ndim < 1 or arr.shape[0] < 1:
            raise ValueError("submit_batch needs a leading batch dim")
        if arr.shape[0] > self._buckets[-1]:
            raise ValueError(
                "batch of %d exceeds the largest bucket (%d); chunk it "
                "client-side (the bucket set is closed by design)"
                % (arr.shape[0], self._buckets[-1]))
        return self._submit(arr, deadline, single=False, lane=lane,
                            tenant=tenant)

    def _shed_mark(self, lane, tenant, reason, deadline=False):
        """The one counter block of every shed path (quota sheds,
        born-expired, dispatch-time expiry, displacement)."""
        self._count("rejected")
        if deadline:
            self._count("expired")
        events.incr("serve.rejected")
        if deadline:
            events.incr("serve.deadline_expired")
        events.incr("serve.shed")
        events.incr("serve.shed", labels={"lane": lane or "-",
                                          "reason": reason})
        if tenant is not None:
            events.incr("serve.shed", labels={"tenant": tenant})
        if self._version is not None:
            events.incr("serve.shed", labels={"version": self._version})

    def _shed(self, lane, tenant, reason, msg):
        self._shed_mark(lane, tenant, reason)
        raise Shed(msg)

    def _count(self, name, n=1):
        with self._count_lock:
            self._counts[name] += n

    def _reject(self):
        """A refusal that is not a shed (QueueFull, EngineClosed)."""
        self._count("rejected")
        events.incr("serve.rejected")

    def _submit(self, arr, deadline, single, lane=None, tenant=None):
        if fault.should_fire("serve.enqueue"):
            self._reject()
            raise QueueFull("injected enqueue fault (serve.enqueue)")
        self._check_example(arr.shape[1:], arr.dtype)
        lane = self._lanes[0] if lane is None else str(lane)
        if lane not in self._lane_caps:
            raise ValueError("unknown lane %r (engine lanes: %s)"
                             % (lane, ",".join(self._lanes)))
        tenant = str(tenant) if tenant is not None else None
        fut = Future()
        req = _Request(arr, arr.shape[0], fut, deadline, single,
                       lane=lane, tenant=tenant)
        req.rec = self._journal.start(req.t_enq, lane, tenant)
        if req.rec is not None:
            req.rec.n = req.n
        if req.deadline is not None and req.deadline <= req.t_enq:
            self._shed_mark(lane, tenant, "deadline", deadline=True)
            exc = DeadlineExceeded("deadline is not in the future")
            rec, req.rec = req.rec, None
            self._journal.retire(rec, exc=exc)
            raise exc
        try:
            self._submit_locked(req, deadline, lane, tenant)
        except MXNetError as e:
            rec, req.rec = req.rec, None
            self._journal.retire(rec, exc=e)
            raise
        self._ensure_dispatcher()
        return fut

    def _submit_locked(self, req, deadline, lane, tenant):
        # closed-check and enqueue are atomic against close()'s final
        # flush, so every accepted request is resolved by someone
        with self._lock:
            if self._closed or self._draining:
                self._reject()
                raise EngineClosed("engine is draining/closed")
            if tenant is not None and self._tenant_quota > 0 and \
                    self._tenant_q.get(tenant, 0) >= self._tenant_quota:
                self._shed(lane, tenant, "tenant_quota",
                           "tenant %r over quota (%d queued, cap %d); "
                           "back off or raise MXNET_SERVE_TENANT_QUOTA"
                           % (tenant, self._tenant_q.get(tenant, 0),
                              self._tenant_quota))
            victim = None
            try:
                self._q.put_nowait(req)
            except _OverQuota as oq:
                self._shed(lane, tenant, "lane_quota",
                           "lane %r over quota (%d queued, cap %d); "
                           "excess low-priority work is shed under "
                           "overload — see MXNET_SERVE_LANE_QUOTAS"
                           % (oq.lane, oq.depth, oq.cap))
            except queue.Full:
                # priority displacement: a higher-lane submit meeting a
                # full queue evicts the newest lowest-lane request
                victim = self._q.evict_lowest(below=lane)
                if victim is None:
                    self._reject()
                    raise QueueFull(
                        "serve queue at capacity (%d requests); retry "
                        "later or raise MXNET_SERVE_QUEUE_CAP"
                        % self._q.maxsize) from None
                self._q.put_nowait(req)
            if tenant is not None:
                self._tenant_q[tenant] = self._tenant_q.get(tenant, 0) + 1
            if deadline is not None:
                dq = self._lane_deadline_s.get(lane)
                if dq is None:
                    dq = self._lane_deadline_s[lane] = deque(maxlen=256)
                dq.append(float(deadline))
        if victim is not None:          # outside the lock
            self._shed_mark(victim.lane, victim.tenant, "displaced")
            self._finish(victim, exc=Shed(
                "displaced by %r-lane traffic under overload (queue "
                "full); back off or escalate lanes" % lane))

    def _ensure_dispatcher(self):
        if self._thread is not None and self._thread.is_alive():
            return
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
            except Exception as e:      # noqa: BLE001 — a dead dispatcher
                # strands every queued future; _execute resolves its own
                # requests, so what escaped here had none in hand
                logging.getLogger(__name__).exception(
                    "serve dispatcher error (recovered)")
                events.incr("serve.dispatcher_errors")
                _bb.record("fault", "serve.dispatcher",
                           error=type(e).__name__)
                _bb.crash_dump("serve.dispatcher", e)
                time.sleep(0.01)
            finally:
                del eng

    def _retire(self, req):
        """Return an accepted request's queue slot and release its
        tenant hold: reached exactly once per accepted request."""
        if req.tenant is not None:
            with self._lock:
                n = self._tenant_q.get(req.tenant, 0) - 1
                if n > 0:
                    self._tenant_q[req.tenant] = n
                else:
                    self._tenant_q.pop(req.tenant, None)
        self._q.task_done()

    def _finish(self, req, result=None, exc=None):
        """Resolve a request's future and retire its queue slot, tolerant
        of a caller-side cancel()."""
        try:
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(result)
        except Exception:               # noqa: BLE001 — cancelled/done
            events.incr("serve.cancelled")
        self._retire(req)
        rec, req.rec = req.rec, None
        if rec is not None:
            self._journal.retire(rec, exc=exc)

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
                        rem = min(rem, edl - now)
                    if rem <= 0:
                        break
                    try:
                        item = self._q.get(timeout=min(rem, 0.05))
                    except queue.Empty:
                        continue
            if item.rec is not None:
                item.rec.t_collect = time.monotonic()
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
        self._shed_mark(req.lane, req.tenant, "deadline", deadline=True)
        self._finish(req, exc=DeadlineExceeded(
            "request expired after %.3fs in queue"
            % (time.monotonic() - req.t_enq)))

    def _bucket_for(self, n):
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _svc_estimate(self, bucket):
        """EWMA batch service seconds for `bucket` (the nearest known
        bucket's, scaled by size, when this one has not run), times the
        margin; 0 cold."""
        with self._lock:
            est = self._svc_ewma.get(bucket)
            if est is None and self._svc_ewma:
                near = min(self._svc_ewma, key=lambda b: abs(b - bucket))
                est = self._svc_ewma[near] * (bucket / float(near))
            return (est or 0.0) * self._SVC_MARGIN

    def _execute(self, reqs):
        # reap the already-expired first, then judge feasibility against
        # the service time of the batch that will actually run
        now = time.monotonic()
        fresh = []
        for r in reqs:
            if r.rec is not None:
                r.rec.t_exec = now
            if r.deadline is not None and now > r.deadline:
                self._expire(r)
            else:
                fresh.append(r)
        live = []
        est = self._svc_estimate(
            self._bucket_for(sum(r.n for r in fresh))) if fresh else 0.0
        for r in fresh:
            if r.deadline is not None and now + est > r.deadline:
                self._expire(r)
            elif not r.future.set_running_or_notify_cancel():
                events.incr("serve.cancelled")
                self._retire(r)
                rec, r.rec = r.rec, None
                self._journal.retire(rec, status="cancelled",
                                     reason="cancelled while queued")
            else:
                live.append(r)
        if not live:
            return
        total = sum(r.n for r in live)
        bucket = self._bucket_for(total)
        t_adm = min(r.t_enq for r in live)
        _bb.record_at(time.time() - (time.monotonic() - t_adm), "serve",
                      "queue", depth=self._q.qsize(), bucket=bucket,
                      n=total)
        dev_i = self._pick_replica()
        if self._pools is None:
            self._run_and_fan(live, total, bucket, dev_i)
            return
        self._inflight.acquire()
        with self._lock:
            self._n_inflight += 1
        try:
            self._pools[dev_i].submit(self._run_and_fan, live, total,
                                      bucket, dev_i)
        except RuntimeError:            # pool shut down by a racing
            self._inflight.release()    # close(): resolve, never strand
            with self._lock:
                self._n_inflight -= 1
            for r in live:
                self._finish(r, exc=EngineClosed(
                    "engine closed before dispatch"))

    # -- replica health ------------------------------------------------
    def _pick_replica(self):
        """Health-aware round-robin: skip replicas inside their unhealthy
        cooldown; one whose cooldown expired gets ONE probe batch (its
        window re-arms at once).  All unhealthy fails open to the
        soonest-recovering replica."""
        n = len(self._reps)
        if n == 1:
            self._rr += 1
            return 0
        now = time.monotonic()
        with self._lock:
            for _ in range(n):
                i = self._rr % n
                self._rr += 1
                until = self._unhealthy_until[i]
                if until == 0.0:
                    return i
                if now >= until:
                    self._unhealthy_until[i] = now + self._cooldown
                    events.incr("serve.replica_probes")
                    return i
            i = min(range(n), key=lambda k: self._unhealthy_until[k])
        events.incr("serve.all_replicas_unhealthy")
        return i

    def _replica_failed(self, dev_i, exc):
        """A terminal dispatch failure (retries spent) on `dev_i`."""
        newly = False
        with self._lock:
            self._fail_streak[dev_i] += 1
            streak = self._fail_streak[dev_i]
            if streak >= self._max_fails or \
                    self._unhealthy_until[dev_i] > 0.0:
                newly = self._unhealthy_until[dev_i] == 0.0
                self._unhealthy_until[dev_i] = \
                    time.monotonic() + self._cooldown
        if newly:
            events.incr("serve.replica_unhealthy")
            _bb.record("serve", "replica_unhealthy", replica=int(dev_i),
                       device=str(self._devices[dev_i]),
                       consecutive_fails=int(streak),
                       error=type(exc).__name__, cooldown_s=self._cooldown)
            logging.getLogger(__name__).warning(
                "serving replica %d (%s) marked unhealthy after %d "
                "consecutive failures (%s); routing around it for %.1fs",
                dev_i, self._devices[dev_i], streak, type(exc).__name__,
                self._cooldown)

    def _replica_ok(self, dev_i):
        """A successful dispatch: the streak resets, and an unhealthy
        replica (this was its probe) is re-admitted."""
        recovered = False
        with self._lock:
            self._fail_streak[dev_i] = 0
            if self._unhealthy_until[dev_i] > 0.0:
                self._unhealthy_until[dev_i] = 0.0
                recovered = True
        if recovered:
            events.incr("serve.replica_recovered")
            _bb.record("serve", "replica_recovered", replica=int(dev_i),
                       device=str(self._devices[dev_i]))

    def _run_and_fan(self, live, total, bucket, dev_i):
        """Pad → replay → fan out for one coalesced batch, inline on a
        single-replica engine, on the replica's worker otherwise.  Every
        exit resolves every live future."""
        t0 = time.monotonic()
        for r in live:
            events.observe_time("serve.queue_us", t0 - r.t_enq)
            if r.rec is not None:
                r.rec.t_infer0 = t0
                r.rec.bucket = bucket
        dispatch_span = _tele.span("serve.dispatch", parent=live[0].tele)
        try:
            dispatch_span.start()
            spans, off = [], 0
            for r in live:
                spans.append((off, off + r.n, r.single))
                off += r.n
            try:
                batch = live[0].data if len(live) == 1 else \
                    np.concatenate([r.data for r in live], axis=0)
                if bucket > total:
                    pad = np.zeros((bucket - total,) + batch.shape[1:],
                                   batch.dtype)
                    batch = np.concatenate([batch, pad], axis=0)
                with _tele.span("serve.infer"):
                    outs = retry_transient(
                        lambda: self._run(dev_i, batch, spans),
                        what="serve.infer(bucket=%d)" % bucket,
                        event="serve.retries")
            except Exception as e:      # noqa: BLE001 — fan the failure
                events.incr("serve.failed")
                self._replica_failed(dev_i, e)
                for r in live:
                    self._finish(r, exc=e)
                return
            self._replica_ok(dev_i)
            t1 = time.monotonic()
            dt_svc = t1 - t0
            for r in live:
                if r.rec is not None:
                    r.rec.t_infer1 = t1
            with self._lock:
                prev = self._svc_ewma.get(bucket)
                self._svc_ewma[bucket] = dt_svc if prev is None \
                    else 0.3 * dt_svc + 0.7 * prev
                self._n_batches += 1
                self._dev_batches[dev_i] += 1
                self._bucket_batches[bucket] += 1
            with self._count_lock:
                self._counts["batches"] += 1
                self._counts["requests"] += len(live)
                self._counts["examples"] += total
                self._counts["padded"] += bucket - total
            events.observe_time("serve.infer_us", dt_svc)
            events.incr("serve.batches")
            events.incr("serve.batch_fill", total)
            events.incr("serve.pad_waste", bucket - total)
            events.incr("serve.requests", len(live))
            self._fan_out(live, outs)
        finally:
            dispatch_span.stop()
            if self._pools is not None:
                self._inflight.release()
                with self._lock:
                    self._n_inflight -= 1

    def _fan_out(self, reqs, outs):
        e2e = []
        for r, res in zip(reqs, outs):
            if r.rec is not None:
                r.rec.t_fin = time.monotonic()
            self._finish(r, result=res)
            dt = time.monotonic() - r.t_enq
            e2e.append(dt)
            events.observe_time("serve.e2e_us", dt)
            us = int(dt * 1e6)
            if r.lane is not None:
                events.observe("serve.e2e_us", us, labels={"lane": r.lane})
                events.incr("serve.requests", labels={"lane": r.lane})
            if r.tenant is not None:
                events.observe("serve.e2e_us", us,
                               labels={"tenant": r.tenant})
                events.incr("serve.requests", labels={"tenant": r.tenant})
            if self._version is not None:
                events.observe("serve.e2e_us", us,
                               labels={"version": self._version})
                events.incr("serve.requests",
                            labels={"version": self._version})
        with self._lock:
            self._e2e_s.extend(e2e)

    # -- programs --------------------------------------------------------
    def _torch_dtype(self):
        return torch.from_numpy(np.zeros(0, self._wire_dtype)).dtype

    def _stage(self, rep, bucket, batch_np):
        rep.inputs[bucket].copy_(
            torch.from_numpy(np.ascontiguousarray(batch_np)))

    def _capture(self, dev_i, bucket, batch_np):
        """Capture replica `dev_i`'s program for `bucket`, with
        `batch_np` staged in its static input first (on the CPU the
        capture runs the program on it).  Caller holds the execution
        lock.  Returns the program."""
        rep = self._reps[dev_i]
        dev = rep.device
        with rep.gate.work():
            rep.after_callers()
            with rep.on_stream():
                static_in = torch.zeros(
                    (bucket,) + self._example_shape,
                    dtype=self._torch_dtype(), device=dev)
                rep.inputs[bucket] = static_in
                self._stage(rep, bucket, batch_np)
        block, params = self._block, rep.params

        def program():
            with _model_scope(), _SWAP_LOCK:
                return torch.func.functional_call(block, params,
                                                  (static_in,))

        _prime(dev)
        t0 = time.monotonic()
        try:
            # on the replica's own stream: its graphs' cuBLAS workspace is
            # that stream's, so replicas and engines replaying at once
            # never share one
            prog, out = _gc.capture(program, dev, pool=rep.pool,
                                    stream=rep.stream)
        except Exception as e:
            from ..telemetry import memwatch as _mw
            _mw.guard_oom("serve.capture", e)
            raise
        wall = time.monotonic() - t0
        growth = prog.pool_growth
        if rep.pool is None:
            rep.pool = prog.pool()
        leaves, spec = tree_flatten(out)
        rep.outputs[bucket], rep.spec[bucket] = leaves, spec
        self._programs[(dev_i, bucket)] = prog
        out_bytes = sum(_nbytes(t) for t in leaves)
        rep.rows[bucket] = _costs.note_program(
            "serve", "%s[r%db%d]" % (self._cost_label, dev_i, bucket),
            sig="%s x %s %s on %s" % (bucket, self._example_shape,
                                      self._wire_dtype, dev),
            group="%x:r%d" % (id(self), dev_i),
            param_bytes=rep.param_bytes,
            argument_bytes=rep.param_bytes + _nbytes(static_in),
            output_bytes=out_bytes,
            temp_bytes=max(0, (growth or 0) - out_bytes),
            pool_bytes=growth, capture_s=wall)
        events.incr("serve.traces")
        return prog

    def _run(self, dev_i, batch_np, spans):
        """Run one padded bucket on replica `dev_i` and return each span's
        (lo, hi, single) rows of the outputs, copied off the static
        outputs, once the device has finished."""
        fault.maybe_raise("serve.infer", step=self._n_batches)
        # a benign per-batch stall (latency chaos): slows, never fails
        fault.maybe_slow("serve.slow", step=self._n_batches)
        rep = self._reps[dev_i]
        bucket = batch_np.shape[0]
        key = (dev_i, bucket)
        with self._exec_lock:
            prog, ran = self._programs.get(key), False
            if prog is None:
                if rep.params is None:
                    self._materialize_params(batch_np)
                prog = self._capture(dev_i, bucket, batch_np)
                ran = prog.ran
            with rep.gate.work(), rep.on_stream():
                if not ran:
                    self._stage(rep, bucket, batch_np)
                    prog.replay()
                _costs.invoke(rep.rows[bucket])
                res = [self._slice(rep, bucket, lo, hi, single)
                       for lo, hi, single in spans]
                done = None
                if rep.stream is not None:
                    done = torch.cuda.Event()
                    done.record(rep.stream)
        if done is not None:
            with rep.gate.work():
                done.synchronize()
        if self._degrade_s:
            time.sleep(self._degrade_s)
        return res

    def _slice(self, rep, bucket, lo, hi, single):
        """One request's own copy of its rows (a held result must not
        pin the bucket's outputs, which the next replay overwrites);
        sign-flipped under the bad-version taint.  The copy is made on
        the replica's stream and handed to a client that reads it on its
        device's default stream: the allocator reuses its block only
        after what that stream queued before the client freed it."""
        flip = bool(self._degrade_s)
        client = torch.cuda.default_stream(rep.device) \
            if rep.stream is not None else None

        def take(a):
            t = (a[lo] if single else a[lo:hi]).clone()
            if flip:
                t.neg_()
            if client is not None:
                t.record_stream(client)
            return t

        leaves = [take(a) for a in rep.outputs[bucket]]
        return tree_unflatten(leaves, rep.spec[bucket])

    # -- warmup --------------------------------------------------------
    def warmup(self, example_shape=None, wire_dtype=None):
        """Capture EVERY (replica, bucket) program before traffic and run
        each once, so no request ever pays a capture.  Needs the example
        signature from the constructor, a prior request, or the
        arguments.  Returns a summary dict; after it ``serve.traces``
        stays flat under any mix of request sizes."""
        if self._example_shape is None and example_shape is None:
            raise ValueError("warmup() before any request needs "
                             "example_shape= (and wire_dtype=) — the "
                             "programs' signature")
        self._check_example(
            tuple(example_shape) if example_shape is not None
            else self._example_shape,
            wire_dtype or self._wire_dtype or "float32")
        dtype = np.dtype(self._wire_dtype)
        t0 = time.monotonic()
        traces0 = events.get("serve.traces")
        per_bucket = {}
        try:
            # the deterministic OOM drill: the serve.oom fault site
            # raises through the same catch an allocator failure takes
            fault.maybe_raise(
                "serve.oom", 0, msg="CUDA out of memory while warming "
                "%r (injected)" % self._cost_label)
            for i in range(len(self._reps)):
                for b in self._buckets:
                    x = np.zeros((b,) + self._example_shape, dtype)
                    tb = time.monotonic()
                    self._run(i, x, [])
                    per_bucket[b] = round(time.monotonic() - tb, 4)
                    self._count("warmup_batches")
        except Exception as e:
            from ..telemetry import memwatch as _mw
            _mw.guard_oom("serve.warmup", e)
            raise
        self._warm = True
        events.incr("serve.warmups")
        return {"buckets": list(self._buckets),
                "devices": len(self._reps),
                "wall_s": round(time.monotonic() - t0, 3),
                "bucket_wall_s": per_bucket,
                "captures": events.get("serve.traces") - traces0,
                "traces": events.get("serve.traces")}

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
                if (self._thread is None or
                        not self._thread.is_alive()) and \
                        not self._n_inflight:
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
        joined = True
        if t is not None and t.is_alive():
            t.join(max(0.1, t_end - time.monotonic()))
            joined = not t.is_alive()
        if self._pools is not None:     # in-flight replica batches
            for p in self._pools:       # complete (and resolve) first
                p.shutdown(wait=True)
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
        self.uninstall_sigterm()
        return joined

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # flags only: never join a thread from a finalizer
        self._draining = True
        self._stop = True
        self._closed = True
        try:
            self.uninstall_sigterm()
        except Exception:               # noqa: BLE001
            pass

    # -- introspection -------------------------------------------------
    def held_tensors(self):
        """The tensors this engine holds: each replica's parameter copy,
        static inputs and static outputs."""
        out = []
        for rep in self._reps:
            out += list((rep.params or {}).values())
            out += list(rep.inputs.values())
            for leaves in rep.outputs.values():
                out += [t for t in leaves if isinstance(t, torch.Tensor)]
        return out

    def slo_targets(self):
        """{lane: tightest relative deadline seconds among the last 256
        accepted deadlined requests}: the per-lane SLO targets of the
        default serving rules."""
        with self._lock:
            return {lane: min(dq)
                    for lane, dq in self._lane_deadline_s.items() if dq}

    def slo_lane_quotas(self):
        """{lane: the occupancy quota fraction this engine enforces}."""
        cap = float(self._q.maxsize)
        return {lane: (1.0 if c is None else c / cap)
                for lane, c in self._lane_caps.items()}

    def stats(self):
        """The engine's own counts (requests, batches, warmup_batches,
        examples, padded, rejected, expired, bucket_batches, e2e p50/p99
        ms over the recent resolved requests) and the JAX engine's keys:
        the process-wide ``serve.*`` counters and percentiles, buckets,
        devices, per-replica batches and health, queue and lane depths,
        tenants, version, degraded, warm."""
        now = time.monotonic()
        with self._count_lock:
            out = dict(self._counts)
        with self._lock:
            out["bucket_batches"] = dict(self._bucket_batches)
            e2e = np.asarray(self._e2e_s, dtype=np.float64)
            tenants = dict(self._tenant_q)
            health = ["unhealthy" if u > now else
                      ("probing" if u > 0.0 else "healthy")
                      for u in self._unhealthy_until]
            dev_batches = list(self._dev_batches)
        if e2e.size:
            out["e2e_p50_ms"] = float(np.percentile(e2e, 50) * 1e3)
            out["e2e_p99_ms"] = float(np.percentile(e2e, 99) * 1e3)
        out.update({
            "counters": serve_counters(),
            "latency": events.latency_snapshot("serve."),
            "labeled": events.labeled_latency_snapshot("serve."),
            "buckets": list(self._buckets),
            "devices": [str(d) for d in self._devices],
            "device_batches": dev_batches,
            "replica_health": health,
            "queue_depth": self._q.qsize(),
            "lanes": {"order": list(self._lanes),
                      "depths": self._q.lane_depths(),
                      "caps": dict(self._lane_caps)},
            "tenants_queued": tenants,
            "version": self._version,
            "degraded": bool(self._degrade_s),
            "warm": self._warm,
            "captures": len(self._programs)})
        return out
