"""Captured programs of the PyTorch port: what a hybridized block and a
`gluon.Trainer` replay instead of running their Python again (the
counterpart of the JAX package's jitted executables: `_CachedGraph` in
incubator_mxnet_tpu/gluon/block.py, `_fused_multi` in
incubator_mxnet_tpu/optimizer/optimizer.py).

`capture(fn, device, pool=None, stream=None)` captures `fn()` and returns
`(program, result)`; `program.replay()` runs what `fn` issued, on the
same tensors, and `program.ran` says whether the capture itself ran it
once (a recording does; a CUDA graph's capture only records its
launches):

* on a CUDA device the program is a `torch.cuda.CUDAGraph` (in the
  memory pool `pool`, where given), captured with the port's generator
  registered (`random.register_with_graph`) and replayed on the current
  stream;
* on the CPU, where the caller asked for it, the program is the list of
  aten ops that `fn` issued, recorded under a `TorchDispatchMode` while
  they ran.  A replay issues each op again on the recorded arguments and
  copies each fresh result into the storage of the recorded one, so that
  every tensor keeps its storage across replays, as in a graph's pool.
  It is not a fallback: a CUDA tensor never takes it.

Either program keeps a CUDA graph's rules, so that the CPU tests catch
what breaks them: Python values are frozen at capture, a replay reads
and writes the storage that the capture saw (a tensor replaced since is
not read), and its results are the same tensors each replay.  A host
read of a device value (`.item()`, `nonzero`, ...) inside `fn` raises
`CaptureError` naming the op, as does any other failure of a capture,
with the last op issued before it.  Nothing falls back to eager.  A
failed CUDA capture leaves the generators it held (the device's default
one and the port's) marked as capturing; each is given a copy of its own
state, at the same seed and offset, so that it draws again.

No other engine may launch work on a card while a capture is open on
it.  Each device has one `DeviceGate`, shared by every engine on it: a
capture holds it alone, and device work that may run beside another
engine (a serving engine's staging, replay, result copies and waits)
holds it shared, so a capture waits for that work to finish and holds
the next off.  A CUDA graph is captured with
``capture_error_mode="thread_local"``, which holds the capturing thread
to the capture's rules and leaves what other threads still do on the
host meanwhile (a client dropping a result tensor) to them.  A captured
GEMM bakes in the cuBLAS workspace of the stream it was captured on, so
programs that may replay at the same time on different streams are
captured on different streams (`capture(..., stream=)`): on torch's one
shared capture stream, one engine's replay hung on the H100 beside
another engine's (`tests/test_torch_cuda.py::
test_capture_while_another_engine_serves`).

The kernels' launch counters (`ops.attention`, `ops.conv_stats`) count
what their wrappers issue, a capture's launches into its graph included;
a replay runs no wrapper and counts nothing, so a replayed step's
launches are read from the profiler's kernel names.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from . import random as _rnd
from .base import MXNetError

__all__ = ["CaptureError", "capture", "DeviceGate", "gate"]

_aten = torch.ops.aten
#: ops whose result is a host value read from the device, or whose shape
#: depends on device values
_HOST_READS = frozenset((_aten._local_scalar_dense, _aten.nonzero,
                         _aten.equal, _aten.is_nonzero,
                         _aten.masked_select, _aten._unique2,
                         _aten.unique_consecutive, _aten.unique_dim))


class CaptureError(MXNetError):
    """A program could not be captured."""


class DeviceGate:
    """Captures on one device exclusive, device work shared.

    `work()` is shared and reentrant; `exclusive()` waits until no other
    thread works or captures, and holds new work off meanwhile (a waiting
    capture is not starved).  A thread that works and then captures
    gives its shared hold up while it waits and takes it back after, so
    two such threads never wait on each other."""

    def __init__(self):
        self._cond = threading.Condition()
        self._shared = {}           # thread id -> shared depth
        self._owner = None          # thread holding it exclusively
        self._waiting = 0           # exclusive requests waiting

    @contextlib.contextmanager
    def work(self):
        me = threading.get_ident()
        with self._cond:
            if self._owner != me and me not in self._shared:
                while self._owner is not None or self._waiting:
                    self._cond.wait()
            self._shared[me] = self._shared.get(me, 0) + 1
        try:
            yield
        finally:
            with self._cond:
                n = self._shared[me] - 1
                if n:
                    self._shared[me] = n
                else:
                    del self._shared[me]
                self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        with self._cond:
            held = self._shared.pop(me, 0)
            self._waiting += 1
            self._cond.notify_all()
            try:
                while self._owner is not None or self._shared:
                    self._cond.wait()
            finally:
                self._waiting -= 1
            self._owner = me
        try:
            yield
        finally:
            with self._cond:
                self._owner = None
                if held:
                    self._shared[me] = held
                self._cond.notify_all()


_GATES = {}
_GATES_LOCK = threading.Lock()


def gate(device):
    """The `DeviceGate` of `device` (one per device, process-wide)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    with _GATES_LOCK:
        g = _GATES.get(key)
        if g is None:
            g = _GATES[key] = DeviceGate()
        return g


class _Watch(TorchDispatchMode):
    """Refuses host reads and names the last op issued; with `record`,
    keeps (op, args, kwargs, result) of every op it lets run."""

    def __init__(self, record):
        super().__init__()
        self.ops = [] if record else None
        self.last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.last = func
        if func.overloadpacket in _HOST_READS:
            raise CaptureError(
                "%s reads a device value on the host, which a captured "
                "program cannot do" % func)
        out = func(*args, **kwargs)
        if self.ops is not None:
            self.ops.append((func, args, kwargs, out))
        return out


def _alias(t):
    """A tensor's storage under a version counter of its own (a replay
    neither bumps the versions that autograd checks nor records)."""
    return t.data if isinstance(t, torch.Tensor) else t


def _same_storage(a, b):
    return (isinstance(b, torch.Tensor) and a.untyped_storage().data_ptr()
            == b.untyped_storage().data_ptr())


class _Recording:
    """The aten ops one capture issued on the CPU, replayed in order."""

    def __init__(self, ops):
        self._plan = [(func, tree_map(_alias, args), tree_map(_alias, kw),
                       [_alias(o) if isinstance(o, torch.Tensor) else None
                        for o in tree_flatten(out)[0]])
                      for func, args, kw, out in ops]

    #: the capture ran the ops
    ran = True
    #: no graph pool on the CPU
    pool_growth = None

    def pool(self):
        return None

    @torch.no_grad()
    def replay(self):
        for func, args, kwargs, outs in self._plan:
            fresh = tree_flatten(func(*args, **kwargs))[0]
            for rec, new in zip(outs, fresh):
                if rec is not None and not _same_storage(rec, new):
                    rec.copy_(new)


class _Graph:
    """A captured CUDA graph; `pool_growth` is what its capture added to
    its graph pool's segments (bytes; None where the allocator does not
    say)."""

    def __init__(self, graph, pool_growth):
        self.graph = graph
        self.pool_growth = pool_growth

    #: a capture runs nothing on the device
    ran = False

    def pool(self):
        return self.graph.pool()

    def replay(self):
        self.graph.replay()


def _release_generators(device):
    """Out of capture, at the same seed and offset, the generators that a
    failed capture on `device` held."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    for gen in (torch.cuda.default_generators[index],
                _rnd.generator(device)):
        gen.graphsafe_set_state(gen.clone_state())


def _pool_bytes(device, pool):
    """Bytes of the allocator's segments that belong to graph pool `pool`
    on `device` (0 for no pool yet), or None when the snapshot does not
    tag segments with their pool."""
    if pool is None:
        return 0
    segs = [s for s in torch.cuda.memory_snapshot()
            if s.get("device") == device.index]
    if segs and not all("segment_pool_id" in s for s in segs):
        return None
    return sum(int(s["total_size"]) for s in segs
               if tuple(s["segment_pool_id"]) == tuple(pool))


def _failed(watch, exc):
    return CaptureError("capture failed at %s: %s: %s"
                        % (watch.last, type(exc).__name__, exc))


def capture(fn, device, pool=None, stream=None):
    """Capture `fn()` on `device` ("cuda..." or "cpu") while holding the
    device's gate alone; returns (program, what fn returned).  `stream`
    is the CUDA stream the graph is captured on (default: torch's one
    shared capture stream).  The cuBLAS workspace a captured GEMM uses is
    the capture stream's, baked into the graph: graphs that may replay at
    the same time on different streams must be captured on different
    streams."""
    device = torch.device(device)
    with gate(device).exclusive():
        return _capture(fn, device, pool, stream)


def _capture(fn, device, pool, stream):
    if device.type == "cpu":
        watch = _Watch(record=True)
        try:
            with watch:
                out = fn()
        except CaptureError:
            raise
        except Exception as exc:
            raise _failed(watch, exc) from exc
        return _Recording(watch.ops), out
    if device.type != "cuda":
        raise CaptureError("no captured programs on %s" % device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    graph = torch.cuda.CUDAGraph()
    _rnd.register_with_graph(graph, device)
    before = _pool_bytes(device, pool)
    watch = _Watch(record=False)
    # torch.cuda.graph collects garbage before it starts; a collection
    # inside the capture could free another program's graph (one that a
    # cycle held), which invalidates the capture
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.device(device), torch.cuda.graph(
                graph, pool=pool, stream=stream,
                capture_error_mode="thread_local"):
            with watch:
                out = fn()
    except Exception as exc:
        _release_generators(device)
        if isinstance(exc, CaptureError):
            raise
        raise _failed(watch, exc) from exc
    finally:
        if collecting:
            gc.enable()
    after = _pool_bytes(device, graph.pool())
    growth = None if before is None or after is None else after - before
    return _Graph(graph, growth), out
