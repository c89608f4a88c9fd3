"""The device feed of the PyTorch port (counterpart of
incubator_mxnet_tpu/io/device_feed.py): host batches onto the card while
the current step runs, uint8 on the wire.

1. **uint8 on the wire.**  The decode paths ship raw augmented pixels
   (`dtype="uint8"`), 4x fewer host-to-device bytes than float32.  The
   mean/std normalize and the cast to the compute dtype run on the card
   inside the captured step (`HybridBlock.set_input_transform` with
   `normalize_transform`), so the float tensor exists only there.
2. **Overlap.**  A background thread reads the next batch from the
   source and places it while the consumer's step runs; `depth`
   batches in flight (``MXNET_FEED_DEPTH``, 2 = double buffer).
3. **Placement on a CUDA target.**  The thread copies each host leaf
   into one of `depth` page-locked staging buffers, issues
   ``copy_(..., non_blocking=True)`` into a fresh device tensor on a
   side CUDA stream the feed owns, and records an event.  The consumer's
   stream waits on that event (``wait_event``: no host sync), and every
   delivered tensor is marked ``record_stream(consumer stream)``, so the
   caching allocator hands its memory to no one else while the step
   reads it.  A staging buffer is refilled only after its last copy's
   event completed.  On a CPU target there is no pinning and no stream:
   the feed copies a numpy leaf (`torch.from_numpy` aliases, and the
   decode service recycles its slabs).

4. **Placement on a mesh.**  With `sharding=` (a
   `parallel.NamedSharding` whose spec splits dimension 0 along a mesh
   axis, or replicates with `P()`), each leaf comes back as a
   `parallel.Shards`: one NDArray per replica of the mesh, holding that
   replica's rows (or the whole leaf), placed on its device as above,
   through a staging ring and a copy stream per card; a CPU replica's
   piece carries its context (`context.tag_replica`).
   `ShardedTrainer.step` takes such leaves as they are.

``MXNET_FEED_ASYNC=0`` reads and places in the consumer (same counters,
no thread).

Counters on `monitor.events` (microseconds, bytes, counts):

    feed.read_us      source wall (read + decode) in the thread
    feed.transfer_us  placement wall in the thread: staging into pinned
                      memory and issuing the copy (a CPU target: the
                      copy); the copy itself runs on the side stream
    feed.stall_us     consumer wait: the step starved by the feed
    feed.step_us      consumer wall between batches: the step side
    feed.bytes        bytes shipped on the wire
    feed.queue_depth  ready batches when the consumer arrived (observed)
    feed.batches / feed.epochs

A stall above 1 ms also records a ``("feed", "stall")`` event with the
queue depth in the flight recorder's ring; ``feed.read`` and
``feed.transfer`` spans join the consumer's trace.
"""
from __future__ import annotations

import queue
import threading
import time
import weakref

import numpy as _np

from .. import config as _cfg
from ..monitor import events
from ..telemetry import flightrec as _bb
from ..telemetry import spans as _tele

#: consumer waits above this land in the flight recorder's ring
_STALL_RECORD_US = 1000

__all__ = ["DeviceFeed", "feed_counters", "make_normalizer",
           "normalize_transform"]

_EOE = ("eoe", None)
#: numpy dtypes that the port's arrays narrow, as `nd.array` does
_NARROW = {_np.dtype(_np.float64): _np.float32,
           _np.dtype(_np.int64): _np.int32,
           _np.dtype(_np.uint64): _np.uint32}


def feed_counters():
    """Snapshot of the `feed.*` counters (us, bytes, counts)."""
    return events.snapshot("feed.")


def _channel_const(v, ndim, axis):
    """A scalar or per-channel sequence as a float32 numpy constant that
    broadcasts against an `ndim`-rank batch on `axis` (1 for NCHW)."""
    arr = _np.asarray(v, _np.float32)
    if arr.ndim == 0:
        return arr
    shape = [1] * ndim
    shape[axis] = arr.shape[0]
    return arr.reshape(shape)


def make_normalizer(mean=127.5, std=64.0, dtype="bfloat16", axis=1):
    """A tensor function ``x -> ((x.float32 - mean) / std).to(dtype)``;
    `mean`/`std` are scalars or per-channel sequences on channel axis
    `axis`.  Its constants are made once per (rank, device), so that a
    captured program reads them and copies nothing from the host."""
    import torch
    from ..base import nd_dtype
    dt = nd_dtype(dtype)
    cache = {}

    def norm(x):
        y = x.to(torch.float32)
        key = (y.ndim, y.device)
        consts = cache.get(key)
        if consts is None:
            consts = cache[key] = tuple(
                torch.from_numpy(_np.array(_channel_const(v, y.ndim, axis)))
                .to(y.device) for v in (mean, std))
        return ((y - consts[0]) / consts[1]).to(dt)

    return norm


def normalize_transform(mean=127.5, std=64.0, dtype="bfloat16", axis=1):
    """The NDArray form of `make_normalizer`, for
    `HybridBlock.set_input_transform`: run inside the hybridized step's
    captured program, so that uint8 stays the wire format and the
    normalize runs on the card as part of the step."""
    from .. import ndarray as nd
    cache = {}      # (ndim, device) -> constant NDArrays, made once

    def transform(x):
        y = x.astype("float32")
        key = (y.ndim, x.context)
        consts = cache.get(key)
        if consts is None:
            consts = cache[key] = (
                nd.array(_channel_const(mean, y.ndim, axis), ctx=x.context),
                nd.array(_channel_const(std, y.ndim, axis), ctx=x.context))
        m, s = consts
        return ((y - m) / s).astype(dtype)

    return transform


class _Stager:
    """The pinned staging buffers of a CUDA target, one slot per batch in
    flight, and the side stream the copies run on."""

    def __init__(self, device, slots):
        import torch
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._bufs = [dict() for _ in range(slots)]
        self._events = [None] * slots
        self._next = 0

    def place(self, hosts):
        """Device tensors of the host leaves `hosts` (numpy arrays or CPU
        tensors, in place where already on the device), copied through
        the next staging slot on the side stream; and the copy's event."""
        import torch
        k = self._next
        self._next = (k + 1) % len(self._bufs)
        if self._events[k] is not None:
            self._events[k].synchronize()   # the slot's last copy is done
        bufs = self._bufs[k]
        out = []
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            for i, h in enumerate(hosts):
                if isinstance(h, torch.Tensor) and h.device == self.device:
                    out.append(h)
                    continue
                dtype = h.dtype if isinstance(h, torch.Tensor) else \
                    torch.from_numpy(_np.empty(0, h.dtype)).dtype
                pinned = bufs.get(i)
                if pinned is None or pinned.dtype != dtype \
                        or tuple(pinned.shape) != tuple(h.shape):
                    pinned = bufs[i] = torch.empty(tuple(h.shape),
                                                   dtype=dtype,
                                                   pin_memory=True)
                if isinstance(h, torch.Tensor):
                    pinned.copy_(h)
                else:
                    pinned.numpy()[...] = h
                d = torch.empty(tuple(h.shape), dtype=dtype,
                                device=self.device)
                d.copy_(pinned, non_blocking=True)
                out.append(d)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self._events[k] = ev
        return out, ev


class DeviceFeed:
    """Background-transfer iterator over host batches.

    source: an iterable of host batches (numpy arrays, NDArrays or
        tensors, or tuples, lists and dicts of them), or a zero-argument
        callable returning a fresh iterator per epoch.  A source that is
        not callable and has ``reset()`` is reset between epochs.
    ctx: the target device (default `cuda:0`); batches come back as
        NDArrays on it.
    sharding: a `parallel.NamedSharding` to place each batch across the
        replicas of its mesh (module doc, 4.), instead of `ctx`.
    depth: batches in flight and pinned staging slots (default
        ``MXNET_FEED_DEPTH``).
    transform: a host function applied to each raw batch in the thread
        (label reshapes, ...) before the transfer.

    Iteration yields one epoch.  `reset()` starts the next, dropping the
    batches in flight; `iter()` after the end re-arms the next epoch.
    """

    def __init__(self, source, ctx=None, sharding=None, depth=None,
                 transform=None):
        from ..context import resolve_device
        self._replicas = None
        if sharding is not None:
            from ..parallel.mesh import mesh_devices
            spec = tuple(sharding.spec)
            if any(a is not None for a in spec[1:]):
                raise NotImplementedError(
                    "DeviceFeed(sharding=%r): only the batch dimension "
                    "(dim 0) is split across replicas" % (sharding,))
            self._split_rows = bool(spec) and spec[0] is not None
            self._replicas = mesh_devices(sharding.mesh)
            ctx = self._replicas[0]
        # resolved here, not in the thread
        self._device = resolve_device(ctx)
        self._source = source
        self._transform = transform
        self._depth = max(1, int(depth if depth is not None
                                 else _cfg.get("MXNET_FEED_DEPTH")))
        self._async = bool(_cfg.get("MXNET_FEED_ASYNC"))
        self._stager = None
        self._stagers = {}
        self._gen = 0               # epoch generation; bumping it
        self._q = None              # retires the thread at its next put
        self._thread = None
        self._epoch_it = None
        self._tele_parent = None
        self._exhausted = False
        self._started = False
        self._last_t = None

    @property
    def device(self):
        return self._device

    # -- placement -----------------------------------------------------
    def _host(self, leaf):
        import torch
        from ..ndarray.ndarray import NDArray
        if isinstance(leaf, NDArray):
            leaf = leaf._data
        if isinstance(leaf, torch.Tensor):
            return leaf.detach()
        arr = _np.asarray(leaf)
        narrow = _NARROW.get(arr.dtype)
        return arr.astype(narrow) if narrow is not None else arr

    def _place(self, batch):
        """(placed batch of tensors on the target, the copy's event or
        None, wire bytes)."""
        import torch
        from torch.utils._pytree import tree_flatten, tree_unflatten
        leaves, spec = tree_flatten(batch, is_leaf=_is_array)
        hosts = [self._host(l) for l in leaves]
        nbytes = sum(int(h.nbytes) if isinstance(h, _np.ndarray)
                     else h.numel() * h.element_size() for h in hosts)
        if self._replicas is not None:
            placed, evs = self._place_shards(hosts)
            return tree_unflatten(placed, spec), evs, nbytes
        if self._device.type != "cuda":
            out = [torch.from_numpy(_np.array(h, copy=True))
                   if isinstance(h, _np.ndarray) else h.to(self._device)
                   for h in hosts]
            return tree_unflatten(out, spec), None, nbytes
        if self._stager is None:
            self._stager = _Stager(self._device, self._depth)
        out, ev = self._stager.place(hosts)
        return tree_unflatten(out, spec), ev, nbytes

    def _place_shards(self, hosts):
        """Per leaf, a `Shards` of the replicas' pieces on their devices;
        and the copies' events (None without a card)."""
        import torch
        from ..context import tag_replica
        from ..parallel.mesh import Shards
        n = len(self._replicas)
        per, evs = [], []
        for r, dev in enumerate(self._replicas):
            pieces = []
            for h in hosts:
                if self._split_rows:
                    if h.shape[0] % n:
                        raise ValueError(
                            "a batch of %d rows does not split over %d "
                            "replicas" % (h.shape[0], n))
                    rows = h.shape[0] // n
                    h = h[r * rows:(r + 1) * rows]
                pieces.append(h)
            if dev.type != "cuda":
                out = [tag_replica(torch.from_numpy(_np.array(h, copy=True))
                                   if isinstance(h, _np.ndarray)
                                   else h.to("cpu", copy=True), dev)
                       for h in pieces]
            else:
                stager = self._stagers.get(dev)
                if stager is None:
                    stager = self._stagers[dev] = _Stager(dev, self._depth)
                out, ev = stager.place(pieces)
                evs.append(ev)
            per.append(out)
        return ([Shards(per[r][i] for r in range(n))
                 for i in range(len(hosts))], evs or None)

    def _deliver(self, placed, ev):
        """The consumer's side: its stream waits on the copy's event, each
        tensor is marked as used by that stream, NDArrays come out."""
        from torch.utils._pytree import tree_flatten, tree_map
        from ..ndarray.ndarray import _wrap
        if isinstance(ev, list):
            import torch
            from ..parallel.mesh import Shards
            leaves, _ = tree_flatten(
                placed, is_leaf=lambda x: isinstance(x, Shards))
            for leaf in leaves:
                for t in leaf:
                    if t.is_cuda:
                        stream = torch.cuda.current_stream(t.device)
                        for e in ev:
                            stream.wait_event(e)
                        t.record_stream(stream)
            return tree_map(lambda t: Shards(_wrap(x) for x in t), placed,
                            is_leaf=lambda x: isinstance(x, Shards))
        if self._replicas is not None:
            from ..parallel.mesh import Shards
            return tree_map(lambda t: Shards(_wrap(x) for x in t), placed,
                            is_leaf=lambda x: isinstance(x, Shards))
        if ev is not None:
            import torch
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ev)
            for t in tree_flatten(placed)[0]:
                t.record_stream(stream)
        return tree_map(_wrap, placed)

    # -- worker --------------------------------------------------------
    def _epoch_iter(self):
        src = self._source
        return iter(src() if callable(src) else src)

    @staticmethod
    def _run(ref, gen, q):
        """The thread's loop.  It holds the feed only through a weakref
        (strongly only between queue waits), so that a feed dropped
        mid-epoch is collected, whose `close()` retires the thread."""
        while True:
            feed = ref()
            if feed is None or feed._gen != gen:
                return
            parent = feed._tele_parent
            t0 = time.perf_counter()
            try:
                with _tele.span("feed.read", parent=parent):
                    batch = next(feed._epoch_it)
                    if feed._transform is not None:
                        batch = feed._transform(batch)
                t1 = time.perf_counter()
                with _tele.span("feed.transfer", parent=parent):
                    placed, ev, nbytes = feed._place(batch)
            except StopIteration:
                del feed
                DeviceFeed._safe_put(ref, q, gen, _EOE)
                return
            except Exception as e:              # noqa: BLE001
                # read, transform and transfer errors all reach the
                # consumer as ('error', e), never a silent hang
                del feed
                DeviceFeed._safe_put(ref, q, gen, ("error", e))
                return
            events.add_time("feed.read_us", t1 - t0)
            events.add_time("feed.transfer_us", time.perf_counter() - t1)
            events.incr("feed.bytes", nbytes)
            del feed, batch
            if not DeviceFeed._safe_put(ref, q, gen,
                                        ("batch", (placed, ev))):
                return
            del placed, ev

    @staticmethod
    def _safe_put(ref, q, gen, item):
        """A bounded put that gives up once the epoch generation moves on
        or the feed is collected while the queue is full."""
        while True:
            feed = ref()
            if feed is None or feed._gen != gen:
                return False
            del feed
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue

    def _start(self):
        self._exhausted = False
        self._started = True
        self._last_t = None
        self._tele_parent = _tele.current()
        self._epoch_it = self._epoch_iter()
        events.incr("feed.epochs")
        if self._async:
            self._gen += 1
            self._q = queue.Queue(maxsize=self._depth)
            self._thread = threading.Thread(
                target=DeviceFeed._run,
                args=(weakref.ref(self), self._gen, self._q),
                daemon=True, name="DeviceFeed")
            self._thread.start()

    # -- consumer ------------------------------------------------------
    def __iter__(self):
        if self._exhausted:
            self.reset()
        elif not self._started:
            self._start()
        return self

    def __next__(self):
        if self._exhausted:
            raise StopIteration
        if not self._started:
            self._start()
        t0 = time.perf_counter()
        if self._last_t is not None:
            events.add_time("feed.step_us", t0 - self._last_t)
        if not self._async:
            out = self._next_sync(t0)
        else:
            depth = self._q.qsize()
            events.observe("feed.queue_depth", depth)
            kind, val = self._q.get()
            stall_s = time.perf_counter() - t0
            events.add_time("feed.stall_us", stall_s)
            stall_us = int(stall_s * 1e6)
            if stall_us > _STALL_RECORD_US:
                # depth 0: the source (decode) starved the thread
                _bb.record("feed", "stall", us=stall_us, qdepth=depth)
            if kind == "eoe":
                self._exhausted = True
                raise StopIteration
            if kind == "error":
                self._exhausted = True
                raise val
            events.incr("feed.batches")
            out = self._deliver(*val)
        self._last_t = time.perf_counter()
        return out

    def _next_sync(self, t0):
        try:
            batch = next(self._epoch_it)
        except StopIteration:
            self._exhausted = True
            raise
        if self._transform is not None:
            batch = self._transform(batch)
        t1 = time.perf_counter()
        placed, ev, nbytes = self._place(batch)
        events.add_time("feed.read_us", t1 - t0)
        events.add_time("feed.transfer_us", time.perf_counter() - t1)
        events.incr("feed.bytes", nbytes)
        events.incr("feed.batches")
        return self._deliver(placed, ev)

    def reset(self):
        """Begin a new epoch: the batches in flight are dropped, the source
        is reset (its `reset()`, or a fresh call when it is callable) and
        the prefetch restarts."""
        self._gen += 1              # retire the old thread...
        t = self._thread
        if t is not None and t.is_alive():
            t.join()                # ...and wait it out
        self._thread = None
        self._epoch_it = None
        src = self._source
        if not callable(src) and hasattr(src, "reset"):
            src.reset()
        self._start()

    def close(self):
        """Stop the thread and wait for it (it ends after at most the
        source pull it is in); `next()` then raises StopIteration
        (`reset()`/`iter()` re-arm).  The source may be closed after."""
        self._gen += 1
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join()
        self._thread = None
        self._epoch_it = None
        self._started = False
        self._exhausted = True

    def __del__(self):
        try:
            self.close()
        except Exception:           # noqa: BLE001
            pass


def _is_array(x):
    """Leaves of a batch: arrays and NDArrays (torch's pytree would
    otherwise see neither as a leaf of its own kind)."""
    from ..ndarray.ndarray import NDArray
    return isinstance(x, (NDArray, _np.ndarray))
