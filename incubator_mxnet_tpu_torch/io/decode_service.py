"""Multi-process decode service of the PyTorch port (a port of
incubator_mxnet_tpu/io/decode_service.py): the shared-memory data plane
under `ImageRecordIter(workers=N)` and `DeviceFeed`.

1. **Processes.**  A `DecodeService` runs N worker processes, which
   decode in parallel without the interpreter lock.  A worker runs
   numpy, PIL and the recordio framing only, and never calls torch:
   the parent holds a CUDA context, the feed's thread and the caching
   allocator, and a forked child that makes any CUDA call dies or
   hangs.  The resize is this module's own numpy triangle filter
   (`_axis_resize`).  A startup handshake turns a pool whose workers
   never report ready into `DecodeServiceUnavailable`, never a hang;
   the start method is ``MXNET_IO_MP_START`` (``fork`` by default).
2. **Sharded readers.**  Each worker owns a disjoint, deterministic
   shard of the records per epoch (`shard_records`): every worker
   computes the same seeded permutation for (seed, epoch) and takes a
   strided slice of its batch-sized blocks, so every record is decoded
   once per epoch with no coordination, and at most one batch per epoch
   is partial.  The parent resolves a byte offset per record (the
   ``.idx`` sidecar, else `recordio.list_record_offsets`) and every
   worker seeks on its own file handle.
3. **Shared-memory slab ring.**  Batches land in uint8 or float32 slabs
   of one `multiprocessing.shared_memory` segment.  The queues carry
   slot numbers, never pixels: no per-batch pickling and no copy on the
   way to the consumer, which hands the slab view to `DeviceFeed`
   (uint8 on the wire; mean/std and the cast run on the card through
   `set_input_transform`).

Slab lifetime: `DecodeService.__next__` recycles the previous batch's
slot when it is called, by which time each consumer of this package
(the feed stages batch N before it pulls N+1; the synchronous path
copies at once) is done with the view.  A holder that keeps a slab
longer calls `SlabBatch.release()` when done (idempotent).

A worker that dies mid-epoch is respawned (up to
``MXNET_IO_WORKER_RESTARTS`` pool-wide, counted on
``io.decode.worker_restarts``); its replacement resumes the same
(wid, epoch) slice at the first undelivered batch.  The augmentation RNG
derives from (seed, epoch, wid, seq, record), so the resumed stream is
bit for bit the uninterrupted one.  Past the budget a dead worker is a
mid-epoch error.

Corrupt records are quarantined, not fatal: with a ``<rec>.crc``
sidecar present every payload's CRC is checked before decode, and a
mismatching or undecodable record is skipped (the batch ships short),
booked by the parent (``io.decode.records_corrupt``, a ring event, a
quarantine JSONL entry naming file and offset) under the per-epoch
``MXNET_IO_CORRUPT_BUDGET`` (past it: `CorruptRecordBudgetExceeded`).

Counters (`monitor.events`):

    io.decode.batches / records / bytes    volume
    io.decode.wait_us                      consumer wait on the ring
    io.decode.queue_depth                  ready batches (observed)
    io.decode.epochs                       epochs announced
    io.decode.worker_restarts              dead workers respawned
    io.decode.records_corrupt              records quarantined

A consumer wait above 1 ms records an ``("io", "stall")`` event with the
queue depth in the flight recorder's ring.  Workers emit no spans: each
batch message carries the decode interval's wall clock, and the consumer
emits an ``io.decode`` span on the worker's behalf
(`telemetry.emit_foreign`, the worker's pid, under the consumer's
innermost span, stamped with the global step); the `SlabBatch` carries
its `TraceContext` in ``.trace``.

A host where shared memory or process start is unavailable raises
`DecodeServiceUnavailable` from the constructor; `ImageRecordIter`
warns once and uses the native or threaded pipeline.
"""
from __future__ import annotations

import gc
import os
import queue as _queue
import threading
import time
import warnings

import numpy as _np

from .. import config as _cfg
from .. import fault as _fault
from ..integrity import (CorruptRecordBudgetExceeded, RecordCorrupt,
                         checksum_fn)
from ..monitor import events
from .recordio import (idx_sidecar_path, list_record_offsets,
                       read_crc_sidecar, read_record, unpack_img)

__all__ = ["DecodeService", "DecodeServiceUnavailable", "SlabBatch",
           "shard_records", "decode_record", "service_available"]

#: consumer waits above this land in the flight-recorder ring (same
#: threshold as DeviceFeed's feed.stall events)
_STALL_RECORD_US = 1000

#: parent-side timeout ceiling for a wedged pool (a worker that dies
#: without a sentinel must surface as an error, not a hang)
_DRAIN_TIMEOUT_S = 30.0

#: steady-state pull deadline: seconds without ANY worker message
#: before the consumer declares the pool wedged — a child that posted
#: "ready" but then deadlocked (inherited-lock fork hazard, module
#: docstring) is alive, so the dead-worker check never fires; generous
#: because one slot may legitimately take seconds (cold page cache,
#: network filesystems)
_PULL_TIMEOUT_S = 120.0

#: seconds each worker gets to post its startup-handshake "ready" —
#: past this the pool is declared unavailable (→ threaded fallback)
_READY_TIMEOUT_S = 20.0


class DecodeServiceUnavailable(RuntimeError):
    """Shared memory / process spawn unavailable on this host; callers
    fall back to the threaded pipeline."""


# ---------------------------------------------------------------------------
# shard partitioning — pure, deterministic, coordination-free
# ---------------------------------------------------------------------------

def shard_records(n, num_shards, shard_id, epoch=0, shuffle=False,
                  seed=0, batch_size=None):
    """Indices (into the canonical record order) owned by `shard_id`
    for `epoch`.

    Every shard computes the SAME global permutation for
    (seed, epoch) — `RandomState` shuffle is bit-deterministic across
    platforms — then takes its slice with no inter-worker
    communication: the shards are disjoint and their union is exactly
    `range(n)`.  `shuffle=False` keeps the identity order.

    `batch_size=None` slices record-strided (`order[shard_id::N]`).
    With `batch_size=B` the permutation is cut into contiguous
    B-sized blocks and the BLOCKS are strided across shards, so every
    worker emits whole batches and only the worker owning the final
    (short) block emits a partial one — at most ONE ragged batch per
    epoch pool-wide, matching the single-reader pipelines, instead of
    one per worker.  Steps-per-epoch therefore do not change with the
    worker count."""
    if not 0 <= shard_id < num_shards:
        raise ValueError("shard_id %d not in [0, %d)"
                         % (shard_id, num_shards))
    order = _np.arange(n, dtype=_np.int64)
    if shuffle:
        rs = _np.random.RandomState(
            (int(seed) * 1000003 + int(epoch)) % (2 ** 31 - 1))
        rs.shuffle(order)
    if batch_size is None:
        return order[shard_id::num_shards]
    b = int(batch_size)
    if b <= 0:
        raise ValueError("batch_size must be positive")
    blocks = [order[s:s + b]
              for s in range(shard_id * b, n, num_shards * b)]
    return _np.concatenate(blocks) if blocks else order[:0]


# ---------------------------------------------------------------------------
# decode + augment — shared by the worker processes and the threaded
# ImageRecordIter path (one decode semantics, two execution engines)
# ---------------------------------------------------------------------------

def _axis_resize(a, n_out, axis):
    """Triangle-filter resample of one axis (the semantics of the JAX
    package's image resize, 'linear': half-pixel centers, antialiased
    when downscaling, edge weights renormalized) as a banded gather —
    a few vectorized adds, NO BLAS: a tensordot here fans out into
    the multithreaded BLAS pool, and one worker quietly eating every
    host core defeats the whole point of worker scaling."""
    n_in = a.shape[axis]
    scale = n_out / n_in
    k = min(scale, 1.0)             # widen the kernel on downscale
    taps = int(_np.ceil(2.0 / k)) + 1
    centers = (_np.arange(n_out) + 0.5) / scale - 0.5
    idx = _np.floor(centers - (taps - 1) / 2.0).astype(_np.int64)
    idx = idx[:, None] + _np.arange(taps)[None, :]      # (n_out, taps)
    w = _np.clip(1.0 - _np.abs((idx - centers[:, None]) * k),
                 0.0, None)
    w *= (idx >= 0) & (idx < n_in)  # out-of-range taps drop, then the
    w /= w.sum(axis=1, keepdims=True)   # row renormalizes (edge rule)
    w = w.astype(_np.float32)
    idx = _np.clip(idx, 0, n_in - 1)
    a = _np.moveaxis(_np.asarray(a, _np.float32), axis, 0)
    bshape = (-1,) + (1,) * (a.ndim - 1)
    out = _np.zeros((n_out,) + a.shape[1:], _np.float32)
    for t in range(taps):
        out += a[idx[:, t]] * w[:, t].reshape(bshape)
    return _np.moveaxis(out, 0, axis)


def _resize_linear(img, size):
    """Bilinear (w, h) resize of an HWC image in numpy alone: the
    decode-service workers call no torch (module docstring)."""
    w_out, h_out = size
    a = _np.asarray(img, _np.float32)
    if a.ndim == 2:
        a = a[:, :, None]
    return _axis_resize(_axis_resize(a, h_out, 0), w_out, 1)


def decode_record(raw, data_shape, resize, rand_crop, rand_mirror, rng,
                  mean=None, std=None, dtype="uint8", out=None):
    """Decode one packed image record to CHW and return (pixels, label).

    Mirrors the reference augment order (resize short side → crop →
    mirror).  `dtype="uint8"` ships raw pixels (normalize on device);
    `"float32"` applies `mean`/`std` host-side (shape (3,1,1) or None).
    `out` is an optional preallocated CHW array (a shared-memory slab
    row) the pixels are written into."""
    header, img = unpack_img(raw)               # HWC uint8
    c, h, w = data_shape
    if resize > 0:
        short = min(img.shape[:2])
        scale = resize / short
        img = _resize_linear(img, (int(round(img.shape[1] * scale)),
                                   int(round(img.shape[0] * scale))))
    H, W = img.shape[:2]
    if rand_crop and H > h and W > w:
        y0 = rng.randint(0, H - h + 1)
        x0 = rng.randint(0, W - w + 1)
    else:
        y0, x0 = max(0, (H - h) // 2), max(0, (W - w) // 2)
    if H < h or W < w:
        img = _resize_linear(img, (w, h))
        y0 = x0 = 0
    img = img[y0:y0 + h, x0:x0 + w]
    if rand_mirror and rng.rand() < 0.5:
        img = img[:, ::-1]
    label = header.label if hasattr(header.label, "__len__") else \
        _np.float32(header.label)
    chw = img.transpose(2, 0, 1)
    if dtype == "uint8":            # raw pixels on the wire
        if chw.dtype != _np.uint8:  # resize goes through float32
            chw = chw.astype(_np.uint8)
        if out is not None:
            out[:] = chw
            return out, label
        return _np.ascontiguousarray(chw), label
    chw = chw.astype(_np.float32)
    if mean is not None:
        chw = chw - mean
    if std is not None:
        chw = chw / std
    chw = chw.astype(dtype, copy=False)
    if out is not None:
        out[:] = chw
        return out, label
    return _np.ascontiguousarray(chw), label


def _record_rng(seed, epoch, wid, seq, j):
    """Augment RNG for ONE record, derived from
    (seed, epoch, wid, seq, record-position-in-batch).

    Deriving per RECORD (not per batch with sequential draws) gives
    two independence properties the integrity layer needs on top of
    the respawn bit-identity:
    a QUARANTINED record consumes no draws, so the clean records
    around it keep exactly the pixels an uninjected run produces (the
    bit-identical-clean-stream contract) — and a respawned worker
    resuming at batch `seq` still reproduces every record of it."""
    return _np.random.RandomState(
        (int(seed) * 2654435761 + int(epoch) * 1000003 +
         int(wid) * 8191 + int(seq) * 7919 + int(j) * 104729 + 1)
        % (2 ** 31 - 1))


def _write_label(row, label):
    """Scalar or vector label into a float32 (label_width,) slab row."""
    row[:] = 0.0
    if hasattr(label, "__len__"):
        k = min(len(label), row.shape[0])
        row[:k] = _np.asarray(label, _np.float32)[:k]
    else:
        row[0] = float(label)


# ---------------------------------------------------------------------------
# availability probe
# ---------------------------------------------------------------------------

_AVAILABLE = None


def service_available():
    """Whether this host can run the multi-process service: shared
    memory allocates and the configured start method exists.  Probed
    once (tiny segment, immediately unlinked)."""
    global _AVAILABLE
    if _AVAILABLE is None:
        try:
            import multiprocessing as mp
            from multiprocessing import shared_memory
            method = _start_method()
            if method not in mp.get_all_start_methods():
                raise RuntimeError("start method %r unavailable" % method)
            seg = shared_memory.SharedMemory(create=True, size=16)
            seg.close()
            seg.unlink()
            _AVAILABLE = True
        except Exception:           # noqa: BLE001 — any failure means
            _AVAILABLE = False      # "use the threaded pipeline"
    return _AVAILABLE


def _start_method():
    method = _cfg.get("MXNET_IO_MP_START")
    if method not in ("fork", "spawn", "forkserver"):
        raise ValueError("MXNET_IO_MP_START must be fork, spawn or "
                         "forkserver, not %r" % (method,))
    return method


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------

def _attach_shm(name):
    """Attach the parent's segment.  Workers share the parent's
    resource-tracker process (fork and spawn both inherit its fd), and
    its cache is a per-name set — the attach-side register dedupes and
    the parent's single unlink unregisters, so no child-side tracker
    bookkeeping is needed (an explicit child unregister would race the
    siblings' and spam KeyError tracebacks from the tracker)."""
    from multiprocessing import shared_memory
    return shared_memory.SharedMemory(name=name)


def _slot_views(buf, spec):
    """Per-slot (data, label) numpy views over the shared segment."""
    batch = spec["batch"]
    shape = (batch,) + tuple(spec["data_shape"])
    ddt = _np.dtype(spec["dtype"])
    dbytes = int(_np.prod(shape)) * ddt.itemsize
    lbytes = batch * spec["label_width"] * 4
    stride = dbytes + lbytes
    views = []
    for s in range(spec["slots"]):
        off = s * stride
        data = _np.ndarray(shape, dtype=ddt, buffer=buf,
                           offset=off)
        label = _np.ndarray((batch, spec["label_width"]),
                            dtype=_np.float32, buffer=buf,
                            offset=off + dbytes)
        views.append((data, label))
    return views, stride


def _worker_main(wid, spec, ctrl_q, free_q, out_q, cur_epoch,
                 owners=None, corrupt_n=None):
    """Worker process entry: decode this worker's shard of each
    announced epoch into free slab slots.  numpy, PIL and the recordio
    framing only run here: no torch call (module docstring).  `owners` is the shared slot-owner
    table: a worker writes its wid when it acquires a slot, the PARENT
    clears it on message receipt — so a slot held by a worker that died
    is identifiable and reclaimable (auto-respawn).

    `corrupt_n` is the pool-wide per-epoch quarantine counter (a
    lock-free shared int — racy increments can only UNDER-count,
    which errs on the tolerant side of the budget): a record whose
    payload fails its sidecar CRC or whose decode raises is
    QUARANTINED — reported to the parent as a ``("corrupt", ...)``
    message naming file offset and reason, skipped, the batch shipped
    short — until ``MXNET_IO_CORRUPT_BUDGET`` is exceeded, at which
    point the worker fails the epoch loudly (the parent re-raises a
    typed `CorruptRecordBudgetExceeded`)."""
    seg = None
    fh = None
    try:
        seg = _attach_shm(spec["shm"])
        views, _ = _slot_views(seg.buf, spec)
        fh = open(spec["path"], "rb")
        # startup handshake: the parent refuses to trust a pool until
        # every worker proves it came up (a wedged fork must degrade
        # to the threaded pipeline, never hang the consumer)
        out_q.put(("ready", -1, wid))
        offsets = spec["offsets"]
        n = len(offsets)
        workers = spec["workers"]
        batch = spec["batch"]
        mean = spec["mean"]
        std = spec["std"]
        crcs = spec.get("crcs")
        crc_of = checksum_fn(spec["crc_algo"]) \
            if crcs is not None else None
        budget = int(spec.get("corrupt_budget", -1))
        while True:
            cmd = ctrl_q.get()
            if cmd[0] == "stop":
                return
            epoch = cmd[1]
            # a respawned replacement resumes its predecessor's slice
            # at the first UNDELIVERED batch; a fresh epoch starts at 0
            skip = int(cmd[2]) if len(cmd) > 2 else 0
            # batch-block-aligned shard: every worker's slice is a
            # whole number of batches except the one owning the final
            # short block — at most ONE partial batch per epoch
            order = shard_records(n, workers, wid, epoch=epoch,
                                  shuffle=spec["shuffle"],
                                  seed=spec["seed"], batch_size=batch)
            seq = skip
            aborted = False
            slot = None
            try:
                for start in range(skip * batch, len(order), batch):
                    idxs = order[start:start + batch]
                    slot = _acquire_slot(free_q, cur_epoch, epoch)
                    if slot is None:        # epoch aborted (reset)
                        aborted = True
                        break
                    # decode-interval wall clock (time.time(): epoch
                    # time IS comparable across processes, unlike
                    # perf_counter) — rides the batch message so the
                    # consumer can emit this interval as an io.decode
                    # span in THIS worker's process row
                    bt0 = time.time()
                    if owners is not None:
                        owners[slot] = wid
                    dview, lview = views[slot]
                    k = 0           # clean records land compacted
                    for j, ri in enumerate(idxs):
                        try:
                            fh.seek(offsets[ri])
                            # in-flight payload corruption injector
                            # (io.corrupt, fault.py): caught below by
                            # the CRC sidecar or the decoder — the
                            # production quarantine path, not a mock
                            raw = read_record(fh)
                            if raw is None:
                                raise RecordCorrupt(
                                    spec["path"], int(offsets[ri]),
                                    "EOF mid-shard (truncated file)")
                            if _fault.should_fire("io.corrupt"):
                                raw = _fault.flip_bits(raw)
                            if crc_of is not None and \
                                    int(crcs[ri]) >= 0 and \
                                    crc_of(raw) != int(crcs[ri]):
                                raise RecordCorrupt(
                                    spec["path"], int(offsets[ri]),
                                    "payload CRC mismatch")
                            # per-RECORD augment RNG (seed, epoch,
                            # wid, seq, j): bit-identical whether this
                            # record is decoded by the original
                            # worker, a post-crash replacement, or in
                            # a run where its NEIGHBOR was quarantined
                            rng = _record_rng(spec["seed"], epoch,
                                              wid, seq, j)
                            _, label = decode_record(
                                raw, spec["data_shape"],
                                spec["resize"], spec["rand_crop"],
                                spec["rand_mirror"], rng, mean=mean,
                                std=std, dtype=spec["dtype"],
                                out=dview[k])
                        except Exception as e:  # noqa: BLE001 —
                            # quarantine: ONE bad record must not kill
                            # the worker or perturb its clean stream
                            out_q.put((
                                "corrupt", epoch, wid,
                                int(offsets[ri]),
                                ("%s: %s" % (type(e).__name__,
                                             e))[:200]))
                            cn = 1
                            if corrupt_n is not None:
                                cn = corrupt_n.value + 1
                                corrupt_n.value = cn
                            if 0 <= budget < cn:
                                raise CorruptRecordBudgetExceeded(
                                    spec["path"], cn, budget)
                            continue
                        _write_label(lview[k], label)
                        k += 1
                    out_q.put(("batch", epoch, slot, k, wid, seq,
                               bt0, int((time.time() - bt0) * 1e6)))
                    slot = None             # ownership passed on (the
                    seq += 1                # parent clears owners[])
                    if cur_epoch.value != epoch:
                        aborted = True
                        break
            except Exception as e:          # noqa: BLE001 — surfaced
                if slot is not None:        # half-filled slot: return
                    if owners is not None:  # it, don't shrink the ring
                        owners[slot] = -1
                    free_q.put(slot)
                out_q.put(("error", epoch, wid,                # to the
                           "%s: %s" % (type(e).__name__, e)))  # parent
                continue
            out_q.put(("eoe", epoch, wid, seq if not aborted else -1))
    except (KeyboardInterrupt, BrokenPipeError, EOFError):
        pass                        # parent went away; exit quietly
    finally:
        try:
            if fh is not None:
                fh.close()
            if seg is not None:
                seg.close()
        except Exception:           # noqa: BLE001
            pass


def _acquire_slot(free_q, cur_epoch, epoch):
    """Blocking free-slot take that notices an epoch abort (reset):
    returns a slot id, or None when the epoch moved on."""
    while True:
        if cur_epoch.value != epoch:
            return None
        try:
            return free_q.get(timeout=0.05)
        except _queue.Empty:
            continue


# ---------------------------------------------------------------------------
# consumer side
# ---------------------------------------------------------------------------

class SlabBatch:
    """One decoded batch living in a shared-memory slot.

    `data` is the (count, C, H, W) slab view (uint8 or float32),
    `label` the (count, label_width) float32 view.  The views stay
    valid until the slot is recycled — which happens at the NEXT
    `DecodeService.__next__` (or an explicit `release()`).  `wid`/`seq`
    identify the producing worker and its batch ordinal, so a batch
    stream is attributable (and bit-reproducibility testable).
    `trace` is the `telemetry.TraceContext` of the
    `io.decode` span the consumer emitted on the worker's behalf —
    None when telemetry is off — so downstream stages can join the
    same trace."""

    __slots__ = ("data", "label", "count", "wid", "seq", "trace",
                 "_svc", "_slot")

    def __init__(self, data, label, count, wid, seq, svc, slot,
                 trace=None):
        self.data = data
        self.label = label
        self.count = count
        self.wid = wid
        self.seq = seq
        self.trace = trace
        self._svc = svc
        self._slot = slot

    def release(self):
        """Return the slot to the ring (idempotent).  After this the
        `data`/`label` views may be overwritten by a worker."""
        svc, self._svc = self._svc, None
        if svc is not None:
            svc._recycle(self._slot, self)


class DecodeService:
    """Worker-process pool decoding a RecordIO file into a
    shared-memory slab ring (module docstring has the architecture).

    Iteration yields one epoch of `SlabBatch`es; `reset()` advances to
    a fresh epoch (discarding any in-flight batches); re-entering
    `iter()` after exhaustion re-arms the next epoch automatically.
    Batches arrive in worker-completion order — per-epoch record
    coverage (exactly once, disjoint shards) is deterministic, the
    interleaving across workers is not.

    Raises `DecodeServiceUnavailable` when the host cannot run it
    (no shared memory / process spawn) — callers degrade to the
    threaded pipeline."""

    def __init__(self, path_imgrec, batch_size, data_shape, workers=None,
                 label_width=1, shuffle=False, seed=0, resize=-1,
                 rand_crop=False, rand_mirror=False, dtype="uint8",
                 mean=None, std=None, ring_slots=None):
        if dtype not in ("uint8", "float32"):
            raise ValueError("dtype must be 'uint8' or 'float32'")
        if len(data_shape) != 3 or data_shape[0] != 3:
            raise ValueError("data_shape must be (3, H, W)")
        if not service_available():
            raise DecodeServiceUnavailable(
                "shared memory / process spawn unavailable on this host")
        workers = int(workers if workers is not None
                      else _cfg.get("MXNET_IO_WORKERS"))
        if workers < 1:
            raise ValueError("workers must be >= 1")
        self._path = path_imgrec
        self._batch = int(batch_size)
        self._data_shape = tuple(data_shape)
        self._workers_n = workers
        self._label_width = int(label_width)
        self._shuffle = bool(shuffle)
        self._seed = int(seed)
        self._dtype = dtype
        self._offsets = self._resolve_offsets(path_imgrec)
        slots = int(ring_slots if ring_slots is not None
                    else _cfg.get("MXNET_IO_RING_SLOTS"))
        if slots <= 0:
            slots = 2 * workers + 2
        self._slots_n = max(slots, workers + 1)
        # optional integrity sidecar (<rec>.crc): per-record payload
        # CRCs the workers verify before decoding — a mismatch is
        # QUARANTINED (skipped + reported), not decoded into garbage
        crc_algo, crc_arr = None, None
        sidecar = read_crc_sidecar(path_imgrec)
        if sidecar is not None:
            crc_algo, crc_map = sidecar
            checksum_fn(crc_algo)   # unknown algo fails HERE, loudly
            crc_arr = _np.full(len(self._offsets), -1, _np.int64)
            for i, off in enumerate(self._offsets):
                crc_arr[i] = crc_map.get(int(off), -1)
        self._corrupt_budget = int(_cfg.get("MXNET_IO_CORRUPT_BUDGET"))
        self._spec = {
            "path": path_imgrec, "offsets": self._offsets,
            "batch": self._batch, "data_shape": self._data_shape,
            "label_width": self._label_width, "workers": workers,
            "shuffle": self._shuffle, "seed": self._seed,
            "resize": int(resize), "rand_crop": bool(rand_crop),
            "rand_mirror": bool(rand_mirror), "dtype": dtype,
            "mean": None if mean is None else
            _np.asarray(mean, _np.float32).reshape(3, 1, 1),
            "std": None if std is None else
            _np.asarray(std, _np.float32).reshape(3, 1, 1),
            "slots": self._slots_n, "shm": None,
            "crcs": crc_arr, "crc_algo": crc_algo,
            "corrupt_budget": self._corrupt_budget,
        }
        dbytes = int(_np.prod((self._batch,) + self._data_shape)) * \
            _np.dtype(dtype).itemsize
        self._slot_stride = dbytes + self._batch * self._label_width * 4
        self._started = False
        self._closed = False
        self._exhausted = False
        self._consumed = False      # anything pulled from this epoch?
        self._epoch = -1
        self._eoe_wids = set()      # workers done with this epoch
        self._current = None        # SlabBatch the consumer holds
        self._shm = None
        self._procs = []
        self._ctrl = []
        self._free_q = None
        self._out_q = None
        self._cur_epoch = None      # mp.Value workers poll for aborts
        self._owners = None         # shared slot-owner table (respawn)
        self._corrupt_n = None      # pool-wide per-epoch quarantines
        self._delivered = {}        # wid -> batches received this epoch
        self._restarts_left = int(_cfg.get("MXNET_IO_WORKER_RESTARTS"))
        self._lock = threading.Lock()   # slot recycle is cross-thread

    @property
    def num_records(self):
        return len(self._offsets)

    @property
    def workers(self):
        return self._workers_n

    @staticmethod
    def _resolve_offsets(path):
        """One byte offset per record, in canonical order: the .idx
        sidecar's key order when present, else a sequential header
        scan (`list_record_offsets`)."""
        idx_path = idx_sidecar_path(path)
        if os.path.exists(idx_path):
            offsets = []
            with open(idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        offsets.append(int(parts[1]))
            if offsets:
                return _np.asarray(offsets, _np.int64)
        # compact int64 array: under spawn the spec is pickled per
        # worker, and a million-record list would ship as python ints
        return _np.asarray(list_record_offsets(path), _np.int64)

    # -- lifecycle -----------------------------------------------------
    def _start(self):
        import multiprocessing as mp
        from multiprocessing import shared_memory
        ctx = mp.get_context(_start_method())
        try:
            self._shm = shared_memory.SharedMemory(
                create=True, size=self._slots_n * self._slot_stride)
        except Exception as e:
            raise DecodeServiceUnavailable(
                "cannot allocate %d-byte shared ring: %s"
                % (self._slots_n * self._slot_stride, e)) from e
        self._spec["shm"] = self._shm.name
        self._views, _ = _slot_views(self._shm.buf, self._spec)
        self._free_q = ctx.Queue()
        self._out_q = ctx.Queue()
        self._cur_epoch = ctx.Value("l", -1, lock=False)
        # slot-owner table: worker writes its wid on slot acquire, the
        # parent clears on delivery — slots a dead worker held are
        # identifiable and reclaimed on respawn (ring never shrinks)
        self._owners = ctx.Array("l", [-1] * self._slots_n, lock=False)
        # pool-wide quarantine counter, lock-free on purpose: a racy
        # lost increment only under-counts toward the budget, and a
        # SIGKILLed worker can never wedge siblings on a Value lock
        self._corrupt_n = ctx.Value("l", 0, lock=False)
        for s in range(self._slots_n):
            self._free_q.put(s)
        try:
            with warnings.catch_warnings():
                # the workers call no torch (module docstring): the
                # interpreter's fork-with-threads warning does not
                # apply to them
                warnings.filterwarnings(
                    "ignore", message=".*os.fork.*",
                    category=RuntimeWarning)
                warnings.filterwarnings(
                    "ignore", message=".*fork.*",
                    category=DeprecationWarning)
                for wid in range(self._workers_n):
                    self._ctrl.append(None)
                    self._procs.append(None)
                    self._spawn_worker(ctx, wid)
        except Exception as e:
            self.close()
            raise DecodeServiceUnavailable(
                "cannot start decode workers: %s" % e) from e
        # startup handshake: every worker must post "ready" before the
        # pool is trusted — a fork that wedged (inherited lock, broken
        # host) degrades to the threaded pipeline instead of
        # hanging the first next()
        ready = set()
        deadline = time.monotonic() + _READY_TIMEOUT_S
        while len(ready) < self._workers_n:
            try:
                msg = self._out_q.get(
                    timeout=min(0.5, max(0.01,
                                         deadline - time.monotonic())))
                if msg[0] == "ready":
                    ready.add(msg[2])
                continue
            except _queue.Empty:
                pass
            dead = [p.name for p in self._procs
                    if p is not None and not p.is_alive()]
            if dead or time.monotonic() > deadline:
                self.close()
                raise DecodeServiceUnavailable(
                    "decode workers failed to start (%d/%d ready; "
                    "dead: %s)" % (len(ready), self._workers_n,
                                   dead or "none, timed out"))
        self._started = True

    def _spawn_worker(self, ctx, wid):
        """Start (or re-start) worker `wid` on a FRESH control queue —
        a respawn must not consume the corpse's stale epoch announce
        (it carries no resume offset)."""
        old = self._ctrl[wid]
        if old is not None:
            try:
                old.cancel_join_thread()
                old.close()
            except Exception:       # noqa: BLE001
                pass
        cq = ctx.Queue()
        p = ctx.Process(
            target=_worker_main,
            args=(wid, self._spec, cq, self._free_q,
                  self._out_q, self._cur_epoch, self._owners,
                  self._corrupt_n),
            daemon=True, name="DecodeWorker-%d" % wid)
        fork = ctx.get_start_method() == "fork"
        if fork:
            # a forked child must never collect, and so never finalize,
            # an object of the parent: a torch tensor or a native
            # reader freed there would call CUDA or join threads that
            # do not exist in the child
            gc.freeze()
        try:
            p.start()
        finally:
            if fork:
                gc.unfreeze()
        self._ctrl[wid] = cq
        self._procs[wid] = p

    def _respawn(self, dead_wids, resume=True):
        """Worker-death recovery: rebuild the WHOLE pool — every
        worker, on FRESH queues — within the pool-wide restart budget
        (MXNET_IO_WORKER_RESTARTS).  Returns False when the budget
        cannot cover the dead set — the caller then hard-errors, the
        pre-elastic behaviour.

        The rebuild is total because surgical replacement cannot be
        made kill-safe: a hard-killed worker (segfault, OOM kill) can
        die HOLDING an mp.Queue lock — free_q's reader lock (a blocked
        worker spends its life inside ``free_q.get`` holding it) or
        out_q's writer lock — and every survivor sharing that queue
        then wedges forever.  Fresh queues sidestep any poisoned lock;
        the slab ring itself is raw shared memory (lock-free) and
        carries over, as does the slot the consumer currently holds a
        view into.

        Determinism: called only once the out queue is drained (the
        callers detect death from the empty-queue branch), so every
        batch that reached the parent is counted in `self._delivered`.
        Each worker — replacement and survivor alike — resumes its
        (wid, epoch) shard slice at the first undelivered batch;
        per-record RNG derivation (seed, epoch, wid, seq, j) makes the
        resumed streams bit-identical to an uninterrupted run, with
        every record still decoded exactly once."""
        import multiprocessing as mp
        dead_wids = sorted(dead_wids)
        if self._restarts_left < len(dead_wids):
            return False
        self._restarts_left -= len(dead_wids)
        ctx = mp.get_context(_start_method())
        # total teardown: a survivor may be blocked on a lock the
        # corpse died holding — terminate, then kill the stubborn
        for p in self._procs:
            if p is not None and p.is_alive():
                p.terminate()
        for p in self._procs:
            if p is None:
                continue
            p.join(timeout=2.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=1.0)
        for q in (self._free_q, self._out_q):
            try:
                q.cancel_join_thread()
                q.close()
            except Exception:       # noqa: BLE001
                pass
        # fresh data plane: new queues, every slot free again except
        # the one the consumer is holding a view into right now.  The
        # held-slot read and the queue swap are ONE critical section
        # with _recycle (a cross-thread SlabBatch.release racing this
        # rebuild): a release that lands before the swap clears
        # _current — its slot joins the rebuilt queue below; one that
        # lands after targets the NEW queue, whose rebuild excluded
        # the held slot.  Either way the slot survives exactly once.
        with self._lock:
            cur = self._current
            held = cur._slot if cur is not None else -1
            self._free_q = ctx.Queue()
            self._out_q = ctx.Queue()
            self._cur_epoch = ctx.Value("l", self._epoch, lock=False)
            reclaimed = 0
            for s in range(self._slots_n):
                if self._owners[s] >= 0:
                    reclaimed += 1
                self._owners[s] = -1
                if s != held:
                    self._free_q.put(s)
        for wid in range(self._workers_n):
            self._spawn_worker(ctx, wid)
            if resume and self._epoch >= 0 \
                    and wid not in self._eoe_wids:
                self._ctrl[wid].put(
                    ("epoch", self._epoch,
                     int(self._delivered.get(wid, 0))))
        for wid in dead_wids:
            events.incr("io.decode.worker_restarts")
            try:
                from ..telemetry import flightrec as _bb
                _bb.record("io", "worker_restart", wid=int(wid),
                           epoch=int(self._epoch),
                           skip=int(self._delivered.get(wid, 0)),
                           slots_reclaimed=reclaimed,
                           restarts_left=int(self._restarts_left))
            except Exception:       # noqa: BLE001 — forensics only
                pass
        warnings.warn(
            "decode worker(s) %s died; pool rebuilt on fresh queues "
            "(epoch %d resumes at each worker's first undelivered "
            "batch; %d slot(s) reclaimed, %d restart(s) left)"
            % (dead_wids, self._epoch, reclaimed, self._restarts_left),
            RuntimeWarning, stacklevel=3)
        return True

    def close(self):
        """Stop the pool and free the shared ring.  Idempotent; the
        service cannot be restarted after close."""
        if self._closed:
            return
        self._closed = True
        self._exhausted = True
        if self._cur_epoch is not None:
            self._cur_epoch.value = -2      # abort any in-flight epoch
        for cq in self._ctrl:
            try:
                cq.put(("stop",))
            except Exception:       # noqa: BLE001
                pass
        for p in self._procs:
            if p is None:
                continue
            p.join(timeout=2.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=1.0)
        for q in [self._free_q, self._out_q] + self._ctrl:
            if q is None:
                continue
            try:
                q.cancel_join_thread()
                q.close()
            except Exception:       # noqa: BLE001
                pass
        self._procs = []
        self._ctrl = []
        self._views = None
        self._current = None
        if self._shm is not None:
            try:                    # unlink FIRST: a consumer still
                self._shm.unlink()  # holding a slab view makes close()
            except Exception:       # raise BufferError, and the name
                pass                # must not leak in /dev/shm
            try:
                self._shm.close()
            except Exception:       # noqa: BLE001
                pass
            self._shm = None

    def __del__(self):
        try:
            self.close()
        except Exception:           # noqa: BLE001
            pass

    # -- slot recycling ------------------------------------------------
    def _recycle(self, slot, sb):
        # capture the queue ref INSIDE the lock: _respawn swaps
        # self._free_q under the same lock, so we either target the
        # old queue (discarded — the rebuild re-frees our slot) or the
        # new one (which the rebuild withheld our slot from); putting
        # outside the critical section on a stale ref would leak the
        # slot and shrink the ring
        with self._lock:
            if self._current is sb:
                self._current = None
            q = None if self._closed else self._free_q
        if q is not None:
            try:
                q.put(slot)
            except Exception:       # noqa: BLE001
                pass

    def _release_current(self):
        cur = self._current
        if cur is not None:
            cur.release()

    # -- epoch control -------------------------------------------------
    def reset(self):
        """Advance to a fresh epoch.  In-flight batches of the old one
        are drained and their slots recycled; a no-op when the current
        epoch is freshly announced and nothing was consumed yet (so
        `reset()` followed by `iter()` advances exactly once)."""
        if self._closed:
            raise RuntimeError("DecodeService is closed")
        if not self._started:
            self._start()
        elif not self._consumed and not self._exhausted \
                and self._epoch >= 0:
            return                  # current epoch is still untouched
        self._release_current()
        if self._epoch >= 0 and self._outstanding_alive():
            self._drain_epoch()
        # a worker that died in a previous epoch must be back before
        # the announce, or its shard of the new epoch silently stalls
        dead = [wid for wid in range(self._workers_n)
                if not self._procs[wid].is_alive()]
        if dead and not self._respawn(dead, resume=False):
            self._exhausted = True
            raise RuntimeError(
                "decode worker(s) %s died and the restart budget "
                "(MXNET_IO_WORKER_RESTARTS) is exhausted" % dead)
        self._epoch += 1
        self._eoe_wids = set()
        self._exhausted = False
        self._consumed = False
        self._delivered = {}
        if self._corrupt_n is not None:
            self._corrupt_n.value = 0   # quarantine budget is per-epoch
        self._cur_epoch.value = self._epoch
        for cq in self._ctrl:
            cq.put(("epoch", self._epoch))
        events.incr("io.decode.epochs")

    def _outstanding_alive(self):
        """Live workers that have not posted this epoch's sentinel."""
        return [wid for wid in range(self._workers_n)
                if wid not in self._eoe_wids
                and self._procs[wid].is_alive()]

    def _drain_epoch(self):
        """After aborting an epoch (reset mid-epoch), absorb every
        straggler message and recycle its slot until each live worker
        posted its end-of-epoch sentinel — so the next epoch starts
        with a clean ring and an empty queue."""
        self._cur_epoch.value = -2          # != any announced epoch
        deadline = time.monotonic() + _DRAIN_TIMEOUT_S
        while self._outstanding_alive():
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "decode service: drain timed out (%d/%d workers "
                    "reported)"
                    % (len(self._eoe_wids), self._workers_n))
            try:
                msg = self._out_q.get(timeout=0.2)
            except _queue.Empty:
                continue
            if msg[0] == "batch":
                self._owners[msg[2]] = -1
                self._free_q.put(msg[2])
            elif msg[0] == "corrupt":
                continue            # aborted epoch: not booked
            elif msg[0] in ("eoe", "error") and msg[1] == self._epoch:
                self._eoe_wids.add(msg[2])

    # -- iteration -----------------------------------------------------
    def __iter__(self):
        if not self._started or self._exhausted or self._consumed:
            self.reset()
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        if not self._started or self._epoch < 0:
            self.reset()
        if self._exhausted:
            raise StopIteration
        from .. import fault
        fault.maybe_slow("io.slow")
        fault.maybe_raise("io.read", exc_type=fault.InjectedIOError)
        self._consumed = True
        self._release_current()
        t0 = time.perf_counter()
        while True:
            try:
                depth = self._out_q.qsize()
            except (NotImplementedError, OSError):
                depth = -1
            try:
                msg = self._out_q.get(timeout=0.5)
            except _queue.Empty:
                outstanding = [wid for wid in range(self._workers_n)
                               if wid not in self._eoe_wids]
                dead = [wid for wid in outstanding
                        if not self._procs[wid].is_alive()]
                if dead:
                    # a worker owing batches is dead and the queue is
                    # drained (this branch): respawn it resuming its
                    # (wid, epoch) slice at the first undelivered
                    # batch — bit-identical stream, exactly-once
                    # records — unless the budget ran dry, which is
                    # the pre-elastic hard mid-epoch error
                    if self._respawn(dead):
                        t0 = time.perf_counter()    # fresh deadline
                        continue
                    self._exhausted = True
                    raise RuntimeError(
                        "decode worker(s) %s died mid-epoch and the "
                        "restart budget (MXNET_IO_WORKER_RESTARTS) "
                        "is exhausted" % dead)
                if not outstanding:         # all sentinels seen (can
                    self._exhausted = True  # only happen via races)
                    raise StopIteration
                if time.perf_counter() - t0 > _PULL_TIMEOUT_S:
                    # alive-but-wedged pool (a child deadlocked after
                    # its handshake): surface, don't hang the step loop
                    self._exhausted = True
                    raise RuntimeError(
                        "decode service: no batch from worker(s) %s "
                        "for %.0fs — pool wedged (alive but not "
                        "producing)" % (outstanding, _PULL_TIMEOUT_S))
                continue
            tag = msg[0]
            if tag == "ready":      # handshake straggler (restarted
                continue            # pools); consumed in _start
            if tag == "batch" and msg[1] != self._epoch:
                self._owners[msg[2]] = -1   # stale (pre-reset straggler)
                self._free_q.put(msg[2])
                continue
            if tag in ("eoe", "error", "corrupt") and \
                    msg[1] != self._epoch:
                continue
            if tag == "corrupt":
                # a worker quarantined one record: book it — counter,
                # flight-recorder event, quarantine JSONL naming
                # file/offset — and keep pulling (the batch it came
                # from still arrives, just short)
                from .. import integrity as _integ
                _integ.quarantine_record(
                    self._path, msg[3], msg[4],
                    epoch=self._epoch, wid=msg[2])
                continue
            if tag == "eoe":
                self._eoe_wids.add(msg[2])
                if len(self._eoe_wids) >= self._workers_n:
                    self._exhausted = True
                    raise StopIteration
                continue
            if tag == "error":
                self._eoe_wids.add(msg[2])  # the worker left the epoch
                self._exhausted = True
                if str(msg[3]).startswith(
                        "CorruptRecordBudgetExceeded"):
                    # the typed loud failure: the epoch's data is
                    # sick, not blipping (budget counted pool-wide)
                    raise CorruptRecordBudgetExceeded(
                        self._path,
                        int(self._corrupt_n.value)
                        if self._corrupt_n is not None else -1,
                        self._corrupt_budget)
                raise RuntimeError("decode worker %d failed: %s"
                                   % (msg[2], msg[3]))
            if msg[3] == 0:         # batch: every record quarantined —
                self._owners[msg[2]] = -1   # recycle the slot, advance
                self._delivered[msg[4]] = int(msg[5]) + 1   # resume pt
                self._free_q.put(msg[2])
                continue            # keep pulling
            break
        slot, count, wid, seq = msg[2:6]
        # delivery: the slot's owner mark clears (a respawn must not
        # reclaim a slot the consumer holds) and the worker's resume
        # point advances to the batch after this one
        self._owners[slot] = -1
        self._delivered[wid] = int(seq) + 1
        wait_s = time.perf_counter() - t0
        events.add_time("io.decode.wait_us", wait_s)
        if depth >= 0:
            events.observe("io.decode.queue_depth", depth)
        wait_us = int(wait_s * 1e6)
        if wait_us > _STALL_RECORD_US:
            from ..telemetry import flightrec as _bb
            _bb.record("io", "stall", us=wait_us,
                       qdepth=max(depth, 0))
        # cross-process re-parenting: the worker reported
        # its decode interval's wall timing in the message; emit it as
        # an io.decode span in the WORKER's process row, parented
        # under the consumer's innermost open span and stamped with
        # the current global step — one bool read when telemetry is
        # off, and a 6-tuple message carries no timing
        trace = None
        if len(msg) >= 8:
            from ..telemetry import spans as _tele
            if _tele.enabled():
                proc = self._procs[wid] if wid < len(self._procs) \
                    else None
                ctx = _tele.emit_foreign(
                    "io.decode", msg[6], msg[7] / 1e6,
                    pid=getattr(proc, "pid", None),
                    wid=int(wid), seq=int(seq), epoch=self._epoch,
                    records=int(count))
                if ctx is not None:
                    trace = _tele.TraceContext(
                        ctx.trace_id, ctx.span_id,
                        _tele.get_global_step())
        dview, lview = self._views[slot]
        sb = SlabBatch(dview[:count], lview[:count], count, wid, seq,
                       self, slot, trace=trace)
        with self._lock:
            self._current = sb
        events.incr("io.decode.batches")
        events.incr("io.decode.records", count)
        events.incr("io.decode.bytes",
                    int(sb.data.nbytes) + int(sb.label.nbytes))
        return sb
