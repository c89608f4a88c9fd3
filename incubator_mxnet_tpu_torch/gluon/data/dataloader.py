"""DataLoader of the PyTorch port (a port of
incubator_mxnet_tpu/gluon/data/dataloader.py; ref:
python/mxnet/gluon/data/dataloader.py).

Workers, threads or `spawn` processes, build **numpy** batches and hand
them back (a process pickles them): a worker never builds a CUDA
NDArray, so no worker opens a CUDA context of its own.  The main
process wraps a batch as NDArrays on `cuda:0` (the port's default
device), or, with ``ctx=``, hands it to a `DeviceFeed`, which places the
next batch while the consumer's step runs.
"""
from __future__ import annotations

import multiprocessing as _mp
import threading as _threading

import numpy as _np

from ...ndarray.ndarray import NDArray
from ... import ndarray as nd
from .sampler import SequentialSampler, RandomSampler, BatchSampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]

# serializes Pool construction across DataLoaders (see __init__ cleanup)
_POOL_CTOR_LOCK = _threading.Lock()


def _asnumpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return _np.asarray(x)


def default_batchify_fn(data):
    """Stack samples into a batch of NDArrays on the default device (ref:
    default_batchify_fn)."""
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn([d[i] for d in data])
                     for i in range(len(data[0])))
    return nd.array(_np.stack([_asnumpy(d) for d in data]))


default_mp_batchify_fn = default_batchify_fn


_worker_dataset = None


def _worker_init(dataset):
    global _worker_dataset
    _worker_dataset = dataset


def _fetch_batch(dataset, samples):
    batch = [dataset[i] for i in samples]
    if isinstance(batch[0], tuple):
        return tuple(_np.stack([_asnumpy(b[i]) for b in batch])
                     for i in range(len(batch[0])))
    return _np.stack([_asnumpy(b) for b in batch])


def _worker_fn(samples):
    """In a worker process: fetch and stack to numpy (picklable)."""
    return _fetch_batch(_worker_dataset, samples)


def _thread_worker_fn(dataset, samples):
    """The thread-pool form: the dataset comes with each call (a
    process-wide global would be clobbered by a second loader)."""
    return _fetch_batch(dataset, samples)


def _np_to_nd(out):
    if isinstance(out, tuple):
        return tuple(nd.array(o) for o in out)
    return nd.array(out)


class DataLoader:
    """ref: gluon.data.DataLoader — batching, shuffling, prefetching.

    Without `ctx=` batches are NDArrays on `cuda:0`.  `ctx=` hands the
    numpy batches to a `io.device_feed.DeviceFeed`: they come back as
    NDArrays on `ctx`, the next batch's transfer overlapped with the
    consumer's step (`feed_depth` buffers, default MXNET_FEED_DEPTH;
    counters under `feed.*`).  `num_workers > 0` fetches on `spawn`
    processes (a dataset that does not pickle falls back to threads,
    with a warning), `thread_pool=True` on threads."""

    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 pin_device_id=0, prefetch=None, thread_pool=False,
                 timeout=120, ctx=None, feed_depth=None):
        self._dataset = dataset
        self._pin_memory = pin_memory
        self._ctx = ctx
        self._feed_depth = feed_depth
        self._num_workers = max(0, num_workers)
        self._timeout = timeout
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size required when batch_sampler "
                                 "is not given")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must be False with sampler given")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None or
                last_batch is not None):
            raise ValueError("batch_size/shuffle/sampler/last_batch must "
                             "not be given with batch_sampler")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn
        self._prefetch = max(0, prefetch or 2 * self._num_workers)
        self._pool = None
        self._thread_pool = thread_pool
        if self._num_workers > 0:
            if not thread_pool:
                # spawn, not fork: the parent holds a CUDA context and
                # threads.  Spawn pickles the dataset into each worker at
                # pool start, so that start is the picklability probe.
                import pickle as _pickle
                mp_ctx = _mp.get_context("spawn")
                # serialized: the failure cleanup diffs active_children()
                with _POOL_CTOR_LOCK:
                    before = set(_mp.active_children())
                    try:
                        self._pool = mp_ctx.Pool(
                            self._num_workers,
                            initializer=_worker_init,
                            initargs=(self._dataset,))
                        e = None
                    except Exception as exc:
                        e = exc
                        # reap the workers a half-built Pool started
                        for proc in (set(_mp.active_children()) -
                                     before):
                            if proc.daemon and proc.name.startswith(
                                    "SpawnPoolWorker"):
                                proc.terminate()
                                proc.join()
                if e is not None:
                    if not isinstance(e, (_pickle.PicklingError,
                                          TypeError, AttributeError)):
                        raise e     # not a pickling failure: surface it
                    import warnings
                    warnings.warn(
                        "DataLoader: dataset failed to pickle into "
                        "spawned workers (%s: %s) — using thread "
                        "workers instead (pass thread_pool=True to "
                        "silence)" % (type(e).__name__, e))
                    self._thread_pool = thread_pool = True
            if thread_pool:
                from multiprocessing.dummy import Pool as _ThreadPool
                self._pool = _ThreadPool(self._num_workers)

    def __iter__(self):
        raw = self._ctx is not None
        base = self._mp_iter(raw=raw) if self._pool is not None \
            else self._serial_iter(raw=raw)
        if not raw:
            return base
        # a fresh feed per epoch: its thread ends with the epoch
        from ...io.device_feed import DeviceFeed
        return iter(DeviceFeed(base, ctx=self._ctx,
                               depth=self._feed_depth))

    def _serial_iter(self, raw=False):
        for batch_idx in self._batch_sampler:
            if raw and self._batchify_fn is default_batchify_fn:
                # numpy straight to the feed (a custom batchify runs, and
                # the feed unwraps its NDArrays)
                yield _fetch_batch(self._dataset, batch_idx)
            else:
                yield self._batchify_fn(
                    [self._dataset[i] for i in batch_idx])

    def _mp_iter(self, raw=False):
        # a sliding window of async results (double-buffered prefetch)
        import collections
        queue = collections.deque()
        it = iter(self._batch_sampler)

        def enqueue():
            try:
                idx = next(it)
            except StopIteration:
                return False
            if self._thread_pool:
                queue.append(self._pool.apply_async(
                    _thread_worker_fn, (self._dataset, idx)))
            else:
                queue.append(self._pool.apply_async(_worker_fn, (idx,)))
            return True

        for _ in range(self._prefetch or 2):
            if not enqueue():
                break
        while queue:
            res = queue.popleft()
            out = res.get(self._timeout)
            enqueue()
            yield out if raw else _np_to_nd(out)

    def __len__(self):
        return len(self._batch_sampler)

    def close(self):
        """Stop the workers (idempotent)."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.terminate()
            pool.join()

    def __del__(self):
        try:
            self.close()
        except Exception:           # noqa: BLE001
            pass
