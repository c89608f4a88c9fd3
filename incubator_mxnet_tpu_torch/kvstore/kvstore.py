"""KVStore of the PyTorch port (counterpart of
incubator_mxnet_tpu/kvstore/kvstore.py): the key/value parameter store
of MXNet's data-parallel training.

`create(name)`:

* ``local``, ``device``, ``nccl`` — `KVStore`: one process, values are
  NDArrays or tensors on any device.  `push` sums the per-device copies
  given for a key (in their order, on the first copy's device; row_sparse
  copies by `ndarray.sparse.add`) and replaces the stored value with the
  sum, or, with an optimizer set (`set_optimizer`), updates the stored
  weight with it in the store; `pull` writes fresh copies out;
  `pushpull` sums and writes out without touching the store.
* ``dist_sync``, ``dist_async``, ``dist_sync_device`` (and the
  reference's other dist names) — `DistKVStore`: the worker's local sum
  is then summed over every worker of the `torch.distributed` group
  (`base.ensure_distributed` joins it from the DMLC_* environment): gloo
  for host tensors, NCCL for card tensors.  `init` broadcasts worker 0's
  value; 2-bit gradient compression (`set_gradient_compression`)
  quantizes each push to {-threshold, 0, +threshold} with the
  quantization error carried to the next push, as the reference's
  `Quantize2BitKernel` does, and sends it as 2-bit codes; the barrier
  has a deadline (``MXNET_KVSTORE_BARRIER_TIMEOUT``) and names the
  waiting rank.  A process that is in no group is a single worker:
  `num_workers` 1, no wire, compression still applied.

Every store carries a membership generation (`generation`,
`advance_generation`, `check_generation`); a rank that presents an old
one is refused with `StaleMembership` before it can enter a barrier.
"""
from __future__ import annotations

import os
import threading
from typing import Dict

import torch

from ..base import MXNetError, ensure_distributed
from ..monitor import events
from ..ndarray.ndarray import NDArray, _wrap
from ..ndarray import sparse as _sparse
from ..optimizer import Optimizer, get_updater
from ..parallel.collectives import LOW_PRECISION

__all__ = ["KVStore", "DistKVStore", "StaleMembership", "create"]


class StaleMembership(MXNetError):
    """A rank presented a membership generation older than the store's:
    it belongs to a previous mesh and must not enter a barrier or a
    collective of the new one (ref: the JAX package's class)."""


def _is_list(x):
    return isinstance(x, (list, tuple))


def _tensor(x):
    """The tensor of an NDArray, a tensor or an array."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return NDArray(x, ctx="cpu")._data


class KVStore:
    """ref: kvstore.py KVStore (module doc)."""

    def __init__(self, kv_type: str = "local"):
        self.type = kv_type
        self._store: Dict = {}
        self._updater = None
        self._optimizer = None
        self._compression = {}
        self._generation = 0

    # -- membership generations ------------------------------------------
    @property
    def generation(self) -> int:
        return self._generation

    def advance_generation(self, reason: str = "membership-change") -> int:
        """A new membership generation: credentials of the previous one
        are refused from now on."""
        self._generation += 1
        events.incr("kvstore.generation_advanced")
        return self._generation

    def check_generation(self, generation) -> None:
        """Refuse (`StaleMembership`) a generation that is not the
        store's; None is unchecked."""
        if generation is None:
            return
        if int(generation) != self._generation:
            events.incr("kvstore.stale_rank")
            raise StaleMembership(
                "rank presented membership generation %d but the store is "
                "at generation %d — this rank belongs to a previous mesh; "
                "exit and rejoin" % (int(generation), self._generation))

    # ------------------------------------------------------------------
    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def init(self, key, value):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                continue
            vv = v[0] if _is_list(v) else v
            self._store[k] = _wrap(_tensor(vv).detach().clone())

    broadcast = init

    def push(self, key, value, priority=0):
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            if k not in self._store:
                raise MXNetError("key %r not initialised" % (k,))
            self._apply(k, self._aggregate(k, self._reduce(v)))

    def _aggregate(self, k, local):
        """The sum the store applies: the local sum on one worker."""
        return local

    def _apply(self, k, agg):
        """Update the stored value of `k` with aggregate `agg`: the
        optimizer in the store, else the pushed rows or the whole value
        replace it."""
        dst = self._store[k]
        if self._updater is not None:
            self._update(self._int_key(k), agg, dst)
        elif isinstance(agg, _sparse.RowSparseNDArray):
            rows = agg.indices._data.long().to(dst._data.device)
            t = dst._data.clone()
            t[rows] = agg.data._data.to(t.device, t.dtype)
            dst._data = t
        else:
            dst._data = _tensor(agg).detach().to(
                dst._data.device, dst._data.dtype, copy=True)

    def _update(self, index, grad, weight):
        """The store's optimizer on its weight (in place)."""
        updater = self._updater
        if isinstance(grad, _sparse.RowSparseNDArray):
            opt = updater.optimizer
            if index not in updater.states:
                updater.states[index] = opt.create_state_multi_precision(
                    index, weight._data)
            opt._sparse_update(index, weight._data, grad,
                               updater.states[index])
            return
        updater(index, _tensor(grad).to(weight._data.device),
                weight._data)

    @staticmethod
    def _write_out(dst, src):
        """Write `src` (NDArray, tensor or RowSparseNDArray) into `dst`
        as a fresh buffer in dst's dtype, on dst's device (a tensor `dst`
        is written in place)."""
        if isinstance(src, _sparse.RowSparseNDArray):
            if isinstance(dst, _sparse.RowSparseNDArray):
                dst.indices = src.indices.copy()
                dst.data = src.data.copy()
                dst._shape = src.shape
                return
            src = src.tostype("default")
        s = _tensor(src).detach()
        if isinstance(dst, _sparse.RowSparseNDArray):
            rsp = _sparse.cast_storage(_wrap(s), "row_sparse")
            dst.indices, dst.data, dst._shape = rsp.indices, rsp.data, \
                rsp.shape
        elif isinstance(dst, NDArray):
            dst._data = s.to(dst._data.device, dst._data.dtype, copy=True)
        else:
            with torch.no_grad():
                dst.copy_(s)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = self._normalize(key, out)
        for k, o in zip(keys, outs):
            if k not in self._store:
                raise MXNetError("key %r not initialised" % (k,))
            for dst in (o if _is_list(o) else [o]):
                self._write_out(dst, self._store[k])

    def pushpull(self, key, value, out=None, priority=0):
        """The sum over the copies (and workers) written into `out`
        (default: the copies themselves), the store untouched (ref:
        KVStoreNCCL::PushPull)."""
        keys, values = self._normalize(key, value)
        _, outs = self._normalize(key, value if out is None else out)
        for k, v, o in zip(keys, values, outs):
            agg = self._aggregate(k, self._reduce(v))
            for dst in (o if _is_list(o) else [o]):
                self._write_out(dst, agg)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Only the rows `row_ids` of the stored value (the others zero,
        or a RowSparseNDArray `out` of just those rows)."""
        keys, outs = self._normalize(key, out)
        _, rids = self._normalize(key, row_ids)
        for k, o, r in zip(keys, outs, rids):
            src = self._store[k]._data
            rows = _tensor(r[0] if _is_list(r) else r).long().to(src.device)
            vals = src.index_select(0, rows)
            for dst in (o if _is_list(o) else [o]):
                if isinstance(dst, _sparse.RowSparseNDArray):
                    dst.indices = _wrap(rows.to(torch.int32))
                    dst.data = _wrap(vals.clone())
                    dst._shape = tuple(src.shape)
                    continue
                dense = torch.zeros_like(src)
                dense[rows] = vals
                self._write_out(dst, _wrap(dense))

    # ------------------------------------------------------------------
    def set_optimizer(self, optimizer: Optimizer):
        """Run the optimizer in the store: a push updates the stored
        weight with the aggregate gradient."""
        self._optimizer = optimizer
        self._updater = get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """Only a dist store sends payloads that compression shrinks; an
        in-process one refuses, as in the JAX package."""
        raise MXNetError(
            "gradient compression requires a dist kvstore "
            "(create('dist_sync')); %r is in-process and transfers "
            "nothing to compress" % self.type)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Write the store's optimizer states (atomically: a temporary
        file, then `os.replace`)."""
        if self._updater is None:
            raise MXNetError("optimizer not set on kvstore")
        payload = self._updater.get_states(dump_optimizer)
        tmp = "%s.tmp.%d" % (fname, os.getpid())
        try:
            with open(tmp, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, fname)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("optimizer not set on kvstore")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        for i, st in list(self._updater.states.items()):
            w = self._store.get(i, self._store.get(str(i)))
            if w is not None:
                from ..optimizer.optimizer import _map_state
                self._updater.states[i] = _map_state(
                    lambda t, d=w._data.device: t.to(d), st)

    def _barrier(self, timeout=None, generation=None):
        """One process: nothing to wait for; a stale generation is still
        refused."""
        self.check_generation(generation)

    # ------------------------------------------------------------------
    @staticmethod
    def _normalize(key, value):
        if _is_list(key):
            return list(key), list(value)
        return [key], [value]

    @staticmethod
    def _int_key(k):
        try:
            return int(k)
        except (TypeError, ValueError):
            return k

    @staticmethod
    def _reduce(v):
        """The sum of a list of per-device copies, in order, on the first
        copy's device, in its dtype (row_sparse copies stay row_sparse)."""
        if not _is_list(v):
            return v
        if len(v) == 1:
            return v[0]
        if any(isinstance(x, _sparse.RowSparseNDArray) for x in v):
            acc = v[0]
            for x in v[1:]:
                acc = _sparse.add(acc, x)
            return acc
        acc = _tensor(v[0]).detach()
        for x in v[1:]:
            acc = acc + _tensor(x).detach().to(acc.device)
        return _wrap(acc)


def _quantize_2bit(g, residual, threshold):
    """ref: gradient_compression.cu Quantize2BitKernel: each element of
    g + residual to {-threshold, 0, +threshold}; the error stays in the
    returned residual."""
    x = g + residual
    q = torch.where(x >= threshold, threshold,
                    torch.where(x <= -threshold, -threshold, 0.0)) \
        .to(g.dtype)
    return q, x - q


class DistKVStore(KVStore):
    """Workers of a `torch.distributed` group (module doc): every
    worker's local sum is summed over all workers."""

    def __init__(self, kv_type="dist_sync"):
        super().__init__(kv_type)
        ensure_distributed()
        self._residuals: Dict = {}

    @staticmethod
    def _dist():
        import torch.distributed as dist
        return dist if dist.is_initialized() else None

    @property
    def rank(self) -> int:
        d = self._dist()
        return d.get_rank() if d else 0

    @property
    def num_workers(self) -> int:
        d = self._dist()
        return d.get_world_size() if d else 1

    def _retry(self, fn, what):
        """`fn()` retried on injected transient faults only
        (``fault`` site "kvstore.collective"): a real partial failure of
        a collective is not retried by one rank alone."""
        from .. import fault as _fault
        from ..parallel.resilience import retry_transient

        def attempt():
            _fault.maybe_raise("kvstore.collective")
            return fn()
        return retry_transient(attempt, what=what,
                               retryable=(_fault.TransientFault,))

    def _allreduce_sum(self, t):
        """The sum over workers in t's dtype (in f32 for bf16/f16),
        rounded into t's dtype."""
        d = self._dist()
        if d is None:
            return t

        def run():
            acc = t.float() if t.dtype in LOW_PRECISION else t.clone()
            d.all_reduce(acc)
            return acc.to(t.dtype)
        return self._retry(run, "kvstore allreduce (rank %d)" % self.rank)

    def _allreduce_2bit(self, k, t):
        """2-bit compression over the wire: `t` quantized with its error
        feedback, packed four codes a byte ({0, 1, 2} for -thr, 0, +thr),
        the bytes all-gathered and each worker's codes decoded and summed
        in rank order in f32 (ref: the JAX package's `_allreduce_2bit`;
        the wire carries 1/16 of an f32 payload)."""
        q = self._compress(k, t)
        d = self._dist()
        if d is None:
            return q
        thr = float(self._compression.get("threshold", 0.5))
        codes = (torch.sign(q) + 1).to(torch.uint8).reshape(-1)
        n = codes.numel()
        pad = (-n) % 4
        if pad:
            codes = torch.cat([codes, codes.new_ones(pad)])
        c = codes.view(-1, 4)
        packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)

        def run():
            rows = [torch.empty_like(packed) for _ in range(self.num_workers)]
            d.all_gather(rows, packed)
            return rows
        rows = self._retry(run, "kvstore allgather (rank %d)" % self.rank)
        total = torch.zeros(n + pad, dtype=torch.float32, device=t.device)
        for row in rows:
            u = torch.stack([row & 3, (row >> 2) & 3, (row >> 4) & 3,
                             (row >> 6) & 3], 1).reshape(-1)
            total += (u.float() - 1.0) * thr
        return total[:n].reshape(t.shape).to(t.dtype)

    def _bcast_from_root(self, t):
        d = self._dist()
        if d is None:
            return t

        def run():
            out = t.detach().clone().contiguous()
            d.broadcast(out, 0)
            return out
        return self._retry(run, "kvstore broadcast (rank %d)" % self.rank)

    def init(self, key, value):
        """Worker 0's value, broadcast to every worker."""
        keys, values = self._normalize(key, value)
        for k, v in zip(keys, values):
            if k in self._store:
                continue
            vv = v[0] if _is_list(v) else v
            self._store[k] = _wrap(self._bcast_from_root(_tensor(vv)))

    broadcast = init

    def _compress(self, k, payload):
        thr = float(self._compression.get("threshold", 0.5))
        res = self._residuals.get(k)
        if res is None:
            res = torch.zeros_like(payload)
        q, self._residuals[k] = _quantize_2bit(payload, res, thr)
        return q

    def _aggregate(self, k, local):
        """local -> the sum over workers (a row_sparse payload goes dense
        on the wire, as in the JAX package; one worker sends nothing)."""
        if isinstance(local, _sparse.RowSparseNDArray):
            if self._dist() is None:
                return local
            local = local.tostype("default")
        t = _tensor(local).detach()
        if self._compression.get("type") == "2bit":
            return _wrap(self._allreduce_2bit(k, t))
        return _wrap(self._allreduce_sum(t))

    def _barrier(self, timeout=None, generation=None):
        """A barrier with a deadline: a worker that never arrives turns
        into an MXNetError naming this rank instead of a hang.  `timeout`
        in seconds (default MXNET_KVSTORE_BARRIER_TIMEOUT; 0 waits
        forever).  A stale `generation` is refused before entry.  After
        a timeout the waiting thread is abandoned inside the collective:
        the process must exit."""
        from .. import config, fault as _fault
        self.check_generation(generation)
        if timeout is None:
            timeout = float(config.get("MXNET_KVSTORE_BARRIER_TIMEOUT"))
        hang = _fault.should_fire("kvstore.barrier_hang")
        d = self._dist()
        if d is None and not hang:
            return

        def wait():
            if hang:
                import time
                time.sleep(max(timeout, 0.1) + 5)
                return
            d.barrier()
        if timeout <= 0:
            return wait()
        err = []

        def body():
            try:
                wait()
            except Exception as e:          # surfaced after join
                err.append(e)
        t = threading.Thread(target=body, daemon=True,
                             name="kvstore_barrier")
        t.start()
        t.join(timeout)
        if t.is_alive():
            events.incr("kvstore.barrier_timeout")
            raise MXNetError(
                "kvstore barrier timed out after %.1fs on worker rank "
                "%d/%d — a peer is hung or dead; exit and let the "
                "scheduler restart this worker (raise "
                "MXNET_KVSTORE_BARRIER_TIMEOUT if the job is just slow)"
                % (timeout, self.rank, self.num_workers))
        if err:
            raise err[0]

    def set_gradient_compression(self, compression_params):
        params = dict(compression_params)
        if params.get("type", "2bit") != "2bit":
            raise MXNetError("unsupported compression type %r"
                             % params.get("type"))
        params.setdefault("type", "2bit")
        self._compression = params


_TYPES = ("local", "device", "nccl", "dist_sync", "dist_async",
          "dist_sync_device", "dist_async_device", "horovod", "p3store_dist")


def create(name: str = "local") -> KVStore:
    """ref: KVStore::Create."""
    if name not in _TYPES:
        raise MXNetError("unknown kvstore type %r" % name)
    if name.startswith("dist") or name == "p3store_dist":
        return DistKVStore(name)
    return KVStore(name)
