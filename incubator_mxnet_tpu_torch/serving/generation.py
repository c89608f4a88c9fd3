"""Generation serving of the PyTorch port: KV-cached decode with
continuous batching over a fixed slot set (counterpart of
incubator_mxnet_tpu/serving/generation.py).

The program set is closed and captured ahead of traffic; who is in the
batch, at what position and with what prompt is data flowing through
fixed-shape programs, never a new capture.  Each program comes from
`graph_capture.capture`: a `torch.cuda.CUDAGraph` on the card, the
recorded aten ops replayed on the same storage on the CPU.  All three
kinds share one graph pool, and each reads and writes only the engine's
static state, allocated once outside every program (the slot cache, one
prefill row, the per-bucket prompt inputs and the join's slot index), so
that no program's result lives in pool memory that another's replay
reuses:

1. ``prefill``, one program per prompt bucket (`MXNET_GEN_BUCKETS`):
   encode the padded prompt under its padding mask
   (`init_cache(src, valid, max_len=, mem_len=largest bucket)`, so every
   bucket yields one row shape) and copy the row into the static row.
2. ``join``, one program: the masked update of every cache leaf at the
   static slot index from the static row, and bos / position 0 / an
   all-eos output row for that slot (`torch.where`, as the JAX package's
   `jnp.where`).
3. ``decode_step``, one program at (slots, max_len): `decode_step(tok,
   pos, cache)`, the argmax, the one-hot write of the output row,
   `pos = min(pos + 1, max_len - 1)`, `tok = next`, and every updated
   leaf copied back into the static cache.  The copies are the port's
   counterpart of the JAX package's buffer donation; a check on the
   first replayed step (every leaf keeps its `data_ptr()` and holds the
   step's new values) counts ``gen.donation_copy`` and warns with the
   program's label when it fails.

``serve.traces`` counts captures: `warmup()` makes exactly
``len(prompt_buckets) + 2``, and after it no prompt length or batch
membership captures again.  A cold engine captures lazily on the decode
loop's thread.  Nothing falls back to eager: a failed capture raises
`graph_capture.CaptureError` from `warmup()` or fails the request that
triggered it; a failed join or decode step fails every live slot with a
typed error and resets the static cache in place.

**Continuous batching.**  The decode loop advances the fixed slot batch
step by step.  A sequence that finishes (eos, token budget or deadline)
frees its slot at the step boundary, and queued requests join at once.
Admission is the `_LaneQueue` of `serving.engine`: strict priority
across lanes, earliest deadline first within one, per-lane and
per-tenant quotas that shed with the typed errors (`Shed`, `QueueFull`,
`DeadlineExceeded`); a born-expired request, or one whose deadline the
prefill estimate says cannot see a first token, is shed before any
device work.  ``continuous=False`` is drain batching (a new batch forms
only when every slot is free), the A/B baseline.

**Streaming.**  `submit()` returns a `GenerationStream`: iterate it for
tokens as they are emitted (time to first token and inter-token latency
land in the labeled rings ``gen.ttft_us`` / ``gen.intertoken_us`` split
by lane) or call `.result()`.  `drain()` and `close()` resolve every
stream exactly once.

**Threads.**  `submit()` touches numpy only.  Every device operation
(the prompt's copy into its static input, every capture and replay, the
read of the step's tokens) runs on the decode loop's thread, or on the
`warmup()` caller under the same lock, and holds the device's
`graph_capture.gate` shared, so that no engine on the card launches
work while another's capture is open.  Each program files a
`telemetry.costs` row (its parameters, the static state and its pool
growth) under ``cost_label``.  The step's one host sync is the read of
its (slots,) tokens through a pinned buffer and an event.

Model contract (`models.TransformerNMT`, `models.Seq2Seq`):

- ``init_cache(src, src_valid_len, max_len=, mem_len=)`` -> dict of
  slot-major tensors whose shapes are a function of (prompt bucket,
  max_len, mem_len): the Transformer's per-layer K/V caches, or
  Seq2Seq's enc_k (B, M, H), src_len (B,) and LSTM h/c (B, L, H).  It
  runs once on meta tensors (`_leaf_specs`) as well;
- ``decode_step(tok, pos, cache)`` -> (next-token logits (B, V), updated
  cache), one token per slot per call, position as data.

The engine's device defaults to `cuda:0`; without CUDA, construction
raises unless the caller passes ``ctx=cpu()``.
"""
from __future__ import annotations

import logging
import queue
import threading
import time
import warnings
import weakref
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from .. import config as _cfg
from .. import fault
from .. import graph_capture as _gc
from ..context import resolve_device
from ..gluon.parameter import is_deferred
from ..monitor import events
from ..parallel.resilience import retry_transient
from ..telemetry import costs as _costs
from ..telemetry import flightrec as _bb
from ..telemetry import reqtrace as _reqtrace
from ..telemetry import spans as _tele
from .engine import (DeadlineExceeded, EngineClosed, QueueFull, Shed,
                     _LaneQueue, _OverQuota, _meta_call, _model_scope,
                     _nbytes as _tensor_bytes, _parse_lane_quotas,
                     _parse_lanes, _prime)

__all__ = ["GenerationEngine", "GenerationStream",
           "project_generation_footprint"]

_END = object()          # stream sentinel: normal end


def _parse_prompt_buckets(spec, max_len):
    """Power-of-two prompt-length buckets (`MXNET_GEN_BUCKETS`): the
    closed set prefill is captured over.  Empty = 8, 16, ... up to
    max_len (always at least one bucket)."""
    if spec and isinstance(spec, (list, tuple, set, frozenset)):
        bs = sorted({int(s) for s in spec})
    elif spec:
        bs = sorted({int(s) for s in str(spec).split(",") if s.strip()})
    else:
        bs, b = [], 8
        while b < int(max_len):
            bs.append(b)
            b *= 2
        bs.append(int(max_len))
        bs = sorted(set(bs))
    if not bs or bs[0] < 1:
        raise ValueError("generation prompt buckets must be positive "
                         "ints, got %r" % (spec,))
    return tuple(bs)


def _leaf_specs(block, max_len, mem_len, vocab=False):
    """{leaf: (shape, dtype)} of one `init_cache` row at prompt length
    `mem_len`, and with `vocab` the width of `decode_step`'s logits, from
    a run on the meta device (the block's tensors swapped for meta
    copies): no device memory, no kernel."""
    width = None
    with _model_scope():
        src = torch.zeros((1, mem_len), dtype=torch.int32, device="meta")
        valid = torch.full((1,), mem_len, dtype=torch.int32, device="meta")
        row = _meta_call(block, "init_cache", (src, valid),
                         dict(max_len=int(max_len), mem_len=int(mem_len)))
        specs = {k: (tuple(v.shape), v.dtype) for k, v in row.items()}
        if vocab:
            logits, _ = _meta_call(block, "decode_step",
                                   (src[:, 0], src[:, 0], row))
            width = int(logits.shape[-1])
    return specs, width


def _nbytes(shape, dtype):
    return int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()


def project_generation_footprint(block, slots, max_len, buckets,
                                 vocab_hint=None, temp_factor=None):
    """Projected device bytes for generation serving: parameter bytes +
    ``slots x kv_bytes_per_slot`` + a temp-factor margin over the decode
    step's logits.  The KV bytes per slot come from the leaves the
    model's own `init_cache` produces, run on the meta device (no memory,
    no kernel); the vocab from `decode_step`'s logits unless hinted.
    Returns (total_bytes, detail) with the KV term broken out."""
    if temp_factor is None:
        temp_factor = float(_cfg.get("MXNET_SERVE_HBM_TEMP_FACTOR"))
    pb = sum(p.numel() * p.element_size()
             for p in block.collect_params().values())
    mem_len = int(max(buckets))
    specs, vocab = _leaf_specs(block, max_len, mem_len,
                               vocab=not vocab_hint)
    kv_slot = sum(_nbytes(shape[1:], dt) for shape, dt in specs.values())
    kv_total = int(slots) * kv_slot
    vocab = int(vocab_hint or vocab)
    act = int(slots) * max(vocab, 1) * 4
    total = int(pb + kv_total + temp_factor * act)
    return total, {"param_bytes": int(pb),
                   "kv_bytes_per_slot": int(kv_slot),
                   "slots": int(slots),
                   "kv_bytes": int(kv_total),
                   "max_len": int(max_len),
                   "mem_len": mem_len,
                   "temp_factor": float(temp_factor)}


class GenerationStream:
    """Streaming handle for one generation request.

    - Iterate for tokens as they are emitted (``for tok in stream``).
    - ``result(timeout)`` blocks for the full sequence (np.int32 array)
      or raises the terminal error (DeadlineExceeded / EngineClosed /
      Shed / the failure of a program).
    - ``future`` is the underlying `concurrent.futures.Future`, resolved
      exactly once.
    """

    def __init__(self, lane, tenant):
        self.lane = lane
        self.tenant = tenant
        self.future = Future()
        self._q = queue.Queue()
        self._tokens = []

    # -- engine side ---------------------------------------------------
    def _push(self, tok):
        self._tokens.append(int(tok))
        self._q.put(int(tok))

    def _finish(self, exc=None):
        """Resolve exactly once (idempotent: the close() flush may race
        a retire)."""
        if self.future.done():
            return False
        try:
            if exc is not None:
                self.future.set_exception(exc)
            else:
                self.future.set_result(np.asarray(self._tokens, np.int32))
        except Exception:       # noqa: BLE001 — cancelled by caller
            events.incr("gen.cancelled")
        self._q.put(exc if exc is not None else _END)
        return True

    # -- caller side ---------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _END:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def tokens(self):
        """Tokens emitted so far (list copy, non-blocking)."""
        return list(self._tokens)

    def result(self, timeout=None):
        return self.future.result(timeout)

    def done(self):
        return self.future.done()


class _GenRequest:
    __slots__ = ("prompt", "max_new", "deadline", "lane", "tenant",
                 "stream", "t_enq", "tele", "future", "n", "acct",
                 "rec")

    def __init__(self, prompt, max_new, deadline, lane, tenant):
        self.prompt = prompt
        self.max_new = max_new
        self.t_enq = time.monotonic()
        self.deadline = None if deadline is None \
            else self.t_enq + float(deadline)
        self.lane = lane
        self.tenant = tenant
        self.stream = GenerationStream(lane, tenant)
        self.future = self.stream.future    # _LaneQueue duck type
        self.n = 1
        self.acct = False       # queue/tenant accounting released once
        self.tele = _tele.current()
        self.rec = None         # reqtrace.Record (journal lifecycle)


class _Slot:
    __slots__ = ("req", "emitted", "t_join", "t_last")

    def __init__(self, req):
        self.req = req
        self.emitted = 0
        self.t_join = time.monotonic()
        self.t_last = None      # last token wall (inter-token meter)


class _Static:
    """The engine's device state, allocated once, outside every program:
    the slot cache (model leaves at (S, ...) plus int32 tok, pos and
    out), one prefill row (1, ...), each bucket's prompt inputs, the
    join's slot index, and the host side of the prompt and token
    copies (pinned on the card)."""

    def __init__(self, specs, S, L, buckets, device, eos):
        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        i32 = torch.int32
        self.cache = {k: zeros((S,) + shape[1:], dt)
                      for k, (shape, dt) in specs.items()}
        self.tok = torch.full((S,), eos, dtype=i32, device=device)
        self.pos = zeros((S,), i32)
        self.out = torch.full((S, L), eos, dtype=i32, device=device)
        self.row = {k: zeros(shape, dt) for k, (shape, dt) in specs.items()}
        self.src = {b: zeros((1, b), i32) for b in buckets}
        self.valid = {b: zeros((1,), i32) for b in buckets}
        self.slot = zeros((), torch.int64)
        pin = device.type == "cuda"
        # prompt tokens then the valid length, staged for one H2D copy
        self.prompt_host = torch.zeros((1, max(buckets) + 1), dtype=i32,
                                       pin_memory=pin)
        self.tok_host = torch.zeros((S,), dtype=i32, pin_memory=pin)
        self.copied = torch.cuda.Event() if pin else None

    def leaves(self):
        """Every tensor of the slot cache, by name."""
        return dict(self.cache, tok=self.tok, pos=self.pos, out=self.out)

    def reset(self, eos):
        """The empty cache, in place (the programs keep reading it)."""
        for t in self.cache.values():
            t.zero_()
        self.tok.fill_(eos)
        self.pos.zero_()
        self.out.fill_(eos)


class GenerationEngine:
    """KV-cached autoregressive decode with continuous batching over a
    fixed slot set.

    block: a model implementing ``init_cache``/``decode_step``
        (`models.TransformerNMT`, `models.Seq2Seq`), its parameters on
        the engine's device.
    bos / eos: special token ids (decode starts from bos; an emitted eos
        retires the sequence).
    ctx: the device, `gpu(i)`, `cpu()` or a device string (default
        `cuda:0`; without CUDA the caller must ask for the CPU).
    slots / max_len: the (slot count, max_len) the one decode step is
        captured at (`MXNET_GEN_SLOTS`, `MXNET_GEN_MAX_LEN`).  max_len
        bounds prompt length and emitted tokens per request.
    prompt_buckets: closed prompt-length bucket set (`MXNET_GEN_BUCKETS`;
        empty = powers of two up to max_len).
    continuous: True = continuous batching (join at step boundaries);
        False = drain batching (the measured baseline).

    Lifecycle: construct -> ``warmup()`` -> ``submit()`` traffic ->
    ``drain()`` / ``close()``.
    """

    def __init__(self, block, bos, eos, ctx=None, slots=None,
                 max_len=None, prompt_buckets=None, queue_cap=None,
                 lanes=None, lane_quotas=None, tenant_quota=None,
                 continuous=True, cost_label=None, max_new_default=None):
        for m in ("init_cache", "decode_step"):
            if not callable(getattr(block, m, None)):
                raise TypeError(
                    "generation needs a model with the explicit-cache "
                    "decode contract (missing %r) — see "
                    "models/transformer.py and models/seq2seq.py" % m)
        self._device = resolve_device(ctx)
        self._block = block
        self._bos, self._eos = int(bos), int(eos)
        self._S = int(slots if slots is not None
                      else _cfg.get("MXNET_GEN_SLOTS"))
        self._L = int(max_len if max_len is not None
                      else _cfg.get("MXNET_GEN_MAX_LEN"))
        if self._S < 1 or self._L < 2:
            raise ValueError("need slots >= 1 and max_len >= 2")
        blk_max = getattr(block, "_max_length", None)
        if blk_max is not None and self._L > int(blk_max):
            raise ValueError(
                "max_len %d exceeds the model's positional table "
                "(max_length=%d)" % (self._L, int(blk_max)))
        self._buckets = _parse_prompt_buckets(
            prompt_buckets if prompt_buckets is not None
            else _cfg.get("MXNET_GEN_BUCKETS"), self._L)
        self._mem_len = int(self._buckets[-1])
        self._max_new_default = int(max_new_default or self._L)
        self._continuous = bool(continuous)
        self._label = str(cost_label or "serve.gen")
        self._journal = _reqtrace.journal(
            "gen",
            self._label.split(":", 1)[1]
            if ":" in self._label else self._label)

        cap = max(1, int(queue_cap if queue_cap is not None
                         else _cfg.get("MXNET_SERVE_QUEUE_CAP")))
        self._lanes = _parse_lanes(
            lanes if lanes is not None
            else _cfg.get("MXNET_SERVE_LANES"))
        self._lane_caps = _parse_lane_quotas(
            lane_quotas if lane_quotas is not None
            else _cfg.get("MXNET_SERVE_LANE_QUOTAS"), self._lanes, cap)
        self._q = _LaneQueue(cap, self._lanes, self._lane_caps)
        self._tenant_q = {}
        self._tenant_quota = int(
            tenant_quota if tenant_quota is not None
            else _cfg.get("MXNET_SERVE_TENANT_QUOTA"))

        self._lock = threading.Lock()       # host bookkeeping
        self._exec_lock = threading.Lock()  # device work: warmup vs loop
        self._work = threading.Event()      # submit -> wake the idle loop
        self._lane_deadline_s = {}          # lane -> deque of rel deadlines
        self._slots = [None] * self._S      # host mirror: _Slot | None
        self._prefill_ewma = {}             # bucket -> prefill seconds
        self._step_ewma = None              # decode-step seconds
        self._steps = 0
        self._thread = None
        self._draining = False
        self._stop = False
        self._closed = False
        self._warm = False
        self._donation_checked = False

        params = block.collect_params()
        if any(is_deferred(p) for p in params.values()):
            # deferred widths: one small teacher-forced forward on the
            # engine's device gives the parameters their shapes
            src = torch.full((1, self._buckets[0]), self._bos,
                             dtype=torch.int32, device=self._device)
            with _model_scope():
                block(src, src[:, :1])
        for name, p in block.collect_params().items():
            if p.device != self._device:
                raise ValueError(
                    "parameter %s lives on %s but the engine runs on %s; "
                    "move the block first" % (name, p.device, self._device))
        self._specs, _ = _leaf_specs(block, self._L, self._mem_len)
        self._state = None      # _Static, allocated by the first device
        self._programs = {}     # work: "join", "decode", ("prefill", b)
        self._pool = None       # the programs' shared graph pool
        self._rows = {}         # work -> cost-row key
        self._written = None    # leaves the decode step writes back
        self._ptrs = None       # every leaf's data_ptr() at allocation
        self._gate = _gc.gate(self._device)
        # the engine's graphs are captured on a stream of their own, so
        # the cuBLAS workspace they bake in is theirs alone: another
        # engine's graphs may replay beside them
        self._capture_stream = torch.cuda.Stream(self._device) \
            if self._device.type == "cuda" else None
        _bb.install_crash_hooks()

    # -- static state and programs ---------------------------------------
    def _ensure_state(self):
        if self._state is None:
            st = _Static(self._specs, self._S, self._L, self._buckets,
                         self._device, self._eos)
            self._ptrs = {k: t.data_ptr() for k, t in st.leaves().items()}
            self._state = st
        return self._state

    def _prefill_fn(self, b):
        st, block = self._state, self._block

        def prefill():
            with _model_scope():
                row = block.init_cache(st.src[b], st.valid[b],
                                       max_len=self._L,
                                       mem_len=self._mem_len)
                for k, t in st.row.items():
                    t.copy_(row[k])
        return prefill

    def _join_fn(self):
        st, S = self._state, self._S

        def join():
            with _model_scope():
                keep = torch.arange(S, device=st.slot.device) == st.slot
                for k, c in st.cache.items():
                    m = keep.reshape((S,) + (1,) * (c.dim() - 1))
                    c.copy_(torch.where(m, st.row[k].to(c.dtype), c))
                st.tok.copy_(torch.where(keep, self._bos, st.tok))
                st.pos.copy_(torch.where(keep, 0, st.pos))
                st.out.copy_(torch.where(keep[:, None], self._eos, st.out))
        return join

    def _decode_fn(self):
        st, block, L = self._state, self._block, self._L

        def decode_step():
            with _model_scope():
                logits, new = block.decode_step(st.tok, st.pos, st.cache)
                nxt = logits.argmax(-1).to(torch.int32)
                # the device-resident emitted-token record, one-hot at pos
                oh = (torch.arange(L, device=nxt.device)
                      == st.pos.reshape(-1, 1)).to(torch.int32)
                st.out.copy_(st.out * (1 - oh) + nxt[:, None] * oh)
                # the clamp keeps dead slots' one-hot writes in range; a
                # live slot never reaches it (max_new <= max_len)
                st.pos.copy_(torch.clamp(st.pos + 1, max=L - 1))
                st.tok.copy_(nxt)
                written = [k for k, t in st.cache.items() if new[k] is not t]
                for k in written:
                    st.cache[k].copy_(new[k])
            self._written = written
        return decode_step

    def _run(self, key):
        """Replay program `key`, capturing it first when it does not
        exist yet (a capture on the CPU runs it once itself)."""
        prog = self._programs.get(key)
        if prog is None:
            fn = (self._prefill_fn(key[1]) if isinstance(key, tuple)
                  else self._join_fn() if key == "join"
                  else self._decode_fn())
            _prime(self._device)
            t0 = time.monotonic()
            prog, _ = _gc.capture(fn, self._device, pool=self._pool,
                                  stream=self._capture_stream)
            wall = time.monotonic() - t0
            if self._pool is None:
                self._pool = prog.pool()
            self._programs[key] = prog
            self._note_cost(key, prog.pool_growth, wall)
            events.incr("serve.traces")
            if prog.ran:
                return
        prog.replay()
        _costs.invoke(self._rows[key])

    def _note_cost(self, key, growth, wall):
        """One cost row per program, all in the family
        ``<cost_label>:gen`` (``:gen[prefill16]``, ``:gen[join]``,
        ``:gen[decode_step]``): the programs share the parameters and the
        static state, which `costs.footprint_bytes` counts once, and each
        adds its pool growth on the card."""
        name = "prefill%d" % key[1] if isinstance(key, tuple) \
            else ("decode_step" if key == "decode" else key)
        shared = sum(_tensor_bytes(t) for t in self.held_tensors())
        self._rows[key] = _costs.note_program(
            "serve", "%s:gen[%s]" % (self._label, name),
            group="%x" % id(self), param_bytes=shared,
            argument_bytes=shared, output_bytes=0,
            temp_bytes=max(0, growth or 0), pool_bytes=growth,
            capture_s=wall)

    def _stage(self, prompt, bucket):
        """Copy `prompt`, padded to `bucket`, and its length into the
        bucket's static inputs."""
        st = self._state
        if st.copied is not None:
            st.copied.synchronize()     # the last copy read the buffer
        host = st.prompt_host
        host.zero_()
        host[0, :prompt.size] = torch.from_numpy(prompt)
        host[0, -1] = prompt.size
        st.src[bucket].copy_(host[:, :bucket], non_blocking=True)
        st.valid[bucket].copy_(host[0, -1:], non_blocking=True)
        if st.copied is not None:
            st.copied.record()

    def _read_tokens(self):
        """The step's one host sync: the (S,) next tokens."""
        st = self._state
        st.tok_host.copy_(st.tok, non_blocking=True)
        if st.copied is not None:
            st.copied.record()
            st.copied.synchronize()
        return st.tok_host.numpy().copy()

    def _donation_probe(self, live):
        """Before the first replayed step: each live slot's position and
        its cache rows there.  Returns a check to run after the step."""
        st = self._state
        idx = torch.tensor(live, device=self._device)
        pos = st.pos[idx].long()
        rows = {k: st.cache[k][idx, pos].clone()
                for k in (self._written or ())}

        def holds_new_values():
            ok = {k: t.data_ptr() for k, t in st.leaves().items()} \
                == self._ptrs
            ok = ok and bool(torch.equal(
                st.pos[idx].long(), (pos + 1).clamp(max=self._L - 1)))
            ok = ok and bool(torch.equal(st.out[idx, pos], st.tok[idx]))
            return ok and all(
                bool((st.cache[k][idx, pos] != r).any(-1).all())
                for k, r in rows.items())
        return holds_new_values

    def held_tensors(self):
        """The tensors this engine holds on its device: the model's
        parameters and the static state its programs read and write."""
        out = list(self._block.parameters())
        st = self._state
        if st is not None:
            out += list(st.leaves().values()) + list(st.row.values())
            out += list(st.src.values()) + list(st.valid.values())
        return out

    def kv_cache_bytes(self):
        """Device bytes of the slot cache (the model's leaves at (S, ...)
        and the tok, pos and out rows), and the per-slot share."""
        S, L = self._S, self._L
        total = sum(_nbytes((S,) + shape[1:], dt)
                    for shape, dt in self._specs.values())
        total += 4 * (2 * S + S * L)
        return {"total": total, "per_slot": total // S, "slots": S}

    # -- warmup ---------------------------------------------------------
    def warmup(self):
        """Capture the whole program set (one prefill per prompt bucket,
        the join and the (S, max_len) decode step) and run each once;
        after it ``serve.traces`` stays flat under any mix of prompt
        lengths and batch membership.  Raises `graph_capture.
        CaptureError` when a program cannot be captured.  Returns a
        summary dict."""
        t0 = time.monotonic()
        per_bucket = {}
        with self._exec_lock, self._gate.work(), _model_scope():
            fault.maybe_raise(
                "serve.oom", 0, msg="RESOURCE_EXHAUSTED: out of memory "
                "while warming %r (injected)" % self._label)
            st = self._ensure_state()
            for b in self._buckets:
                tb = time.monotonic()
                self._stage(np.full((b,), self._bos, np.int32), b)
                self._run(("prefill", b))
                if self._device.type == "cuda":
                    torch.cuda.synchronize(self._device)
                per_bucket[b] = round(time.monotonic() - tb, 4)
            st.slot.fill_(0)
            self._run("join")
            self._run("decode")
            self._read_tokens()
        self._warm = True
        events.incr("gen.warmups")
        return {"prompt_buckets": list(self._buckets),
                "slots": self._S, "max_len": self._L,
                "wall_s": round(time.monotonic() - t0, 3),
                "bucket_wall_s": per_bucket,
                "kv_cache": self.kv_cache_bytes(),
                "traces": events.get("serve.traces")}

    # -- submission ------------------------------------------------------
    def _shed_mark(self, lane, tenant, reason, deadline=False):
        events.incr("gen.rejected")
        if deadline:
            events.incr("gen.deadline_expired")
        events.incr("gen.shed")
        events.incr("gen.shed", labels={"lane": lane or "-",
                                        "reason": reason})
        if tenant is not None:
            events.incr("gen.shed", labels={"tenant": tenant})

    def _shed(self, lane, tenant, reason, msg):
        self._shed_mark(lane, tenant, reason)
        raise Shed(msg)

    def submit(self, prompt, max_new_tokens=None, deadline=None,
               lane=None, tenant=None):
        """Enqueue one generation request.

        prompt: 1-D int token sequence (list/np array), length <= the
            largest prompt bucket.
        max_new_tokens: emitted-token budget (default: max_len).
        deadline: seconds from now for the full generation; expiry, even
            mid-decode, resolves the stream with DeadlineExceeded and
            frees the slot.
        Returns a `GenerationStream`.  Raises QueueFull / Shed /
        DeadlineExceeded / EngineClosed synchronously.
        """
        if fault.should_fire("serve.enqueue"):
            events.incr("gen.rejected")
            raise QueueFull("injected enqueue fault (serve.enqueue)")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if prompt.size > self._buckets[-1]:
            raise ValueError(
                "prompt of %d tokens exceeds the largest prompt "
                "bucket (%d); the bucket set is closed by design "
                "(MXNET_GEN_BUCKETS)" % (prompt.size, self._buckets[-1]))
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self._max_new_default)
        if not 0 < max_new <= self._L:
            raise ValueError("max_new_tokens must be in [1, %d] (the "
                             "max_len bucket)" % self._L)
        lane = self._lanes[0] if lane is None else str(lane)
        if lane not in self._lane_caps:
            raise ValueError("unknown lane %r (engine lanes: %s)"
                             % (lane, ",".join(self._lanes)))
        tenant = str(tenant) if tenant is not None else None
        req = _GenRequest(prompt, max_new, deadline, lane, tenant)
        req.rec = self._journal.start(req.t_enq, lane, tenant)
        if req.deadline is not None and req.deadline <= req.t_enq:
            self._shed_mark(lane, tenant, "deadline", deadline=True)
            exc = DeadlineExceeded("deadline is not in the future")
            rec, req.rec = req.rec, None
            self._journal.retire(rec, exc=exc)
            raise exc
        try:
            with self._lock:
                if self._closed or self._draining:
                    events.incr("gen.rejected")
                    raise EngineClosed("engine is draining/closed")
                if tenant is not None and self._tenant_quota > 0 and \
                        self._tenant_q.get(tenant, 0) >= \
                        self._tenant_quota:
                    self._shed(
                        lane, tenant, "tenant_quota",
                        "tenant %r over quota (%d queued, cap %d)"
                        % (tenant, self._tenant_q.get(tenant, 0),
                           self._tenant_quota))
                try:
                    self._q.put_nowait(req)
                except _OverQuota as oq:
                    self._shed(
                        lane, tenant, "lane_quota",
                        "lane %r over quota (%d queued, cap %d); "
                        "excess work is shed under overload — see "
                        "MXNET_SERVE_LANE_QUOTAS"
                        % (oq.lane, oq.depth, oq.cap))
                except queue.Full:
                    events.incr("gen.rejected")
                    raise QueueFull(
                        "generation queue at capacity (%d); retry "
                        "later or raise MXNET_SERVE_QUEUE_CAP"
                        % self._q.maxsize)
                if tenant is not None:
                    self._tenant_q[tenant] = \
                        self._tenant_q.get(tenant, 0) + 1
                if deadline is not None:
                    dq = self._lane_deadline_s.get(lane)
                    if dq is None:
                        dq = self._lane_deadline_s[lane] = \
                            deque(maxlen=256)
                    dq.append(float(deadline))
        except (Shed, QueueFull, EngineClosed) as e:
            # synchronous refusals never reach _resolve: this is their
            # journal retire point
            rec, req.rec = req.rec, None
            self._journal.retire(rec, exc=e)
            raise
        events.incr("gen.requests")
        events.incr("gen.requests", labels={"lane": lane})
        if tenant is not None:
            events.incr("gen.requests", labels={"tenant": tenant})
        self._ensure_loop()
        self._work.set()
        return req.stream

    def _ensure_loop(self):
        if self._thread is not None and self._thread.is_alive():
            return
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=GenerationEngine._decode_loop,
                    args=(weakref.ref(self),), daemon=True,
                    name="GenDecodeLoop")
                self._thread.start()

    # -- decode loop -----------------------------------------------------
    @staticmethod
    def _decode_loop(ref):
        """Weakref-held loop: an engine dropped without close() lets this
        thread retire at its next poll instead of pinning the parameters
        and the slot cache."""
        eng0 = ref()
        if eng0 is None:
            return
        wake = weakref.ref(eng0._work)
        del eng0
        while True:
            eng = ref()
            if eng is None:
                return
            try:
                state = eng._tick()
                if state == "closed":
                    # a request this thread popped or joined after
                    # close()'s own sweep must still resolve; the flush
                    # is idempotent, so both sides may run it
                    eng._flush_leftovers()
                    return
                idle = state == "idle"
            except Exception as e:      # noqa: BLE001 — the loop must
                logging.getLogger(__name__).exception(  # survive anything
                    "generation decode loop error (recovered)")
                events.incr("gen.loop_errors")
                _bb.record("fault", "gen.loop", error=type(e).__name__)
                _bb.crash_dump("gen.loop", e)
                idle = True
            finally:
                del eng
            if idle:
                # block on the submit-side event, not a poll; the strong
                # ref lapsed above, so an abandoned engine still goes
                ev = wake()
                if ev is not None:
                    ev.wait(0.05)
                    ev.clear()

    def _live(self):
        return [i for i, s in enumerate(self._slots) if s is not None]

    def _free(self):
        return [i for i, s in enumerate(self._slots) if s is None]

    def _tick(self):
        """One scheduler round: admit into free slots at this step
        boundary, then advance the decode batch one token.  Returns
        'ran' | 'idle' | 'closed'."""
        if self._stop:
            return "closed"
        with self._exec_lock, self._gate.work(), _model_scope():
            self._admit()
            live = self._live()
            if not live:
                return "idle"
            self._step(live)
        return "ran"

    def _admit(self):
        """Fill free slots from the lane queue.  Continuous mode joins
        whenever a slot is free; drain mode only when every slot is."""
        free = self._free()
        if not free:
            return
        if not self._continuous and len(free) != self._S:
            return
        while free:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                return
            if req.rec is not None:     # queue phase ends at the pop
                req.rec.t_collect = time.monotonic()
            slot = free.pop(0)
            if not self._admit_one(req, slot):
                free.insert(0, slot)    # shed: the slot stays free

    def _admit_one(self, req, slot):
        """Prefill and join one request into `slot`.  Returns True when
        the slot was taken.  Sheds born-expired and infeasible-deadline
        requests (prefill estimate and one step say no first token can
        land in time) with the typed errors, before any device work."""
        if self._closed or self._stop:
            # a close() raced the pop: resolve, never strand
            self._resolve(req, exc=EngineClosed(
                "engine closed before dispatch"))
            return False
        now = time.monotonic()
        bucket = self._bucket_for(req.prompt.size)
        if req.rec is not None:
            req.rec.bucket = bucket
        if req.deadline is not None:
            est = self._prefill_ewma.get(bucket, 0.0) \
                + (self._step_ewma or 0.0)
            if now + est * 1.25 > req.deadline:
                self._shed_mark(req.lane, req.tenant, "deadline",
                                deadline=True)
                self._resolve(req, exc=DeadlineExceeded(
                    "deadline %s before the first token could land "
                    "(prefill estimate %.3fs)"
                    % ("expired" if now > req.deadline
                       else "infeasible", est)))
                return False
        if not req.stream.future.set_running_or_notify_cancel():
            events.incr("gen.cancelled")
            rec, req.rec = req.rec, None
            self._journal.retire(rec, status="cancelled",
                                 reason="cancelled while queued")
            self._retire_accounting(req)
            return False
        t0 = time.monotonic()
        span = _tele.span("serve.prefill", parent=req.tele)
        span.start()
        try:
            fault.maybe_raise("serve.infer", step=self._steps)
            st = self._ensure_state()
            self._stage(req.prompt, bucket)
            self._run(("prefill", bucket))
        except Exception as e:          # noqa: BLE001 — the prefill
            span.stop()                 # writes only its own row: this
            events.incr("gen.failed")   # request fails, the engine
            self._resolve(req, exc=e)   # survives
            return False
        try:
            st.slot.fill_(slot)
            self._run("join")
        except Exception as e:          # noqa: BLE001 — the join writes
            span.stop()                 # the whole cache: running slots
            events.incr("gen.failed")   # lose their state too; fail
            self._resolve(req, exc=e)   # them and reset it
            for i in self._live():
                self._retire(i, exc=EngineClosed(
                    "slot state lost to a failed join (%s)"
                    % type(e).__name__))
            st.reset(self._eos)
            _bb.record("gen", "join_failed", error=type(e).__name__)
            return False
        span.stop()
        if req.rec is not None:         # prefill phase ends here
            req.rec.t_exec = time.monotonic()
        dt = time.monotonic() - t0
        prev = self._prefill_ewma.get(bucket)
        self._prefill_ewma[bucket] = dt if prev is None \
            else 0.3 * dt + 0.7 * prev
        events.observe_time("gen.prefill_us", dt)
        events.incr("gen.prefills")
        events.incr("gen.joins")
        self._slots[slot] = _Slot(req)
        self._occupancy_event("join", slot, req)
        return True

    def _bucket_for(self, n):
        for b in self._buckets:
            if b >= n:
                return b
        return self._buckets[-1]

    def _step(self, live):
        """Advance every live slot one token; stream, then retire
        finished sequences at this boundary.  A failed decode step fails
        every live sequence (typed, exactly once) and resets the cache."""
        t0 = time.monotonic()
        check = None
        with _tele.span("serve.decode_step"):
            # injected transient faults fire host-side, before the
            # replay, so retrying them is safe; serve.decode_slow stalls
            # a step (deadline tests) without failing it
            fault.maybe_slow("serve.decode_slow", step=self._steps)
            retry_transient(
                lambda: fault.maybe_raise("serve.infer",
                                          step=self._steps),
                what="gen.decode_step", event="gen.retries")
            try:
                self._ensure_state()
                if not self._donation_checked and "decode" in self._programs:
                    check = self._donation_probe(live)
                self._run("decode")
                toks = self._read_tokens()
            except Exception as e:          # noqa: BLE001 — terminal:
                events.incr("gen.failed")   # fail live slots, reset
                for i in list(live):
                    self._retire(i, exc=e)
                if self._state is not None:
                    self._state.reset(self._eos)
                _bb.record("gen", "step_failed", error=type(e).__name__)
                return
        if check is not None:
            self._donation_checked = True
            if not check():
                events.incr("gen.donation_copy")
                warnings.warn(
                    "program %r: the slot cache was not updated in place "
                    "(a leaf moved or lacks the step's values)"
                    % (self._label + ":decode_step"))
        dt = time.monotonic() - t0
        self._step_ewma = dt if self._step_ewma is None \
            else 0.3 * dt + 0.7 * self._step_ewma
        self._steps += 1
        events.observe_time("gen.step_us", dt)
        events.incr("gen.steps")
        events.incr("gen.tokens", len(live))
        events.observe("gen.slots_live", len(live))
        now = time.monotonic()
        for i in live:
            slot = self._slots[i]
            if slot is None:    # a racing close() swept this slot; its
                continue        # stream is already resolved
            req = slot.req
            tok = int(toks[i])
            slot.emitted += 1
            if slot.t_last is None:
                events.observe_time("gen.ttft_us", now - req.t_enq)
                events.observe("gen.ttft_us",
                               int((now - req.t_enq) * 1e6),
                               labels={"lane": req.lane})
            else:
                events.observe_time("gen.intertoken_us",
                                    now - slot.t_last)
                events.observe("gen.intertoken_us",
                               int((now - slot.t_last) * 1e6),
                               labels={"lane": req.lane})
            slot.t_last = now
            req.stream._push(tok)
            if req.deadline is not None and now > req.deadline:
                # mid-decode deadline: shed, free the slot this step
                self._shed_mark(req.lane, req.tenant, "deadline",
                                deadline=True)
                self._retire(i, exc=DeadlineExceeded(
                    "deadline expired after %d token(s)"
                    % slot.emitted))
            elif tok == self._eos or slot.emitted >= req.max_new:
                self._retire(i)

    def _occupancy_event(self, kind, slot, req):
        live = len(self._live())
        _bb.record("gen", kind, slot=int(slot), lane=req.lane,
                   live=live, free=self._S - live, step=self._steps)

    def _retire(self, i, exc=None):
        with self._lock:        # close()'s sweep may race this clear;
            slot = self._slots[i]   # one winner takes the request
            self._slots[i] = None
        if slot is None:
            return
        req = slot.req
        if req.rec is not None:         # decode phase ends here
            req.rec.t_fin = time.monotonic()
        self._resolve(req, exc=exc)
        events.incr("gen.retires")
        e2e = time.monotonic() - req.t_enq
        events.observe_time("gen.e2e_us", e2e)
        events.observe("gen.e2e_us", int(e2e * 1e6),
                       labels={"lane": req.lane})
        self._occupancy_event("retire", i, req)

    def _retire_accounting(self, req):
        """Queue-slot and tenant-hold release, exactly once per accepted
        request (the per-request flag, flipped under the lock, makes a
        close() sweep racing the loop's own retire a no-op)."""
        with self._lock:
            if req.acct:
                return
            req.acct = True
            if req.tenant is not None:
                n = self._tenant_q.get(req.tenant, 0) - 1
                if n > 0:
                    self._tenant_q[req.tenant] = n
                else:
                    self._tenant_q.pop(req.tenant, None)
        self._q.task_done()

    def _resolve(self, req, exc=None):
        req.stream._finish(exc)
        rec, req.rec = req.rec, None    # single journal retire point
        if rec is not None:
            self._journal.retire(rec, exc=exc)
        self._retire_accounting(req)

    # -- lifecycle -------------------------------------------------------
    def drain(self, timeout=60.0):
        """Stop intake and wait for every accepted request to resolve
        (queued requests still get generated).  True when fully drained
        in time."""
        self._draining = True
        deadline = time.monotonic() + float(timeout)
        self._ensure_loop()
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    return False
                if self._thread is None or \
                        not self._thread.is_alive():
                    break
                self._q.all_tasks_done.wait(min(rem, 0.1))
        return self._q.unfinished_tasks == 0

    def _flush_leftovers(self):
        """Resolve everything still queued or slotted with EngineClosed.
        Idempotent, and safe from both the closing thread and the decode
        loop's exit path."""
        leftovers = []
        with self._lock:
            while True:
                try:
                    leftovers.append(self._q.get_nowait())
                except queue.Empty:
                    break
            for i, s in enumerate(self._slots):
                if s is not None:
                    self._slots[i] = None
                    leftovers.append(s.req)
        for req in leftovers:
            self._resolve(req, exc=EngineClosed(
                "engine closed before completion"))

    def close(self, timeout=60.0):
        """drain() + stop the decode loop + resolve any leftover stream
        (EngineClosed) exactly once.  Idempotent."""
        t_end = time.monotonic() + float(timeout)
        self.drain(timeout)
        self._stop = True
        self._work.set()
        t = self._thread
        joined = True
        if t is not None and t.is_alive():
            t.join(max(0.1, t_end - time.monotonic()))
            joined = not t.is_alive()
        with self._lock:
            self._closed = True
        self._flush_leftovers()
        return joined

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self._draining = True
        self._stop = True
        self._closed = True

    # -- introspection ---------------------------------------------------
    def slo_targets(self):
        """{lane: tightest relative deadline seconds among recent
        accepted deadlined requests}: the TTFT p99 targets of the
        default generation SLO rules."""
        with self._lock:
            return {lane: min(dq)
                    for lane, dq in self._lane_deadline_s.items() if dq}

    def slo_lane_quotas(self):
        cap = float(self._q.maxsize)
        return {lane: (1.0 if c is None else c / cap)
                for lane, c in self._lane_caps.items()}

    def install_slo_rules(self, **kw):
        """Register the default generation SLO rules (per-lane TTFT p99
        against the observed deadline targets, and shed burn rates).
        Returns the rule names."""
        from ..telemetry import slo as _slo
        return _slo.install_default_generation_rules(engine=self, **kw)

    def stats(self):
        with self._lock:
            tenants = dict(self._tenant_q)
        live = self._live()
        return {"counters": events.snapshot("gen."),
                "latency": events.latency_snapshot("gen."),
                "labeled": events.labeled_latency_snapshot("gen."),
                "slots": self._S, "max_len": self._L,
                "prompt_buckets": list(self._buckets),
                "slots_live": len(live),
                "queue_depth": self._q.qsize(),
                "lanes": {"order": list(self._lanes),
                          "depths": self._q.lane_depths(),
                          "caps": dict(self._lane_caps)},
                "tenants_queued": tenants,
                "continuous": self._continuous,
                "steps": self._steps,
                "warm": self._warm}
