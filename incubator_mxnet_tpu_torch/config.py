"""Typed config/flag registry of the PyTorch port.

The registry mechanics of incubator_mxnet_tpu/config.py, with only the
knobs this package reads.  Values resolve in order: process-local
override (`set`) → environment → registered default.  Use sites read
through `get` at call time, so environment changes made before first
use are honored.

The port has no attention dispatch switch: on a CUDA tensor attention
is the hand-written kernel, so none of the JAX package's Pallas knobs
(MXNET_USE_PALLAS, MXNET_FLASH_*) exist here."""
from __future__ import annotations

import os
import threading
import warnings
from typing import Any, Callable, Dict

__all__ = ["register", "get", "set", "unset", "list_vars",
           "serve_lane_quota_fractions"]

_LOCK = threading.Lock()
_REGISTRY: Dict[str, "_Var"] = {}
_OVERRIDES: Dict[str, str] = {}
_warned = set()


class _Var:
    __slots__ = ("name", "type", "default", "doc")

    def __init__(self, name, type_, default, doc):
        self.name = name
        self.type = type_
        self.default = default
        self.doc = doc


_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def _to_bool(s):
    v = str(s).lower()
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    raise ValueError("not a boolean: %r" % (s,))


def _conv(var):
    return _to_bool if var.type is bool else var.type


def register(name: str, type_: Callable = str, default: Any = None,
             doc: str = ""):
    """Register a knob.  Re-registration with an identical signature is a
    no-op; a conflicting one raises."""
    with _LOCK:
        old = _REGISTRY.get(name)
        if old is not None:
            if (old.type, old.default) != (type_, default):
                raise ValueError("config %s re-registered with a "
                                 "different signature" % name)
            return
        _REGISTRY[name] = _Var(name, type_, default, doc)


def _var(name):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError("unknown config knob %s (registered: %s)"
                       % (name, sorted(_REGISTRY))) from None


def get(name: str):
    """Typed read: override > environment > registered default.  A
    malformed environment value warns once and falls back to the default;
    `set()` overrides were validated eagerly."""
    var = _var(name)
    raw = _OVERRIDES.get(name, os.environ.get(name))
    if raw is None:
        return var.default
    try:
        return _conv(var)(raw)
    except (TypeError, ValueError) as e:
        if name not in _warned:
            _warned.add(name)
            warnings.warn("ignoring invalid %s=%r (%s); using default %r"
                          % (name, raw, e, var.default))
        return var.default


def set(name: str, value) -> None:     # noqa: A001 — parity naming
    """Process-local override (wins over the environment), validated
    eagerly."""
    var = _var(name)
    _conv(var)(str(value))
    _OVERRIDES[name] = str(value)


def unset(name: str) -> None:
    _OVERRIDES.pop(name, None)


def list_vars():
    return sorted(_REGISTRY)


def serve_lane_quota_fractions(spec, n_lanes):
    """Per-lane queue-occupancy quota fractions from a
    MXNET_SERVE_LANE_QUOTAS-style spec (a list/tuple of floats or a
    comma string; empty = the auto ladder 1.0, .75, .5, ... floored at
    .25; a short list repeats its last value)."""
    if spec and isinstance(spec, (list, tuple)):
        fracs = [float(s) for s in spec]
    elif spec:
        fracs = [float(s) for s in str(spec).split(",") if s.strip()]
    else:
        fracs = [max(0.25, 1.0 - 0.25 * i) for i in range(n_lanes)]
    if not fracs or any(f <= 0 for f in fracs):
        raise ValueError("lane quotas must be positive fractions, "
                         "got %r" % (spec,))
    while len(fracs) < int(n_lanes):
        fracs.append(fracs[-1])             # short list: last repeats
    return fracs[:int(n_lanes)]


register("MXNET_SERVE_MAX_BATCH", int, 32,
         "InferenceEngine (serving.engine): largest batch bucket — the "
         "dispatcher coalesces queued requests up to this many examples "
         "per forward")
register("MXNET_SERVE_MAX_WAIT_US", int, 2000,
         "InferenceEngine: microseconds the dispatcher waits for more "
         "requests to fill a bucket before dispatching a partial batch")
register("MXNET_SERVE_QUEUE_CAP", int, 256,
         "InferenceEngine: bounded request-queue capacity; submits "
         "beyond it are rejected with QueueFull")
register("MXNET_SERVE_BUCKETS", str, "",
         "InferenceEngine: comma-separated batch bucket sizes (e.g. "
         "'1,2,4,8'). Empty = powers of two up to MXNET_SERVE_MAX_BATCH. "
         "Every request batch is padded up to a bucket")
register("MXNET_BN_STABLE_VAR", bool, False,
         "BatchNorm batch statistics: 1 = shifted two-pass variance "
         "E[(x-mean)^2] (safe when |mean| >> std), 0 = one-pass "
         "E[x^2]-E[x]^2 clamped at 0 (one read of x; the statistics the "
         "fused 1x1-conv kernel produces, so only 0 fuses)")
register("MXNET_SERVE_LANES", str, "high,normal,low",
         "Priority lanes, highest first (comma-separated names).  "
         "Admission drains lanes in strict priority order, earliest-"
         "deadline-first within a lane; submits default to the first "
         "lane")
register("MXNET_SERVE_LANE_QUOTAS", str, "",
         "Per-lane queue-occupancy quotas as comma-separated fractions "
         "of MXNET_SERVE_QUEUE_CAP, positionally matching "
         "MXNET_SERVE_LANES (short lists repeat the last value). "
         "Empty = auto: 1.0 for the top lane, then 0.75, 0.5, ... "
         "floor 0.25.  A submit that would push its lane past quota "
         "is shed with the typed Shed error")
register("MXNET_SERVE_TENANT_QUOTA", int, 0,
         "Max queued requests per tenant (submit tenant=...); a submit "
         "beyond it is shed (Shed, gen.shed labeled by tenant). 0 = no "
         "per-tenant bound")
register("MXNET_SERVE_HBM_TEMP_FACTOR", float, 2.0,
         "Footprint projection (ModelRegistry, project_footprint, "
         "project_generation_footprint): multiplier on the largest "
         "bucket's input + output bytes (the decode step's logits for "
         "generation) to cover temporaries before a measured footprint "
         "replaces the projection")
register("MXNET_GEN_SLOTS", int, 4,
         "GenerationEngine (serving.generation): decode-batch slot "
         "count, the fixed sequence capacity of the one captured "
         "decode step.  Finished sequences free their slot at a step "
         "boundary and queued requests join at once")
register("MXNET_GEN_MAX_LEN", int, 64,
         "GenerationEngine: the per-slot K/V buffer length the decode "
         "step is captured at; bounds prompt length and emitted tokens "
         "per request.  Must not exceed the model's positional table")
register("MXNET_GEN_BUCKETS", str, "",
         "GenerationEngine: comma-separated prompt-length buckets (one "
         "captured prefill each; prompts pad up to a bucket).  Empty = "
         "powers of two from 8 up to MXNET_GEN_MAX_LEN.  After warmup() "
         "no prompt length captures again")
register("MXNET_FAULT_PLAN", str, "",
         "Deterministic fault-injection plan (fault.py): ';'-separated "
         "'site@step' / 'site#call' entries with optional xN repeat and "
         "~S stall seconds, e.g. 'serve.infer@3;serve.enqueue#2'. "
         "Empty = no faults. Armed via fault.reset_from_config()")
register("MXNET_IO_CORRUPT_BUDGET", int, 16,
         "Corrupt RecordIO records tolerated (quarantined: skipped, "
         "counted on io.decode.records_corrupt, ring-evented and "
         "appended to the io-quarantine JSONL) per epoch per "
         "reader/service before the epoch fails with "
         "CorruptRecordBudgetExceeded.  Negative = unlimited "
         "quarantine; 0 = the first corrupt record fails the epoch")
register("MXNET_IO_WORKER_RESTARTS", int, 2,
         "DecodeService: dead decode-worker respawns allowed per service "
         "(pool-wide).  A respawned worker resumes its (wid, epoch) "
         "shard slice at the first undelivered batch, bit for bit the "
         "stream of an uninterrupted run (per-record RNG).  Counted on "
         "io.decode.worker_restarts; past the budget a dead worker is a "
         "mid-epoch error.  0 disables respawn")
register("MXNET_IO_WORKERS", int, 0,
         "Multi-process decode service (io.decode_service): worker "
         "processes behind ImageRecordIter(workers=), decoding sharded "
         "RecordIO readers into a shared-memory slab ring.  0 = disabled "
         "(the native or threaded pipeline)")
register("MXNET_IO_RING_SLOTS", int, 0,
         "Decode-service shared-memory ring size in batch slabs (shared "
         "by all workers; each slab is one full batch).  0 = auto "
         "(2*workers + 2)")
register("MXNET_IO_MP_START", str, "fork",
         "Decode-service process start method.  'fork' is the fast "
         "default: a worker runs numpy, PIL and the recordio framing "
         "only and never calls torch, so forking a parent that holds a "
         "CUDA context is safe; 'spawn' and 'forkserver' pay a fresh "
         "interpreter and the package's import (torch) per worker")
register("MXNET_FEED_DEPTH", int, 2,
         "DeviceFeed (io.device_feed) prefetch depth: batches in flight "
         "between the background transfer thread and the consumer, and "
         "the number of pinned staging buffers (2 = double buffer)")
register("MXNET_FEED_ASYNC", bool, True,
         "DeviceFeed background transfer thread; 0 = synchronous read "
         "and copy in the consumer (debugging; same counters)")
register("MXNET_RETRY_MAX", int, 3,
         "Retry budget for transient failures (parallel.resilience."
         "retry_transient; exponential backoff between attempts)")
register("MXNET_RETRY_BACKOFF", float, 0.05,
         "Initial backoff seconds for retries (doubles per attempt, "
         "jittered; see MXNET_RETRY_BACKOFF_MS)")
register("MXNET_RETRY_BACKOFF_MS", float, 0.0,
         "Initial retry backoff in milliseconds; when > 0 it overrides "
         "MXNET_RETRY_BACKOFF.  Each attempt doubles the window and "
         "sleeps a uniform-jittered interval in [window/2, window]")
register("MXNET_TELEMETRY", bool, False,
         "Telemetry spans (telemetry/spans.py) on the profiler's trace "
         "sink and the flight recorder's ring.  Off = every span is a "
         "single bool read; the monitor.events counters are always on")
register("MXNET_BLACKBOX", bool, True,
         "Flight recorder (telemetry/flightrec.py): always-on bounded "
         "event ring and black-box JSON dumps on uncaught exceptions, "
         "SIGUSR2 and engine faults.  0 reduces every hook to a single "
         "bool read")
register("MXNET_BLACKBOX_RING", int, 4096,
         "Flight-recorder ring capacity (events retained for the "
         "last-N timeline a black-box dump embeds)")
register("MXNET_BLACKBOX_DIR", str, "",
         "Directory for black-box dumps (auto-named "
         "blackbox-<ts>-p<pid>-<seq>-<reason>.json). Empty = the "
         "system temp directory")
register("MXNET_REQTRACE", bool, True,
         "Per-request lifecycle journal (telemetry/reqtrace.py): every "
         "generation request gets a phase-stamped record; tail outliers "
         "and terminal failures are promoted to exemplars")
register("MXNET_REQTRACE_RING", int, 512,
         "Per-engine request-journal ring size (retired records kept "
         "for snapshots)")
register("MXNET_REQTRACE_WINDOW", int, 256,
         "Per-lane rolling window of completed-request e2e samples the "
         "promotion threshold (p99) is computed over.  Promotion needs "
         "at least 20 samples in the lane window first")
register("MXNET_REQTRACE_EXEMPLARS", int, 32,
         "Promoted exemplars retained per engine journal (the "
         "process-wide set keeps the newest 64)")
register("MXNET_REQTRACE_PIN_P99_US", float, 0.0,
         "When > 0, replaces the rolling per-lane p99 promotion "
         "threshold with this fixed e2e value in us (deterministic "
         "promotion for tests). 0 = rolling threshold")
register("MXNET_SERVE_HBM_BUDGET", int, 0,
         "ModelRegistry: per-device memory budget in bytes for serving "
         "admission control. 0 = auto (the card's total memory from "
         "torch.cuda.mem_get_info, else unbudgeted); a model whose "
         "projected footprint does not fit the budget on enough "
         "devices is refused with AdmissionDenied")
register("MXNET_SERVE_BREAKER_FAILS", int, 5,
         "ModelRegistry circuit breaker: consecutive terminal request "
         "failures on ONE model backend before its breaker OPENS "
         "(submits fail fast with CircuitOpen)")
register("MXNET_SERVE_BREAKER_COOLDOWN_S", float, 10.0,
         "ModelRegistry circuit breaker: seconds an OPEN breaker "
         "rejects before letting ONE probe request through "
         "(half-open); probe success re-closes it, failure restarts "
         "the cooldown")
register("MXNET_SERVE_REPLICA_FAILS", int, 3,
         "InferenceEngine: consecutive terminal dispatch failures on "
         "ONE replica before it is marked unhealthy and routed around "
         "(serve.replica_unhealthy); a healthy dispatch resets the "
         "streak")
register("MXNET_SERVE_REPLICA_COOLDOWN_S", float, 5.0,
         "InferenceEngine: seconds an unhealthy replica is skipped by "
         "the round-robin before ONE probe batch is routed back to it "
         "(success re-admits it, failure restarts the cooldown)")
register("MXNET_SERVE_BUILD_TIMEOUT_S", float, 120.0,
         "Bounded engine-build timeout for ModelRegistry.register / "
         "register_version / resize: a build that wedges past this "
         "raises RegistrationTimeout and rolls the ledger hold back.  "
         "0 disables the bound")
register("MXNET_CTL_CANARY_FRACTION", float, 0.1,
         "Initial traffic fraction mirrored to a freshly-admitted "
         "canary version (ModelRegistry.register_version)")
register("MXNET_CTL_DEGRADE_S", float, 0.05,
         "Per-batch stall applied to an engine tainted by the "
         "model.bad_version fault site (outputs are also sign-flipped)")
register("MXNET_TELEMETRY_EXPORT_PATH", str, "",
         "MetricsExporter periodic-file path ('.prom'/'.txt' = "
         "Prometheus text, else JSON). Empty = no file export")
register("MXNET_TELEMETRY_EXPORT_S", float, 15.0,
         "Seconds between periodic telemetry file exports")
register("MXNET_STRAGGLER_SIGMA", float, 4.0,
         "Robust-sigma multiplier of the SLO anomaly rules: a live "
         "value above median + max(sigma*1.4826*MAD, 0.5*median) of "
         "its history baseline fires")
register("MXNET_HISTORY_DIR", str, "",
         "Durable telemetry history (telemetry/history.py): directory "
         "of the per-process append-only shard files "
         "(history-<ts>-p<pid>.jsonl).  Empty = history off")
register("MXNET_HISTORY_SHARD_KB", int, 4096,
         "Size cap in KB per history shard file; a shard past the cap "
         "is compacted in place (newest half kept, older half "
         "downsampled 2:1)")
register("MXNET_SLO_FAST_S", float, 60.0,
         "SLO burn-rate FAST window in seconds (telemetry/slo.py)")
register("MXNET_SLO_SLOW_S", float, 300.0,
         "SLO burn-rate SLOW window in seconds")
register("MXNET_SLO_SHED_BUDGET", float, 0.02,
         "Default serving error budget: the allowed shed fraction of "
         "the TOP lane's burn-rate rule; lower lanes budget max(this, "
         "1 - lane quota)")
register("MXNET_MEMWATCH", bool, True,
         "Sampled per-device memory observatory (telemetry/"
         "memwatch.py): torch.cuda.memory_stats per card, tenant "
         "attribution against the serving ledger, per-phase peak "
         "watermarks.  Sampling rides the exporter tick and "
         "warmup/deploy transitions, never a request path")
register("MXNET_MEMWATCH_MIN_S", float, 0.25,
         "Probe throttle: an unforced memwatch.sample() within this "
         "many seconds of the previous sample returns it unchanged; "
         "0 disables the throttle")
register("MXNET_MEMWATCH_RING", int, 128,
         "Bounded ring of retained memwatch samples")
register("MXNET_MEMWATCH_DRIFT_FACTOR", float, 1.5,
         "slo.MemDriftRule threshold: a tenant whose measured bytes "
         "contradict its ledger commitment by more than this factor "
         "(either direction) fires and re-reconciles the ledger row")
register("MXNET_MEMWATCH_FRESH_S", float, 30.0,
         "Maximum age in seconds for a memwatch sample to count as "
         "fresh (registry stats() measured columns, the drift rule)")
register("MXNET_MEMWATCH_TOP", int, 5,
         "Top-N consumers carried on a firing mem-drift alert and the "
         "memwatch block")
register("MXNET_KVSTORE_BARRIER_TIMEOUT", float, 300.0,
         "DistKVStore barrier timeout in seconds: a worker stuck at a "
         "barrier raises an error naming its rank instead of hanging "
         "(0 = wait indefinitely)")
register("MXNET_ZERO_LEVEL", int, 0,
         "Default ZeRO stage of parallel.ShardedTrainer(zero=None): 0 "
         "replicated, 1 optimizer state sharded, 2 + gradients "
         "reduce-scattered in buckets and the update on shards, 3 + "
         "parameters stored sharded (parallel/zero.py)")
register("MXNET_ZERO_BUCKET_MB", float, 0.0,
         "Bucket cap in MB of the ZeRO-2/3 concat buckets; 0 = auto, "
         "1/32 of the parameter bytes clamped to [1, 16] MB")
register("MXNET_ZERO_SOLO_KB", int, 256,
         "Parameter size in KB from which a parameter with a "
         "data-divisible axis is reduce-scattered on its own instead of "
         "joining a concat bucket")
register("MXNET_ZERO_OVERLAP", str, "auto",
         "ZeRO-2/3 collective schedule: 'trail' or 'auto' (both: every "
         "collective after the backward, recorded in the plan); 'bwd' "
         "is not ported and raises")
register("MXNET_DISPATCH_THREADS", int, -1,
         "ShardedTrainer per-replica threads (parallel/dispatch.py): -1 "
         "= one per replica (at most 8), 0 = none (replicas run in turn "
         "and cannot reduce inside a forward), N = exactly N")
register("MXNET_AMP_DTYPE", str, "",
         "parallel.ShardedTrainer(amp=None): the mixed-precision compute "
         "dtype, 'bfloat16' or 'float16' (contrib.amp's cast policy), "
         "empty = off")
