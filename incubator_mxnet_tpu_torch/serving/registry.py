"""Multi-model serving registry of the PyTorch port, with memory
admission control and per-model circuit breakers (counterpart of
incubator_mxnet_tpu/serving/registry.py).

**Admission control.**  Each registry device carries a budget
(`MXNET_SERVE_HBM_BUDGET` or ``hbm_budget=``, else the card's total
memory from ``torch.cuda.mem_get_info``; a CPU device reports none and
is unbudgeted) and a committed-bytes ledger.  A model asks for
`replicas` devices; admission judges a fresh **projection** of the block
in hand: parameter bytes (one full replica per device, the engine's own
copy) + `MXNET_SERVE_HBM_TEMP_FACTOR` x the largest bucket's input and
output bytes, the output shapes from a run on the meta device
(`torch.func.functional_call` over meta copies of the parameters: no
memory, no kernel).  **Measured** bytes replace the projection through
``warmup()``→``reconcile()``: the `telemetry.costs` rows that the
engine's captured programs filed (label ``serve.infer:<name>``; the
parameter copy, static inputs and graph-pool growth of each replica).

Placement is best-fit decreasing: the `replicas` devices with the most
free budget take the model.  If the k-th best device cannot fit it,
registration fails with the typed `AdmissionDenied` naming the decision
(per-device free bytes against the footprint, and a generator's KV
term), a ``serve.admission_rejected`` counter and a flight-recorder
event, before anything is allocated for it.

**Circuit breaker.**  `MXNET_SERVE_BREAKER_FAILS` consecutive terminal
request failures (flow-control sheds and deadline expiries are neutral)
open a model's breaker: submits fail fast with `CircuitOpen`.  After
`MXNET_SERVE_BREAKER_COOLDOWN_S` one probe request is let through; its
success closes the breaker, its failure restarts the cooldown.

**Versions.**  `register_version` admits a canary beside the primary
and mirrors a deterministic fraction of its traffic to it;
`promote_version` swaps the canary's weights into the primary's captured
programs in place (`InferenceEngine.refresh_params_from`);
`rollback_version` drops the canary.

Not ported: `register_quantized` (quantization is a later slice).

Typical lifecycle::

    reg = serving.ModelRegistry(devices=[mx.gpu(0)])
    reg.register("ranker", ranker_net, example_shape=(256,),
                 wire_dtype="float32")
    reg.warmup("ranker")                      # capture + reconcile
    fut = reg.submit("ranker", x, lane="high", tenant="acme",
                     deadline=0.05)
    ...
    reg.unregister("ranker")                  # close + release budget
"""
from __future__ import annotations

import threading
import time
import weakref

import numpy as np
import torch

from .. import config as _cfg
from .. import fault
from ..base import MXNetError
from ..context import resolve_device
from ..monitor import events
from ..ops import attention as _attention
from ..telemetry import costs as _costs
from ..telemetry import flightrec as _bb
from ..telemetry import memwatch as _mw
from .engine import (InferenceEngine, QueueFull, DeadlineExceeded,
                     EngineClosed, Shed, _meta_call, _model_scope,
                     param_bytes as _param_bytes)

__all__ = ["ModelRegistry", "AdmissionDenied", "CircuitOpen",
           "UnknownModel", "RegistrationTimeout", "project_footprint",
           "live_registries"]

#: every live registry, weakly — the memwatch attribution join and
#: the mem-drift reconcile walk these (the controlplane's
#: _SUPERVISORS pattern)
_REGISTRIES = weakref.WeakSet()


def live_registries():
    """The live ModelRegistry instances (weak — closed/collected
    registries drop out)."""
    return [r for r in list(_REGISTRIES) if not r._closed]


class AdmissionDenied(MXNetError):
    """The model's projected HBM footprint does not fit the remaining
    per-device budget on enough devices — refused at REGISTRATION time
    (a ledger check), not discovered as an allocator OOM at traffic
    time."""


class RegistrationTimeout(MXNetError):
    """The engine build (param replication + functionalization) did
    not complete within the bounded build timeout
    (MXNET_SERVE_BUILD_TIMEOUT_S / ``build_timeout=``): the ledger
    hold was rolled back and the name released, so the deploy path is
    free to retry — a wedged build must not hold it hostage.  If
    the abandoned build eventually completes, its engine is closed in
    the background (never leaked)."""


class CircuitOpen(MXNetError):
    """The model's backend circuit breaker is open: its recent
    dispatches failed terminally, so submits fail fast instead of
    queueing onto a dead backend.  Retry after the cooldown (a probe
    re-closes the breaker once the backend recovers)."""


class UnknownModel(MXNetError):
    """submit()/warmup()/unregister() for a name that was never
    registered (or was already unregistered)."""


#: flow-control errors are NEUTRAL for the breaker: they mean the
#: engine is protecting itself, not that the backend is broken
_FLOW_ERRORS = (Shed, QueueFull, DeadlineExceeded, EngineClosed,
                CircuitOpen)


def project_footprint(block, buckets, example_shape, wire_dtype,
                      temp_factor=None):
    """Projected per-device bytes for serving `block` with the given
    bucket set: parameter bytes + temp_factor x (input + output bytes of
    the largest bucket).  The outputs come from a run on the meta device
    (the block's tensors swapped for meta copies): no memory, no kernel,
    so admission stays cheap.  Returns (bytes, detail dict)."""
    if temp_factor is None:
        temp_factor = float(_cfg.get("MXNET_SERVE_HBM_TEMP_FACTOR"))
    pb = _param_bytes(block)
    largest = int(max(buckets))
    dt = np.dtype(wire_dtype or "float32")
    in_bytes = largest * int(np.prod(example_shape)) * dt.itemsize
    out_bytes = 0
    try:
        x = torch.zeros((largest,) + tuple(example_shape), device="meta",
                        dtype=torch.from_numpy(np.zeros(0, dt)).dtype)
        with _model_scope(), _attention.shapes_only():
            out = _meta_call(block, "forward", (x,))
        from torch.utils._pytree import tree_flatten
        out_bytes = sum(t.numel() * t.element_size()
                        for t in tree_flatten(out)[0]
                        if isinstance(t, torch.Tensor))
    except Exception:           # noqa: BLE001 — projection degrades to
        pass                    # the input-side estimate, never raises
    total = int(pb + temp_factor * (in_bytes + out_bytes))
    return total, {"param_bytes": int(pb), "input_bytes": int(in_bytes),
                   "output_bytes": int(out_bytes),
                   "temp_factor": float(temp_factor),
                   "bucket": largest}


class _Breaker:
    """Whole-model circuit breaker (closed → open → half-open).  State
    transitions are lock-guarded; `allow()` is the submit-time gate."""

    def __init__(self, model, max_fails, cooldown_s):
        self.model = model
        self.max_fails = int(max_fails)
        self.cooldown = float(cooldown_s)
        self._lock = threading.Lock()
        self.state = "closed"
        self.streak = 0
        self.open_until = 0.0

    def allow(self):
        """True when a submit may proceed.  An open breaker whose
        cooldown elapsed admits exactly ONE probe (the window re-arms
        immediately, so a burst cannot pile onto an unproven
        backend)."""
        with self._lock:
            if self.state == "closed":
                return True
            now = time.monotonic()
            if now < self.open_until:
                return False
            # half-open: one probe through, window re-armed
            self.open_until = now + self.cooldown
            events.incr("serve.breaker_probes")
            return True

    def ok(self):
        with self._lock:
            self.streak = 0
            reopened = self.state != "closed"
            self.state = "closed"
            self.open_until = 0.0
        if reopened:
            events.incr("serve.breaker_closed")
            _bb.record("serve", "breaker_closed", model=self.model)

    def fail(self, exc=None):
        with self._lock:
            self.streak += 1
            tripped = (self.streak >= self.max_fails
                       or self.state == "open")
            newly = tripped and self.state == "closed"
            if tripped:
                self.state = "open"
                self.open_until = time.monotonic() + self.cooldown
            streak = self.streak
        if newly:
            events.incr("serve.breaker_opened")
            _bb.record("serve", "breaker_open", model=self.model,
                       consecutive_fails=int(streak),
                       error=type(exc).__name__ if exc else None,
                       cooldown_s=self.cooldown)
            import logging
            logging.getLogger(__name__).warning(
                "serving backend %r circuit OPEN after %d consecutive "
                "failures (%s); failing fast for %.1fs", self.model,
                streak, type(exc).__name__ if exc else "?",
                self.cooldown)


class _Entry:
    __slots__ = ("name", "engine", "breaker", "footprint", "basis",
                 "devices", "detail", "cost_labels", "version",
                 "canary", "spawn")

    def __init__(self, name, engine, breaker, footprint, basis,
                 devices, detail, cost_labels=None, version=None,
                 spawn=None):
        self.name = name
        self.engine = engine
        self.breaker = breaker
        self.footprint = footprint
        self.basis = basis          # "measured" | "projected"
        self.devices = devices      # indices into the registry pool
        self.detail = detail
        # cost-registry label families this entry's measured footprint
        # is read from (``serve.infer:<name>`` for one-shot engines,
        # ``serve.infer:<name>:gen`` for generation engines)
        self.cost_labels = cost_labels or ["serve.infer:%s" % name]
        self.version = version      # serving version tag
        # in-flight canary route: {"name", "version", "fraction",
        # "acc"} — the deterministic traffic-mirroring state
        self.canary = None
        # registration kwargs, so resize / register_version can
        # rebuild an engine with the same signature without the
        # caller re-supplying it
        self.spawn = spawn or {}


class ModelRegistry:
    """N `InferenceEngine`s behind one admission-controlled surface.

    devices: the serving pool (default: `cuda:0`).  Every model replica
        occupies one pool device and commits its footprint to that
        device's ledger.
    hbm_budget: per-device budget in bytes (default
        MXNET_SERVE_HBM_BUDGET; 0 = the card's total memory, else
        unbudgeted — admission always runs, the ledger is always kept,
        but nothing is refused without a budget to refuse against).
    """

    def __init__(self, devices=None, hbm_budget=None):
        if devices is None:
            devices = [None]
        self._devices = [resolve_device(d) for d in devices]
        budget = int(hbm_budget if hbm_budget is not None
                     else _cfg.get("MXNET_SERVE_HBM_BUDGET"))
        self._budgets = [self._device_budget(c, budget)
                         for c in self._devices]
        self._committed = [0] * len(self._devices)
        self._lock = threading.Lock()
        self._models = {}           # name -> _Entry
        self._closed = False
        _bb.install_crash_hooks()
        _REGISTRIES.add(self)

    @staticmethod
    def _device_budget(device, budget):
        if budget > 0:
            return budget
        try:
            from ..storage import memory_info
            _, limit = memory_info(device)
            return int(limit or 0)
        except Exception:           # noqa: BLE001 — a CPU device
            return 0                # reports no limit

    # -- admission -----------------------------------------------------
    def _place(self, name, footprint, replicas, kv_detail=None):
        """Best-fit decreasing bin-pack: the `replicas` pool devices
        with the most free budget take the model.  Returns the chosen
        indices, or raises AdmissionDenied with the full decision.
        `kv_detail` (generation admission) breaks the footprint's
        slots×kv term out so the refusal NAMES it — KV cache is the
        part that scales with concurrency, not the deploy.  Caller
        holds self._lock."""
        free = [(self._budgets[i] - self._committed[i]
                 if self._budgets[i] > 0 else float("inf"), i)
                for i in range(len(self._devices))]
        free.sort(key=lambda t: (-t[0], t[1]))
        if replicas > len(self._devices):
            raise AdmissionDenied(
                "model %r wants %d replicas but the pool has %d "
                "devices" % (name, replicas, len(self._devices)))
        chosen = free[:replicas]
        worst_free, _ = chosen[-1]
        if worst_free < footprint:
            decision = [
                {"device": str(self._devices[i]),
                 "budget": self._budgets[i],
                 "committed": self._committed[i],
                 "free": (self._budgets[i] - self._committed[i]
                          if self._budgets[i] > 0 else None)}
                for i in range(len(self._devices))]
            events.incr("serve.admission_rejected")
            events.incr("serve.admission_rejected",
                        labels={"model": name})
            # the refusal is a flight-recorder event NAMING the model
            # and the bin-packing decision (the acceptance contract) —
            # a later blackbox dump explains why the deploy bounced
            _bb.record("serve", "admission_rejected", model=name,
                       projected_bytes=int(footprint),
                       replicas=int(replicas),
                       kv_detail=kv_detail,
                       decision=decision)
            kv_term = ""
            if kv_detail:
                kv_term = (" — of which KV cache %d bytes (%d slots x "
                           "%d bytes/slot; fewer slots or a smaller "
                           "max_len shrink the KV term, the model "
                           "itself is only %d bytes)"
                           % (kv_detail.get("kv_bytes", 0),
                              kv_detail.get("slots", 0),
                              kv_detail.get("kv_bytes_per_slot", 0),
                              kv_detail.get("param_bytes", 0)))
            raise AdmissionDenied(
                "model %r projected footprint %d bytes does not fit "
                "the remaining budget on %d device(s): %s%s"
                % (name, footprint, replicas,
                   ", ".join("%s free=%s" % (d["device"], d["free"])
                             for d in decision), kv_term))
        return [i for _, i in chosen]

    def _build_engine(self, name, ctor, build_timeout):
        """Run the engine constructor in a worker bounded by
        `build_timeout` seconds (MXNET_SERVE_BUILD_TIMEOUT_S when
        None; <= 0 = unbounded).  A build that wedges (hung capture,
        stalled param replication) raises the typed
        `RegistrationTimeout` instead of holding the deploy path
        hostage; the abandoned worker closes its engine if it ever
        finishes, so nothing leaks.  The `serve.build` fault site
        stalls inside the worker — the deterministic wedge the
        regression test arms."""
        if build_timeout is None:
            build_timeout = float(
                _cfg.get("MXNET_SERVE_BUILD_TIMEOUT_S"))
        if build_timeout <= 0:
            fault.maybe_slow("serve.build")
            try:
                return ctor()
            except Exception as e:
                # an allocator OOM during the build IS the forensic
                # moment: dump who was resident before unwinding
                _mw.guard_oom("serve.build", e)
                raise
        box = {"engine": None, "exc": None, "abandoned": False}
        done = threading.Event()
        claim = threading.Lock()

        def build():
            try:
                fault.maybe_slow("serve.build")
                eng = ctor()
            except BaseException as e:      # noqa: BLE001 — reraised
                box["exc"] = e              # on the caller's thread
            else:
                with claim:                 # exactly one side owns the
                    orphan = box["abandoned"]   # engine: the caller
                    if not orphan:          # (returned) or the build thread
                        box["engine"] = eng     # (closes the orphan)
                if orphan:
                    try:                    # too late: caller already
                        eng.close(1.0)      # rolled the ledger back
                    except Exception:       # noqa: BLE001
                        pass
            done.set()

        t = threading.Thread(target=build, daemon=True,
                             name="ServeBuild-%s" % name)
        t.start()
        if not done.wait(build_timeout):
            with claim:
                timed_out = box["engine"] is None
                box["abandoned"] = timed_out
            if timed_out:
                events.incr("serve.registration_timeout")
                events.incr("serve.registration_timeout",
                            labels={"model": name})
                _bb.record("serve", "registration_timeout",
                           model=name, timeout_s=float(build_timeout))
                raise RegistrationTimeout(
                    "engine build for model %r did not complete "
                    "within %.1fs (MXNET_SERVE_BUILD_TIMEOUT_S / "
                    "build_timeout=); ledger hold rolled back — "
                    "retry or raise the bound" % (name, build_timeout))
        if box["exc"] is not None:
            _mw.guard_oom("serve.build", box["exc"])
            raise box["exc"]
        return box["engine"]

    def register(self, name, block, replicas=1, example_shape=None,
                 wire_dtype=None, buckets=None, max_batch=None,
                 build_timeout=None, **engine_kw):
        """Admit `block` as model `name` on `replicas` pool devices.

        The per-device footprint comes from the cost registry when
        measured rows exist for this model (a known re-deploy), else
        from `project_footprint` — both checked against the device
        budgets BEFORE any program is captured.  Raises AdmissionDenied
        (with a flight-recorder event) on refusal; returns the
        admission record on success."""
        name = str(name)
        max_batch = int(max_batch if max_batch is not None
                        else _cfg.get("MXNET_SERVE_MAX_BATCH"))
        from .engine import _parse_buckets
        bset = _parse_buckets(
            buckets if buckets is not None
            else _cfg.get("MXNET_SERVE_BUCKETS"), max_batch)
        label = "serve.infer:%s" % name
        # admission always starts from a fresh PROJECTION of the block
        # in hand: the cost registry is process-wide and keeps rows
        # across unregister, so trusting a pre-existing
        # 'serve.infer:<name>' row here would admit a RE-registered
        # name at its previous incarnation's footprint.  Measured
        # reality flows into the ledger through warmup()→reconcile(),
        # which reads the rows THIS engine's programs just filed.
        if example_shape is not None:
            footprint, detail = project_footprint(
                block, bset, example_shape, wire_dtype)
            basis = "projected"
        else:
            # no signature yet (deferred first-request engines): only
            # the parameter side is projectable
            try:
                footprint = _param_bytes(block)
            except Exception:       # noqa: BLE001 — deferred params
                footprint = 0
            basis, detail = "projected", {"source": "params_only"}
        with self._lock:
            if self._closed:
                raise EngineClosed("registry is closed")
            if name in self._models:
                raise ValueError("model %r already registered "
                                 "(unregister it first)" % name)
            idxs = self._place(name, footprint, int(replicas))
            for i in idxs:
                self._committed[i] += footprint
            # hold the name while the engine builds OUTSIDE the lock
            # (construction replicates params onto devices — slow)
            self._models[name] = None
        try:
            # deploys watermark under their own memwatch phase: param
            # replication is the residency step change the steady
            # envelope must not absorb
            with _mw.phase("deploy"):
                engine = self._build_engine(
                    name,
                    lambda: InferenceEngine(
                        block, devices=[self._devices[i] for i in idxs],
                        buckets=bset, max_batch=max_batch,
                        example_shape=example_shape,
                        wire_dtype=wire_dtype,
                        cost_label=label, **engine_kw),
                    build_timeout)
        except Exception:
            with self._lock:    # roll the admission back — a failed
                for i in idxs:  # (or timed-out) build must not leak
                    self._committed[i] = max(    # committed budget
                        0, self._committed[i] - footprint)
                self._models.pop(name, None)
            raise
        entry = _Entry(
            name, engine,
            _Breaker(name, _cfg.get("MXNET_SERVE_BREAKER_FAILS"),
                     _cfg.get("MXNET_SERVE_BREAKER_COOLDOWN_S")),
            footprint, basis, idxs, detail,
            version=engine_kw.get("version"),
            spawn=dict(engine_kw, replicas=int(replicas),
                       example_shape=example_shape,
                       wire_dtype=wire_dtype, buckets=list(bset),
                       max_batch=max_batch))
        with self._lock:
            if self._closed:
                closed = True       # a close() raced the engine build:
            else:                   # don't resurrect a closed registry
                closed = False
                self._models[name] = entry
        if closed:
            engine.close()
            raise EngineClosed("registry closed during registration "
                               "of model %r" % name)
        events.incr("serve.models_admitted")
        _bb.record("serve", "admitted", model=name,
                   footprint_bytes=int(footprint), basis=basis,
                   devices=[str(self._devices[i]) for i in idxs])
        return {"model": name, "footprint_bytes": int(footprint),
                "basis": basis, "detail": detail,
                "devices": [str(self._devices[i]) for i in idxs]}

    def register_quantized(self, name, block, calib_data=None,
                           calib_mode=None, num_calib_batches=None,
                           exclude_layers=None, **register_kw):
        """Post-training-quantize `block` and admit it: not yet ported
        (quantization is a later slice of the port)."""
        raise NotImplementedError(
            "ModelRegistry.register_quantized (serving/quantize.py) is "
            "not yet ported")

    def register_generator(self, name, block, bos, eos, slots=None,
                           max_len=None, prompt_buckets=None,
                           **engine_kw):
        """Admit `block` as GENERATION model `name` on one pool device
        (a `serving.generation.GenerationEngine`).

        Admission accounts what one-shot serving has no analogue for:
        the KV term — ``slots × kv_bytes_per_slot`` from
        `project_generation_footprint` (HBM scales with CONCURRENT
        SEQUENCES, not just params).  A refusal names that term in
        both the AdmissionDenied message and the flight-recorder
        ledger.  ``warmup(name)`` reconciles the projection against
        the measured rows of its programs (``serve.infer:<name>:gen``:
        the parameters and the full slot cache once, plus each
        program's pool growth)."""
        from .generation import (GenerationEngine,
                                 project_generation_footprint,
                                 _parse_prompt_buckets)
        name = str(name)
        slots = int(slots if slots is not None
                    else _cfg.get("MXNET_GEN_SLOTS"))
        max_len = int(max_len if max_len is not None
                      else _cfg.get("MXNET_GEN_MAX_LEN"))
        bset = _parse_prompt_buckets(
            prompt_buckets if prompt_buckets is not None
            else _cfg.get("MXNET_GEN_BUCKETS"), max_len)
        label = "serve.infer:%s" % name
        footprint, detail = project_generation_footprint(
            block, slots, max_len, bset)
        with self._lock:
            if self._closed:
                raise EngineClosed("registry is closed")
            if name in self._models:
                raise ValueError("model %r already registered "
                                 "(unregister it first)" % name)
            idxs = self._place(name, footprint, 1, kv_detail=detail)
            for i in idxs:
                self._committed[i] += footprint
            self._models[name] = None       # hold the name (build
        try:                                # outside the lock)
            engine = GenerationEngine(
                block, bos, eos, ctx=self._devices[idxs[0]], slots=slots,
                max_len=max_len, prompt_buckets=bset,
                cost_label=label, **engine_kw)
        except Exception:
            with self._lock:
                for i in idxs:
                    self._committed[i] = max(
                        0, self._committed[i] - footprint)
                self._models.pop(name, None)
            raise
        entry = _Entry(
            name, engine,
            _Breaker(name, _cfg.get("MXNET_SERVE_BREAKER_FAILS"),
                     _cfg.get("MXNET_SERVE_BREAKER_COOLDOWN_S")),
            footprint, "projected", idxs, detail,
            cost_labels=[label + ":gen"])
        with self._lock:
            if self._closed:
                closed = True
            else:
                closed = False
                self._models[name] = entry
        if closed:
            engine.close()
            raise EngineClosed("registry closed during registration "
                               "of model %r" % name)
        events.incr("serve.models_admitted")
        _bb.record("serve", "admitted", model=name,
                   footprint_bytes=int(footprint), basis="projected",
                   kv_detail=detail,
                   devices=[str(self._devices[i]) for i in idxs])
        return {"model": name, "footprint_bytes": int(footprint),
                "basis": "projected", "detail": detail,
                "devices": [str(self._devices[i]) for i in idxs]}

    def generate(self, name, prompt, max_new_tokens=None,
                 deadline=None, lane=None, tenant=None):
        """Route one generation request through model `name`'s
        circuit breaker (the same `_route` triage as one-shot
        submits).  Returns the `GenerationStream`; terminal
        infrastructure failures on its future feed the breaker."""
        entry = self._entry(name)
        return self._route(entry, entry.engine.submit, prompt,
                           max_new_tokens=max_new_tokens,
                           deadline=deadline, lane=lane,
                           tenant=tenant)

    def unregister(self, name, timeout=30.0):
        """Close the model's engine (drain + resolve every future) and
        release its committed budget."""
        with self._lock:
            entry = self._models.get(str(name))
            if entry is None:           # absent or mid-register
                raise UnknownModel("model %r is not registered"
                                   % (name,))
            del self._models[str(name)]
            for i in entry.devices:
                self._committed[i] = max(
                    0, self._committed[i] - entry.footprint)
            # instant traffic revert: any primary mirroring traffic to
            # this name stops NOW, not at its next rollback bookkeeping
            for e in self._models.values():
                if e is not None and e.canary \
                        and e.canary.get("name") == str(name):
                    e.canary = None
        entry.engine.close(timeout)
        # drop the model's cost rows with it: a later re-registration
        # under the same name must not read THIS incarnation's
        # footprint (register projects fresh; warmup re-measures)
        for fam in entry.cost_labels:
            _costs.drop_rows(fam, kind="serve")
        events.incr("serve.models_evicted")
        _bb.record("serve", "evicted", model=entry.name,
                   released_bytes=int(entry.footprint))

    # -- elastic resize -------------------------------------
    def resize(self, name, replicas, force=False, timeout=30.0,
               build_timeout=None):
        """Grow/shrink model `name` to `replicas` pool devices —
        make-before-break: the NEW replica set is admitted (bin-packed
        + committed) while the old one still serves, the new engine is
        built and warmed, traffic swaps atomically, and only then is
        the old engine closed and its commitment released.  The
        temporary double-count is the safe direction — admission may
        transiently refuse OTHER deploys, never oversubscribe HBM.
        `force=True` rebuilds even at the same replica count (the
        supervisor's all-replicas-unhealthy fallback).  Raises
        AdmissionDenied when the new set does not fit; the old engine
        keeps serving untouched."""
        entry = self._entry(name)
        if not isinstance(entry.engine, InferenceEngine):
            raise ValueError(
                "resize() supports one-shot InferenceEngine models "
                "only (generation engines are single-device)")
        replicas = int(replicas)
        if replicas < 1:
            raise ValueError("replicas must be >= 1, got %d"
                             % replicas)
        if replicas == len(entry.devices) and not force:
            return {"model": entry.name, "replicas": replicas,
                    "resized": False}
        with self._lock:
            if self._closed:
                raise EngineClosed("registry is closed")
            idxs = self._place(entry.name, entry.footprint, replicas)
            for i in idxs:
                self._committed[i] += entry.footprint
        old_engine = entry.engine
        spawn = {k: v for k, v in entry.spawn.items()
                 if k not in ("replicas", "version")}
        example_shape = spawn.pop("example_shape", None)
        wire_dtype = spawn.pop("wire_dtype", None)
        bset = spawn.pop("buckets", None)
        max_batch = spawn.pop("max_batch", None)
        label = "serve.infer:%s" % entry.name

        def ctor():
            eng = InferenceEngine(
                old_engine._block,
                devices=[self._devices[i] for i in idxs],
                buckets=bset, max_batch=max_batch,
                example_shape=example_shape, wire_dtype=wire_dtype,
                cost_label=label, version=entry.version, **spawn)
            if old_engine._param_src is not None:
                # the primary was promoted since registration: new
                # replicas must serve the promoted weights, not the
                # original block's
                eng.refresh_params_from(old_engine._param_src)
            return eng

        engine = None
        try:
            engine = self._build_engine(entry.name, ctor,
                                        build_timeout)
            if example_shape is not None:
                engine.warmup()     # new replicas capture BEFORE the
                                    # swap — traffic never pays it
        except Exception:
            with self._lock:        # release the NEW commitment; the
                for i in idxs:      # old set never stopped serving
                    self._committed[i] = max(
                        0, self._committed[i] - entry.footprint)
            if engine is not None:
                try:
                    engine.close(1.0)
                except Exception:   # noqa: BLE001
                    pass
            raise
        with self._lock:
            old_devices, entry.devices = entry.devices, idxs
            entry.engine = engine
            for i in old_devices:
                self._committed[i] = max(
                    0, self._committed[i] - entry.footprint)
        old_engine.close(timeout)
        events.incr("serve.resized")
        events.incr("serve.resized", labels={"model": entry.name})
        _bb.record("serve", "resized", model=entry.name,
                   replicas=replicas, from_replicas=len(old_devices),
                   forced=bool(force),
                   devices=[str(self._devices[i]) for i in idxs])
        return {"model": entry.name, "replicas": replicas,
                "resized": True,
                "devices": [str(self._devices[i]) for i in idxs]}

    # -- versioned deploys ----------------------------------
    def register_version(self, name, block, version, fraction=None,
                         warmup=True, **register_kw):
        """Admit `block` as version `version` of model `name`
        ALONGSIDE the serving one, under the same admission ledger
        (entry name ``<name>@<version>``, own engine/breaker/ledger
        hold), and start mirroring a deterministic `fraction` of the
        primary's traffic to it (default
        MXNET_CTL_CANARY_FRACTION).  Engine signature defaults come
        from the primary's registration, so the canary serves the
        same wire contract without re-specifying it.  The
        `model.bad_version` fault site taints the version admitted
        while armed (engine.degrade) — after warmup, so the taint
        degrades traffic, not compilation.  Promote with
        `promote_version`, abort with `rollback_version`."""
        base = self._entry(name)
        if not isinstance(base.engine, InferenceEngine):
            raise ValueError("register_version() supports one-shot "
                             "InferenceEngine models only")
        version = str(version)
        cname = "%s@%s" % (name, version)
        with self._lock:
            if base.canary is not None:
                raise ValueError(
                    "model %r already has version %r in flight "
                    "(promote or roll it back first)"
                    % (name, base.canary["version"]))
        tainted = fault.should_fire("model.bad_version")
        spawn = {k: v for k, v in base.spawn.items()
                 if k not in ("replicas", "version")}
        spawn.update(register_kw)
        replicas = int(spawn.pop("replicas", 1))
        rec = self.register(cname, block, replicas=replicas,
                            version=version, **spawn)
        try:
            centry = self._entry(cname)
            if warmup and centry.engine._example_shape is not None:
                self.warmup(cname)
            if tainted:
                stall = float(_cfg.get("MXNET_CTL_DEGRADE_S"))
                centry.engine.degrade(stall)
                _bb.record("serve", "bad_version", model=str(name),
                           version=version, stall_s=stall)
            fraction = float(
                fraction if fraction is not None
                else _cfg.get("MXNET_CTL_CANARY_FRACTION"))
            if not (0.0 <= fraction <= 1.0):
                raise ValueError("canary fraction must be in [0, 1], "
                                 "got %r" % (fraction,))
            with self._lock:
                cur = self._models.get(str(name))
                if cur is None or cur is not base:
                    raise UnknownModel(
                        "model %r was unregistered while version %r "
                        "built" % (name, version))
                base.canary = {"name": cname, "version": version,
                               "fraction": fraction, "acc": 0.0}
        except Exception:
            # the canary's ledger hold releases on EVERY exit path —
            # a failed warmup/validation must not strand it
            try:
                self.unregister(cname, timeout=5.0)
            except UnknownModel:
                pass
            raise
        events.incr("serve.versions_admitted")
        events.incr("serve.versions_admitted",
                    labels={"model": str(name), "version": version})
        _bb.record("serve", "version_admitted", model=str(name),
                   version=version, fraction=fraction,
                   tainted=bool(tainted))
        rec.update(version=version, fraction=fraction,
                   tainted=bool(tainted))
        return rec

    def canary(self, name):
        """The in-flight canary route for model `name` ({name,
        version, fraction, acc}) or None."""
        with self._lock:
            entry = self._models.get(str(name))
            if entry is None:
                raise UnknownModel("model %r is not registered"
                                   % (name,))
            return dict(entry.canary) if entry.canary else None

    def set_canary_fraction(self, name, fraction):
        """Re-point the mirrored traffic fraction of model `name`'s
        in-flight version (the supervisor's ramp actuator)."""
        fraction = float(fraction)
        if not (0.0 <= fraction <= 1.0):
            raise ValueError("canary fraction must be in [0, 1], "
                             "got %r" % (fraction,))
        with self._lock:
            entry = self._models.get(str(name))
            if entry is None:
                raise UnknownModel("model %r is not registered"
                                   % (name,))
            if entry.canary is None:
                raise ValueError("model %r has no version in flight"
                                 % (name,))
            entry.canary["fraction"] = fraction
            version = entry.canary["version"]
        _bb.record("serve", "canary_fraction", model=str(name),
                   version=version, fraction=fraction)
        return fraction

    def promote_version(self, name, timeout=30.0):
        """Promote model `name`'s in-flight version: the primary
        engine swaps to the version's weights in place
        (`refresh_params_from` — the already-captured programs keep
        serving, zero downtime), re-tags its version label, and the
        canary entry is unregistered (its ledger hold released
        exactly once).  A failed swap (parameter-tree mismatch)
        restores the canary route so `rollback_version` can still
        clean up."""
        name = str(name)
        with self._lock:
            entry = self._models.get(name)
            if entry is None:
                raise UnknownModel("model %r is not registered"
                                   % (name,))
            can, entry.canary = entry.canary, None
        if can is None:
            raise ValueError("model %r has no version in flight to "
                             "promote" % (name,))
        try:
            centry = self._entry(can["name"])
            src = (centry.engine._param_src
                   if centry.engine._param_src is not None
                   else centry.engine._block)
            entry.engine.refresh_params_from(src,
                                             version=can["version"])
        except Exception:
            with self._lock:        # keep the canary rollbackable —
                cur = self._models.get(name)    # its ledger hold must
                if cur is not None and cur.canary is None:  # still
                    cur.canary = can            # release exactly once
            raise
        entry.version = can["version"]
        try:
            self.unregister(can["name"], timeout)
        except UnknownModel:
            pass
        events.incr("serve.versions_promoted")
        events.incr("serve.versions_promoted",
                    labels={"model": name, "version": can["version"]})
        _bb.record("serve", "version_promoted", model=name,
                   version=can["version"])
        return {"model": name, "version": can["version"]}

    def rollback_version(self, name, reason=None, timeout=30.0):
        """Revert model `name`'s in-flight version: traffic mirroring
        stops immediately (the route is cleared under the lock before
        anything slow), the canary entry is unregistered and its
        ledger hold released.  Idempotent — a second rollback (or a
        rollback racing a promote) returns None and touches nothing,
        so the release happens exactly once.  Returns the rolled-back
        route dict."""
        name = str(name)
        with self._lock:
            entry = self._models.get(name)
            can = entry.canary if entry is not None else None
            if entry is not None:
                entry.canary = None
        if can is None:
            return None
        try:
            self.unregister(can["name"], timeout)
        except UnknownModel:
            pass
        events.incr("serve.versions_rolled_back")
        events.incr("serve.versions_rolled_back",
                    labels={"model": name, "version": can["version"]})
        _bb.record("serve", "version_rolled_back", model=name,
                   version=can["version"],
                   reason=str(reason) if reason else None)
        return dict(can)

    # -- traffic -------------------------------------------------------
    def _entry(self, name):
        with self._lock:
            entry = self._models.get(str(name))
        if entry is None:   # absent OR still mid-register (placeholder)
            raise UnknownModel("model %r is not registered" % (name,))
        return entry

    def engine(self, name):
        """The model's underlying InferenceEngine (escape hatch)."""
        return self._entry(name).engine

    def _observed(self, breaker):
        """Future callback: success (or a flow-control rejection)
        feeds the breaker's verdict; infrastructure failures trip
        it."""
        def cb(fut):
            if fut.cancelled():
                return
            exc = fut.exception()
            if exc is None:
                breaker.ok()
            elif not isinstance(exc, _FLOW_ERRORS):
                breaker.fail(exc)
        return cb

    def _route(self, entry, submit, *args, **kw):
        """ONE breaker triage for every submit shape: one-shot submits
        return a Future, generation submits a GenerationStream whose
        `.future` carries the verdict — the done-callback lands on
        whichever exists."""
        if not entry.breaker.allow():
            events.incr("serve.breaker_rejected")
            events.incr("serve.breaker_rejected",
                        labels={"model": entry.name})
            raise CircuitOpen(
                "model %r backend circuit is open (cooldown %.1fs); "
                "recent dispatches failed terminally"
                % (entry.name, entry.breaker.cooldown))
        try:
            res = submit(*args, **kw)
        except _FLOW_ERRORS:
            raise                   # engine self-protection: neutral
        except (ValueError, TypeError):
            raise                   # CLIENT error (bad shape/dtype/
                                    # lane): a misconfigured caller
                                    # must not open the breaker on a
                                    # healthy backend for everyone
        except Exception as e:      # noqa: BLE001 — submit-side infra
            entry.breaker.fail(e)   # failure counts against the model
            raise
        fut = getattr(res, "future", res)
        fut.add_done_callback(self._observed(entry.breaker))
        return res

    def _traffic_entry(self, entry):
        """Canary mirroring: a deterministic fraction
        ACCUMULATOR (not a RNG) routes exactly `fraction` of the
        primary's submits to the in-flight version — reproducible
        splits, no sampling noise in the canary's labeled series.
        The canary rides its own entry: own breaker, own engine, own
        version-labeled telemetry."""
        if entry.canary is None:
            return entry
        with self._lock:
            can = entry.canary
            if can is None or can["fraction"] <= 0.0:
                return entry
            can["acc"] += can["fraction"]
            if can["acc"] < 1.0 - 1e-9:
                return entry
            can["acc"] -= 1.0
            target = self._models.get(can["name"])
        return target if target is not None else entry

    def submit(self, name, x, deadline=None, lane=None, tenant=None):
        """Route one example to model `name` through its circuit
        breaker.  Raises UnknownModel / CircuitOpen synchronously on
        top of the engine's QueueFull / Shed / EngineClosed.  With a
        version in flight, a deterministic fraction of submits mirrors
        to the canary entry instead."""
        entry = self._traffic_entry(self._entry(name))
        return self._route(entry, entry.engine.submit, x,
                           deadline=deadline, lane=lane, tenant=tenant)

    def submit_batch(self, name, x, deadline=None, lane=None,
                     tenant=None):
        entry = self._traffic_entry(self._entry(name))
        return self._route(entry, entry.engine.submit_batch, x,
                           deadline=deadline, lane=lane, tenant=tenant)

    # -- warmup / reconcile --------------------------------------------
    def warmup(self, name=None, **kw):
        """`engine.warmup()` for one model (or all), then reconcile the
        admission ledger against the MEASURED cost-registry rows the
        warmup just created — the projection admitted the model, the
        measurement keeps the ledger honest."""
        if name is not None:
            names = [str(name)]
        else:
            with self._lock:
                names = [n for n, e in self._models.items()
                         if e is not None]
        out = {}
        for n in names:
            entry = self._entry(n)
            # warmup residency is a phase of its own in the memory
            # observatory: the capture/replication spike watermarks
            # under "warmup", never inflating the steady envelope
            with _mw.phase("warmup"):
                out[n] = entry.engine.warmup(**kw)
            self.reconcile(n)
        return out if name is None else out[str(name)]

    def reconcile(self, name):
        """Swap a model's projected footprint for the measured one (the
        `telemetry.costs` rows of its captured programs: the parameter
        copy, static inputs and graph-pool growth of each replica; for a
        generation engine its parameters and static state once and
        every program's pool) when available; adjusts the committed
        ledger by the delta and records the correction.  Returns the
        measured bytes (0 = nothing measured yet)."""
        entry = self._entry(name)
        measured = max(_costs.footprint_bytes(fam, kind="serve")
                       for fam in entry.cost_labels)
        if measured <= 0 or measured == entry.footprint:
            return measured
        with self._lock:
            prior = entry.footprint
            delta = measured - prior
            for i in entry.devices:
                self._committed[i] = max(0, self._committed[i] + delta)
            entry.footprint, entry.basis = measured, "measured"
        pct = (delta / prior) if prior > 0 else 1.0
        _bb.record("serve", "footprint_reconciled", model=entry.name,
                   measured_bytes=int(measured), delta_bytes=int(delta),
                   pct_moved=round(pct, 4))
        if abs(pct) > 0.10:
            # a reconcile that MOVES the row >10% means the projection
            # (or a prior measurement) was materially wrong — its own
            # event + counter so drift trends are countable without
            # parsing every reconcile
            events.incr("serve.footprint_reconcile_large")
            events.incr("serve.footprint_reconcile_large",
                        labels={"model": entry.name})
            _bb.record("serve", "footprint_reconcile_large",
                       model=entry.name, prior_bytes=int(prior),
                       measured_bytes=int(measured),
                       pct_moved=round(pct, 4))
        return measured

    # -- introspection / lifecycle -------------------------------------
    def slo_targets(self):
        """{lane: tightest relative deadline seconds observed across
        every hosted model's engine} — the registry-level SLO targets
       .  A lane's target is the MOST demanding deadline
        any tenant asked of it; lanes that never saw a deadlined
        request contribute nothing."""
        with self._lock:
            entries = [e for e in self._models.values()
                       if e is not None]
        out = {}
        for e in entries:
            for lane, t in e.engine.slo_targets().items():
                cur = out.get(lane)
                if cur is None or t < cur:
                    out[lane] = t
        return out

    def slo_lane_quotas(self):
        """{lane: most restrictive occupancy quota fraction enforced
        by any hosted engine} — the budgets the default shed burn
        rules derive from (see `InferenceEngine.slo_lane_quotas`)."""
        with self._lock:
            entries = [e for e in self._models.values()
                       if e is not None]
        out = {}
        for e in entries:
            for lane, f in e.engine.slo_lane_quotas().items():
                cur = out.get(lane)
                out[lane] = f if cur is None else min(cur, f)
        return out

    def install_slo_rules(self, **kw):
        """Build + register the default serving SLO rules
        (telemetry/slo.py) with this registry's observed per-lane
        deadline targets: per-lane shed burn-rate + p99-vs-deadline.
        Returns the registered rule names; call again after traffic
        has established deadlines to pick up tighter targets."""
        from ..telemetry import slo as _slo
        return _slo.install_default_serving_rules(registry=self, **kw)

    def slow_requests(self, name=None, lane=None):
        """The promoted slow-request exemplars of one
        hosted model's engine — or of every hosted model when ``name``
        is None — newest last.  The per-request autopsy surface:
        each row carries the full phase waterfall, terminal status
        and dominant phase (`tools/blackbox.py autopsy` renders the
        same rows from a dump)."""
        if name is not None:
            names = [str(name)]
        else:
            with self._lock:
                names = [n for n, e in self._models.items()
                         if e is not None]
        out = []
        for n in names:
            j = getattr(self._entry(n).engine, "_journal", None)
            if j is None:
                continue
            for ex in j.exemplars():
                if lane is None or ex.get("lane") == lane:
                    out.append(ex)
        out.sort(key=lambda e: e.get("ts", 0))
        return out

    def stats(self):
        with self._lock:
            models = {}
            for n, e in self._models.items():
                if e is None:
                    continue
                j = getattr(e.engine, "_journal", None)
                models[n] = {
                    "footprint_bytes": e.footprint, "basis": e.basis,
                    "devices": [str(self._devices[i])
                                for i in e.devices],
                    "replicas": len(e.devices),
                    "version": e.version,
                    "canary": dict(e.canary) if e.canary else None,
                    "breaker": e.breaker.state,
                    "reqtrace": None if j is None else
                    {"records": j.records, "promoted": j.promoted}}
            # measured columns: a FRESH memwatch
            # sample annotates each ledger row with the allocator's
            # view and the drift ratio; stale/absent samples leave
            # None — the reader always knows whether it is looking at
            # measurement or just the ledger again
            measured = None
            try:
                measured = _mw.fresh_device_bytes()
            except Exception:       # noqa: BLE001
                measured = None
            ledger = []
            for c, b, u in zip(self._devices, self._budgets,
                               self._committed):
                m = None if measured is None else \
                    measured.get(_mw.device_key(c))
                ledger.append(
                    {"device": str(c), "budget": b, "committed": u,
                     "free": (b - u) if b > 0 else None,
                     "measured_bytes": m,
                     "drift": (round(m / u, 4)
                               if m is not None and u > 0 else None)})
        return {"models": models, "ledger": ledger}

    def drain_all(self, timeout=30.0):
        ok = True
        with self._lock:
            entries = [e for e in self._models.values()
                       if e is not None]
        for e in entries:
            ok = e.engine.drain(timeout) and ok
        return ok

    def close(self, timeout=30.0):
        """Close every engine (resolving every outstanding future) and
        release the whole ledger.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            entries, self._models = [
                e for e in self._models.values() if e is not None], {}
            self._committed = [0] * len(self._devices)
        for e in entries:
            e.engine.close(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
