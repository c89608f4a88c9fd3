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

__all__ = ["register", "get", "set", "unset"]

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
