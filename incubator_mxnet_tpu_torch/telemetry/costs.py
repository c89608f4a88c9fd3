"""Per-program memory attribution of the PyTorch port: the serving rows
of incubator_mxnet_tpu/telemetry/costs.py.

Every captured serving program (an `InferenceEngine` bucket on one
replica, a `GenerationEngine` prefill, join or decode step) registers
one row keyed by its label and signature, and every replay bumps the
row's invocation count, so a dump or a `/metrics` scrape can say what
the serving programs hold on each device.

A row's bytes are measured, not estimated.  XLA's `memory_analysis` has
no counterpart for a CUDA graph, so a row carries:

* ``param_bytes``: the parameter copy the program reads;
* ``argument_bytes``: that copy plus the program's static input buffer
  (the JAX package's argument bytes);
* ``output_bytes``: the program's static outputs;
* ``pool_bytes``: what the capture added to its graph pool's segments
  (``torch.cuda.memory_snapshot()`` read around the capture,
  `graph_capture.capture`), which hold the outputs and the
  temporaries; ``temp_bytes`` is that growth less the outputs.  On the
  CPU a recording has no pool and no allocator statistics: both are
  None/0 and ``temp_measured`` is False.

The FLOP and bytes-accessed fields of the JAX rows come from XLA's cost
analysis; a captured program has none, so they stay 0 with
``analyzed=False``.  `MeteredJit` (the training side) is not ported.

`note_collective` registers a ZeRO bucket's collective (a reduce-scatter,
an all-gather or an all-reduce of one bucket, `parallel/zero.py`) with
its bytes on the wire as ``bytes_accessed``, kind "collective", as the
JAX package's rows do.
"""
from __future__ import annotations

import threading

__all__ = ["note_program", "note_collective", "invoke", "table", "totals", "snapshot",
           "reset", "footprint_bytes", "drop_rows"]

_LOCK = threading.Lock()
_ROWS = {}                      # key -> dict row
_NEXT = [1]


def note_program(kind, label, sig=None, group=None, param_bytes=0,
                 argument_bytes=0, output_bytes=0, temp_bytes=0,
                 pool_bytes=None, capture_s=None):
    """Register one captured program's row (the counterpart of the JAX
    package's `note_executable`).  ``group`` names the programs that
    share one parameter copy (an engine replica); `footprint_bytes`
    counts that copy once per group.  Returns the row key for
    `invoke()`."""
    row = {"kind": str(kind), "label": str(label),
           "flops": 0.0, "bytes_accessed": 0.0, "analyzed": False,
           "compile_wall_s": float(capture_s) if capture_s else 0.0,
           "loaded": False, "invocations": 0,
           "group": None if group is None else str(group),
           "param_bytes": int(param_bytes),
           "argument_bytes": int(argument_bytes),
           "output_bytes": int(output_bytes),
           "temp_bytes": int(temp_bytes),
           "pool_bytes": None if pool_bytes is None else int(pool_bytes),
           "temp_measured": pool_bytes is not None}
    if sig is not None:
        row["sig"] = str(sig)
    with _LOCK:
        key = _NEXT[0]
        _NEXT[0] += 1
        _ROWS[key] = row
    return key


def note_collective(label, op, wire_bytes, n_shards, dtype="float32"):
    """Register one bucket collective's row (module doc); returns its key
    for `invoke()`."""
    row = {"kind": "collective", "label": str(label), "flops": 0.0,
           "bytes_accessed": float(wire_bytes), "analyzed": True,
           "compile_wall_s": 0.0, "loaded": False, "invocations": 0,
           "group": None, "param_bytes": 0, "argument_bytes": 0,
           "output_bytes": 0, "temp_bytes": 0, "pool_bytes": None,
           "temp_measured": False,
           "sig": "%s[%d shards, %s]" % (op, int(n_shards), dtype)}
    with _LOCK:
        key = _NEXT[0]
        _NEXT[0] += 1
        _ROWS[key] = row
    return key


def invoke(key, n=1):
    """Bump a row's cumulative invocation count (one lock)."""
    with _LOCK:
        row = _ROWS.get(key)
        if row is not None:
            row["invocations"] += int(n)


def table():
    """The cost table: one dict per registered program, sorted by the
    bytes it holds (argument + output + temp), largest first."""
    with _LOCK:
        items = [(k, dict(r)) for k, r in _ROWS.items()]
    out = []
    for key, r in items:
        r["key"] = key
        out.append(r)
    out.sort(key=lambda r: -(r["argument_bytes"] + r["output_bytes"]
                             + r["temp_bytes"]))
    return out


def totals():
    """Aggregates for one JSON line: program and invocation counts and
    the bytes the programs hold."""
    rows = table()
    return {"executables": len(rows),
            "invocations": sum(r["invocations"] for r in rows),
            "compile_wall_s": round(sum(r["compile_wall_s"]
                                        for r in rows), 3),
            "held_bytes": sum(r["argument_bytes"] + r["output_bytes"]
                              + r["temp_bytes"] - r["param_bytes"]
                              for r in rows)}


def _matches(label, prefix):
    return label == prefix or label.startswith(prefix + "[")


def footprint_bytes(label_prefix, kind=None):
    """MEASURED per-device footprint of one program family: for each
    group (the programs that share one parameter copy), the parameter
    bytes once plus every program's static input and its pool growth
    (its outputs where no pool was measured); the largest group.  A
    CUDA graph holds its outputs and pool for its lifetime, so the
    programs of one replica add up where an XLA family's largest
    executable bounds it.  Labels
    match exactly or as ``<prefix>[...]`` (model 'ranker' never reads
    'ranker2').  0 when nothing matches."""
    groups = {}
    for r in table():
        if kind is not None and r.get("kind") != kind:
            continue
        if not _matches(str(r.get("label", "")), label_prefix):
            continue
        g = groups.setdefault(r.get("group"), [0, 0])
        g[0] = max(g[0], r["param_bytes"])
        held = r["pool_bytes"] if r["pool_bytes"] is not None \
            else r["output_bytes"] + r["temp_bytes"]
        g[1] += r["argument_bytes"] - r["param_bytes"] + held
    return max((p + rest for p, rest in groups.values()), default=0)


def drop_rows(label_prefix, kind=None):
    """Remove the rows of one label family (the `footprint_bytes`
    matching rule); the ModelRegistry drops a model's rows on
    unregister.  Returns the number removed."""
    with _LOCK:
        gone = [k for k, r in _ROWS.items()
                if (kind is None or r.get("kind") == kind)
                and _matches(str(r.get("label", "")), label_prefix)]
        for k in gone:
            del _ROWS[k]
    return len(gone)


def snapshot():
    """{"rows": table(), "totals": totals()} — the dump/export block."""
    return {"rows": table(), "totals": totals()}


def reset():
    with _LOCK:
        _ROWS.clear()
