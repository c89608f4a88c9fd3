"""Integrity of the PyTorch port (counterpart of
incubator_mxnet_tpu/integrity.py): records, checkpoints and replicas.

An optional ``<file>.crc`` sidecar (`io.recordio.write_crc_sidecar`)
carries a CRC per RecordIO payload.  The readers (the decode-service
workers and the threaded `ImageRecordIter` path) verify it and
QUARANTINE a corrupt record: it is skipped, counted
(``io.decode.records_corrupt``), recorded in the flight recorder's ring
and appended to a quarantine JSONL that names its file and offset, under
a per-epoch ``MXNET_IO_CORRUPT_BUDGET`` past which the epoch fails with
`CorruptRecordBudgetExceeded`.  `RecordCorrupt` is not transient, so the
retry paths fail fast on it.

The checksum is CRC32C through `google_crc32c` where that package is
importable, else zlib's CRC32; the name of the one in use is written
into every sidecar, and a reader verifies with the recorded one.

A checkpoint directory carries ``integrity_manifest.json``
(`write_manifest`, written inside the temp directory before the atomic
publish): per file its size and CRC, and per leaf of the trainer's
state (`named_leaves`: ``params/<name>`` in sorted order, then
``opt_state/<path>`` with jax's key-path spelling, ``['m']['w']``) the
CRC of its bytes.  The same parameters give the same per-leaf digests
in both packages.  `verify_checkpoint` raises `CheckpointCorrupt` naming
every file that does not match, and the leaves that do not where
``checkpoint.pt`` still loads (a flipped bit may make `torch.load`
itself fail, and then no leaf is named).

`audit_replicas` hashes every replicated parameter and optimizer-state
leaf per replica of a `ShardedTrainer` and compares them across the
mesh (the data-parallel invariant: bit-identical copies); the
``mesh.replica_divergence`` fault site perturbs one replica's CRC.
With a kvstore the per-replica digests round-trip through it
(`_kv_roundtrip`) and the pulled values are compared too.
"""
from __future__ import annotations

import json
import os
import threading
import zlib

from . import config as _cfg
from .monitor import events

__all__ = ["IntegrityError", "CheckpointCorrupt", "RecordCorrupt",
           "CorruptRecordBudgetExceeded", "SDCDetected", "checksum",
           "checksum_algo", "checksum_fn", "MANIFEST", "write_manifest",
           "verify_checkpoint", "named_leaves", "quarantine_record",
           "quarantine_path", "audit_replicas", "AuditReport"]

MANIFEST = "integrity_manifest.json"
_MANIFEST_SCHEMA = "mxtpu-integrity/1"


class IntegrityError(Exception):
    """Base class: data failed an integrity check."""


class CheckpointCorrupt(IntegrityError):
    """A checkpoint's bytes do not match its manifest.  `ckpt` is the
    directory, `files` the mismatching relative paths with reasons,
    `leaves` the state leaves found bad (empty when the checkpoint file
    cannot be loaded), `kind` ``file`` or ``manifest``."""

    def __init__(self, ckpt, files=None, leaves=None, kind="file",
                 detail=""):
        self.ckpt = str(ckpt)
        self.files = dict(files or {})
        self.leaves = sorted(leaves or [])
        self.kind = kind
        what = ", ".join("%s (%s)" % kv for kv in
                         sorted(self.files.items())[:4]) or detail
        leaf = (" — bad leaf(s): %s" % ", ".join(self.leaves[:4])
                if self.leaves else "")
        super().__init__(
            "checkpoint %s failed integrity verification [%s]: %s%s"
            % (self.ckpt, kind, what, leaf))


class SDCDetected(IntegrityError):
    """A replica's replicated state diverged from the mesh (the
    cross-replica audit) and no checkpoint exists to roll back to."""

    def __init__(self, replicas, leaves, step):
        self.replicas = sorted(int(r) for r in replicas)
        self.leaves = sorted(leaves)
        self.step = int(step)
        super().__init__(
            "cross-replica SDC audit failed at step %d: replica(s) %s "
            "diverge on %s (no checkpoint to roll back to)"
            % (self.step, self.replicas, self.leaves[:4]))


class RecordCorrupt(IntegrityError, IOError):
    """A RecordIO payload failed its CRC or could not be decoded.  An
    IOError for handlers that expect one, but not transient: re-reading
    corrupt bytes gives the same bytes, so `io.resilient` does not
    retry it."""

    def __init__(self, uri, offset, reason):
        self.uri = str(uri)
        self.offset = int(offset)
        self.reason = str(reason)
        super().__init__("corrupt record in %s at offset %d: %s"
                         % (self.uri, self.offset, self.reason))


class CorruptRecordBudgetExceeded(IntegrityError, RuntimeError):
    """More records were quarantined this epoch than
    ``MXNET_IO_CORRUPT_BUDGET`` allows: the epoch fails instead of
    training on a shrinking dataset."""

    def __init__(self, uri, count, budget):
        self.uri = str(uri)
        self.count = int(count)
        self.budget = int(budget)
        super().__init__(
            "corrupt-record budget exceeded for %s: %d quarantined "
            "this epoch > MXNET_IO_CORRUPT_BUDGET=%d"
            % (uri, count, budget))


try:
    import google_crc32c as _crc32c
except ImportError:
    _crc32c = None


def checksum_algo() -> str:
    """Name of the checksum `checksum` computes on this host."""
    return "crc32c" if _crc32c is not None else "crc32"


def checksum(data) -> int:
    """CRC of a bytes-like object with this host's algorithm
    (`checksum_algo`)."""
    return checksum_fn(checksum_algo())(data)


def checksum_fn(algo: str):
    """The CRC function of a recorded algorithm name; an algorithm this
    host cannot compute raises instead of comparing unlike sums."""
    if algo == "crc32c":
        if _crc32c is None:
            raise IntegrityError(
                "artifact was checksummed with crc32c but the "
                "google_crc32c package is not importable on this host")
        return lambda b: int(_crc32c.value(bytes(b)))
    if algo == "crc32":
        return lambda b: zlib.crc32(bytes(b)) & 0xFFFFFFFF
    raise IntegrityError("unknown checksum algorithm %r" % (algo,))


# -- checkpoint manifests ----------------------------------------------

def _walk_files(ckpt_dir):
    for root, _dirs, files in os.walk(ckpt_dir):
        for f in sorted(files):
            fp = os.path.join(root, f)
            rel = os.path.relpath(fp, ckpt_dir)
            if rel == MANIFEST:
                continue
            yield rel.replace(os.sep, "/"), fp


def _keystr(path):
    """jax's `keystr` of a key path of dict keys and sequence indices."""
    return "".join("[%r]" % (k,) if isinstance(k, str) else "[%d]" % k
                   for k in path)


def _flatten_with_path(tree, path=()):
    """[(key path, leaf)] in jax's flattening order: dict keys sorted,
    sequences in order; None is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten_with_path(tree[k], path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out.extend(_flatten_with_path(v, path + (i,)))
        return out
    return [(path, tree)]


def named_leaves(params, opt_state=None):
    """``[(leaf name, tensor)]`` over a trainer's state: parameters by
    name (``params/<name>``, sorted), then the optimizer state by its
    tree path (``opt_state/<path>``), as the JAX package names them."""
    out = [("params/%s" % name, params[name]) for name in sorted(params)]
    if opt_state is not None:
        for path, leaf in _flatten_with_path(opt_state):
            out.append(("opt_state/%s" % _keystr(path), leaf))
    return out


def _leaf_bytes(t):
    """The bytes of a tensor (or array) in C order, as numpy holds
    them: a bfloat16 leaf gives its 2-byte words."""
    import numpy as _np
    import torch
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return _np.ascontiguousarray(_np.asarray(t)).tobytes()


def _stream_crc(path, algo, chunk=1 << 20):
    """CRC of a file's contents without holding it in memory."""
    acc = None
    with open(path, "rb") as fh:
        while True:
            buf = fh.read(chunk)
            if not buf:
                break
            if acc is None:
                acc = checksum_fn(algo)(buf)
            elif algo == "crc32c":
                acc = int(_crc32c.extend(acc, buf))
            else:
                acc = zlib.crc32(buf, acc) & 0xFFFFFFFF
    return 0 if acc is None else acc


def write_manifest(ckpt_dir, leaves=None) -> str:
    """Write ``integrity_manifest.json`` into `ckpt_dir`: per file its
    size and CRC, and per leaf of `leaves` (`named_leaves`) the size and
    CRC of its bytes.  Returns the manifest's path."""
    algo = checksum_algo()
    fn = checksum_fn(algo)
    files = {rel: [os.path.getsize(fp), _stream_crc(fp, algo)]
             for rel, fp in _walk_files(ckpt_dir)}
    doc = {"schema": _MANIFEST_SCHEMA, "algo": algo, "files": files}
    if leaves:
        doc["leaves"] = {name: [int(len(b)), fn(b)] for name, b in
                         ((n, _leaf_bytes(a)) for n, a in leaves)}
    path = os.path.join(ckpt_dir, MANIFEST)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def _load_manifest(ckpt_dir):
    path = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
        if doc.get("schema") != _MANIFEST_SCHEMA or \
                "files" not in doc or "algo" not in doc:
            raise ValueError("bad schema %r" % doc.get("schema"))
        return doc
    except (ValueError, KeyError, OSError) as e:
        raise CheckpointCorrupt(
            ckpt_dir, kind="manifest",
            detail="manifest unreadable: %s" % e) from e


def _find_bad_leaves(ckpt_dir, doc):
    """The manifest's leaves whose bytes in the loaded checkpoint file no
    longer match; [] where the file does not load (the file is still
    reported) or the manifest has no leaves."""
    want = doc.get("leaves")
    if not want:
        return []
    try:
        import torch
        from .parallel.trainer import CHECKPOINT_FILE
        tree = torch.load(os.path.join(ckpt_dir, CHECKPOINT_FILE),
                          map_location="cpu", weights_only=True)
        got = dict(named_leaves(tree.get("params", {}),
                                tree.get("opt_state")))
        fn = checksum_fn(doc["algo"])
        bad = []
        for name, (nbytes, crc) in want.items():
            if name not in got:
                bad.append(name)
                continue
            b = _leaf_bytes(got[name])
            if len(b) != nbytes or fn(b) != crc:
                bad.append(name)
        return bad
    except Exception:               # noqa: BLE001 — unreadable: no leaf
        return []


def verify_checkpoint(ckpt_dir, name_leaves=True) -> dict:
    """Verify a checkpoint directory against its manifest.  Returns a
    report dict; raises `CheckpointCorrupt` naming every file that is
    missing, of another size or another CRC, and (with `name_leaves`,
    where the checkpoint file loads) the bad leaves.  A checkpoint
    without a manifest is reported ``verified=False`` and counted
    (``integrity.ckpt_unverified``), not refused."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        raise CheckpointCorrupt(ckpt_dir, kind="file",
                                detail="checkpoint directory missing")
    doc = _load_manifest(ckpt_dir)
    if doc is None:
        events.incr("integrity.ckpt_unverified")
        return {"ckpt": ckpt_dir, "verified": False,
                "reason": "no manifest", "files": 0}
    algo = doc["algo"]
    checksum_fn(algo)               # an unknown algorithm fails here
    bad = {}
    for rel, (nbytes, crc) in doc["files"].items():
        fp = os.path.join(ckpt_dir, rel.replace("/", os.sep))
        if not os.path.isfile(fp):
            bad[rel] = "missing"
            continue
        size = os.path.getsize(fp)
        if size != int(nbytes):
            bad[rel] = "size %d != %d" % (size, nbytes)
            continue
        if _stream_crc(fp, algo) != int(crc):
            bad[rel] = "crc mismatch"
    if bad:
        leaves = _find_bad_leaves(ckpt_dir, doc) if name_leaves else []
        events.incr("integrity.ckpt_corrupt")
        _ring("ckpt_corrupt", ckpt=os.path.basename(ckpt_dir),
              files=sorted(bad)[:4], leaves=leaves[:4])
        raise CheckpointCorrupt(ckpt_dir, files=bad, leaves=leaves)
    return {"ckpt": ckpt_dir, "verified": True, "algo": algo,
            "files": len(doc["files"]),
            "leaves": len(doc.get("leaves", {}))}


# -- record quarantine -------------------------------------------------

_QUAR_LOCK = threading.Lock()


def quarantine_path() -> str:
    """This process's quarantine ledger (JSON lines, one per record):
    ``<MXNET_BLACKBOX_DIR>/io-quarantine-p<pid>.jsonl``, next to the
    black-box dumps (the system temp directory by default)."""
    import tempfile
    d = _cfg.get("MXNET_BLACKBOX_DIR") or tempfile.gettempdir()
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        d = tempfile.gettempdir()
    return os.path.join(d, "io-quarantine-p%d.jsonl" % os.getpid())


def quarantine_record(uri, offset, reason, epoch=None, wid=None) -> str:
    """Book one corrupt record: count it (``io.decode.records_corrupt``),
    record a flight-recorder event and append a JSONL entry naming its
    file and offset.  Returns the ledger's path.  Never raises: the
    caller decides about skipping and the budget."""
    events.incr("io.decode.records_corrupt")
    _ring("record_corrupt", file=os.path.basename(str(uri)),
          offset=int(offset), reason=str(reason)[:80], epoch=epoch, wid=wid)
    path = quarantine_path()
    entry = {"file": str(uri), "offset": int(offset),
             "reason": str(reason)[:200]}
    if epoch is not None:
        entry["epoch"] = int(epoch)
    if wid is not None:
        entry["wid"] = int(wid)
    try:
        with _QUAR_LOCK, open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")
    except OSError:
        pass
    return path


def _ring(name, **data):
    """A flight-recorder event of kind ``integrity`` (never raises)."""
    try:
        from .telemetry import flightrec as _bb
        _bb.record("integrity", name,
                   **{k: v for k, v in data.items() if v is not None})
    except Exception:               # noqa: BLE001 — forensics only
        pass


# -- cross-replica audit -----------------------------------------------

class AuditReport:
    """One cross-replica audit round.

    divergent: {rid: [leaf names]}, the replicas whose replicated bytes
        differ from the mesh's modal ones (empty: clean)
    digests: {rid: int}, each replica's fold over its comparable
        (leaf, shard) groups, the value that round-trips through the
        kvstore
    groups: the number of comparable groups
    """

    __slots__ = ("step", "divergent", "digests", "groups")

    def __init__(self, step, divergent, digests, groups):
        self.step = int(step)
        self.divergent = divergent
        self.digests = digests
        self.groups = int(groups)

    @property
    def ok(self) -> bool:
        return not self.divergent

    def victims(self):
        return sorted(self.divergent)

    def leaves(self):
        out = set()
        for ls in self.divergent.values():
            out.update(ls)
        return sorted(out)


def _fold(crcs) -> int:
    """A deterministic fold of (key, crc) pairs into one digest (sorted
    first, so every replica folds the same bytes to the same value)."""
    acc = 0
    for key, crc in sorted(crcs):
        acc = zlib.crc32(("%s:%d" % (key, crc)).encode(), acc) & 0xFFFFFFFF
    return acc


def _replica_shards(trainer):
    """[(leaf name, shard index, replica position, tensor)] over every
    local replica's parameters and optimizer state; a leaf stored whole
    on a replica has shard index None, a sharded one its replica's
    position along the sharded dimension."""
    names = set(trainer._shapes)
    out = []
    for r, params in enumerate(trainer._rparams):
        for name, t in params.items():
            dim = trainer._param_dim.get(name)
            out.append(("params/%s" % name,
                        None if dim is None else r, r, t))
        for path, leaf in _flatten_with_path(trainer._opt[r]):
            nm = next((k for k in path if k in names), None)
            dim = None if nm is None else trainer._state_dim.get(nm)
            out.append(("opt_state/%s" % _keystr(path),
                        None if dim is None else r, r, leaf))
    return out


def audit_replicas(trainer, step=0, rid_of=None, kv=None,
                   inject=True) -> AuditReport:
    """Hash every replicated parameter and optimizer-state leaf of a
    `ShardedTrainer` per replica and compare across the mesh.

    Leaves are grouped by (leaf name, shard index): replicas holding the
    same slice of the same leaf must hold the same bytes.  A leaf
    sharded so that no two replicas hold the same slice (ZeRO) adds no
    group.  The deviant of a group is whoever disagrees with the modal
    CRC; a tie blames the higher replica ids.

    rid_of: {replica position: replica id} (default: the position; the
        elastic trainer passes its original ids).
    kv: a kvstore through which each replica's digest is pushed and
        pulled back (`_kv_roundtrip`); a replica whose pulled digest
        disagrees with the modal one is divergent too.
    inject: whether the ``mesh.replica_divergence`` fault site may fire
        this round."""
    from . import fault
    groups = {}
    for name, idx, r, t in _replica_shards(trainer):
        rid = r if rid_of is None else rid_of.get(r)
        if rid is None:
            continue
        groups.setdefault((name, str(idx)), {})[rid] = \
            checksum(_leaf_bytes(t))
    comparable = {k: v for k, v in groups.items() if len(v) > 1}

    if inject and comparable and \
            fault.should_fire("mesh.replica_divergence", step):
        key = sorted(comparable)[0]
        victim = max(comparable[key])
        comparable[key][victim] ^= 0x1
        import logging
        logging.getLogger(__name__).warning(
            "fault: injected replica divergence at step %d (replica %d, "
            "leaf %s)", step, victim, key[0])

    divergent = {}
    for (name, _idx), crcs in comparable.items():
        vals = sorted(crcs.values())
        if vals[0] == vals[-1]:
            continue
        counts = {}
        for c in crcs.values():
            counts[c] = counts.get(c, 0) + 1
        modal = max(sorted(counts), key=lambda c: counts[c])
        deviants = [r for r, c in crcs.items() if c != modal]
        if len(deviants) == len(crcs) - len(deviants):
            deviants = sorted(crcs)[len(crcs) - len(deviants):]
        for r in deviants:
            divergent.setdefault(int(r), []).append(name)

    rids = sorted({r for crcs in comparable.values() for r in crcs})
    digests = {r: _fold(((name, idx), crcs[r])
                        for (name, idx), crcs in comparable.items()
                        if r in crcs)
               for r in rids}
    if kv is not None and rids:
        digests = _kv_roundtrip(kv, digests, step)
        counts = {}
        for dg in digests.values():
            counts[dg] = counts.get(dg, 0) + 1
        if len(counts) > 1:
            modal = max(sorted(counts), key=lambda d: counts[d])
            for r, dg in digests.items():
                if dg != modal and int(r) not in divergent:
                    divergent[int(r)] = ["<digest>"]

    events.incr("integrity.audits")
    report = AuditReport(step, divergent, digests, len(comparable))
    if divergent:
        events.incr("integrity.sdc")
        _ring("sdc", step=int(step), replicas=report.victims(),
              leaves=report.leaves()[:4])
    return report


_AUDIT_KEY = "__mesh__/audit/%d"
_AUDIT_INITED = "_mx_integrity_audit_keys"


def _kv_roundtrip(kv, digests, step):
    """Push each replica's digest through the kvstore (host float64
    arrays, the heartbeat channel) and read the comparison inputs back
    from the pulled values; on any kvstore failure, the host digests
    (the audit degrades, it never blocks training)."""
    try:
        import numpy as _np
        from .ndarray.ndarray import array
        inited = getattr(kv, _AUDIT_INITED, set())
        out = {}
        for rid, dg in digests.items():
            key = _AUDIT_KEY % rid
            if rid not in inited:
                kv.init(key, array(_np.zeros(2), ctx="cpu",
                                   dtype="float64"))
                inited.add(rid)
            kv.push(key, array(_np.asarray([float(step), float(dg)]),
                               ctx="cpu", dtype="float64"))
        setattr(kv, _AUDIT_INITED, inited)
        for rid in digests:
            buf = array(_np.zeros(2), ctx="cpu", dtype="float64")
            kv.pull(_AUDIT_KEY % rid, out=buf)
            s, dg = (float(x) for x in buf.asnumpy())
            out[rid] = int(dg) if int(s) == int(step) else digests[rid]
        return out
    except Exception:               # noqa: BLE001 — degrade, never block
        return digests
