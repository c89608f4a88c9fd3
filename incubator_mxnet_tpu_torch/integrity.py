"""Record integrity of the PyTorch port: the record half of
incubator_mxnet_tpu/integrity.py.

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

Left out: the checkpoint manifests and the cross-replica audit, which
wait for the port's checkpointing and sharded trainers.
"""
from __future__ import annotations

import json
import os
import threading
import zlib

from . import config as _cfg
from .monitor import events

__all__ = ["IntegrityError", "RecordCorrupt", "CorruptRecordBudgetExceeded",
           "checksum", "checksum_algo", "checksum_fn", "quarantine_record",
           "quarantine_path"]


class IntegrityError(Exception):
    """Base class: data failed an integrity check."""


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
