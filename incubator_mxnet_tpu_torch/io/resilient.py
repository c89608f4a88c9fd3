"""Retrying I/O of the PyTorch port (a copy of
incubator_mxnet_tpu/io/resilient.py): storage blips must not end a run.

`RetryingReader` wraps a reader (MXRecordIO, NativeImageRecordReader, a
DataIter, anything with read methods) and retries transient failures,
IOError/OSError and an injected `fault.TransientFault`, with jittered
exponential backoff (`parallel.resilience.retry_transient`).  Other
errors pass through, and so do permanent I/O errors: corruption
(`integrity.RecordCorrupt`) and the errno classes that time does not
heal (ENOENT, EACCES, EISDIR, ...) fail on the first attempt
(`NON_RETRYABLE`).

    reader = RetryingReader(MXRecordIO(path, "r"))
    buf = reader.read()

Retries count on `monitor.events` (``io.retry``); the budgets come from
MXNET_RETRY_MAX and MXNET_RETRY_BACKOFF (or MXNET_RETRY_BACKOFF_MS)
unless given; ``jitter=False`` sleeps the full window.
"""
from __future__ import annotations

from .. import fault
from ..integrity import RecordCorrupt
from ..monitor import events

__all__ = ["RetryingReader", "retry_io", "NON_RETRYABLE"]

#: method names proxied WITH retry; everything else proxies straight
#: through (reset/seek mutate position — retrying those is the
#: caller's decision, not a blanket policy)
_RETRIED = ("read", "read_idx", "next_batch", "next", "__next__")

#: permanent I/O failures: matching exceptions fail FAST even though
#: they are (subclasses of) OSError.  Corruption re-read is the same
#: corruption; a missing file does not appear because we slept; a
#: permission error does not self-grant.  Retrying these turns one
#: clear error into MXNET_RETRY_MAX slow copies of it — and a corrupt
#: record retried forever is exactly how a poisoned file turns into a
#: retry storm.
NON_RETRYABLE = (RecordCorrupt, FileNotFoundError, PermissionError,
                 IsADirectoryError, NotADirectoryError)


def retry_io(fn, retries=None, backoff=None, what="io operation",
             jitter=True, non_retryable=NON_RETRYABLE):
    """Run `fn()` under the transient-I/O retry policy.  Injected
    faults fire INSIDE the reader (fault sites io.read / io.slow at the
    actual I/O boundary), so what is retried here is exactly what a
    real storage blip would raise.  `non_retryable` failures
    (corruption, permanent errnos — see `NON_RETRYABLE`) pass through
    on the FIRST attempt."""
    from ..parallel.resilience import retry_transient
    return retry_transient(fn, retries=retries, backoff=backoff,
                           what=what,
                           retryable=(fault.TransientFault, OSError),
                           non_retryable=non_retryable,
                           event="io.retry", jitter=jitter)


class RetryingReader:
    """Transparent retry proxy around a reader object.

    Retried methods re-invoke the underlying call after a transient
    failure; if the wrapped reader exposes `reset()` and a retried
    sequential `read` keeps failing, the caller still owns recovery
    semantics — this wrapper never silently skips records."""

    def __init__(self, reader, retries=None, backoff=None, jitter=True):
        self._reader = reader
        self._retries = retries
        self._backoff = backoff
        self._jitter = jitter

    def __getattr__(self, name):
        attr = getattr(self._reader, name)
        if name in _RETRIED and callable(attr):
            def wrapped(*args, **kw):
                # sequential file readers: remember the position and
                # rewind before every attempt, so a blip AFTER partial
                # consumption (header read, payload failed) retries the
                # whole record instead of resuming mid-stream
                handle = getattr(self._reader, "handle", None)
                pos = None
                if handle is not None and hasattr(handle, "seek"):
                    try:
                        pos = handle.tell()
                    except (OSError, ValueError):
                        pos = None

                def attempt():
                    if pos is not None:
                        handle.seek(pos)
                    return attr(*args, **kw)
                return retry_io(attempt,
                                retries=self._retries,
                                backoff=self._backoff,
                                jitter=self._jitter,
                                what="%s.%s" % (
                                    type(self._reader).__name__, name))
            return wrapped
        return attr

    def __iter__(self):
        it = iter(self._reader)
        while True:
            try:
                yield retry_io(lambda: next(it),
                               retries=self._retries,
                               backoff=self._backoff,
                               jitter=self._jitter,
                               what="%s iteration" % (
                                   type(self._reader).__name__,))
            except StopIteration:
                return

    def __next__(self):
        return retry_io(lambda: next(self._reader),
                        retries=self._retries, backoff=self._backoff,
                        jitter=self._jitter,
                        what="%s next" % (type(self._reader).__name__,))
