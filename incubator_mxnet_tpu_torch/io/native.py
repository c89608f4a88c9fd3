"""ctypes bridge of the PyTorch port to the native C++ image-record
pipeline (src/io/recordio_pipeline.cc, MXNet's ImageRecordIOParser2
counterpart; a port of incubator_mxnet_tpu/io/native.py).

The source is read, never written: the shared library is compiled at
first use with g++ and ``-ljpeg`` into the checkout's ``build/io/``
(ignored by git), named by a hash of the source, the flags and the CPU
model (the JAX package's `-march=native`, so that both packages decode
alike), and never placed next to the source.  `available()` is False where g++ or
libjpeg is missing.  `NativeImageRecordReader` hands out (data, label)
numpy batches (float32 normalized, or raw uint8); `ImageRecordIter`
wraps it with a prefetch thread or the device feed.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading

import numpy as _np

__all__ = ["available", "NativeImageRecordReader", "build_library"]

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "src", "io", "recordio_pipeline.cc")
_BUILD = os.path.join(_ROOT, "build", "io")


def _cpu_model():
    """This host's CPU model name: `-march=native` builds for it, so a
    library built on another host is not loaded here."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def build_library():
    """Compile the pipeline's shared library, with the JAX package's
    flags, into ``build/io/libmxtpu_io-<hash>.so`` (the hash over the
    source, the flags and the CPU model) unless it is there already;
    returns its path."""
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", "-march=native"]
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(cmd).encode()
                                + _cpu_model().encode())
    out = os.path.join(_BUILD, "libmxtpu_io-%s.so" % digest.hexdigest()[:12])
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = "%s.%d.tmp" % (out, os.getpid())
    subprocess.run(cmd + [_SRC, "-ljpeg", "-o", tmp], check=True,
                   capture_output=True)
    os.replace(tmp, out)        # a concurrent build finds a whole file
    return out


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not os.path.exists(_SRC):
            return None
        try:
            lib = ctypes.CDLL(build_library())
        except (OSError, subprocess.CalledProcessError):
            return None             # no g++ or no libjpeg on this host
        lib.mxio_create.restype = ctypes.c_void_p
        lib.mxio_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_uint64, ctypes.c_int]
        lib.mxio_num_records.restype = ctypes.c_int64
        lib.mxio_num_records.argtypes = [ctypes.c_void_p]
        lib.mxio_next.restype = ctypes.c_int
        lib.mxio_next.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_float),
                                  ctypes.POINTER(ctypes.c_float)]
        lib.mxio_next_u8.restype = ctypes.c_int
        lib.mxio_next_u8.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_uint8),
                                     ctypes.POINTER(ctypes.c_float)]
        lib.mxio_reset.argtypes = [ctypes.c_void_p]
        lib.mxio_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def available():
    return _load() is not None


class NativeImageRecordReader:
    """Batch iterator over a .rec file, decoded/augmented in C++ threads.

    Yields (data, label) float32 arrays; data layout NCHW (default) or
    NHWC, already mean/std-normalized."""

    def __init__(self, rec_path, batch_size, data_shape, resize=0,
                 rand_crop=False, rand_mirror=False, shuffle=False,
                 label_width=1, layout="NCHW", mean=None, std=None,
                 seed=0, num_threads=None, dtype="float32"):
        lib = _load()
        if lib is None:
            raise RuntimeError("native io library unavailable")
        self._lib = lib
        if dtype not in ("float32", "uint8"):
            raise ValueError("dtype must be float32 or uint8")
        # uint8: raw augmented pixels, NO mean/std (normalize on the
        # accelerator) — 4x fewer host->device bytes
        self._u8 = dtype == "uint8"
        if self._u8 and (mean or std):
            raise ValueError("uint8 output skips normalization; "
                             "apply mean/std on device")
        if len(data_shape) != 3 or data_shape[0] != 3:
            raise ValueError("data_shape must be (3, H, W)")
        _, h, w = data_shape
        self._batch = batch_size
        self._h, self._w = h, w
        self._label_width = label_width
        self._nchw = layout == "NCHW"
        mean_arr = (ctypes.c_float * 3)(*(mean or (0.0, 0.0, 0.0)))
        std_arr = (ctypes.c_float * 3)(*(std or (1.0, 1.0, 1.0)))
        nthreads = num_threads or min(os.cpu_count() or 8, 16)
        self._h_ptr = lib.mxio_create(
            rec_path.encode(), batch_size, h, w, resize,
            int(rand_crop), int(rand_mirror), int(shuffle),
            label_width, int(self._nchw), mean_arr, std_arr,
            seed, nthreads)
        if not self._h_ptr:
            raise IOError("cannot open record file %r" % rec_path)

    @property
    def num_records(self):
        return self._lib.mxio_num_records(self._h_ptr)

    def reset(self):
        self._lib.mxio_reset(self._h_ptr)

    def next_batch(self):
        """Returns (data, label) with the actual sample count, or None at
        epoch end. Fresh buffers per batch — safe to hand to device_put."""
        from .. import fault
        fault.maybe_slow("io.slow")
        fault.maybe_raise("io.read", exc_type=fault.InjectedIOError)
        shape = ((self._batch, 3, self._h, self._w) if self._nchw
                 else (self._batch, self._h, self._w, 3))
        label = _np.empty((self._batch, self._label_width), _np.float32)
        if self._u8:
            data = _np.empty(shape, _np.uint8)
            n = self._lib.mxio_next_u8(
                self._h_ptr,
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                label.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        else:
            data = _np.empty(shape, _np.float32)
            n = self._lib.mxio_next(
                self._h_ptr,
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                label.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n == 0:
            return None
        if n < self._batch:
            data = data[:n]
            label = label[:n]
        return data, label

    def __iter__(self):
        while True:
            b = self.next_batch()
            if b is None:
                return
            yield b

    def close(self):
        """Release the native reader handle (idempotent)."""
        if getattr(self, "_h_ptr", None):
            self._lib.mxio_destroy(self._h_ptr)
            self._h_ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
