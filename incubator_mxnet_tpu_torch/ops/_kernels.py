"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` with a plain C interface.  It is
compiled by `nvcc` for `sm_90a` into a shared library under the
checkout's `build/kernels/` at first use and loaded with `ctypes`.  The
library's file name carries a hash of its source, so an edited source is
rebuilt and a stale library is never loaded.  Nothing here runs at
import time: a machine without `nvcc` imports the package and uses the
plain PyTorch versions on CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..base import MXNetError

__all__ = ["SOURCES", "build_all", "library"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: kernel library name -> (source file, {C function: (argtypes, restype)})
SOURCES = {
    "flash_attention_fwd": ("flash_attention_fwd.cu", {
        "mxt_flash_attention_fwd": (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int),
    }),
    "flash_attention_bwd": ("flash_attention_bwd.cu", {
        "mxt_flash_attention_bwd_dq": (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int),
        "mxt_flash_attention_bwd_dkv": (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
            ctypes.c_int),
    }),
    "conv1x1_stats": ("conv1x1_stats.cu", {
        "mxt_conv1x1_stats_scratch": ([ctypes.c_int] * 3, ctypes.c_longlong),
        "mxt_conv1x1_stats": (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
            ctypes.c_int),
    }),
}

_LOCK = threading.Lock()
_LIBS = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError(
        "nvcc not found (looked on PATH and in %s/bin); the CUDA kernels "
        "are built from source at first use on a CUDA host" % home)


def _lib_path(name):
    src = _CSRC / SOURCES[name][0]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return src, _BUILD / ("lib%s-%s.so" % (name, digest))


def _command(src, out):
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-o", str(out), str(src)]


def build_all(names=None):
    """Compile every missing kernel library, one `nvcc` per source, all
    started together.  Returns {name: ptxas report} for what was built
    (empty for libraries already on disk).  Raises on a failed build."""
    names = list(SOURCES if names is None else names)
    _BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in names:
            src, out = _lib_path(name)
            if out.exists():
                continue
            # build into a private name, then rename: a second process
            # building the same source never loads a half-written file
            tmp = out.with_suffix(".%d.tmp" % os.getpid())
            procs[name] = (subprocess.Popen(
                _command(src, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, out)
        reports = {}
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise MXNetError("nvcc failed for %s (exit %d):\n%s"
                                 % (name, proc.returncode, log))
            os.replace(tmp, out)
            reports[name] = log
        return reports
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def library(name):
    """The loaded ctypes library of kernel `name`, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        _, path = _lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        for fn, (argtypes, restype) in SOURCES[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
        return lib
