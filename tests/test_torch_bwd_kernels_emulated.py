"""PyTorch port: the flash-attention backward kernels' CUDA source run on
the CPU, under an emulation of the CUDA pieces it uses.

`ops/csrc/flash_attention_bwd.cu` is compiled with the host C++ compiler
against `tests/cuda_emulation.h`: its inline-asm helpers (cp.async,
ldmatrix, mma.sync) give way to the header's emulated warp collectives
and its launches to `emu::launch` (a block's CUDA threads as cooperative
threads of one host thread); the
rest of the source (tiles, fragment layouts, masks, the 3xTF32 split, the
double-buffered loop) runs as written.  Its C entry points then take CPU
pointers and are held against the plain versions with the tolerances
chip_smoke.py holds the kernels to on the card.  This checks the kernels'
logic; whether nvcc takes the source, and how fast it runs, only the card
shows (tests/test_torch_cuda.py, chip_smoke.py).

Not covered here: the ordering of the two tile buffers.  The emulated
cp.async copies at once and its waits do nothing, so a missing wait or
__syncthreads between a tile's copy and its use would still pass here;
the card's parity and determinism tests (tests/test_torch_cuda.py) check
that ordering.  The rewrite reads the source and its local headers as
text: each `__device__ __forceinline__` helper (optionally after a
`template <...> ` on the same line) either fits on its line or closes
with a `}` line of its own, dynamic shared memory is one
`extern __shared__ ... smem[];` per kernel, and every launch is written
`kernel<<<grid, threads, smem, stream>>>(...);`.  `_emulated_source` and
`build_emulated` serve tests/test_torch_kernels_emulated.py too.
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.ops import _kernels
from incubator_mxnet_tpu_torch.ops import attention as tatt
from chip_smoke import _low_tolerance

pytestmark = pytest.mark.torch_port

HEADER = Path(__file__).resolve().parent / "cuda_emulation.h"


_HELPER = re.compile(r"(template <[^>]*> )?__device__ __forceinline__")


def _inline_headers(path, seen):
    """The text of `path` with each local `#include "x.cuh"` replaced by
    that header's text (itself inlined), each header once.  A local
    include is what `_kernels.local_headers` hashes (`_kernels._INCLUDE`)."""
    out = []
    for line in path.read_text().split("\n"):
        m = _kernels._INCLUDE.match(line)
        if m is None:
            out.append(line)
            continue
        hdr = (path.parent / m.group(1)).resolve()
        if hdr not in seen:
            seen.add(hdr)
            out.append(_inline_headers(hdr, seen))
    return "\n".join(line for line in out if line.strip() != "#pragma once")


def _emulated_source(path):
    """The kernel source at `path` (a `csrc/` file), its local headers
    inlined, with its asm helpers dropped (the emulation header defines
    them) and each `kernel<<<grid, threads, smem, stream>>>(...)` turned
    into an emu::launch."""
    lines, out, i = _inline_headers(path, set()).split("\n"), [], 0
    while i < len(lines):
        if _HELPER.match(lines[i]):
            j = i
            if not lines[i].rstrip().endswith("}"):
                if "}" not in lines[i:]:
                    raise ValueError(
                        "the emulation's rewrite expects each "
                        "`__device__ __forceinline__` helper to close with "
                        "a `}` line of its own; none follows line %d of "
                        "%s with its headers" % (i + 1, path.name))
                j = lines.index("}", i)
            if "asm" in "\n".join(lines[i:j + 1]):
                i = j + 1
                continue
        out.append(lines[i])
        i += 1
    src = "\n".join(out)
    src = src.replace("#include <cuda_runtime.h>",
                      '#include "%s"' % HEADER.name)
    src = src.replace("#include <cuda_bf16.h>", "")
    src = src.replace("#include <cuda_fp16.h>", "")
    for pattern, repl, marker, what in (
            (r"extern __shared__[^;]*\bsmem\[\];",
             "unsigned char* smem = emu::smem;", "extern __shared__",
             "`extern __shared__ ... smem[];`"),
            (r"(\w+)<<<([^,]+), ([^,]+), ([^,]+), [^>]+>>>\((.*?)\);",
             r"emu::launch(\2, \3, \4, [&] { \1(\5); });", "<<<",
             "`kernel<<<grid, threads, smem, stream>>>(...);`")):
        found = src.count(marker)
        src, n = re.subn(pattern, repl, src, flags=re.S)
        if n != found or (n == 0 and marker == "<<<"):
            raise ValueError(
                "the emulation's rewrite expects every launch as %s, and "
                "turned %d of %d in %s: bring _emulated_source up to date "
                "with the source's layout" % (what, n, found, path.name))
    return src


def build_emulated(name, work, defines=()):
    """Kernel library `name` of `_kernels.SOURCES` built for the CPU in
    directory `work`, its C entry points bound as on the card; `defines`
    are `NAME=value` macros passed as `-D` (a source's tunable constants,
    lowered to reach their edge cases at small sizes)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++) to build the emulation")
    cu, fns = _kernels.SOURCES[name]
    src = work / (name + ".cpp")
    src.write_text(_emulated_source(_kernels._CSRC / cu))
    lib = work / ("lib%s.so" % name)
    build = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-w",
         "-I", str(HEADER.parent)] + ["-D" + d for d in defines]
        + ["-o", str(lib), str(src)],
        capture_output=True, text=True)
    assert build.returncode == 0, build.stderr
    so = ctypes.CDLL(str(lib))
    for fn, (argtypes, restype) in fns.items():
        getattr(so, fn).argtypes = argtypes
        getattr(so, fn).restype = restype
    return so


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The backward kernels' C entry points, built for the CPU."""
    return build_emulated("flash_attention_bwd",
                          tmp_path_factory.mktemp("emulated"))


def _tolerance(ref, dtype):
    """chip_smoke.py's `_grad_tolerance`: f32 within 1e-4 of the largest
    |ref|; bf16 and f16 within 4 u (|ref| + rms(ref)), u their unit
    roundoff, at least 2 ulps of each element."""
    if dtype == torch.float32:
        return torch.full_like(ref, 1e-4 * ref.abs().max().item())
    return _low_tolerance(ref, str(dtype).replace("torch.", ""))


# T = 77: two key tiles and two query tiles of 64 (three of 32 for dK/dV
# at d = 128), the last one ragged
@pytest.mark.parametrize("d", tatt.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_emulated_bwd_kernels_match_plain_version(emulated, d, dtype,
                                                  causal):
    BH, T = 2, 77
    rs = np.random.RandomState(d)
    q, k, v, do = (torch.from_numpy(rs.randn(BH, T, d).astype(np.float32)
                                    * 0.5).to(dtype) for _ in range(4))
    scale = d ** -0.5
    out, lse = tatt.flash_attention_fwd_plain(q, k, v, scale, causal)
    dq, dk, dv = (torch.full_like(q, float("nan")) for _ in range(3))
    delta = torch.full((BH, T), float("nan"))
    code = tatt._KERNEL_DTYPES[dtype]
    assert emulated.mxt_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), delta.data_ptr(),
        BH, T, d, scale, int(causal), code, None) == 0
    assert emulated.mxt_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        BH, T, d, scale, int(causal), code, None) == 0
    ref_dq, ref_delta = tatt.flash_attention_bwd_dq_plain(
        q, k, v, out, lse, do, scale, causal)
    ref_dk, ref_dv = tatt.flash_attention_bwd_dkv_plain(
        q, k, v, do, lse, delta, scale, causal)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        ref = ref.float()
        assert bool(((got.float() - ref).abs()
                     <= _tolerance(ref, dtype)).all())
    assert (delta - ref_delta).abs().max().item() <= \
        1e-4 * max(ref_delta.abs().max().item(), 1.0)


def test_emulated_bwd_kernels_refuse_what_they_do_not_take(emulated):
    # a head dim or dtype without an instance: cudaErrorInvalidValue, and
    # nothing written
    x = torch.zeros(1, 16, 48)
    for d, code in ((48, 0), (64, 3)):
        assert emulated.mxt_flash_attention_bwd_dq(
            *(x.data_ptr(),) * 8, 1, 16, d, 0.1, 0, code, None) == 1
        assert emulated.mxt_flash_attention_bwd_dkv(
            *(x.data_ptr(),) * 8, 1, 16, d, 0.1, 0, code, None) == 1
    assert bool((x == 0).all())
