"""PyTorch port: the fused 1x1-conv + BatchNorm-statistics kernel's and the
flash-attention forward kernel's CUDA sources run on the CPU, under the
emulation of tests/cuda_emulation.h (built as in
test_torch_bwd_kernels_emulated.py), and held against their plain versions
(and a 16-bit y, as the plain version's, against the exact product) with the
tolerances chip_smoke.py holds the kernels to on the card.

As there, this checks the kernels' logic (tiles, fragment layouts, masks,
whole-image slabs, the ring of stages, the statistics' fixed-order sums and
the mma's rounding toward zero); whether nvcc takes the source, the
ordering of the cp.async stages and the speed only the card shows
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import shutil

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu_torch.ops import _kernels
from incubator_mxnet_tpu_torch.ops import attention as tatt
from incubator_mxnet_tpu_torch.ops import conv_stats as tcs
import chip_smoke
from chip_smoke import CONV_SUM_TOL, TOL
from test_torch_bwd_kernels_emulated import build_emulated

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module")
def conv_lib(tmp_path_factory):
    return build_emulated("conv1x1_stats", tmp_path_factory.mktemp("conv"))


def _conv_inputs(N, C, HW, O, dtype, seed=0):
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(N, C, HW).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rs.randn(O, C) * 0.05).astype(np.float32)) \
        .to(dtype)
    return x, w


def _conv_emulated(lib, x, w):
    N, C, HW = x.shape
    O = w.shape[0]
    code = tcs._KERNEL_DTYPES[x.dtype]
    y = torch.full((N, O, HW), float("nan"), dtype=x.dtype)
    s1, s2 = (torch.full((1, O), float("nan")) for _ in range(2))
    scratch = torch.full(
        (lib.mxt_conv1x1_stats_scratch(N, C, HW, O, code),), float("nan"))
    assert lib.mxt_conv1x1_stats(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), scratch.data_ptr(),
        s1.data_ptr(), s2.data_ptr(), N, C, HW, O, code, None) == 0
    return y, s1, s2


def _conv_errors(x, w, y, s1, s2):
    """({kernel[, plain]}: largest y error over its tolerance, relative s1
    and s2 errors against the plain version), as chip_smoke.py measures
    them: f32 y within 1e-4 of the largest |plain|; a 16-bit y, the kernel's
    and the plain version's, within `conv1x1_y_bound` of the exact
    product; s1 relative to sqrt(N·HW·Σy²), s2 to itself."""
    N, _, HW = x.shape
    ref_y, ref_s1, ref_s2 = tcs.fused_conv1x1_stats_plain(x, w)
    err_y = chip_smoke.conv_y_errors(torch, tcs, x, w, y, ref_y)
    rel_s1 = ((s1 - ref_s1).abs()
              / (N * HW * ref_s2).sqrt().clamp_min(1e-30)).max().item()
    rel_s2 = ((s2 - ref_s2).abs() / ref_s2.clamp_min(1e-30)).max().item()
    return err_y, rel_s1, rel_s2


def test_every_resnet_step_shape_takes_the_tensor_cores(conv_lib):
    for C, HW, O, _ in tcs.RESNET_CONV_SHAPES:
        for code in (1, 2):             # bf16, f16
            path = conv_lib.mxt_conv1x1_stats_path(128, C, HW, O, code)
            assert tcs.PATHS[path] in ("tensor_cores_rows",
                                       "tensor_cores_slabs"), (C, HW, O)
    # f32, and bf16 or f16 with C not a multiple of 32: the CUDA cores
    assert conv_lib.mxt_conv1x1_stats_path(128, 64, 3136, 256, 0) == 0
    assert conv_lib.mxt_conv1x1_stats_path(3, 72, 49, 80, 1) == 0
    assert conv_lib.mxt_conv1x1_stats_path(3, 72, 49, 80, 2) == 0


# (N, C, HW, O, dtype, instance): HW 49 and 196 (rows not 16-byte
# aligned: whole-image slabs; 3 images of 49 leave a tile of 4 part
# empty), aligned rows with a ragged last column tile and O tile, ragged
# C on the CUDA cores, f32, and f16 on each instance
CONV_CASES = [
    (2, 64, 49, 64, torch.bfloat16, "tensor_cores_slabs"),
    (3, 64, 49, 128, torch.bfloat16, "tensor_cores_slabs"),
    (2, 64, 196, 128, torch.bfloat16, "tensor_cores_slabs"),
    (3, 64, 40, 136, torch.bfloat16, "tensor_cores_rows"),
    (3, 72, 49, 80, torch.bfloat16, "cuda_cores"),
    (5, 17, 33, 65, torch.bfloat16, "cuda_cores"),
    (2, 24, 10, 9, torch.float32, "cuda_cores"),
    (2, 64, 49, 64, torch.float16, "tensor_cores_slabs"),
    (2, 64, 196, 128, torch.float16, "tensor_cores_slabs"),
    (3, 64, 40, 136, torch.float16, "tensor_cores_rows"),
    (5, 17, 33, 65, torch.float16, "cuda_cores"),
]


@pytest.mark.parametrize("N,C,HW,O,dtype,path", CONV_CASES)
def test_emulated_conv_kernel_matches_plain_version(conv_lib, N, C, HW, O,
                                                    dtype, path):
    assert tcs.PATHS[conv_lib.mxt_conv1x1_stats_path(
        N, C, HW, O, tcs._KERNEL_DTYPES[dtype])] == path
    x, w = _conv_inputs(N, C, HW, O, dtype)
    y, s1, s2 = _conv_emulated(conv_lib, x, w)
    err_y, rel_s1, rel_s2 = _conv_errors(x, w, y, s1, s2)
    assert max(err_y.values()) <= 1.0 and rel_s1 <= CONV_SUM_TOL \
        and rel_s2 <= CONV_SUM_TOL, (err_y, rel_s1, rel_s2)


def test_emulated_conv_kernel_sums_hold_at_2048_channels(conv_lib):
    # a long k loop on the tensor cores, one accumulator for every mma:
    # the mma rounds toward zero, so |y| can shrink by up to C/16 ulps and
    # Σy² by twice that (1.5e-5 at C 2048, beyond CONV_SUM_TOL); on random
    # data the shrinkage stays within it, against the plain version and
    # against the exact (f64) Σy²; y stays within its bound
    N, C, HW, O = 1, 2048, 49, 64
    x, w = _conv_inputs(N, C, HW, O, torch.bfloat16, seed=3)
    y, s1, s2 = _conv_emulated(conv_lib, x, w)
    err_y, rel_s1, rel_s2 = _conv_errors(x, w, y, s1, s2)
    exact = (w.double() @ x.double()[0]).pow(2).sum(dim=1)
    rel_exact = ((s2[0].double() - exact).abs() / exact).max().item()
    assert max(err_y.values()) <= 1.0 and rel_s1 <= CONV_SUM_TOL \
        and rel_s2 <= CONV_SUM_TOL and rel_exact <= CONV_SUM_TOL, \
        (err_y, rel_s1, rel_s2, rel_exact)


def test_a_dropped_channel_fails_the_sums_check(conv_lib):
    # a kernel that skipped one input channel: y moves by w_oc x_cp, within
    # the elementwise y bound at most elements of a long sum over C, but
    # Σy² moves by about 1/C of itself, far beyond CONV_SUM_TOL
    N, C, HW, O = 1, 2048, 49, 16
    x, w = _conv_inputs(N, C, HW, O, torch.bfloat16, seed=4)
    dropped = x.clone()
    dropped[:, 777] = 0
    _, _, rel_s2 = _conv_errors(x, w, *_conv_emulated(conv_lib, dropped, w))
    assert rel_s2 > 10 * CONV_SUM_TOL, rel_s2


@pytest.fixture(scope="module")
def fwd_lib(tmp_path_factory):
    return build_emulated("flash_attention_fwd",
                          tmp_path_factory.mktemp("fwd"))


# T = 77: two key tiles and two query tiles of 64, the last one ragged
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("causal", [False, True])
def test_emulated_fwd_kernel_matches_plain_version(fwd_lib, d, dtype,
                                                   causal):
    BH, T = 2, 77
    rs = np.random.RandomState(d)
    q, k, v = (torch.from_numpy(rs.randn(BH, T, d).astype(np.float32)
                                * 0.5).to(dtype) for _ in range(3))
    scale = d ** -0.5
    out = torch.full_like(q, float("nan"))
    lse = torch.full((BH, T), float("nan"))
    assert fwd_lib.mxt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), BH, T, d, scale, int(causal),
        tatt._KERNEL_DTYPES[dtype], None) == 0
    ref_out, ref_lse = tatt.flash_attention_fwd_plain(q, k, v, scale, causal)
    ref = ref_out.float()
    # chip_smoke.py's: f32 within TOL; in 16 bits both outputs rounded,
    # P rounded against the running max in the kernel and the final max
    # in the plain version: 4 u (|ref| + rms(ref)), at least 2 ulps
    tol = chip_smoke._out_tolerance(torch, ref,
                                    str(dtype).replace("torch.", ""))
    assert bool(((out.float() - ref).abs() <= tol).all())
    assert (lse - ref_lse).abs().max().item() <= TOL


def test_emulated_fwd_kernel_refuses_what_it_does_not_take(fwd_lib):
    # a head dim or dtype without an instance: cudaErrorInvalidValue, and
    # nothing written
    x = torch.zeros(1, 16, 48)
    for d, code in ((48, 0), (64, 3)):
        assert fwd_lib.mxt_flash_attention_fwd(
            *(x.data_ptr(),) * 5, 1, 16, d, 0.1, 0, code, None) == 1
    assert bool((x == 0).all())


def test_editing_a_shared_header_renames_the_libraries_that_include_it(
        tmp_path, monkeypatch):
    # a library's name hashes its source and every local header it
    # includes, so an edited header is rebuilt and never loaded stale
    csrc = tmp_path / "csrc"
    shutil.copytree(_kernels._CSRC, csrc)
    monkeypatch.setattr(_kernels, "_CSRC", csrc)

    def names():
        return {n: _kernels._lib_path(n)[1].name for n in _kernels.SOURCES}

    assert [h.name for h in _kernels.local_headers(
        csrc / "flash_attention_bwd.cu")] == ["flash_tiles.cuh",
                                              "mma_sm90.cuh"]
    before = names()
    with open(csrc / "flash_tiles.cuh", "a") as f:
        f.write("// edited\n")
    after_tiles = names()
    assert after_tiles["conv1x1_stats"] == before["conv1x1_stats"]
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        assert after_tiles[name] != before[name]
    with open(csrc / "mma_sm90.cuh", "a") as f:
        f.write("// edited\n")
    after_mma = names()
    assert all(after_mma[n] != after_tiles[n] for n in _kernels.SOURCES)


def test_emulated_fwd_kernel_output_has_no_one_sided_drift(fwd_lib):
    # the mma rounds its sums toward zero.  With O's accumulator fed back
    # into every mma, O shrinks by 4.6e-6 of itself at T = 512, one way in
    # every row, and the backward's D = rowsum(dO O) stops matching
    # rowsum(P dP); folded per k step, by half an ulp (4e-8).  Measured as
    # O's projection on the exact (f64) output.
    BH, T, d = 1, 512, 16
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(BH, T, d).astype(np.float32) * 0.5)
               for _ in range(3))
    out = torch.full_like(q, float("nan"))
    lse = torch.full((BH, T), float("nan"))
    assert fwd_lib.mxt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), BH, T, d, d ** -0.5, 0, 0, None) == 0
    s = q.double() @ k.double().transpose(-1, -2) * d ** -0.5
    exact = torch.softmax(s, -1) @ v.double()
    drift = ((out.double() - exact) * exact).sum() / exact.pow(2).sum()
    assert abs(drift.item()) <= 5e-7, drift.item()
