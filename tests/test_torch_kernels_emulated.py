"""PyTorch port: the fused 1x1-conv + BatchNorm-statistics kernel's, the
flash-attention forward kernel's and the greedy NMS kernel's CUDA
sources run on the CPU, under the
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
from incubator_mxnet_tpu_torch.ops import nms as tnms
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
    # every source but the NMS kernel's includes mma_sm90.cuh
    assert _kernels.local_headers(csrc / "nms.cu") == []
    assert after_mma["nms"] == before["nms"]
    assert all(after_mma[n] != after_tiles[n] for n in _kernels.SOURCES
               if n != "nms")


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


@pytest.fixture(scope="module")
def nms_lib(tmp_path_factory):
    return build_emulated("nms", tmp_path_factory.mktemp("nms"))


# what the scratch holds before a call: a word no row of the tests writes
SCRATCH_FILL = 0x5A5A5A5A5A5A5A5A


def _nms_emulated(lib, boxes, valid, thresh, cls=None, plus_one=False,
                  topk=0, positions_only=False, scratch=None):
    """(keep, idx) of the emulated kernel (keep None with
    `positions_only`); `scratch`, where given, is the (B, words) tensor
    the call uses, filled with SCRATCH_FILL here."""
    B, N, _ = boxes.shape
    # held here: a copy made inside the call's arguments is freed before it
    boxes, cls, valid = (None if t is None else t.contiguous()
                         for t in (boxes, cls, valid))
    words = lib.mxt_nms_mask_words(N)
    if scratch is None:
        scratch = torch.empty((B, words), dtype=torch.long)
    assert tuple(scratch.shape) == (B, words)
    scratch.fill_(SCRATCH_FILL)
    keep = None if positions_only else torch.full((B, N), 7,
                                                  dtype=torch.uint8)
    idx = torch.full((B, max(topk, 1)), 12345, dtype=torch.long)
    assert lib.mxt_nms(
        boxes.data_ptr(), 0 if cls is None else cls.data_ptr(),
        0 if valid is None else valid.data_ptr(),
        scratch.data_ptr(), 0 if keep is None else keep.data_ptr(),
        idx.data_ptr(), B, N, thresh, int(plus_one), topk, None) == 0
    return None if keep is None else keep.bool(), idx[:, :topk]


def _nms_boxes(B, N, scale, seed, ties=False):
    rs = np.random.RandomState(seed)
    ctr = rs.rand(B, N, 2) * scale * 0.3
    wh = rs.rand(B, N, 2) * scale * 0.5 + 1
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1)
    if ties:        # repeated boxes: IoU exactly 1, and exact ties
        boxes[:, 1::3] = boxes[:, 0:-1:3][:, :boxes[:, 1::3].shape[1]]
    return torch.from_numpy(boxes.astype(np.float32))


# (B, N, convention, class-aware, with valid flags, topk, ties): one chunk
# of 64 and ragged chunks past it, Proposal's +1 convention with its topk
# and box_nms' corner one, class-aware, with valid flags and with repeated
# boxes
NMS_CASES = [(2, 40, True, False, False, 16, False),
             (2, 200, True, False, False, 50, False),
             (1, 130, True, False, False, 200, True),
             (3, 150, False, True, True, 0, False),
             (2, 64, False, False, True, 0, True),
             (2, 129, False, True, False, 0, True)]


@pytest.mark.parametrize("B,N,plus_one,aware,flags,topk,ties", NMS_CASES)
def test_emulated_nms_kernel_matches_plain_version(nms_lib, B, N, plus_one,
                                                   aware, flags, topk, ties):
    """The mask and scan launches give exactly the plain version's keep
    flags (and first `topk` kept positions, -1 after)."""
    rs = np.random.RandomState(N)
    boxes = _nms_boxes(B, N, 60.0, seed=N + B, ties=ties)
    cls = torch.from_numpy(rs.randint(0, 3, (B, N)).astype(np.float32)) \
        if aware else None
    valid = torch.from_numpy(rs.rand(B, N) > 0.25) if flags else None
    for thresh in (0.3, 0.7):
        keep, idx = _nms_emulated(nms_lib, boxes, valid, thresh, cls,
                                  plus_one, topk)
        ref = tnms.nms_sorted_plain(boxes, valid, thresh, cls, plus_one,
                                    topk)
        ref_keep = ref[0] if topk else ref
        assert torch.equal(keep, ref_keep), (thresh, plus_one)
        assert 0 < int(keep.sum()) < B * N
        if topk:
            assert torch.equal(idx, ref[1])


def test_emulated_nms_kernel_refuses_too_many_images(nms_lib):
    x = torch.zeros(1, 1, 4)
    assert nms_lib.mxt_nms(x.data_ptr(), 0, 0, x.data_ptr(), x.data_ptr(),
                           0, 70000, 1, 0.5, 0, 0, None) == 1


@pytest.mark.parametrize("plus_one,boxes", [
    (False, [[0, 0, 2, 2], [0, 0, 2, 1]]),
    (True, [[0, 0, 1, 1], [0, 0, 1, 0]])])
def test_emulated_nms_kernel_keeps_a_box_at_exactly_the_threshold(
        nms_lib, plus_one, boxes):
    """IoU exactly 0.5 does not suppress at thresh 0.5 (`iou > thresh`,
    as the JAX ops decide); below the IoU, the threshold does."""
    b = torch.tensor([boxes], dtype=torch.float32)
    iou = (tnms.iou_plus_one if plus_one else tnms.iou_corner)(b[0], b[0])
    assert iou[0, 1].item() == 0.5
    for thresh, want in ((0.5, [True, True]), (0.45, [True, False])):
        keep, _ = _nms_emulated(nms_lib, b, None, thresh, plus_one=plus_one)
        assert keep[0].tolist() == want
        assert torch.equal(keep, tnms.nms_sorted_plain(b, None, thresh,
                                                       plus_one=plus_one))


def _triangle_words(N):
    """Words of an image's mask triangle: chunk r of 64 rows holds the
    words r..nb-1 of its rows, the last chunk N - 64 (nb - 1) rows."""
    nb = -(-N // 64)
    return 64 * ((nb - 1) * nb - (nb - 1) * (nb - 2) // 2) + N - 64 * (nb - 1)


def _sparse_flags(kind, B, N, rs):
    """"prefix": each image's first 8-12 % of boxes take part, a long
    invalid tail after; "none": no box does; "interleaved": every other
    box and a random third of the rest, none in the last tenth."""
    if kind == "prefix":
        ends = rs.randint(N * 8 // 100, N * 12 // 100 + 1, B)
        return torch.from_numpy(np.arange(N)[None, :] < ends[:, None])
    if kind == "none":
        return torch.zeros(B, N, dtype=torch.bool)
    flags = (np.arange(N) % 2 == 0)[None, :] | (rs.rand(B, N) < 0.33)
    flags[:, N - N // 10:] = False
    return torch.from_numpy(flags)


# (B, N, convention, class-aware, flags, topk): a long invalid tail, no
# box at all, and flags that are no prefix, each way and with its topk
SPARSE_NMS_CASES = [(2, 300, False, True, "prefix", 0),
                    (3, 300, True, False, "prefix", 20),
                    (3, 200, False, False, "none", 10),
                    (2, 300, False, True, "interleaved", 0),
                    (2, 300, True, False, "interleaved", 40)]


@pytest.mark.parametrize("B,N,plus_one,aware,flags,topk", SPARSE_NMS_CASES)
def test_emulated_nms_kernel_matches_plain_version_on_sparse_flags(
        nms_lib, B, N, plus_one, aware, flags, topk):
    """Exactly the plain version's keep flags and positions where few or
    no boxes take part, and no mask word written for a row or column at
    or past n_eff (one past the last box that takes part): with every
    box that takes part in the first chunk, only that chunk's rows below
    n_eff are written, and the flag words."""
    rs = np.random.RandomState(N + B)
    boxes = _nms_boxes(B, N, 60.0, seed=N, ties=True)
    cls = torch.from_numpy(rs.randint(0, 3, (B, N)).astype(np.float32)) \
        if aware else None
    valid = _sparse_flags(flags, B, N, rs)
    tri, nb = _triangle_words(N), -(-N // 64)
    for thresh in (0.3, 0.7):
        scratch = torch.empty((B, nms_lib.mxt_nms_mask_words(N)),
                              dtype=torch.long)
        keep, idx = _nms_emulated(nms_lib, boxes, valid, thresh, cls,
                                  plus_one, topk, scratch=scratch)
        ref = tnms.nms_sorted_plain(boxes, valid, thresh, cls, plus_one,
                                    topk)
        ref_keep = ref[0] if topk else ref
        assert torch.equal(keep, ref_keep), (thresh, plus_one)
        if topk:
            assert torch.equal(idx, ref[1])
        if flags == "none":
            assert not bool(keep.any()) and bool((idx == -1).all())
        elif flags == "prefix":
            assert 0 < int(keep.sum())
        written = scratch[:, :tri] != SCRATCH_FILL
        for b in range(B):
            n_eff = int(valid[b].nonzero().max()) + 1 if valid[b].any() \
                else 0
            if flags != "interleaved":
                want = torch.zeros(tri, dtype=torch.bool)
                want[:n_eff] = True
                assert n_eff <= 64 and torch.equal(written[b], want), b
        assert bool((scratch[:, tri:tri + nb] != SCRATCH_FILL).any()) \
            or flags == "none"


@pytest.mark.parametrize("plus_one,flags", [(True, None),
                                            (False, "interleaved")])
@pytest.mark.parametrize("topk", [6, 1000])
def test_emulated_nms_kernel_positions_only(nms_lib, plus_one, flags, topk):
    """Without keep flags the kernel writes the first `topk` kept
    positions, -1 after, as the plain version's positions-only mode and
    its full pass do: `topk` reached in the first chunk (the scan ends
    there), and never reached."""
    B, N = 2, 260
    rs = np.random.RandomState(topk)
    boxes = _nms_boxes(B, N, 60.0, seed=topk, ties=True)
    valid = None if flags is None else _sparse_flags(flags, B, N, rs)
    for thresh in (0.3, 0.7):
        keep, idx = _nms_emulated(nms_lib, boxes, valid, thresh,
                                  plus_one=plus_one, topk=topk,
                                  positions_only=True)
        ref = tnms.nms_sorted_plain(boxes, valid, thresh, None, plus_one,
                                    topk, positions_only=True)
        full = tnms.nms_sorted_plain(boxes, valid, thresh, None, plus_one,
                                     topk)
        assert keep is None and torch.equal(idx, ref) \
            and torch.equal(ref, full[1])
        assert bool((idx >= 0).all()) if topk == 6 \
            else bool((idx == -1).any())


@pytest.fixture(scope="module")
def nms_slab_lib(tmp_path_factory):
    # slabs of 4 words of 64 rows: at N 700 (11 chunks) the first chunks'
    # words come in three slabs
    return build_emulated("nms", tmp_path_factory.mktemp("nms_slab"),
                          defines=("MXT_NMS_SLAB_BYTES=2048",))


@pytest.mark.parametrize("plus_one,aware,flags,topk,positions_only", [
    (False, True, None, 0, False), (True, False, "interleaved", 300, False),
    (True, False, None, 300, True), (False, False, "prefix", 0, False)])
def test_emulated_nms_kernel_streams_rows_in_slabs(
        nms_slab_lib, plus_one, aware, flags, topk, positions_only):
    """A chunk's row words wider than one slab are streamed in several,
    through both buffers, with the same result as the plain version."""
    B, N = 2, 700
    rs = np.random.RandomState(7)
    boxes = _nms_boxes(B, N, 60.0, seed=11)
    cls = torch.from_numpy(rs.randint(0, 3, (B, N)).astype(np.float32)) \
        if aware else None
    valid = None if flags is None else _sparse_flags(flags, B, N, rs)
    if flags == "prefix":
        valid = torch.from_numpy(np.arange(N) < 600)[None].expand(B, N)
    for thresh in (0.3, 0.7):
        keep, idx = _nms_emulated(nms_slab_lib, boxes, valid, thresh, cls,
                                  plus_one, topk, positions_only)
        ref = tnms.nms_sorted_plain(boxes, valid, thresh, cls, plus_one,
                                    topk, positions_only)
        if positions_only:
            assert torch.equal(idx, ref)
            continue
        ref_keep = ref[0] if topk else ref
        assert torch.equal(keep, ref_keep) and 0 < int(keep.sum()) < B * N
        if topk:
            assert torch.equal(idx, ref[1])


def test_emulated_nms_scratch_is_at_most_the_full_mask(nms_lib):
    """An image's scratch (the mask triangle and its flag words) is at
    most the N x ceil(N / 64) words of a full mask past two chunks, and
    about half of it at SSD-512's 24,564 anchors."""
    for N in (129, 200, 2000, 4096, 24564):
        nb = -(-N // 64)
        words = nms_lib.mxt_nms_mask_words(N)
        assert _triangle_words(N) + nb <= words <= N * nb, N
    assert nms_lib.mxt_nms_mask_words(24564) / (24564 * 384) < 0.51


def test_nms_bound_counts_only_the_boxes_that_take_part():
    """chip_smoke's NMS bound reads every flag and writes every keep flag,
    but reads the boxes and class ids of the boxes that take part only
    (up to `upto` where given), and counts their pairs, by class where
    the pass is class-aware."""
    B, N = 2, 300
    valid = torch.zeros(B, N, dtype=torch.bool)
    valid[0, :10] = True
    valid[1, [0, 5, 250]] = True
    cls = torch.zeros(B, N)
    cls[0, :4] = 1.0                    # classes of image 0: 4 ones, 6 zeros
    inp = dict(boxes=torch.zeros(B, N, 4), valid=valid, cls=cls)
    got = chip_smoke._nms_bound(inp, 0)
    assert got["bytes"] == B * N * 2 + 13 * 20
    assert got["pairs"] == 6 + 15 + 3
    assert got["bound_by"] == "bytes"
    every = dict(boxes=inp["boxes"], valid=None, cls=None)
    assert chip_smoke._nms_bound(every, 5, keep_out=False, upto=[7, 300])[
        "bytes"] == (7 + 300) * 16 + B * 5 * 8
    assert chip_smoke._nms_bound(every, 0)["pairs"] == B * N * (N - 1) // 2


@pytest.mark.parametrize("plus_one", [False, True])
def test_emulated_nms_kernel_decides_as_the_division_near_the_threshold(
        nms_lib, plus_one):
    """The kernel decides IoU > thresh from the product thresh x union
    where the two are far apart and from the division near the
    threshold: for thresholds at each pair's IoU, one ulp and 2^-21 and
    2^-19 of it either side, its flags are the plain version's."""
    boxes = _nms_boxes(1, 40, 30.0, seed=5)
    iou = (tnms.iou_plus_one if plus_one else tnms.iou_corner)(boxes[0],
                                                               boxes[0])
    pairs = [(i, j) for i in range(40) for j in range(i + 1, 40)
             if 0.05 < float(iou[i, j]) < 0.95][:6]
    assert len(pairs) == 6
    for i, j in pairs:
        two = boxes[:, [i, j]]
        v = iou[i, j].reshape(1)
        for thresh in (v, torch.nextafter(v, v + 1), torch.nextafter(v, v - 1),
                       v * (1 + 2 ** -21), v * (1 - 2 ** -21),
                       v * (1 + 2 ** -19), v * (1 - 2 ** -19)):
            t = float(thresh.float())
            keep, _ = _nms_emulated(nms_lib, two, None, t, plus_one=plus_one)
            assert torch.equal(keep, tnms.nms_sorted_plain(
                two, None, t, plus_one=plus_one)), (i, j, t)
