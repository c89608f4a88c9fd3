#!/usr/bin/env python3
"""Accuracy and cost of the tensor-core conv and forward kernels on the card.

Run from the repo root on a CUDA host: `python3 tc_precision_study.py`.
It prints one JSON object per line:

* `conv`: at each of the 12 bf16 shapes of a resnet50_v1b step (batch 128,
  the inputs chip_smoke.py's kernel_conv phase draws), the kernel as built
  (one f32 accumulator for every mma over C) and `folded` (each 32-channel
  stage summed in a zeroed fragment and added to the accumulator with
  rounding adds, built from a copy of the source by a text replacement):
  - `over_one_ulp`: how many y elements lie more than one bf16 ulp
    (2**-7 |b|) from b, for a the kernel, the folded kernel or the plain
    version and b the plain version or the exact product (f64, rounded to
    bf16): why a bf16 y is not held to one ulp of the plain version;
  - `over_bound`: the largest |a - e| over `conv_stats.conv1x1_y_bound`
    (the bound chip_smoke.py holds y to; e the exact f64 product), for the
    kernel, the folded kernel and the plain version;
  - `s2_vs_exact`: Sum y^2 per channel against the exact (f64) one, the
    largest relative error and the mean signed one, for the kernel, the
    folded kernel and the plain version;
  - `ms`, `folded_ms` (CUDA events, as chip_smoke.py times kernels);
  then `conv_step`: both times summed over the 33 launch sites.
* `tiling`: the kernel as built and variants of its tiling (warps along
  the columns WP and n8 tiles per warp NT of the rows instance; one slab
  tiling for every HW in place of the choice by HW; a deeper cp.async
  ring), each built from a copy of the source by a text replacement: ms at each step shape, whether y comes
  out bit for bit as the built kernel's (`same_y`), and the sum over the
  33 launch sites.
* `forward`: f32 at BH 96, T 512, d 64, non-causal, the kernel as built
  (the P.V sum folded per k8 step, `product_cn`'s kFold), `fold_per_tile`
  (each 64-key tile's P.V summed in a zeroed accumulator, then added to O)
  and `one_accumulator` (P.V's mmas all in O's accumulator): ms, the
  largest error against the plain version, and O's drift, its projection
  on the exact (f64) output, (out - exact).exact / exact.exact.

Nothing here is held to a bound: it reads.  Exits 1 without a card.
"""
import sys

import bwd_precision_study as bps
import chip_smoke as cs

STAGE = ("      mma_bf16(acc[i][j], a[0], b[0][j][0], b[0][j][1]);\n"
         "      mma_bf16(acc[i][j], a[1], b[1][j][0], b[1][j][1]);\n")
FOLDED = ("      float t[4] = {0.f, 0.f, 0.f, 0.f};\n"
          "      mma_bf16(t, a[0], b[0][j][0], b[0][j][1]);\n"
          "      mma_bf16(t, a[1], b[1][j][0], b[1][j][1]);\n"
          "#pragma unroll\n"
          "      for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];\n")
ROWS = "constexpr int kRowsWP = 4, kRowsNT = 4;"
SLAB_NT = ("return whole2 > 0 && kSlab2Cols * whole < kSlabCols * whole2 "
           "? kSlab2NT : kSlabNT;")
# variant -> (text of conv1x1_stats.cu, its replacement)
TILINGS = {
    "rows_wp2_nt8": (ROWS, "constexpr int kRowsWP = 2, kRowsNT = 8;"),
    "rows_wp4_nt2": (ROWS, "constexpr int kRowsWP = 4, kRowsNT = 2;"),
    "rows_wp8_nt2": (ROWS, "constexpr int kRowsWP = 8, kRowsNT = 2;"),
    "slabs_wp7_nt4": (SLAB_NT, "return kSlabNT + 0 * whole * whole2;"),
    "slabs_wp13_nt2": (SLAB_NT, "return whole2 > 0 ? kSlab2NT : kSlabNT;"),
    "stages4": ("constexpr int kStages = 3;", "constexpr int kStages = 4;"),
}
PV_FOLDED = "product_cn<D, N, true>(acc, s, vt);"
PV_ONE = "product_cn<D, N>(acc, s, vt);"
PV_TILE = ("{\n"
           "      float t[D / 8][4] = {};\n"
           "      product_cn<D, N>(t, s, vt);\n"
           "#pragma unroll\n"
           "      for (int n = 0; n < D / 8; ++n)\n"
           "#pragma unroll\n"
           "        for (int e = 0; e < 4; ++e) acc[n][e] += t[n][e];\n"
           "    }")
# forward design -> its kernel library
FWD = {"kernel": "flash_attention_fwd", "fold_per_tile": "fwd_fold_per_tile",
       "one_accumulator": "fwd_one_accumulator"}


def _over_ulp(a, b):
    return int(((a - b).abs() > 2.0 ** -7 * b.abs()).sum())


def conv(torch, tcs, use):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    sites = {(C, HW, O): k for C, HW, O, k in tcs.RESNET_CONV_SHAPES}
    step = dict(ms=0.0, folded_ms=0.0)
    for N, C, HW, O, dt in cs.conv_cases(tcs):
        # drawn for every case, as kernel_conv draws them
        dtype = getattr(torch, dt)
        x = torch.randn(N, C, HW, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(O, C, device="cuda", generator=gen) * 0.05) \
            .to(dtype)
        k = sites.get((C, HW, O)) if (N, dt) == (cs.RESNET_BATCH,
                                                 "bfloat16") else None
        if not k:
            continue
        ys, s2s, ms = {}, {}, {}
        for design in ("kernel", "folded"):
            use(design)
            y, _, s2 = tcs.fused_conv1x1_stats(x, w)
            ys[design], s2s[design] = y.float(), s2[0].double()
            ms[design] = cs._time_ms(torch, lambda: tcs.fused_conv1x1_stats(
                x, w))
        use("kernel")
        ref_y, _, ref_s2 = tcs.fused_conv1x1_stats_plain(x, w)
        ys["plain"], s2s["plain"] = ref_y.float(), ref_s2[0].double()
        exact64, bound = tcs.conv1x1_y_bound(x, w)
        exact = exact64.to(dtype).float()
        exact_s2 = exact64.pow(2).sum(dim=(0, 2))
        row = dict(phase="conv", N=N, C=C, HW=HW, O=O, sites=k,
                   path=tcs.conv1x1_stats_path(N, C, HW, O, dtype),
                   over_one_ulp={
                       "%s_vs_%s" % (a, b): _over_ulp(ys[a], ref)
                       for a, b, ref in (
                           ("kernel", "plain", ys["plain"]),
                           ("folded", "plain", ys["plain"]),
                           ("plain", "exact", exact),
                           ("kernel", "exact", exact))},
                   over_bound={
                       a: ((ys[a].double() - exact64).abs() / bound).max()
                       .item() for a in ("kernel", "folded", "plain")},
                   s2_vs_exact={
                       a: dict(max_rel=((s2 - exact_s2).abs() / exact_s2)
                               .max().item(),
                               mean_signed=((s2 - exact_s2) / exact_s2)
                               .mean().item())
                       for a, s2 in s2s.items()},
                   ms=ms["kernel"], folded_ms=ms["folded"])
        cs._emit(row)
        step["ms"] += k * ms["kernel"]
        step["folded_ms"] += k * ms["folded"]
        del ys, exact, exact64, bound
    cs._emit(dict(phase="conv_step", sites=cs.RESNET_SITES, **step))


def tiling(torch, tcs, use):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    step = dict.fromkeys(("kernel",) + tuple(TILINGS), 0.0)
    for C, HW, O, k in tcs.RESNET_CONV_SHAPES:
        N = cs.RESNET_BATCH
        x = torch.randn(N, C, HW, device="cuda", generator=gen) \
            .to(torch.bfloat16)
        w = (torch.randn(O, C, device="cuda", generator=gen) * 0.05) \
            .to(torch.bfloat16)
        row = dict(phase="tiling", C=C, HW=HW, O=O, sites=k,
                   path=tcs.conv1x1_stats_path(N, C, HW, O, torch.bfloat16),
                   ms={}, same_y={})
        for design in step:
            use(design)
            y = tcs.fused_conv1x1_stats(x, w)[0]
            if design == "kernel":
                base = y
            row["same_y"][design] = bool(torch.equal(y, base))
            row["ms"][design] = cs._time_ms(
                torch, lambda: tcs.fused_conv1x1_stats(x, w))
            step[design] += k * row["ms"][design]
        use("kernel")
        cs._emit(row)
    cs._emit(dict(phase="tiling_step", sites=cs.RESNET_SITES, ms=step))


def forward(torch, att, use):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    q, k, v = (torch.randn(96, cs.SEQ, 64, device="cuda", generator=gen)
               for _ in range(3))
    scale = 0.125
    ref, _ = att.flash_attention_fwd_plain(q, k, v, scale, False)
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) * scale
    exact = torch.matmul(torch.softmax(s, -1), v.double())
    del s
    for design in FWD:
        use(design)
        out, _ = att.flash_attention_fwd(q, k, v, scale, False)
        drift = ((out.double() - exact) * exact).sum() / exact.pow(2).sum()
        cs._emit(dict(phase="forward", design=design, BH=96, T=cs.SEQ, d=64,
                      dtype="float32",
                      ms=cs._time_ms(torch, lambda: att.flash_attention_fwd(
                          q, k, v, scale, False)),
                      err_vs_plain=(out - ref).abs().max().item(),
                      drift=drift.item()))
    use("kernel")


def main():
    import torch
    if not torch.cuda.is_available():
        print("tc_precision_study: no CUDA device", file=sys.stderr)
        return 1
    from incubator_mxnet_tpu_torch.ops import _kernels
    from incubator_mxnet_tpu_torch.ops import attention as att
    from incubator_mxnet_tpu_torch.ops import conv_stats as tcs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs._emit(dict(phase="env", nvidia_smi=cs._nvidia_smi(),
                  torch=torch.__version__, cuda=torch.version.cuda))
    build = _kernels._BUILD / "study"
    build.mkdir(parents=True, exist_ok=True)
    bps.kernel_variant(_kernels, build, "conv1x1_stats", "conv_folded",
                       "conv1x1_stats.cu", STAGE, FOLDED)
    for variant, text in (("fwd_one_accumulator", PV_ONE),
                          ("fwd_fold_per_tile", PV_TILE)):
        bps.kernel_variant(_kernels, build, "flash_attention_fwd", variant,
                           "flash_attention_fwd.cu", PV_FOLDED, text)
    for variant, (old, new) in TILINGS.items():
        bps.kernel_variant(_kernels, build, "conv1x1_stats", variant,
                           "conv1x1_stats.cu", old, new)
    names = ("conv1x1_stats", "conv_folded") + tuple(FWD.values()) \
        + tuple(TILINGS)
    reports = _kernels.build_all(names)
    # registers and spills of each variant's tensor-core conv instances
    # and of the forward designs' f32 instances
    cs._emit(dict(phase="build", ptxas={
        n: {k: v for k, v in cs._ptxas({n: reports[n]}).items()
            if "_tc_" in k or "fwd_kernel<f32" in k}
        for n in tuple(TILINGS) + ("conv_folded",) + tuple(FWD.values())
        if n in reports}))
    libs = {name: _kernels.library(name) for name in names}

    def use_conv(design):
        _kernels._LIBS["conv1x1_stats"] = libs[
            {"kernel": "conv1x1_stats", "folded": "conv_folded"}.get(
                design, design)]

    def use_fwd(design):
        _kernels._LIBS["flash_attention_fwd"] = libs[FWD[design]]

    conv(torch, tcs, use_conv)
    tiling(torch, tcs, use_conv)
    forward(torch, att, use_fwd)
    return 0


if __name__ == "__main__":
    sys.exit(main())
