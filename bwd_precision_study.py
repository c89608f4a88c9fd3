#!/usr/bin/env python3
"""Accuracy of the f32 flash-attention backward kernels on the card.

Run from the repo root on a CUDA host: `python3 bwd_precision_study.py`.
It prints one JSON object per line:

* `probe`: how `mma.sync.m16n8k8.tf32` rounds its f32 sum.  Random tf32
  operands and f32 accumulators go through one mma; each result is held
  against the exact sum rounded to nearest and rounded toward zero.
* `kernel`: the f32 kernels against their plain versions at the BERT-base
  shape (BH 96, T 512, d 64), for two designs of the S and dP products:
  `two_accumulators` (ops/csrc/flash_attention_bwd.cu as it is: the small
  terms of the 3xTF32 split in an accumulator of their own) and
  `one_accumulator` (the same source with all three products of a k step
  in one accumulator, built from it by a text replacement).  `err` is the
  largest error over chip_smoke.BWD_TOL of the largest gradient;
  `dk_colsum` is max |sum over key rows of dK| over max |dK|, which is 0
  in exact arithmetic (the rows of dS sum to 0), `dk_colsum_plain` the
  same of the plain version.
* `e2e`: the three largest errors of a BERT-base batch-1 step's
  gradients against a CPU copy, each over its scale as chip_smoke.py's
  `train` phase holds them (TRAIN_TOL 1e-3), with the attention backward
  taken by each design, by the plain version with f32 products, with
  3xTF32 products rounded to nearest (torch), and with one TF32 product
  each.  Two inputs: chip_smoke.py's batch row and a second draw.

Nothing here is held to a bound: it reads.  Exits 1 without a card.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

import chip_smoke as cs

PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// d (16 x 8) = a (16 x 8, row-major) . b (8 x 8, b[k * 8 + n]) + c, one warp
// per problem, one mma.sync.m16n8k8.tf32 each
__global__ void mma_probe(const float* a, const float* b, const float* c, float* d) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  a += blockIdx.x * 128; b += blockIdx.x * 64; c += blockIdx.x * 128; d += blockIdx.x * 128;
  uint32_t a0 = __float_as_uint(a[g * 8 + t]), a1 = __float_as_uint(a[(g + 8) * 8 + t]);
  uint32_t a2 = __float_as_uint(a[g * 8 + t + 4]), a3 = __float_as_uint(a[(g + 8) * 8 + t + 4]);
  uint32_t b0 = __float_as_uint(b[t * 8 + g]), b1 = __float_as_uint(b[(t + 4) * 8 + g]);
  float c0 = c[g * 8 + 2 * t], c1 = c[g * 8 + 2 * t + 1];
  float c2 = c[(g + 8) * 8 + 2 * t], c3 = c[(g + 8) * 8 + 2 * t + 1];
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c0), "+f"(c1), "+f"(c2), "+f"(c3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  d[g * 8 + 2 * t] = c0;
  d[g * 8 + 2 * t + 1] = c1;
  d[(g + 8) * 8 + 2 * t] = c2;
  d[(g + 8) * 8 + 2 * t + 1] = c3;
}
extern "C" int mma_probe_run(const float* a, const float* b, const float* c, float* d, int n) {
  mma_probe<<<n, 32>>>(a, b, c, d);
  return (int)cudaDeviceSynchronize();
}
"""

# the small terms of the S and dP products back in the main accumulator
TWO = ("      mma_tf32(lo[j], as, bb0, bb1);\n"
       "      mma_tf32(lo[j], ab, bs0, bs1);\n")
ONE = ("      mma_tf32(acc[j], as, bb0, bb1);\n"
       "      mma_tf32(acc[j], ab, bs0, bs1);\n")


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _tf32_np(x):
    return ((x.astype(np.float32).view(np.int32) + 0x1000) & ~0x1fff) \
        .view(np.float32)


def probe(torch, _kernels, build):
    so = build / "libmma_probe.so"
    src = build / "mma_probe.cu"
    src.write_text(PROBE_SRC)
    subprocess.run([_kernels._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(so),
                    str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.mma_probe_run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    rs = np.random.RandomState(5)
    n = 4096
    a, b = _tf32_np(rs.randn(n, 16, 8)), _tf32_np(rs.randn(n, 8, 8))
    c = rs.randn(n, 16, 8).astype(np.float32)
    ta, tb, tc = (torch.from_numpy(x).cuda() for x in (a, b, c))
    td = torch.empty_like(tc)
    rc = lib.mma_probe_run(ta.data_ptr(), tb.data_ptr(), tc.data_ptr(),
                           td.data_ptr(), n)
    cs._check(rc == 0, "the mma probe failed with CUDA error %d" % rc)
    d = td.cpu().numpy().astype(np.float64)
    # products of tf32 values and their sums are exact in f64 here
    exact = np.einsum("rik,rkn->rin", a.astype(np.float64),
                      b.astype(np.float64)) + c
    rn = exact.astype(np.float32)
    rz = np.where(np.abs(rn.astype(np.float64)) > np.abs(exact),
                  np.nextafter(rn, np.float32(0)), rn).astype(np.float64)
    rn = rn.astype(np.float64)
    off = d != exact
    _emit(dict(phase="probe", mma="m16n8k8.row.col.f32.tf32.tf32.f32",
               sums=int(d.size), match_nearest=float((d == rn).mean()),
               match_toward_zero=float((d == rz).mean()),
               inexact_toward_zero=float(
                   (np.abs(d[off]) < np.abs(exact[off])).mean())))


def kernels(torch, att, libs, use):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for causal in (False, True):
        q, k, v, do = (torch.randn(96, cs.SEQ, 64, device="cuda",
                                   generator=gen) for _ in range(4))
        scale = 0.125
        out, lse = att.flash_attention_fwd(q, k, v, scale, causal)
        rdq, rdel = att.flash_attention_bwd_dq_plain(q, k, v, out, lse, do,
                                                     scale, causal)
        rdk, rdv = att.flash_attention_bwd_dkv_plain(q, k, v, do, lse, rdel,
                                                     scale, causal)
        for name in libs:
            use(name)
            dq, delta = att.flash_attention_bwd_dq(q, k, v, out, lse, do,
                                                   scale, causal)
            dk, dv = att.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                 scale, causal)
            err = {n: ((g - r).abs().max() / (cs.BWD_TOL * r.abs().max()))
                   .item() for n, g, r in (("dq", dq, rdq), ("dk", dk, rdk),
                                           ("dv", dv, rdv))}
            _emit(dict(
                phase="kernel", design=name, shape=[96, cs.SEQ, 64],
                dtype="float32", causal=causal, err=err,
                dk_colsum=(dk.double().sum(1).abs().max()
                           / dk.abs().max()).item(),
                dk_colsum_plain=(rdk.double().sum(1).abs().max()
                                 / rdk.abs().max()).item(),
                dq_ms=cs._time_ms(torch, lambda: att.flash_attention_bwd_dq(
                    q, k, v, out, lse, do, scale, causal)),
                dkv_ms=cs._time_ms(torch, lambda: att.flash_attention_bwd_dkv(
                    q, k, v, do, lse, delta, scale, causal))))


def e2e(torch, mx, att, libs, use):
    def mm_3xtf32(a, b):
        ab, bb = cs._tf32(torch, a), cs._tf32(torch, b)
        as_ = cs._tf32(torch, a - ab, False)
        bs = cs._tf32(torch, b - bb, False)
        return (torch.matmul(as_, bb) + torch.matmul(ab, bs)
                + torch.matmul(ab, bb))

    mx.random.seed(0)
    net = mx.models.bert_base(dropout=0.0, output_hidden=True, device="cuda:0")
    head = mx.models.FusedMLMCELoss(30522, 768, device="cuda:0")
    params = dict(net.collect_params())
    params.update({"loss." + n: p for n, p in head.collect_params().items()})
    cpu_net = mx.models.bert_base(dropout=0.0, output_hidden=True,
                                  device="cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    cpu_head = mx.models.FusedMLMCELoss(30522, 768, device="cpu")
    cpu_head.load_state_dict({k: v.cpu()
                              for k, v in head.state_dict().items()})
    cpu_params = dict(cpu_net.collect_params())
    cpu_params.update({"loss." + n: p
                       for n, p in cpu_head.collect_params().items()})
    for data, rows in (("chip_smoke", cs.TRAIN_BATCH), ("second", 1)):
        rs = np.random.RandomState(0)
        x = torch.from_numpy(rs.randint(0, 30522, (rows, cs.SEQ))
                             .astype(np.int32)[:1])
        y = torch.from_numpy(rs.randint(0, 30522, (rows, cs.SEQ))
                             .astype(np.float32)[:1])
        with mx.autograd.record():
            ref_loss = cpu_head(cpu_net(x), y)
        mx.autograd.backward(ref_loss)
        refs = {n: p.grad.clone() for n, p in cpu_params.items()}
        gmax = max(g.abs().max().item() for g in refs.values())

        def top3():
            with mx.autograd.record():
                loss = head(net(x.cuda()), y.cuda())
            mx.autograd.backward(loss)
            per = {n: (p.grad.cpu() - refs[n]).abs().max().item()
                   / max(refs[n].abs().max().item(), 1e-3 * gmax)
                   for n, p in params.items()}
            return sorted(per.items(), key=lambda kv: -kv[1])[:3]

        for name in libs:
            use(name)
            _emit(dict(phase="e2e", data=data, backward=name, top=top3()))
        use("two_accumulators")
        for name, mm in (("plain_f32", torch.matmul),
                         ("plain_3xtf32_nearest_sums", mm_3xtf32),
                         ("plain_1xtf32", lambda a, b: torch.matmul(
                             cs._tf32(torch, a), cs._tf32(torch, b)))):
            with cs._plain_backward(att, mm):
                _emit(dict(phase="e2e", data=data, backward=name,
                           top=top3()))


def main():
    import torch
    if not torch.cuda.is_available():
        print("bwd_precision_study: no CUDA device", file=sys.stderr)
        return 1
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import _kernels
    from incubator_mxnet_tpu_torch.ops import attention as att
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _emit(dict(phase="env", nvidia_smi=cs._nvidia_smi(),
               torch=torch.__version__, cuda=torch.version.cuda))
    build = _kernels._BUILD / "study"
    build.mkdir(parents=True, exist_ok=True)
    probe(torch, _kernels, build)

    name = "flash_attention_bwd"
    src = (_kernels._CSRC / _kernels.SOURCES[name][0]).read_text()
    cs._check(src.count(TWO) == 1, "flash_attention_bwd.cu no longer holds "
              "the S/dP small-term accumulator this study replaces")
    one = build / "flash_attention_bwd_one_accumulator.cu"
    one.write_text(src.replace(TWO, ONE))
    _kernels.SOURCES["one_accumulator"] = (str(one), _kernels.SOURCES[name][1])
    _kernels.build_all([name, "one_accumulator"])
    libs = {"two_accumulators": _kernels.library(name),
            "one_accumulator": _kernels.library("one_accumulator")}

    def use(design):
        _kernels._LIBS[name] = libs[design]

    kernels(torch, att, libs, use)
    e2e(torch, mx, att, libs, use)
    use("two_accumulators")
    return 0


if __name__ == "__main__":
    sys.exit(main())
