#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives incubator_mxnet_tpu_torch only (never JAX or the JAX package):

1. env     — card name, power limit and compute capability (must be 9.0).
2. build   — compiles every CUDA kernel of the port from the checkout's
             sources (one nvcc per source, all started together), with
             ptxas's registers and spill stores per kernel instance.
3. kernel  — each kernel against its plain PyTorch version on the card, at
             the serving, NMT and bf16 training shapes and at edge cases,
             timed with CUDA events beside the plain version and one
             PyTorch library call, and by
             the device time of its kernels (torch.profiler) beside the
             library call's.
4. serve   — BERT-base at full width (random weights from seed 0, f32)
             behind InferenceEngine on cuda:0: warmup; a burst of 12
             singles from 3 threads and one batch of 3, every result
             checked and one request's logits held against a CPU copy of
             the model (which takes the plain attention path); then a
             sustained window of 600 singles from 3 closed-loop clients
             (8 outstanding each), with rate and e2e tail over the whole
             window.  The kernel must launch 12 times per batch.
   profile — device time by kernel over full-bucket forwards
             (torch.profiler), and the device's busy share of that wall.
5. kernel_bwd — the flash backward's dQ and dK/dV kernels (tensor cores:
             bf16 mma.sync, f32 as 3xTF32) against their plain versions on
             the card, over the forward phase's cases, timed beside the
             plain versions and the backward of scaled_dot_product_attention
             alone (autograd.grad over a kept graph), read as the device
             time of the kernels it launches, with their names; the pair's
             own device time, each kernel's, and the pair's ratio to the
             library's beside it.
6. train   — BERT-base MLM at full width (f32, dropout 0, output_hidden
             + FusedMLMCELoss, Adam lr 1e-4, batch 8 x 512 tokens from
             RandomState(0)): one batch-1 step's loss and every gradient
             against a CPU copy of the model; 2 warm-up and 10 timed
             steps (step ms by CUDA events, tokens/s, peak memory, every
             loss finite); each step launches each of the three kernels
             12 times.
   train_profile — device time by kernel over one training step.
7. train_bf16 — BERT-base as bench.py's run_bert trains it: bert_base and
             FusedMLMCELoss cast to bf16 (Block.cast), Adam lr 1e-4,
             batch 16 x 512 from RandomState(0): a batch-1 step's loss and
             worst gradient against an f32 CPU copy holding the same
             bf16-valued weights, by the kernels and by the plain route
             (every flash kernel's plain version on the card), the
             kernels held to twice the plain route's errors; 2 warm-up and
             10 timed steps (step ms by CUDA events, tokens/s, peak
             memory, every loss finite), each launching each kernel 12
             times, every launch a bf16 instance; the vocab projection's
             two routes (cuBLAS bf16 GEMMs with f32 output, and the
             operands upcast to f32) timed at the step's shape.
   train_bf16_profile — device time by kernel over one such step.
8. kernel_conv — the fused 1x1-conv + BatchNorm-statistics kernel at the
             12 shapes of a ResNet-50 step (bf16, batch 128), the tool's 5
             shapes in f32 and ragged shapes, each with the kernel
             instance it takes (every step shape must take the tensor
             cores): its sums and f32 y against the plain version, and a
             bf16 y, the kernel's and the plain version's, against the
             exact product; timed beside the plain version, the library
             route (cuDNN's 1x1 convolution, then the two f32 sums) and
             cuDNN's 1x1 convolution alone.
9. train_resnet — resnet50_v1b (1000 classes, random weights from seed 0)
             + SoftmaxCrossEntropyLoss + SGD (lr 0.1, momentum 0.9, wd
             1e-4), as bench.py's run_cachedop: one batch-2 f32 step's
             loss, 161 gradients and running statistics against a CPU
             copy (gradients against the copy's own rounding spread), a
             small ResNet v1b's gradients against its CPU copy; then
             batch 128 x 3 x 224 x 224 cast to bf16, labels
             from RandomState(0), 2 warm-up and 10 timed steps (step ms by
             CUDA events, images/s, peak memory, every loss finite); each
             step launches the conv kernel 33 times.
   train_resnet_profile — device time by kernel over one such step.
10. train_nmt — transformer_nmt_base (6 + 6 layers, 512 units, 8 heads,
             vocab 32000, dropout 0, output_hidden + FusedMLMCELoss, Adam
             lr 1e-4, f32) as bench.py's run_transformer_nmt (config 4b):
             one batch-1 step's loss and every gradient against a CPU
             copy; then batch 64 x source 64 x target 64 from
             RandomState(0), 2 warm-up and 10 timed steps (step ms by CUDA
             events, target tokens/s, peak memory, every loss finite);
             each step launches each flash kernel 12 times, 6 of them
             causal (the decoder's self-attention).
   train_nmt_profile — device time by kernel over one such step.
11. decode_nmt — the same model with its vocab projection: init_cache for
             8 of those source rows at differing valid lengths with the
             memory padded past the source, then 16 greedy decode_steps
             on cuda:0 (ms per step); each step's logits against the
             teacher-forced forward over the same prefix on the card and
             against a CPU copy's decode steps.  The decode step attends
             with torch.bmm: no flash kernel may launch.
   decode_nmt_profile — device time by kernel over one prefill and its
             greedy steps.
12. kernels — one JSON line per the port's kernel table (4 rows), then the
             card's name and power limit, then the final {"ok": true, ...}
             line.

Every phase prints one JSON line; the first failure raises and exits
nonzero with its traceback.  Without a CUDA device it exits 1 and prints
nothing on standard output.
"""
import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM data-sheet peaks (dense) and HBM3 bandwidth, used only for the
# least time a call could take.  An f32-accurate product has two routes on
# the card: scalar FMAs on the CUDA cores (67 TFLOP/s) and the 3xTF32 split
# on the tensor cores (three TF32 products at 495 TFLOP/s for each f32 one,
# so 165 TFLOP/s).  The f32 bound takes the faster route; the f32 phase rows
# carry the CUDA-core bound beside it as bound_cuda_core_ms (the kernels line
# carries bound_ms only).  bf16 runs on the tensor
# cores at 989 TFLOP/s.
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12, "float16": 989e12}
PEAK_FLOPS_F32_CUDA_CORES = 67e12
PEAK_BYTES_S = 3.35e12
SERVE_BUCKETS = (1, 2, 4, 8)
SEQ = 512
# flash forward against its plain version: f32 out and lse (from f32
# scores in every dtype) differ by the same sums in another order
TOL = 1e-4
# unit roundoff of the 16-bit dtypes (half their spacing at 1): a 16-bit
# kernel output is held to 4 u (|ref| + rms(ref)) of its plain version
# (`_low_tolerance`)
ROUNDOFF = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}
# CPU vs card on the served logits, both f32: cuBLAS and the CPU BLAS sum
# in other orders and the kernel's tiled online softmax differs from the
# plain softmax in rounding; through 12 layers of LayerNorm-ed residuals
# this stays near 1e-5 on logits of size ~1, so 2e-3 leaves a wide margin
# while any wrong tile, mask or scale shows up as O(1e-1) or more.
SERVE_TOL = 2e-3
# flash backward against its plain version in f32: the same sums in
# another order, far below 1e-4 of the largest gradient; a wrong tile,
# mask, scale or delta moves gradients by O(1) of that size
BWD_TOL = 1e-4
# one batch-1 training step, card against a CPU copy, both f32: cuBLAS,
# the CPU BLAS and the flash kernels sum in other orders through 12
# layers forward and back.  Each gradient's max-abs error is held to
# 1e-3 of its max-abs value.  That value is floored at 1e-3 of the
# model's largest gradient: attn.key.bias has a gradient of exactly 0 in
# exact arithmetic (softmax ignores a shift of a row's scores), so its
# rounding noise is held to the model's scale.  A dropped or wrong
# attention gradient moves the q/k/v projections' gradients by O(1).
TRAIN_TOL = 1e-3
TRAIN_BATCH = 8
TRAIN_WARMUP = 2
TRAIN_STEPS = 10
# bench.py's run_bert: BERT-base cast to bf16 at batch 16 x 512.  A bf16
# step cannot be held to the f32 TRAIN_TOL.  Its batch-1 step is read
# against an f32 CPU copy holding the same bf16-valued weights, by the
# kernels and by the plain route (the card's step with every flash kernel
# replaced by its plain version), and each tensor X (the final hidden
# states and every gradient) is held on its own:
#     e_kernels(X) <= 2 e_plain(X) + ulp(X),
# e the max-abs error against the CPU copy over X's scale (its max-abs
# value, floored at 1e-3 of the largest gradient), ulp(X) one bf16 ulp of
# that scale over the scale.  The two routes round at the same points
# (the plain versions round P, dS and the outputs to bf16 where the
# kernels do) and differ only in the order of f32 sums, which tips a
# rounding here and there by one ulp; those flips travel through the same
# computation as the bf16 roundings that make e_plain, so the routes'
# distance is at most about e_plain, and e_kernels <= e_plain + that
# distance <= 2 e_plain; where e_plain is below X's own rounding, one ulp
# of X's scale is the floor.  A fault in a tile, mask, scale or delta
# moves the hidden states or the well-conditioned gradients (the value
# and output projections, the FFNs, every layer below the fault) by O(1)
# of their scale.  The batch-1 loss (f32 from bf16 hidden states) is held
# to twice the plain route's error plus 1e-6; at random init it hardly
# depends on the network, so the hidden states carry the forward's check.
BF16_BATCH = 16
BF16_ROUTE_FACTOR = 2.0
BF16_LOSS_FLOOR = 1e-6
# fused 1x1 conv + statistics.  f32 y against the plain version: the
# same f32 sums over C in another order, 1e-4 of the largest |y|.  A
# 16-bit y, the kernel's and the plain version's alike, against the exact
# (f64) product e: within conv_stats.conv1x1_y_bound, u |e| (+ 2**-25 in
# f16) + 1.01 C 2**-23 sum_c |w x|, u = 2**-8 in bf16 and 2**-11 in f16,
# what an f32 sum over C in any order and any rounding of its adds, then
# rounded to y's dtype, can miss e by (its docstring derives it).  The sums of N·HW f32 terms in another order: Σy within
# CONV_SUM_TOL of sqrt(N·HW·Σy²) (which is at least Σ|y|), Σy² within
# CONV_SUM_TOL of itself.  A wrong tile or mask moves a sum by O(1) of
# it, a dropped input channel Σy² by about 1/C of it (4.9e-4 at C 2048).
CONV_SUM_TOL = 1e-5
RESNET_BATCH = 128
RESNET_PARITY_BATCH = 2
RESNET_SITES = 33       # pointwise conv + BatchNorm pairs of resnet50_v1b
# running statistics after the parity step, card against the CPU copy:
# batch statistics from the kernel's sums against the CPU's, f32 through
# 50 layers; each tensor within 1e-4 of its scale
RUNNING_TOL = 1e-4
# resnet50_v1b's batch-2 gradients are not a smooth function of the
# inputs at rounding level: scaling the input by 1 + 2**-22 on the CPU
# flips about 80 ReLU decisions and moves most gradients by 1-20 % of
# their scale (the same size at 2**-16: discrete flips, not growth).  So
# the card's gradients are held to RESNET_SPREAD_FACTOR times the spread
# the CPU copy shows against itself under that perturbation, in its
# largest and its median tensor (the spread itself varies with the
# perturbation: 0.17-0.35 of scale in the largest tensor, 0.018-0.027 in
# the median one); a wrong gradient path moves its tensors by O(1) of
# their scale.  The small ResNet below, free of such flips, is held to
# TRAIN_TOL per tensor.
RESNET_SPREAD_FACTOR = 3.0
SMALL_RESNET = dict(layers=[1, 1, 1, 1], channels=[8, 16, 32, 64, 128],
                    classes=10, thumbnail=True, stride_on_3x3=True)
# sustained serving window: closed-loop clients, each keeping INFLIGHT
# singles outstanding, so the queue stays deeper than the largest bucket
WINDOW_CLIENTS = 3
WINDOW_PER_CLIENT = 200
WINDOW_INFLIGHT = 8
# bench.py's config 4b: transformer_nmt_base at batch 64, source and
# target 64, vocab 32000
NMT_VOCAB = 32000
NMT_UNITS = 512
NMT_BATCH = 64
NMT_SEQ = 64
NMT_LAYERS = 6
# cached decode: 8 source rows of differing valid lengths, the memory
# padded from 64 to 80 rows, 16 greedy steps from token 1
NMT_DECODE_VALID = (64, 61, 55, 48, 40, 31, 17, 6)
NMT_MEM_LEN = 80
NMT_DECODE_STEPS = 16
NMT_BOS = 1


def _emit(obj):
    print(json.dumps(obj), flush=True)


def _check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _time_ms(torch, fn, reps=20, rounds=5):
    """Median over `rounds` of the mean time of `reps` back-to-back calls,
    by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def _low_tolerance(ref, dt):
    """4 u (|ref| + rms(ref)) for the 16-bit dtype `dt` of unit roundoff u
    (`ROUNDOFF`): 2**-6 in bf16, 2**-9 in f16.  4 u |ref| is at least 2
    ulps of each element (an ulp is at most 2 u of it), and 4 u rms(ref)
    covers the elements near zero."""
    return 4.0 * ROUNDOFF[dt] * (ref.abs() + ref.pow(2).mean().sqrt())


def _out_tolerance(torch, ref, dt):
    """Elementwise bound on |out - ref| of the flash forward.  16-bit: both
    outputs are rounded to the dtype, and the kernel rounds P against the
    running max where the plain version uses the final max; within
    `_low_tolerance`.  A fault that scales out by 4 u or more (3 % in
    bf16), or mixes up rows of V, exceeds it."""
    if dt == "float32":
        return torch.full_like(ref, TOL)
    return _low_tolerance(ref, dt)


def _roofline(flops, nbytes, dtype, prefix=""):
    """{bound_ms, bound_by}: the least time (ms) of a call that does `flops`
    at the dtype's faster route and moves `nbytes` at HBM bandwidth, and
    which of the two bounds it; for f32 also bound_cuda_core_ms and
    bound_cuda_core_by, the same with the products on the CUDA cores.
    Keys take `prefix`."""
    def one(peak):
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_S
        return max(t_ops, t_bytes) * 1e3, \
            "operations" if t_ops >= t_bytes else "bytes"
    out = dict(zip((prefix + "bound_ms", prefix + "bound_by"),
                   one(PEAK_FLOPS[dtype])))
    if dtype == "float32":
        out.update(zip((prefix + "bound_cuda_core_ms",
                        prefix + "bound_cuda_core_by"),
                       one(PEAK_FLOPS_F32_CUDA_CORES)))
    return out


def _bound(BH, T, d, dtype, causal, products, tensors, rows, prefix=""):
    """Roofline of a flash kernel: `products` (T, T, d) matrix products of
    2·d flops per (query, key) pair this mask keeps; `tensors` (BH, T, d)
    operands and `rows` (BH, T) f32 statistics each read or written
    once."""
    elem = 4 if dtype == "float32" else 2
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = 2.0 * products * BH * d * pairs
    nbytes = tensors * BH * T * d * elem + rows * 4.0 * BH * T
    return _roofline(flops, nbytes, dtype, prefix)


def _flash_bound(BH, T, d, dtype, causal):
    """Forward: S and P·V; q, k, v read, out and lse written."""
    return _bound(BH, T, d, dtype, causal, products=2, tensors=4, rows=1)


def _dq_bound(BH, T, d, dtype, causal):
    """dQ: S, dP and dS·K; q, k, v, dO, O and lse read, dq and delta
    written."""
    return _bound(BH, T, d, dtype, causal, products=3, tensors=6, rows=2,
                  prefix="dq_")


def _dkv_bound(BH, T, d, dtype, causal):
    """dK/dV: S, dP, P^T·dO and dS^T·Q; q, k, v, dO, lse and delta read,
    dk and dv written."""
    return _bound(BH, T, d, dtype, causal, products=4, tensors=6, rows=2,
                  prefix="dkv_")


# kernel cases (BH, T, d, dtype, causal): the BERT serving and training
# shape first, then causal, bf16, ragged T and the other head dims, then
# the NMT step's shape (64 x 8 heads, T 64: one tile, every tile on the
# diagonal when causal) both ways, a ragged causal T of one partial tile,
# the bf16 BERT step's shape, and the f16 instances (amp.init("float16"),
# a float16 cast) at the BERT shape and a ragged causal T
BERT_CASE = (96, SEQ, 64, "float32", False)
NMT_CASES = ((NMT_BATCH * 8, NMT_SEQ, 64, "float32", False),
             (NMT_BATCH * 8, NMT_SEQ, 64, "float32", True))
# the bf16 BERT step's shape (batch 16 x 12 heads)
BF16_CASES = ((BF16_BATCH * 12, SEQ, 64, "bfloat16", False),)
CASES = [BERT_CASE, (96, SEQ, 64, "float32", True),
         (96, SEQ, 64, "bfloat16", False), (96, SEQ, 64, "bfloat16", True),
         (8, 200, 64, "float32", False), (8, 200, 64, "bfloat16", True),
         (96, SEQ, 32, "float32", False), (96, SEQ, 128, "float32", False),
         (8, 200, 16, "float32", True)] + list(NMT_CASES) + [
         (NMT_BATCH * 8, 50, 64, "float32", True)] + list(BF16_CASES) + [
         (96, SEQ, 64, "float16", False), (8, 200, 64, "float16", True)]


def phase_kernel(torch, att):
    """Flash forward kernel against its plain version; returns its rows
    by case."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}
    for BH, T, d, dt, causal in CASES:
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(BH, T, d, device="cuda", generator=gen)
                   .mul_(0.5).to(dtype) for _ in range(3))
        scale = 1.0 / math.sqrt(d)
        out, lse = att.flash_attention_fwd(q, k, v, scale, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = att.flash_attention_fwd_plain(q, k, v, scale,
                                                         causal)
        ref = ref_out.float()
        diff = (out.float() - ref).abs()
        err_out = diff.max().item()
        # the largest error as a share of its element's bound (ok <= 1)
        err_ratio = (diff / _out_tolerance(torch, ref, dt)).max().item()
        err_lse = (lse - ref_lse).abs().max().item()
        ok = err_ratio <= 1.0 and err_lse <= TOL
        ms = _time_ms(torch, lambda: att.flash_attention_fwd(
            q, k, v, scale, causal))
        plain_ms = _time_ms(torch, lambda: att.flash_attention_fwd_plain(
            q, k, v, scale, causal))
        # 4-D (1, BH, T, d) views: PyTorch's fused SDPA backends take 4-D
        q4, k4, v4 = q[None], k[None], v[None]
        library_ms = _time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale))
        # device time of the kernel and of the library's kernels: at a short
        # T a call's host work outlasts its kernel, and back-to-back calls
        # timed by events then read the host's rate
        device_ms, _ = _device_ms(torch, lambda: att.flash_attention_fwd(
            q, k, v, scale, causal))
        library_device_ms, _ = _device_ms(
            torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=causal, scale=scale))
        row = dict(phase="kernel", name="flash_attention_fwd", BH=BH, T=T,
                   d=d, dtype=dt, causal=causal, err_out=err_out,
                   err_out_over_bound=err_ratio, err_lse=err_lse,
                   tol_lse=TOL, ok=ok, ms=ms, device_ms=device_ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   library_device_ms=library_device_ms,
                   **_flash_bound(BH, T, d, dt, causal))
        _emit(row)
        _check(ok, "flash_attention_fwd disagrees with its plain version: "
                   "%r" % (row,))
        rows[BH, T, d, dt, causal] = row
    return rows


def _device_kernels(torch, fn, reps, tries=3):
    """[(device us, kernel name, calls)] of the CUDA kernels that `reps`
    back-to-back calls of `fn` (after one unprofiled call) launch, largest
    first, from torch.profiler, and the host wall of that window (us).
    Every call launches the same kernels, so a trace in which a kernel's
    count is not a multiple of `reps`, or that holds no kernel, lost
    records (seen once on the card: no launch of a 20-call window, and
    part of the next call's): the window is profiled again, and after
    `tries` such traces the run fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # kernels only: the aten op that launched a kernel carries the
        # same device time again
        rows = [(ev.self_device_time_total, ev.key, ev.count)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA
                and ev.self_device_time_total > 0]
        if rows and all(n % reps == 0 for _, _, n in rows):
            rows.sort(reverse=True)
            return rows, wall_us
    raise RuntimeError("torch.profiler lost kernel records of %d calls in "
                       "%d windows: %r" % (reps, tries, rows))


def _device_ms(torch, fn, reps=20):
    """Device time (ms) per call of `fn`: its kernels' summed self time
    over `reps` calls, divided by `reps`; and those kernels by name with
    their time (us) and launches per call."""
    rows, _ = _device_kernels(torch, fn, reps)
    return sum(r[0] for r in rows) / reps / 1e3, \
        [dict(kernel=k[:120], us=us / reps, calls=n / reps)
         for us, k, n in rows]


# the port's hand-written kernels among the profiler's kernel names (they
# live in an anonymous namespace; cuDNN's own "..._flash_bprop_..." do not)
_PORT_KERNEL = re.compile(r"::(flash_(?:fwd|bwd_dq|bwd_dkv)_kernel"
                          r"|conv1x1_stats(?:_tc)?_kernel"
                          r"|stats_reduce_kernel)\b")


def _profile(torch, fn, reps, top=8, **row):
    """Device time per kernel name over `reps` calls of `fn`; `busy_share`
    is that time over the host wall of the profiled window (profiler
    overhead included).  Emits `row` with the breakdown: the `top`
    kernels, and every kernel of the port's own (`port_kernels`) with
    their sum and share."""
    rows, wall_us = _device_kernels(torch, fn, reps)
    device_us = sum(r[0] for r in rows)
    port = [dict(kernel=k[:100], us=us, calls=n) for us, k, n in rows
            if _PORT_KERNEL.search(k)]
    port_us = sum(r["us"] for r in port)
    _emit(dict(row, wall_us=wall_us, device_us=device_us,
               busy_share=device_us / wall_us,
               top=[dict(kernel=k[:100], us=us, calls=n,
                         share=us / device_us if device_us else None)
                    for us, k, n in rows[:top]],
               port_kernels=port, port_kernels_us=port_us,
               port_kernels_share=port_us / device_us if device_us
               else None))


def phase_profile(torch, net, x, forwards=3):
    """Device time by kernel over `forwards` full-bucket forwards."""
    with torch.inference_mode():
        _profile(torch, lambda: net(x), forwards, phase="profile",
                 batch=list(x.shape), forwards=forwards)


def _grad_tolerance(torch, ref, dt):
    """Elementwise bound on a flash gradient against its plain version.
    f32: BWD_TOL of the largest |ref|.  16-bit: both round P and dS at the
    same points and round the outputs to the dtype, and sums in another
    f32 order can tip a rounding by one ulp; within `_low_tolerance`."""
    if dt == "float32":
        return torch.full_like(ref, BWD_TOL * ref.abs().max().item())
    return _low_tolerance(ref, dt)


def phase_kernel_bwd(torch, att):
    """The dQ and dK/dV kernels against their plain versions over CASES;
    returns their rows by case."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rows = {}
    for BH, T, d, dt, causal in CASES:
        dtype = getattr(torch, dt)
        q, k, v, do = (torch.randn(BH, T, d, device="cuda", generator=gen)
                       .mul_(0.5).to(dtype) for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        out, lse = att.flash_attention_fwd(q, k, v, scale, causal)
        dq, delta = att.flash_attention_bwd_dq(q, k, v, out, lse, do, scale,
                                               causal)
        dk, dv = att.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                             causal)
        torch.cuda.synchronize()
        # each kernel against its plain version on the same inputs
        ref_dq, ref_delta = att.flash_attention_bwd_dq_plain(
            q, k, v, out, lse, do, scale, causal)
        ref_dk, ref_dv = att.flash_attention_bwd_dkv_plain(
            q, k, v, do, lse, delta, scale, causal)
        errs, ratios = {}, {}
        for name, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                               ("dv", dv, ref_dv)):
            ref = ref.float()
            diff = (got.float() - ref).abs()
            errs[name] = diff.max().item()
            ratios[name] = (diff / _grad_tolerance(torch, ref, dt)).max() \
                .item()
        err_delta = (delta - ref_delta).abs().max().item()
        tol_delta = BWD_TOL * max(ref_delta.abs().max().item(), 1.0)
        ok = max(ratios.values()) <= 1.0 and err_delta <= tol_delta
        dq_ms = _time_ms(torch, lambda: att.flash_attention_bwd_dq(
            q, k, v, out, lse, do, scale, causal))
        dkv_ms = _time_ms(torch, lambda: att.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, scale, causal))
        dq_plain_ms = _time_ms(torch, lambda: att.flash_attention_bwd_dq_plain(
            q, k, v, out, lse, do, scale, causal))
        dkv_plain_ms = _time_ms(
            torch, lambda: att.flash_attention_bwd_dkv_plain(
                q, k, v, do, lse, delta, scale, causal))
        # device time of the pair and of each kernel, as the library's is
        # read below
        pair_device_ms, pair_kernels = _device_ms(
            torch, lambda: att.flash_attention_bwd(q, k, v, out, lse, do,
                                                   scale, causal))
        dq_device_ms, dkv_device_ms = (
            sum(r["us"] for r in pair_kernels if name in r["kernel"]) / 1e3
            for name in ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"))
        # the library's backward alone: scaled_dot_product_attention's
        # forward once on 4-D (1, BH, T, d) views with its graph kept, then
        # autograd.grad over it again and again, timed by CUDA events and
        # by the device time of the kernels it launches.  It gives dq, dk
        # and dv together, so both kernel rows carry the same value.
        q4, k4, v4 = (t[None].detach().requires_grad_() for t in (q, k, v))
        out4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                              scale=scale)
        do4 = do[None]

        def sdpa_bwd():
            return torch.autograd.grad(out4, (q4, k4, v4), do4,
                                       retain_graph=True)

        library_events_ms = _time_ms(torch, sdpa_bwd)
        library_ms, library_kernels = _device_ms(torch, sdpa_bwd)
        del out4
        row = dict(phase="kernel_bwd", BH=BH, T=T, d=d, dtype=dt,
                   causal=causal, err=errs, err_over_bound=ratios,
                   err_delta=err_delta, tol_delta=tol_delta, ok=ok,
                   dq_ms=dq_ms, dkv_ms=dkv_ms, dq_plain_ms=dq_plain_ms,
                   dkv_plain_ms=dkv_plain_ms, dq_device_ms=dq_device_ms,
                   dkv_device_ms=dkv_device_ms, pair_device_ms=pair_device_ms,
                   library_ms=library_ms, library_events_ms=library_events_ms,
                   library="sdpa backward alone (autograd.grad over a kept "
                           "graph, 4-D views), device time",
                   library_kernels=library_kernels[:4],
                   pair_device_over_library=pair_device_ms / library_ms,
                   **_dq_bound(BH, T, d, dt, causal),
                   **_dkv_bound(BH, T, d, dt, causal))
        _emit(row)
        _check(ok, "flash backward disagrees with its plain version: %r"
               % (row,))
        rows[BH, T, d, dt, causal] = row
    return rows


def _train_step(mx, net, loss_fn, trainer, inputs, y):
    """One training step of `net` on the tuple `inputs` (batch first)."""
    with mx.autograd.record():
        loss = loss_fn(net(*inputs), y)
    mx.autograd.backward(loss)
    trainer.step(inputs[0].shape[0])
    return loss.detach()


def _tf32(torch, x, nearest=True):
    """x cut to TF32 (10 mantissa bits): to nearest, or truncated as the
    tensor cores read an f32 operand."""
    bits = x.contiguous().view(torch.int32)
    return (((bits + 0x1000) if nearest else bits) & ~0x1fff) \
        .view(torch.float32)


@contextlib.contextmanager
def _plain_backward(att, matmul, forward=False):
    """The attention backward (with `forward`, the forward too) taken by
    its plain version on the card, its products through `matmul`; the
    kernels again on exit."""
    saved = att.flash_attention_fwd, att.flash_attention_bwd, att._matmul
    att.flash_attention_bwd, att._matmul = att.flash_attention_bwd_plain, \
        matmul
    if forward:
        att.flash_attention_fwd = att.flash_attention_fwd_plain
    try:
        yield
    finally:
        att.flash_attention_fwd, att.flash_attention_bwd, att._matmul = \
            saved


@contextlib.contextmanager
def _launch_dtypes(att):
    """Yields a list that gets (kernel, operand dtype) for each flash
    kernel launch inside the block: the wrappers' CUDA entries are
    wrapped, their launch counters untouched."""
    log = []
    names = ("_flash_fwd_cuda", "_flash_bwd_dq_cuda", "_flash_bwd_dkv_cuda")
    saved = [getattr(att, n) for n in names]

    def logged(name, fn):
        def call(q, *args):
            log.append((name, str(q.dtype)))
            return fn(q, *args)
        return call

    for name, fn in zip(names, saved):
        setattr(att, name, logged(name, fn))
    try:
        yield log
    finally:
        for name, fn in zip(names, saved):
            setattr(att, name, fn)


# the three kernels' launch counters, then the causal ones among them
_COUNT_KEYS = ("fwd", "dq", "dkv", "fwd_causal", "dq_causal", "dkv_causal")
_COUNTERS = ("flash_fwd_launches", "flash_bwd_dq_launches",
             "flash_bwd_dkv_launches", "flash_fwd_causal_launches",
             "flash_bwd_dq_causal_launches", "flash_bwd_dkv_causal_launches")


def _all_counts(att):
    return tuple(getattr(att, name) for name in _COUNTERS)


def _reset_counts(att):
    for name in _COUNTERS:
        setattr(att, name, 0)


def phase_train(torch, mx, att):
    """BERT-base MLM training through the port's entry points; returns
    the launches of each kernel over the timed steps."""
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, 30522, (TRAIN_BATCH, SEQ)).astype(np.int32)
    labels = rs.randint(0, 30522, (TRAIN_BATCH, SEQ)).astype(np.float32)
    mx.random.seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = mx.models.bert_base(dropout=0.0, output_hidden=True,
                              device="cuda:0")
    head = mx.models.FusedMLMCELoss(30522, 768, device="cuda:0")
    layers = len(net.encoder.layers)
    params = dict(net.collect_params())
    params.update({"loss." + n: p for n, p in head.collect_params().items()})
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-4})

    # parity: one batch-1 step's loss and gradients against a CPU copy
    cpu_net = mx.models.bert_base(dropout=0.0, output_hidden=True,
                                  device="cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    cpu_head = mx.models.FusedMLMCELoss(30522, 768, device="cpu")
    cpu_head.load_state_dict({k: v.cpu()
                              for k, v in head.state_dict().items()})
    cpu_params = dict(cpu_net.collect_params())
    cpu_params.update({"loss." + n: p
                       for n, p in cpu_head.collect_params().items()})
    x1, y1 = torch.from_numpy(tokens[:1]), torch.from_numpy(labels[:1])
    with mx.autograd.record():
        ref_loss = cpu_head(cpu_net(x1), y1)
    mx.autograd.backward(ref_loss)
    gmax = max(p.grad.abs().max().item() for p in cpu_params.values())

    def worst_grad():
        worst, worst_name = 0.0, None
        for name, p in params.items():
            ref = cpu_params[name].grad
            err = (p.grad.cpu() - ref).abs().max().item()
            ratio = err / max(ref.abs().max().item(), 1e-3 * gmax)
            if ratio >= worst:
                worst, worst_name = ratio, name
        return worst, worst_name

    # the same gradients with the attention backward's plain version in
    # place of the kernels, its products in f32 and in one TF32 product
    # each: the kernels' share of the distance to the CPU copy, and what
    # TRAIN_TOL makes of 1xTF32 products.  Read only, held to nothing.
    plain_bwd = {}
    for label, matmul in (("f32", torch.matmul),
                          ("1xtf32", lambda a, b: torch.matmul(
                              _tf32(torch, a), _tf32(torch, b)))):
        with _plain_backward(att, matmul):
            with mx.autograd.record():
                loss = head(net(x1.cuda()), y1.cuda())
            mx.autograd.backward(loss)
        plain_bwd[label] = dict(zip(("worst_grad_err_over_scale",
                                     "worst_grad"), worst_grad()))
    loss1 = _train_step(mx, net, head, trainer, (x1.cuda(),), y1.cuda())
    loss_err = (loss1.cpu() - ref_loss.detach()).abs().max().item()
    worst, worst_name = worst_grad()
    del cpu_net, cpu_head, cpu_params, ref_loss

    x = torch.from_numpy(tokens).cuda()
    y = torch.from_numpy(labels).cuda()
    for _ in range(TRAIN_WARMUP):
        _train_step(mx, net, head, trainer, (x,), y)
    torch.cuda.synchronize()
    _reset_counts(att)                  # the main path starts here
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    losses, per_step = [], []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        before = _all_counts(att)[:3]
        losses.append(_train_step(mx, net, head, trainer, (x,), y).mean())
        events[i + 1].record()
        per_step.append(tuple(a - b for a, b in
                              zip(_all_counts(att)[:3], before)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _all_counts(att)[:3]     # the main path ends here
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(TRAIN_STEPS)]
    losses = [v.item() for v in losses]
    _emit(dict(phase="train", model="bert_base", dtype="float32",
               batch=TRAIN_BATCH, seq=SEQ, optimizer="adam", lr=1e-4,
               parity=dict(batch=1, loss_max_abs_err=loss_err,
                           loss_mean=loss1.mean().item(),
                           worst_grad_err_over_scale=worst,
                           worst_grad=worst_name, tol=TRAIN_TOL,
                           tensors=len(params), plain_backward=plain_bwd),
               warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
               step_ms=step_ms, step_ms_median=statistics.median(step_ms),
               wall_s=wall,
               tokens_per_s=TRAIN_STEPS * TRAIN_BATCH * SEQ / wall,
               losses=losses,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=dict(zip(("fwd", "dq", "dkv"), launches)),
               launches_per_step=sorted(set(per_step))))
    # the loss is a forward quantity: held as the served logits are
    _check(loss_err <= SERVE_TOL, "batch-1 loss differs from the CPU copy "
           "by %g > %g" % (loss_err, SERVE_TOL))
    _check(worst <= TRAIN_TOL, "gradient of %s differs from the CPU copy: "
           "%g of its scale > %g" % (worst_name, worst, TRAIN_TOL))
    _check(all(math.isfinite(v) for v in losses),
           "non-finite training loss: %r" % (losses,))
    _check(all(c == (layers,) * 3 for c in per_step),
           "a training step launched (fwd, dq, dkv) %r, not %d each"
           % (per_step, layers))
    _profile(torch, lambda: _train_step(mx, net, head, trainer, (x,), y), 1,
             top=16, phase="train_profile", batch=[TRAIN_BATCH, SEQ],
             steps=1)
    return dict(zip(("fwd", "dq", "dkv"), launches))


@contextlib.contextmanager
def _upcast_vocab_route(mx):
    """The fused CE's vocab GEMMs with bf16 operands upcast to f32 on the
    card (the CPU's route) in place of cuBLAS's bf16 GEMM with an f32
    output; the card route again on exit."""
    nn = mx.ops.nn
    route = nn._low_precision_card
    nn._low_precision_card = lambda a, b: False
    try:
        yield
    finally:
        nn._low_precision_card = route


def _vocab_routes(torch, mx, head, y):
    """One forward and backward of the fused vocab CE at the step's shape
    (BF16_BATCH x SEQ rows of bf16 hidden states, random from seed 0)
    by each route: CUDA-event ms (tens of ms a call, so the host's share
    is small), and the routes' largest loss and dh differences."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    h = torch.randn(y.numel(), head.weight.shape[1], device="cuda",
                    generator=gen).to(torch.bfloat16).requires_grad_()
    w, b, lab = head.weight, head.bias, y.reshape(-1)

    def fwd_bwd():
        loss = mx.ops.nn.fused_linear_softmax_ce(h, w, b, lab)
        return (loss,) + torch.autograd.grad(loss.sum(), (h, w, b))

    out = {}
    for route in ("bf16_f32_out", "upcast_f32"):
        ctx = _upcast_vocab_route(mx) if route == "upcast_f32" \
            else contextlib.nullcontext()
        with ctx:
            res = fwd_bwd()
            ms = _time_ms(torch, fwd_bwd, reps=3, rounds=3)
        out[route] = dict(ms=ms, res=res)
    a, c = out["bf16_f32_out"].pop("res"), out["upcast_f32"].pop("res")
    out["loss_max_abs_diff"] = (a[0] - c[0]).abs().max().item()
    out["dh_max_abs_diff"] = (a[1].float() - c[1].float()).abs().max().item()
    out["flops"] = 3 * 2.0 * y.numel() * w.shape[0] * w.shape[1]
    return out


def phase_train_bf16(torch, mx, att):
    """BERT-base MLM training in bf16 through the port's entry points, as
    bench.py's run_bert (net.cast and loss.cast to bf16, Adam lr 1e-4,
    batch 16 x 512); returns the launches of each kernel over the timed
    steps."""
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, 30522, (BF16_BATCH, SEQ)).astype(np.int32)
    labels = rs.randint(0, 30522, (BF16_BATCH, SEQ)).astype(np.float32)
    mx.random.seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = mx.models.bert_base(dropout=0.0, output_hidden=True,
                              device="cuda:0").cast("bfloat16")
    head = mx.models.FusedMLMCELoss(30522, 768, device="cuda:0") \
        .cast("bfloat16")
    layers = len(net.encoder.layers)
    params = dict(net.collect_params())
    params.update({"loss." + n: p for n, p in head.collect_params().items()})
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-4})

    # parity: a batch-1 step against an f32 CPU copy holding the same
    # bf16-valued weights (bf16 is exact in f32), by the kernels and by
    # the plain route (every flash kernel's plain version on the card)
    cpu_net = mx.models.bert_base(dropout=0.0, output_hidden=True,
                                  device="cpu")
    cpu_net.load_state_dict({k: v.float().cpu()
                             for k, v in net.state_dict().items()})
    cpu_head = mx.models.FusedMLMCELoss(30522, 768, device="cpu")
    cpu_head.load_state_dict({k: v.float().cpu()
                              for k, v in head.state_dict().items()})
    x1, y1 = torch.from_numpy(tokens[:1]), torch.from_numpy(labels[:1])
    with mx.autograd.record():
        ref_hidden = cpu_net(x1)
        ref_loss = cpu_head(ref_hidden, y1)
    mx.autograd.backward(ref_loss)
    ref_hidden = ref_hidden.detach()
    ref_grads = {n: p.grad for n, p in cpu_net.collect_params().items()}
    ref_grads.update({"loss." + n: p.grad
                      for n, p in cpu_head.collect_params().items()})
    top = max(r.abs().max().item() for r in ref_grads.values())
    scales = {n: max(r.abs().max().item(), 1e-3 * top)
              for n, r in ref_grads.items()}
    scales["hidden"] = ref_hidden.abs().max().item()

    def route_errors(loss, hidden):
        err = _scaled_err({n: p.grad for n, p in params.items()}, ref_grads)
        err["hidden"] = (hidden.float().cpu() - ref_hidden).abs().max() \
            .item() / scales["hidden"]
        worst = max((n for n in err if n != "hidden"), key=err.get)
        return err, dict(loss_max_abs_err=(loss.float().cpu()
                                           - ref_loss.detach()).abs().max()
                         .item(),
                         hidden_err_over_scale=err["hidden"],
                         worst_grad_err_over_scale=err[worst],
                         worst_grad=worst)

    def keep_hidden(h, y):
        hidden.append(h.detach())
        return head(h, y)

    hidden = []
    with _plain_backward(att, torch.matmul, forward=True):
        with mx.autograd.record():
            loss = keep_hidden(net(x1.cuda()), y1.cuda())
        mx.autograd.backward(loss)
    plain_err, plain = route_errors(loss, hidden.pop())
    loss1 = _train_step(mx, net, keep_hidden, trainer, (x1.cuda(),),
                        y1.cuda())
    kern_err, kern = route_errors(loss1, hidden.pop())
    # each tensor's kernel-route error over its gate (ok <= 1)
    over = {n: kern_err[n] / (BF16_ROUTE_FACTOR * plain_err[n]
                              + _bf16_ulp_share(scales[n]))
            for n in kern_err}
    worst_over = max(over, key=over.get)
    del cpu_net, cpu_head, ref_grads, ref_loss, ref_hidden

    x = torch.from_numpy(tokens).cuda()
    y = torch.from_numpy(labels).cuda()
    for _ in range(TRAIN_WARMUP):
        _train_step(mx, net, head, trainer, (x,), y)
    torch.cuda.synchronize()
    _reset_counts(att)                  # the main path starts here
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    losses, per_step = [], []
    with _launch_dtypes(att) as dtypes:
        t0 = time.perf_counter()
        events[0].record()
        for i in range(TRAIN_STEPS):
            before = _all_counts(att)
            losses.append(_train_step(mx, net, head, trainer, (x,), y)
                          .mean())
            events[i + 1].record()
            per_step.append(tuple(a - b for a, b in
                                  zip(_all_counts(att), before)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(zip(_COUNT_KEYS, _all_counts(att)))  # the path ends here
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(TRAIN_STEPS)]
    losses = [v.item() for v in losses]
    peak = torch.cuda.max_memory_allocated()
    vocab = _vocab_routes(torch, mx, head, y)
    per_step_want = (layers,) * 3 + (0,) * 3
    launch_dtypes = sorted(set(dtypes))
    _emit(dict(phase="train_bf16", model="bert_base", dtype="bfloat16",
               batch=BF16_BATCH, seq=SEQ, optimizer="adam", lr=1e-4,
               parity=dict(batch=1, kernels=kern, plain_route=plain,
                           route_factor=BF16_ROUTE_FACTOR,
                           loss_floor=BF16_LOSS_FLOOR,
                           loss_mean=loss1.mean().item(),
                           tensors=len(over),
                           worst_over_gate=over[worst_over],
                           worst_over_gate_tensor=worst_over,
                           # [tensor, e_kernels / gate, e_kernels, e_plain]
                           over_gate_top=[
                               [n, over[n], kern_err[n], plain_err[n]]
                               for n in sorted(over, key=over.get)[-6:]]),
               warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
               step_ms=step_ms, step_ms_median=statistics.median(step_ms),
               wall_s=wall,
               tokens_per_s=TRAIN_STEPS * BF16_BATCH * SEQ / wall,
               losses=losses, max_memory_allocated=peak,
               launches=launches, launch_dtypes=launch_dtypes,
               launches_per_step=[dict(zip(_COUNT_KEYS, c))
                                  for c in sorted(set(per_step))],
               vocab_projection=vocab))
    _check(kern["loss_max_abs_err"] <= BF16_ROUTE_FACTOR
           * plain["loss_max_abs_err"] + BF16_LOSS_FLOOR,
           "bf16 batch-1 loss by the kernels differs from the CPU copy by "
           "%g, more than %g x the plain route's %g + %g"
           % (kern["loss_max_abs_err"], BF16_ROUTE_FACTOR,
              plain["loss_max_abs_err"], BF16_LOSS_FLOOR))
    _check(over[worst_over] <= 1.0,
           "bf16 %s by the kernels differs from the CPU copy by %g of its "
           "scale, more than %g x the plain route's %g + one bf16 ulp"
           % (worst_over, kern_err[worst_over], BF16_ROUTE_FACTOR,
              plain_err[worst_over]))
    _check(all(math.isfinite(v) for v in losses),
           "non-finite bf16 training loss: %r" % (losses,))
    _check(all(c == per_step_want for c in per_step),
           "a bf16 training step launched %r (%s), not %r"
           % (per_step, ", ".join(_COUNT_KEYS), per_step_want))
    _check({dt for _, dt in launch_dtypes} == {"torch.bfloat16"},
           "the bf16 step launched kernel instances %r" % (launch_dtypes,))
    # the loss is a forward quantity: the two routes held as served logits
    _check(vocab["loss_max_abs_diff"] <= SERVE_TOL, "the vocab projection's "
           "routes disagree on the loss by %g" % vocab["loss_max_abs_diff"])
    _profile(torch, lambda: _train_step(mx, net, head, trainer, (x,), y), 1,
             top=16, phase="train_bf16_profile", batch=[BF16_BATCH, SEQ],
             steps=1)
    return launches


def conv_cases(cs):
    """kernel_conv cases (N, C, HW, O, dtype): the step's shapes in bf16
    (`cs.RESNET_CONV_SHAPES`), the tool's five shapes in f32, ragged
    shapes in both dtypes, and the f16 instances at three step shapes
    (rows, and both slab tilings) and a ragged one."""
    return ([(RESNET_BATCH, C, HW, O, "bfloat16")
             for C, HW, O, _ in cs.RESNET_CONV_SHAPES]
            + [(RESNET_BATCH, C, HW, O, "float32") for C, HW, O in (
                (64, 3136, 256), (128, 784, 512), (256, 196, 1024),
                (512, 49, 2048), (256, 3136, 64))]
            + [(3, 72, 49, 80, "bfloat16"), (3, 72, 49, 80, "float32"),
               (5, 17, 33, 65, "bfloat16"), (1, 1, 1, 1, "float32")]
            + [(RESNET_BATCH, C, HW, O, "float16") for C, HW, O in (
                (64, 3136, 256), (1024, 196, 256), (512, 49, 2048))]
            + [(5, 17, 33, 65, "float16")])


def conv_y_errors(torch, cs, x, w, y, ref_y):
    """The largest error of y over its elementwise tolerance (ok <= 1).
    f32 {kernel}: |y - plain| against 1e-4 of the largest |plain|.  bf16
    and f16 {kernel, plain}: |y - e| of the kernel's y and of the plain
    version's against `cs.conv1x1_y_bound`."""
    if x.dtype == torch.float32:
        tol = 1e-4 * ref_y.abs().max().item()
        return dict(kernel=(y - ref_y).abs().max().item() / max(tol, 1e-30))
    exact, bound = cs.conv1x1_y_bound(x, w)
    bound.clamp_(min=1e-300)
    return {name: ((got.double() - exact).abs() / bound).max().item()
            for name, got in (("kernel", y), ("plain", ref_y))}


def _conv_bound(N, C, HW, O, dtype):
    """Roofline of the fused call: the 2·N·HW·C·O product operations; x
    and w read, y written, and the two (O,) f32 sums written once."""
    elem = 4 if dtype == "float32" else 2
    flops = 2.0 * N * HW * C * O
    nbytes = (N * C * HW + O * C + N * O * HW) * elem + 2 * 4.0 * O
    return _roofline(flops, nbytes, dtype)


def phase_kernel_conv(torch, cs):
    """The fused 1x1-conv + statistics kernel against its plain version
    over `conv_cases`; returns the per-step sums over the 33 launch sites
    of a bf16 resnet50_v1b step."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    sites = {(C, HW, O): k for C, HW, O, k in cs.RESNET_CONV_SHAPES}
    step = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, library_conv_ms=0.0,
                bound_ms=0.0, max_abs_err=0.0, launches=0)
    bound_by_ms = dict(bytes=0.0, operations=0.0)
    for N, C, HW, O, dt in conv_cases(cs):
        dtype = getattr(torch, dt)
        x = torch.randn(N, C, HW, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(O, C, device="cuda", generator=gen) * 0.05) \
            .to(dtype)
        path = cs.conv1x1_stats_path(N, C, HW, O, dtype)
        y, s1, s2 = cs.fused_conv1x1_stats(x, w)
        torch.cuda.synchronize()
        ref_y, ref_s1, ref_s2 = cs.fused_conv1x1_stats_plain(x, w)
        err_y = (y.float() - ref_y.float()).abs().max().item()
        y_over_bound = conv_y_errors(torch, cs, x, w, y, ref_y)
        rel_s1 = ((s1 - ref_s1).abs()
                  / (N * HW * ref_s2).sqrt().clamp_min(1e-30)).max().item()
        rel_s2 = ((s2 - ref_s2).abs() / ref_s2.clamp_min(1e-30)) \
            .max().item()
        ok = (max(y_over_bound.values()) <= 1.0 and rel_s1 <= CONV_SUM_TOL
              and rel_s2 <= CONV_SUM_TOL)
        ms = _time_ms(torch, lambda: cs.fused_conv1x1_stats(x, w))
        plain_ms = _time_ms(torch, lambda: cs.fused_conv1x1_stats_plain(
            x, w))
        # the library route: cuDNN's 1x1 convolution, then the two f32
        # sums of its (rounded) output, and the convolution alone;
        # yardsticks the port never calls
        x4, w4 = x.reshape(N, C, HW, 1), w.reshape(O, C, 1, 1)

        def library():
            y4 = F.conv2d(x4, w4).float()
            return y4.sum(dim=(0, 2, 3)), y4.square().sum(dim=(0, 2, 3))

        library_ms = _time_ms(torch, library)
        library_conv_ms = _time_ms(torch, lambda: F.conv2d(x4, w4))
        bound = _conv_bound(N, C, HW, O, dt)
        row = dict(phase="kernel_conv", name="conv1x1_stats", N=N, C=C,
                   HW=HW, O=O, dtype=dt, path=path, err_y=err_y,
                   y_over_bound=y_over_bound, rel_err_s1=rel_s1,
                   rel_err_s2=rel_s2, tol_sums=CONV_SUM_TOL, ok=ok, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   library="F.conv2d 1x1 + two f32 sums",
                   library_conv_ms=library_conv_ms, **bound,
                   bound_share=bound["bound_ms"] / ms)
        _emit(row)
        _check(ok, "conv1x1_stats disagrees with its plain version or the "
                   "exact product: %r" % (row,))
        k = sites.get((C, HW, O)) if (N, dt) == (RESNET_BATCH,
                                                 "bfloat16") else None
        if k:
            _check(path.startswith("tensor_cores"), "the step shape %r "
                   "takes the %s instance, not the tensor cores"
                   % ((C, HW, O), path))
            for key in ("ms", "plain_ms", "library_ms", "library_conv_ms",
                        "bound_ms"):
                step[key] += k * row[key]
            step["max_abs_err"] = max(step["max_abs_err"], err_y)
            bound_by_ms[row["bound_by"]] += k * row["bound_ms"]
            step["launches"] += k
    _check(step["launches"] == RESNET_SITES, "the step's conv shapes cover "
           "%d launch sites, not %d" % (step["launches"], RESNET_SITES))
    # what bounds most of the step's summed bound
    step["bound_by"] = max(bound_by_ms, key=bound_by_ms.get)
    return step


def _resnet_grads(mx, net, loss_fn, x, y):
    """One forward and backward in training mode: the per-example loss,
    {name: gradient} of the trainable tensors and {name: value} of the
    running statistics (which the forward updated), on the CPU."""
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    mx.autograd.backward(loss)
    params = net.collect_params()
    # copies: the next forward updates the running statistics in place
    return (loss.detach().cpu(),
            {n: p.grad.detach().cpu().clone() for n, p in params.items()
             if p.requires_grad},
            {n: p.detach().cpu().clone() for n, p in params.items()
             if not p.requires_grad})


def _small_resnet_parity(torch, mx, loss_fn):
    """A small ResNet v1b (9 fused pairs) through one f32 step of batch 4
    on the card against a CPU copy: every gradient within TRAIN_TOL of
    its scale."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet
    kw = dict(SMALL_RESNET)
    args = (resnet.BottleneckV1, kw.pop("layers"), kw.pop("channels"))
    net = resnet.ResNetV1(*args, device="cuda:0", **kw)
    cpu = resnet.ResNetV1(*args, device="cpu", **kw)
    cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(4, 3, 32, 32).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 4).astype(np.float32))
    loss, grads, _ = _resnet_grads(mx, net, loss_fn, x.cuda(), y.cuda())
    ref_loss, ref_grads, _ = _resnet_grads(mx, cpu, loss_fn, x, y)
    err = _scaled_err(grads, ref_grads)
    worst = max(err, key=err.get)
    return dict(batch=4, image=[3, 32, 32], gradients=len(err),
                loss_max_abs_err=(loss - ref_loss).abs().max().item(),
                worst_grad_err_over_scale=err[worst], worst_grad=worst,
                grad_tol=TRAIN_TOL)


def _bf16_ulp_share(scale):
    """One bf16 ulp at `scale` (8 significant bits) over `scale`."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7) / scale


def _scaled_err(got, ref):
    """{name: max-abs error over max-abs value}, each value floored at
    1e-3 of the largest among `ref`."""
    top = max(r.abs().max().item() for r in ref.values())
    return {n: (got[n].cpu() - r).abs().max().item()
            / max(r.abs().max().item(), 1e-3 * top) for n, r in ref.items()}


def phase_train_resnet(torch, mx, cs):
    """resnet50_v1b training through the port's entry points, as
    bench.py's run_cachedop; returns the conv kernel's launches over the
    timed steps."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
        resnet50_v1b
    rs = np.random.RandomState(0)
    images = rs.randn(RESNET_BATCH, 3, 224, 224).astype(np.float32)
    labels = rs.randint(0, 1000, RESNET_BATCH).astype(np.float32)
    mx.random.seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = resnet50_v1b(classes=1000, device="cuda:0")
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    params = net.collect_params()
    trainer = mx.gluon.Trainer(params, "sgd", {
        "learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4})

    # parity: one batch-2 f32 step against a CPU copy (TF32 is off)
    cpu_net = resnet50_v1b(classes=1000, device="cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    x2 = torch.from_numpy(images[:RESNET_PARITY_BATCH])
    y2 = torch.from_numpy(labels[:RESNET_PARITY_BATCH])
    loss2, grads, running = _resnet_grads(mx, net, loss_fn, x2.cuda(),
                                          y2.cuda())
    trainer.step(RESNET_PARITY_BATCH)
    ref_loss, ref_grads, ref_running = _resnet_grads(mx, cpu_net, loss_fn,
                                                     x2, y2)
    # the CPU copy against itself, its input scaled by 1 + 2**-22
    _, spread_grads, _ = _resnet_grads(mx, cpu_net, loss_fn,
                                       x2 * (1.0 + 2.0 ** -22), y2)
    loss_err = (loss2.cpu() - ref_loss).abs().max().item()
    grad_err = _scaled_err(grads, ref_grads)
    spread = _scaled_err(spread_grads, ref_grads)
    run_err = _scaled_err(running, ref_running)
    worst_grad = max(grad_err, key=grad_err.get)
    worst_run = max(run_err, key=run_err.get)
    grad_max = dict(card=grad_err[worst_grad], cpu_spread=max(spread.values()))
    grad_median = dict(card=statistics.median(grad_err.values()),
                       cpu_spread=statistics.median(spread.values()))
    del cpu_net, ref_grads, spread_grads, grads, running, ref_running
    small = _small_resnet_parity(torch, mx, loss_fn)

    x = torch.from_numpy(images).cuda().to(torch.bfloat16)  # bench.py's cast
    y = torch.from_numpy(labels).cuda()
    for _ in range(TRAIN_WARMUP):
        _train_step(mx, net, loss_fn, trainer, (x,), y)
    torch.cuda.synchronize()
    cs.conv1x1_stats_launches = 0       # the main path starts here
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    losses, per_step = [], []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        before = cs.conv1x1_stats_launches
        losses.append(_train_step(mx, net, loss_fn, trainer, (x,), y).mean())
        events[i + 1].record()
        per_step.append(cs.conv1x1_stats_launches - before)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cs.conv1x1_stats_launches    # the main path ends here
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(TRAIN_STEPS)]
    losses = [v.item() for v in losses]
    _emit(dict(phase="train_resnet", model="resnet50_v1b", classes=1000,
               dtype="bfloat16", batch=RESNET_BATCH, image=[3, 224, 224],
               optimizer="sgd", lr=0.1, momentum=0.9, wd=1e-4,
               parity=dict(batch=RESNET_PARITY_BATCH, dtype="float32",
                           loss_max_abs_err=loss_err,
                           loss_mean=loss2.mean().item(),
                           grad_err_over_scale_max=grad_max,
                           grad_err_over_scale_median=grad_median,
                           worst_grad=worst_grad,
                           spread_factor=RESNET_SPREAD_FACTOR,
                           within_train_tol=sum(
                               v <= TRAIN_TOL for v in grad_err.values()),
                           gradients=len(grad_err),
                           worst_running_err_over_scale=run_err[worst_run],
                           worst_running=worst_run, running_tol=RUNNING_TOL,
                           running_tensors=len(run_err),
                           small_resnet=small),
               warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
               step_ms=step_ms, step_ms_median=statistics.median(step_ms),
               wall_s=wall,
               images_per_s=TRAIN_STEPS * RESNET_BATCH / wall,
               losses=losses,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               conv1x1_stats_launches=launches,
               launches_per_step=sorted(set(per_step))))
    _check(loss_err <= SERVE_TOL, "batch-2 loss differs from the CPU copy "
           "by %g > %g" % (loss_err, SERVE_TOL))
    _check(len(grad_err) == 161, "%d trainable tensors, not 161"
           % len(grad_err))
    for name, v in (("largest", grad_max), ("median", grad_median)):
        _check(v["card"] <= RESNET_SPREAD_FACTOR * v["cpu_spread"],
               "the %s gradient error against the CPU copy, %g of its "
               "scale, exceeds %g x the CPU copy's own rounding spread %g"
               % (name, v["card"], RESNET_SPREAD_FACTOR, v["cpu_spread"]))
    _check(small["worst_grad_err_over_scale"] <= TRAIN_TOL,
           "small ResNet gradient differs from the CPU copy: %r" % (small,))
    _check(small["loss_max_abs_err"] <= 1e-4,
           "small ResNet loss differs from the CPU copy: %r" % (small,))
    _check(run_err[worst_run] <= RUNNING_TOL, "running statistic %s differs "
           "from the CPU copy: %g of its scale > %g"
           % (worst_run, run_err[worst_run], RUNNING_TOL))
    _check(all(math.isfinite(v) for v in losses),
           "non-finite training loss: %r" % (losses,))
    _check(all(c == RESNET_SITES for c in per_step),
           "a training step launched the conv kernel %r times, not %d"
           % (per_step, RESNET_SITES))
    _profile(torch, lambda: _train_step(mx, net, loss_fn, trainer, (x,), y),
             1, top=16, phase="train_resnet_profile",
             batch=[RESNET_BATCH, 3, 224, 224], steps=1)
    return launches


def _window(eng, rs, vocab):
    """Sustained traffic: WINDOW_CLIENTS threads each submit
    WINDOW_PER_CLIENT singles, keeping WINDOW_INFLIGHT of them outstanding
    and dropping each result once it is checked.  Returns each request's
    e2e latency (s, submit -> future resolved) and the window's wall."""
    n = WINDOW_CLIENTS * WINDOW_PER_CLIENT
    toks = rs.randint(0, vocab, size=(n, SEQ)).astype(np.int32)
    lat = []
    lock = threading.Lock()

    def stamp(t_sub):
        def done(_fut):
            dt = time.monotonic() - t_sub
            with lock:
                lat.append(dt)
        return done

    def take(fut):
        out = fut.result(timeout=300)
        _check(tuple(out.shape) == (SEQ, vocab),
               "window result shape %s" % (tuple(out.shape),))

    def client(rows):
        pending = deque()
        for row in rows:
            if len(pending) == WINDOW_INFLIGHT:
                take(pending.popleft())
            t_sub = time.monotonic()
            fut = eng.submit(row)
            fut.add_done_callback(stamp(t_sub))
            pending.append(fut)
        while pending:
            take(pending.popleft())

    t0 = time.monotonic()
    with ThreadPoolExecutor(WINDOW_CLIENTS) as pool:
        jobs = [pool.submit(client, toks[j::WINDOW_CLIENTS])
                for j in range(WINDOW_CLIENTS)]
        for job in jobs:
            job.result(timeout=600)     # re-raises a client's failure
    wall = time.monotonic() - t0
    _check(len(lat) == n, "%d of %d window requests resolved"
           % (len(lat), n))
    return np.asarray(lat), wall


def phase_serve(torch, mx, att):
    rs = np.random.RandomState(0)
    mx.random.seed(0)
    torch.cuda.reset_peak_memory_stats()
    net = mx.models.bert_base(device="cuda:0")
    vocab = net.decoder.weight.shape[0]
    layers = len(net.encoder.layers)
    eng = net.inference_engine(buckets=SERVE_BUCKETS, example_shape=(SEQ,),
                               wire_dtype="int32")
    singles = [rs.randint(0, vocab, size=(SEQ,)).astype(np.int32)
               for _ in range(12)]
    batch = rs.randint(0, vocab, size=(3, SEQ)).astype(np.int32)
    futures = {}
    lock = threading.Lock()

    def client(idx):
        for i in idx:
            fut = eng.submit(singles[i])
            with lock:
                futures[i] = fut

    att.flash_fwd_launches = 0          # the main path starts here
    warm = eng.warmup()
    # a burst: 12 singles from 3 threads and one batch of 3, every result
    # kept and checked
    threads = [threading.Thread(target=client, args=(range(j, 12, 3),))
               for j in range(3)]
    for t in threads:
        t.start()
    batch_fut = eng.submit_batch(batch)
    for t in threads:
        t.join(timeout=300)
    results = {i: f.result(timeout=300) for i, f in futures.items()}
    batch_out = batch_fut.result(timeout=300)
    before = eng.stats()
    lat, wall = _window(eng, rs, vocab)
    launches = att.flash_fwd_launches   # the main path ends here
    _check(eng.close(timeout=60), "engine dispatcher did not retire")
    stats = eng.stats()
    batches = stats["batches"] + stats["warmup_batches"]

    _check(len(results) == 12, "only %d of 12 singles resolved"
           % len(results))
    for out in results.values():
        _check(tuple(out.shape) == (SEQ, vocab),
               "single result shape %s" % (tuple(out.shape),))
        _check(bool(torch.isfinite(out).all()), "non-finite logits")
    _check(tuple(batch_out.shape) == (3, SEQ, vocab),
           "batch result shape %s" % (tuple(batch_out.shape),))
    _check(bool(torch.isfinite(batch_out).all()), "non-finite logits")
    n_window = WINDOW_CLIENTS * WINDOW_PER_CLIENT
    _check(stats["requests"] == 13 + n_window, "engine counted %d requests"
           % stats["requests"])
    _check(launches == layers * batches,
           "flash kernel launched %d times for %d batches of %d layers"
           % (launches, batches, layers))

    # one full bucket forward timed on the card
    x8 = torch.from_numpy(np.stack(singles[:8])).cuda()
    with torch.inference_mode():
        fwd8_ms = _time_ms(torch, lambda: net(x8), reps=3, rounds=3)

    cpu_net = mx.models.bert_base(device="cpu")
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    cpu_net.eval()
    with torch.inference_mode():
        ref = cpu_net(torch.from_numpy(singles[0][None]))[0]
    err = (results[0].cpu() - ref).abs().max().item()
    window_buckets = {b: stats["bucket_batches"][b]
                      - before["bucket_batches"][b] for b in SERVE_BUCKETS}
    _emit(dict(phase="serve", model="bert_base", dtype="float32",
               seq=SEQ, buckets=list(SERVE_BUCKETS),
               warmup_batches=stats["warmup_batches"],
               burst=dict(requests=13, examples=before["examples"],
                          batches=before["batches"]),
               window=dict(clients=WINDOW_CLIENTS,
                           inflight_per_client=WINDOW_INFLIGHT,
                           requests=n_window,
                           batches=stats["batches"] - before["batches"],
                           bucket_batches=window_buckets, wall_s=wall,
                           requests_per_s=n_window / wall,
                           tokens_per_s=n_window * SEQ / wall,
                           e2e_p50_ms=float(np.percentile(lat, 50) * 1e3),
                           e2e_p99_ms=float(np.percentile(lat, 99) * 1e3),
                           e2e_max_ms=float(lat.max() * 1e3)),
               flash_fwd_launches=launches, batches=batches,
               warmup_s=warm["wall_s"], forward_bucket8_ms=fwd8_ms,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               cpu_max_abs_err=err, cpu_tol=SERVE_TOL))
    _check(err <= SERVE_TOL, "served logits differ from the CPU copy by "
                             "%g > %g" % (err, SERVE_TOL))
    phase_profile(torch, net, x8)
    return launches


def _nmt_data():
    """bench.py's run_transformer_nmt inputs: src, tgt and labels (64 x 64
    each) drawn in that order from RandomState(0)."""
    rs = np.random.RandomState(0)
    shape = (NMT_BATCH, NMT_SEQ)
    src = rs.randint(0, NMT_VOCAB, shape).astype(np.int32)
    tgt = rs.randint(0, NMT_VOCAB, shape).astype(np.int32)
    labels = rs.randint(0, NMT_VOCAB, shape).astype(np.float32)
    return src, tgt, labels


def _nmt_model(mx, device, **kw):
    return mx.models.transformer_nmt_base(NMT_VOCAB, NMT_VOCAB, dropout=0.0,
                                          device=device, **kw)


def phase_train_nmt(torch, mx, att):
    """transformer_nmt_base training through the port's entry points, as
    bench.py's run_transformer_nmt; returns each kernel's launches over
    the timed steps, and the causal ones among them."""
    src, tgt, labels = _nmt_data()
    mx.random.seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = _nmt_model(mx, "cuda:0", output_hidden=True)
    head = mx.models.FusedMLMCELoss(NMT_VOCAB, NMT_UNITS, device="cuda:0")
    params = dict(net.collect_params())
    params.update({"loss." + n: p for n, p in head.collect_params().items()})
    trainer = mx.gluon.Trainer(params, "adam", {"learning_rate": 1e-4})

    # parity: one batch-1 step's loss and gradients against a CPU copy
    cpu_net = _nmt_model(mx, "cpu", output_hidden=True)
    cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    cpu_head = mx.models.FusedMLMCELoss(NMT_VOCAB, NMT_UNITS, device="cpu")
    cpu_head.load_state_dict({k: v.cpu()
                              for k, v in head.state_dict().items()})
    s1, t1, y1 = (torch.from_numpy(a[:1]) for a in (src, tgt, labels))
    with mx.autograd.record():
        ref_loss = cpu_head(cpu_net(s1, t1), y1)
    mx.autograd.backward(ref_loss)
    ref_grads = {n: p.grad for n, p in cpu_net.collect_params().items()}
    ref_grads.update({"loss." + n: p.grad
                      for n, p in cpu_head.collect_params().items()})
    loss1 = _train_step(mx, net, head, trainer, (s1.cuda(), t1.cuda()),
                        y1.cuda())
    loss_err = (loss1.cpu() - ref_loss.detach()).abs().max().item()
    grad_err = _scaled_err({n: p.grad for n, p in params.items()}, ref_grads)
    worst_name = max(grad_err, key=grad_err.get)
    del cpu_net, cpu_head, ref_grads, ref_loss

    s, t, y = (torch.from_numpy(a).cuda() for a in (src, tgt, labels))
    for _ in range(TRAIN_WARMUP):
        _train_step(mx, net, head, trainer, (s, t), y)
    torch.cuda.synchronize()
    _reset_counts(att)                  # the main path starts here
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    losses, per_step = [], []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        before = _all_counts(att)
        losses.append(_train_step(mx, net, head, trainer, (s, t), y).mean())
        events[i + 1].record()
        per_step.append(tuple(a - b for a, b in
                              zip(_all_counts(att), before)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(zip(_COUNT_KEYS, _all_counts(att)))  # the path ends here
    step_ms = [events[i].elapsed_time(events[i + 1])
               for i in range(TRAIN_STEPS)]
    losses = [v.item() for v in losses]
    per_step_want = (2 * NMT_LAYERS,) * 3 + (NMT_LAYERS,) * 3
    _emit(dict(phase="train_nmt", model="transformer_nmt_base",
               dtype="float32", batch=NMT_BATCH, src_len=NMT_SEQ,
               tgt_len=NMT_SEQ, vocab=NMT_VOCAB, optimizer="adam", lr=1e-4,
               parameters=sum(p.numel() for p in params.values()),
               parity=dict(batch=1, loss_max_abs_err=loss_err,
                           loss_mean=loss1.mean().item(),
                           worst_grad_err_over_scale=grad_err[worst_name],
                           worst_grad=worst_name, tol=TRAIN_TOL,
                           tensors=len(grad_err)),
               warmup_steps=TRAIN_WARMUP, steps=TRAIN_STEPS,
               step_ms=step_ms, step_ms_median=statistics.median(step_ms),
               wall_s=wall,
               tgt_tokens_per_s=TRAIN_STEPS * NMT_BATCH * NMT_SEQ / wall,
               losses=losses,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=launches,
               launches_per_step=[dict(zip(_COUNT_KEYS, c))
                                  for c in sorted(set(per_step))]))
    _check(loss_err <= SERVE_TOL, "batch-1 loss differs from the CPU copy "
           "by %g > %g" % (loss_err, SERVE_TOL))
    _check(grad_err[worst_name] <= TRAIN_TOL, "gradient of %s differs from "
           "the CPU copy: %g of its scale > %g"
           % (worst_name, grad_err[worst_name], TRAIN_TOL))
    _check(all(math.isfinite(v) for v in losses),
           "non-finite training loss: %r" % (losses,))
    _check(all(c == per_step_want for c in per_step),
           "a training step launched %r (%s), not %r"
           % (per_step, ", ".join(_COUNT_KEYS), per_step_want))
    _profile(torch, lambda: _train_step(mx, net, head, trainer, (s, t), y), 1,
             top=16, phase="train_nmt_profile",
             batch=[NMT_BATCH, NMT_SEQ, NMT_SEQ], steps=1)
    return launches


def phase_decode_nmt(torch, mx, att):
    """transformer_nmt_base's cached decode on cuda:0: init_cache, then
    NMT_DECODE_STEPS greedy decode_steps, each step's logits held against
    the teacher-forced forward and a CPU copy."""
    src, _, _ = _nmt_data()
    rows = len(NMT_DECODE_VALID)
    mx.random.seed(0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    net = _nmt_model(mx, "cuda:0")
    s = torch.from_numpy(src[:rows]).cuda()
    valid = torch.tensor(NMT_DECODE_VALID, dtype=torch.float32,
                         device="cuda")

    def greedy():
        """Prefill and NMT_DECODE_STEPS greedy steps from NMT_BOS: the fed
        tokens (rows, steps), the logits (rows, steps, vocab) and CUDA
        events around the prefill and each step."""
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(NMT_DECODE_STEPS + 2)]
        events[0].record()
        cache = net.init_cache(s, valid, max_len=NMT_DECODE_STEPS,
                               mem_len=NMT_MEM_LEN)
        events[1].record()
        tok = torch.full((rows,), NMT_BOS, dtype=torch.long, device="cuda")
        fed, logits = [], []
        for i in range(NMT_DECODE_STEPS):
            fed.append(tok)
            out, cache = net.decode_step(
                tok, torch.full((rows,), i, device="cuda"), cache)
            events[i + 2].record()
            logits.append(out)
            tok = out.argmax(-1)
        return torch.stack(fed, 1), torch.stack(logits, 1), events

    with torch.inference_mode():
        greedy()                        # warm-up
        # device time by kernel over one prefill and its greedy steps
        _profile(torch, greedy, 1, top=8, phase="decode_nmt_profile",
                 rows=rows, steps=NMT_DECODE_STEPS)
        torch.cuda.synchronize()
        _reset_counts(att)              # the main path starts here
        t0 = time.perf_counter()
        fed, logits, events = greedy()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(zip(_COUNT_KEYS, _all_counts(att)))  # path ends
        prefill_ms = events[0].elapsed_time(events[1])
        step_ms = [events[i + 1].elapsed_time(events[i + 2])
                   for i in range(NMT_DECODE_STEPS)]
        # the teacher-forced forward over the fed prefix, on the card
        forced = net(s, fed, src_valid_length=valid)
        err_forced = (logits - forced).abs().max().item()
        cpu_net = _nmt_model(mx, "cpu")
        cpu_net.load_state_dict({k: v.cpu()
                                 for k, v in net.state_dict().items()})
        cache = cpu_net.init_cache(s.cpu(), valid.cpu(),
                                   max_len=NMT_DECODE_STEPS,
                                   mem_len=NMT_MEM_LEN)
        err_cpu = 0.0
        for i in range(NMT_DECODE_STEPS):
            out, cache = cpu_net.decode_step(fed[:, i].cpu(),
                                             torch.full((rows,), i), cache)
            err_cpu = max(err_cpu,
                          (logits[:, i].cpu() - out).abs().max().item())
    _emit(dict(phase="decode_nmt", model="transformer_nmt_base",
               dtype="float32", rows=rows, src_len=NMT_SEQ,
               src_valid_length=list(NMT_DECODE_VALID), mem_len=NMT_MEM_LEN,
               steps=NMT_DECODE_STEPS, prefill_ms=prefill_ms,
               step_ms=step_ms, step_ms_median=statistics.median(step_ms),
               wall_s=wall, tokens_per_s=rows * NMT_DECODE_STEPS / wall,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               distinct_tokens=int(fed.unique().numel()),
               forced_max_abs_err=err_forced, cpu_max_abs_err=err_cpu,
               tol=SERVE_TOL, launches=launches))
    _check(tuple(logits.shape) == (rows, NMT_DECODE_STEPS, NMT_VOCAB),
           "decode logits of shape %s" % (tuple(logits.shape),))
    _check(bool(torch.isfinite(logits).all()), "non-finite decode logits")
    # f32 logits of size ~1 through 6 + 6 layers, held as the served ones
    _check(err_forced <= SERVE_TOL, "decode logits differ from the "
           "teacher-forced forward by %g > %g" % (err_forced, SERVE_TOL))
    _check(err_cpu <= SERVE_TOL, "decode logits differ from the CPU copy "
           "by %g > %g" % (err_cpu, SERVE_TOL))
    _check(not any(launches.values()), "the decode steps launched flash "
           "kernels: %r" % (launches,))


def _shape_rows(fwd_rows, bwd_rows, kernel, cases):
    """One kernel's times at a path's shapes `cases`, by "non_causal" and
    "causal": {ms, device_ms, plain_ms, bound_ms, bound_by, library_ms}
    with library_ms the device time of SDPA (forward) or of its backward
    alone (the dQ and dK/dV kernels together)."""
    out = {}
    for case in cases:
        if kernel == "fwd":
            r, pre = fwd_rows[case], ""
            library_ms = r["library_device_ms"]
        else:
            r, pre = bwd_rows[case], kernel + "_"
            library_ms = r["library_ms"]
        out["causal" if case[-1] else "non_causal"] = dict(
            ms=r[pre + "ms"], device_ms=r[pre + "device_ms"],
            plain_ms=r[pre + "plain_ms"], bound_ms=r[pre + "bound_ms"],
            bound_by=r[pre + "bound_by"], library_ms=library_ms)
    return out


# template arguments of a mangled kernel name: float, bf16, int, bool
_PTX_ARG = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16",
            "Lb0E": "false", "Lb1E": "true"}


def _ptxas(reports):
    """{"kernel<args>": {registers, spill_store_bytes}} from ptxas's
    report: each "Compiling entry function" line names a template instance
    by its mangled name, the spill line and the "Used N registers" line
    that follow are its own."""
    out, name = {}, None
    for log in reports.values():
        for line in log.splitlines():
            m = re.search(r"(flash_[a-z_]+_kernel|conv1x1_stats(?:_tc)?_kernel"
                          r"|stats_reduce_kernel)"
                          r"((?:I(?:f|13__nv_bfloat16|6__half|Li\d+E"
                          r"|Lb[01]E)+E)?)",
                          line)
            if "Compiling entry function" in line and m:
                args = [_PTX_ARG.get(a, a[2:-1]) for a in re.findall(
                    r"13__nv_bfloat16|6__half|Li\d+E|Lb[01]E|f",
                    m.group(2))]
                name = m.group(1) + ("<%s>" % ", ".join(args) if args
                                     else "")
                out[name] = {}
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and name:
                out[name]["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out[name]["registers"], name = int(m.group(1)), None
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import _kernels
    from incubator_mxnet_tpu_torch.ops import attention as att
    from incubator_mxnet_tpu_torch.ops import conv_stats as cs

    # f32 products stay full f32 on the card (no TF32), so the kernel and
    # the served logits can be held to f32 tolerances
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    _emit(dict(phase="env", nvidia_smi=smi, device=name,
               capability=list(cap), torch=torch.__version__,
               cuda=torch.version.cuda))
    _check(cap == (9, 0), "needs a Hopper card (capability 9.0), got %s"
           % (cap,))

    t0 = time.monotonic()
    reports = _kernels.build_all()
    ptxas = _ptxas(reports)
    _emit(dict(phase="build", seconds=time.monotonic() - t0,
               kernels=sorted(_kernels.SOURCES), built=sorted(reports),
               spill_store_bytes=sum(k.get("spill_store_bytes", 0)
                                     for k in ptxas.values()),
               ptxas=ptxas))

    fwd_rows = phase_kernel(torch, att)
    main_row = fwd_rows[BERT_CASE]
    launches = phase_serve(torch, mx, att)
    bwd_rows = phase_kernel_bwd(torch, att)
    bwd_row = bwd_rows[BERT_CASE]
    train_launches = phase_train(torch, mx, att)
    bf16_launches = phase_train_bf16(torch, mx, att)
    conv_step = phase_kernel_conv(torch, cs)
    conv_launches = phase_train_resnet(torch, mx, cs)
    nmt_launches = phase_train_nmt(torch, mx, att)
    phase_decode_nmt(torch, mx, att)

    def nmt(kernel):
        """A flash row's NMT-path and bf16-path launches and their shapes'
        times."""
        return dict(nmt_launches=dict(total=nmt_launches[kernel],
                                      causal=nmt_launches[kernel + "_causal"]),
                    nmt_shape=_shape_rows(fwd_rows, bwd_rows, kernel,
                                          NMT_CASES),
                    bf16_launches=bf16_launches[kernel],
                    bf16_shape=_shape_rows(fwd_rows, bwd_rows, kernel,
                                           BF16_CASES)["non_causal"])
    shape = dict(shape=[main_row["BH"], main_row["T"], main_row["d"]],
                 dtype=main_row["dtype"])
    bwd_src = "incubator_mxnet_tpu_torch/ops/csrc/flash_attention_bwd.cu"
    _emit({"kernels": [
        dict(name="flash_attention_fwd", route="cuda",
             source="incubator_mxnet_tpu_torch/ops/csrc/"
                    "flash_attention_fwd.cu",
             replaces="incubator_mxnet_tpu/ops/attention.py:131",
             launches=launches, train_launches=train_launches["fwd"],
             parity="ok",
             max_abs_err=max(main_row["err_out"], main_row["err_lse"]),
             ms=main_row["ms"], kernel_ms=main_row["ms"],
             plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"],
             bound_by=main_row["bound_by"],
             library_ms=main_row["library_ms"], **shape, **nmt("fwd")),
        dict(name="flash_attention_bwd_dq", route="cuda", source=bwd_src,
             replaces="incubator_mxnet_tpu/ops/attention.py:232",
             launches=train_launches["dq"], parity="ok",
             max_abs_err=max(bwd_row["err"]["dq"], bwd_row["err_delta"]),
             ms=bwd_row["dq_ms"], kernel_ms=bwd_row["dq_ms"],
             plain_ms=bwd_row["dq_plain_ms"],
             bound_ms=bwd_row["dq_bound_ms"],
             bound_by=bwd_row["dq_bound_by"],
             library_ms=bwd_row["library_ms"],
             library_events_ms=bwd_row["library_events_ms"],
             library_kernel=bwd_row["library_kernels"][0]["kernel"],
             **shape, **nmt("dq")),
        dict(name="flash_attention_bwd_dkv", route="cuda", source=bwd_src,
             replaces="incubator_mxnet_tpu/ops/attention.py:278",
             launches=train_launches["dkv"], parity="ok",
             max_abs_err=max(bwd_row["err"]["dk"], bwd_row["err"]["dv"]),
             ms=bwd_row["dkv_ms"], kernel_ms=bwd_row["dkv_ms"],
             plain_ms=bwd_row["dkv_plain_ms"],
             bound_ms=bwd_row["dkv_bound_ms"],
             bound_by=bwd_row["dkv_bound_by"],
             library_ms=bwd_row["library_ms"],
             library_events_ms=bwd_row["library_events_ms"],
             library_kernel=bwd_row["library_kernels"][0]["kernel"],
             **shape, **nmt("dkv")),
        dict(name="conv1x1_stats", route="cuda",
             source="incubator_mxnet_tpu_torch/ops/csrc/conv1x1_stats.cu",
             replaces="tools/conv_stats_pallas_experiment.py:9",
             launches=conv_launches, parity="ok",
             max_abs_err=conv_step["max_abs_err"], ms=conv_step["ms"],
             plain_ms=conv_step["plain_ms"], bound_ms=conv_step["bound_ms"],
             bound_by=conv_step["bound_by"],
             library_ms=conv_step["library_ms"],
             library_conv_ms=conv_step["library_conv_ms"],
             shape="the %d launch sites of one resnet50_v1b step, summed"
                   % RESNET_SITES, dtype="bfloat16", batch=RESNET_BATCH)]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
