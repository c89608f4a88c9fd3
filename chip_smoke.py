#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives incubator_mxnet_tpu_torch only (never JAX or the JAX package):

1. env     — card name, power limit and compute capability (must be 9.0).
2. build   — compiles every CUDA kernel of the port from the checkout's
             sources (one nvcc per source, all started together), with
             ptxas's registers and spill stores per kernel instance.
3. kernel  — each kernel against its plain PyTorch version on the card, at
             the serving shapes and at edge cases, timed with CUDA events
             beside the plain version and one PyTorch library call.
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
             own device time and its ratio to the library's beside it.
6. train   — BERT-base MLM at full width (f32, dropout 0, output_hidden
             + FusedMLMCELoss, Adam lr 1e-4, batch 8 x 512 tokens from
             RandomState(0)): one batch-1 step's loss and every gradient
             against a CPU copy of the model; 2 warm-up and 10 timed
             steps (step ms by CUDA events, tokens/s, peak memory, every
             loss finite); each step launches each of the three kernels
             12 times.
   train_profile — device time by kernel over one training step.
7. kernel_conv — the fused 1x1-conv + BatchNorm-statistics kernel against
             its plain version at the 12 shapes of a ResNet-50 step (bf16,
             batch 128), the tool's 5 shapes in f32 and ragged shapes,
             timed beside the plain version and the library route
             (cuDNN's 1x1 convolution, then the two f32 sums).
8. train_resnet — resnet50_v1b (1000 classes, random weights from seed 0)
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
9. kernels — one JSON line per the port's kernel table (4 rows), then the
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
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_FLOPS_F32_CUDA_CORES = 67e12
PEAK_BYTES_S = 3.35e12
SERVE_BUCKETS = (1, 2, 4, 8)
SEQ = 512
# flash forward against its plain version: f32 out and lse (from f32
# scores in both dtypes) differ by the same sums in another order
TOL = 1e-4
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
# fused 1x1 conv + statistics against its plain version.  f32 y: the
# same f32 sums over C in another order, 1e-4 of the largest |y|.  bf16
# y: both round the f32 accumulator, so at most one bf16 ulp apart
# (2**-7 |y|).  The sums of N·HW f32 terms in another order: Σy within
# CONV_SUM_TOL of sqrt(N·HW·Σy²) (which is at least Σ|y|), Σy² within
# CONV_SUM_TOL of itself.  A wrong tile, mask or channel moves a sum by
# 1/64 of it or more.
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


def _out_tolerance(torch, ref, dt):
    """Elementwise bound on |out - ref| of the flash forward.  bf16: both
    outputs are rounded to bf16, and the kernel rounds P against the
    running max where the plain version uses the final max; 2**-6 |ref| is
    at least 2 bf16 ulps of each element and 2**-6 rms(ref) covers the
    elements near zero.  A fault that scales out by 3 % or more, or mixes
    up rows of V, exceeds it."""
    if dt == "float32":
        return torch.full_like(ref, TOL)
    return 2.0 ** -6 * (ref.abs() + ref.pow(2).mean().sqrt())


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


# kernel cases (BH, T, d, dtype, causal): the serving and training shape
# first, then causal, bf16, ragged T and the other head dims
CASES = [(96, SEQ, 64, "float32", False), (96, SEQ, 64, "float32", True),
         (96, SEQ, 64, "bfloat16", False), (96, SEQ, 64, "bfloat16", True),
         (8, 200, 64, "float32", False), (8, 200, 64, "bfloat16", True),
         (96, SEQ, 32, "float32", False), (96, SEQ, 128, "float32", False),
         (8, 200, 16, "float32", True)]


def phase_kernel(torch, att):
    """Flash forward kernel against its plain version; returns the row of
    the serving shape (f32, BH = 8 * 12, T = 512, d = 64)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    main = None
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
        row = dict(phase="kernel", name="flash_attention_fwd", BH=BH, T=T,
                   d=d, dtype=dt, causal=causal, err_out=err_out,
                   err_out_over_bound=err_ratio, err_lse=err_lse,
                   tol_lse=TOL, ok=ok, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   **_flash_bound(BH, T, d, dt, causal))
        _emit(row)
        _check(ok, "flash_attention_fwd disagrees with its plain version: "
                   "%r" % (row,))
        if (BH, T, d, dt, causal) == (96, SEQ, 64, "float32", False):
            main = row
    return main


def _device_kernels(torch, fn, reps):
    """[(device us, kernel name, calls)] of the CUDA kernels that `reps`
    back-to-back calls of `fn` (after one unprofiled call) launch, largest
    first, from torch.profiler, and the host wall of that window (us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernels only: the aten op that launched a kernel carries the same
    # device time again
    rows = [(ev.self_device_time_total, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    return rows, wall_us


def _device_ms(torch, fn, reps=20):
    """Device time (ms) per call of `fn`: its kernels' summed self time
    over `reps` calls, divided by `reps`; and those kernels by name with
    their time (us) and launches per call."""
    rows, _ = _device_kernels(torch, fn, reps)
    return sum(r[0] for r in rows) / reps / 1e3, \
        [dict(kernel=k[:120], us=us / reps, calls=n / reps)
         for us, k, n in rows]


def _profile(torch, fn, reps, top=8, **row):
    """Device time per kernel name over `reps` calls of `fn`; `busy_share`
    is that time over the host wall of the profiled window (profiler
    overhead included).  Emits `row` with the breakdown."""
    rows, wall_us = _device_kernels(torch, fn, reps)
    device_us = sum(r[0] for r in rows)
    _emit(dict(row, wall_us=wall_us, device_us=device_us,
               busy_share=device_us / wall_us,
               top=[dict(kernel=k[:100], us=us, calls=n,
                         share=us / device_us if device_us else None)
                    for us, k, n in rows[:top]]))


def phase_profile(torch, net, x, forwards=3):
    """Device time by kernel over `forwards` full-bucket forwards."""
    with torch.inference_mode():
        _profile(torch, lambda: net(x), forwards, phase="profile",
                 batch=list(x.shape), forwards=forwards)


def _grad_tolerance(torch, ref, dt):
    """Elementwise bound on a flash gradient against its plain version.
    f32: BWD_TOL of the largest |ref|.  bf16: both round P and dS at the
    same points and round the outputs to bf16, and sums in another f32
    order can tip a rounding by one ulp; 2**-6 (|ref| + rms(ref)) is at
    least 2 bf16 ulps of each element, and rms(ref) covers the elements
    near zero."""
    if dt == "float32":
        return torch.full_like(ref, BWD_TOL * ref.abs().max().item())
    return 2.0 ** -6 * (ref.abs() + ref.pow(2).mean().sqrt())


def phase_kernel_bwd(torch, att):
    """The dQ and dK/dV kernels against their plain versions over CASES;
    returns the rows of the training shape (f32, BH 96, T 512, d 64)."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    main = {}
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
        # device time of the pair, as the library's is read below
        pair_device_ms, _ = _device_ms(torch, lambda: att.flash_attention_bwd(
            q, k, v, out, lse, do, scale, causal))
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
                   dkv_plain_ms=dkv_plain_ms, pair_device_ms=pair_device_ms,
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
        if (BH, T, d, dt, causal) == (96, SEQ, 64, "float32", False):
            main = row
    return main


def _train_step(mx, net, head, trainer, x, y):
    with mx.autograd.record():
        loss = head(net(x), y)
    mx.autograd.backward(loss)
    trainer.step(x.shape[0])
    return loss.detach()


def _tf32(torch, x, nearest=True):
    """x cut to TF32 (10 mantissa bits): to nearest, or truncated as the
    tensor cores read an f32 operand."""
    bits = x.contiguous().view(torch.int32)
    return (((bits + 0x1000) if nearest else bits) & ~0x1fff) \
        .view(torch.float32)


@contextlib.contextmanager
def _plain_backward(att, matmul):
    """The attention backward taken by its plain version on the card, its
    products through `matmul`; the kernels again on exit."""
    bwd, mm = att.flash_attention_bwd, att._matmul
    att.flash_attention_bwd, att._matmul = att.flash_attention_bwd_plain, \
        matmul
    try:
        yield
    finally:
        att.flash_attention_bwd, att._matmul = bwd, mm


def _launch_counts(att):
    return (att.flash_fwd_launches, att.flash_bwd_dq_launches,
            att.flash_bwd_dkv_launches)


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
    loss1 = _train_step(mx, net, head, trainer, x1.cuda(), y1.cuda())
    loss_err = (loss1.cpu() - ref_loss.detach()).abs().max().item()
    worst, worst_name = worst_grad()
    del cpu_net, cpu_head, cpu_params, ref_loss

    x = torch.from_numpy(tokens).cuda()
    y = torch.from_numpy(labels).cuda()
    for _ in range(TRAIN_WARMUP):
        _train_step(mx, net, head, trainer, x, y)
    torch.cuda.synchronize()
    att.flash_fwd_launches = att.flash_bwd_dq_launches = 0
    att.flash_bwd_dkv_launches = 0      # the main path starts here
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    losses, per_step = [], []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        before = _launch_counts(att)
        losses.append(_train_step(mx, net, head, trainer, x, y).mean())
        events[i + 1].record()
        per_step.append(tuple(a - b for a, b in
                              zip(_launch_counts(att), before)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts(att)      # the main path ends here
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
    _profile(torch, lambda: _train_step(mx, net, head, trainer, x, y), 1,
             top=16, phase="train_profile", batch=[TRAIN_BATCH, SEQ],
             steps=1)
    return dict(zip(("fwd", "dq", "dkv"), launches))


# (C, HW, O, sites): the pointwise conv + BatchNorm pairs of one
# resnet50_v1b step at batch 128 and 224 x 224 images
RESNET_CONV_SHAPES = [
    (64, 3136, 64, 1), (64, 3136, 256, 4), (256, 3136, 64, 2),
    (256, 3136, 128, 1), (128, 784, 512, 4), (512, 784, 128, 3),
    (512, 784, 256, 1), (256, 196, 1024, 6), (1024, 196, 256, 5),
    (1024, 196, 512, 1), (512, 49, 2048, 3), (2048, 49, 512, 2)]
# kernel_conv cases (N, C, HW, O, dtype): the step's shapes in bf16, the
# tool's five shapes in f32, ragged shapes in both dtypes
CONV_CASES = ([(RESNET_BATCH, C, HW, O, "bfloat16")
               for C, HW, O, _ in RESNET_CONV_SHAPES]
              + [(RESNET_BATCH, C, HW, O, "float32") for C, HW, O in (
                  (64, 3136, 256), (128, 784, 512), (256, 196, 1024),
                  (512, 49, 2048), (256, 3136, 64))]
              + [(3, 72, 49, 80, "bfloat16"), (3, 72, 49, 80, "float32"),
                 (5, 17, 33, 65, "bfloat16"), (1, 1, 1, 1, "float32")])


def _conv_bound(N, C, HW, O, dtype):
    """Roofline of the fused call: the 2·N·HW·C·O product operations; x
    and w read, y written, and the two (O,) f32 sums written once."""
    elem = 4 if dtype == "float32" else 2
    flops = 2.0 * N * HW * C * O
    nbytes = (N * C * HW + O * C + N * O * HW) * elem + 2 * 4.0 * O
    return _roofline(flops, nbytes, dtype)


def phase_kernel_conv(torch, cs):
    """The fused 1x1-conv + statistics kernel against its plain version
    over CONV_CASES; returns the per-step sums over the 33 launch sites
    of a bf16 resnet50_v1b step."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    sites = {(C, HW, O): k for C, HW, O, k in RESNET_CONV_SHAPES}
    step = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                max_abs_err=0.0, launches=0)
    bound_by_ms = dict(bytes=0.0, operations=0.0)
    for N, C, HW, O, dt in CONV_CASES:
        dtype = getattr(torch, dt)
        x = torch.randn(N, C, HW, device="cuda", generator=gen).to(dtype)
        w = (torch.randn(O, C, device="cuda", generator=gen) * 0.05) \
            .to(dtype)
        y, s1, s2 = cs.fused_conv1x1_stats(x, w)
        torch.cuda.synchronize()
        ref_y, ref_s1, ref_s2 = cs.fused_conv1x1_stats_plain(x, w)
        ref = ref_y.float()
        diff = (y.float() - ref).abs()
        err_y = diff.max().item()
        tol_y = (torch.full_like(ref, 1e-4 * ref.abs().max().item())
                 if dt == "float32" else 2.0 ** -7 * ref.abs())
        err_y_over_tol = (diff / tol_y.clamp_min(1e-30)).max().item()
        rel_s1 = ((s1 - ref_s1).abs()
                  / (N * HW * ref_s2).sqrt().clamp_min(1e-30)).max().item()
        rel_s2 = ((s2 - ref_s2).abs() / ref_s2.clamp_min(1e-30)) \
            .max().item()
        ok = (err_y_over_tol <= 1.0 and rel_s1 <= CONV_SUM_TOL
              and rel_s2 <= CONV_SUM_TOL)
        ms = _time_ms(torch, lambda: cs.fused_conv1x1_stats(x, w))
        plain_ms = _time_ms(torch, lambda: cs.fused_conv1x1_stats_plain(
            x, w))
        # the library route: cuDNN's 1x1 convolution, then the two f32
        # sums of its (rounded) output; a yardstick the port never calls
        x4, w4 = x.reshape(N, C, HW, 1), w.reshape(O, C, 1, 1)

        def library():
            y4 = F.conv2d(x4, w4).float()
            return y4.sum(dim=(0, 2, 3)), y4.square().sum(dim=(0, 2, 3))

        library_ms = _time_ms(torch, library)
        bound = _conv_bound(N, C, HW, O, dt)
        row = dict(phase="kernel_conv", name="conv1x1_stats", N=N, C=C,
                   HW=HW, O=O, dtype=dt, err_y=err_y,
                   err_y_over_tol=err_y_over_tol, rel_err_s1=rel_s1,
                   rel_err_s2=rel_s2, tol_sums=CONV_SUM_TOL, ok=ok, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   library="F.conv2d 1x1 + two f32 sums", **bound,
                   bound_share=bound["bound_ms"] / ms)
        _emit(row)
        _check(ok, "conv1x1_stats disagrees with its plain version: %r"
               % (row,))
        k = sites.get((C, HW, O)) if (N, dt) == (RESNET_BATCH,
                                                 "bfloat16") else None
        if k:
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                step[key] += k * row[key]
            step["max_abs_err"] = max(step["max_abs_err"], err_y)
            bound_by_ms[row["bound_by"]] += k * row["bound_ms"]
            step["launches"] += k
    _check(step["launches"] == RESNET_SITES, "the step's conv shapes cover "
           "%d launch sites, not %d" % (step["launches"], RESNET_SITES))
    # what bounds most of the step's summed bound
    step["bound_by"] = max(bound_by_ms, key=bound_by_ms.get)
    return step


def _resnet_step(mx, net, loss_fn, trainer, x, y):
    with mx.autograd.record():
        loss = loss_fn(net(x), y)
    mx.autograd.backward(loss)
    trainer.step(x.shape[0])
    return loss.detach()


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
        _resnet_step(mx, net, loss_fn, trainer, x, y)
    torch.cuda.synchronize()
    cs.conv1x1_stats_launches = 0       # the main path starts here
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    losses, per_step = [], []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(TRAIN_STEPS):
        before = cs.conv1x1_stats_launches
        losses.append(_resnet_step(mx, net, loss_fn, trainer, x, y).mean())
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
    _profile(torch, lambda: _resnet_step(mx, net, loss_fn, trainer, x, y),
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


def _ptxas(reports):
    """{"kernel<dtype, d>": {registers, spill_store_bytes}} from ptxas's
    report: each "Compiling entry function" line names a template instance
    by its mangled name, the spill line and the "Used N registers" line
    that follow are its own."""
    out, name = {}, None
    for log in reports.values():
        for line in log.splitlines():
            m = re.search(r"(flash_[a-z_]+_kernel|conv1x1_stats_kernel|"
                          r"stats_reduce_kernel)"
                          r"(?:I(f|13__nv_bfloat16)(?:Li(\d+))?E)?", line)
            if "Compiling entry function" in line and m:
                args = [a for a in (m.group(2), m.group(3)) if a]
                if args and args[0] in ("f", "13__nv_bfloat16"):
                    args[0] = "f32" if args[0] == "f" else "bf16"
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

    main_row = phase_kernel(torch, att)
    launches = phase_serve(torch, mx, att)
    bwd_row = phase_kernel_bwd(torch, att)
    train_launches = phase_train(torch, mx, att)
    conv_step = phase_kernel_conv(torch, cs)
    conv_launches = phase_train_resnet(torch, mx, cs)
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
             library_ms=main_row["library_ms"], **shape),
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
             **shape),
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
             **shape),
        dict(name="conv1x1_stats", route="cuda",
             source="incubator_mxnet_tpu_torch/ops/csrc/conv1x1_stats.cu",
             replaces="tools/conv_stats_pallas_experiment.py:9",
             launches=conv_launches, parity="ok",
             max_abs_err=conv_step["max_abs_err"], ms=conv_step["ms"],
             plain_ms=conv_step["plain_ms"], bound_ms=conv_step["bound_ms"],
             bound_by=conv_step["bound_by"],
             library_ms=conv_step["library_ms"],
             shape="the %d launch sites of one resnet50_v1b step, summed"
                   % RESNET_SITES, dtype="bfloat16", batch=RESNET_BATCH)]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
