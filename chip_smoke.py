#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives incubator_mxnet_tpu_torch only (never JAX or the JAX package):

1. env     — card name, power limit and compute capability (must be 9.0).
2. build   — compiles every CUDA kernel of the port from the checkout's
             sources (one nvcc per source, all started together).
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
5. kernel_bwd — the flash backward's dQ and dK/dV kernels against their
             plain versions on the card, over the forward phase's cases,
             timed beside the plain versions and the backward of
             scaled_dot_product_attention.
6. train   — BERT-base MLM at full width (f32, dropout 0, output_hidden
             + FusedMLMCELoss, Adam lr 1e-4, batch 8 x 512 tokens from
             RandomState(0)): one batch-1 step's loss and every gradient
             against a CPU copy of the model; 2 warm-up and 10 timed
             steps (step ms by CUDA events, tokens/s, peak memory, every
             loss finite); each step launches each of the three kernels
             12 times.
   train_profile — device time by kernel over one training step.
7. kernels — one JSON line per the port's kernel table, then the card's
             name and power limit, then the final {"ok": true, ...} line.

Every phase prints one JSON line; the first failure raises and exits
nonzero with its traceback.  Without a CUDA device it exits 1 and prints
nothing on standard output.
"""
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

# H100 SXM data-sheet peaks (dense): exact f32 on CUDA cores, bf16 on tensor
# cores, HBM3 bandwidth.  Used only for the least time a call could take.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
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


def _bound(BH, T, d, dtype, causal, products, tensors, rows):
    """Least time (ms) for a flash kernel: `products` (T, T, d) matrix
    products of 2·d flops per (query, key) pair this mask keeps;
    `tensors` (BH, T, d) operands and `rows` (BH, T) f32 statistics each
    read or written once."""
    elem = 4 if dtype == "float32" else 2
    pairs = T * (T + 1) // 2 if causal else T * T
    flops = 2.0 * products * BH * d * pairs
    nbytes = tensors * BH * T * d * elem + rows * 4.0 * BH * T
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def _flash_bound(BH, T, d, dtype, causal):
    """Forward: S and P·V; q, k, v read, out and lse written."""
    return _bound(BH, T, d, dtype, causal, products=2, tensors=4, rows=1)


def _dq_bound(BH, T, d, dtype, causal):
    """dQ: S, dP and dS·K; q, k, v, dO, O and lse read, dq and delta
    written."""
    return _bound(BH, T, d, dtype, causal, products=3, tensors=6, rows=2)


def _dkv_bound(BH, T, d, dtype, causal):
    """dK/dV: S, dP, P^T·dO and dS^T·Q; q, k, v, dO, lse and delta read,
    dk and dv written."""
    return _bound(BH, T, d, dtype, causal, products=4, tensors=6, rows=2)


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
        bound_ms, bound_by = _flash_bound(BH, T, d, dt, causal)
        row = dict(phase="kernel", name="flash_attention_fwd", BH=BH, T=T,
                   d=d, dtype=dt, causal=causal, err_out=err_out,
                   err_out_over_bound=err_ratio, err_lse=err_lse,
                   tol_lse=TOL, ok=ok, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        _emit(row)
        _check(ok, "flash_attention_fwd disagrees with its plain version: "
                   "%r" % (row,))
        if (BH, T, d, dt, causal) == (96, SEQ, 64, "float32", False):
            main = row
    return main


def _profile(torch, fn, reps, top=8, **row):
    """Device time per kernel name over `reps` back-to-back calls of `fn`
    (after one unprofiled call), from torch.profiler; `busy_share` is that
    time over the host wall of the profiled window (profiler overhead
    included).  Emits `row` with the breakdown."""
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
        # the library's backward: scaled_dot_product_attention on 4-D
        # (1, BH, T, d) views, forward + backward minus forward; it gives
        # dq, dk and dv together, so both kernel rows carry the same value
        q4, k4, v4 = (t[None].detach().requires_grad_() for t in (q, k, v))
        do4 = do[None]

        def sdpa():
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=causal,
                                                  scale=scale)

        fwd_ms = _time_ms(torch, sdpa)
        fwd_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
            sdpa(), (q4, k4, v4), do4))
        library_ms = fwd_bwd_ms - fwd_ms
        dq_bound, dq_by = _dq_bound(BH, T, d, dt, causal)
        dkv_bound, dkv_by = _dkv_bound(BH, T, d, dt, causal)
        row = dict(phase="kernel_bwd", BH=BH, T=T, d=d, dtype=dt,
                   causal=causal, err=errs, err_over_bound=ratios,
                   err_delta=err_delta, tol_delta=tol_delta, ok=ok,
                   dq_ms=dq_ms, dkv_ms=dkv_ms, dq_plain_ms=dq_plain_ms,
                   dkv_plain_ms=dkv_plain_ms, library_ms=library_ms,
                   library="sdpa fwd+bwd minus fwd, 4-D views",
                   dq_bound_ms=dq_bound, dq_bound_by=dq_by,
                   dkv_bound_ms=dkv_bound, dkv_bound_by=dkv_by)
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
    loss1 = _train_step(mx, net, head, trainer, x1.cuda(), y1.cuda())
    with mx.autograd.record():
        ref_loss = cpu_head(cpu_net(x1), y1)
    mx.autograd.backward(ref_loss)
    loss_err = (loss1.cpu() - ref_loss.detach()).abs().max().item()
    gmax = max(p.grad.abs().max().item() for p in cpu_params.values())
    worst, worst_name = 0.0, None
    for name, p in params.items():
        ref = cpu_params[name].grad
        err = (p.grad.cpu() - ref).abs().max().item()
        ratio = err / max(ref.abs().max().item(), 1e-3 * gmax)
        if ratio >= worst:
            worst, worst_name = ratio, name
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
                           tensors=len(params)),
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


def _registers(reports):
    """{"kernel<dtype, d>": registers per thread} from ptxas's report: each
    "Compiling entry function" line names a template instance by its
    mangled name, and the next "Used N registers" line is its count."""
    regs, name = {}, None
    for log in reports.values():
        for line in log.splitlines():
            m = re.search(r"(flash_[a-z_]+_kernel)I(f|13__nv_bfloat16)Li(\d+)E",
                          line)
            if "Compiling entry function" in line and m:
                dt = "f32" if m.group(2) == "f" else "bf16"
                name = "%s<%s, %s>" % (m.group(1), dt, m.group(3))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                regs[name], name = int(m.group(1)), None
    return regs


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops import _kernels
    from incubator_mxnet_tpu_torch.ops import attention as att

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
    spills = sum(int(n) for log in reports.values()
                 for n in re.findall(r"(\d+) bytes spill stores", log))
    _emit(dict(phase="build", seconds=time.monotonic() - t0,
               kernels=sorted(_kernels.SOURCES), built=sorted(reports),
               spill_store_bytes=spills, registers=_registers(reports)))

    main_row = phase_kernel(torch, att)
    launches = phase_serve(torch, mx, att)
    bwd_row = phase_kernel_bwd(torch, att)
    train_launches = phase_train(torch, mx, att)
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
             library_ms=bwd_row["library_ms"], **shape),
        dict(name="flash_attention_bwd_dkv", route="cuda", source=bwd_src,
             replaces="incubator_mxnet_tpu/ops/attention.py:278",
             launches=train_launches["dkv"], parity="ok",
             max_abs_err=max(bwd_row["err"]["dk"], bwd_row["err"]["dv"]),
             ms=bwd_row["dkv_ms"], kernel_ms=bwd_row["dkv_ms"],
             plain_ms=bwd_row["dkv_plain_ms"],
             bound_ms=bwd_row["dkv_bound_ms"],
             bound_by=bwd_row["dkv_bound_by"],
             library_ms=bwd_row["library_ms"], **shape)]})
    print(smi, flush=True)
    _emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
