"""Fused 1x1 convolution + BatchNorm statistics of the PyTorch port
(counterpart of `fused_conv1x1_stats` in
tools/conv_stats_pallas_experiment.py, the JAX package's Pallas kernel).

`fused_conv1x1_stats(x, w) -> (y, s1, s2)` takes x (N, C, HW) and
w (O, C) of one dtype (float32 or bfloat16) and returns y = w·x
(N, O, HW) in x's dtype and the per-channel sums s1 = Σ y and s2 = Σ y²
over (n, hw), each (1, O) float32, taken of the f32 accumulator before y
is rounded, as the Pallas kernel sums them.

* a CUDA tensor launches the hand-written kernel
  (`csrc/conv1x1_stats.cu`), or raises `ValueError` for what it does not
  take (dtype, layout, shapes, operands off 16-byte boundaries);
* a CPU tensor takes the plain PyTorch version
  (`fused_conv1x1_stats_plain`), with the same rounding points;
* there is no fallback between the two and no size threshold.

`conv1x1_stats` is the `torch.autograd.Function` around it: y carries
the gradient, s1 and s2 are non-differentiable.  The JAX package has no
backward kernel for it, so the backward is two plain GEMMs
(dx = wᵀ·dy, dw = Σₙ dy·xᵀ) in dy's dtype.  `conv1x1_stats_launches`
counts kernel launches.  The kernel library picks one of its instances
by shape (`conv1x1_stats_path` names it): bf16 with C a multiple of 32
takes the tensor cores, the rest scalar FMAs on the CUDA cores.

`conv1x1_y_bound(x, w)` is the elementwise bound that a bf16 y is held
to, the kernel's and the plain version's alike; `RESNET_CONV_SHAPES`
lists the pointwise convolutions of a resnet50_v1b step.
"""
from __future__ import annotations

import torch

from . import _kernels

__all__ = ["fused_conv1x1_stats", "fused_conv1x1_stats_plain",
           "conv1x1_stats", "conv1x1_stats_path", "conv1x1_y_bound",
           "PATHS", "RESNET_CONV_SHAPES"]

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the kernel library's instances, by the number its
#: `mxt_conv1x1_stats_path` returns
PATHS = ("cuda_cores", "tensor_cores_rows", "tensor_cores_slabs")

#: (C, HW, O, sites): the pointwise conv + BatchNorm pairs of one
#: resnet50_v1b step at 224 x 224 images, with how many of each a step has
RESNET_CONV_SHAPES = [
    (64, 3136, 64, 1), (64, 3136, 256, 4), (256, 3136, 64, 2),
    (256, 3136, 128, 1), (128, 784, 512, 4), (512, 784, 128, 3),
    (512, 784, 256, 1), (256, 196, 1024, 6), (1024, 196, 256, 5),
    (1024, 196, 512, 1), (512, 49, 2048, 3), (2048, 49, 512, 2)]

#: launches of the CUDA kernel in this process
conv1x1_stats_launches = 0


def conv1x1_y_bound(x, w):
    """(e, bound): the exact product e = w·x (N, O, HW) in float64 and the
    elementwise bound on |y - e| of a bf16 y = w·x summed in f32 in any
    order, with any rounding of the adds:

        |y - e| <= 2**-8 |e| + 1.01 C 2**-23 sum_c |w_oc| |x_cp|

    The f32 sum s of C products meets |s - e| <= gamma_C sum_c |w x|,
    gamma_C = C u / (1 - C u), where u = 2**-23 covers the tensor cores'
    rounding toward zero (round to nearest needs only 2**-24); rounding s
    to bf16 adds at most 2**-8 |s|; and 1.01 covers (1 + 2**-8) /
    (1 - C 2**-23) up to C = 2048.  e is exact for bf16 operands up to
    the f64 sums' rounding.  A wrong tile, row or mask moves y by O(|y|)
    and breaks the bound."""
    C = x.shape[1]
    x64, w64 = x.double(), w.double()
    exact = torch.matmul(w64, x64)
    bound = 2.0 ** -8 * exact.abs() + 1.01 * C * 2.0 ** -23 * torch.matmul(
        w64.abs(), x64.abs())
    return exact, bound


def fused_conv1x1_stats_plain(x, w):
    """Plain PyTorch version of the kernel: an f32 product (products of
    the operands' values, f32 sums) cast to x's dtype, and the sums of
    the f32 product."""
    y32 = torch.matmul(w.float(), x.float())
    s1 = y32.sum(dim=(0, 2)).unsqueeze(0)
    s2 = (y32 * y32).sum(dim=(0, 2)).unsqueeze(0)
    return y32.to(x.dtype), s1, s2


def _check_operands(x, w):
    name = "fused_conv1x1_stats"
    if w.device != x.device:
        raise ValueError("%s operands lie on different devices: %s, %s"
                         % (name, x.device, w.device))
    if x.dtype not in _KERNEL_DTYPES or w.dtype != x.dtype:
        raise ValueError("%s kernel takes float32 or bfloat16 operands of "
                         "one dtype, got %s, %s" % (name, x.dtype, w.dtype))
    if x.ndim != 3 or w.ndim != 2 or w.shape[1] != x.shape[1]:
        raise ValueError("%s needs x (N, C, HW) and w (O, C), got %s and %s"
                         % (name, tuple(x.shape), tuple(w.shape)))
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("%s kernel needs contiguous operands" % name)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("%s kernel needs operands that start on 16-byte "
                         "boundaries (cp.async)" % name)
    N, C, HW = x.shape
    O = w.shape[0]
    if max(x.numel(), w.numel(), N * O * HW) >= 2 ** 31:
        raise ValueError("%s kernel takes < 2**31 elements per tensor"
                         % name)


def conv1x1_stats_path(N, C, HW, O, dtype):
    """The name of the kernel instance (`PATHS`) that x (N, C, HW),
    w (O, C) of `dtype` take; builds the kernel library if needed."""
    lib = _kernels.library("conv1x1_stats")
    return PATHS[lib.mxt_conv1x1_stats_path(N, C, HW, O,
                                            _KERNEL_DTYPES[dtype])]


def _fused_cuda(x, w):
    global conv1x1_stats_launches
    _check_operands(x, w)
    N, C, HW = x.shape
    O = w.shape[0]
    y = torch.empty((N, O, HW), dtype=x.dtype, device=x.device)
    s1 = torch.empty((1, O), dtype=torch.float32, device=x.device)
    s2 = torch.empty((1, O), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, s1.zero_(), s2.zero_()
    lib = _kernels.library("conv1x1_stats")
    code = _KERNEL_DTYPES[x.dtype]
    scratch = torch.empty(lib.mxt_conv1x1_stats_scratch(N, C, HW, O, code),
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.mxt_conv1x1_stats(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), scratch.data_ptr(),
            s1.data_ptr(), s2.data_ptr(), N, C, HW, O, code,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_conv1x1_stats kernel launch failed with "
                           "CUDA error %d" % rc)
    conv1x1_stats_launches += 1
    return y, s1, s2


def fused_conv1x1_stats(x, w):
    """x (N, C, HW), w (O, C) → y (N, O, HW) in x's dtype, s1, s2 (1, O)
    f32: the kernel for CUDA tensors, the plain version for CPU ones."""
    if x.device.type == "cuda":
        return _fused_cuda(x, w)
    if x.device.type == "cpu":
        return fused_conv1x1_stats_plain(x, w)
    raise ValueError("fused_conv1x1_stats runs on CUDA or CPU tensors, got "
                     "a tensor on %s" % x.device)


class _Conv1x1Stats(torch.autograd.Function):
    """(y, s1, s2) = fused_conv1x1_stats(x, w); y differentiable in x and
    w, the sums not."""

    @staticmethod
    def forward(ctx, x, w):
        y, s1, s2 = fused_conv1x1_stats(x, w)
        ctx.save_for_backward(x, w)
        ctx.mark_non_differentiable(s1, s2)
        return y, s1, s2

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _ds1, _ds2):
        x, w = ctx.saved_tensors
        N, C, HW = x.shape
        O = w.shape[0]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.matmul(w.t(), dy)                  # (N, C, HW)
        if ctx.needs_input_grad[1]:
            # one GEMM over all N·HW columns: (O, N·HW) · (N·HW, C)
            dw = torch.matmul(dy.transpose(0, 1).reshape(O, N * HW),
                              x.transpose(0, 1).reshape(C, N * HW).t())
        return dx, dw


def conv1x1_stats(x, w):
    """Differentiable `fused_conv1x1_stats`: gradients flow through y."""
    return _Conv1x1Stats.apply(x, w)
