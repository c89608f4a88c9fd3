"""Neural-network ops of the PyTorch port, with the semantics of
incubator_mxnet_tpu/ops/nn.py.  These are XLA ops in the JAX package,
not Pallas kernels, so plain PyTorch is their port.

The two fused softmax cross-entropies are `torch.autograd.Function`s that
keep the JAX package's memory-exact residuals: the logits (or, for the
linear one, nothing row-sized but a per-row lse) and the labels; their
backwards rebuild the softmax from the lse.

The training BatchNorm is a `torch.autograd.Function` too: it saves only
x, gamma and the per-channel mean and 1/std, as the JAX package's custom
vjp does, and takes its statistics either from x (one pass, or two with
`MXNET_BN_STABLE_VAR`) or from sums computed elsewhere: the fused 1x1
convolution (`conv1x1_bn_stats`, through `ops.conv_stats`' kernel) hands
over Σy and Σy².

`convolution` and `fully_connected` cast the weight to the activation's
dtype (the JAX package's amp rule), so bf16 activations run against f32
master weights.
"""
from __future__ import annotations

import warnings

import torch
import torch.nn.functional as F

from . import conv_stats as _conv_stats
from .. import config as _config
from ..base import torch_dtype as _torch_dtype

__all__ = ["fully_connected", "convolution", "conv1x1_bn_stats",
           "pooling", "activation",
           "flatten", "batch_norm", "layer_norm", "embedding", "leaky_relu",
           "dropout", "softmax", "log_softmax", "fused_softmax_ce",
           "fused_linear_softmax_ce"]


def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    """`data @ weight.T + bias` with weight (num_hidden, in_units); with
    `flatten`, every axis after the first is folded into in_units."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    if weight.dtype != data.dtype:      # amp: follow activation dtype
        weight = weight.to(data.dtype)
    if no_bias or bias is None:
        return F.linear(data, weight)
    return F.linear(data, weight, bias.to(data.dtype))


def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                workspace=1024, cudnn_tune=None, cudnn_off=False,
                layout=None):
    """2-D NCHW convolution, weight (num_filter, C/num_group, kh, kw); the
    bias is added after the product, in the output dtype.  `workspace`
    and `cudnn_*` are accepted and ignored, as in the JAX package."""
    if data.ndim != 4 or layout not in (None, "NCHW"):
        raise NotImplementedError("convolution over %d-d data, layout %r, "
                                  "is not yet ported (2-D NCHW only)"
                                  % (data.ndim, layout))
    stride = tuple(stride) if stride else (1, 1)
    dilate = tuple(dilate) if dilate else (1, 1)
    pad = tuple(pad) if pad else (0, 0)
    if weight.dtype != data.dtype:      # amp: follow activation dtype
        weight = weight.to(data.dtype)
    out = F.conv2d(data, weight, None, stride, pad, dilate, num_group)
    if not no_bias and bias is not None:
        out = out + bias.to(out.dtype).reshape(1, -1, 1, 1)
    return out


def conv1x1_bn_stats(data, weight):
    """The pointwise convolution (1x1, stride 1, no padding, no bias) of
    NCHW `data` by weight (O, C, 1, 1), with the per-channel sums that a
    training BatchNorm after it takes, from one pass of `ops.conv_stats`'
    kernel: y (N, O, H, W) and Σy, Σy² over (n, h, w), each (1, O) f32.
    The weight follows the activation's dtype, as in `convolution`; under
    `contrib.amp` this op is a Convolution."""
    N, C, H, W = data.shape
    w = weight.reshape(weight.shape[0], C)
    if w.dtype != data.dtype:           # amp: follow activation dtype
        w = w.to(data.dtype)
    y, s1, s2 = _conv_stats.conv1x1_stats(
        data.contiguous().reshape(N, C, H * W), w)
    return y.reshape(N, -1, H, W), s1, s2


def pooling(data, kernel=(), pool_type="max", global_pool=False,
            cudnn_off=False, pooling_convention="valid", stride=(), pad=(),
            p_value=2, count_include_pad=True, layout=None):
    """2-D pooling over NCHW data: max (padding is -inf), avg or sum.
    `pooling_convention='full'` pads the high edge so that the output
    size is the ceiling; avg divides by the window size with
    `count_include_pad`, else by the count of real elements."""
    if data.ndim != 4 or layout not in (None, "NCHW"):
        raise NotImplementedError("pooling over %d-d data, layout %r, is "
                                  "not yet ported (2-D NCHW only)"
                                  % (data.ndim, layout))
    if global_pool:
        kernel, stride, pad = tuple(data.shape[2:]), (1, 1), (0, 0)
    kernel = tuple(kernel)
    stride = tuple(stride) if stride else (1, 1)
    pad = tuple(pad) if pad else (0, 0)
    extra = [0, 0]
    if pooling_convention == "full":
        for i in range(2):
            in_sz = data.shape[2 + i] + 2 * pad[i]
            out_sz = -(-(in_sz - kernel[i]) // stride[i]) + 1
            extra[i] = max(0, (out_sz - 1) * stride[i] + kernel[i] - in_sz)
    # F.pad takes (left, right) of the last axis first
    widths = (pad[1], pad[1] + extra[1], pad[0], pad[0] + extra[0])

    def window_sum(t):
        return F.avg_pool2d(F.pad(t, widths), kernel, stride,
                            divisor_override=1)

    if pool_type == "max":
        return F.max_pool2d(F.pad(data, widths, value=float("-inf")),
                            kernel, stride)
    if pool_type in ("avg", "sum"):
        summed = window_sum(data)
        if pool_type == "sum":
            return summed
        if count_include_pad:
            return summed / (kernel[0] * kernel[1])
        return summed / window_sum(torch.ones_like(data))
    if pool_type == "lp":
        raise NotImplementedError("pooling pool_type='lp' is not yet ported")
    raise ValueError(pool_type)


_ACTIVATIONS = {"relu": F.relu, "sigmoid": torch.sigmoid,
                "tanh": torch.tanh, "softrelu": F.softplus,
                "softsign": F.softsign}


def activation(data, act_type="relu"):
    """relu, sigmoid, tanh, softrelu (softplus) or softsign."""
    try:
        return _ACTIVATIONS[act_type](data)
    except KeyError:
        raise ValueError(act_type) from None


def flatten(data):
    """(N, ...) → (N, prod(...))."""
    return data.reshape(data.shape[0], -1)


def _bcast_shape(x, axis):
    return tuple(x.shape[axis] if i == axis else 1 for i in range(x.ndim))


def _bn_stats(x, axis):
    """Batch mean and biased variance over every axis but `axis`, in f32:
    one pass E[x²] - E[x]², clamped at 0; with `MXNET_BN_STABLE_VAR` the
    shifted two-pass E[(x - mean)²]."""
    red = tuple(i for i in range(x.ndim) if i != axis)
    x32 = x.float()
    m1 = x32.mean(dim=red)
    if _config.get("MXNET_BN_STABLE_VAR"):
        d = x32 - m1.reshape(_bcast_shape(x, axis))
        return m1, d.square().mean(dim=red)
    m2 = x32.square().mean(dim=red)
    return m1, torch.clamp_min(m2 - m1.square(), 0.0)


def _moments(s1, s2, n):
    """Mean and one-pass biased variance, clamped at 0, from the f32 sums
    Σx and Σx² of n values per channel."""
    m1 = s1.reshape(-1) / n
    m2 = s2.reshape(-1) / n
    return m1, torch.clamp_min(m2 - m1.square(), 0.0)


class _BNTrain(torch.autograd.Function):
    """Training BatchNorm (out, mean, var) over channel `axis`.  With
    `s1` None the statistics come from x (`_bn_stats`); otherwise from
    the sums s1 = Σx, s2 = Σx² of n values per channel.  Saves x, gamma,
    mean and 1/std; the statistics are non-differentiable outputs and
    their cotangents are ignored."""

    @staticmethod
    def forward(ctx, x, g, b, axis, eps, s1, s2, n):
        bshape = _bcast_shape(x, axis)
        if s1 is None:
            mean, var = _bn_stats(x, axis)
        else:
            mean, var = _moments(s1, s2, n)
        inv = torch.rsqrt(var + eps)
        g32 = g.float()
        scale = (g32 * inv).reshape(bshape)
        shift = (b.float() - mean * g32 * inv).reshape(bshape)
        # in the activation dtype: no full-size f32 intermediate
        out = x * scale.to(x.dtype) + shift.to(x.dtype)
        ctx.save_for_backward(x, g, mean, inv)
        ctx.axis = axis
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _dmean, _dvar):
        x, g, mean, inv = ctx.saved_tensors
        axis = ctx.axis
        red = tuple(i for i in range(x.ndim) if i != axis)
        bshape = _bcast_shape(x, axis)
        n = x.numel() // x.shape[axis]
        dy32 = dy.float()
        xhat = (x.float() - mean.reshape(bshape)) * inv.reshape(bshape)
        dbeta = dy32.sum(dim=red)
        dgamma = (dy32 * xhat).sum(dim=red)
        m1 = (dbeta / n).reshape(bshape)
        m2 = (dgamma / n).reshape(bshape)
        dx = (g.float() * inv).reshape(bshape) * (dy32 - m1 - xhat * m2)
        return (dx.to(x.dtype), dgamma.to(g.dtype), dbeta.to(g.dtype), None,
                None, None, None, None)


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               axis=1, training=True, sums=None):
    """BatchNorm over channel `axis` → (out, mean, var).  While
    `training` and not `use_global_stats`, the batch statistics
    normalize (taken from `sums` = (Σx, Σx², n) when given, else from
    data; ignored otherwise); otherwise the moving ones.  `fix_gamma`
    treats gamma as 1.  The caller updates the moving statistics
    (`momentum` is taken for the JAX signature and not used here)."""
    axis = axis % data.ndim
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training and not use_global_stats:
        s1, s2, n = sums if sums is not None else (None, None, 0)
        return _BNTrain.apply(data, g, beta, axis, eps, s1, s2, n)
    bshape = _bcast_shape(data, axis)
    mean = moving_mean.float()
    var = moving_var.float()
    inv = torch.rsqrt(var + eps)
    g32 = g.float()
    scale = (g32 * inv).reshape(bshape)
    shift = (beta.float() - mean * g32 * inv).reshape(bshape)
    out = data * scale.to(data.dtype) + shift.to(data.dtype)
    return out, mean, var


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Normalize over the last axis with the biased variance, then scale
    and shift.  The result takes the promoted dtype of data and gamma, as
    the JAX op's arithmetic does (bf16 data with f32 gamma gives f32)."""
    if axis % data.ndim != data.ndim - 1:
        raise NotImplementedError("layer_norm over axis %d is not yet "
                                  "ported (last axis only)" % axis)
    dt = torch.promote_types(data.dtype, gamma.dtype)
    return F.layer_norm(data.to(dt), (data.shape[-1],), gamma.to(dt),
                        beta.to(dt), eps)


def embedding(data, weight):
    """Rows of `weight` at the indices `data`.  Out-of-range indices are
    clamped into the table (the JAX package's gather clamps too), so a bad
    token id cannot fault the device."""
    idx = data.long().clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight)


def leaky_relu(data, act_type):
    """Only `gelu`, the exact erf form, is ported."""
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    raise NotImplementedError("leaky_relu act_type=%r is not yet ported"
                              % (act_type,))


def dropout(data, p=0.5, training=False, generator=None):
    """Inverted dropout drawn from `generator`; the identity unless
    `training` and p > 0."""
    if not training or p <= 0.0:
        return data
    keep = 1.0 - p
    mask = torch.rand(data.shape, generator=generator, device=data.device,
                      dtype=torch.float32) < keep
    return data * mask.to(data.dtype) / keep


def _softmax_input(data, axis, temperature, use_length):
    if use_length:
        raise NotImplementedError("softmax use_length is not yet ported")
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return data, axis % data.ndim


def softmax(data, axis=-1, temperature=None, length=None, use_length=False,
            dtype=None):
    """softmax along `axis` in data's dtype, over data / temperature; the
    result cast to `dtype` if given."""
    data, ax = _softmax_input(data, axis, temperature, use_length)
    out = torch.softmax(data, dim=ax)
    return out if dtype is None else out.to(_torch_dtype(dtype))


def log_softmax(data, axis=-1, temperature=None, dtype=None):
    """log softmax along `axis`, as `softmax`."""
    data, ax = _softmax_input(data, axis, temperature, False)
    out = torch.log_softmax(data, dim=ax)
    return out if dtype is None else out.to(_torch_dtype(dtype))


class _SoftmaxCE(torch.autograd.Function):
    """-log softmax(pred)[label] along the last axis; residuals are the
    logits, the labels and a per-row f32 lse."""

    @staticmethod
    def forward(ctx, pred, label):
        p32 = pred.float()
        lse = torch.logsumexp(p32, dim=-1, keepdim=True)
        idx = label.long().unsqueeze(-1)
        loss = (lse - p32.gather(-1, idx)).squeeze(-1)
        ctx.save_for_backward(pred, idx, lse)
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        pred, idx, lse = ctx.saved_tensors
        # softmax in f32 from the saved lse, minus the one-hot label
        dpred = torch.exp(pred.float() - lse)
        dpred.scatter_add_(-1, idx, torch.full_like(idx, -1.0,
                                                    dtype=dpred.dtype))
        dpred.mul_(dy.float().unsqueeze(-1))
        return dpred.to(pred.dtype), None


def fused_softmax_ce(pred, label, axis=-1):
    """-log softmax(pred)[label] per row, along `axis`; the loss has
    pred's shape without that axis, in f32.  The backward recomputes the
    softmax from the logits and a per-row lse (ref: the JAX package's
    memory-exact custom vjp)."""
    ax = axis % pred.ndim
    last = pred.ndim - 1
    if ax != last:
        pred = pred.movedim(ax, last)
    return _SoftmaxCE.apply(pred, label)


def _low_precision_card(a, b):
    """bf16 or f16 operands of one dtype on the card, which cuBLAS
    multiplies as they are into an f32 output (`out_dtype`)."""
    return (a.is_cuda and a.dtype == b.dtype
            and a.dtype in (torch.bfloat16, torch.float16))


def _chunk_logits(hc, weight, bias):
    """f32 logits of one row chunk: products of the operands' values summed
    in f32, as the JAX package's preferred_element_type=f32 dot.  bf16 and
    f16 operands on the card go to cuBLAS as they are, with an f32
    output; elsewhere both are upcast, the same function since their
    products are exact in f32."""
    if _low_precision_card(hc, weight):
        return torch.addmm(bias.float(), hc, weight.t(),
                           out_dtype=torch.float32)
    return torch.addmm(bias.float(), hc.float(), weight.float().t())


class _LinearSoftmaxCE(torch.autograd.Function):
    """Per-row -log softmax(hidden @ weight.T + bias)[label] over `nchunk`
    row chunks; the forward keeps only a per-row f32 lse, the backward
    recomputes each chunk's logits and accumulates dW and db in f32."""

    @staticmethod
    def forward(ctx, hidden, weight, bias, label, nchunk):
        lab = label.long()
        losses, lses = [], []
        for hc, lc in zip(hidden.chunk(nchunk), lab.chunk(nchunk)):
            logits = _chunk_logits(hc, weight, bias)
            lse = torch.logsumexp(logits, dim=-1)
            losses.append(lse - logits.gather(-1, lc[:, None]).squeeze(-1))
            lses.append(lse)
        ctx.nchunk = nchunk
        ctx.save_for_backward(hidden, weight, bias, lab, torch.cat(lses))
        return torch.cat(losses)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        hidden, weight, bias, lab, lse = ctx.saved_tensors
        nchunk = ctx.nchunk
        low = _low_precision_card(hidden, weight)
        w32 = None if low else weight.float()
        dw = torch.zeros(weight.shape, dtype=torch.float32,
                         device=weight.device)
        db = torch.zeros(bias.shape, dtype=torch.float32, device=bias.device)
        dh = []
        for hc, lc, lsec, dyc in zip(hidden.chunk(nchunk), lab.chunk(nchunk),
                                     lse.chunk(nchunk),
                                     dy.float().chunk(nchunk)):
            # in place on the chunk's logits: softmax, minus one-hot, times dy
            dlogits = _chunk_logits(hc, weight, bias)
            dlogits.sub_(lsec[:, None]).exp_()
            dlogits.scatter_add_(-1, lc[:, None], torch.full(
                (lc.shape[0], 1), -1.0, device=dlogits.device))
            dlogits.mul_(dyc[:, None])
            db += dlogits.sum(0)
            dl = dlogits.to(hidden.dtype)
            if low:                     # as _chunk_logits: f32 outputs
                dh.append(torch.mm(dl, weight, out_dtype=torch.float32)
                          .to(hidden.dtype))
                torch.addmm(dw, dl.t(), hc, out_dtype=torch.float32, out=dw)
                continue
            dl = dl.float()
            dh.append(torch.matmul(dl, w32).to(hidden.dtype))
            dw.addmm_(dl.t(), hc.float())
        return (torch.cat(dh), dw.to(weight.dtype), db.to(bias.dtype), None,
                None)


def fused_linear_softmax_ce(hidden, weight, bias, label, num_chunks=0):
    """Per-row -log softmax(hidden @ weight.T + bias)[label] without
    materialising the (rows, vocab) logits of more than one row chunk.
    hidden (N, D); weight (V, D); bias (V,); label (N,) integer-valued.
    num_chunks=0 picks the largest chunk size in [256, 2048] that divides
    N (one unchunked pass, with a warning when N > 4096, if there is
    none); N must divide into the chunk count."""
    n = hidden.shape[0]
    nchunk = int(num_chunks)
    if nchunk <= 0:
        nchunk = 1
        for chunk in range(min(n, 2048), 255, -1):
            if n % chunk == 0:
                nchunk = n // chunk
                break
        if nchunk == 1 and n > 4096:
            warnings.warn(
                "_fused_linear_softmax_ce: %d rows have no divisor in "
                "[256, 2048]; computing UNCHUNKED (full logits "
                "materialise) — pass num_chunks explicitly" % n)
    if n % nchunk != 0:
        raise ValueError(
            "_fused_linear_softmax_ce: %d rows not divisible into %d "
            "chunks" % (n, nchunk))
    return _LinearSoftmaxCE.apply(hidden, weight, bias, label, nchunk)
