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

import math
import warnings

import torch
import torch.nn.functional as F

from . import conv_stats as _conv_stats
from .. import config as _config
from .. import random as _rnd
from ..base import MXNetError, torch_dtype as _torch_dtype

__all__ = ["fully_connected", "convolution", "deconvolution",
           "conv1x1_bn_stats", "pooling", "activation", "instance_norm",
           "group_norm", "lrn", "sync_batch_norm", "ctc_loss", "upsampling",
           "grid_generator",
           "flatten", "batch_norm", "layer_norm", "embedding", "leaky_relu",
           "dropout", "softmax", "log_softmax", "softmin", "softmax_output",
           "smooth_l1", "make_loss", "fused_softmax_ce",
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


_CONV = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}
_CONV_T = {3: F.conv_transpose1d, 4: F.conv_transpose2d,
           5: F.conv_transpose3d}
#: channel-first layouts by rank: the only ones the JAX ops compute
_LAYOUTS = {3: "NCW", 4: "NCHW", 5: "NCDHW"}


def _spatial_args(data, layout, what, *tuples):
    """The number k of spatial axes of channel-first `data` (3-, 4- or
    5-d, as the JAX ops take it), and each of `tuples` as a k-tuple
    (1 or 0 for an empty one, per its position: stride and dilation 1,
    padding 0).  The JAX ops read every layout as channel-first; a
    channel-last one raises here instead."""
    if data.ndim not in _LAYOUTS or layout not in (None,
                                                   _LAYOUTS[data.ndim]):
        raise NotImplementedError(
            "%s over %d-d data with layout %r: the port computes the "
            "channel-first layouts NCW, NCHW and NCDHW, as the JAX ops do"
            % (what, data.ndim, layout))
    k = data.ndim - 2
    return (k,) + tuple(tuple(v) if v else (d,) * k for v, d in tuples)


def _add_bias(out, bias, no_bias):
    if no_bias or bias is None:
        return out
    return out + bias.to(out.dtype).reshape((1, -1) + (1,) * (out.ndim - 2))


def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                workspace=1024, cudnn_tune=None, cudnn_off=False,
                layout=None):
    """1-, 2- or 3-D convolution of channel-first data (by its rank),
    weight (num_filter, C/num_group, *kernel); the bias is added after
    the product, in the output dtype.  `workspace` and `cudnn_*` are
    accepted and ignored, as in the JAX package."""
    _, stride, dilate, pad = _spatial_args(
        data, layout, "convolution", (stride, 1), (dilate, 1), (pad, 0))
    if weight.dtype != data.dtype:      # amp: follow activation dtype
        weight = weight.to(data.dtype)
    out = _CONV[data.ndim](data, weight, None, stride, pad, dilate,
                           num_group)
    return _add_bias(out, bias, no_bias)


def deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), target_shape=(), num_filter=0,
                  num_group=1, no_bias=True, workspace=512,
                  cudnn_tune=None, cudnn_off=False, layout=None):
    """Transposed convolution (the gradient of `convolution` in its
    input) of channel-first data, weight (C, num_filter/num_group,
    *kernel), as the JAX op computes it: each spatial size becomes
    (in - 1) stride - 2 pad + (k - 1) dilate + 1 + adj.  The full
    product (no padding) is cut by `pad` at both ends and grown by `adj`
    at the high end, with zeros where no input reaches, so any `adj`
    works (torch's `output_padding` takes only adj < stride or
    dilation).  `target_shape` is accepted and, as in the JAX op, not
    used."""
    k, stride, dilate, pad, adj = _spatial_args(
        data, layout, "deconvolution", (stride, 1), (dilate, 1), (pad, 0),
        (adj, 0))
    weight = weight.to(data.dtype)      # amp: follow activation dtype
    out = _CONV_T[data.ndim](data, weight, None, stride, 0, 0, num_group,
                             dilate)
    if any(pad) or any(adj):
        # F.pad takes (low, high) of the last axis first; negative cuts
        widths = []
        for i in reversed(range(k)):
            widths += [-pad[i], adj[i] - pad[i]]
        out = F.pad(out, widths)
    return _add_bias(out, bias, no_bias)


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


_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def pooling(data, kernel=(), pool_type="max", global_pool=False,
            cudnn_off=False, pooling_convention="valid", stride=(), pad=(),
            p_value=2, count_include_pad=True, layout=None):
    """1-, 2- or 3-D pooling of channel-first data (by its rank): max
    (padding is -inf), avg, sum or lp.  `pooling_convention='full'` pads
    the high edge so that the output size is the ceiling; avg divides by
    the window size with `count_include_pad`, else by the count of real
    elements.  1-D data runs as 2-D with a height of 1."""
    k, stride, pad = _spatial_args(data, layout, "pooling", (stride, 1),
                                   (pad, 0))
    if global_pool:
        kernel, stride, pad = tuple(data.shape[2:]), (1,) * k, (0,) * k
    kernel = tuple(kernel)
    if k == 1:
        return pooling(data.unsqueeze(2), (1,) + kernel, pool_type,
                       pooling_convention=pooling_convention,
                       stride=(1,) + stride, pad=(0,) + pad,
                       p_value=p_value,
                       count_include_pad=count_include_pad).squeeze(2)
    extra = [0] * k
    if pooling_convention == "full":
        for i in range(k):
            in_sz = data.shape[2 + i] + 2 * pad[i]
            out_sz = -(-(in_sz - kernel[i]) // stride[i]) + 1
            extra[i] = max(0, (out_sz - 1) * stride[i] + kernel[i] - in_sz)
    # F.pad takes (low, high) of the last axis first
    widths = []
    for i in reversed(range(k)):
        widths += [pad[i], pad[i] + extra[i]]

    def window_sum(t):
        return _AVG_POOL[k](F.pad(t, widths), kernel, stride,
                            divisor_override=1)

    if pool_type == "max":
        return _MAX_POOL[k](F.pad(data, widths, value=float("-inf")),
                            kernel, stride)
    if pool_type in ("avg", "sum"):
        summed = window_sum(data)
        if pool_type == "sum":
            return summed
        if count_include_pad:
            return summed / math.prod(kernel)
        return summed / window_sum(torch.ones_like(data))
    if pool_type == "lp":
        summed = window_sum(data.abs().pow(p_value))
        return summed.pow(1.0 / p_value)
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


def _bn_acc(x):
    """The dtype BatchNorm's statistics and arithmetic take: f32, or
    float64 for a float64 input."""
    return torch.promote_types(x.dtype, torch.float32)


def _bn_stats(x, axis):
    """Batch mean and biased variance over every axis but `axis`, in
    `_bn_acc(x)`: one pass E[x²] - E[x]², clamped at 0; with
    `MXNET_BN_STABLE_VAR` the shifted two-pass E[(x - mean)²]."""
    red = tuple(i for i in range(x.ndim) if i != axis)
    x32 = x.to(_bn_acc(x))
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
    the sums s1 = Σx, s2 = Σx² of n values per channel.  With `sync` =
    (replica group, local rank) the statistics span the group's
    replicas: the per-channel Σx, Σx² and n (the fused convolution's
    sums where given) are summed across them, and so are the backward's
    two per-channel sums, as the JAX package's `_bn_train_sync` does
    with psum; the gradients of gamma and beta stay this replica's own
    (the trainer sums them with the others).  Saves x, gamma, mean and
    1/std; the statistics are non-differentiable outputs and their
    cotangents are ignored."""

    @staticmethod
    def forward(ctx, x, g, b, axis, eps, s1, s2, n, sync):
        bshape = _bcast_shape(x, axis)
        n_all = n
        if sync is not None:
            mean, var, n_all = _sync_moments(x, axis, s1, s2, n, sync)
        elif s1 is None:
            mean, var = _bn_stats(x, axis)
        else:
            mean, var = _moments(s1, s2, n)
        inv = torch.rsqrt(var + eps)
        g32 = g.to(mean.dtype)
        scale = (g32 * inv).reshape(bshape)
        shift = (b.to(mean.dtype) - mean * g32 * inv).reshape(bshape)
        # in the activation dtype: no full-size f32 intermediate
        out = x * scale.to(x.dtype) + shift.to(x.dtype)
        ctx.save_for_backward(x, g, mean, inv)
        ctx.axis = axis
        ctx.sync, ctx.n_all = sync, n_all
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
        acc = mean.dtype
        dy32 = dy.to(acc)
        xhat = (x.to(acc) - mean.reshape(bshape)) * inv.reshape(bshape)
        dbeta = dy32.sum(dim=red)
        dgamma = (dy32 * xhat).sum(dim=red)
        sb, sg = dbeta, dgamma
        if ctx.sync is not None:
            group, rank = ctx.sync
            sb, sg = group.lockstep_all_reduce(
                rank, torch.stack([dbeta, dgamma]))
            n = ctx.n_all
        m1 = (sb / n).reshape(bshape)
        m2 = (sg / n).reshape(bshape)
        dx = (g.to(acc) * inv).reshape(bshape) * (dy32 - m1 - xhat * m2)
        return (dx.to(x.dtype), dgamma.to(g.dtype), dbeta.to(g.dtype), None,
                None, None, None, None, None)


def _sync_moments(x, axis, s1, s2, n, sync):
    """(mean, biased variance, n) over every replica of `sync`'s group:
    the per-channel sums Σx, Σx² (the given ones, else x's) and the
    count n summed across the replicas."""
    group, rank = sync
    if s1 is None:
        red = tuple(i for i in range(x.ndim) if i != axis)
        x32 = x.to(_bn_acc(x))
        s1, s2 = x32.sum(dim=red), x32.square().sum(dim=red)
        n = x.numel() // x.shape[axis]
    s1 = s1.reshape(-1)
    local = torch.cat([s1, s2.reshape(-1).to(s1.dtype),
                       torch.full((1,), float(n), dtype=s1.dtype,
                                  device=s1.device)])
    tot = group.lockstep_all_reduce(rank, local)
    c = s1.shape[0]
    n_all = tot[2 * c:]
    mean = tot[:c] / n_all
    return (mean, torch.clamp_min(tot[c:2 * c] / n_all - mean.square(), 0.0),
            n_all)


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               axis=1, training=True, sums=None):
    """BatchNorm over channel `axis` → (out, mean, var).  While
    `training` and not `use_global_stats`, the batch statistics
    normalize (taken from `sums` = (Σx, Σx², n) when given, else from
    data; ignored otherwise); otherwise the moving ones.  `fix_gamma`
    treats gamma as 1.  Inside `parallel.collectives.replica_sync` the
    batch statistics span the replicas of its group (`_BNTrain`).  The
    caller updates the moving statistics (`momentum` is taken for the
    JAX signature and not used here)."""
    axis = axis % data.ndim
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training and not use_global_stats:
        from ..parallel import collectives
        s1, s2, n = sums if sums is not None else (None, None, 0)
        return _BNTrain.apply(data, g, beta, axis, eps, s1, s2, n,
                              collectives.current_sync())
    bshape = _bcast_shape(data, axis)
    acc = _bn_acc(data)
    mean = moving_mean.to(acc)
    var = moving_var.to(acc)
    inv = torch.rsqrt(var + eps)
    g32 = g.to(acc)
    scale = (g32 * inv).reshape(bshape)
    shift = (beta.to(acc) - mean * g32 * inv).reshape(bshape)
    out = data * scale.to(data.dtype) + shift.to(data.dtype)
    return out, mean, var


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Normalize over `axis` with the biased variance, then scale and
    shift.  The result takes the promoted dtype of data and gamma, as the
    JAX op's arithmetic does (bf16 data with f32 gamma gives f32)."""
    dt = torch.promote_types(data.dtype, gamma.dtype)
    ax = axis % data.ndim
    x = data.to(dt)
    if ax != data.ndim - 1:
        x = x.movedim(ax, -1)
    out = F.layer_norm(x, (x.shape[-1],), gamma.to(dt), beta.to(dt), eps)
    return out if ax == data.ndim - 1 else out.movedim(-1, ax)


def _normalize(x, red, eps):
    """(x - mean) / sqrt(var + eps) over the axes `red`, with the biased
    variance, in x's dtype (jnp.mean and jnp.var)."""
    mean = x.mean(dim=red, keepdim=True)
    var = (x - mean).square().mean(dim=red, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def _channel_affine(x, gamma, beta):
    bshape = (1, -1) + (1,) * (x.ndim - 2)
    return x * gamma.reshape(bshape) + beta.reshape(bshape)


def instance_norm(data, gamma, beta, eps=1e-3):
    """Normalize each (example, channel) over its spatial axes, then scale
    and shift per channel."""
    out = _normalize(data, tuple(range(2, data.ndim)), eps)
    return _channel_affine(out, gamma, beta)


def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    """Normalize each example's `num_groups` groups of channels over the
    group's channels and spatial axes, then scale and shift per channel:
    gamma and beta are (C,), as in the JAX package (upstream MXNet's are
    (num_groups,))."""
    n, c = data.shape[:2]
    x = data.reshape((n, num_groups, c // num_groups) + data.shape[2:])
    x = _normalize(x, tuple(range(2, x.ndim)), eps).reshape(data.shape)
    return _channel_affine(x, gamma, beta)


def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across channels: data over
    (knorm + alpha / nsize * the sum of squares in a window of `nsize`
    channels centred on each) ** beta."""
    half = nsize // 2
    sq = F.pad(data.square(), (0, 0) * (data.ndim - 2) + (half, half))
    c = data.shape[1]
    acc = torch.zeros_like(data)
    for i in range(nsize):
        acc = acc + sq[:, i:i + c]
    return data / torch.pow(knorm + alpha * acc / nsize, beta)


def sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                    momentum=0.9, fix_gamma=True, use_global_stats=False,
                    axis=1, ndev=1, axis_name="", training=True):
    """BatchNorm whose batch statistics span every replica of a
    data-parallel group.  With `axis_name` the caller's thread must be a
    replica of a group (`parallel.collectives.replica_sync`, as the JAX
    op runs under its shard_map axis), whose replicas' moments and
    backward sums it sums; without one it is `batch_norm`, which also
    syncs inside a group, as upstream MXNet degrades at ndev=1 and the
    JAX op without an axis name is BatchNorm.  `ndev` is taken for the
    reference's signature."""
    from ..parallel import collectives
    if axis_name and training and not use_global_stats and \
            collectives.current_sync() is None:
        raise MXNetError(
            "SyncBatchNorm with axis_name %r outside a replica group: run "
            "it in the replicas' threads (parallel.collectives."
            "replica_sync, as parallel.ShardedTrainer does)" % (axis_name,))
    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps,
                      momentum, fix_gamma, use_global_stats, axis, training)


def embedding(data, weight, sparse_grad=False):
    """Rows of `weight` at the indices `data`.  Out-of-range indices are
    clamped into the table (the JAX package's gather clamps too), so a bad
    token id cannot fault the device.  With `sparse_grad`, a leaf
    weight's gradient is torch's sparse COO tensor of the rows looked up
    (a weight with recorded history takes the dense one)."""
    idx = data.long().clamp(0, weight.shape[0] - 1)
    return F.embedding(idx, weight,
                       sparse=bool(sparse_grad) and weight.grad_fn is None)


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """leaky, prelu (per-channel `gamma` on axis 1), elu, selu, gelu (the
    exact erf form) and rrelu (its deterministic mean slope)."""
    if act_type == "gelu":
        return F.gelu(data, approximate="none")
    if act_type == "leaky":
        return F.leaky_relu(data, slope)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2)) \
            if gamma.ndim == 1 and data.ndim > 2 else gamma
        return torch.where(data >= 0, data, g * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return F.selu(data)
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2.0
        return torch.where(data >= 0, data, mid * data)
    raise ValueError(act_type)


def dropout(data, p=0.5, training=False, generator=None, axes=()):
    """Inverted dropout drawn from `generator`; the identity unless
    `training` and p > 0.  `axes` share one mask value along them.
    Inside a checkpointed forward's recompute the forward's mask is used
    again (`random.remat_mask`)."""
    if not training or p <= 0.0:
        return data
    keep = 1.0 - p
    shape = tuple(1 if i in axes else s for i, s in enumerate(data.shape))
    mask = _rnd.remat_mask(lambda: torch.rand(
        shape, generator=generator, device=data.device,
        dtype=torch.float32) < keep)
    return data * mask.to(data.dtype) / keep


def _softmax_input(data, axis, temperature):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return data, axis % data.ndim


def softmax(data, axis=-1, temperature=None, length=None, use_length=False,
            dtype=None):
    """softmax along `axis` in data's dtype, over data / temperature; the
    result cast to `dtype` if given.  `length` and `use_length` are
    accepted and, as in the JAX op, not used: every position takes part
    (upstream MXNet masks the positions past `length`)."""
    data, ax = _softmax_input(data, axis, temperature)
    out = torch.softmax(data, dim=ax)
    return out if dtype is None else out.to(_torch_dtype(dtype))


def log_softmax(data, axis=-1, temperature=None, dtype=None):
    """log softmax along `axis`, as `softmax`."""
    data, ax = _softmax_input(data, axis, temperature)
    out = torch.log_softmax(data, dim=ax)
    return out if dtype is None else out.to(_torch_dtype(dtype))


def softmin(data, axis=-1, temperature=None, dtype=None):
    """softmax of -data along `axis`, as `softmax`."""
    data, ax = _softmax_input(data, axis, temperature)
    out = torch.softmax(-data, dim=ax)
    return out if dtype is None else out.to(_torch_dtype(dtype))


class _SoftmaxOutput(torch.autograd.Function):
    """Forward softmax; backward the op's own rule, (softmax - smoothed
    one_hot(label)) * grad_scale, whatever the incoming gradient unless
    `out_grad` (ref: SoftmaxOutputOp::Backward)."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                normalization, multi_output, smooth_alpha, out_grad):
        p = torch.softmax(data, dim=1 if multi_output else -1)
        ctx.save_for_backward(p, label)
        ctx.attrs = (grad_scale, ignore_label, use_ignore, normalization,
                     multi_output, smooth_alpha, out_grad)
        return p

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, cot):
        p, label = ctx.saved_tensors
        (grad_scale, ignore_label, use_ignore, normalization, multi_output,
         smooth_alpha, out_grad) = ctx.attrs
        axis = 1 if multi_output else p.ndim - 1
        C = p.shape[axis]
        oh = F.one_hot(label.long().clamp(0, C - 1), C).to(p.dtype)
        oh = oh.movedim(-1, axis)
        if smooth_alpha:
            oh = oh * (1.0 - smooth_alpha) \
                + (1.0 - oh) * (smooth_alpha / max(C - 1, 1))
        g = (p - oh) * grad_scale
        if use_ignore:
            keep = (label != ignore_label).to(p.dtype)
            g = g * keep.unsqueeze(axis)
        if normalization == "batch":
            g = g / p.shape[0]
        elif normalization == "valid":
            n = torch.clamp_min((label != ignore_label).sum(), 1) \
                if use_ignore else label.numel()
            g = g / n
        if out_grad:
            g = g * cot
        return (g,) + (None,) * 8


def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   multi_output=False, use_ignore=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0):
    """Softmax (axis 1 with multi_output, else the last) whose gradient
    is SoftmaxOutput's own rule (`_SoftmaxOutput`)."""
    return _SoftmaxOutput.apply(data, label, float(grad_scale),
                                float(ignore_label), bool(use_ignore),
                                str(normalization), bool(multi_output),
                                float(smooth_alpha), bool(out_grad))


def smooth_l1(data, scalar=1.0):
    """0.5 s^2 x^2 where |x| < 1/s^2, else |x| - 0.5/s^2."""
    s2 = scalar * scalar
    return torch.where(data.abs() < 1.0 / s2, 0.5 * s2 * data.square(),
                       data.abs() - 0.5 / s2)


def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """The identity; marks its input as a loss head (ref: MakeLoss)."""
    return data


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) with the JAX op's derivative, exp(a - out) and
    exp(b - out): where both are the -1e30 that stands for log 0, out
    rounds to -1e30 too and each input takes the whole cotangent
    (torch.logaddexp's derivative gives each half of it)."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def _ctc_logaddexp3(a, b, c):
    return _LogAddExp.apply(_LogAddExp.apply(a, b), c)


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """Per-example CTC loss -log p(label | data) of data (T, B, A)
    activations (softmaxed here) and label (B, L), by the forward
    recursion in log space over the extended sequence blank, l1, blank,
    ..., lL, blank, one time step at a time, as the JAX op's scan runs
    it (-1e30 stands for log 0, so an impossible alignment gives about
    1e30).  The blank is symbol 0 ("first") or A - 1 ("last").  Without
    `use_label_lengths` a label's length is its count of symbols > 0
    ("first") or >= 0 ("last"); with `use_data_lengths` example b stops
    after data_lengths[b] steps."""
    T, B, A = data.shape
    logp = torch.log_softmax(data, dim=-1)
    L = label.shape[1]
    blank = 0 if blank_label == "first" else A - 1
    lab = label.long()
    lab = torch.where(lab < 0, lab + A, lab)    # jnp's negative indexing
    ext = torch.full((B, 2 * L + 1), blank, dtype=torch.long,
                     device=data.device)
    ext[:, 1::2] = lab
    if use_label_lengths and label_lengths is not None:
        lab_len = label_lengths.long()
    elif blank == 0:
        lab_len = (label > 0).sum(dim=1)
    else:
        lab_len = (label >= 0).sum(dim=1)
    ninf = torch.tensor(-1e30, dtype=logp.dtype, device=data.device)
    same = torch.cat([torch.zeros((B, 2), dtype=torch.bool,
                                  device=data.device),
                      ext[:, 2:] == ext[:, :-2]], dim=1)
    alpha = torch.full((B, 2 * L + 1), -1e30, dtype=logp.dtype,
                       device=data.device)
    alpha = torch.cat([logp[0, :, blank:blank + 1],
                       logp[0].gather(1, ext[:, 1:2]), alpha[:, 2:]], dim=1)
    pad1 = ninf.expand(B, 1)
    pad2 = ninf.expand(B, 2)
    dl = data_lengths.long() if use_data_lengths \
        and data_lengths is not None else None
    for t in range(1, T):
        shift1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        shift2 = torch.where(same, ninf,
                             torch.cat([pad2, alpha[:, :-2]], dim=1))
        new = _ctc_logaddexp3(alpha, shift1, shift2) \
            + logp[t].gather(1, ext)
        alpha = new if dl is None else torch.where((t < dl)[:, None], new,
                                                   alpha)
    send = 2 * lab_len
    p_end = alpha.gather(1, send[:, None])[:, 0]
    p_end1 = alpha.gather(1, torch.clamp_min(send - 1, 0)[:, None])[:, 0]
    return -_LogAddExp.apply(p_end, p_end1)


def upsampling(*data, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=512):
    """NCHW data[0] upsampled by the integer `scale`: each pixel repeated
    (nearest) or bilinearly interpolated with half-pixel centres (the
    JAX op's `jax.image.resize`; `F.interpolate` with align_corners
    False computes the same for an upscale).  Further inputs are
    repeated up to the first one's size and concatenated on the channel
    axis; as in the JAX op, `multi_input_mode` is not read (upstream
    MXNet's "sum" adds them instead)."""
    x = data[0]
    h = x.shape[2]
    if sample_type == "nearest":
        out = x.repeat_interleave(scale, dim=2).repeat_interleave(scale,
                                                                  dim=3)
    else:
        out = F.interpolate(x, scale_factor=scale, mode="bilinear",
                            align_corners=False)
    if len(data) > 1:
        outs = [out]
        for d in data[1:]:
            s = h * scale // d.shape[2]
            outs.append(d.repeat_interleave(s, dim=2)
                        .repeat_interleave(s, dim=3))
        out = torch.cat(outs, dim=1)
    return out


def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """Sampling grids in [-1, 1] for BilinearSampler: "affine" maps the
    (N, 6) matrices over a target_shape (h, w) grid of normalized
    coordinates to (N, 2, h, w); "warp" adds an (N, 2, H, W) flow field
    to the pixel grid and normalizes x by (W - 1) / 2, y by (H - 1) / 2."""
    if transform_type == "affine":
        h, w = target_shape
        ys = torch.linspace(-1, 1, h, dtype=data.dtype, device=data.device)
        xs = torch.linspace(-1, 1, w, dtype=data.dtype, device=data.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                            torch.ones_like(gx).reshape(-1)])
        out = torch.matmul(data.reshape(-1, 2, 3), grid)
        return out.reshape(-1, 2, h, w)
    if transform_type == "warp":
        _, _, fh, fw = data.shape
        ys = torch.arange(fh, dtype=torch.float32, device=data.device)
        xs = torch.arange(fw, dtype=torch.float32, device=data.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        nx = (data[:, 0] + gx) * 2.0 / max(fw - 1, 1) - 1.0
        ny = (data[:, 1] + gy) * 2.0 / max(fh - 1, 1) - 1.0
        return torch.stack([nx, ny], dim=1)
    raise ValueError("GridGenerator: unknown transform_type %r"
                     % (transform_type,))


class _SoftmaxCE(torch.autograd.Function):
    """-log softmax(pred)[label] along the last axis, in f32 (float64 for
    float64 logits); residuals are the logits, the labels and a per-row
    lse."""

    @staticmethod
    def forward(ctx, pred, label):
        p32 = pred.to(torch.promote_types(pred.dtype, torch.float32))
        lse = torch.logsumexp(p32, dim=-1, keepdim=True)
        idx = label.long().unsqueeze(-1)
        loss = (lse - p32.gather(-1, idx)).squeeze(-1)
        ctx.save_for_backward(pred, idx, lse)
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        pred, idx, lse = ctx.saved_tensors
        # softmax in lse's dtype from the saved lse, minus the one-hot label
        dpred = torch.exp(pred.to(lse.dtype) - lse)
        dpred.scatter_add_(-1, idx, torch.full_like(idx, -1.0,
                                                    dtype=dpred.dtype))
        dpred.mul_(dy.to(lse.dtype).unsqueeze(-1))
        return dpred.to(pred.dtype), None


def fused_softmax_ce(pred, label, axis=-1):
    """-log softmax(pred)[label] per row, along `axis`; the loss has
    pred's shape without that axis, in f32 (float64 for float64 pred).  The backward recomputes the
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


# -- registry entries -------------------------------------------------------
# The JAX package's names and signatures over the functions above.  Each
# entry calls its function through this module's namespace when it runs,
# so `contrib.amp`'s rebinding of a module attribute covers the entry too.

from .registry import alias, register  # noqa: E402


@register("FullyConnected", ndarray_inputs=("data", "weight", "bias"))
def _fully_connected_op(data, weight, bias=None, num_hidden=0, no_bias=False,
                        flatten=True):
    """data @ weight.T + bias, weight (num_hidden, in_units)."""
    return fully_connected(data, weight, bias, num_hidden, no_bias, flatten)


@register("Convolution", ndarray_inputs=("data", "weight", "bias"))
def _convolution_op(data, weight, bias=None, kernel=(), stride=(),
                    dilate=(), pad=(), num_filter=0, num_group=1,
                    no_bias=False, workspace=1024, cudnn_tune=None,
                    cudnn_off=False, layout=None):
    return convolution(data, weight, bias, kernel, stride, dilate, pad,
                       num_filter, num_group, no_bias, workspace,
                       cudnn_tune, cudnn_off, layout)


@register("Deconvolution", ndarray_inputs=("data", "weight", "bias"))
def _deconvolution_op(data, weight, bias=None, kernel=(), stride=(),
                      dilate=(), pad=(), adj=(), target_shape=(),
                      num_filter=0, num_group=1, no_bias=True,
                      workspace=512, cudnn_tune=None, cudnn_off=False,
                      layout=None):
    return deconvolution(data, weight, bias, kernel, stride, dilate, pad,
                         adj, target_shape, num_filter, num_group, no_bias,
                         workspace, cudnn_tune, cudnn_off, layout)


@register("Pooling", ndarray_inputs=("data",))
def _pooling_op(data, kernel=(), pool_type="max", global_pool=False,
                cudnn_off=False, pooling_convention="valid", stride=(),
                pad=(), p_value=2, count_include_pad=True, layout=None):
    return pooling(data, kernel, pool_type, global_pool, cudnn_off,
                   pooling_convention, stride, pad, p_value,
                   count_include_pad, layout)


@register("Activation", ndarray_inputs=("data",))
def _activation_op(data, act_type="relu"):
    return activation(data, act_type)


@register("LeakyReLU", ndarray_inputs=("data", "gamma"))
def _leaky_relu_op(data, gamma=None, act_type="leaky", slope=0.25,
                   lower_bound=0.125, upper_bound=0.334):
    return leaky_relu(data, gamma, act_type, slope, lower_bound, upper_bound)


@register("softmax", ndarray_inputs=("data",))
def _softmax_op(data, axis=-1, temperature=None, length=None,
                use_length=False, dtype=None):
    return softmax(data, axis, temperature, length, use_length, dtype)


@register("log_softmax", ndarray_inputs=("data",))
def _log_softmax_op(data, axis=-1, temperature=None, dtype=None):
    return log_softmax(data, axis, temperature, dtype)


@register("softmin", ndarray_inputs=("data",))
def _softmin_op(data, axis=-1, temperature=None, dtype=None):
    return softmin(data, axis, temperature, dtype)


@register("BatchNorm",
          ndarray_inputs=("data", "gamma", "beta", "moving_mean",
                          "moving_var"),
          num_outputs=3, visible_outputs=1)
def _batch_norm_op(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                   momentum=0.9, fix_gamma=True, use_global_stats=False,
                   output_mean_var=False, axis=1, cudnn_off=False,
                   _training=True):
    """(out, batch mean, batch var); batch statistics while training
    (`autograd.is_training()`), the moving ones otherwise.  The moving
    statistics are not written (the caller updates them)."""
    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps,
                      momentum, fix_gamma, use_global_stats, axis,
                      training=_training)


@register("LayerNorm", ndarray_inputs=("data", "gamma", "beta"))
def _layer_norm_op(data, gamma, beta, axis=-1, eps=1e-5,
                   output_mean_var=False):
    return layer_norm(data, gamma, beta, axis, eps)


@register("InstanceNorm", ndarray_inputs=("data", "gamma", "beta"))
def _instance_norm_op(data, gamma, beta, eps=1e-3):
    return instance_norm(data, gamma, beta, eps)


@register("GroupNorm", ndarray_inputs=("data", "gamma", "beta"))
def _group_norm_op(data, gamma, beta, num_groups=1, eps=1e-5):
    return group_norm(data, gamma, beta, num_groups, eps)


@register("LRN", ndarray_inputs=("data",))
def _lrn_op(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    return lrn(data, alpha, beta, knorm, nsize)


@register("_contrib_SyncBatchNorm",
          ndarray_inputs=("data", "gamma", "beta", "moving_mean",
                          "moving_var"),
          num_outputs=3, visible_outputs=1)
def _sync_batch_norm_op(data, gamma, beta, moving_mean, moving_var,
                        eps=1e-3, momentum=0.9, fix_gamma=True,
                        use_global_stats=False, output_mean_var=False,
                        axis=1, ndev=1, key="", axis_name="",
                        _training=True):
    """BatchNorm with statistics across the replicas of the caller's
    group (`sync_batch_norm`)."""
    return sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps,
                           momentum, fix_gamma, use_global_stats, axis,
                           ndev, axis_name, training=_training)


@register("Dropout", ndarray_inputs=("data",), needs_rng=True)
def _dropout_op(data, p=0.5, mode="training", axes=(), cudnn_off=False,
                _training=True, _rng_key=None):
    """Dropout while training (or always with mode='always'), drawn from
    the device's generator (`_rng_key`)."""
    if not _training and mode != "always":
        return data
    return dropout(data, p, training=True, generator=_rng_key,
                   axes=tuple(axes))


@register("Embedding", ndarray_inputs=("data", "weight"),
          nograd_argnums=(0,))
def _embedding_op(data, weight, input_dim=0, output_dim=0, dtype="float32",
                  sparse_grad=False):
    return embedding(data, weight)


@register("_fused_softmax_ce", ndarray_inputs=("pred", "label"),
          nograd_argnums=(1,))
def _fused_softmax_ce_op(pred, label, axis=-1):
    return fused_softmax_ce(pred, label, axis)


@register("_fused_linear_softmax_ce",
          ndarray_inputs=("hidden", "weight", "bias", "label"),
          nograd_argnums=(3,))
def _fused_linear_softmax_ce_op(hidden, weight, bias, label, num_chunks=0):
    return fused_linear_softmax_ce(hidden, weight, bias, label, num_chunks)


@register("SoftmaxOutput", ndarray_inputs=("data", "label"),
          nograd_argnums=(1,))
def _softmax_output_op(data, label, grad_scale=1.0, ignore_label=-1.0,
                       multi_output=False, use_ignore=False,
                       preserve_shape=False, normalization="null",
                       out_grad=False, smooth_alpha=0.0):
    return softmax_output(data, label, grad_scale, ignore_label,
                          multi_output, use_ignore, preserve_shape,
                          normalization, out_grad, smooth_alpha)


@register("smooth_l1", ndarray_inputs=("data",))
def _smooth_l1_op(data, scalar=1.0):
    return smooth_l1(data, scalar)


@register("MakeLoss", ndarray_inputs=("data",))
def _make_loss_op(data, grad_scale=1.0, valid_thresh=0.0,
                  normalization="null"):
    return make_loss(data, grad_scale, valid_thresh, normalization)


@register("CTCLoss", ndarray_inputs=("data", "label"), nograd_argnums=(1,))
def _ctc_loss_op(data, label, data_lengths=None, label_lengths=None,
                 use_data_lengths=False, use_label_lengths=False,
                 blank_label="first"):
    return ctc_loss(data, label, data_lengths, label_lengths,
                    use_data_lengths, use_label_lengths, blank_label)


alias("CTCLoss", "ctc_loss")


@register("UpSampling", ndarray_inputs=None)
def _upsampling_op(*data, scale=1, sample_type="nearest", num_args=1,
                   num_filter=0, multi_input_mode="concat", workspace=512):
    return upsampling(*data, scale=scale, sample_type=sample_type,
                      num_args=num_args, num_filter=num_filter,
                      multi_input_mode=multi_input_mode,
                      workspace=workspace)


@register("GridGenerator", ndarray_inputs=("data",))
def _grid_generator_op(data, transform_type="affine", target_shape=(0, 0)):
    return grid_generator(data, transform_type, target_shape)
