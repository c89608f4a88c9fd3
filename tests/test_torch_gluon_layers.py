"""PyTorch port: the Gluon layers of gluon/nn (activations, basic layers,
convolutions and pools), gluon.contrib.nn and `gluon.loss.CTCLoss`
against the JAX package.

Each case builds one layer in both packages from the same expression
(`mx.gluon.nn...` with `mx` either package), initializes the JAX one,
carries its parameters into the port with `weights.load_reference_params`
and feeds both the same numpy input under `record()` (training mode):
the output, the input's gradient and every parameter's gradient against
a seeded cotangent, all f32, each tensor within 2e-5 of its largest
value (at least 1): the same f32 sums in another order.  Dropout's masks
come from each package's own generator, so `Dropout(axes=...)` is held
to its statistics.  The HybridConcurrent case checks that the
Conv2D → BatchNorm fusion pairs layers inside a branch and never across
two branches.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import random as jrandom
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import conv_stats as tcs

pytestmark = pytest.mark.torch_port

TOL = 2e-5


def _conv_bn_branch(mx, c):
    seq = mx.gluon.nn.HybridSequential()
    seq.add(mx.gluon.nn.Conv2D(c, 1, use_bias=False),
            mx.gluon.nn.BatchNorm(), mx.gluon.nn.Activation("relu"))
    return seq


def _concurrent(mx, hybrid):
    cnn = mx.gluon.contrib.nn
    net = (cnn.HybridConcurrent if hybrid else cnn.Concurrent)(axis=1)
    net.add(_conv_bn_branch(mx, 4), _conv_bn_branch(mx, 3),
            cnn.Identity())
    return net


def _sequential(mx, hybrid):
    nn = mx.gluon.nn
    net = (nn.HybridSequential if hybrid else nn.Sequential)()
    net.add(nn.Conv2D(6, 1, use_bias=False), nn.BatchNorm(),
            nn.PReLU(alpha_initializer="ones"), nn.Conv2DTranspose(
                4, 3, strides=2, padding=1, output_padding=1),
            nn.GroupNorm(num_groups=2), nn.InstanceNorm(scale=True))
    return net


def _after_swish(mx, block):
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Swish(), block)
    return net


def _swish_lambda(x):
    return x * 0.5 + 1.0


#: name -> (constructor(mx), input shapes); every input from U(-1, 1)
CASES = {
    "leaky_relu": (lambda mx: mx.gluon.nn.LeakyReLU(0.1), [(2, 3, 5)]),
    "prelu": (lambda mx: mx.gluon.nn.PReLU(alpha_initializer="ones"),
              [(2, 3, 4, 4)]),
    "prelu_default": (lambda mx: mx.gluon.nn.PReLU(), [(3, 5)]),
    "elu": (lambda mx: mx.gluon.nn.ELU(0.7), [(2, 3, 5)]),
    "selu": (lambda mx: mx.gluon.nn.SELU(), [(2, 3, 5)]),
    "gelu": (lambda mx: mx.gluon.nn.GELU(), [(2, 3, 5)]),
    "swish": (lambda mx: mx.gluon.nn.Swish(1.5), [(2, 3, 5)]),
    "conv1d": (lambda mx: mx.gluon.nn.Conv1D(
        6, 3, strides=2, padding=1, dilation=2, groups=2,
        activation="tanh"), [(2, 4, 11)]),
    "conv2d_deferred": (lambda mx: mx.gluon.nn.Conv2D(
        5, (3, 2), padding=(1, 0), use_bias=False), [(2, 3, 6, 5)]),
    "conv3d": (lambda mx: mx.gluon.nn.Conv3D(
        4, (2, 3, 3), strides=(1, 2, 2), padding=1, in_channels=3),
        [(2, 3, 4, 6, 5)]),
    "conv1d_transpose": (lambda mx: mx.gluon.nn.Conv1DTranspose(
        3, 4, strides=3, padding=1, output_padding=2), [(2, 4, 5)]),
    "conv2d_transpose": (lambda mx: mx.gluon.nn.Conv2DTranspose(
        6, 3, strides=2, padding=1, output_padding=1, groups=3,
        activation="relu"), [(2, 3, 4, 5)]),
    "conv3d_transpose": (lambda mx: mx.gluon.nn.Conv3DTranspose(
        2, 2, strides=2, use_bias=False, in_channels=3),
        [(1, 3, 2, 3, 2)]),
    "max_pool1d": (lambda mx: mx.gluon.nn.MaxPool1D(3, 2, 1),
                   [(2, 3, 9)]),
    "avg_pool1d": (lambda mx: mx.gluon.nn.AvgPool1D(
        3, 2, 1, ceil_mode=True, count_include_pad=False), [(2, 3, 10)]),
    "max_pool3d": (lambda mx: mx.gluon.nn.MaxPool3D(2), [(2, 3, 4, 4, 6)]),
    "avg_pool3d": (lambda mx: mx.gluon.nn.AvgPool3D(
        3, 2, 1), [(2, 2, 5, 4, 6)]),
    "global_max_pool1d": (lambda mx: mx.gluon.nn.GlobalMaxPool1D(),
                          [(2, 3, 7)]),
    "global_avg_pool1d": (lambda mx: mx.gluon.nn.GlobalAvgPool1D(),
                          [(2, 3, 7)]),
    "global_max_pool3d": (lambda mx: mx.gluon.nn.GlobalMaxPool3D(),
                          [(2, 3, 2, 3, 4)]),
    "global_avg_pool3d": (lambda mx: mx.gluon.nn.GlobalAvgPool3D(),
                          [(2, 3, 2, 3, 4)]),
    "reflection_pad2d": (lambda mx: mx.gluon.nn.ReflectionPad2D(2),
                         [(2, 3, 5, 4)]),
    "instance_norm": (lambda mx: mx.gluon.nn.InstanceNorm(scale=True),
                      [(2, 3, 4, 5)]),
    "instance_norm_1d": (lambda mx: mx.gluon.nn.InstanceNorm(
        epsilon=1e-3, center=False), [(3, 4, 6)]),
    "group_norm": (lambda mx: mx.gluon.nn.GroupNorm(
        num_groups=3, gamma_initializer="ones"), [(2, 6, 3, 4)]),
    "group_norm_3d": (lambda mx: mx.gluon.nn.GroupNorm(
        num_groups=2, epsilon=1e-3), [(2, 4, 2, 3, 2)]),
    "sequential": (lambda mx: _sequential(mx, False), [(2, 3, 4, 4)]),
    "hybrid_sequential": (lambda mx: _sequential(mx, True),
                          [(2, 3, 4, 4)]),
    "lambda_string": (lambda mx: mx.gluon.nn.Lambda("tanh"), [(2, 5)]),
    "lambda_function": (lambda mx: mx.gluon.nn.Lambda(_swish_lambda),
                        [(2, 5)]),
    "hybrid_lambda_string": (lambda mx: mx.gluon.nn.HybridLambda("relu"),
                             [(2, 5)]),
    "hybrid_lambda_function": (lambda mx: mx.gluon.nn.HybridLambda(
        _swish_lambda), [(2, 5)]),
    "concurrent": (lambda mx: _concurrent(mx, False), [(2, 3, 4, 4)]),
    "hybrid_concurrent": (lambda mx: _concurrent(mx, True),
                          [(2, 3, 4, 4)]),
    # a bare Identity returns its input, which JAX cannot differentiate
    "identity": (lambda mx: _after_swish(mx, mx.gluon.contrib.nn.Identity()),
                 [(2, 3)]),
    "sync_batch_norm": (lambda mx: mx.gluon.contrib.nn.SyncBatchNorm(
        num_devices=1), [(4, 3, 2, 3)]),
    "pixel_shuffle1d": (lambda mx: mx.gluon.contrib.nn.PixelShuffle1D(3),
                        [(2, 6, 4)]),
    "pixel_shuffle2d": (lambda mx: mx.gluon.contrib.nn.PixelShuffle2D(
        (2, 3)), [(2, 12, 3, 2)]),
    "pixel_shuffle3d": (lambda mx: mx.gluon.contrib.nn.PixelShuffle3D(2),
                        [(1, 16, 2, 1, 3)]),
}


def _jax_params(layer, inputs, rs):
    """Initialize the JAX layer, complete its deferred widths by an
    inference forward, and move every parameter but the running
    statistics by U(-0.5, 0.5) (the default initializer draws
    U(-0.07, 0.07), and PReLU's alpha is 0), so that each shows in the
    output: {structural name: value}."""
    layer.initialize()
    layer(*[nd.array(a) for a in inputs])
    params = {}
    for n, p in layer._collect_params_with_prefix().items():
        a = p.data().asnumpy()
        if "running" not in n:
            a = a + rs.uniform(-0.5, 0.5, a.shape).astype(np.float32)
            p.set_data(nd.array(a))
        params[n] = a
    return params


def _jax_run(layer, inputs, cot_seed):
    """One recorded forward and backward of the JAX layer: (output,
    cotangent, input gradients, parameter gradients)."""
    named = layer._collect_params_with_prefix()
    xs = [nd.array(a) for a in inputs]
    for x in xs:
        x.attach_grad()
    with jag.record():
        out = layer(*xs)
    cot = np.random.RandomState(cot_seed).uniform(
        -1, 1, out.shape).astype(np.float32)
    out.backward(nd.array(cot))
    grads = {n: p.grad().asnumpy() for n, p in named.items()
             if p.grad_req != "null"}
    return out.asnumpy(), cot, [x.grad.asnumpy() for x in xs], grads


def _port_run(layer, params, inputs, cot):
    tmx.weights.load_reference_params(layer, params, device="cpu")
    ts = [torch.from_numpy(a).requires_grad_() for a in inputs]
    with tmx.autograd.record():
        out = layer(*ts)
    out.backward(torch.from_numpy(cot))
    grads = {n: p.grad.numpy() for n, p in layer.collect_params().items()
             if p.requires_grad}
    return out.detach().numpy(), [t.grad.numpy() for t in ts], grads


def _close(got, ref, what):
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name):
    build, shapes = CASES[name]
    rs = np.random.RandomState(sorted(CASES).index(name))
    inputs = [rs.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    jrandom.seed(0)
    jlayer = build(jmx)
    params = _jax_params(jlayer, inputs, rs)
    ref, cot, ref_dx, ref_grads = _jax_run(jlayer, inputs, 1)
    out, dx, grads = _port_run(build(tmx), params, inputs, cot)
    _close(out, ref, "output")
    for g, r in zip(dx, ref_dx):
        _close(g, r, "input gradient")
    assert set(grads) == set(ref_grads)
    for n in ref_grads:
        _close(grads[n], ref_grads[n], "gradient of " + n)


def test_hybrid_concurrent_fuses_within_branches_only():
    """Each branch's pointwise Conv2D → BatchNorm fuses (two kernel calls
    a training forward); the Identity branch and the branches' seams
    never pair, and the output stacks every branch's channels."""
    net = _concurrent(tmx, True)
    net.initialize(ctx="cpu")
    calls = []
    orig = tcs.fused_conv1x1_stats
    tcs.fused_conv1x1_stats = lambda a, b: calls.append(a.shape) or orig(
        a, b)
    try:
        with tmx.autograd.record():
            out = net(torch.zeros(2, 3, 4, 4))
        with torch.no_grad():
            net(torch.zeros(2, 3, 4, 4))
    finally:
        tcs.fused_conv1x1_stats = orig
    assert out.shape == (2, 4 + 3 + 3, 4, 4)
    assert calls == [(2, 3, 16), (2, 3, 16)]


def test_dropout_axes_shares_the_mask():
    """`Dropout(rate, axes)` draws one mask value along `axes`, in both
    packages, and keeps about 1 - rate of the values, scaled."""
    x = np.ones((4, 50, 30), np.float32)
    with jag.record():
        ref = jmx.gluon.nn.Dropout(0.4, axes=(1,))(nd.array(x)).asnumpy()
    layer = tmx.gluon.nn.Dropout(0.4, axes=(1,))
    with tmx.autograd.record():
        out = layer(torch.from_numpy(x)).numpy()
    with torch.no_grad():
        assert torch.equal(layer(torch.from_numpy(x)), torch.from_numpy(x))
    for a in (ref, out):
        assert (a == a[:, :1, :]).all()
        assert set(np.unique(a)) <= {0.0, np.float32(1 / 0.6)}
        assert abs((a[:, 0] == 0).mean() - 0.4) < 0.15


def test_ctc_loss_block_matches_jax():
    """gluon.loss.CTCLoss (blank last) in both layouts, with and without
    lengths, and with a sample weight: losses and the activations'
    gradients."""
    rs = np.random.RandomState(3)
    pred = rs.uniform(-1, 1, (3, 7, 5)).astype(np.float32)    # NTC
    label = np.array([[0, 1, 1], [2, -1, -1], [3, 3, 0]], np.float32)
    lens = (np.array([7, 5, 6], np.float32), np.array([3, 1, 2],
                                                       np.float32))
    sw = rs.uniform(0.5, 1.5, (3,)).astype(np.float32)
    for layout, lengths, weight in (("NTC", False, None),
                                    ("TNC", True, sw)):
        p = pred if layout == "NTC" else pred.transpose(1, 0, 2).copy()
        extra = list(lens) + [weight] if lengths else []
        jl = jmx.gluon.loss.CTCLoss(layout=layout)
        jp = nd.array(p)
        jp.attach_grad()
        with jag.record():
            ref = jl(jp, nd.array(label), *[nd.array(a) for a in extra])
        ref.backward()
        tl = tmx.gluon.loss.CTCLoss(layout=layout)
        tp = torch.from_numpy(p).requires_grad_()
        out = tl(tp, torch.from_numpy(label),
                 *[torch.from_numpy(a) for a in extra])
        out.sum().backward()
        _close(out.detach().numpy(), ref.asnumpy(), "loss " + layout)
        _close(tp.grad.numpy(), jp.grad.asnumpy(), "gradient " + layout)


def test_sync_batch_norm_across_devices_raises():
    """SyncBatchNorm is BatchNorm outside a replica group (its statistics
    across replicas: test_torch_gluon_multi.py); with an axis name the
    layer and the op raise an MXNetError there while training."""
    x = torch.from_numpy(np.random.RandomState(0).randn(4, 3, 2, 2)
                         .astype(np.float32))
    sbn = tmx.gluon.contrib.nn.SyncBatchNorm(num_devices=2, in_channels=3,
                                             device="cpu")
    bn = tmx.gluon.nn.BatchNorm(in_channels=3, device="cpu")
    with tmx.autograd.record():
        torch.testing.assert_close(sbn(x), bn(x))
    named = tmx.gluon.contrib.nn.SyncBatchNorm(axis_name="data",
                                               in_channels=3, device="cpu")
    with pytest.raises(MXNetError, match="outside a replica group"):
        with tmx.autograd.record():
            named(x)
    named(x)            # inference: the running statistics
    z = tmx.nd.zeros((2, 3), ctx="cpu")
    g = tmx.nd.ones((3,), ctx="cpu")
    tmx.nd.contrib.SyncBatchNorm(z, g, g * 0, g * 0, g, ndev=2)
    with pytest.raises(MXNetError, match="outside a replica group"):
        with tmx.autograd.record():
            tmx.nd.contrib.SyncBatchNorm(z, g, g * 0, g * 0, g, ndev=2,
                                         axis_name="data")


def test_layers_refuse_channel_last_layouts():
    with pytest.raises(NotImplementedError, match="channel-first"):
        tmx.gluon.nn.Conv2D(4, 3, layout="NHWC")
    with pytest.raises(NotImplementedError, match="channel-first"):
        tmx.gluon.nn.MaxPool1D(layout="NWC")
    with pytest.raises(NotImplementedError, match="channel-first"):
        tmx.ops.nn.convolution(torch.zeros(1, 2, 3, 4), torch.zeros(
            1, 2, 1, 1), layout="NHWC")


def test_deferred_widths_match_jax():
    """Each convolution's deferred weight shape, and the norms', after
    the first forward, equal the JAX ones (the transposed layout is
    (in, out / groups, *kernel))."""
    cases = [lambda mx: mx.gluon.nn.Conv1D(6, 3, groups=2),
             lambda mx: mx.gluon.nn.Conv3D(4, 2),
             lambda mx: mx.gluon.nn.Conv2DTranspose(6, 3, groups=2),
             lambda mx: mx.gluon.nn.Conv3DTranspose(5, (1, 2, 1)),
             lambda mx: mx.gluon.nn.GroupNorm(2),
             lambda mx: mx.gluon.nn.InstanceNorm()]
    shapes = [(1, 4, 7), (1, 2, 3, 3, 3), (1, 4, 3, 3), (1, 2, 2, 2, 2),
              (1, 4, 3), (1, 3, 2, 2)]
    for build, shape in zip(cases, shapes):
        x = np.zeros(shape, np.float32)
        j = build(jmx)
        j.initialize()
        j(nd.array(x))
        t = build(tmx)
        t.initialize(ctx="cpu")
        with torch.no_grad():
            t(torch.from_numpy(x))
        got = {n: tuple(p.shape) for n, p in t.collect_params().items()}
        want = {n: tuple(p.shape)
                for n, p in j._collect_params_with_prefix().items()}
        assert got == want, (type(t).__name__, got, want)


def test_clip_block_captures_in_bf16():
    """A `hybrid_forward` block over `F.clip` (MobileNet's ReLU6)
    hybridized on bf16 input: its bounds are rounded to bf16 without a
    host read, so the program captures and replays, equal to eager."""
    from incubator_mxnet_tpu_torch.gluon.model_zoo.vision.mobilenet import \
        _ReLU6
    x = torch.linspace(-8, 8, 60).reshape(3, 20).bfloat16()
    block = _ReLU6()
    with torch.no_grad():
        ref = block(x)
        block.hybridize()
        outs = [block(x) for _ in range(3)]
    graph = block._cached_graph
    assert (graph.captures, graph.replays) == (1, 1)
    for out in outs:
        assert torch.equal(out, ref)
    assert ref.max().item() == 6.0 and ref.min().item() == 0.0
