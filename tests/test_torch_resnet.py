"""PyTorch port: the ResNet training path against the JAX package.

The ops (pooling, activation, BatchNorm with and without
MXNET_BN_STABLE_VAR, the SGD updates) on the same numpy inputs, and a
small ResNet v1b — `ResNetV1(BottleneckV1, [1, 1, 1, 1],
[8, 16, 32, 64, 128], classes=10, thumbnail=True, stride_on_3x3=True)`
on 2 x 3 x 16 x 16 images — built in JAX, its weights carried into the
port, through an inference forward, two training steps of
SoftmaxCrossEntropyLoss + SGD with momentum (bench.py's lr 0.1,
momentum 0.9, wd 1e-4), and the running statistics they update.  All
f32; the port's 1x1 convolutions run fused with their BatchNorm's
statistics (the kernel's plain version on the CPU).  The JAX net runs
op by op, as the port does (not hybridized).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import random as jrandom
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from incubator_mxnet_tpu.ops import nn as jnn
from incubator_mxnet_tpu.ops import optimizer as jopt
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from incubator_mxnet_tpu_torch.ops import conv_stats as tcs
from incubator_mxnet_tpu_torch.ops import nn as tnn
from incubator_mxnet_tpu_torch.ops import optimizer as topt

pytestmark = pytest.mark.torch_port

B, STEPS = 2, 2
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
NET_ARGS = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
NET_KW = dict(classes=10, thumbnail=True, stride_on_3x3=True)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _vjp_check(jax_fn, torch_fn, inputs, dy, tol):
    """Values and input gradients of jax_fn and torch_fn on the same
    numpy inputs, each tensor within `tol` of its largest value (at
    least 1).  An input the port gives no gradient must have a zero one
    in JAX."""
    ref, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in inputs))
    ref_grads = vjp(jnp.asarray(dy))
    ts = [_t(a).requires_grad_() for a in inputs]
    out = torch_fn(*ts)
    out.backward(_t(dy))
    pairs = [(out.detach().numpy(), _np(ref))] + [
        (np.zeros_like(a) if t.grad is None else t.grad.numpy(), _np(r))
        for t, a, r in zip(ts, inputs, ref_grads)]
    for got, r in pairs:
        assert got.shape == r.shape
        assert np.abs(got - r).max() <= tol * max(np.abs(r).max(), 1.0)


POOL_CASES = {
    "max_pad": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    "max_full": dict(kernel=(3, 3), stride=(2, 2),
                     pooling_convention="full"),
    "avg_valid_pad": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="avg"),
    "avg_full_include_pad": dict(kernel=(2, 2), stride=(2, 2), pad=(1, 1),
                                 pool_type="avg", pooling_convention="full"),
    "avg_full_exclude_pad": dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                                 pool_type="avg", pooling_convention="full",
                                 count_include_pad=False),
    "sum": dict(kernel=(2, 3), stride=(1, 2), pool_type="sum"),
    "global_max": dict(global_pool=True, pool_type="max"),
    "global_avg": dict(global_pool=True, pool_type="avg"),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling_matches_jax(case):
    kw = POOL_CASES[case]
    rs = np.random.RandomState(7)
    x = rs.randn(2, 3, 8, 9).astype(np.float32)
    ref_shape = jnn.pooling(jnp.asarray(x), **kw).shape
    dy = rs.randn(*ref_shape).astype(np.float32)
    # f32 window sums in another order; max picks the same element
    _vjp_check(lambda a: jnn.pooling(a, **kw),
               lambda a: tnn.pooling(a, **kw), [x], dy, tol=1e-5)


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation_matches_jax(act):
    rs = np.random.RandomState(8)
    x = (rs.randn(4, 6) * 3).astype(np.float32)
    dy = rs.randn(4, 6).astype(np.float32)
    # elementwise f32 functions: a few ulps apart
    _vjp_check(lambda a: jnn.activation(a, act_type=act),
               lambda a: tnn.activation(a, act_type=act), [x], dy,
               tol=1e-6)


@pytest.mark.parametrize("stable_var", ["0", "1"])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batch_norm_matches_jax(monkeypatch, stable_var, fix_gamma):
    monkeypatch.setenv("MXNET_BN_STABLE_VAR", stable_var)
    rs = np.random.RandomState(9)
    # a mean well away from 0, where the one- and two-pass forms differ
    x = (rs.randn(3, 5, 4, 6) * 0.5 + 3.0).astype(np.float32)
    g = rs.uniform(0.5, 1.5, 5).astype(np.float32)
    b = rs.randn(5).astype(np.float32)
    dy = rs.randn(*x.shape).astype(np.float32)
    mm, mv = rs.randn(5).astype(np.float32), rs.rand(5).astype(np.float32)
    kw = dict(eps=1e-5, fix_gamma=fix_gamma)

    def jax_fn(xa, ga, ba):
        return jnn.batch_norm(xa, ga, ba, jnp.asarray(mm), jnp.asarray(mv),
                              _training=True, **kw)[0]

    def torch_fn(xa, ga, ba):
        return tnn.batch_norm(xa, ga, ba, _t(mm), _t(mv), training=True,
                              **kw)[0]

    # f32 statistics and sums over 72 values per channel in another
    # order; the one-pass variance of values with mean 3 and std 0.5
    # cancels about 5 bits, so 2e-5 of each tensor's scale
    _vjp_check(jax_fn, torch_fn, [x, g, b], dy, tol=2e-5)
    ref = jnn.batch_norm(*(jnp.asarray(a) for a in (x, g, b, mm, mv)),
                         _training=True, **kw)
    got = tnn.batch_norm(*(_t(a) for a in (x, g, b, mm, mv)),
                         training=True, **kw)
    mean, var = _np(ref[1]), _np(ref[2])    # batch mean and variance
    np.testing.assert_allclose(got[1].numpy(), mean, rtol=1e-5, atol=1e-6)
    # E[x²] - E[x]² rounds at the size of E[x²] (about 9 here)
    np.testing.assert_allclose(got[2].numpy(), var, rtol=0,
                               atol=1e-5 * (mean ** 2 + var).max())
    # inference: the moving statistics, whatever the knob
    ref = jnn.batch_norm(*(jnp.asarray(a) for a in (x, g, b, mm, mv)),
                         _training=False, **kw)[0]
    got = tnn.batch_norm(*(_t(a) for a in (x, g, b, mm, mv)),
                         training=False, **kw)[0]
    np.testing.assert_allclose(got.numpy(), _np(ref), rtol=0, atol=2e-5)


@pytest.mark.parametrize("training", [True, False])
def test_batch_norm_takes_float64_arithmetic_for_float64_input(training):
    """A float64 input keeps float64 statistics and arithmetic (its f32
    gamma, beta and moving statistics cast up): the output, the batch
    statistics and the input's gradient within 1e-12 of torch's own
    float64 BatchNorm, which f32 arithmetic misses by about 1e-7; gamma's
    and beta's gradients are the f64 sums rounded once to f32.  The JAX
    package has no float64 (x64 is off), so this is the port's rule."""
    import torch.nn.functional as F
    rs = np.random.RandomState(19)
    x = torch.tensor(rs.randn(3, 5, 4, 6) * 0.5 + 3.0, requires_grad=True)
    g = torch.tensor(rs.uniform(0.5, 1.5, 5).astype(np.float32),
                     requires_grad=True)
    b = torch.tensor(rs.randn(5).astype(np.float32), requires_grad=True)
    mm, mv = _t(rs.randn(5).astype(np.float32)), \
        _t(rs.rand(5).astype(np.float32))
    dy = torch.tensor(rs.randn(*x.shape))
    out, mean, var = tnn.batch_norm(x, g, b, mm, mv, eps=1e-5,
                                    fix_gamma=False, training=training)
    ref = F.batch_norm(x, mm.double().clone(), mv.double().clone(),
                       g.double(), b.double(), training=training, eps=1e-5)
    assert out.dtype == torch.float64
    scale = ref.abs().max().item()
    assert (out - ref).abs().max().item() <= 1e-12 * scale
    if training:
        want_mean = x.detach().mean(dim=(0, 2, 3))
        want_var = x.detach().var(dim=(0, 2, 3), unbiased=False)
        assert mean.dtype == var.dtype == torch.float64
        assert (mean - want_mean).abs().max().item() <= 1e-12
        assert (var - want_var).abs().max().item() <= 1e-12
    got = torch.autograd.grad(out, (x, g, b), dy)
    want = torch.autograd.grad(ref, (x, g, b), dy)
    assert got[0].dtype == torch.float64
    assert (got[0] - want[0]).abs().max().item() \
        <= 1e-12 * want[0].abs().max().item()
    for a, w in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=2 ** -23,
                                   atol=0)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_updates_match_jax(momentum):
    rs = np.random.RandomState(10)
    ws, gs, ms = ([rs.randn(n).astype(np.float32) for n in (7, 3, 5)]
                  for _ in range(3))
    lrs, wds = [0.1, 0.05, 0.2], [1e-4, 0.0, 1e-3]
    kw = dict(rescale_grad=0.5, clip_gradient=0.8)
    tw = [_t(a) for a in ws]
    tm = [_t(a) for a in ms]
    if momentum:
        ref = jopt.multi_sgd_mom_update(
            *[jnp.asarray(a) for t in zip(ws, gs, ms) for a in t],
            lrs=lrs, wds=wds, momentum=momentum, num_weights=3, **kw)
        topt.multi_sgd_mom_update(tw, [_t(a) for a in gs], tm, lrs, wds,
                                  momentum=momentum, **kw)
        got = [a for pair in zip(tw, tm) for a in pair]
        single = jopt.sgd_mom_update(jnp.asarray(ws[0]), jnp.asarray(gs[0]),
                                     jnp.asarray(ms[0]), lr=lrs[0],
                                     momentum=momentum, wd=wds[0], **kw)
        w0, m0 = _t(ws[0]), _t(ms[0])
        topt.sgd_mom_update(w0, _t(gs[0]), m0, lr=lrs[0], momentum=momentum,
                            wd=wds[0], **kw)
        single_got = [w0, m0]
    else:
        ref = jopt.multi_sgd_update(
            *[jnp.asarray(a) for t in zip(ws, gs) for a in t],
            lrs=lrs, wds=wds, num_weights=3, **kw)
        topt.multi_sgd_update(tw, [_t(a) for a in gs], lrs, wds, **kw)
        got = tw
        single = [jopt.sgd_update(jnp.asarray(ws[0]), jnp.asarray(gs[0]),
                                  lr=lrs[0], wd=wds[0], **kw)]
        w0 = _t(ws[0])
        topt.sgd_update(w0, _t(gs[0]), lr=lrs[0], wd=wds[0], **kw)
        single_got = [w0]
    # the same f32 arithmetic, up to a fused multiply-add: 1e-6
    for t, r in zip(list(got) + single_got, list(ref) + list(single)):
        np.testing.assert_allclose(t.numpy(), _np(r), rtol=1e-6, atol=1e-7)


def test_sgd_optimizer_and_trainer_surface():
    opt = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    assert isinstance(opt, tmx.optimizer.SGD) and opt.aggregatable
    assert tmx.optimizer.create("adam").aggregatable    # as in JAX
    w = torch.nn.Parameter(torch.ones(3))
    frozen = torch.nn.Parameter(torch.ones(3), requires_grad=False)
    tr = tmx.gluon.Trainer([w, frozen], opt)
    w.grad = torch.full((3,), 2.0)
    tr.step(2)                      # one aggregated update; frozen skipped
    torch.testing.assert_close(w.detach(), torch.full((3,), 0.9))
    torch.testing.assert_close(frozen.detach(), torch.ones(3))
    assert set(tr._updater.states) == {0}
    tr.step(2)                      # momentum: mom = 0.9 (-0.1) - 0.1
    torch.testing.assert_close(w.detach(), torch.full((3,), 0.71))
    assert opt._index_update_count == {0: 2}
    # the per-index path (Updater → SGD.update) makes the same two steps
    v = torch.ones(3)
    upd = tmx.optimizer.get_updater(tmx.optimizer.create(
        "sgd", learning_rate=0.1, momentum=0.9))
    for _ in range(2):
        upd(0, torch.ones(3), v)
    torch.testing.assert_close(v, torch.full((3,), 0.71))


def test_resnet_surface():
    with pytest.raises(MXNetError, match="pretrained"):
        tres.resnet18_v1b(pretrained=True, device="cpu")
    with pytest.raises(MXNetError, match="invalid resnet depth"):
        tres.get_resnet(1, 20, device="cpu")
    with pytest.raises(NotImplementedError, match="v2"):
        tres.get_resnet(2, 18, device="cpu")
    net = tres.resnet50_v1b(device="cpu")
    params = net.collect_params()
    assert len(params) == 267
    assert sum(p.requires_grad for p in params.values()) == 161
    assert not params["features.1.running_var"].requires_grad
    assert params["features.5.0.body.0.weight"].shape == (128, 256, 1, 1)
    assert net.features[5][0].body[3]._kwargs["stride"] == (2, 2)  # v1b


def test_amp_casts_weights_to_the_activation_dtype():
    rs = np.random.RandomState(11)
    x = _t(rs.randn(2, 4, 6, 6).astype(np.float32))
    w = _t((rs.randn(5, 4, 3, 3) * 0.1).astype(np.float32))
    b = _t(rs.randn(5).astype(np.float32))
    ref = tnn.convolution(x, w, b, kernel=(3, 3), pad=(1, 1))
    out = tnn.convolution(x.bfloat16(), w, b, kernel=(3, 3), pad=(1, 1))
    assert out.dtype == torch.bfloat16
    # bf16 operands and output: a few bf16 ulps of the f32 result
    assert (out.float() - ref).abs().max() <= 0.05 * ref.abs().max()
    fw = _t(rs.randn(3, 20).astype(np.float32))
    fb = _t(np.zeros(3, np.float32))
    fc = tnn.fully_connected(x.bfloat16()[:, :, :1, :5], fw, fb)
    assert fc.dtype == torch.bfloat16 and fc.shape == (2, 3)


@pytest.mark.parametrize("strides,pad,dilate,groups,bias", [
    (1, 0, 1, 1, False), (2, 1, 1, 2, True), (1, 2, 2, 1, True)])
def test_conv2d_layer_matches_jax(strides, pad, dilate, groups, bias):
    from incubator_mxnet_tpu.gluon import nn as jnn_layers
    kw = dict(strides=strides, padding=pad, dilation=dilate, groups=groups,
              use_bias=bias, in_channels=4)
    jconv = jnn_layers.Conv2D(6, 3, **kw)
    jconv.initialize()
    rs = np.random.RandomState(12)
    x = rs.randn(2, 4, 9, 9).astype(np.float32)
    ref = jconv(nd.array(x)).asnumpy()
    params = {n: p.data().asnumpy()
              for n, p in jconv._collect_params_with_prefix().items()}
    conv = tmx.gluon.nn.Conv2D(6, 3, device="cpu", **kw)
    tmx.weights.load_reference_params(conv, params)
    with torch.no_grad():
        out = conv(_t(x))
    # f32 sums over 36 products in another order
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


# --- the slice as a whole -------------------------------------------------

@pytest.fixture(scope="module")
def jax_resnet():
    """The JAX net's initial parameters, inputs, and its reference run:
    an inference forward, then STEPS training steps (loss, gradients,
    running statistics, parameters after each step)."""
    rs = np.random.RandomState(0)
    x = rs.randn(B, 3, 16, 16).astype(np.float32)
    y = rs.randint(0, 10, B).astype(np.float32)
    # the JAX generator's state depends on the tests run before in this
    # process; seeding it makes the initial weights the same in every run
    jrandom.seed(0)
    net = jres.ResNetV1(jres.BottleneckV1, *NET_ARGS, **NET_KW)
    net.initialize()
    pred = net(nd.array(x)).asnumpy()       # outside record(): inference
    params = net._collect_params_with_prefix()
    init = {n: p.data().asnumpy() for n, p in params.items()}
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    trainer = jgluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    steps = []
    for _ in range(STEPS):
        with jag.record():
            out = net(nd.array(x))
            loss = loss_fn(out, nd.array(y))
            loss.backward()
        grads = {n: p.grad().asnumpy() for n, p in params.items()
                 if p.grad_req != "null"}
        trainer.step(B)
        steps.append(dict(out=out.asnumpy(), loss=loss.asnumpy(),
                          grads=grads,
                          after={n: p.data().asnumpy()
                                 for n, p in params.items()}))
    return x, y, init, pred, steps


@pytest.fixture(scope="module")
def port_resnet(jax_resnet):
    x, y, init, _, _ = jax_resnet
    net = tres.ResNetV1(tres.BottleneckV1, *NET_ARGS, device="cpu",
                        **NET_KW)
    tmx.weights.load_reference_params(net, init)
    params = net.collect_params()
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = tmx.gluon.Trainer(params, "sgd", dict(SGD))
    tx, ty = _t(x), _t(y)
    calls = []
    orig = tcs.fused_conv1x1_stats
    tcs.fused_conv1x1_stats = lambda a, b: calls.append(1) or orig(a, b)
    try:
        with torch.no_grad():
            pred = net(tx).numpy()
        fused_outside = len(calls)
        steps = []
        for _ in range(STEPS):
            with tmx.autograd.record():
                out = net(tx)
                loss = loss_fn(out, ty)
            tmx.autograd.backward(loss)
            grads = {n: p.grad.numpy().copy() for n, p in params.items()
                     if p.requires_grad}
            trainer.step(B)
            steps.append(dict(out=out.detach().numpy(),
                              loss=loss.detach().numpy(), grads=grads,
                              after={n: p.detach().numpy().copy()
                                     for n, p in params.items()}))
    finally:
        tcs.fused_conv1x1_stats = orig
    return pred, steps, fused_outside, len(calls)


def _close_to_scale(got, ref, tol):
    """Each tensor's max-abs error within `tol` of its own max-abs value,
    floored at `tol` of the largest value among all the tensors."""
    floor = max(np.abs(r).max() for r in ref.values())
    for n, r in ref.items():
        err = np.abs(got[n] - r).max()
        assert err <= tol * max(np.abs(r).max(), 1e-3 * floor), (n, err)


def test_resnet_fuses_its_pointwise_convs_only_while_training(port_resnet):
    _, _, fused_outside, calls = port_resnet
    assert fused_outside == 0
    # conv1 and conv3 of 4 bottlenecks, and the first stage's stride-1
    # downsample; the other three downsamples have stride 2
    assert calls == 9 * STEPS


def test_resnet_forward_matches_jax(jax_resnet, port_resnet):
    _, _, _, ref_pred, ref_steps = jax_resnet
    pred, steps, _, _ = port_resnet
    # inference with the initial running statistics (mean 0, var 1): tiny
    # logits; f32 sums in another order, 1e-4 of their scale
    scale = np.abs(ref_pred).max()
    np.testing.assert_allclose(pred, ref_pred, rtol=0, atol=1e-4 * scale)
    # training (batch statistics): logits of order 1, 1e-5
    np.testing.assert_allclose(steps[0]["out"], ref_steps[0]["out"], rtol=0,
                               atol=1e-5)


def test_resnet_gradients_and_running_stats_match_jax(jax_resnet,
                                                      port_resnet):
    _, _, _, _, ref_steps = jax_resnet
    _, steps, _, _ = port_resnet
    got, ref = steps[0], ref_steps[0]
    assert set(got["grads"]) == set(ref["grads"])
    assert len(got["grads"]) == 51
    # f32 sums in other orders through 18 layers forward and back: 1e-4 of
    # each gradient's scale
    _close_to_scale(got["grads"], ref["grads"], 1e-4)
    stats = {n: a for n, a in ref["after"].items() if "running" in n}
    assert len(stats) == 32
    # the running statistics after one step: 0.1 of a batch statistic in
    # f32 (mean and biased variance of at least 8 values per channel)
    _close_to_scale({n: got["after"][n] for n in stats}, stats, 1e-5)


def test_resnet_sgd_steps_match_jax(jax_resnet, port_resnet):
    _, _, init, _, ref_steps = jax_resnet
    _, steps, _, _ = port_resnet
    before = ref_before = init
    # what each step changed in the parameters and running statistics:
    # lr * (gradient + momentum), held as the gradients are, to 1e-4 of
    # each change's scale.  The first step at lr 0.1 moves the net to
    # where BatchNorm's backward over a batch of 2 cancels more: there
    # the port moves its own second update by up to 9e-5 of its scale
    # when the input is scaled by 1 + 2**-22, so the second step is held
    # to 1e-3
    for got, ref, tol in zip(steps, ref_steps, (1e-4, 1e-3)):
        # per-example losses of order 1: 1e-5
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=0,
                                   atol=1e-5)
        delta = {n: got["after"][n] - before[n] for n in init}
        ref_delta = {n: ref["after"][n] - ref_before[n] for n in init}
        _close_to_scale(delta, ref_delta, tol)
        before, ref_before = got["after"], ref["after"]
