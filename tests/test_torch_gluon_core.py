"""PyTorch port: the Gluon core surface against the JAX package.

A user's training loop, as the JAX package's north star writes it:
deferred widths, `initialize`, `ParameterDict` (`setattr`, `grad_req`,
`lr_mult`/`wd_mult`), NAG with a `CosineScheduler`, and a
`save_parameters`/`save_states` then `load_parameters`/`load_states`
round trip.  Parameter files interchange with the JAX package in both
directions, bit for bit in f32 and bf16.  The small CNN is
`examples/train_cnn.py`'s kind of net with a pointwise Conv2D →
BatchNorm pair, which the port runs fused (the conv kernel's plain
version on the CPU), on 4 x 3 x 16 x 16 images.  Inputs come from
`np.random.RandomState`; the two packages' generators are never shared,
so random initializers are held to their distributions, not to JAX's
values.
"""
import copy
import math
import os
import tempfile

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import initializer as jinit
from incubator_mxnet_tpu import lr_scheduler as jsched
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import random as jrandom
from incubator_mxnet_tpu.base import MXNetError as JaxMXNetError
from incubator_mxnet_tpu.gluon.block import nameless_scope
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon.parameter import (
    DeferredInitializationError, is_deferred)
from incubator_mxnet_tpu_torch.ops import conv_stats as tcs

pytestmark = pytest.mark.torch_port

B, C, HW, CLASSES = 4, 3, 16, 10
# f32 forward, backward and updates of the same small nets in another
# order of sums: within 2e-5
TOL = 2e-5
NAG = dict(learning_rate=0.05, momentum=0.9, wd=1e-4)
COSINE = dict(max_update=8, base_lr=0.05, final_lr=0.0, warmup_steps=1,
              warmup_begin_lr=0.01)
NO_WD = ".*beta|.*gamma|.*bias"


@pytest.fixture(scope="module", autouse=True)
def _own_jax_block_names():
    """The JAX blocks built here take their auto-names from counters of
    their own: the JAX package's tests that share this process read
    parameters in the order of the names their counters give."""
    with nameless_scope():
        yield


def _data(seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, C, HW, HW).astype(np.float32)
    y = rs.randint(0, CLASSES, B).astype(np.float32)
    return x, y


def _cnn(nn):
    """The small CNN, every width deferred, in either package."""
    net = nn.HybridSequential()
    net.add(nn.Conv2D(8, 3, padding=1, activation="relu"),
            nn.Conv2D(16, 1, use_bias=False), nn.BatchNorm(),
            nn.Activation("relu"), nn.GlobalAvgPool2D(), nn.Dense(CLASSES))
    return net


def _port_params(net):
    return {n: p.detach().clone() for n, p in net.collect_params().items()}


def _jax_params(net):
    return {n: p.data().asnumpy()
            for n, p in net._collect_params_with_prefix().items()}


def _bits(a):
    """The raw 16-bit words of a bf16 tensor or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _count_fused():
    """Patch the fused conv's entry point to count its calls."""
    calls = []
    orig = tcs.fused_conv1x1_stats

    def counted(a, b):
        calls.append(1)
        return orig(a, b)
    return calls, orig, counted


# --- the file format, both directions --------------------------------------

@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """The JAX CNN: initialized, materialized by an inference forward and
    saved (f32, and a bf16 cast of it), then a training forward."""
    d = tmp_path_factory.mktemp("jax_cnn")
    x, _ = _data()
    jrandom.seed(0)
    net = _cnn(jgluon.nn)
    net.initialize()
    pred = net(nd.array(x)).asnumpy()
    init = _jax_params(net)
    net.save_parameters(str(d / "f32.params"))
    with jag.record():
        train_out = net(nd.array(x)).asnumpy()
    running = {n: a for n, a in _jax_params(net).items() if "running" in n}
    bnet = _cnn(jgluon.nn)
    bnet.cast("bfloat16")
    bnet.load_parameters(str(d / "f32.params"))
    bnet.save_parameters(str(d / "bf16.params"))
    return dict(dir=d, x=x, init=init, pred=pred, train_out=train_out,
                running=running, bf16=_jax_params(bnet))


def test_jax_file_loads_into_deferred_port_net(jax_files):
    net = _cnn(tmx.gluon.nn)
    assert all(is_deferred(p) for p in net.collect_params().values())
    net.load_parameters(str(jax_files["dir"] / "f32.params"), ctx="cpu")
    got = _port_params(net)
    assert set(got) == set(jax_files["init"])
    for n, ref in jax_files["init"].items():
        assert got[n].dtype == torch.float32
        np.testing.assert_array_equal(got[n].numpy(), ref)   # bit for bit
    x = torch.from_numpy(jax_files["x"])
    with torch.no_grad():
        pred = net(x).numpy()
    np.testing.assert_allclose(pred, jax_files["pred"], rtol=0, atol=TOL)
    calls, orig, counted = _count_fused()
    tcs.fused_conv1x1_stats = counted
    try:
        with tmx.autograd.record():
            out = net(x)
    finally:
        tcs.fused_conv1x1_stats = orig
    assert len(calls) == 1              # the pointwise pair ran fused
    np.testing.assert_allclose(out.detach().numpy(), jax_files["train_out"],
                               rtol=0, atol=TOL)
    for n, ref in jax_files["running"].items():
        np.testing.assert_allclose(net.collect_params()[n].detach().numpy(),
                                   ref, rtol=0, atol=TOL)


def test_jax_bf16_file_loads_bit_for_bit(jax_files):
    net = _cnn(tmx.gluon.nn)
    net.cast("bfloat16")
    net.load_parameters(str(jax_files["dir"] / "bf16.params"), ctx="cpu")
    got = net.collect_params()
    for n, ref in jax_files["bf16"].items():
        assert got[n].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got[n]), _bits(ref))
    # into an f32 net: the bf16 values exactly
    net32 = _cnn(tmx.gluon.nn)
    net32.load_parameters(str(jax_files["dir"] / "bf16.params"), ctx="cpu")
    for n, ref in jax_files["bf16"].items():
        np.testing.assert_array_equal(
            net32.collect_params()[n].detach().numpy(),
            np.asarray(ref, dtype=np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_file_loads_into_jax_bit_for_bit(tmp_path, dtype):
    torch.manual_seed(0)
    tmx.random.seed(3)
    net = _cnn(tmx.gluon.nn)
    net.initialize(ctx="cpu")
    with torch.no_grad():
        net(torch.from_numpy(_data()[0]))
    net.cast(dtype)
    path = str(tmp_path / "port.params")
    net.save_parameters(path)
    jnet = _cnn(jgluon.nn)
    jnet.cast(dtype)
    jnet.load_parameters(path)
    ref = jnet._collect_params_with_prefix()
    got = net.collect_params()
    assert set(ref) == set(got)
    for n, p in got.items():
        arr = ref[n].data().asnumpy()
        assert str(arr.dtype) == dtype
        if dtype == "bfloat16":
            np.testing.assert_array_equal(_bits(arr), _bits(p))
        else:
            np.testing.assert_array_equal(arr, p.detach().numpy())


def _both_raise(jfn, tfn):
    """Both calls raise their package's MXNetError with the same text."""
    with pytest.raises(JaxMXNetError) as jerr:
        jfn()
    with pytest.raises(MXNetError) as terr:
        tfn()
    assert str(terr.value) == str(jerr.value)


def test_load_prefixes_missing_and_extra_as_jax(jax_files, tmp_path):
    src = tmx.nd.load(str(jax_files["dir"] / "f32.params"), ctx="cpu")
    jnet, net = _cnn(jgluon.nn), _cnn(tmx.gluon.nn)
    # the reference's arg:/aux: prefixes are stripped by both
    prefixed = {("aux:" if "running" in n else "arg:") + n: t
                for n, t in src.items()}
    tmx.nd.save(str(tmp_path / "prefixed"), prefixed)
    jnet.load_parameters(str(tmp_path / "prefixed"))
    net.load_parameters(str(tmp_path / "prefixed"), ctx="cpu")
    for n, ref in _jax_params(jnet).items():
        np.testing.assert_array_equal(_port_params(net)[n].numpy(), ref)
    missing = {n: t for n, t in src.items() if n != "5.bias"}
    tmx.nd.save(str(tmp_path / "missing"), missing)
    extra = dict(src, **{"6.weight": torch.zeros(2)})
    tmx.nd.save(str(tmp_path / "extra"), extra)
    for name, kw in (("missing", "allow_missing"),
                     ("extra", "ignore_extra")):
        f = str(tmp_path / name)
        _both_raise(lambda: jnet.load_parameters(f),
                    lambda: net.load_parameters(f, ctx="cpu"))
        jnet.load_parameters(f, **{kw: True})
        net.load_parameters(f, ctx="cpu", **{kw: True})
    # a net without data raises for no missing name, in both
    jfresh, fresh = _cnn(jgluon.nn), _cnn(tmx.gluon.nn)
    jfresh.load_parameters(str(tmp_path / "missing"))
    fresh.load_parameters(str(tmp_path / "missing"), ctx="cpu")
    assert is_deferred(fresh.collect_params()["5.bias"])


def test_nd_save_load_lists_and_dtypes(tmp_path):
    rs = np.random.RandomState(1)
    arrays = [torch.from_numpy(rs.randn(3, 5).astype(np.float32)),
              torch.from_numpy(rs.randn(7).astype(np.float32)).bfloat16(),
              torch.arange(6, dtype=torch.int32).reshape(2, 3)]
    path = str(tmp_path / "list")
    tmx.nd.save(path, arrays)
    back = tmx.nd.load(path, ctx="cpu")
    ref = nd.load(path)
    # NDArrays in a list, as the JAX nd.load returns them
    assert isinstance(back, list) and len(back) == 3 and len(ref) == 3
    for a, b, r in zip(arrays, back, ref):
        assert isinstance(b, tmx.nd.NDArray) and isinstance(r, nd.NDArray)
        assert a.dtype == b._data.dtype and torch.equal(a, b._data)
        assert b.shape == r.shape
    np.testing.assert_array_equal(_bits(ref[1].asnumpy()), _bits(arrays[1]))
    np.testing.assert_array_equal(_bits(back[1]._data), _bits(arrays[1]))
    for i in (0, 2):
        np.testing.assert_array_equal(back[i].asnumpy(), ref[i].asnumpy())
        assert back[i].asnumpy().dtype == ref[i].asnumpy().dtype
    # named arrays come back as a dict of NDArrays in both
    tmx.nd.save(path, {"a": arrays[0], "c": arrays[2]})
    back, ref = tmx.nd.load(path, ctx="cpu"), nd.load(path)
    assert isinstance(back, dict) and list(back) == list(ref) == ["a", "c"]
    for k in back:
        assert isinstance(back[k], tmx.nd.NDArray)
        np.testing.assert_array_equal(back[k].asnumpy(), ref[k].asnumpy())
    with open(path, "r+b") as f:
        f.write(b"\0")
    with pytest.raises(MXNetError, match="invalid NDArray file"):
        tmx.nd.load(path, ctx="cpu")


# --- deferred widths -------------------------------------------------------

LAYERS = {
    "dense": (lambda nn: nn.Dense(5), (2, 3, 4)),
    "dense_no_flatten": (lambda nn: nn.Dense(5, flatten=False), (2, 3, 4)),
    "dense_activation": (lambda nn: nn.Dense(5, activation="tanh"), (2, 6)),
    "conv_groups": (lambda nn: nn.Conv2D(6, 3, groups=2, padding=1),
                    (2, 4, 8, 8)),
    "batchnorm": (lambda nn: nn.BatchNorm(), (2, 4, 5, 5)),
    "layernorm": (lambda nn: nn.LayerNorm(), (2, 3, 7)),
}


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_deferred_layer_shapes_and_values_match_jax(case):
    build, shape = LAYERS[case]
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    jlayer = build(jgluon.nn)
    jlayer.initialize()
    ref = jlayer(nd.array(x)).asnumpy()
    params = _jax_params(jlayer)
    layer = build(tmx.gluon.nn)
    layer.initialize(ctx="cpu")
    # what depends on the input waits for it; a bias of known width not
    waiting = {n for n, p in layer.collect_params().items()
               if is_deferred(p)}
    assert waiting == {n for n, p in layer.collect_params().items()
                       if 0 in p.shape}
    assert waiting
    with torch.no_grad():
        layer(torch.from_numpy(x))
    got = layer.collect_params()
    assert {n: tuple(p.shape) for n, p in got.items()} == \
        {n: a.shape for n, a in params.items()}
    tmx.weights.load_reference_params(layer, params)
    with torch.no_grad():
        out = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=TOL)


def test_resnet18_v1b_deferred_shapes_match_jax():
    x = np.random.RandomState(3).randn(1, 3, 32, 32).astype(np.float32)
    jnet = jvision.get_model("resnet18_v1b", classes=CLASSES)
    jnet.initialize()
    jnet.infer_shape(nd.array(x))
    ref = {n: tuple(p.shape)
           for n, p in jnet._collect_params_with_prefix().items()}
    net = tmx.gluon.model_zoo.vision.get_model("resnet18_v1b",
                                               classes=CLASSES)
    net.initialize(tmx.init.MSRAPrelu(), ctx="cpu")
    stem = net.collect_params()["features.0.weight"]
    assert stem.shape == (64, 0, 7, 7) and is_deferred(stem)
    with pytest.raises(DeferredInitializationError):
        stem + 1
    with tmx.autograd.pause():
        net(torch.from_numpy(x))
    got = net.collect_params()
    assert not any(is_deferred(p) for p in got.values())
    assert {n: tuple(p.shape) for n, p in got.items()} == ref
    assert got["features.0.weight"] is stem


def test_uninitialized_net_and_trainer_before_first_forward():
    net = _cnn(tmx.gluon.nn)
    with pytest.raises(MXNetError, match="call initialize"):
        net(torch.zeros(1, C, HW, HW))
    with pytest.raises(MXNetError, match="not been initialized"):
        tmx.gluon.Trainer(net.collect_params(), "sgd")
    net.initialize(ctx="cpu")
    params = net.collect_params()
    trainer = tmx.gluon.Trainer(params, "nag", dict(NAG))
    objs = {n: id(p) for n, p in params.items()}
    x, y = (torch.from_numpy(a) for a in _data())
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        loss = loss_fn(net(x), y)
    tmx.autograd.backward(loss)
    before = _port_params(net)
    trainer.step(B)
    after = net.collect_params()
    assert {n: id(p) for n, p in after.items()} == objs
    for n, p in after.items():
        moved = not torch.equal(p.detach(), before[n])
        assert moved == p.requires_grad, n
    assert set(trainer._updater.states) == {
        i for i, p in enumerate(trainer._params) if p.requires_grad}


def test_device_keyword_initializes_at_construction():
    dense = tmx.gluon.nn.Dense(4, in_units=3, device="cpu")
    assert not is_deferred(dense.weight)
    deferred = tmx.gluon.nn.Dense(4, device="cpu")
    assert is_deferred(deferred.weight) and not is_deferred(deferred.bias)
    with pytest.warns(UserWarning, match="already initialized"):
        dense.initialize(ctx="cpu")
    w = dense.weight.detach().clone()
    dense.initialize(tmx.init.One(), ctx="cpu", force_reinit=True)
    assert torch.equal(dense.weight.detach(), torch.ones(4, 3))
    assert not torch.equal(w, dense.weight.detach())
    # a cast before materialisation is the dtype the forward allocates
    deferred.cast("bfloat16")
    with torch.no_grad():
        deferred(torch.ones(2, 5, dtype=torch.bfloat16))
    assert deferred.weight.dtype == torch.bfloat16
    assert tuple(deferred.weight.shape) == (4, 5)


# --- initializers ----------------------------------------------------------

DETERMINISTIC = {
    "zero": (lambda m: m.Zero(), "fc_weight", (3, 4)),
    "one": (lambda m: m.One(), "fc_weight", (3, 4)),
    "constant": (lambda m: m.Constant(0.37), "fc_weight", (3, 4)),
    "bias_by_name": (lambda m: m.Uniform(), "dense0_bias", (5,)),
    "gamma_by_name": (lambda m: m.Constant(3.0), "bn_gamma", (5,)),
    "beta_by_name": (lambda m: m.One(), "bn_beta", (5,)),
    "running_mean": (lambda m: m.Normal(), "bn_running_mean", (5,)),
    "running_var": (lambda m: m.Zero(), "bn_running_var", (5,)),
    "moving_var": (lambda m: m.Uniform(), "bn_moving_var", (5,)),
    "bilinear": (lambda m: m.Bilinear(), "up_weight", (2, 3, 4, 5)),
    "lstm_bias": (lambda m: m.LSTMBias(2.5), "lstm_i2h_weight", (8,)),
    "mixed": (lambda m: m.Mixed([".*fc.*", ".*"], [m.Constant(2.0),
                                                    m.Zero()]),
              "fc_weight", (2, 2)),
    "mixed_fallback": (lambda m: m.Mixed([".*fc.*", ".*"],
                                         [m.Constant(2.0), m.One()]),
                       "conv_weight", (2, 2)),
}


@pytest.mark.parametrize("case", sorted(DETERMINISTIC))
def test_deterministic_fills_match_jax(case):
    build, name, shape = DETERMINISTIC[case]
    arr = nd.zeros(shape)
    build(jinit)(name, arr)
    t = torch.full(shape, 7.0)
    build(tmx.init)(name, t, tmx.random.generator("cpu"))
    np.testing.assert_array_equal(t.numpy(), arr.asnumpy())


def test_initializer_registry():
    assert isinstance(tmx.init.create("zeros"), tmx.init.Zero)
    assert isinstance(tmx.init.create("gaussian", sigma=0.1),
                      tmx.init.Normal)
    x = tmx.init.create("xavier", magnitude=2)
    assert isinstance(x, tmx.init.Xavier) and x.magnitude == 2.0
    assert isinstance(tmx.init.create("msraprelu"), tmx.init.MSRAPrelu)
    assert isinstance(tmx.init.create(None), tmx.init.Uniform)
    assert tmx.init.MSRAPrelu(slope=0.1).dumps() == \
        jinit.MSRAPrelu(slope=0.1).dumps()
    with pytest.raises(MXNetError, match="unknown initializer"):
        tmx.init.create("nope")
    with pytest.raises(MXNetError, match="no initializer pattern"):
        tmx.init.Mixed(["a.*"], [tmx.init.One()])("b", torch.zeros(1))


def _xavier_scale(j, shape):
    """Xavier's bound or deviation from the JAX instance's attributes,
    by the JAX package's formula."""
    hw = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
    fan_in, fan_out = shape[1] * hw, shape[0] * hw
    factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
              "out": fan_out}[j.factor_type]
    return math.sqrt(j.magnitude / factor)


# (port and JAX instance, shape) -> ("uniform" | "normal", scale)
RANDOM = {
    "uniform": (lambda m: m.Uniform(0.3), (256, 256),
                lambda j, s: ("uniform", j.scale)),
    "normal": (lambda m: m.Normal(0.02), (256, 256),
               lambda j, s: ("normal", j.sigma)),
    "xavier_uniform_avg": (lambda m: m.Xavier(), (128, 64, 3, 3),
                           lambda j, s: ("uniform", _xavier_scale(j, s))),
    "xavier_gaussian_in": (lambda m: m.Xavier("gaussian", "in", 2),
                           (128, 64, 3, 3),
                           lambda j, s: ("normal", _xavier_scale(j, s))),
    "xavier_uniform_out": (lambda m: m.Xavier("uniform", "out", 6),
                           (300, 256),
                           lambda j, s: ("uniform", _xavier_scale(j, s))),
    "msraprelu": (lambda m: m.MSRAPrelu(), (128, 64, 3, 3),
                  lambda j, s: ("normal", _xavier_scale(j, s))),
    "msraprelu_in": (lambda m: m.MSRAPrelu("in", 0.0), (256, 512),
                     lambda j, s: ("normal", _xavier_scale(j, s))),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(RANDOM))
def test_random_fills_follow_the_jax_distribution(case, dtype):
    build, shape, law = RANDOM[case]
    kind, scale = law(build(jinit), shape)
    t = torch.empty(shape, dtype=dtype)
    tmx.random.seed(11)
    build(tmx.init)("w_weight", t, tmx.random.generator("cpu"))
    v = t.double().flatten()
    n = v.numel()
    assert n >= 64 * 1024
    if kind == "uniform":
        # U(-s, s): variance s²/3, variance of x² 4 s⁴ / 45; a bf16 value
        # may round up past s by less than one bf16 ulp
        bf16 = dtype == torch.bfloat16
        assert v.abs().max() <= scale * (1 + 2.0 ** -7 if bf16 else 1)
        var, var_sd = scale ** 2 / 3, math.sqrt(4 / 45) * scale ** 2
    else:
        var, var_sd = scale ** 2, math.sqrt(2.0) * scale ** 2
    # six standard errors of the mean and of the second moment, plus
    # the largest shift of the second moment by bf16 rounding (each x
    # within 2**-9 of itself, so x² within 2**-8 of itself)
    assert abs(v.mean().item()) <= 6 * math.sqrt(var / n)
    shift = 2.0 ** -8 * var if dtype == torch.bfloat16 else 0.0
    assert abs((v * v).mean().item() - var) <= 6 * var_sd / math.sqrt(n) \
        + shift


@pytest.mark.parametrize("rand_type", ["uniform", "normal"])
@pytest.mark.parametrize("shape", [(16, 48), (24, 4, 3, 2)])
def test_orthogonal_rows_are_orthonormal(rand_type, shape):
    init = tmx.init.Orthogonal(scale=1.414, rand_type=rand_type)
    t = torch.empty(shape)
    init("w_weight", t, tmx.random.generator("cpu"))
    w = t.reshape(shape[0], -1).double() / 1.414
    torch.testing.assert_close(w @ w.T, torch.eye(shape[0],
                                                  dtype=torch.float64),
                               rtol=0, atol=1e-5)


# --- ParameterDict, grad_req and the multipliers ---------------------------

def _mlp(nn, **kw):
    net = nn.HybridSequential()
    net.add(nn.Dense(8, in_units=6, activation="relu"), nn.Dense(4))
    return net


def _set_attrs(net, pd_keys):
    """wd_mult 0 for biases, lr_mult 2 on the first weight, the last
    bias frozen and the first one accumulating."""
    net.collect_params(".*bias").setattr("wd_mult", 0.0)
    params = net.collect_params()
    params[pd_keys["w0"]].lr_mult = 2.0
    params[pd_keys["b1"]].grad_req = "null"
    params[pd_keys["b0"]].grad_req = "add"


@pytest.mark.parametrize("opt", ["sgd", "nag"])
def test_multipliers_and_grad_req_match_jax_over_three_steps(opt):
    rs = np.random.RandomState(4)
    x = rs.randn(5, 6).astype(np.float32)
    y = rs.randint(0, 4, 5).astype(np.float32)
    hp = dict(learning_rate=0.1, momentum=0.9, wd=0.05)
    jrandom.seed(0)
    jnet = _mlp(jgluon.nn)
    jnet.initialize()
    jnet(nd.array(x))
    init = _jax_params(jnet)
    jparams = list(jnet.collect_params().keys())
    jkeys = dict(w0=jparams[0], b0=jparams[1], b1=jparams[3])
    _set_attrs(jnet, jkeys)
    net = _mlp(tmx.gluon.nn)
    tmx.weights.load_reference_params(net, init, device="cpu")
    _set_attrs(net, dict(w0="0.weight", b0="0.bias", b1="1.bias"))
    jtr = jgluon.Trainer(jnet.collect_params(), opt, dict(hp))
    tr = tmx.gluon.Trainer(net.collect_params(), opt, dict(hp))
    jloss, loss_fn = (jgluon.loss.SoftmaxCrossEntropyLoss(),
                      tmx.gluon.loss.SoftmaxCrossEntropyLoss())
    for _ in range(3):
        with jag.record():
            jl = jloss(jnet(nd.array(x)), nd.array(y))
            jl.backward()
        jtr.step(5)
        with tmx.autograd.record():
            loss = loss_fn(net(torch.from_numpy(x)), torch.from_numpy(y))
        tmx.autograd.backward(loss)
        tr.step(5)
        ref, got = _jax_params(jnet), _port_params(net)
        for n in ref:
            np.testing.assert_allclose(got[n].numpy(), ref[n], rtol=0,
                                       atol=TOL, err_msg=n)
    # the frozen bias: bit for bit as loaded, and no optimizer state
    np.testing.assert_array_equal(got["1.bias"].numpy(), init["1.bias"])
    assert 3 not in tr._updater.states and len(tr._updater.states) == 3


@pytest.mark.parametrize("hybrid", [False, True])
def test_unreached_parameters_update_from_zero_gradients_as_jax(hybrid):
    """A parameter that no backward reaches (a Dense the loss never calls)
    is updated from a zero gradient by both Trainers, so SGD's weight
    decay moves it; `ignore_stale_grad` changes nothing in either.  The
    port's live set is the same in every step, so a hybridized run
    updates eagerly once, captures its update in step 2 and replays it
    in step 3."""
    rs = np.random.RandomState(6)
    x = rs.randn(5, 6).astype(np.float32)
    y = rs.randint(0, 4, 5).astype(np.float32)
    hp = dict(learning_rate=0.1, momentum=0.9, wd=0.05)
    jrandom.seed(0)
    jnet, jidle = _mlp(jgluon.nn), jgluon.nn.Dense(3, in_units=6)
    jnet.initialize()
    jidle.initialize()
    jnet(nd.array(x))
    init, idle_init = _jax_params(jnet), _jax_params(jidle)
    net, idle = _mlp(tmx.gluon.nn), tmx.gluon.nn.Dense(3, in_units=6)
    tmx.weights.load_reference_params(net, init, device="cpu")
    tmx.weights.load_reference_params(idle, idle_init, device="cpu")
    if hybrid:
        net.hybridize()
    jtr = jgluon.Trainer(list(jnet.collect_params().values())
                         + list(jidle.collect_params().values()), "sgd",
                         dict(hp))
    tr = tmx.gluon.Trainer(list(net.collect_params().values())
                           + list(idle.collect_params().values()), "sgd",
                           dict(hp))
    jloss, loss_fn = (jgluon.loss.SoftmaxCrossEntropyLoss(),
                      tmx.gluon.loss.SoftmaxCrossEntropyLoss())
    for step in range(3):
        with jag.record():
            jl = jloss(jnet(nd.array(x)), nd.array(y))
            jl.backward()
        jtr.step(5, ignore_stale_grad=step == 1)
        with tmx.autograd.record():
            loss = loss_fn(net(torch.from_numpy(x)), torch.from_numpy(y))
        tmx.autograd.backward(loss)
        tr.step(5, ignore_stale_grad=step == 1)
        for jblock, block in ((jnet, net), (jidle, idle)):
            ref, got = _jax_params(jblock), _port_params(block)
            for n in ref:
                np.testing.assert_allclose(got[n].numpy(), ref[n], rtol=0,
                                           atol=TOL, err_msg=n)
    assert not np.allclose(_port_params(idle)["weight"].numpy(),
                           idle_init["weight"])
    assert len(tr._updater.states) == 6
    if hybrid:
        assert (tr.eager_updates, tr.captures, tr.replays) == (1, 1, 1)


def test_grad_req_add_sums_until_zero_grad():
    net = _mlp(tmx.gluon.nn)
    net.initialize(ctx="cpu")
    x = torch.from_numpy(np.random.RandomState(5).randn(3, 6)
                         .astype(np.float32))
    params = net.collect_params()
    params.setattr("grad_req", "add")
    params["1.weight"].grad_req = "write"

    def backward():
        with tmx.autograd.record():
            out = net(x).sum()
        tmx.autograd.backward(out)
        return {n: p.grad.clone() for n, p in params.items()}
    g1 = backward()
    g2 = backward()
    for n in g1:
        want = g1[n] if n == "1.weight" else 2 * g1[n]
        torch.testing.assert_close(g2[n], want, rtol=1e-6, atol=0)
    net.zero_grad()
    assert all(not p.grad.any() for p in params.values())
    assert params["0.weight"].list_grad()[0] is params["0.weight"].grad
    assert params["0.weight"].list_data()[0] is params["0.weight"]


def test_parameter_dict_surface():
    pd = tmx.gluon.ParameterDict("net_")
    w = pd.get("w", shape=(2, 0), allow_deferred_init=True)
    assert pd.get("w") is w and list(pd) == ["net_w"] and pd.prefix == "net_"
    pd.get("w", shape=(2, 3))
    assert w.shape == (2, 3)
    c = pd.get_constant("c", [1.0, 2.0])
    with pytest.raises(MXNetError, match="constant net_d not found"):
        pd.get_constant("d")
    pd.initialize(tmx.init.One(), ctx="cpu")
    assert torch.equal(w.detach(), torch.ones(2, 3))
    assert torch.equal(c.detach(), torch.tensor([1.0, 2.0]))
    assert not c.requires_grad and c.grad_req == "null"
    other = tmx.gluon.ParameterDict()
    other.update({"net_w": w})
    with pytest.raises(MXNetError, match="duplicate parameter name"):
        other.update({"net_w": c})
    pd.setattr("lr_mult", 0.5)
    assert w.lr_mult == c.lr_mult == 0.5
    assert dict(pd) == {"net_w": w, "net_c": c}
    pd.zero_grad()                      # no gradient yet: nothing to do
    with pytest.raises(ValueError, match="grad_req"):
        w.grad_req = "sometimes"
    deferred = tmx.gluon.Parameter("d", shape=(0, 2),
                                   allow_deferred_init=True)
    with pytest.raises(MXNetError, match="call initialize"):
        deferred.list_ctx()
    deferred.initialize(ctx="cpu")
    pd.update({"d": deferred})
    pd.reset_ctx(tmx.cpu())
    assert {p.list_ctx()[0] for p in pd.values()} == {torch.device("cpu")}
    deferred.set_data(np.ones((3, 2), np.float32))     # completes it
    assert not is_deferred(deferred) and deferred.shape == (3, 2)
    twin = copy.deepcopy(w)             # a copy keeps class and attributes
    assert type(twin) is type(w) and twin is not w
    assert (twin.name, twin.lr_mult) == ("net_w", 0.5)
    assert torch.equal(twin, w) and twin.data_ptr() != w.data_ptr()


# --- lr schedulers ---------------------------------------------------------

SCHEDULERS = {
    "factor": ("FactorScheduler", dict(step=5, factor=0.5, base_lr=0.1,
                                       stop_factor_lr=1e-3)),
    "factor_warmup_linear": ("FactorScheduler", dict(
        step=4, factor=0.7, base_lr=0.2, warmup_steps=6,
        warmup_begin_lr=0.01)),
    "multifactor_warmup_constant": ("MultiFactorScheduler", dict(
        step=[5, 12, 30], factor=0.3, base_lr=0.1, warmup_steps=3,
        warmup_begin_lr=0.02, warmup_mode="constant")),
    "poly": ("PolyScheduler", dict(max_update=40, base_lr=0.1, pwr=2,
                                   final_lr=1e-3)),
    "poly_warmup_linear": ("PolyScheduler", dict(
        max_update=40, base_lr=0.1, pwr=1.5, warmup_steps=5,
        warmup_begin_lr=0.001)),
    "cosine": ("CosineScheduler", dict(max_update=40, base_lr=0.1,
                                       final_lr=0.01)),
    "cosine_warmup_linear": ("CosineScheduler", dict(
        max_update=30, base_lr=0.1, final_lr=0.0, warmup_steps=4,
        warmup_begin_lr=0.01)),
    "cosine_warmup_constant": ("CosineScheduler", dict(
        max_update=30, base_lr=0.1, warmup_steps=4, warmup_begin_lr=0.03,
        warmup_mode="constant")),
}


@pytest.mark.parametrize("case", sorted(SCHEDULERS))
def test_lr_schedulers_match_jax_exactly(case):
    cls, kw = SCHEDULERS[case]
    ref = getattr(jsched, cls)(**kw)
    got = getattr(tmx.lr_scheduler, cls)(**kw)
    assert [got(n) for n in range(51)] == [ref(n) for n in range(51)]


def test_optimizer_follows_its_scheduler():
    sched = tmx.lr_scheduler.CosineScheduler(**COSINE)
    opt = tmx.optimizer.create("nag", lr_scheduler=sched, **NAG)
    ref = jsched.CosineScheduler(**COSINE)
    w = torch.ones(3)
    upd = tmx.optimizer.get_updater(opt)
    for k in range(1, 6):
        upd(0, torch.ones(3), w)
        assert opt.num_update == k and opt.learning_rate == ref(k)
    with pytest.raises(MXNetError, match="lr_scheduler"):
        opt.set_learning_rate(0.5)


def test_nag_update_matches_jax():
    from incubator_mxnet_tpu.ops import optimizer as jopt
    import jax.numpy as jnp
    rs = np.random.RandomState(6)
    w, g, m = (rs.randn(37).astype(np.float32) for _ in range(3))
    kw = dict(lr=0.1, momentum=0.9, wd=1e-2, rescale_grad=0.5,
              clip_gradient=0.7)
    ref_w, ref_m = jopt.nag_mom_update(jnp.asarray(w), jnp.asarray(g),
                                       jnp.asarray(m), **kw)
    tw, tm = torch.from_numpy(w.copy()), torch.from_numpy(m.copy())
    tmx.ops.optimizer.nag_mom_update(tw, torch.from_numpy(g), tm, **kw)
    # the same f32 arithmetic, up to a fused multiply-add
    np.testing.assert_allclose(tw.numpy(), np.asarray(ref_w), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(tm.numpy(), np.asarray(ref_m), rtol=1e-6,
                               atol=1e-7)
    # bf16: through an f32 copy, rounded once
    bw, bm = tw.bfloat16(), tm.bfloat16()
    fw, fm = bw.float(), bm.float()
    tmx.ops.optimizer.nag_mom_update(bw, torch.from_numpy(g), bm, **kw)
    tmx.ops.optimizer.nag_mom_update(fw, torch.from_numpy(g), fm, **kw)
    assert torch.equal(bw, fw.bfloat16()) and torch.equal(bm, fm.bfloat16())


# --- trainer states: the slice's loop on the small CNN ---------------------

STEPS, SAVE_AT = 4, 2


def _jax_run(x, y):
    """The JAX package's uninterrupted run: initial parameters, and per
    step the loss and the parameters after it."""
    jrandom.seed(1)
    net = _cnn(jgluon.nn)
    net.initialize(jinit.MSRAPrelu())
    net(nd.array(x))
    init = _jax_params(net)
    net.collect_params(NO_WD).setattr("wd_mult", 0.0)
    trainer = jgluon.Trainer(net.collect_params(), "nag", dict(
        NAG, lr_scheduler=jsched.CosineScheduler(**COSINE)))
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    steps = []
    for _ in range(STEPS):
        with jag.record():
            loss = loss_fn(net(nd.array(x)), nd.array(y))
            loss.backward()
        trainer.step(B)
        steps.append(dict(loss=loss.asnumpy(), after=_jax_params(net)))
    return init, steps


def _port_trainer(net):
    net.collect_params(NO_WD).setattr("wd_mult", 0.0)
    return tmx.gluon.Trainer(net.collect_params(), "nag", dict(
        NAG, lr_scheduler=tmx.lr_scheduler.CosineScheduler(**COSINE)))


def _port_steps(net, trainer, x, y, n, metrics, save=None):
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    steps = []
    for k in range(n):
        with tmx.autograd.record():
            out = net(x)
            loss = loss_fn(out, y)
        tmx.autograd.backward(loss)
        trainer.step(B)
        for m in metrics:
            m.update([y], [out])
        steps.append(dict(loss=loss.detach().clone(),
                          after=_port_params(net)))
        if save is not None and k + 1 == SAVE_AT:
            net.save_parameters(save + ".params")
            trainer.save_states(save + ".states")
    return steps


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    x, y = _data(7)
    init, ref = _jax_run(x, y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    save = str(tmp_path_factory.mktemp("resume") / "run")
    net = _cnn(tmx.gluon.nn)
    tmx.weights.load_reference_params(net, init, device="cpu")
    metrics = [tmx.metric.Accuracy(), tmx.metric.TopKAccuracy(5)]
    trainer = _port_trainer(net)
    whole = _port_steps(net, trainer, tx, ty, STEPS, metrics, save)
    # resumed in fresh objects, with a fresh scheduler
    net2 = _cnn(tmx.gluon.nn)
    net2.load_parameters(save + ".params", ctx="cpu")
    trainer2 = _port_trainer(net2)
    trainer2.load_states(save + ".states")
    resumed = _port_steps(net2, trainer2, tx, ty, STEPS - SAVE_AT, [])
    return dict(ref=ref, whole=whole, resumed=resumed, trainer=trainer,
                trainer2=trainer2, metrics=metrics, y=y)


def test_resumed_run_equals_uninterrupted_bit_for_bit(trainer_runs):
    whole, resumed = trainer_runs["whole"], trainer_runs["resumed"]
    for got, want in zip(resumed, whole[SAVE_AT:]):
        assert torch.equal(got["loss"], want["loss"])
        for n, t in want["after"].items():
            assert torch.equal(got["after"][n], t), n
    t1, t2 = trainer_runs["trainer"], trainer_runs["trainer2"]
    assert t2.optimizer.num_update == t1.optimizer.num_update == STEPS
    assert t2.optimizer._index_update_count == \
        t1.optimizer._index_update_count
    assert vars(t2.optimizer.lr_scheduler) == vars(t1.optimizer.lr_scheduler)
    assert t2.learning_rate == t1.learning_rate
    for i, s in t1._updater.states.items():
        assert torch.equal(t2._updater.states[i], s)


def test_uninterrupted_run_matches_jax(trainer_runs):
    for got, ref in zip(trainer_runs["whole"], trainer_runs["ref"]):
        np.testing.assert_allclose(got["loss"].numpy(), ref["loss"], rtol=0,
                                   atol=TOL)
        for n, r in ref["after"].items():
            np.testing.assert_allclose(got["after"][n].numpy(), r, rtol=0,
                                       atol=TOL, err_msg=n)


def test_metrics_of_the_run_read_once(trainer_runs):
    acc, top5 = trainer_runs["metrics"]
    assert isinstance(acc.sum_metric, torch.Tensor)
    assert acc.num_inst == top5.num_inst == STEPS * B
    name, value = acc.get()
    assert name == "accuracy" and 0.0 <= value <= 1.0
    assert top5.get()[0] == "top_k_accuracy_5"
    assert top5.get()[1] >= value


def test_states_file_holds_cpu_tensors_and_no_parameters(trainer_runs,
                                                         tmp_path):
    import pickle
    path = str(tmp_path / "s")
    trainer_runs["trainer"].save_states(path)
    with open(path, "rb") as f:
        states, opt = pickle.loads(f.read())
    assert isinstance(opt, tmx.optimizer.NAG) and opt.param_dict == {}
    assert all(s.device.type == "cpu" for s in states.values())
    assert isinstance(opt.lr_scheduler, tmx.lr_scheduler.CosineScheduler)


def test_resnet_user_loop_resumes_bit_for_bit(tmp_path):
    """get_model with deferred widths, initialize, the no-wd pattern,
    NAG + CosineScheduler, metrics, save after step 2 and resume."""
    rs = np.random.RandomState(8)
    x = torch.from_numpy(rs.randn(2, 3, 32, 32).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, CLASSES, 2).astype(np.float32))
    get = tmx.gluon.model_zoo.vision.get_model
    tmx.random.seed(0)
    net = get("resnet18_v1b", classes=CLASSES)
    net.initialize(tmx.init.MSRAPrelu(), ctx=tmx.cpu())
    net.hybridize(static_alloc=True, static_shape=True)
    trainer = _port_trainer(net)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    save = str(tmp_path / "r")

    def run(net, trainer, n, save=None):
        losses = []
        metric = tmx.metric.CompositeEvalMetric(
            [tmx.metric.Accuracy(), tmx.metric.TopKAccuracy(5)])
        for k in range(n):
            with tmx.autograd.record():
                out = net(x)
                loss = loss_fn(out, y)
            tmx.autograd.backward(loss)
            trainer.step(2)
            metric.update([y], [out])
            losses.append(loss.detach().clone())
            if save and k + 1 == SAVE_AT:
                net.save_parameters(save + ".params")
                trainer.save_states(save + ".states")
        return losses, metric.get()
    whole, whole_metric = run(net, trainer, STEPS, save)
    net2 = get("resnet18_v1b", classes=CLASSES)
    net2.load_parameters(save + ".params", ctx="cpu")
    trainer2 = _port_trainer(net2)
    trainer2.load_states(save + ".states")
    resumed, _ = run(net2, trainer2, STEPS - SAVE_AT)
    assert all(torch.equal(a, b) for a, b in zip(resumed, whole[SAVE_AT:]))
    for n, p in net.collect_params().items():
        assert torch.equal(p, net2.collect_params()[n]), n
    assert whole_metric[0] == ["accuracy", "top_k_accuracy_5"]
    assert all(0.0 <= v <= 1.0 for v in whole_metric[1])


def test_gluon_utils():
    from incubator_mxnet_tpu.gluon import utils as jutils
    rs = np.random.RandomState(9)
    arrays = [rs.randn(4, 3).astype(np.float32) * 3,
              rs.randn(5).astype(np.float32)]
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    js = [nd.array(a) for a in arrays]
    assert tmx.gluon.utils.clip_global_norm(ts, 1.0) == pytest.approx(
        jutils.clip_global_norm(js, 1.0), rel=1e-6)
    for t, j in zip(ts, js):
        np.testing.assert_allclose(t.numpy(), j.asnumpy(), rtol=1e-6)
    data = torch.arange(10.0).reshape(5, 2)
    parts = tmx.gluon.utils.split_data(data, 2, even_split=False)
    ref = jutils.split_data(nd.array(data.numpy()), 2, even_split=False)
    assert [p.tolist() for p in parts] == [r.asnumpy().tolist() for r in ref]
    with pytest.raises(MXNetError, match="evenly split"):
        tmx.gluon.utils.split_data(data, 2)
    loaded = tmx.gluon.utils.split_and_load(data.numpy(), [tmx.cpu()])
    assert len(loaded) == 1 and torch.equal(loaded[0], data)
    missing = "file://" + os.path.join(os.path.dirname(__file__),
                                       "no_such_file.bin")
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(MXNetError, match="download of .*no_such_file"
                           ".bin failed .* place the file at"):
            tmx.gluon.utils.download(missing, path=d)
        assert os.listdir(d) == []
    path = os.path.join(os.path.dirname(__file__), "test_torch_imports.py")
    import hashlib
    with open(path, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()
    assert tmx.gluon.utils.check_sha1(path, digest)
