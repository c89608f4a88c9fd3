"""PyTorch port: the vision model zoo against the JAX package.

Every family of the JAX registry is built in both packages from the
same constructor (reduced multipliers, widths or depth where the family
takes them, 10 classes, the smallest input it takes), the JAX net
initialized with MSRAPrelu and its weights carried into the port with
`weights.load_reference_params`.  The same batch of 4 images then takes
one training step in each: the logits (BatchNorm on batch statistics),
and every parameter after one SGD step (lr 0.1, momentum 0.9, wd 1e-4)
of SoftmaxCrossEntropyLoss.  Dropout is set to rate 0 in both (each
package draws its own masks).

The JAX side runs hybridized, one XLA program for its forward and
backward (op by op, a MobileNetV2 step costs about 30 s on the CPU),
whose f32 sums run in other orders than the port's.  A training step at
these sizes is not a smooth function of its inputs at rounding level:
BatchNorm over a few values per channel and the ReLU/ReLU6 kinks turn
the last bits of the activations into changes of up to a fifth of a
parameter update's scale (MobileNetV2 1.0 at 32 x 32).  So the logits,
and each parameter's change in the step (its scale floored at 1e-3 of
the largest change), are held to the port's own spread: the same step
run again with every initial parameter nudged by 1 ± 2**-22 (two seeds;
a change at rounding level in every layer, as another summation order
makes), on one thread so that it is the same in every process.  The
logits' error, and the median, the 90th percentile and the largest of
the tensors' errors, must each be within SPREAD_FACTOR times the
spread's, or within TOL (f32 rounding of order-1 values).  Measured:
at most 0.47 of that bound over the families.  A wrong layer, stride,
shortcut or wiring moves them by O(1).  The port's pointwise Conv2D →
BatchNorm pairs run fused (the kernel's plain version on the CPU), and
the count of fused calls in the step equals the pairs counted from the
block tree.  Inception v3 needs 299 x 299 inputs (its final 8 x 8 pool): its
mixed blocks are held here at a small input, the whole net only in a
slow test.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import random as jrandom
from incubator_mxnet_tpu.gluon.model_zoo import vision as jvision
from incubator_mxnet_tpu.gluon.model_zoo.vision import inception as jinc
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
    inception as tinc
from incubator_mxnet_tpu_torch.gluon.nn import fused_pairs
from incubator_mxnet_tpu_torch.ops import conv_stats as tcs

pytestmark = pytest.mark.torch_port

B = 4
CLASSES = 10
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
TOL = 1e-6
#: an error within this many times the port's own spread passes
SPREAD_FACTOR = 3.0


def _zoo(pkg):
    return jvision if pkg == "jax" else tvision


def _inc(pkg):
    return jinc if pkg == "jax" else tinc


#: name -> (constructor(package name), image side).  The JAX side compiles
#: each net (10-40 s apiece), so the families are held in five files of
#: under a minute each: this one (MobileNetV2), test_torch_model_zoo_
#: mobilenet.py, _resnet.py, _classic.py and _inception.py
FAMILIES = {
    "mobilenet_v2_0_25": (lambda p: _zoo(p).mobilenet_v2_0_25(
        classes=CLASSES), 32),
    "mobilenet_v2_1_0": (lambda p: _zoo(p).mobilenet_v2_1_0(
        classes=CLASSES), 32),
    "mobilenet0_25": (lambda p: _zoo(p).mobilenet0_25(classes=CLASSES),
                      32),
    "mobilenet_v3_small": (lambda p: _zoo(p).mobilenet_v3_small(
        multiplier=0.5, classes=CLASSES), 32),
    "mobilenet_v3_large": (lambda p: _zoo(p).mobilenet_v3_large(
        multiplier=0.35, classes=CLASSES), 32),
    "resnet_v2_basic": (lambda p: _zoo(p).ResNetV2(
        _zoo(p).BasicBlockV2, [1, 1, 1, 1], [8, 8, 16, 32, 64],
        classes=CLASSES, thumbnail=True), 16),
    "resnet_v2_bottleneck": (lambda p: _zoo(p).ResNetV2(
        _zoo(p).BottleneckV2, [1, 2, 1, 1], [8, 16, 32, 64, 128],
        classes=CLASSES), 32),
    "vgg_bn": (lambda p: _zoo(p).VGG([1, 1, 1, 1, 1], [8, 8, 16, 16, 16],
                                     classes=CLASSES, batch_norm=True), 32),
    "vgg": (lambda p: _zoo(p).VGG([1, 1, 2, 1, 1], [8, 8, 16, 16, 16],
                                  classes=CLASSES), 32),
    "alexnet": (lambda p: _zoo(p).alexnet(classes=CLASSES), 64),
    "densenet": (lambda p: _zoo(p).DenseNet(8, 4, [2, 3], bn_size=2,
                                            classes=CLASSES), 32),
    "squeezenet1_0": (lambda p: _zoo(p).squeezenet1_0(classes=CLASSES),
                      64),
    "squeezenet1_1": (lambda p: _zoo(p).squeezenet1_1(classes=CLASSES),
                      64),
    "inception_a_b": (lambda p: _inception_blocks(p, "AB"), 9),
    "inception_c_d_e": (lambda p: _inception_blocks(p, "CDE"), 9),
    "inception_v3": (lambda p: _zoo(p).inception_v3(classes=CLASSES), 299),
}


def _inception_blocks(pkg, which):
    """Inception v3's mixed blocks behind a 16-channel stem convolution,
    pooled into a Dense head: A and B, or C, D and E (B and D stride 2,
    so the input side 9 becomes 4, then 1 after D)."""
    m = _inc(pkg)
    nn = jmx.gluon.nn if pkg == "jax" else tmx.gluon.nn
    net = nn.HybridSequential()
    net.add(m._conv(16, 3, 1, 1))
    if which == "AB":
        net.add(m._make_A(8), m._make_B())
    else:
        net.add(m._make_C(8), m._make_D(), m._make_E())
    net.add(nn.GlobalAvgPool2D(), nn.Flatten(), nn.Dense(CLASSES))
    return net


def _no_dropout_jax(block):
    if isinstance(block, jmx.gluon.nn.Dropout):
        block._rate = 0.0
    for child in block._children.values():
        _no_dropout_jax(child)


def _no_dropout_port(net):
    for m in net.modules():
        if isinstance(m, tmx.gluon.nn.Dropout):
            m._rate = 0.0


def _data(side, scale=1.0):
    rs = np.random.RandomState(0)
    return ((rs.randn(B, 3, side, side) * scale).astype(np.float32),
            rs.randint(0, CLASSES, B).astype(np.float32))


def _initial(name, value):
    """A parameter's value before the first training forward: the
    running statistics as their initializers make them (the forward
    updates them in place), every other as the JAX net holds it."""
    if name.endswith("running_mean"):
        return np.zeros_like(value)
    if name.endswith("running_var"):
        return np.ones_like(value)
    return value


def _jax_step(build, side):
    """The JAX net hybridized: its initial parameters, the logits of a
    training forward and every parameter after one SGD step."""
    x, y = _data(side)
    jrandom.seed(0)
    net = build("jax")
    _no_dropout_jax(net)
    net.initialize(jmx.init.MSRAPrelu())
    net.hybridize()
    trainer = jgluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    with jag.record():
        out = net(nd.array(x))
        loss = loss_fn(out, nd.array(y))
    loss.backward()
    named = net._collect_params_with_prefix()
    init = {n: _initial(n, p.data().asnumpy()) for n, p in named.items()}
    trainer.step(B)
    return init, out.asnumpy(), {n: p.data().asnumpy()
                                 for n, p in named.items()}


def _port_step(build, side, init, scale=1.0):
    """The port's net from the JAX weights: the logits, every parameter
    after one SGD step, and the fused conv calls of the step, for the
    images times `scale`."""
    x, y = _data(side, scale)
    net = build("port")
    _no_dropout_port(net)
    tmx.weights.load_reference_params(net, init, device="cpu")
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd", dict(SGD))
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    calls = []
    orig = tcs.fused_conv1x1_stats
    tcs.fused_conv1x1_stats = lambda a, b: calls.append(1) or orig(a, b)
    try:
        with tmx.autograd.record():
            out = net(torch.from_numpy(x))
            loss = loss_fn(out, torch.from_numpy(y))
        tmx.autograd.backward(loss)
    finally:
        tcs.fused_conv1x1_stats = orig
    trainer.step(B)
    return net, out.detach().numpy(), {
        n: p.detach().numpy().copy()
        for n, p in net.collect_params().items()}, len(calls)


def _scaled(got, ref):
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def _delta_errors(init, after, ref_after):
    """{name: the largest error of a parameter's change in the step over
    the reference change's scale}, floored at 1e-3 of the largest."""
    ref = {n: ref_after[n] - init[n] for n in init}
    floor = 1e-3 * max(np.abs(d).max() for d in ref.values())
    return {n: float(np.abs(after[n] - init[n] - r).max())
            / max(float(np.abs(r).max()), floor) for n, r in ref.items()}


def _nudged(init, seed):
    """The initial parameters, each element times 1 ± 2**-22 (random
    signs from `seed`): a change at rounding level in every layer, as
    another order of the f32 sums makes."""
    rs = np.random.RandomState(seed)
    return {n: (a * (1.0 + 2.0 ** -22 * rs.choice([-1.0, 1.0], a.shape))
                ).astype(np.float32) for n, a in init.items()}


def check_family(name):
    """One family's step in both packages, held to the port's spread
    under `_nudged` parameters (module doc); returns {statistic:
    (error, spread)}."""
    build, side = FAMILIES[name]
    init, ref_out, ref_after = _jax_step(build, side)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        net, out, after, calls = _port_step(build, side, init)
        moved = [_port_step(build, side, _nudged(init, seed))[1:3]
                 for seed in (1, 2)]
    finally:
        torch.set_num_threads(threads)
    assert set(after) == set(ref_after)
    err = _delta_errors(init, after, ref_after)
    spreads = [_delta_errors(init, a, after) for _, a in moved]
    def pct(errs, q):
        return float(np.percentile(list(errs.values()), q))
    rows = {"logits": (_scaled(out, ref_out),
                       max(_scaled(o, out) for o, _ in moved))}
    for q in (50, 90, 100):
        rows["p%d" % q] = (pct(err, q), max(pct(s, q) for s in spreads))
    for what, (e, s) in rows.items():
        assert e <= max(TOL, SPREAD_FACTOR * s), (name, what, e, s)
    assert calls == fused_pairs(net)
    return rows


@pytest.mark.parametrize("name", ["mobilenet_v2_0_25", "mobilenet_v2_1_0"])
def test_family_step_matches_jax(name):
    check_family(name)


def test_fused_pair_counts():
    """The pairs each full-width family fuses while training, from its
    block tree: MobileNetV2 34 (16 expansions, 17 projections and the
    head) at any multiplier, MobileNet 1.0 13 (its pointwise halves),
    MobileNetV3 large 30 and small 22 (expansions where the width grows,
    projections, the head), DenseNet-121 58 (each dense layer's
    bottleneck), Inception v3 40 (its 1x1 convolutions), ResNet-50 v1b
    33, and none in the families whose 1x1 convolutions carry a bias or
    no BatchNorm, or whose v2 blocks hold their layers apart."""
    want = {"mobilenet_v2_1_0": 34, "mobilenet_v2_0_25": 34,
            "mobilenet1_0": 13, "densenet121": 58, "resnet50_v1b": 33,
            "resnet50_v2": 0, "vgg16_bn": 0, "alexnet": 0,
            "squeezenet1_1": 0, "inception_v3": 40,
            "mobilenet_v3_large": 30, "mobilenet_v3_small": 22}
    got = {n: fused_pairs(tvision.get_model(n)) for n in want}
    assert got == want


def test_registry_names_and_structure_match_jax():
    """`get_model` builds every name of the JAX registry; each net has
    the JAX net's structural parameter names and every width the JAX net
    knows before its first forward; `pretrained=True` raises."""
    assert sorted(tvision._models) == sorted(jvision._models)
    for name in sorted(jvision._models):
        jnet = jvision.get_model(name)
        tnet = tvision.get_model(name)
        jshapes = {n: tuple(p.shape) for n, p in
                   jnet._collect_params_with_prefix().items()}
        tshapes = {n: tuple(p.shape or ())
                   for n, p in tnet.collect_params().items()}
        assert set(tshapes) == set(jshapes), name
        for n, s in jshapes.items():
            if s and all(s):
                assert tshapes[n] == s, (name, n, tshapes[n], s)
    for name in ("mobilenet_v2_1_0", "vgg16", "alexnet", "densenet121",
                 "squeezenet1_0", "inception_v3", "resnet18_v2"):
        with pytest.raises(MXNetError, match="pretrained"):
            tvision.get_model(name, pretrained=True)


def test_mobilenet_v2_pointwise_shapes_are_the_kernel_list():
    """The (C, HW, O) of mobilenet_v2_1_0's fused pairs at 224 x 224,
    read from a training forward, are `MOBILENET_V2_CONV_SHAPES`
    with their counts."""
    net = tvision.get_model("mobilenet_v2_1_0")
    seen = []
    orig = tmx.ops.nn.conv1x1_bn_stats

    def spy(data, weight):
        seen.append((data.shape[1], data.shape[2] * data.shape[3],
                     weight.shape[0]))
        return orig(data, weight)
    tmx.ops.nn.conv1x1_bn_stats = spy
    try:
        net.initialize(ctx="cpu")
        with tmx.autograd.record():
            net(torch.zeros(1, 3, 224, 224))
    finally:
        tmx.ops.nn.conv1x1_bn_stats = orig
    counts = {}
    for s in seen:
        counts[s] = counts.get(s, 0) + 1
    assert sorted((c, hw, o, k) for (c, hw, o), k in counts.items()) == \
        sorted(tcs.MOBILENET_V2_CONV_SHAPES)
    assert sum(k for *_, k in tcs.MOBILENET_V2_CONV_SHAPES) == 34


@pytest.mark.slow
def test_inception_v3_step_matches_jax():
    """The whole Inception v3 at 299 x 299 (10 classes): 40 fused
    pairs."""
    check_family("inception_v3")
