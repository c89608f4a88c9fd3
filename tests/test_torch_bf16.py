"""PyTorch port: bf16 training against the JAX package.

* The optimizer updates in the weight's own dtype (F2): every update
  computes in f32 and rounds once into the weight's and the state's
  dtype, as the JAX package's `_fused` / `_fused_multi` do; f32 weights
  keep their in-place f32 arithmetic.
* `Block.cast` gives every parameter the dtype the JAX block's `cast`
  gives it, keeping each `nn.Parameter`, so that a Trainer built before
  or after the cast updates the cast tensors.
* The slice as a whole: `bert_small(dropout=0.0, output_hidden=True)` +
  `FusedMLMCELoss`, both cast to bf16, Adam lr 1e-4, two steps, held to
  the JAX package by the bf16 rule (`_assert_bf16_rule`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon.block import nameless_scope
from incubator_mxnet_tpu import random as jrandom
from incubator_mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from incubator_mxnet_tpu.models import transformer as jtr
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
from incubator_mxnet_tpu.ops import attention as jatt
from incubator_mxnet_tpu.optimizer.optimizer import _fused, _fused_multi
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tresnet
from incubator_mxnet_tpu_torch.ops import optimizer as topt

pytestmark = pytest.mark.torch_port


@pytest.fixture(scope="module", autouse=True)
def _own_jax_block_names():
    """The JAX blocks built here take their auto-names from counters of
    their own: the JAX package's tests that share this process read
    parameters in the order of the names their counters give."""
    with nameless_scope():
        yield

V, B, T, LR, STEPS = 100, 2, 32, 1e-4, 2
KW = dict(vocab_size=V, max_length=64, dropout=0.0, output_hidden=True)
_BF16_ULP_BITS = 7      # bf16 keeps 7 explicit mantissa bits
# Adam moves an element by lr |m^ / (sqrt(v^) + eps)| a step: at most lr at
# t = 1 (the update reads its f32 m and v), and at t = 2 (betas 0.9, 0.999)
# at most sqrt(a^2/c + b^2/d) lr by Cauchy-Schwarz, a, b and c, d the
# bias-corrected weights of g1, g2 in m^ and v^: 1.0040 lr from the
# bf16-stored m and v of step 1 (1.00136 lr were they f32)
_ADAM_T2_BF16 = 1.0040
# the largest share of a tensor whose post-step elements may be "free" (held
# to the port's own step, not the bf16 rule; see the slice test): free
# elements stay a minority of each tensor, so the rule holds most of it
_FREE_CAP = 0.5


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (f32 array), floored at the
    spacing at bf16's smallest normal."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - _BF16_ULP_BITS)


# --- F2: dtype-preserving updates ------------------------------------------

_SHAPES = ((64, 32), (1000,), (7, 3))
_HYPER = dict(rescale_grad=0.125)
_STATIC = dict(clip_gradient=-1.0)
_UPDATES = {
    # name: (JAX op, lr, extra scalars, states as (kind,) per state)
    "sgd": ("sgd_update", 0.1, {}, ()),
    "sgd_mom": ("sgd_mom_update", 0.1, dict(momentum=0.9), ("mom",)),
    "adam": ("adam_update", 1e-3, dict(beta1=0.9, beta2=0.999,
                                       epsilon=1e-8), ("mom", "var")),
    "multi_sgd": ("sgd_update", 0.1, {}, ()),
    "multi_sgd_mom": ("sgd_mom_update", 0.1, dict(momentum=0.9), ("mom",)),
}


def _update_inputs(kinds, dtype, seed=0):
    """[(weight, grad, *states)] per shape as torch tensors of `dtype`
    (bf16 values are rounded once from f32 draws)."""
    rs = np.random.RandomState(seed)
    out = []
    for shape in _SHAPES:
        arrs = [rs.randn(*shape), rs.randn(*shape)]
        for kind in kinds:
            arrs.append(rs.randn(*shape) * 0.1 if kind == "mom"
                        else rs.rand(*shape) * 0.01)
        out.append([torch.from_numpy(a.astype(np.float32)).to(dtype)
                    for a in arrs])
    return out


def _jax_nd(t):
    """The JAX NDArray of a torch tensor's values, in its dtype."""
    a = jnp.asarray(t.float().numpy())
    return NDArray(a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16
                   else a)


def _np32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _port_update(name, tensors, lr, wd, extra):
    """Run the port's update in place on `tensors` ([(w, g, *states)])."""
    kw = dict(_HYPER, clip_gradient=-1.0, **extra)
    if name.startswith("multi_"):
        ws, gs = [t[0] for t in tensors], [t[1] for t in tensors]
        lrs = [lr * (i + 1) for i in range(len(tensors))]
        wds = [wd * (i + 1) for i in range(len(tensors))]
        if name == "multi_sgd":
            topt.multi_sgd_update(ws, gs, lrs, wds, **kw)
        else:
            topt.multi_sgd_mom_update(ws, gs, [t[2] for t in tensors], lrs,
                                      wds, **kw)
        return
    for t in tensors:
        getattr(topt, name + "_update")(*t, lr=lr, wd=wd, **kw)


def _jax_update(name, tensors, lr, wd, extra):
    """The JAX package's outputs [(w, *states)] as f32 numpy arrays."""
    op = _UPDATES[name][0]
    if name.startswith("multi_"):
        ws = [_jax_nd(t[0]) for t in tensors]
        gs = [_jax_nd(t[1]) for t in tensors]
        cols = [[_jax_nd(t[j]) for t in tensors]
                for j in range(2, len(tensors[0]))]
        _fused_multi(op, ws, gs, cols,
                     [lr * (i + 1) for i in range(len(tensors))],
                     [wd * (i + 1) for i in range(len(tensors))],
                     dict(_HYPER, **extra), _STATIC)
        return [[_np32(w._data)] + [_np32(c[i]._data) for c in cols]
                for i, w in enumerate(ws)]
    out = []
    for t in tensors:
        res = _fused(op, [_jax_nd(a) for a in t],
                     dict(_HYPER, lr=lr, wd=wd, **extra), _STATIC)
        res = res if isinstance(res, tuple) else (res,)
        out.append([_np32(r) for r in res])
    return out


@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(_UPDATES))
def test_updates_in_bf16_match_jax(name, dtype, wd):
    """Both sides do the update in f32 and round once to the buffer's
    dtype.  They are held within one bf16 ulp for bf16 buffers, not
    equal: torch takes 1 - beta1 (and the other alpha constants) in
    double and rounds it to f32 once (0.1f), where XLA computes
    1 - f32(0.9) in f32 (0.100000024), and adds with alpha may fuse into
    one FMA; such last-bit differences of the f32 result tip its
    rounding to bf16 now and then.  f32 buffers (whose arithmetic the
    repair leaves as it was) are held within 2**-20 of the tensor's
    largest |value|, eight f32 ulps of it, for the same reasons: where a
    result cancels, as b1 m + (1 - b1) g can, the constants' last bits
    are many ulps of the result (XLA's 1 - f32(0.999) is 0.00099998713,
    torch's f32(0.001) 0.0010000000475).  Before the repair the port
    rounded bf16 after every op (ROADMAP.md, Queue 3, F2)."""
    _, lr, extra, kinds = _UPDATES[name]
    tensors = _update_inputs(kinds, dtype)
    ref = _jax_update(name, tensors, lr, wd, extra)
    grads = [t[1].clone() for t in tensors]
    _port_update(name, tensors, lr, wd, extra)
    for t, g in zip(tensors, grads):
        assert torch.equal(t[1], g)                 # the gradient is kept
    for got, want in zip(tensors, ref):
        outs = [got[0]] + got[2:]
        for i, (o, r) in enumerate(zip(outs, want)):
            assert o.dtype == dtype
            err = np.abs(o.float().numpy() - r)
            if dtype == torch.bfloat16:
                tol = _bf16_ulp(r)
            else:
                tol = 2.0 ** -20 * np.abs(r).max()
            assert (err <= tol).all(), (name, i, float((err / tol).max()))


def _f32_reference(name, t, lr, wd, kw):
    """The in-place f32 arithmetic the updates had before they became
    dtype-preserving, on the tensors `t` ([(w, g, *states)]); the
    multi-tensor forms as per-tensor ops, which is what the CPU's
    `_foreach_*` ops run."""
    rescale, clip = kw["rescale_grad"], kw["clip_gradient"]
    lrs = [lr * (i + 1) for i in range(len(t))]
    wds = [wd * (i + 1) for i in range(len(t))]
    for i, (w, g, *st) in enumerate(t):
        if name.startswith("multi_"):
            lr, wd = lrs[i], wds[i]
        g = g * rescale
        if clip > 0:
            g = g.clamp_(-clip, clip)
        if name == "adam":
            m, v = st
            if wd:
                g.add_(w, alpha=wd)
            m.mul_(kw["beta1"]).add_(g, alpha=1.0 - kw["beta1"])
            v.mul_(kw["beta2"]).addcmul_(g, g, value=1.0 - kw["beta2"])
            w.addcdiv_(m, v.sqrt().add_(kw["epsilon"]), value=-lr)
        elif st:
            g.add_(w, alpha=wd)
            st[0].mul_(kw["momentum"]).sub_(g.mul_(lr))
            w.add_(st[0])
        else:
            g.add_(w, alpha=wd)
            w.sub_(g.mul_(lr))


@pytest.mark.parametrize("clip", [-1.0, 0.3])
@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("name", list(_UPDATES))
def test_f32_updates_keep_their_arithmetic(name, wd, clip):
    """f32 weights and states take the same in-place f32 ops as before the
    dtype-preserving repair, bit for bit."""
    _, lr, extra, kinds = _UPDATES[name]
    got = _update_inputs(kinds, torch.float32, seed=1)
    want = [[a.clone() for a in t] for t in got]
    kw = dict(_HYPER, clip_gradient=clip, **extra)
    if name.startswith("multi_"):
        ws, gs = [t[0] for t in got], [t[1] for t in got]
        lrs = [lr * (i + 1) for i in range(len(got))]
        wds = [wd * (i + 1) for i in range(len(got))]
        if name == "multi_sgd":
            topt.multi_sgd_update(ws, gs, lrs, wds, **kw)
        else:
            topt.multi_sgd_mom_update(ws, gs, [t[2] for t in got], lrs, wds,
                                      **kw)
    else:
        for t in got:
            getattr(topt, name + "_update")(*t, lr=lr, wd=wd, **kw)
    _f32_reference(name, want, lr, wd, kw)
    for g_t, w_t in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g_t, w_t))


@pytest.mark.parametrize("wd", [0.0, 1e-4])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_mp_sgd_updates_match_jax(momentum, wd):
    """mp_sgd_update / mp_sgd_mom_update: the f32 master copy and momentum
    within 2**-20 of their largest |value| (the f32 arithmetic, as
    above), the float16 weight within one float16 ulp (it is the master
    copy rounded once on both sides)."""
    from incubator_mxnet_tpu.ops import optimizer as jopt
    rs = np.random.RandomState(3)
    w32, g, mom = (rs.randn(300).astype(np.float32) for _ in range(3))
    w16, g16 = w32.astype(np.float16), g.astype(np.float16)
    kw = dict(lr=0.1, wd=wd, rescale_grad=0.125, clip_gradient=-1.0)
    tw, tg, tw32 = (torch.from_numpy(a.copy()) for a in (w16, g16, w32))
    if momentum:
        ref = jopt.mp_sgd_mom_update(*(jnp.asarray(a) for a in
                                       (w16, g16, mom, w32)),
                                     momentum=momentum, **kw)
        tm = torch.from_numpy(mom.copy())
        topt.mp_sgd_mom_update(tw, tg, tm, tw32, momentum=momentum, **kw)
        outs = (tw, tm, tw32)
    else:
        ref = jopt.mp_sgd_update(*(jnp.asarray(a) for a in (w16, g16, w32)),
                                 **kw)
        topt.mp_sgd_update(tw, tg, tw32, **kw)
        outs = (tw, tw32)
    assert tw.dtype == torch.float16 and tw32.dtype == torch.float32
    for got, r in zip(outs, ref):
        r = np.asarray(r, np.float32)
        err = np.abs(got.float().numpy() - r)
        if got.dtype == torch.float16:
            tol = 2.0 ** (np.floor(np.log2(np.abs(r) + 2.0 ** -14)) - 10)
        else:
            tol = 2.0 ** -20 * np.abs(r).max()
        assert (err <= tol).all()


# --- bf16 ops and Block.cast ----------------------------------------------

def _bf16_rule_tol(jax_bf16, jax_f32):
    """Elementwise tolerance of the bf16 rule: twice the JAX bf16
    result's largest distance to the JAX f32 result, plus one bf16 ulp
    of each element of the f32 result."""
    jax_bf16, jax_f32 = (np.asarray(a, np.float32)
                         for a in (jax_bf16, jax_f32))
    return 2.0 * np.abs(jax_bf16 - jax_f32).max() + _bf16_ulp(jax_f32)


def _assert_bf16_rule(name, port, jax_bf16, jax_f32, free=None):
    """The bf16 rule: the port's bf16 result within `_bf16_rule_tol` of
    the JAX f32 result from the same bf16-valued inputs.  The packages
    round at different points (F.layer_norm rounds once where the JAX
    layer_norm rounds after each bf16 op), so the port is not held to
    the JAX bf16 result directly; that distance is printed.  Elements
    marked `free` are left to the caller."""
    port, jax_bf16, jax_f32 = (np.asarray(a, np.float32)
                               for a in (port, jax_bf16, jax_f32))
    assert port.shape == jax_f32.shape, name
    err = np.abs(port - jax_f32)
    tol = _bf16_rule_tol(jax_bf16, jax_f32)
    if free is not None:
        tol = np.where(free, np.inf, tol)
    print("%s: port-bf16 vs jax-f32 %.3g, jax-bf16 vs jax-f32 %.3g, "
          "port-bf16 vs jax-bf16 %.3g" % (
              name, err.max(), np.abs(jax_bf16 - jax_f32).max(),
              np.abs(port - jax_bf16).max()))
    assert (err <= tol).all(), (name, float((err / tol).max()))


def _bf16_values(a):
    """f32 numpy array of `a` rounded to bf16."""
    return np.asarray(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def _jax_op(fn, arrays, dtypes):
    import jax
    return jax.vjp(fn, *(jnp.asarray(a).astype(dt)
                         for a, dt in zip(arrays, dtypes)))


_OPS = {
    # name: (inputs' shapes, JAX fn, port fn, differentiable inputs)
    "embedding": lambda jnn, tnn: (
        lambda w: jnn.embedding(jnp.asarray([[3, 1], [0, 7]]), w),
        lambda w: tnn.embedding(torch.tensor([[3, 1], [0, 7]]), w),
        [(8, 16)]),
    "layer_norm": lambda jnn, tnn: (
        jnn.layer_norm, tnn.layer_norm, [(4, 6, 32), (32,), (32,)]),
    "gelu": lambda jnn, tnn: (
        lambda x: jnn.leaky_relu(x, act_type="gelu"),
        lambda x: tnn.leaky_relu(x, act_type="gelu"), [(4, 6, 32)]),
    "fully_connected": lambda jnn, tnn: (
        lambda x, w, b: jnn.fully_connected(x, w, b, num_hidden=24,
                                            flatten=False),
        lambda x, w, b: tnn.fully_connected(x, w, b, num_hidden=24,
                                            flatten=False),
        [(4, 6, 32), (24, 32), (24,)]),
    "fused_linear_softmax_ce": lambda jnn, tnn: (
        lambda h, w, b: jnn.fused_linear_softmax_ce(
            h, w, b, jnp.arange(24) % 37, num_chunks=4),
        lambda h, w, b: tnn.fused_linear_softmax_ce(
            h, w, b, torch.arange(24) % 37, num_chunks=4),
        [(24, 16), (37, 16), (37,)]),
}


@pytest.mark.parametrize("op", list(_OPS))
def test_bf16_ops_keep_jax_dtypes_and_values(op):
    """Each op of BERT's bf16 step on bf16 inputs: the port returns the
    dtypes the JAX op returns (outputs and input gradients; the fused CE
    gives an f32 loss, a bf16 dh and dw and db in the weight's dtype) and
    values under the bf16 rule.  Dropout is checked by dtype only (its
    mask is random)."""
    from incubator_mxnet_tpu.ops import nn as jnn
    from incubator_mxnet_tpu_torch.ops import nn as tnn
    jfn, tfn, shapes = _OPS[op](jnn, tnn)
    rs = np.random.RandomState(5)
    arrays = [_bf16_values(rs.randn(*s)) for s in shapes]
    runs = {}
    for key, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        out, vjp = _jax_op(jfn, arrays, [dt] * len(arrays))
        dy = jnp.asarray(_bf16_values(np.linspace(-1, 1, out.size)
                                      .reshape(out.shape))).astype(out.dtype)
        runs[key] = (out, vjp(dy), dy)
    ts = [torch.from_numpy(np.array(a)).to(torch.bfloat16).requires_grad_()
          for a in arrays]
    out = tfn(*ts)
    out.backward(torch.from_numpy(np.array(runs["bf16"][2], np.float32))
                 .to(out.dtype))
    jout, jgrads, _ = runs["bf16"]
    assert str(out.dtype).replace("torch.", "") == str(jout.dtype)
    for t, jg in zip(ts, jgrads):
        assert str(t.grad.dtype).replace("torch.", "") == str(jg.dtype)
    _assert_bf16_rule(op, out.detach().float().numpy(),
                      np.asarray(jout.astype(jnp.float32)),
                      np.asarray(runs["f32"][0]))
    for i, (t, jg, jg32) in enumerate(zip(ts, jgrads, runs["f32"][1])):
        _assert_bf16_rule("%s d%d" % (op, i), t.grad.float().numpy(),
                          np.asarray(jg.astype(jnp.float32)),
                          np.asarray(jg32))


def test_bf16_dropout_and_mixed_dtypes_follow_jax():
    """Dropout keeps bf16; a bf16 activation against f32 weights follows
    the JAX ops: fully_connected computes in the activation's dtype (the
    amp rule), layer_norm in the promoted dtype (f32)."""
    from incubator_mxnet_tpu_torch.ops import nn as tnn
    x = torch.randn(4, 32).to(torch.bfloat16)
    assert tnn.dropout(x, 0.5, training=True).dtype == torch.bfloat16
    w, b = torch.randn(8, 32), torch.zeros(8)
    assert tnn.fully_connected(x, w, b).dtype == torch.bfloat16
    assert tnn.fully_connected(x.float(), w.bfloat16(),
                               b.bfloat16()).dtype == torch.float32
    g, beta = torch.ones(32), torch.zeros(32)
    out = tnn.layer_norm(x, g, beta)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, tnn.layer_norm(x.float(), g, beta))


def _jax_dtypes(block):
    """The dtype the JAX block's `cast` gives each parameter (its
    `Parameter.dtype`, which the cast sets whether or not the data is
    materialised yet)."""
    return {n: str(jnp.dtype(p.dtype))
            for n, p in block._collect_params_with_prefix().items()}


def _port_dtypes(block):
    return {n: str(p.dtype).replace("torch.", "")
            for n, p in block.collect_params().items()}


def test_block_cast_matches_jax_dtypes():
    """After cast("bfloat16") every parameter of bert_small and of a
    small ResNet v1b (BatchNorm's running statistics included) has, by
    structural name, the dtype the JAX block's parameter has after its
    cast; cast("float32") brings them back."""
    jbert = jtr.bert_small(**KW)
    jbert.initialize()
    net_args = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
    net_kw = dict(classes=10, thumbnail=True, stride_on_3x3=True)
    jres = jresnet.ResNetV1(jresnet.BottleneckV1, *net_args, **net_kw)
    pairs = [(jbert, tmx.models.bert_small(device="cpu", **KW)),
             (jres, tresnet.ResNetV1(tresnet.BottleneckV1, *net_args,
                                     device="cpu", **net_kw))]
    for jb, tb in pairs:
        assert set(_jax_dtypes(jb).values()) == {"float32"}
        jb.cast("bfloat16")
        before = {n: p for n, p in tb.collect_params().items()}
        assert tb.cast("bfloat16") is tb
        assert _port_dtypes(tb) == _jax_dtypes(jb)
        assert set(_port_dtypes(tb).values()) == {"bfloat16"}
        # each nn.Parameter object is kept
        assert all(p is before[n] for n, p in tb.collect_params().items())
        tb.cast("float32")
        assert set(_port_dtypes(tb).values()) == {"float32"}


@pytest.mark.parametrize("order", ["trainer_first", "cast_first"])
def test_trainer_updates_cast_parameters(order):
    """A Trainer built before or after the cast updates the bf16 tensors:
    after one Adam step every trained parameter is bf16 and moved."""
    tmx.random.seed(1)
    net = tmx.models.bert_small(device="cpu", **KW)
    head = tmx.models.FusedMLMCELoss(V, 64, device="cpu")
    params = {**net.collect_params(),
              **{"loss." + n: p for n, p in head.collect_params().items()}}
    if order == "trainer_first":
        trainer = tmx.gluon.Trainer(params, "adam", {"learning_rate": 1e-2})
    net.cast("bfloat16")
    head.cast("bfloat16")
    if order == "cast_first":
        trainer = tmx.gluon.Trainer(params, "adam", {"learning_rate": 1e-2})
    before = {n: p.detach().clone() for n, p in params.items()}
    rs = np.random.RandomState(2)
    x = torch.from_numpy(rs.randint(0, V, (B, T)))
    y = torch.from_numpy(rs.randint(0, V, (B, T)).astype(np.float32))
    with tmx.autograd.record():
        loss = head(net(x), y)
    tmx.autograd.backward(loss)
    trainer.step(B)
    for n, p in params.items():
        assert p.dtype == torch.bfloat16, n
        assert not torch.equal(p.detach(), before[n]), n
    state = trainer._updater.states[0]
    assert all(s.dtype == torch.bfloat16 for s in state)


# --- the slice as a whole --------------------------------------------------

@pytest.fixture(scope="module")
def mlm_setup():
    """JAX bert_small + FusedMLMCELoss (built once), tokens, labels and
    the initial parameters rounded to bf16 values (as f32 numpy; the loss
    block's under "loss.").  The JAX generator is seeded: its state
    otherwise depends on the tests run before in this process."""
    jrandom.seed(0)
    net = jtr.bert_small(**KW)
    net.initialize()
    head = jtr.FusedMLMCELoss(V, 64)
    head.initialize()
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, V, (B, T)).astype(np.int32)
    labels = rs.randint(0, V, (B, T)).astype(np.float32)
    head(net(nd.array(tokens, dtype="int32")), nd.array(labels))  # shapes
    params = dict(net._collect_params_with_prefix())
    params.update({"loss." + n: p
                   for n, p in head._collect_params_with_prefix().items()})
    init = {n: _bf16_values(p.data().asnumpy()) for n, p in params.items()}
    return net, head, params, init, tokens, labels


def _jax_run(setup, dtype):
    """Two Adam steps of the JAX slice from the bf16-valued weights, cast
    to `dtype`: per-step (hidden, loss, {name: grad}) and the parameters
    after, all as f32 numpy."""
    net, head, params, init, tokens, labels = setup
    net.cast(dtype)
    head.cast(dtype)
    for n, p in params.items():
        p.set_data(nd.array(init[n]))          # exact: bf16 values
    trainer = jgluon.Trainer({**net.collect_params(),
                              **head.collect_params()}, "adam",
                             {"learning_rate": LR})
    steps = []
    for _ in range(STEPS):
        with jag.record():
            h = net(nd.array(tokens, dtype="int32"))
            loss = head(h, nd.array(labels))
            loss.backward()
        steps.append((_np32(h._data), _np32(loss._data),
                      {n: _np32(p.grad()._data) for n, p in params.items()}))
        trainer.step(B)
    return steps, {n: _np32(p.data()._data) for n, p in params.items()}


@pytest.fixture(scope="module")
def jax_f32_run(mlm_setup):
    return _jax_run(mlm_setup, "float32")


@pytest.fixture(scope="module")
def port_bf16_run(mlm_setup):
    """The port's slice on the CPU (the kernels' plain versions): built in
    f32, loaded with the bf16-valued weights, cast to bf16, Adam."""
    init, tokens, labels = mlm_setup[3:]
    net = tmx.models.bert_small(device="cpu", **KW)
    tmx.weights.load_reference_params(
        net, {n: a for n, a in init.items() if not n.startswith("loss.")})
    head = tmx.models.FusedMLMCELoss(V, 64, device="cpu")
    tmx.weights.load_reference_params(
        head, {n[5:]: a for n, a in init.items() if n.startswith("loss.")})
    net.cast("bfloat16")
    head.cast("bfloat16")
    params = dict(net.collect_params())
    params.update({"loss." + n: p for n, p in head.collect_params().items()})
    trainer = tmx.gluon.Trainer(params, "adam", {"learning_rate": LR})
    x, y = torch.from_numpy(tokens), torch.from_numpy(labels)
    steps = []
    for _ in range(STEPS):
        with tmx.autograd.record():
            h = net(x)
            loss = head(h, y)
        tmx.autograd.backward(loss)
        assert h.dtype == torch.bfloat16 and loss.dtype == torch.float32
        steps.append((h.detach().float().numpy(), loss.detach().numpy(),
                      {n: p.grad.float().numpy() for n, p in params.items()}))
        trainer.step(B)
    for p in params.values():
        assert p.dtype == torch.bfloat16
    return steps, {n: p.detach().float().numpy() for n, p in params.items()}


@pytest.mark.parametrize("pallas", [True, False],
                         ids=["pallas_interpret", "default"])
def test_bert_small_bf16_training_matches_jax(mlm_setup, jax_f32_run,
                                              port_bf16_run, monkeypatch,
                                              pallas):
    """bert_small + FusedMLMCELoss cast to bf16, two Adam steps at lr 1e-4:
    hidden states, losses, every gradient of both steps and the
    parameters after them under the bf16 rule, against the JAX package
    run in bf16 with its Pallas kernels in interpret mode (forward and
    dq/dkv backward) and on its default path, and in f32 from the same
    bf16-valued weights.

    Adam's first steps move an element by about lr * sign(g).  Where the
    nonzero f32 gradient of a step lies within the rule's own gradient
    tolerance (bf16 rounding can give it either sign), the direction of
    that step is rounding noise, in the JAX bf16 run as in the port's.
    Such a "free" element is held instead to the port's own step:
    |after - init| <= lr + 1.0040 lr (`_ADAM_T2_BF16`) plus the two
    roundings of the stored bf16 parameter (one ulp at the largest
    magnitude it passes).  Over all free elements, the port's mean |step|
    is held to the JAX bf16 run's within twice Hoeffding's bound for N
    values in [0, r] at confidence 1 - 1e-6, r sqrt(ln(2e6) / 2N) with r
    the largest per-element bound: a step that never lands, or lands
    twice, fails it.  Free elements are at most `_FREE_CAP` of every
    tensor but the attention key bias, whose gradient is zero in exact
    arithmetic (softmax ignores a shift of a row's scores) and so wholly
    rounding noise; each share is printed.  Every other element, and
    every gradient, is held to the rule."""
    calls = []
    orig = jatt._flash_bwd_pallas
    monkeypatch.setattr(jatt, "_flash_bwd_pallas",
                        lambda *a: calls.append(1) or orig(*a))
    if pallas:
        monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("MXNET_FLASH_BWD_PALLAS", "2")
    ref_steps, ref_after = jax_f32_run
    jax_steps, jax_after = _jax_run(mlm_setup, "bfloat16")
    assert len(calls) == (2 * STEPS if pallas else 0)
    steps, after = port_bf16_run
    assert set(steps[0][2]) == set(ref_steps[0][2]) and len(steps[0][2]) == 42
    for i in range(STEPS):
        for what, k in (("hidden", 0), ("loss", 1)):
            _assert_bf16_rule("step %d %s" % (i, what), steps[i][k],
                              jax_steps[i][k], ref_steps[i][k])
        for n in ref_steps[i][2]:
            _assert_bf16_rule("step %d grad %s" % (i, n), steps[i][2][n],
                              jax_steps[i][2][n], ref_steps[i][2][n])
    # where the rule lets a step's gradient take either sign, Adam's step
    # (about lr * sign(g) in its first steps) has no determined direction
    init = mlm_setup[3]
    steps_port, steps_jax, bound_max = [], [], 0.0
    for n in ref_after:
        free = np.zeros(ref_after[n].shape, bool)
        for i in range(STEPS):
            g32 = ref_steps[i][2][n]
            free |= (g32 != 0) & (
                np.abs(g32) <= _bf16_rule_tol(jax_steps[i][2][n], g32))
        print("after %s: free share %.3f" % (n, free.mean()))
        assert free.mean() <= _FREE_CAP or n.endswith("attn.key.bias"), \
            (n, free.mean())
        _assert_bf16_rule("after " + n, after[n], jax_after[n], ref_after[n],
                          free=free)
        passed = np.maximum(np.abs(init[n]), np.abs(after[n])) \
            + _ADAM_T2_BF16 * LR
        bound = (1 + _ADAM_T2_BF16) * LR + _bf16_ulp(passed)
        step = np.abs(after[n] - init[n])
        assert (step <= bound)[free].all(), (n, float((step / bound).max()))
        steps_port.append(step[free])
        steps_jax.append(np.abs(jax_after[n] - init[n])[free])
        bound_max = max(bound_max, float(bound[free].max(initial=0.0)))
    port_mean, jax_mean = (float(np.concatenate(a).mean())
                           for a in (steps_port, steps_jax))
    count = sum(a.size for a in steps_port)
    tol = 2 * bound_max * np.sqrt(np.log(2e6) / (2 * count))
    print("free elements: %d, mean |step| port %.4g, jax %.4g, tol %.3g"
          % (count, port_mean, jax_mean, tol))
    assert abs(port_mean - jax_mean) <= tol
