"""PyTorch port: the optimizers against the JAX package's.

Every one of the JAX registry's optimizers (AdaGrad, AdaDelta, RMSProp
plain and centered, Ftrl, Signum with and without momentum, SignSGD,
LAMB with and without bias correction and bounds, Adamax, Nadam, SGLD,
Test, next to SGD and NAG) is run for 5 updates of 3 tensors from
numpy inputs made from a seed, with `rescale_grad`, weight decay, an
`lr_mult`/`wd_mult` per index and, in variants, `clip_gradient` and an
`lr_scheduler`.  Before each update both sides hold the same values; the
port's update is held to the JAX optimizer's `update`: f32 within 2e-6 of
each tensor's largest |value|, bf16 weights and states within one bf16
ulp (module notes at `_tolerance`).  Each optimizer also trains a small
MLP through `gluon.Trainer` for 5 steps, eager and hybridized (bit for
bit; 1 eager update, 1 capture, then replays under a FactorScheduler),
against the JAX Trainer.  SGLD, whose noise is the port's generator and
not JAX's threefry stream, is held by its moments.

Every test runs torch on one thread, as test_torch_hybridize.py does.
"""
import math
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import lr_scheduler as jsched
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu import optimizer as jopt
from incubator_mxnet_tpu import random as jrandom
from incubator_mxnet_tpu.gluon.block import nameless_scope
from incubator_mxnet_tpu.ndarray.ndarray import NDArray
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

pytestmark = pytest.mark.torch_port

STEPS = 5
SHAPES = ((6, 5), (11,), (3, 2, 4))
BASE = dict(wd=1e-3, rescale_grad=0.5)
# optimizer name, its own keyword arguments
CASES = {
    "adagrad": ("adagrad", dict(learning_rate=0.1)),
    "adagrad_clip": ("adagrad", dict(learning_rate=0.1, clip_gradient=0.3)),
    "adadelta": ("adadelta", {}),
    "adadelta_clip": ("adadelta", dict(rho=0.8, clip_gradient=0.3)),
    "rmsprop": ("rmsprop", dict(learning_rate=0.01)),
    "rmsprop_centered": ("rmsprop", dict(learning_rate=0.01, centered=True,
                                         gamma1=0.95, clip_weights=0.9)),
    "rmsprop_clip_weights": ("rmsprop", dict(clip_weights=0.5,
                                             clip_gradient=0.3)),
    "ftrl": ("ftrl", dict(lamda1=0.05)),
    "signum": ("signum", dict(learning_rate=0.01, wd_lh=0.01)),
    "signum_no_momentum": ("signum", dict(learning_rate=0.01, momentum=0.0,
                                          wd_lh=0.01)),
    "signsgd": ("signsgd", dict(learning_rate=0.01, clip_gradient=0.3)),
    "lamb": ("lamb", dict(learning_rate=0.01)),
    "lamb_no_bias_correction": ("lamb", dict(learning_rate=0.01,
                                             bias_correction=False)),
    "lamb_bounds": ("lamb", dict(learning_rate=0.01, lower_bound=2.5,
                                 upper_bound=3.0, clip_gradient=0.3)),
    "adamax": ("adamax", {}),
    "adamax_clip": ("adamax", dict(clip_gradient=0.3)),
    "nadam": ("nadam", dict(learning_rate=0.01)),
    "nadam_clip": ("nadam", dict(learning_rate=0.01, clip_gradient=0.3)),
    "test": ("test", dict(learning_rate=0.05)),
    "sgd": ("sgd", dict(learning_rate=0.05, momentum=0.9)),
    "nag": ("nag", dict(learning_rate=0.05, momentum=0.9)),
}
# Adam is held in test_torch_bf16.py, whose f32 guard keeps the arithmetic
# it had: its 1 - beta2 in double (0.001) is 1.3e-5 away from XLA's
# 1 - f32(0.999), which a zero initial var shows in full
SCHEDULED = ("adagrad", "rmsprop", "lamb", "nadam", "adamax", "signum")
_BF16_ULP_BITS = 7


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _own_jax_block_names():
    with nameless_scope():
        yield


def _bf16_ulp(x):
    e = np.floor(np.log2(np.maximum(np.abs(x), np.float32(2.0 ** -126))))
    return np.float32(2.0) ** (e - _BF16_ULP_BITS)


def _tolerance(ref, dtype):
    """f32: 2e-6 of the tensor's largest |value|: both sides compute in
    f32, but torch and XLA order and fuse the arithmetic differently and
    take some constants in double where XLA has them in f32.  bf16: one
    bf16 ulp of each element: both compute in f32 and round once into the
    buffer, and the f32 results' last-bit differences tip that rounding
    now and then."""
    if dtype == torch.bfloat16:
        return _bf16_ulp(ref)
    return 2e-6 * max(np.abs(ref).max(), 1e-30)


def _inputs(dtype, seed=0):
    """Initial weights and per-step gradients, as f32 numpy arrays holding
    `dtype`'s values."""
    rs = np.random.RandomState(seed)

    def cast(a):
        return torch.from_numpy(a.astype(np.float32)).to(dtype) \
            .float().numpy()
    ws = [cast(rs.randn(*s)) for s in SHAPES]
    gs = [[cast(rs.randn(*s)) for s in SHAPES] for _ in range(STEPS)]
    return ws, gs


def _kwargs(case, sched):
    name, own = CASES[case]
    kw = dict(BASE, **own)
    if sched is not None:
        kw["lr_scheduler"] = sched.FactorScheduler(step=2, factor=0.5)
    return name, kw


def _optimizers(case, scheduled):
    name, kw = _kwargs(case, tmx.lr_scheduler if scheduled else None)
    port = tmx.optimizer.create(name, **kw)
    jname, jkw = _kwargs(case, jsched if scheduled else None)
    jax = jopt.create(jname, **jkw)
    for o in (port, jax):
        o.set_lr_mult({0: 0.5})
        o.set_wd_mult({2: 0.0})
    return port, jax


def _jnd(a, dtype):
    x = jnp.asarray(a)
    return NDArray(x.astype(jnp.bfloat16) if dtype == torch.bfloat16 else x)


def _flat(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [t for s in state for t in _flat(s)]
    return [state]


def _np(x):
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _sync(jax_state, port_state, dtype):
    """Give the JAX state the port state's values."""
    for j, p in zip(_flat(jax_state), _flat(port_state)):
        j._data = _jnd(_np(p), dtype)._data


def _assert_close(got, want, dtype, what):
    err = np.abs(got - want)
    tol = _tolerance(want, dtype)
    assert (err <= tol).all(), (what, float((err / tol).max()))


# the JAX classes that update with jnp arithmetic in the weight's dtype
# (not through an update op with f32 hyper arrays): in bf16 they round
# after every operation, where the port computes in f32 and rounds once
# (F2), so in bf16 they are held to the JAX update of f32 copies of the
# same bf16 values, rounded once
JNP_CLASSES = ("adadelta", "adamax", "nadam", "test")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case,scheduled", [(c, False) for c in sorted(
    CASES)] + [(c, True) for c in sorted(CASES) if c in SCHEDULED])
def test_update_matches_jax(case, scheduled, dtype):
    port, jax = _optimizers(case, scheduled)
    ws, gs = _inputs(dtype)
    pw = [torch.from_numpy(w).to(dtype) for w in ws]
    jdt = torch.float32 if CASES[case][0] in JNP_CLASSES else dtype
    jw = [_jnd(w, jdt) for w in ws]
    ps = [port.create_state(i, w) for i, w in enumerate(pw)]
    js = [jax.create_state(i, w) for i, w in enumerate(jw)]
    assert [len(_flat(s)) for s in ps] == [len(_flat(s)) for s in js]
    for step in range(STEPS):
        for i in range(len(SHAPES)):
            jw[i]._data = _jnd(_np(pw[i]), jdt)._data
            _sync(js[i], ps[i], jdt)
            g = torch.from_numpy(gs[step][i]).to(dtype)
            jax.update(i, jw[i], _jnd(gs[step][i], jdt), js[i])
            port.update(i, pw[i], g, ps[i])
            assert pw[i].dtype == dtype
            what = (case, step, i)
            _assert_close(_np(pw[i]), _np(jw[i]), dtype, what + ("w",))
            for k, (a, b) in enumerate(zip(_flat(ps[i]), _flat(js[i]))):
                assert a.dtype == dtype
                _assert_close(_np(a), _np(b), dtype, what + ("state", k))
    assert port._index_update_count == jax._index_update_count
    assert port.num_update == jax.num_update
    if CASES[case][0] == "nadam":
        assert port.m_schedule == jax.m_schedule


def test_every_jax_optimizer_name_creates():
    names = set(jopt.optimizer._OPT_REGISTRY)
    assert names == set(tmx.optimizer.optimizer._OPT_REGISTRY)
    assert len(names) == 14
    for name in sorted(names):
        o = tmx.optimizer.create(name)
        assert type(o).__name__.lower() == name
        assert o._device_one is not None, name
        ref = jopt.create(name)
        for attr in ("lr", "wd", "rescale_grad", "clip_gradient",
                     "momentum", "beta1", "beta2", "epsilon", "gamma1",
                     "gamma2", "centered", "clip_weights", "rho", "lamda1",
                     "beta", "wd_lh", "lower_bound", "upper_bound",
                     "bias_correction", "schedule_decay",
                     "float_stable_eps", "m_schedule"):
            assert getattr(o, attr, None) == getattr(ref, attr, None), \
                (name, attr)
    with pytest.raises(MXNetError, match="unknown optimizer"):
        tmx.optimizer.create("adamw_not_here")


@pytest.mark.parametrize("name,want", [
    ("rmsprop", 1), ("signum", 1), ("lamb", 2), ("adadelta", 2),
    ("ftrl", 2), ("adamax", 2), ("nadam", 2), ("adagrad", 1)])
def test_state_layout_follows_jax(name, want):
    w = torch.zeros(3)
    state = tmx.optimizer.create(name).create_state(0, w)
    assert len(_flat(state)) == want
    assert len(_flat(tmx.optimizer.create(
        "rmsprop", centered=True).create_state(0, w))) == 3
    assert tmx.optimizer.create("signum", momentum=0.0).create_state(
        0, w) is None
    assert tmx.optimizer.create("signsgd").create_state(0, w) is None
    assert tmx.optimizer.create("sgld").create_state(0, w) is None


def test_nadam_schedule_follows_index_order():
    """`m_schedule` is one product on the optimizer, multiplied once per
    index update: with 3 parameters each index of a step sees another
    value, in update order, as the JAX class gives it."""
    port, jax = _optimizers("nadam", False)
    seen = []
    for step in range(3):
        for i in (2, 0, 1):
            _, _, ex = port._hypers([i])
            jax._update_count(i)
            t = jax._index_update_count[i]
            mt = jax.beta1 * (1.0 - 0.5 * 0.96 ** (t * jax.schedule_decay))
            mt1 = jax.beta1 * (1.0 - 0.5 * 0.96 ** ((t + 1)
                                                     * jax.schedule_decay))
            jax.m_schedule *= mt
            want = (1.0 - mt, mt1, 1.0 - jax.m_schedule,
                    1.0 - jax.m_schedule * mt1, 1.0 - jax.beta2 ** t)
            assert ex == [want]
            seen.append(port.m_schedule)
    assert len(set(seen)) == 9
    assert port.m_schedule == jax.m_schedule


def test_lamb_norm_is_the_jax_norm_in_bf16():
    """r1 and r2 as `jnp.linalg.norm` gives them for bf16 on the CPU:
    f32 squares and sum, the sum rounded to bf16, its root rounded."""
    rs = np.random.RandomState(3)
    for n in (7, 300, 4097):
        for scale in (0.01, 1.0, 30.0):
            a = torch.from_numpy(
                (rs.randn(n) * scale).astype(np.float32)).bfloat16()
            got = tmx.ops.optimizer.lamb_norm(a)
            want = jnp.linalg.norm(jnp.asarray(a.float().numpy())
                                   .astype(jnp.bfloat16))
            assert got.dtype == torch.bfloat16
            assert got.float().item() == float(want)


def test_lamb_phase1_rounds_g_prime_to_the_gradient_dtype():
    w = torch.randn(40, 3).bfloat16()
    g = torch.randn(40, 3)
    m, v = torch.zeros_like(w), torch.zeros_like(w)
    one = torch.tensor(0.0)
    gp = tmx.ops.optimizer.lamb_update_phase1_(
        w, g, m, v, one, torch.tensor(1.0), bias1=torch.tensor(0.1),
        bias2=torch.tensor(0.001))
    assert gp.dtype == torch.float32 and m.dtype == torch.bfloat16
    gp = tmx.ops.optimizer.lamb_update_phase1_(
        w, g.bfloat16(), m, v, one, torch.tensor(1.0))
    assert gp.dtype == torch.bfloat16
    assert gp.untyped_storage().data_ptr() != w.untyped_storage().data_ptr()


def test_adagrad_refuses_a_sparse_gradient():
    """AdaGrad refuses a sparse gradient of a layout that has no update (a
    CSR one); a row_sparse one (torch's COO gradient of an Embedding with
    sparse_grad) takes the lazy update, which leaves the other rows as
    they were (its values against the JAX package:
    test_torch_sparse.py::test_adagrad_takes_a_row_sparse_gradient_as_jax)."""
    o = tmx.optimizer.create("adagrad")
    w = torch.zeros(4, 3)
    csr = torch.sparse_csr_tensor(torch.zeros(5, dtype=torch.long),
                                  torch.zeros(0, dtype=torch.long),
                                  torch.zeros(0), (4, 3))
    with pytest.raises(MXNetError, match="sparse"):
        o.update(0, w, csr, o.create_state(0, w))
    g = torch.zeros(4, 3)
    g[2] = 1.0
    o.update(0, w, g.to_sparse(1), o.create_state(0, w))
    assert bool((w[2] != 0).all()) and bool((w[[0, 1, 3]] == 0).all())


def test_multi_precision_updates_the_master_copy():
    """Adam and LAMB with `multi_precision=True` on float16 weights update
    an f32 master copy, as the JAX package does; within one float16 ulp
    of the JAX weight, the master copy within 2e-6 of scale."""
    ws, gs = _inputs(torch.float32, seed=4)
    for name in ("adam", "lamb", "nadam"):
        port = tmx.optimizer.create(name, multi_precision=True,
                                    learning_rate=0.01, **BASE)
        jax = jopt.create(name, multi_precision=True, learning_rate=0.01,
                          **BASE)
        pw = [torch.from_numpy(w).half() for w in ws]
        jw = [NDArray(jnp.asarray(w).astype(jnp.float16)) for w in ws]
        ps = [port.create_state_multi_precision(i, w)
              for i, w in enumerate(pw)]
        js = [jax.create_state_multi_precision(i, w)
              for i, w in enumerate(jw)]
        for step in range(3):
            for i in range(len(SHAPES)):
                g = gs[step][i]
                port.update_multi_precision(i, pw[i],
                                            torch.from_numpy(g).half(),
                                            ps[i])
                jax.update_multi_precision(
                    i, jw[i], NDArray(jnp.asarray(g).astype(jnp.float16)),
                    js[i])
        for i in range(len(SHAPES)):
            assert pw[i].dtype == torch.float16
            ref = _np(jw[i])
            e = np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -14)))
            assert (np.abs(_np(pw[i]) - ref) <= 2.0 ** (e - 10)).all(), name
            w32, jw32 = ps[i][1], js[i][1]
            assert w32.dtype == torch.float32
            _assert_close(_np(w32), _np(jw32), torch.float32, (name, i))


def test_sgld_noise_moments():
    """SGLD from a zero gradient without wd moves every element by
    N(0, 1) sqrt(lr): over 2**16 elements the mean is within 4 sigma of 0
    and the variance within 4 sigma of lr; a second update draws other
    noise."""
    lr, n = 0.04, 1 << 16
    tmx.random.seed(11)
    o = tmx.optimizer.create("sgld", learning_rate=lr)
    w = torch.zeros(n)
    g = torch.zeros(n)
    o.update(0, w, g, None)
    first = w.clone()
    o.update(0, w, g, None)
    second = w - first
    for d in (first, second):
        d = d.double()
        assert abs(d.mean().item()) <= 4 * math.sqrt(lr / n)
        assert abs(d.var().item() - lr) <= 4 * lr * math.sqrt(2.0 / n)
    assert not torch.equal(first, second)


def test_sgld_drift_matches_jax_without_noise():
    """With the noise set aside (a zero sqrt(lr) extra), SGLD's drift
    -lr / 2 (g rescale + wd w) is the JAX formula's."""
    ws, gs = _inputs(torch.float32, seed=5)
    lr, kw = 0.02, dict(BASE, clip_gradient=0.3)
    w = torch.from_numpy(ws[0]).clone()
    g = torch.from_numpy(gs[0][0])
    tmx.ops.optimizer.sgld_update_(
        w, g, torch.tensor(lr), torch.tensor(kw["wd"]),
        torch.tensor(kw["rescale_grad"]), torch.tensor(0.0),
        tmx.random.generator("cpu"), clip_gradient=kw["clip_gradient"])
    gg = np.clip(gs[0][0] * kw["rescale_grad"] + kw["wd"] * ws[0], -0.3, 0.3)
    want = ws[0] - lr / 2 * gg
    np.testing.assert_allclose(w.numpy(), want, rtol=0, atol=2e-7)


# -- through gluon.Trainer ---------------------------------------------------

B = 4


def _mlp(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=8, activation="relu"),
            nn.LayerNorm(in_channels=16),
            nn.Dense(4, in_units=16))
    return net


def _data():
    rs = np.random.RandomState(7)
    return (rs.randn(B, 8).astype(np.float32),
            rs.randint(0, 4, B).astype(np.float32))


@pytest.fixture(scope="module")
def jax_mlp():
    """The JAX MLP's initial parameters (structural names)."""
    jrandom.seed(0)
    net = _mlp(jgluon.nn)
    net.initialize()
    x, _ = _data()
    net(nd.array(x))
    return {n: p.data().asnumpy()
            for n, p in net._collect_params_with_prefix().items()}


TRAINER = {
    "adagrad": dict(learning_rate=0.1),
    "adadelta": dict(rho=0.9),
    "rmsprop": dict(learning_rate=0.01),
    "rmsprop_centered": dict(learning_rate=0.01, centered=True),
    "ftrl": dict(learning_rate=0.1),
    "signum": dict(learning_rate=0.01),
    "signsgd": dict(learning_rate=0.01),
    "lamb": dict(learning_rate=0.01),
    "adamax": dict(learning_rate=0.01),
    "nadam": dict(learning_rate=0.01),
    "sgld": dict(learning_rate=1e-4),
    "test": dict(learning_rate=0.05),
}


def _trainer_kw(case, sched_mod):
    kw = dict(TRAINER[case], wd=1e-3)
    kw["lr_scheduler"] = sched_mod.FactorScheduler(step=2, factor=0.5)
    return case.split("_")[0], kw


def _port_run(case, init, hybrid, steps=STEPS, seed=0):
    tmx.random.seed(seed)
    net = _mlp(tmx.gluon.nn)
    tmx.weights.load_reference_params(net, init, device="cpu")
    loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    if hybrid:
        net.hybridize(static_alloc=True, static_shape=True)
        loss.hybridize()
    name, kw = _trainer_kw(case, tmx.lr_scheduler)
    params = net.collect_params()
    params["0.weight"].lr_mult = 0.5
    params["1.gamma"].wd_mult = 0.0
    trainer = tmx.gluon.Trainer(params, name, kw)
    x, y = (torch.from_numpy(a) for a in _data())
    out = []
    for _ in range(steps):
        with tmx.autograd.record():
            lv = loss(net(x), y)
        tmx.autograd.backward(lv)
        trainer.step(B)
        out.append(dict(loss=lv.detach().clone(),
                        after={n: p.detach().clone()
                               for n, p in params.items()}))
    return out, trainer


def _jax_run(case, init):
    jrandom.seed(0)
    net = _mlp(jgluon.nn)
    net.initialize()
    x, y = _data()
    net(nd.array(x))
    params = net._collect_params_with_prefix()
    for n, p in params.items():
        p.set_data(nd.array(init[n]))
    params["0.weight"].lr_mult = 0.5
    params["1.gamma"].wd_mult = 0.0
    loss = jgluon.loss.SoftmaxCrossEntropyLoss()
    name, kw = _trainer_kw(case, jsched)
    trainer = jgluon.Trainer(net.collect_params(), name, kw)
    out = []
    for _ in range(STEPS):
        with jag.record():
            lv = loss(net(nd.array(x)), nd.array(y))
            lv.backward()
        trainer.step(B)
        out.append(dict(loss=lv.asnumpy(),
                        after={n: p.data().asnumpy()
                               for n, p in params.items()}))
    return out


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("case", sorted(TRAINER))
def test_trainer_hybridized_equals_eager_and_matches_jax(jax_mlp, case):
    """5 steps under a FactorScheduler: the hybridized Trainer updates
    once eagerly, captures once and then only replays, bit for bit the
    eager Trainer; both within 2e-5 of the JAX Trainer (the forward and
    backward of the two packages differ at f32 rounding; SGLD, whose
    noise is not JAX's, is held to the eager port only)."""
    eager, et = _port_run(case, jax_mlp, hybrid=False)
    hyb, ht = _port_run(case, jax_mlp, hybrid=True)
    for a, b in zip(eager, hyb):
        assert _same_bits(a["loss"], b["loss"])
        for n in a["after"]:
            assert _same_bits(a["after"][n], b["after"][n]), (case, n)
    assert (ht.eager_updates, ht.captures, ht.replays) == (1, 1, STEPS - 2)
    assert (et.captures, et.eager_updates) == (0, STEPS)
    # the scheduler changed the lr during the replays (Test counts no
    # update and reads its lr as set, as the JAX class does)
    lr0 = TRAINER[case].get("learning_rate", 0.01)
    assert ht.optimizer.learning_rate == lr0 if case == "test" \
        else ht.optimizer.learning_rate < lr0
    if case == "sgld":
        return
    ref = _jax_run(case, jax_mlp)
    for step, (g, r) in enumerate(zip(eager, ref)):
        np.testing.assert_allclose(g["loss"].numpy(), r["loss"], rtol=0,
                                   atol=2e-5, err_msg="step %d" % step)
        for n, want in r["after"].items():
            np.testing.assert_allclose(g["after"][n].numpy(), want, rtol=0,
                                       atol=2e-5, err_msg="%s %s step %d"
                                       % (case, n, step))


@pytest.mark.parametrize("case", ["nadam", "lamb", "sgld"])
def test_trainer_save_and_load_states_resume_bit_for_bit(jax_mlp, case,
                                                         tmp_path):
    """Saved after step 2 and loaded into a fresh Trainer over the saved
    parameters, the run resumes bit for bit: Nadam's m_schedule, the
    update counts and the scheduler travel with the optimizer; SGLD's
    generator is reseeded to where it stood."""
    full, _ = _port_run(case, jax_mlp, hybrid=True)
    tmx.random.seed(0)
    net = _mlp(tmx.gluon.nn)
    tmx.weights.load_reference_params(net, jax_mlp, device="cpu")
    net.hybridize()
    loss = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    name, kw = _trainer_kw(case, tmx.lr_scheduler)
    params = net.collect_params()
    params["0.weight"].lr_mult = 0.5
    params["1.gamma"].wd_mult = 0.0
    trainer = tmx.gluon.Trainer(params, name, kw)
    x, y = (torch.from_numpy(a) for a in _data())

    def step(tr):
        with tmx.autograd.record():
            lv = loss(net(x), y)
        tmx.autograd.backward(lv)
        tr.step(B)
        return lv.detach()
    for _ in range(2):
        step(trainer)
    f = str(tmp_path / "opt.states")
    trainer.save_states(f)
    gen_state = tmx.random.generator("cpu").get_state()
    net.save_parameters(str(tmp_path / "net.params"))
    if case == "nadam":
        assert pickle.loads(open(f, "rb").read())[1].m_schedule \
            == trainer.optimizer.m_schedule != 1.0
    net2 = _mlp(tmx.gluon.nn)
    net2.load_parameters(str(tmp_path / "net.params"), ctx="cpu")
    net2.hybridize()
    net = net2
    params = net.collect_params()
    params["0.weight"].lr_mult = 0.5
    params["1.gamma"].wd_mult = 0.0
    resumed = tmx.gluon.Trainer(params, name, dict(kw, lr_scheduler=None))
    resumed.load_states(f)
    tmx.random.generator("cpu").set_state(gen_state)
    assert os.path.getsize(f) > 0
    for k in range(2, STEPS):
        lv = step(resumed)
        assert _same_bits(lv, full[k]["loss"]), (case, k)
    for n, p in params.items():
        assert _same_bits(p.detach(), full[-1]["after"][n]), (case, n)


# -- the registry's functional update ops and the in-place device forms -----
# Eight update ops have two forms in the port: the registry's functional
# one (`nd.rmsprop_update`, ...), which computes in the inputs' dtype with
# the hypers as Python numbers, as the JAX op does, and the in-place form
# that the optimizers capture, which takes tensor hypers, computes in f32
# and rounds once into each buffer.  The first is held to the JAX op, the
# second to the first: in f32 within 4e-6 of each output's largest
# |value| (the in-place forms take 1 - beta as f32(1) - f32(beta), the
# JAX optimizers' arithmetic: for beta2 0.999 that is 1.3e-5 of itself
# from the double 0.001 that the functional forms round, and LAMB's g'
# carries half of it through sqrt(v)), in bf16 within 4 bf16 ulps of it
# (a rounding after every op against one rounding).
def _reg_inputs(n_states, dtype, seed=7):
    rs = np.random.RandomState(seed)
    a = [rs.randn(64, 5).astype(np.float32) for _ in range(2 + n_states)]
    return [torch.from_numpy(x).to(dtype) for x in a]


def _pos(t):
    return t.abs() + 0.1


def _th(x):
    return torch.tensor(x, dtype=torch.float32)


REG_HYPERS = dict(lr=0.01, wd=1e-3, rescale_grad=0.5)
# op: (states, own kwargs, the states made valid, the in-place call)
REG_OPS = {
    "rmsprop_update": (1, dict(gamma1=0.9, epsilon=1e-8, clip_weights=0.9),
                       lambda s: [_pos(s[0])],
                       lambda w, g, s, kw: tmx.ops.optimizer.rmsprop_update_(
                           w, g, s[0], _th(0.01), _th(1e-3), _th(0.5), **kw)),
    "rmspropalex_update": (3, dict(gamma1=0.95, gamma2=0.9, epsilon=1e-8,
                                   clip_weights=0.9),
                           lambda s: [_pos(s[0]) + 3, s[1] * 0.1, s[2]],
                           lambda w, g, s, kw:
                           tmx.ops.optimizer.rmspropalex_update_(
                               w, g, *s, _th(0.01), _th(1e-3), _th(0.5),
                               **kw)),
    "ftrl_update": (2, dict(lamda1=0.05, beta=1.0),
                    lambda s: [s[0], _pos(s[1])],
                    lambda w, g, s, kw: tmx.ops.optimizer.ftrl_update_(
                        w, g, *s, _th(0.01), _th(1e-3), _th(0.5), **kw)),
    "adagrad_update": (1, dict(epsilon=1e-7), lambda s: [_pos(s[0])],
                       lambda w, g, s, kw: tmx.ops.optimizer.adagrad_update_(
                           w, g, s[0], _th(0.01), _th(1e-3), _th(0.5), **kw)),
    "signsgd_update": (0, {}, lambda s: [],
                       lambda w, g, s, kw: tmx.ops.optimizer.signsgd_update_(
                           w, g, _th(0.01), _th(1e-3), _th(0.5))),
    "signum_update": (1, dict(momentum=0.9, wd_lh=0.01), lambda s: s,
                      lambda w, g, s, kw: tmx.ops.optimizer.signum_update_(
                          w, g, s[0], _th(0.01), _th(1e-3), _th(0.5), **kw)),
}


def _lamb1_inplace(w, g, s, kw):
    gp = tmx.ops.optimizer.lamb_update_phase1_(
        w, g, *s, _th(1e-3), _th(0.5), beta1=0.9, beta2=0.999,
        epsilon=1e-6, bias1=_th(1.0 - 0.9 ** 3),
        bias2=_th(1.0 - 0.999 ** 3))
    return gp


def _lamb2_inplace(w, g, s, kw):
    tmx.ops.optimizer.lamb_update_phase2_(w, g, s[0], s[1], _th(0.01),
                                          lower_bound=0.5, upper_bound=30.0)


REG_OPS["lamb_update_phase1"] = (
    2, dict(beta1=0.9, beta2=0.999, epsilon=1e-6, t=3, wd=1e-3,
            rescale_grad=0.5),
    lambda s: [s[0] * 0.1, _pos(s[1]) * 0.01], _lamb1_inplace)
REG_OPS["lamb_update_phase2"] = (
    2, dict(lr=0.01, lower_bound=0.5, upper_bound=30.0),
    lambda s: [s[0][0, 0].abs() * 20, s[1][0, 0].abs() * 10],
    _lamb2_inplace)


def _reg_call(op, dtype):
    """The op's inputs, its port and JAX registry results (weight first,
    then the states), and the in-place form's results on copies."""
    n, own, valid, inplace = REG_OPS[op]
    ins = _reg_inputs(n, dtype)
    w, g, states = ins[0], ins[1], valid(ins[2:])
    kw = own if op.startswith("lamb") else dict(REG_HYPERS, **own)
    port = getattr(tmx.ops.optimizer, op)(w, g, *states, **kw)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jax = getattr(nd, op)(*[NDArray(jnp.asarray(t.float().numpy())
                                    .astype(jdt)) for t in [w, g] + states],
                          **kw)
    port = list(port) if isinstance(port, tuple) else [port]
    jax = list(jax) if isinstance(jax, (tuple, list)) else [jax]
    cw, cs = w.clone(), [s.clone() for s in states]
    gp = inplace(cw, g, cs, own)
    if op == "lamb_update_phase1":
        dev = [gp] + cs
    elif op == "lamb_update_phase2":
        dev = [cw]
    else:
        dev = [cw] + cs
    return port, jax, dev


def _scale_tol(ref, dtype, f32_share, bf16_ulps):
    scale = max(float(np.abs(ref).max()), 1e-30)
    if dtype == torch.bfloat16:
        return bf16_ulps * float(_bf16_ulp(np.float32(scale)))
    return f32_share * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("op", sorted(REG_OPS))
def test_registry_update_op_matches_jax(op, dtype):
    """The registry's functional form against the JAX op in the same
    dtype: f32 within 2e-6 of each output's largest |value|, bf16 within
    two bf16 ulps of it (torch rounds to bf16 after every op; XLA on the
    CPU keeps a fusion's intermediates in f32)."""
    port, jax, _ = _reg_call(op, dtype)
    assert len(port) == len(jax)
    for i, (p, j) in enumerate(zip(port, jax)):
        assert p.dtype == dtype
        want = _np(j)
        err = np.abs(_np(p) - want).max()
        assert err <= _scale_tol(want, dtype, 2e-6, 2), (op, i, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("op", sorted(REG_OPS))
def test_device_form_against_registry_form(op, dtype):
    """The in-place form that the optimizers capture against the
    registry's functional form of the same op: f32 within 4e-6 of each
    output's largest |value|, bf16 within 4 bf16 ulps of it."""
    port, _, dev = _reg_call(op, dtype)
    for i, (p, d) in enumerate(zip(port, dev)):
        want = _np(p)
        err = np.abs(_np(d) - want).max()
        assert err <= _scale_tol(want, dtype, 4e-6, 4), (op, i, err)


def test_lamb_parity_check_fails_planted_updates():
    """chip_smoke.py's LAMB parity check (the card's update held against
    the port's CPU update of bf16 copies), here with both sides on the
    CPU, on bf16 weights shaped as BERT's (a N(0, 0.02) matrix, a zero
    bias and a LayerNorm gamma without weight decay) and gradients of
    N(0, 1e-3): the same update passes with no mismatch; the weights left
    as they were, the update at twice the lr and the step negated each
    fail it."""
    import chip_smoke as cs
    rs = np.random.RandomState(11)
    inits = (rs.randn(96, 64) * 0.02, np.zeros(64), np.ones(64))
    params = [torch.nn.Parameter(torch.from_numpy(
        a.astype(np.float32)).bfloat16()) for a in inits]
    params[1].wd_mult = params[2].wd_mult = 0.0
    grads = [torch.from_numpy((rs.randn(*p.shape) * 1e-3).astype(
        np.float32)).bfloat16() for p in params]
    olds = [p.detach().clone() for p in params]
    lr = cs.LAMB_PARAMS["learning_rate"]
    ref = cs._lamb_updates(tmx, params, olds, grads, lr)

    def check(news):
        return cs._lamb_step_check([cs._lamb_step_counts(torch, o, n, r)
                                    for o, n, r in zip(olds, news, ref)])
    same = cs._lamb_updates(tmx, params, olds, grads, lr)
    got = check(same)
    assert got["ok"] and got["step_mismatch"] == 0, got
    assert got["max_elem_err"] == 0 and 0 < got["moved_share"] < 1, got
    twice = cs._lamb_updates(tmx, params, olds, grads, 2 * lr)
    flip = [2 * o.float() - n.float() for o, n in zip(olds, same)]
    for what, news in (("noop", olds), ("lr_x2", twice), ("flip", flip)):
        bad = check(news)
        assert not bad["ok"], (what, bad)
        assert bad["step_mismatch"] > 20 * cs.LAMB_STEP_MISMATCH, (what, bad)
