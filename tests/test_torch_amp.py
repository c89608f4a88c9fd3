"""PyTorch port: contrib.amp against the JAX package.

The cases of tests/python/unittest/test_amp.py on the port (init and
turn_off, the LossScaler's back-off and growth, scale_loss zeroing
overflowed gradients, convert_hybrid_block keeping the norm parameters
f32, normalize_dtype, convert_model's params-only form), and two runs
held against the JAX package on the same numpy weights: a two-Dense net
trained under amp.init("bfloat16") with SGD, and a float16 net with
multi_precision SGD behind a dynamic loss scaler.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon.block import nameless_scope
from incubator_mxnet_tpu.contrib import amp as jamp
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.contrib import amp
from incubator_mxnet_tpu_torch.ops import nn as tnn
from test_torch_bf16 import _bf16_ulp

pytestmark = pytest.mark.torch_port

B, STEPS = 16, 3


@pytest.fixture(scope="module", autouse=True)
def _own_jax_block_names():
    """The JAX blocks built here take their auto-names from counters of
    their own: the JAX package's tests that share this process read
    parameters in the order of the names their counters give."""
    with nameless_scope():
        yield


@pytest.fixture(autouse=True)
def _amp_off():
    yield
    amp.turn_off()
    jamp.turn_off()


def test_amp_init_casts_target_ops():
    """After init(), FullyConnected (and a Dense layer) and both of the
    port's Convolution functions compute in bf16 on f32 inputs; softmax
    comes back f32; turn_off restores them all."""
    amp.init("bfloat16")
    assert amp.current_target() == "bfloat16"
    x = torch.rand(4, 8)
    w = torch.rand(16, 8)
    out = tnn.fully_connected(x, w, None, num_hidden=16, no_bias=True)
    assert out.dtype == torch.bfloat16
    dense = tmx.gluon.nn.Dense(16, in_units=8, device="cpu")
    assert dense(x).dtype == torch.bfloat16
    assert tnn.softmax(out).dtype == torch.float32     # FP32 op casts up
    assert tnn.log_softmax(out).dtype == torch.float32
    xc, wc = torch.rand(2, 4, 3, 3), torch.rand(8, 4, 1, 1)
    assert tnn.convolution(xc, wc, kernel=(1, 1)).dtype == torch.bfloat16
    assert all(t.dtype == dt for t, dt in zip(
        tnn.conv1x1_bn_stats(xc, wc), (torch.bfloat16, torch.float32,
                                       torch.float32)))
    assert tnn.conv1x1_bn_stats(xc.half(), wc)[0].dtype == torch.float16
    amp.turn_off()
    assert amp.current_target() is None
    assert tnn.fully_connected(x, w, None, num_hidden=16,
                               no_bias=True).dtype == torch.float32
    assert dense(x).dtype == torch.float32
    assert tnn.softmax(out).dtype == torch.bfloat16
    assert tnn.conv1x1_bn_stats(xc, wc)[0].dtype == torch.float32


def test_amp_init_twice_and_retarget():
    amp.init("bfloat16")
    amp.init("bfloat16")            # no-op, not a double wrap
    x, w = torch.rand(2, 8), torch.rand(3, 8)
    assert tnn.fully_connected(x, w, no_bias=True).dtype == torch.bfloat16
    amp.init("float16")
    assert amp.current_target() == "float16"
    assert tnn.fully_connected(x, w, no_bias=True).dtype == torch.float16
    amp.turn_off()
    assert tnn.fully_connected(x, w, no_bias=True).dtype == torch.float32


def test_amp_dynamic_loss_scaler_backoff():
    """fp16-style dynamic scaling: the scale halves on overflow (not
    below 1) and grows after the window of clean steps."""
    sc = amp.LossScaler(init_scale=1024.0, scale_factor=2.0, scale_window=2)
    sc.update(overflow=True)
    assert sc.loss_scale == 512.0
    sc.update(False)
    sc.update(False)
    assert sc.loss_scale == 1024.0
    low = amp.LossScaler(init_scale=1.0)
    low.update(True)
    assert low.loss_scale == 1.0


def test_amp_scale_loss_overflow_zeroes_grads():
    tmx.random.seed(0)
    net = tmx.gluon.nn.Dense(2, in_units=3, device="cpu")
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.0})
    amp.init_trainer(trainer, amp.LossScaler(init_scale=4.0))
    x = torch.full((2, 3), 1e38)        # overflows once scaled
    y = torch.ones(2)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with tmx.autograd.record():
        loss = loss_fn(net(x), y)
        with amp.scale_loss(loss, trainer) as scaled:
            tmx.autograd.backward(scaled)
    assert bool((net.weight.grad == 0).all()), net.weight.grad
    assert trainer._amp_loss_scaler.loss_scale == 2.0   # backed off
    assert trainer._scale == 1.0 / 4.0     # the step unscales by 4
    trainer.step(2)
    assert bool(torch.isfinite(net.weight).all())


def test_amp_unscale_divides_gradients():
    net = tmx.gluon.nn.Dense(2, in_units=3, device="cpu")
    trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1, "rescale_grad": 0.5})
    amp.init_trainer(trainer, amp.LossScaler(init_scale=8.0))
    with tmx.autograd.record():
        out = net(torch.ones(1, 3)).sum()
        with amp.scale_loss(out, trainer) as scaled:
            tmx.autograd.backward(scaled)
    assert trainer._scale == 0.5 / 8.0
    g = net.bias.grad.clone()
    amp.unscale(trainer)
    torch.testing.assert_close(net.bias.grad, g / 8.0)
    torch.testing.assert_close(net.bias.grad, torch.ones(2))
    assert trainer._scale == 0.5


def test_amp_convert_hybrid_block_keeps_norm_params_f32():
    net = tmx.gluon.nn.HybridSequential()
    net.add(tmx.gluon.nn.Conv2D(4, 1, in_channels=3, device="cpu"),
            tmx.gluon.nn.BatchNorm(in_channels=4, device="cpu"),
            tmx.gluon.nn.Flatten(),
            tmx.gluon.nn.Dense(5, in_units=4 * 6 * 6, device="cpu"),
            tmx.gluon.nn.LayerNorm(in_channels=5, device="cpu"))
    kept = {n: p for n, p in net.collect_params().items()}
    assert amp.convert_hybrid_block(net) is net
    dtypes = {n: p.dtype for n, p in net.collect_params().items()}
    assert dtypes == {
        "0.weight": torch.bfloat16, "0.bias": torch.bfloat16,
        "1.gamma": torch.float32, "1.beta": torch.float32,
        "1.running_mean": torch.float32, "1.running_var": torch.float32,
        "3.weight": torch.bfloat16, "3.bias": torch.bfloat16,
        "4.gamma": torch.float32, "4.beta": torch.float32}
    assert all(p is kept[n] for n, p in net.collect_params().items())


def test_amp_normalize_dtype_aliases():
    for s in ("bf16", "BF16", "bfloat16", " bfloat16 "):
        assert amp.normalize_dtype(s) == "bfloat16"
    for s in ("fp16", "half", "float16"):
        assert amp.normalize_dtype(s) == "float16"
    for s in (None, False, 0, "", "0", "off", "None", "float32", "fp32"):
        assert amp.normalize_dtype(s) is None
    with pytest.raises(ValueError, match="unsupported AMP dtype"):
        amp.normalize_dtype("int8")


def test_amp_convert_model_keeps_norm_stats_f32():
    args = {"fc_weight": torch.ones(4, 4), "bn_gamma": torch.ones(4)}
    aux = {"bn_moving_mean": torch.zeros(4)}
    sym, new_args, new_aux = amp.convert_model(None, args, aux,
                                               target_dtype="bfloat16")
    assert sym is None
    assert new_args["fc_weight"].dtype == torch.bfloat16
    assert new_args["bn_gamma"].dtype == torch.float32
    assert new_aux["bn_moving_mean"].dtype == torch.float32
    with pytest.raises(NotImplementedError, match="not yet ported"):
        amp.convert_model(object(), args, aux)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        amp.convert_symbol(object())


# --- held against the JAX package ------------------------------------------

def _weights(seed, dtype):
    """Numpy f32 weights of the Dense(32) → relu → Dense(4) net on 8
    inputs, rounded to `dtype`'s values, by structural name."""
    rs = np.random.RandomState(seed)
    w = {"0.weight": rs.randn(32, 8) * 0.3, "0.bias": rs.randn(32) * 0.1,
         "2.weight": rs.randn(4, 32) * 0.3, "2.bias": rs.randn(4) * 0.1}
    return {n: np.asarray(jnp.asarray(a, jnp.float32).astype(dtype)
                          .astype(jnp.float32)) for n, a in w.items()}


def _data(seed, dtype):
    rs = np.random.RandomState(seed)
    x = np.asarray(jnp.asarray(rs.randn(B, 8), jnp.float32).astype(dtype)
                   .astype(jnp.float32))
    return x, rs.randint(0, 4, B).astype(np.float32)


def _jax_net(init):
    net = jgluon.nn.HybridSequential()
    net.add(jgluon.nn.Dense(32, in_units=8), jgluon.nn.Activation("relu"),
            jgluon.nn.Dense(4, in_units=32))
    net.initialize()
    params = net._collect_params_with_prefix()
    for n, p in params.items():
        p.set_data(nd.array(init[n]))
    return net, params


def _port_net(init):
    nn = tmx.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(32, in_units=8, device="cpu"), nn.Activation("relu"),
            nn.Dense(4, in_units=32, device="cpu"))
    tmx.weights.load_reference_params(net, init)
    return net, net.collect_params()


def _jax_train(init, x, y, steps, opt, amp_dtype=None, cast=None,
               scaler=None, x_dtype="float32"):
    """The JAX net trained `steps` times with SGD `opt`: under
    amp.init(amp_dtype) + convert_hybrid_block, or cast to `cast`, with
    `scaler` behind scale_loss; returns its parameters (f32 numpy), its
    losses, and the trainer."""
    if amp_dtype:
        jamp.init(amp_dtype)
    net, params = _jax_net(init)
    if amp_dtype:
        jamp.convert_hybrid_block(net, amp_dtype)
    if cast:
        net.cast(cast)
    trainer = jgluon.Trainer(net.collect_params(), "sgd", dict(opt))
    if amp_dtype or scaler is not None:
        jamp.init_trainer(trainer, scaler)
    loss_fn = jgluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    xa = nd.array(x, dtype=x_dtype)
    for _ in range(steps):
        with jag.record():
            loss = loss_fn(net(xa), nd.array(y))
            if amp_dtype or scaler is not None:
                with jamp.scale_loss(loss, trainer) as scaled:
                    scaled.backward()
            else:
                loss.backward()
        trainer.step(B)
        losses.append(np.asarray(loss._data.astype(jnp.float32)))
    jamp.turn_off()
    return ({n: np.asarray(p.data()._data.astype(jnp.float32))
             for n, p in params.items()}, losses, trainer)


def _port_train(init, x, y, steps, opt, amp_dtype=None, cast=None,
                scaler=None, x_dtype=torch.float32):
    if amp_dtype:
        amp.init(amp_dtype)
    net, params = _port_net(init)
    if amp_dtype:
        amp.convert_hybrid_block(net, amp_dtype)
    if cast:
        net.cast(cast)
    trainer = tmx.gluon.Trainer(params, "sgd", dict(opt))
    if amp_dtype or scaler is not None:
        amp.init_trainer(trainer, scaler)
    loss_fn = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    xt, yt = torch.from_numpy(np.array(x)).to(x_dtype), torch.from_numpy(y)
    for _ in range(steps):
        with tmx.autograd.record():
            loss = loss_fn(net(xt), yt)
            with amp.scale_loss(loss, trainer) as scaled:
                tmx.autograd.backward(scaled)
        trainer.step(B)
        losses.append(loss.detach().float().numpy())
    amp.turn_off()
    return ({n: p.detach().float().numpy() for n, p in params.items()},
            losses, trainer)


def _assert_rule(name, port, jax_low, jax_f32, floor):
    """The port's low-precision result within twice the JAX
    low-precision run's largest distance to the JAX f32 run (same
    low-precision-valued weights and inputs), plus `floor` of each
    element; the direct port-to-JAX distance is printed."""
    jax_dist = np.abs(jax_low - jax_f32).max()
    err = np.abs(port - jax_f32)
    print("%s: port vs jax-f32 %.3g, jax vs jax-f32 %.3g, port vs jax %.3g"
          % (name, err.max(), jax_dist, np.abs(port - jax_low).max()))
    assert (err <= 2.0 * jax_dist + floor).all(), name


def test_amp_bf16_training_matches_jax():
    """amp.init("bfloat16") + convert_hybrid_block + init_trainer +
    scale_loss on Dense(32) → relu → Dense(4) with SGD (lr 0.1), 3 steps
    in both packages from the same bf16-valued weights: losses and final
    parameters held by the bf16 rule (twice the JAX amp run's distance to
    its f32 run, plus one bf16 ulp of each element)."""
    init, (x, y) = _weights(0, jnp.bfloat16), _data(1, jnp.bfloat16)
    opt = {"learning_rate": 0.1}
    ref, ref_losses, _ = _jax_train(init, x, y, STEPS, opt)
    jax_p, jax_losses, _ = _jax_train(init, x, y, STEPS, opt,
                                      amp_dtype="bfloat16")
    got, losses, trainer = _port_train(init, x, y, STEPS, opt,
                                       amp_dtype="bfloat16")
    assert trainer._amp_loss_scaler.loss_scale == 1.0
    for i in range(STEPS):
        _assert_rule("loss %d" % i, losses[i], jax_losses[i], ref_losses[i],
                     _bf16_ulp(ref_losses[i]))
    for n in ref:
        _assert_rule(n, got[n], jax_p[n], ref[n], _bf16_ulp(ref[n]))
    assert amp.current_target() is None


def test_amp_float16_multi_precision_matches_jax():
    """A float16 net (Block.cast) with multi_precision SGD (lr 0.1) behind
    a dynamic loss scaler, 3 steps in both packages from the same
    f16-valued weights and inputs.  The scale starts at 2**20, which
    overflows float16 in the first backward in both packages: that step
    is skipped (zeroed gradients), the scale backs off to 2**12, and after
    the two clean steps of its window it grows back to 2**20.  The f32
    master weights are held by the rule of the bf16 tests in f32: twice
    the JAX mp run's distance to a JAX f32 run of the two clean steps,
    plus 2**-20 of each tensor's scale; the f16 weights are the master
    weights rounded."""
    init, (x, y) = _weights(2, jnp.float16), _data(3, jnp.float16)
    opt = {"learning_rate": 0.1, "multi_precision": True}

    def scaler(mod):
        return mod.LossScaler(init_scale=2.0 ** 20, scale_factor=2.0 ** 8,
                              scale_window=2)

    ref, _, _ = _jax_train(init, x, y, STEPS - 1, {"learning_rate": 0.1})
    _, _, jtrainer = _jax_train(init, x, y, STEPS, opt, cast="float16",
                                scaler=scaler(jamp), x_dtype="float16")
    got, _, trainer = _port_train(init, x, y, STEPS, opt, cast="float16",
                                  scaler=scaler(amp), x_dtype=torch.float16)
    assert trainer._amp_loss_scaler.loss_scale == \
        jtrainer._amp_loss_scaler.loss_scale == 2.0 ** 20
    jnames = list(_jax_net(init)[1])
    jmaster = {n: np.asarray(jtrainer._updaters[0].states[i][1]._data)
               for i, n in enumerate(jnames)}
    params = list(trainer._params)
    for i, n in enumerate(jnames):
        inner, w32 = trainer._updater.states[i]
        assert inner is None and w32.dtype == torch.float32
        assert params[i].dtype == torch.float16
        assert torch.equal(params[i].detach(), w32.half())
        _assert_rule("master " + n, w32.numpy(), jmaster[n], ref[n],
                     2.0 ** -20 * np.abs(ref[n]).max())
