"""PyTorch port: the Transformer NMT slice against the JAX package.

`transformer_nmt_small` is built and initialized in JAX; its
`_collect_params_with_prefix()` arrays are carried into the port by
`weights.load_reference_params`, and both packages run the same numpy
inputs: teacher-forced logits with and without a source mask, two Adam
steps of `output_hidden` + `FusedMLMCELoss` (the JAX side once on its
default CPU path and once on its Pallas kernels in interpret mode), and
the cached decode step.  The port's own contracts (causality, source
padding invariance, the max-length guard, the causal block's refusals)
are held as the JAX package's tests hold its own.
"""
import warnings

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.models import transformer as jtr
from incubator_mxnet_tpu.ops import attention as jatt
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.models import transformer as ttr
from test_torch_train import _assert_adam_params_close, _assert_grads_close

pytestmark = pytest.mark.torch_port

V, B, TS, TT, LR, STEPS = 40, 2, 9, 8, 1e-4, 2
VALID = np.array([TS, 5], np.float32)       # two source lengths
# f32 logits of size ~1 through 2 + 2 layers, sums in another order
LOGIT_TOL = 2e-5


def _nd(a):
    return nd.array(a, dtype="int32" if a.dtype == np.int32 else None)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    src = rs.randint(0, V, (B, TS)).astype(np.int32)
    tgt = rs.randint(0, V, (B, TT)).astype(np.int32)
    labels = rs.randint(0, V, (B, TT)).astype(np.float32)
    return src, tgt, labels


def _jax_net(**kw):
    """A JAX transformer_nmt_small, its shapes resolved, seeded so that
    every worker builds the same one; with its parameters as numpy."""
    jmx.random.seed(0)
    net = jtr.transformer_nmt_small(V, V, dropout=0.0, **kw)
    net.initialize()
    src, tgt, _ = _inputs()
    net(_nd(src), _nd(tgt))
    return net, {n: p.data().asnumpy()
                 for n, p in net._collect_params_with_prefix().items()}


@pytest.fixture(scope="module")
def jax_nmt():
    return _jax_net()


def _port(params, **kw):
    net = tmx.models.transformer_nmt_small(V, V, dropout=0.0, device="cpu",
                                           **kw)
    return tmx.weights.load_reference_params(net, params)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked",
                                                        "src_valid_length"])
def test_transformer_nmt_small_logits_match_jax(jax_nmt, masked):
    jnet, params = jax_nmt
    src, tgt, _ = _inputs()
    kw = dict(src_valid_length=nd.array(VALID)) if masked else {}
    ref = jnet(_nd(src), _nd(tgt), **kw).asnumpy()
    net = _port(params)
    with torch.inference_mode():
        out = net(_t(src), _t(tgt),
                  **(dict(src_valid_length=_t(VALID)) if masked else {}))
    assert out.shape == (B, TT, V)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=LOGIT_TOL)


def test_port_parameter_names_match_jax(jax_nmt):
    _, params = jax_nmt
    net = tmx.models.transformer_nmt_small(V, V, device="cpu")
    got = {n: tuple(p.shape) for n, p in net.collect_params().items()}
    assert got == {n: a.shape for n, a in params.items()}
    assert len(got) == 93       # 91 and the vocab projection's two
    assert "decoder.layers.0.cross_attn.key.bias" in got
    assert "dec_ln.gamma" in got
    # the base geometry: 16 tensors per encoder layer, 26 per decoder
    # layer, 3 embeddings and 2 LayerNorms
    base = tmx.models.transformer_nmt_base(32000, 32000, output_hidden=True,
                                           dropout=0.0, device="cpu")
    assert len(base.collect_params()) == 6 * 16 + 6 * 26 + 7
    assert sum(p.numel() for p in base.parameters()) == 77_432_832


def test_decoder_is_causal():
    # changing a later target token leaves every earlier position's
    # logits as they were (test_models.py's causality check)
    tmx.random.seed(7)
    net = tmx.models.transformer_nmt_small(50, 60, dropout=0.0,
                                           device="cpu")
    rs = np.random.RandomState(7)
    src = _t(rs.randint(0, 50, (2, 9)))
    tgt = rs.randint(0, 60, (2, 8))
    tgt2 = tgt.copy()
    tgt2[:, 5] = (tgt2[:, 5] + 7) % 60
    with torch.inference_mode():
        out1, out2 = (net(src, _t(t)).numpy() for t in (tgt, tgt2))
    assert out1.shape == (2, 8, 60)
    np.testing.assert_allclose(out1[:, :5], out2[:, :5], rtol=1e-5,
                               atol=1e-5)
    assert np.abs(out1[:, 5:] - out2[:, 5:]).max() > 1e-4


def test_source_padding_is_invisible_with_valid_length():
    # the same sentence padded to two lengths gives the same logits when
    # src_valid_length masks the pads, and different ones without it
    tmx.random.seed(9)
    net = tmx.models.transformer_nmt_small(30, 30, dropout=0.0,
                                           device="cpu")
    rs = np.random.RandomState(9)
    sent = rs.randint(2, 30, (1, 5))
    tgt = _t(rs.randint(2, 30, (1, 6)))

    def run(pad_to, masked):
        src = np.zeros((1, pad_to), np.int64)
        src[:, :5] = sent
        kw = dict(src_valid_length=torch.tensor([5.0])) if masked else {}
        with torch.inference_mode():
            return net(_t(src), tgt, **kw).numpy()

    np.testing.assert_allclose(run(8, True), run(12, True), rtol=1e-4,
                               atol=1e-4)
    assert np.abs(run(8, False) - run(12, False)).max() > 1e-4


def test_max_length_guard():
    net = tmx.models.transformer_nmt_small(20, 20, max_length=16,
                                           dropout=0.0, device="cpu")
    with pytest.raises(ValueError, match="max_length"):
        net(torch.zeros((1, 32), dtype=torch.long),
            torch.zeros((1, 8), dtype=torch.long))
    with pytest.raises(ValueError, match="max_length"):
        net(torch.zeros((1, 8), dtype=torch.long),
            torch.zeros((1, 17), dtype=torch.long))


def test_causal_self_attention_refuses_mask_and_warns_on_dropout():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        att = ttr._CausalSelfAttention(16, 2, device="cpu")
    x = torch.zeros((1, 4, 16))
    with pytest.raises(ValueError, match="mask= is not supported"):
        att(x, mask=torch.zeros((1, 1, 1, 4)))
    with pytest.warns(UserWarning, match="not applied on the fused causal"):
        att = ttr._CausalSelfAttention(16, 2, dropout=0.5, device="cpu")
    # and it is not applied, even while training: the output is the
    # flash path's, with no dropout mask drawn
    x = torch.randn(1, 4, 16, generator=torch.Generator().manual_seed(0))
    with tmx.autograd.record():
        got = att(x)
    ref = att.proj(tmx.ops.attention._contrib_flash_attention(
        att.query(x), att.key(x), att.value(x), num_heads=2, causal=True))
    assert torch.equal(got, ref)


# --- two Adam steps against the JAX Trainer --------------------------------

@pytest.fixture(scope="module")
def jax_nmt_train():
    """JAX transformer_nmt_small(output_hidden) + FusedMLMCELoss, the
    inputs, and the initial parameters as numpy (loss block's under
    "loss.")."""
    net, _ = _jax_net(output_hidden=True)
    head = jtr.FusedMLMCELoss(V, 64)
    head.initialize()
    src, tgt, labels = _inputs()
    head(net(_nd(src), _nd(tgt)), nd.array(labels))     # shapes
    params = dict(net._collect_params_with_prefix())
    params.update({"loss." + n: p
                   for n, p in head._collect_params_with_prefix().items()})
    init = {n: p.data().asnumpy() for n, p in params.items()}
    return net, head, params, init


def _jax_train(jax_nmt_train):
    net, head, params, init = jax_nmt_train
    for n, p in params.items():
        p.set_data(nd.array(init[n]))
    trainer = jgluon.Trainer({**net.collect_params(),
                              **head.collect_params()}, "adam",
                             {"learning_rate": LR})
    src, tgt, labels = _inputs()
    losses, grads = [], []
    for _ in range(STEPS):
        with jag.record():
            loss = head(net(_nd(src), _nd(tgt)), nd.array(labels))
            loss.backward()
        losses.append(loss.asnumpy())
        grads.append({n: p.grad().asnumpy() for n, p in params.items()})
        trainer.step(B)
    return losses, grads, {n: p.data().asnumpy() for n, p in params.items()}


def _port_train(init):
    net = _port({n: a for n, a in init.items() if not n.startswith("loss.")},
                output_hidden=True)
    head = tmx.models.FusedMLMCELoss(V, 64, device="cpu")
    tmx.weights.load_reference_params(
        head, {n[5:]: a for n, a in init.items() if n.startswith("loss.")})
    params = dict(net.collect_params())
    params.update({"loss." + n: p for n, p in head.collect_params().items()})
    trainer = tmx.gluon.Trainer(params, "adam", {"learning_rate": LR})
    src, tgt, labels = (_t(a) for a in _inputs())
    losses, grads = [], []
    for _ in range(STEPS):
        with tmx.autograd.record():
            loss = head(net(src, tgt), labels)
        tmx.autograd.backward(loss)
        losses.append(loss.detach().numpy())
        grads.append({n: p.grad.numpy().copy() for n, p in params.items()})
        trainer.step(B)
    return losses, grads, {n: p.detach().numpy() for n, p in params.items()}


@pytest.mark.parametrize("pallas", [True, False],
                         ids=["pallas_interpret", "default"])
def test_transformer_nmt_small_training_matches_jax(jax_nmt_train,
                                                    monkeypatch, pallas):
    fwd, bwd = [], []
    orig_fwd, orig_bwd = jatt._flash_fwd, jatt._flash_bwd_pallas
    # the last argument of each is `causal`
    monkeypatch.setattr(jatt, "_flash_fwd",
                        lambda *a: fwd.append(a[-1]) or orig_fwd(*a))
    monkeypatch.setattr(jatt, "_flash_bwd_pallas",
                        lambda *a: bwd.append(a[-1]) or orig_bwd(*a))
    if pallas:
        monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("MXNET_FLASH_BWD_PALLAS", "2")
    ref_losses, ref_grads, ref_after = _jax_train(jax_nmt_train)
    # per step, the JAX side ran its Pallas forward and dq/dkv kernels in
    # each of the 2 encoder layers and, causal, each of the 2 decoder
    # layers, exactly when asked
    want = [False, False, True, True] * STEPS if pallas else []
    assert fwd == want and sorted(bwd) == sorted(want)
    losses, grads, after = _port_train(jax_nmt_train[3])
    assert set(grads[0]) == set(ref_grads[0]) and len(grads[0]) == 93
    for step in range(STEPS):
        # per-row losses of ~3.7: f32 sums in another order, 2e-5
        np.testing.assert_allclose(losses[step], ref_losses[step], rtol=0,
                                   atol=2e-5)
        _assert_grads_close(grads[step], ref_grads[step])
    _assert_adam_params_close(after, ref_after, ref_grads)


# --- the cached decode step ------------------------------------------------

MAX_LEN, MEM_LEN, DECODE_STEPS = 6, 12, 4


def test_decode_steps_match_jax(jax_nmt):
    # init_cache with the memory padded from 9 to 12 rows and sources of
    # lengths 9 and 5, then 4 teacher-fed decode steps: logits and the
    # cache against the JAX package's
    jnet, params = jax_nmt
    net = _port(params)
    src, tgt, _ = _inputs()
    jcache = jnet.init_cache(_nd(src), nd.array(VALID), max_len=MAX_LEN,
                             mem_len=MEM_LEN)
    with torch.inference_mode():
        cache = net.init_cache(_t(src), _t(VALID), max_len=MAX_LEN,
                               mem_len=MEM_LEN)
        assert set(cache) == set(jcache)
        for name, ref in jcache.items():
            np.testing.assert_allclose(cache[name].numpy(), ref.asnumpy(),
                                       rtol=0, atol=LOGIT_TOL)
        for i in range(DECODE_STEPS):
            pos = np.full(B, i, np.int32)
            ref, jcache = jnet.decode_step(_nd(tgt[:, i]), _nd(pos), jcache)
            out, cache = net.decode_step(_t(tgt[:, i]), _t(pos), cache)
            assert out.shape == (B, V)
            np.testing.assert_allclose(out.numpy(), ref.asnumpy(), rtol=0,
                                       atol=LOGIT_TOL)
        for name, ref in jcache.items():
            np.testing.assert_allclose(cache[name].numpy(), ref.asnumpy(),
                                       rtol=0, atol=LOGIT_TOL)


def test_decode_steps_match_teacher_forced_forward(jax_nmt):
    # in the port alone: step i's logits are the teacher-forced forward's
    # at position i, over the same prefix and source mask; rows of one
    # batch at different positions decode as they would alone
    net = _port(jax_nmt[1])
    src, tgt, _ = _inputs()
    with torch.inference_mode():
        ref = net(_t(src), _t(tgt), src_valid_length=_t(VALID))
        cache = net.init_cache(_t(src), _t(VALID), max_len=TT,
                               mem_len=MEM_LEN)
        for i in range(TT):
            out, cache = net.decode_step(_t(tgt[:, i]),
                                         torch.full((B,), i), cache)
            np.testing.assert_allclose(out.numpy(), ref[:, i].numpy(),
                                       rtol=0, atol=LOGIT_TOL)
        # row 1 alone, one step behind row 0 in a shared cache
        cache = net.init_cache(_t(src), _t(VALID), max_len=TT)
        _, cache = net.decode_step(_t(tgt[:, 0]), torch.tensor([0, 0]),
                                   cache)
        out, _ = net.decode_step(torch.tensor([tgt[0, 1], tgt[1, 0]]),
                                 torch.tensor([1, 0]), cache)
    np.testing.assert_allclose(out[1].numpy(), ref[1, 0].numpy(), rtol=0,
                               atol=LOGIT_TOL)


def test_decode_step_needs_the_vocab_projection():
    net = tmx.models.transformer_nmt_small(V, V, output_hidden=True,
                                           dropout=0.0, device="cpu")
    src = torch.zeros((1, 4), dtype=torch.long)
    cache = net.init_cache(src, torch.tensor([4.0]), max_len=4)
    assert cache["k0"].shape == (1, 4, 64)
    assert cache["mem_k1"].shape == (1, 4, 64)
    with pytest.raises(ValueError, match="vocab projection"):
        net.decode_step(torch.zeros(1, dtype=torch.long),
                        torch.zeros(1, dtype=torch.long), cache)
