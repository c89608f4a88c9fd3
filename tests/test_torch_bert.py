"""PyTorch port: BERT logits against the JAX package on the same weights.

`bert_small` is built and initialized in JAX; its
`_collect_params_with_prefix()` arrays are carried into the port by
`weights.load_reference_params`, and both models score the same tokens:
once with JAX's attention in Pallas interpret mode (the TPU kernel) and
once on its default CPU path.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu.models import transformer as jtr
from incubator_mxnet_tpu.ops import attention as jatt
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError

pytestmark = pytest.mark.torch_port

KW = dict(vocab_size=1000, max_length=64, dropout=0.0)


@pytest.fixture(scope="module")
def jax_bert():
    """JAX bert_small, its tokens (2, 32) and its parameters as numpy."""
    net = jtr.bert_small(**KW)
    net.initialize()
    tokens = np.random.RandomState(3).randint(0, 1000, (2, 32)) \
        .astype(np.int32)
    net(jmx.nd.array(tokens, dtype="int32"))    # resolves deferred shapes
    params = {name: p.data().asnumpy()
              for name, p in net._collect_params_with_prefix().items()}
    return net, tokens, params


def _port(params):
    net = tmx.models.bert_small(device="cpu", **KW)
    tmx.weights.load_reference_params(net, params)
    return net.eval()


@pytest.mark.parametrize("pallas", [True, False],
                         ids=["pallas_interpret", "default"])
def test_bert_small_logits_match_jax(jax_bert, monkeypatch, pallas):
    jnet, tokens, params = jax_bert
    calls = []
    orig = jatt._flash_fwd
    monkeypatch.setattr(jatt, "_flash_fwd",
                        lambda *a: calls.append(1) or orig(*a))
    if pallas:
        monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")
    ref = jnet(jmx.nd.array(tokens, dtype="int32")).asnumpy()
    # the JAX forward went through the Pallas kernel exactly when asked
    assert (len(calls) == 2) if pallas else not calls
    net = _port(params)
    with torch.inference_mode():
        out = net(torch.from_numpy(tokens))
    assert out.shape == (2, 32, 1000)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_port_parameter_names_match_jax(jax_bert):
    _, _, params = jax_bert
    net = tmx.models.bert_small(device="cpu", **KW)
    got = {n: tuple(p.shape) for n, p in net.collect_params().items()}
    assert got == {n: a.shape for n, a in params.items()}
    assert "encoder.layers.1.attn.query.weight" in got


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_reference_params_rejects_mismatch(jax_bert, fault):
    _, _, params = jax_bert
    params = dict(params)
    if fault == "missing":
        params.pop("encoder.layers.0.ffn.ffn1.bias")
    elif fault == "extra":
        params["encoder.layers.0.attn.extra"] = np.zeros(3, np.float32)
    else:
        params["mlm_ln.gamma"] = np.ones(65, np.float32)
    net = tmx.models.bert_small(device="cpu", **KW)
    before = {n: p.detach().clone() for n, p in net.collect_params().items()}
    with pytest.raises(MXNetError):
        tmx.weights.load_reference_params(net, params)
    # nothing was written before the mismatch was found
    assert all(torch.equal(before[n], p)
               for n, p in net.collect_params().items())


def test_bert_rejects_sequences_past_max_length():
    net = tmx.models.bert_small(device="cpu", vocab_size=50, max_length=8)
    with pytest.raises(ValueError, match="max_length=8"):
        net(torch.zeros((1, 9), dtype=torch.int32))


def test_masked_attention_matches_jax():
    # the masked (unfused) path of MultiHeadAttention, same weights
    rs = np.random.RandomState(21)
    jatt_blk = jtr.MultiHeadAttention(32, 4)
    jatt_blk.initialize()
    x = rs.randn(2, 16, 32).astype(np.float32)
    mask = np.where(rs.rand(2, 1, 1, 16) < 0.2, -1e9, 0.0) \
        .astype(np.float32)
    jx = jmx.nd.array(x)
    ref = jatt_blk(jx, jmx.nd.array(mask)).asnumpy()
    params = {n: p.data().asnumpy()
              for n, p in jatt_blk._collect_params_with_prefix().items()}
    blk = tmx.models.MultiHeadAttention(32, 4, device="cpu")
    tmx.weights.load_reference_params(blk, params)
    with torch.inference_mode():
        out = blk.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (tmx.models.bert_small, tmx.context.current_device,
                  tmx.gpu):
        with pytest.raises(MXNetError, match="device='cpu'"):
            build()


def test_same_seed_same_weights():
    tmx.random.seed(5)
    a = tmx.models.bert_small(device="cpu", vocab_size=50)
    tmx.random.seed(5)
    b = tmx.models.bert_small(device="cpu", vocab_size=50)
    for (n, p), q in zip(a.collect_params().items(),
                         b.collect_params().values()):
        assert torch.equal(p, q), n
    w = a.word_embed.weight.detach()
    assert float(w.abs().max()) <= 0.07 and float(w.std()) > 0.03
    assert torch.equal(a.ln.gamma, torch.ones(64))
    assert torch.equal(a.encoder.layers[0].attn.query.bias, torch.zeros(64))


def test_block_helpers():
    net = tmx.models.bert_small(device="cpu", vocab_size=50, dropout=0.0)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with torch.inference_mode():
        before = net.eval()(toks)
    net.hybridize(static_alloc=True, static_shape=True, remat=True)
    names = list(net.collect_params("encoder.layers.0.ln"))
    assert names == ["encoder.layers.0.ln1.gamma", "encoder.layers.0.ln1.beta",
                     "encoder.layers.0.ln2.gamma", "encoder.layers.0.ln2.beta"]
    assert net.to_device("cpu") is net
    with torch.inference_mode():              # hybridize stays eager
        assert torch.equal(net(toks), before)


def test_dropout_trains_and_is_identity_in_eval():
    # training mode is autograd's, as in the JAX package: the module's
    # train()/eval() flag decides nothing
    layer = tmx.gluon.nn.Dropout(0.25)
    x = torch.ones((64, 256))
    assert layer.train()(x) is x              # outside record(): identity
    with tmx.autograd.predict_mode():
        assert layer(x) is x
    tmx.random.seed(1)
    with tmx.autograd.record():
        a = layer.eval()(x)
    tmx.random.seed(1)
    with tmx.autograd.train_mode():
        assert torch.equal(layer(x), a)       # drawn from the generator
    kept = a != 0
    assert 0.7 < kept.float().mean().item() < 0.8
    assert torch.allclose(a[kept], torch.full_like(a[kept], 1 / 0.75))


def test_training_mode_follows_autograd_record_as_in_jax():
    # the fault: the port decided training from Module.training (True
    # from construction), so user code outside record() ran dropout
    # where the JAX package runs the identity
    ones = np.ones((4, 8), np.float32)
    jdrop, tdrop = jmx.gluon.nn.Dropout(0.5), tmx.gluon.nn.Dropout(0.5)
    # a bert_small with live dropout, outside record() and without
    # .eval(), against the JAX package's logits on the same weights
    kw = dict(KW, dropout=0.1)
    jmx.random.seed(4)          # the same weights whatever ran before
    jnet = jtr.bert_small(**kw)
    jnet.initialize()
    tokens = np.random.RandomState(4).randint(0, 1000, (2, 32)) \
        .astype(np.int32)
    ref = jnet(jmx.nd.array(tokens, dtype="int32")).asnumpy()
    params = {name: p.data().asnumpy()
              for name, p in jnet._collect_params_with_prefix().items()}
    net = tmx.models.bert_small(device="cpu", **kw)
    tmx.weights.load_reference_params(net, params)
    assert net.training
    with torch.no_grad():
        out = net(torch.from_numpy(tokens)).numpy()
    diffs = dict(
        jax_dropout=float(np.abs(jdrop(jmx.nd.array(ones)).asnumpy()
                                 - ones).max()),
        port_dropout=float((tdrop(torch.from_numpy(ones)) - 1).abs().max()),
        logits=float(np.abs(out - ref).max()))
    # outside record(): dropout is the identity in both packages, and the
    # logits agree to f32 sums in another order through 2 layers
    assert diffs["jax_dropout"] == diffs["port_dropout"] == 0.0, diffs
    assert diffs["logits"] <= 1e-5, diffs
    with jag.record():
        assert not np.array_equal(jdrop(jmx.nd.array(ones)).asnumpy(), ones)
    with tmx.autograd.record():
        assert not torch.equal(tdrop(torch.from_numpy(ones)),
                               torch.ones(4, 8))
