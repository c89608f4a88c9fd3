"""PyTorch port: the BERT MLM training path against the JAX package.

The fused softmax cross-entropies, Adam, the loss blocks and the whole
slice — `bert_small(dropout=0.0, output_hidden=True)` + `FusedMLMCELoss`
+ `Trainer("adam")` — run on the same numpy inputs in both packages, the
JAX weights carried into the port by `weights.load_reference_params`.
The slice runs once with the JAX package's Pallas attention kernels
forced (interpret mode, forward and dq/dkv backward) and once on its
default CPU path.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon import loss as jloss
from incubator_mxnet_tpu.models import transformer as jtr
from incubator_mxnet_tpu.ops import attention as jatt
from incubator_mxnet_tpu.ops import nn as jnn
from incubator_mxnet_tpu.ops import optimizer as jopt
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.ops import nn as tnn
from incubator_mxnet_tpu_torch.ops import optimizer as topt

pytestmark = pytest.mark.torch_port

V, B, T, LR, STEPS = 100, 2, 32, 1e-4, 2
KW = dict(vocab_size=V, max_length=64, dropout=0.0, output_hidden=True)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("axis", [-1, 1])
def test_fused_softmax_ce_matches_jax(axis):
    rs = np.random.RandomState(1)
    pred = rs.randn(4, 7, 5).astype(np.float32) * 3
    label = rs.randint(0, pred.shape[axis], (4, 5) if axis == 1 else (4, 7))
    label = label.astype(np.float32)
    dy = rs.rand(*label.shape).astype(np.float32)
    ref, vjp = jax.vjp(lambda p: jnn.fused_softmax_ce(
        p, jnp.asarray(label), axis=axis), jnp.asarray(pred))
    (ref_dp,) = vjp(jnp.asarray(dy))
    tp = _t(pred).requires_grad_()
    loss = tnn.fused_softmax_ce(tp, _t(label), axis=axis)
    loss.backward(_t(dy))
    np.testing.assert_allclose(loss.detach().numpy(), _np(ref), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), _np(ref_dp), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("num_chunks", [4, 0])
def test_fused_linear_softmax_ce_matches_jax(num_chunks):
    # values and all three gradients (dh, dW, db) against the JAX op's
    # custom vjp: f32 sums in another order, 2e-5 (test_fusion.py)
    rs = np.random.RandomState(3)
    n, d, v = 24, 16, 37
    h = rs.randn(n, d).astype(np.float32)
    w = (rs.randn(v, d) * 0.1).astype(np.float32)
    b = rs.randn(v).astype(np.float32)
    lab = rs.randint(0, v, n).astype(np.float32)
    dy = rs.rand(n).astype(np.float32)
    ref, vjp = jax.vjp(lambda h, w, b: jnn.fused_linear_softmax_ce(
        h, w, b, jnp.asarray(lab), num_chunks=num_chunks),
        *(jnp.asarray(a) for a in (h, w, b)))
    ref_grads = vjp(jnp.asarray(dy))
    th, tw, tb = (_t(a).requires_grad_() for a in (h, w, b))
    loss = tnn.fused_linear_softmax_ce(th, tw, tb, _t(lab),
                                       num_chunks=num_chunks)
    loss.backward(_t(dy))
    np.testing.assert_allclose(loss.detach().numpy(), _np(ref), rtol=2e-5,
                               atol=2e-5)
    for got, r in zip((th, tw, tb), ref_grads):
        np.testing.assert_allclose(got.grad.numpy(), _np(r), rtol=2e-5,
                                   atol=2e-5)


def test_fused_linear_softmax_ce_chunk_rule():
    w, b = torch.zeros(5, 4), torch.zeros(5)
    with pytest.raises(ValueError, match="not divisible into 3 chunks"):
        tnn.fused_linear_softmax_ce(torch.zeros(10, 4), w, b,
                                    torch.zeros(10), num_chunks=3)
    # 4099 rows (prime) have no chunk size in [256, 2048]: one pass, loudly
    with pytest.warns(UserWarning, match="UNCHUNKED"):
        loss = tnn.fused_linear_softmax_ce(torch.zeros(4099, 4), w, b,
                                           torch.zeros(4099))
    assert torch.allclose(loss, torch.full((4099,), float(np.log(5))))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tnn.fused_linear_softmax_ce(torch.zeros(4096, 4), w, b,
                                    torch.zeros(4096))


@pytest.mark.parametrize("sparse_label,from_logits", [
    (True, False), (True, True), (False, False)],
    ids=["fused", "pick", "dense_label"])
def test_softmax_ce_loss_matches_jax(sparse_label, from_logits):
    rs = np.random.RandomState(4)
    pred = rs.randn(6, 9).astype(np.float32)
    if from_logits:
        pred = pred - np.log(np.exp(pred).sum(-1, keepdims=True))
    label = rs.randint(0, 9, 6).astype(np.float32)
    if not sparse_label:
        label = rs.dirichlet(np.ones(9), 6).astype(np.float32)
    kw = dict(sparse_label=sparse_label, from_logits=from_logits)
    ref = jloss.SoftmaxCrossEntropyLoss(**kw)(nd.array(pred),
                                              nd.array(label)).asnumpy()
    tp = _t(pred).requires_grad_()
    out = tmx.gluon.loss.SoftmaxCrossEntropyLoss(**kw)(tp, _t(label))
    assert out.shape == (6,)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-6)
    if sparse_label and not from_logits:
        # the fused backward against autograd of the unfused composition
        out.sum().backward()
        tq = _t(pred).requires_grad_()
        ref_loss = -torch.log_softmax(tq, -1).gather(
            -1, _t(label).long()[:, None])
        ref_loss.sum().backward()
        torch.testing.assert_close(tp.grad, tq.grad, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("wd,rescale,clip", [(0.0, 1.0, -1.0),
                                             (0.01, 0.5, 0.3)])
def test_adam_update_matches_jax(wd, rescale, clip):
    rs = np.random.RandomState(6)
    w, g, m = (rs.randn(50).astype(np.float32) for _ in range(3))
    var = rs.rand(50).astype(np.float32)
    kw = dict(lr=0.01, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=wd,
              rescale_grad=rescale, clip_gradient=clip)
    ref = jopt.adam_update(*(jnp.asarray(a) for a in (w, g, m, var)), **kw)
    tw, tg, tm, tv = (_t(a) for a in (w, g, m, var))
    topt.adam_update(tw, tg, tm, tv, **kw)          # in place
    assert torch.equal(tg, _t(g))                   # the gradient is kept
    for got, r in zip((tw, tm, tv), ref):
        np.testing.assert_allclose(got.numpy(), _np(r), rtol=1e-6, atol=1e-7)


def test_optimizer_surface():
    opt = tmx.optimizer.create("adam", learning_rate=0.1)
    assert isinstance(opt, tmx.optimizer.Adam)
    assert tmx.optimizer.create(opt) is opt
    with pytest.raises(MXNetError, match="unknown optimizer"):
        tmx.optimizer.create("nosuch")
    w = torch.nn.Parameter(torch.ones(3))
    w.lr_mult = 0.5
    opt.param_dict = {0: w}
    assert opt._get_lr(0) == pytest.approx(0.05)
    upd = tmx.optimizer.get_updater(opt)
    for _ in range(2):
        upd(0, torch.ones(3), w.data)
    upd(1, torch.ones(3), torch.ones(3))
    # each index keeps its own count t, which sets its bias correction
    assert opt._index_update_count == {0: 2, 1: 1} and opt.num_update == 2
    # t = 1: the step is lr * g / (|g| + eps), about lr * sign(g)
    one = torch.ones(3)
    tmx.optimizer.get_updater(tmx.optimizer.create(
        "adam", learning_rate=0.1))(0, torch.full((3,), 2.0), one)
    torch.testing.assert_close(one, torch.full((3,), 0.9))


def test_trainer_rejects_what_is_not_ported():
    """Parameters on different devices are refused, as in the JAX Trainer
    (several contexts are each parameter's copies: test_torch_gluon_multi
    .py); a one-process dist kvstore is one worker that sums nothing."""
    p = torch.nn.Parameter(torch.ones(2))
    q = torch.nn.Parameter(torch.ones(2, device="meta"))
    with pytest.raises(MXNetError, match="same contexts"):
        tmx.gluon.Trainer([p, q], "adam")
    d = torch.nn.Parameter(torch.ones(2))
    dist = tmx.gluon.Trainer([d], "sgd", {"learning_rate": 0.5},
                             kvstore="dist_sync")
    d.grad = torch.ones(2)
    dist.step(1)
    assert dist._kvstore.num_workers == 1
    torch.testing.assert_close(d.detach(), torch.full((2,), 0.5))
    with pytest.raises(MXNetError, match="dict or a list"):
        tmx.gluon.Trainer(p, "adam")
    tr = tmx.gluon.Trainer({"p": p}, "adam", {"learning_rate": 0.1})
    p.grad = torch.full((2,), 4.0)
    tr.step(4)                  # rescale_grad = 1/4
    assert tr.optimizer.rescale_grad == 0.25
    torch.testing.assert_close(p.detach(), torch.full((2,), 0.9))


def test_autograd_scopes_and_vector_head():
    ag = tmx.autograd
    assert not ag.is_recording() and not ag.is_training()
    x = torch.ones(3, requires_grad=True)
    with ag.record():
        assert ag.is_recording() and ag.is_training()
        assert torch.is_grad_enabled()
        with ag.pause():
            assert not ag.is_recording() and not torch.is_grad_enabled()
            z = x * 2
        y = x * torch.arange(3.0)           # a vector head
    assert not ag.is_recording() and torch.is_grad_enabled()
    ag.backward(y)                          # seeded with ones
    torch.testing.assert_close(x.grad, torch.arange(3.0))
    with ag.record():
        y2 = x * 3.0
    ag.backward([y2], [torch.full((3,), 2.0)])  # overwrites, not adds
    torch.testing.assert_close(x.grad, torch.full((3,), 6.0))
    with pytest.raises(MXNetError, match="not computed while recording"):
        ag.backward(z)
    with pytest.raises(MXNetError, match="2 head gradients for 1 heads"):
        ag.backward([y], [torch.ones(3), torch.ones(3)])


def test_backward_overwrites_gradients():
    # grad_req='write': two backwards without a step leave the second's
    # gradient, not the sum
    tmx.random.seed(2)
    net = tmx.models.bert_small(device="cpu", **KW)
    head = tmx.models.FusedMLMCELoss(V, 64, device="cpu")
    params = list(net.parameters()) + list(head.parameters())
    rs = np.random.RandomState(8)
    xs = [torch.from_numpy(rs.randint(0, V, (B, T))) for _ in range(2)]
    y = torch.from_numpy(rs.randint(0, V, (B, T)))

    def grads(x):
        with tmx.autograd.record():
            loss = head(net(x), y)
        tmx.autograd.backward(loss)
        return [p.grad.clone() for p in params]

    first = grads(xs[0])
    second = grads(xs[1])
    for p in params:
        p.grad = None
    alone = grads(xs[1])
    assert all(torch.equal(s, a) for s, a in zip(second, alone))
    assert not all(torch.equal(f, s) for f, s in zip(first, second))


def _assert_grads_close(grads, ref):
    """Every gradient, per tensor: max-abs error over max-abs value, at
    most 1e-4 (f32 sums in another order).  The value is floored at 1e-3
    of the model's largest gradient: attn.key.bias has a gradient of
    exactly 0 in exact arithmetic (softmax ignores a shift of a row's
    scores), so its rounding noise (~1e-9) is held to the model's scale,
    not its own."""
    gmax = max(np.abs(g).max() for g in ref.values())
    for n, r in ref.items():
        err = np.abs(grads[n] - r).max()
        assert err <= 1e-4 * max(np.abs(r).max(), 1e-3 * gmax), (n, err)


def _assert_adam_params_close(after, ref_after, ref_grads):
    """Post-step parameters after len(ref_grads) Adam steps at LR.  Adam's
    first steps move an element by about lr * sign(g): where |g| is
    rounding noise (below 1e-6 of the largest gradient in some step) the
    sign is noise too, and such an element is held only to the
    2 * steps * lr its steps can span.  Every other element is held to
    5e-6, 5 % of lr."""
    for n, r in ref_after.items():
        tiny = np.zeros(r.shape, bool)
        for g in ref_grads:
            big = max(np.abs(x).max() for x in g.values())
            tiny |= np.abs(g[n]) <= 1e-6 * big
        err = np.abs(after[n] - r)
        assert (err[~tiny] <= 5e-6).all(), (n, err[~tiny].max())
        assert (err[tiny] <= 2 * len(ref_grads) * LR).all(), n


def test_fused_mlm_head_matches_dense_head():
    # BERTModel(output_hidden=True) + FusedMLMCELoss against the Dense
    # decoder head + SoftmaxCrossEntropyLoss on the same weights, through
    # one backward and one Adam step (test_fusion.py's dense-head check)
    tmx.random.seed(5)
    kw = dict(vocab_size=64, max_length=16, dropout=0.0, device="cpu")
    dense = tmx.models.bert_small(**kw)
    fused = tmx.models.bert_small(output_hidden=True, **kw)
    fused.load_state_dict({k: v for k, v in dense.state_dict().items()
                           if not k.startswith("decoder.")})
    head = tmx.models.FusedMLMCELoss(64, 64, num_chunks=4, device="cpu")
    head.load_state_dict({"weight": dense.decoder.weight.detach().clone(),
                          "bias": dense.decoder.bias.detach().clone()})
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randint(0, 64, (4, 16)))
    y = torch.from_numpy(rs.randint(0, 64, (4, 16)).astype(np.float32))
    # BERTModel registers the decoder last, so both lists align
    runs = []
    for params, loss_of in (
            (list(dense.parameters()),
             lambda: tmx.gluon.loss.SoftmaxCrossEntropyLoss()(
                 dense(x).reshape(64, -1), y.reshape(-1))),
            (list(fused.parameters()) + list(head.parameters()),
             lambda: head(fused(x), y))):
        trainer = tmx.gluon.Trainer(params, "adam", {"learning_rate": LR})
        with tmx.autograd.record():
            loss = loss_of()
        tmx.autograd.backward(loss)
        grads = {i: p.grad.numpy().copy() for i, p in enumerate(params)}
        trainer.step(4)
        runs.append((loss.detach().numpy(), grads,
                     {i: p.detach().numpy() for i, p in enumerate(params)}))
    (ref_loss, ref_grads, ref_after), (loss, grads, after) = runs
    assert loss.shape == ref_loss.shape == (64,)
    np.testing.assert_allclose(loss, ref_loss, rtol=0, atol=2e-5)
    _assert_grads_close(grads, ref_grads)
    _assert_adam_params_close(after, ref_after, [ref_grads])


# --- the slice as a whole -------------------------------------------------

@pytest.fixture(scope="module")
def jax_mlm():
    """JAX bert_small + FusedMLMCELoss, its tokens and labels, and its
    initial parameters as numpy (loss block's under "loss.")."""
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
    init = {n: p.data().asnumpy() for n, p in params.items()}
    return net, head, params, init, tokens, labels


def _jax_train(jax_mlm):
    net, head, params, init, tokens, labels = jax_mlm
    for n, p in params.items():
        p.set_data(nd.array(init[n]))
    trainer = jgluon.Trainer({**net.collect_params(),
                              **head.collect_params()}, "adam",
                             {"learning_rate": LR})
    losses, grads = [], []
    for _ in range(STEPS):
        with jag.record():
            loss = head(net(nd.array(tokens, dtype="int32")),
                        nd.array(labels))
            loss.backward()
        losses.append(loss.asnumpy())
        grads.append({n: p.grad().asnumpy() for n, p in params.items()})
        trainer.step(B)
    return losses, grads, {n: p.data().asnumpy() for n, p in params.items()}


def _port_train(init, tokens, labels):
    net = tmx.models.bert_small(device="cpu", **KW)
    tmx.weights.load_reference_params(
        net, {n: a for n, a in init.items() if not n.startswith("loss.")})
    head = tmx.models.FusedMLMCELoss(V, 64, device="cpu")
    tmx.weights.load_reference_params(
        head, {n[5:]: a for n, a in init.items() if n.startswith("loss.")})
    params = dict(net.collect_params())
    params.update({"loss." + n: p for n, p in head.collect_params().items()})
    trainer = tmx.gluon.Trainer(params, "adam", {"learning_rate": LR})
    x, y = torch.from_numpy(tokens), torch.from_numpy(labels)
    losses, grads = [], []
    for _ in range(STEPS):
        with tmx.autograd.record():
            loss = head(net(x), y)
        tmx.autograd.backward(loss)
        losses.append(loss.detach().numpy())
        grads.append({n: p.grad.numpy().copy() for n, p in params.items()})
        trainer.step(B)
    return losses, grads, {n: p.detach().numpy() for n, p in params.items()}


@pytest.mark.parametrize("pallas", [True, False],
                         ids=["pallas_interpret", "default"])
def test_bert_small_mlm_training_matches_jax(jax_mlm, monkeypatch, pallas):
    calls = []
    orig = jatt._flash_bwd_pallas
    monkeypatch.setattr(jatt, "_flash_bwd_pallas",
                        lambda *a: calls.append(1) or orig(*a))
    if pallas:
        monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("MXNET_FLASH_BWD_PALLAS", "2")
    ref_losses, ref_grads, ref_after = _jax_train(jax_mlm)
    # the JAX backward went through the Pallas dq/dkv kernels exactly
    # when asked: 2 layers x STEPS
    assert len(calls) == (2 * STEPS if pallas else 0)
    losses, grads, after = _port_train(*jax_mlm[3:])
    assert set(grads[0]) == set(ref_grads[0]) and len(grads[0]) == 42
    for step in range(STEPS):
        # per-row losses of ~4.6: f32 sums in another order, 2e-5
        np.testing.assert_allclose(losses[step], ref_losses[step], rtol=0,
                                   atol=2e-5)
        _assert_grads_close(grads[step], ref_grads[step])
    _assert_adam_params_close(after, ref_after, ref_grads)
