"""PyTorch port: `models.Seq2Seq` and `models.GNMT` against the JAX
package, on the CPU.

Small nets (embed 16, hidden 32, 2 encoder and 2 decoder layers, vocab
23) are built and initialized in JAX from a seed and their
`_collect_params_with_prefix()` arrays carried into the port unchanged
(`weights.load_reference_params`; the LSTMs' flat vectors under their
JAX key `parameters`).  Both packages run the same numpy inputs: the
forward with and without `src_valid_len`, two Adam steps of
`GNMT(output_hidden=True)` + `FusedMLMCELoss` against the JAX Trainer,
the cached decode (`init_cache` through `RNN_varlen`, `decode_step`),
and `GenerationEngine` over `Seq2Seq` against the JAX engine's tokens.
The port's hybridized training run is held to its eager one bit for
bit.  Torch runs on one thread.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import autograd as jag
from incubator_mxnet_tpu import gluon as jgluon
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.gluon.block import nameless_scope
from incubator_mxnet_tpu.models import seq2seq as js
from incubator_mxnet_tpu.models import transformer as jtr
from incubator_mxnet_tpu.serving import GenerationEngine as JaxEngine
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.monitor import events
from incubator_mxnet_tpu_torch.serving import GenerationEngine

pytestmark = pytest.mark.torch_port

V, E, H, B, TS, TT = 23, 16, 32, 3, 7, 6
VALID = np.array([TS, 4, 2], np.int32)
# f32 through 2 + 2 LSTM layers and an attention, sums in another order
TOL = 2e-5
LR, STEPS = 1e-3, 2
BOS, EOS, SLOTS, MAX_LEN, BUCKETS, NEW = 1, 2, 3, 16, (4, 8), 10
GNMT_KW = dict(embed_dim=E, hidden=H, enc_layers=2, dec_layers=2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nd(a):
    return nd.array(a, dtype="int32" if a.dtype == np.int32 else None)


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, V, (B, TS)).astype(np.int32),
            rs.randint(0, V, (B, TT)).astype(np.int32),
            rs.randint(0, V, (B, TT)).astype(np.float32))


def _arrays(block):
    return {n: p.data().asnumpy()
            for n, p in block._collect_params_with_prefix().items()}


def _close(got, ref, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got.astype(np.float64) - ref).max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.fixture(scope="module")
def jax_nets():
    """JAX Seq2Seq and GNMT (with and without the vocab projection) and
    a FusedMLMCELoss, seeded and shaped by one forward."""
    src, tgt, lab = _inputs()
    with nameless_scope():
        jmx.random.seed(0)
        s2s = js.Seq2Seq(V, V, embed_dim=E, hidden=H, num_layers=2)
        gnmt = js.GNMT(V, V, **GNMT_KW)
        # a third encoder layer: the residual add
        gnmt3 = js.GNMT(V, V, **dict(GNMT_KW, enc_layers=3))
        hid = js.GNMT(V, V, output_hidden=True, **GNMT_KW)
        head = jtr.FusedMLMCELoss(V, H)
        # Seq2Seq at the default Uniform(0.07) decodes every prompt to
        # the same tokens; at this scale they depend on the prompt
        s2s.initialize(jmx.init.Normal(0.5))
        for net in (gnmt, gnmt3, hid, head):
            net.initialize()
        for net in (s2s, gnmt, gnmt3, hid):
            net(_nd(src), _nd(tgt))
        head(hid(_nd(src), _nd(tgt)), nd.array(lab))
    return dict(s2s=s2s, gnmt=gnmt, gnmt3=gnmt3, hid=hid, head=head)


def _port(kind, params, **kw):
    if kind == "s2s":
        net = tmx.models.Seq2Seq(V, V, embed_dim=E, hidden=H, num_layers=2,
                                 device="cpu")
    else:
        net = tmx.models.GNMT(V, V, device="cpu", **dict(
            GNMT_KW, enc_layers=3 if kind == "gnmt3" else 2, **kw))
    return tmx.weights.load_reference_params(net, params)


# -- forward -----------------------------------------------------------------

@pytest.mark.parametrize("kind", ["s2s", "gnmt3"])
def test_keys_are_the_jax_structural_keys_and_cast_reaches_them(jax_nets,
                                                                kind):
    """`collect_params()` keys (the flat vectors' `enc_uni0.parameters`
    among them) equal the JAX `_collect_params_with_prefix()` keys, and
    torch's `parameters()` and `cast` reach every one."""
    jkeys = sorted(jax_nets[kind]._collect_params_with_prefix())
    net = _port(kind, _arrays(jax_nets[kind]))
    assert sorted(net.collect_params()) == jkeys
    assert len(list(net.parameters())) == len(jkeys)
    net.cast("bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    if kind == "gnmt3":
        assert "enc_uni1.parameters" in jkeys


@pytest.mark.parametrize("case", ["s2s", "gnmt", "gnmt_src_valid_len",
                                  "gnmt3_src_valid_len"])
def test_forward_matches_jax(jax_nets, case):
    src, tgt, _ = _inputs()
    kind = case.split("_")[0]
    jnet = jax_nets[kind]
    valid = case.endswith("valid_len")
    ref = jnet(_nd(src), _nd(tgt), *([nd.array(VALID)] if valid else []))
    net = _port(kind, _arrays(jnet))
    with torch.no_grad():
        out = net(_t(src), _t(tgt), *([_t(VALID)] if valid else []))
    assert out.shape == (B, TT, V)
    _close(out, ref.asnumpy(), case)


# -- training ----------------------------------------------------------------

def _jax_train(nets, init):
    hid, head = nets["hid"], nets["head"]
    params = dict(hid._collect_params_with_prefix())
    params.update({"loss." + n: p for n, p in
                   head._collect_params_with_prefix().items()})
    for n, p in params.items():
        p.set_data(nd.array(init[n]))
    trainer = jgluon.Trainer({**hid.collect_params(),
                              **head.collect_params()}, "adam",
                             {"learning_rate": LR})
    src, tgt, lab = _inputs()
    losses, grads = [], []
    for _ in range(STEPS):
        with jag.record():
            loss = head(hid(_nd(src), _nd(tgt)), nd.array(lab))
            loss.backward()
        losses.append(loss.asnumpy())
        grads.append({n: p.grad().asnumpy() for n, p in params.items()})
        trainer.step(B)
    return losses, grads, {n: p.data().asnumpy() for n, p in params.items()}


def _port_train(init, hybrid=False, steps=STEPS):
    net = _port("gnmt", {n: a for n, a in init.items()
                         if not n.startswith("loss.")}, output_hidden=True)
    head = tmx.models.FusedMLMCELoss(V, H, device="cpu")
    tmx.weights.load_reference_params(
        head, {n[5:]: a for n, a in init.items() if n.startswith("loss.")})
    if hybrid:
        net.hybridize(static_alloc=True, static_shape=True)
        head.hybridize()
    params = dict(net.collect_params())
    params.update({"loss." + n: p for n, p in head.collect_params().items()})
    trainer = tmx.gluon.Trainer(params, "adam", {"learning_rate": LR})
    src, tgt, lab = (_t(a) for a in _inputs())
    losses, grads = [], []
    for _ in range(steps):
        with tmx.autograd.record():
            loss = head(net(src, tgt), lab)
        tmx.autograd.backward(loss)
        losses.append(loss.detach().numpy().copy())
        grads.append({n: p.grad.numpy().copy() for n, p in params.items()})
        trainer.step(B)
    after = {n: p.detach().numpy().copy() for n, p in params.items()}
    return losses, grads, after, (net, trainer)


@pytest.fixture(scope="module")
def train_init(jax_nets):
    init = _arrays(jax_nets["hid"])
    init.update({"loss." + n: a
                 for n, a in _arrays(jax_nets["head"]).items()})
    return init


def test_gnmt_adam_steps_match_jax_trainer(jax_nets, train_init):
    ref_losses, ref_grads, ref_after = _jax_train(jax_nets, train_init)
    losses, grads, after, _ = _port_train(train_init)
    assert set(grads[0]) == set(ref_grads[0])
    assert "enc_bi.parameters" in grads[0] and len(grads[0]) == 8
    for step in range(STEPS):
        _close(losses[step], ref_losses[step], "loss %d" % step)
        for n, r in ref_grads[step].items():
            _close(grads[step][n], r, "grad %s, step %d" % (n, step))
    for n, r in ref_after.items():
        _close(after[n], r, "parameter %s" % n)


def test_hybridized_gnmt_training_is_the_eager_run_bit_for_bit(train_init):
    eager = _port_train(train_init, steps=3)
    hyb = _port_train(train_init, hybrid=True, steps=3)
    for a, b in zip(eager[0], hyb[0]):
        assert np.array_equal(a, b)
    for n, a in eager[2].items():
        assert np.array_equal(a, hyb[2][n]), n
    net, trainer = hyb[3]
    graph = net._cached_graph
    # step 1 eager, step 2 captures the forward and backward, step 3
    # replays them; the Trainer captured its update
    assert graph.eager_calls == 1 and graph.captures == 2
    assert graph.replays >= 2 and trainer.captures == 1


# -- cached decode -----------------------------------------------------------

def test_init_cache_and_decode_steps_match_jax(jax_nets):
    jnet = jax_nets["s2s"]
    net = _port("s2s", _arrays(jnet))
    src = _inputs()[0]
    jc = jnet.init_cache(_nd(src), _nd(VALID), mem_len=TS + 3)
    with torch.no_grad():
        tc = net.init_cache(_t(src), _t(VALID), mem_len=TS + 3)
    assert sorted(tc) == sorted(jc) == ["c", "enc_k", "h", "src_len"]
    assert tc["enc_k"].shape == (B, TS + 3, H) and tc["h"].shape == (B, 2, H)
    for k in jc:
        _close(tc[k], jc[k].asnumpy(), "cache " + k)
    tok = np.array([BOS] * B, np.int32)
    for i in range(3):
        jl, jc = jnet.decode_step(_nd(tok), _nd(tok * 0 + i), jc)
        with torch.no_grad():
            tl, tc = net.decode_step(_t(tok), _t(tok * 0 + i), tc)
        _close(tl, jl.asnumpy(), "logits, step %d" % i)
        tok = jl.asnumpy().argmax(-1).astype(np.int32)


# -- GenerationEngine over Seq2Seq -------------------------------------------

PROMPTS = {"off_bucket": 3, "on_bucket": 8}


def _prompt(n, seed=7):
    return np.random.RandomState(seed + n).randint(3, V, (n,)).astype(
        np.int32)


def _trim(tokens):
    toks = [int(t) for t in tokens]
    return toks[:toks.index(EOS) + 1] if EOS in toks else toks


@torch.no_grad()
def _eager_greedy(net, prompt, steps, feed=None):
    """The port's eager greedy loop for one request: tokens and each
    step's top-2 gap (fed `feed` instead of its own argmax if given)."""
    cache = net.init_cache(_t(prompt[None]), torch.tensor([prompt.size]),
                           max_len=MAX_LEN, mem_len=max(BUCKETS))
    tok, toks, gaps = torch.tensor([BOS]), [], []
    for i in range(steps):
        logits, cache = net.decode_step(tok, torch.tensor([i]), cache)
        top = logits[0].topk(2).values
        gaps.append(float(top[0] - top[1]))
        toks.append(int(logits[0].argmax()))
        if toks[-1] == EOS:
            break
        nxt = feed[i] if feed is not None and i < len(feed) else toks[-1]
        tok = torch.tensor([nxt])
    return toks, gaps


def _assert_same_tokens(got, ref, net, prompt, what):
    """got == ref, but for a near tie (test_torch_generation.py's rule):
    at the first differing step the reference's top-2 gap is within TOL,
    and the comparison stops there."""
    got, ref = _trim(got), _trim(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        if g != r:
            _, gaps = _eager_greedy(net, prompt, i + 1, feed=ref)
            print("%s: near tie at step %d, top-2 gap %g" % (what, i,
                                                             gaps[i]))
            assert gaps[i] <= TOL, (what, i, got, ref)
            return
    assert got == ref, (what, got, ref)


def test_generation_engine_serves_seq2seq_as_the_jax_engine(jax_nets):
    jnet = jax_nets["s2s"]
    jeng = JaxEngine(jnet, bos=BOS, eos=EOS, slots=SLOTS, max_len=MAX_LEN,
                     prompt_buckets=BUCKETS)
    try:
        jeng.warmup()
        ref = {k: _trim(jeng.submit(_prompt(n), max_new_tokens=NEW)
                        .result(timeout=60)) for k, n in PROMPTS.items()}
    finally:
        jeng.close()
    net = _port("s2s", _arrays(jnet))
    eng = GenerationEngine(net, bos=BOS, eos=EOS, ctx="cpu", slots=SLOTS,
                           max_len=MAX_LEN, prompt_buckets=BUCKETS)
    try:
        t0 = events.get("serve.traces")
        eng.warmup()
        assert events.get("serve.traces") - t0 == len(BUCKETS) + 2
        t1 = events.get("serve.traces")
        streams = {k: eng.submit(_prompt(n), max_new_tokens=NEW)
                   for k, n in PROMPTS.items()}
        got = {k: s.result(timeout=60) for k, s in streams.items()}
        assert events.get("serve.traces") == t1     # none in traffic
    finally:
        eng.close()
    # the prompt steers the tokens, so that a wrong prefill shows
    assert _trim(got["off_bucket"]) != _trim(got["on_bucket"])
    for k, n in PROMPTS.items():
        assert 1 <= got[k].size <= NEW
        _assert_same_tokens(got[k], ref[k], net, _prompt(n), "JAX engine, "
                            + k)
        eager, _ = _eager_greedy(net, _prompt(n), NEW)
        _assert_same_tokens(got[k], eager, net, _prompt(n), "port eager, "
                            + k)
    detail = eng.kv_cache_bytes()
    # enc_k (8, 32) f32, src_len int32, h and c (2, 32) f32, plus the
    # engine's own tok, pos and out rows
    assert detail["per_slot"] == 4 * (8 * H + 1 + 2 * 2 * H) + 4 * (
        2 + MAX_LEN)


def test_registry_admits_seq2seq_with_the_jax_kv_term(jax_nets):
    """`project_generation_footprint` reads Seq2Seq's leaves from a meta
    run of `init_cache` (`RNN_varlen` on meta tensors): the per-slot KV
    bytes equal the JAX package's, and `ModelRegistry.register_generator`
    admits it with that term."""
    from incubator_mxnet_tpu.serving.generation import \
        project_generation_footprint as jax_footprint
    from incubator_mxnet_tpu_torch.serving import (
        ModelRegistry, project_generation_footprint)
    jnet = jax_nets["s2s"]
    net = _port("s2s", _arrays(jnet))
    _, jdetail = jax_footprint(jnet, slots=SLOTS, max_len=MAX_LEN,
                               buckets=BUCKETS)
    _, detail = project_generation_footprint(net, SLOTS, MAX_LEN, BUCKETS)
    # enc_k (8, H) and h, c (2, H) f32, src_len one int32
    assert detail["kv_bytes_per_slot"] == jdetail["kv_bytes_per_slot"] \
        == 4 * (8 * H + 2 * 2 * H + 1)
    reg = ModelRegistry(devices=["cpu"], hbm_budget=1 << 30)
    try:
        rec = reg.register_generator("s2s", net, BOS, EOS, slots=SLOTS,
                                     max_len=MAX_LEN, prompt_buckets=BUCKETS)
        assert rec["detail"]["kv_bytes"] == SLOTS * detail[
            "kv_bytes_per_slot"]
    finally:
        reg.close()


def test_entry_points_need_cuda_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        tmx.models.gnmt_large(output_hidden=True)
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        tmx.models.Seq2Seq(V, V)
    net = tmx.models.Seq2Seq(V, V, embed_dim=E, hidden=H, device="cpu")
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        GenerationEngine(net, bos=BOS, eos=EOS)


def test_gnmt_parity_check_fails_a_planted_gate_order(monkeypatch,
                                                      train_init):
    """chip_smoke.py's train_gnmt parity (`_spread_parity` held by
    `_spread_checks`) at this size, the CPU standing in for the card: the
    port's step against a copy of itself passes, and the same step with
    the LSTM's input and forget gates swapped fails."""
    import chip_smoke
    from incubator_mxnet_tpu_torch.ops import rnn as tops
    data = [_t(a) for a in _inputs()]

    def build():
        net = _port("gnmt", {n: a for n, a in train_init.items()
                             if not n.startswith("loss.")},
                    output_hidden=True)
        head = tmx.models.FusedMLMCELoss(V, H, device="cpu")
        tmx.weights.load_reference_params(
            head, {n[5:]: a for n, a in train_init.items()
                   if n.startswith("loss.")})
        return net, head

    _, ref = chip_smoke.gnmt_grads(tmx, *build(), *data)
    _, same = chip_smoke.gnmt_grads(tmx, *build(), *data)
    net, head = build()
    chip_smoke.nudge_weights(torch, (net, head), chip_smoke.GNMT_NUDGE)
    _, spread = chip_smoke.gnmt_grads(tmx, net, head, *data)
    chip_smoke._spread_checks("gnmt", chip_smoke._spread_parity(
        torch, same, ref, spread))
    cell = tops._lstm_cell

    def swapped(gates, c):
        h = c.shape[-1]
        return cell(torch.cat([gates[:, h:2 * h], gates[:, :h],
                               gates[:, 2 * h:]], dim=-1), c)
    monkeypatch.setattr(tops, "_lstm_cell", swapped)
    _, planted = chip_smoke.gnmt_grads(tmx, *build(), *data)
    monkeypatch.undo()
    parity = chip_smoke._spread_parity(torch, planted, ref, spread)
    with pytest.raises(RuntimeError, match="spread"):
        chip_smoke._spread_checks("gnmt", parity)
