"""PyTorch port: the serving tier (`serving.InferenceEngine` over captured
programs, `serving.ModelRegistry`) against the JAX package's, on the CPU.

`bert_small` (2 layers, T 64, vocab 100, dropout 0) is built and
initialized in JAX and its weights are carried into the port
(`weights.load_reference_params`).  On the CPU each bucket's program is
the recorded aten ops of its capture, replayed on the same storage
(`graph_capture`), so a replay that read stale parameters or inputs
would show here as it would on the card.

No test waits on the wall clock: the dispatchers are held
(`_ensure_dispatcher` patched out) and driven by hand through
`_collect`/`_execute`, breakers and replica cooldowns run on a fake
`time.monotonic`, and the retry budget is 0 so that no retry sleeps.
"""
import re

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import config as jcfg
from incubator_mxnet_tpu import fault as jfault
from incubator_mxnet_tpu.gluon.block import nameless_scope
from incubator_mxnet_tpu.models import transformer as jtr
from incubator_mxnet_tpu.monitor import events as jevents
from incubator_mxnet_tpu.serving import engine as jengine_mod
from incubator_mxnet_tpu.serving import registry as jregistry_mod
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import config as tcfg
from incubator_mxnet_tpu_torch import fault as tfault
from incubator_mxnet_tpu_torch.monitor import events as tevents
from incubator_mxnet_tpu_torch.serving import engine as tengine_mod
from incubator_mxnet_tpu_torch.serving import registry as tregistry_mod
from incubator_mxnet_tpu_torch.telemetry import costs as tcosts

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

T, V = 64, 100
KW = dict(vocab_size=V, max_length=T, dropout=0.0)
BUCKETS = (1, 2, 4)
# f32 logits through 2 layers, the same sums in another order
OUT_TOL = 1e-5
# the served v2 against v2's own eager forward: the same ops on the same
# values, so only the bucket's padding rows differ (they do not mix)
SWAP_TOL = 1e-6
NMT_V, BOS, EOS = 23, 1, 2


@pytest.fixture(scope="module")
def jax_bert():
    """JAX bert_small (seeded) and its parameters as numpy."""
    with nameless_scope():
        jmx.random.seed(11)
        net = jtr.bert_small(**KW)
        net.initialize()
        net(jmx.nd.array(np.zeros((1, T), np.int32), dtype="int32"))
    params = {n: p.data().asnumpy()
              for n, p in net._collect_params_with_prefix().items()}
    return net, params


def _port(params):
    net = tmx.models.bert_small(device="cpu", **KW)
    tmx.weights.load_reference_params(net, params)
    return net.eval()


def _tokens(n, seed):
    return np.random.RandomState(seed).randint(0, V, (n, T)) \
        .astype(np.int32)


def _hold(eng):
    """Keep the dispatcher thread from starting: the test drives it."""
    eng._ensure_dispatcher = lambda: None
    return eng


def _drive(eng):
    """Dispatch every queued request on the test thread."""
    while eng._q.qsize() or eng._carry is not None:
        reqs = eng._collect()
        if reqs:
            eng._execute(reqs)


def _jax_engine(net, **kw):
    return jengine_mod.InferenceEngine(net, ctx=jmx.cpu(0), **kw)


def _port_engine(net, **kw):
    return tengine_mod.InferenceEngine(net, device="cpu", **kw)


@pytest.fixture
def no_retry():
    """Terminal failures at once, no retry sleeps, in both packages."""
    for cfg in (jcfg, tcfg):
        cfg.set("MXNET_RETRY_MAX", 0)
    yield
    for cfg in (jcfg, tcfg):
        cfg.unset("MXNET_RETRY_MAX")


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    """A fake `time.monotonic` for both packages' serving modules."""
    c = _Clock()
    for mod in (jengine_mod, tengine_mod, jregistry_mod, tregistry_mod):
        monkeypatch.setattr(mod.time, "monotonic", c)
    return c


# -- 1. outputs per bucket, captures ---------------------------------------
def test_outputs_per_bucket_and_captures_match_jax(jax_bert):
    jnet, params = jax_bert
    net = _port(params)
    common = dict(buckets=BUCKETS, example_shape=(T,), wire_dtype="int32",
                  max_wait_us=0)
    jeng = _hold(_jax_engine(jnet, **common))
    teng = _hold(_port_engine(net, **common))
    traces = jevents.get("serve.traces"), tevents.get("serve.traces")
    jeng.warmup()
    teng.warmup()
    after = jevents.get("serve.traces"), tevents.get("serve.traces")
    assert after[0] - traces[0] == len(BUCKETS)
    assert after[1] - traces[1] == len(BUCKETS)
    assert len(teng._programs) == len(BUCKETS)
    toks = _tokens(20, seed=3)
    # batches of 1, 2 and 3 (padded to 4) and 4, then 10 singles
    sizes = (1, 2, 3, 4)
    outs = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        futs, off = [], 0
        for n in sizes:
            futs.append(eng.submit_batch(toks[off:off + n]))
            _drive(eng)
            off += n
        futs += [eng.submit(t) for t in toks[off:]]
        _drive(eng)
        res = [f.result(timeout=0) for f in futs]
        outs[name] = [np.asarray(r.asnumpy() if name == "jax" else r)
                      for r in res]
    assert jevents.get("serve.traces") == after[0]      # flat in traffic
    assert tevents.get("serve.traces") == after[1]
    for j, t in zip(outs["jax"], outs["port"]):
        assert j.shape == t.shape
        np.testing.assert_allclose(t, j, rtol=0, atol=OUT_TOL)
    st = teng.stats()
    # 1, 2, 3 → 4, 4, then the singles as 4 + 4 + 2
    assert st["bucket_batches"] == {1: 1, 2: 2, 4: 4}
    assert st["padded"] == 1                # the batch of 3
    assert st["captures"] == len(BUCKETS)
    assert jeng.stats()["device_batches"] == st["device_batches"]
    jeng.close()
    teng.close()


# -- 2. lanes and tenants --------------------------------------------------
def _shed_counts(events):
    return {tuple(sorted(r["labels"].items())): r["value"]
            for r in events.labeled_snapshot().get("serve.shed", ())}


def _submit_script(eng, toks):
    """A fixed submit sequence with the dispatcher held: each step's
    outcome ('ok' or the exception type), then the displaced futures'."""
    script = [("lo", "a", None), ("lo", "b", None), ("lo", "a", None),
              ("hi", "a", None), ("hi", "a", None), ("hi", "c", None),
              ("hi", "c", None), ("hi", "d", None), ("hi", None, 0.0),
              ("lo", "e", None)]
    outcome, futs = [], []
    for i, (lane, tenant, deadline) in enumerate(script):
        try:
            futs.append(eng.submit(toks[i], lane=lane, tenant=tenant,
                                   deadline=deadline))
            outcome.append("ok")
        except Exception as e:      # noqa: BLE001 — the typed refusal
            outcome.append(type(e).__name__)
    done = [type(f.exception(timeout=0)).__name__ if f.done() else "queued"
            for f in futs]
    return outcome, done


def test_lanes_and_tenants_shed_like_jax(jax_bert):
    jnet, params = jax_bert
    net = _port(params)
    kw = dict(buckets=(1,), example_shape=(T,), wire_dtype="int32",
              queue_cap=4, lanes=("hi", "lo"), lane_quotas=(1.0, 0.5),
              tenant_quota=2)
    toks = _tokens(10, seed=5)
    got = {}
    for name, eng, events in (
            ("jax", _hold(_jax_engine(jnet, **kw)), jevents),
            ("port", _hold(_port_engine(net, **kw)), tevents)):
        before = _shed_counts(events)
        rejected = events.get("serve.rejected")
        outcome, done = _submit_script(eng, toks)
        after = _shed_counts(events)
        st = eng.stats()
        got[name] = dict(
            outcome=outcome, done=done,
            shed={k: v - before.get(k, 0) for k, v in after.items()
                  if v != before.get(k, 0)},
            rejected=events.get("serve.rejected") - rejected,
            depths=st["lanes"]["depths"], tenants=st["tenants_queued"],
            quotas=eng.slo_lane_quotas())
        eng.close()
    assert got["jax"] == got["port"]
    assert got["port"]["outcome"] == [
        "ok", "ok", "Shed", "ok", "Shed", "ok", "ok", "ok",
        "DeadlineExceeded", "QueueFull"]
    assert got["port"]["done"].count("Shed") == 2       # both lo displaced


# -- 3. replica health ------------------------------------------------------
def test_replica_health_matches_jax(jax_bert, clock, no_retry,
                                    monkeypatch):
    jnet, params = jax_bert
    net = _port(params)
    for cfg in (jcfg, tcfg):
        monkeypatch.setitem(cfg._OVERRIDES, "MXNET_SERVE_REPLICA_FAILS",
                            "2")
        monkeypatch.setitem(cfg._OVERRIDES,
                            "MXNET_SERVE_REPLICA_COOLDOWN_S", "5")
    kw = dict(buckets=(1,), example_shape=(T,), wire_dtype="int32",
              max_wait_us=0)
    toks = _tokens(1, seed=7)[0]
    plan = "serve.infer#2;serve.infer#4;serve.infer#7"
    got = {}
    for name, eng, flt, events in (
            ("jax", _hold(jengine_mod.InferenceEngine(
                jnet, devices=[jmx.cpu(0), jmx.cpu(1)], **kw)),
             jfault, jevents),
            ("port", _hold(tengine_mod.InferenceEngine(
                net, devices=["cpu", "cpu"], **kw)), tfault, tevents)):
        eng.warmup()
        picked = []
        orig = eng._pick_replica

        def pick(orig=orig, picked=picked):
            i = orig()
            picked.append(i)
            return i
        eng._pick_replica = pick
        counts0 = {k: events.get("serve." + k)
                   for k in ("replica_unhealthy", "replica_recovered",
                             "replica_probes")}
        flt.clear()
        for kw_ in flt._parse_spec(plan):
            flt.install(**kw_)
        seq = []
        for step in range(12):
            fut = eng.submit(toks)
            _drive(eng)
            exc = fut.exception(timeout=30)
            seq.append((picked[-1], "ok" if exc is None else "fail",
                        tuple(eng.stats()["replica_health"])))
            clock.now += 2.0 if step != 7 else 0.5
        flt.clear()
        got[name] = dict(seq=seq, counts={
            k: events.get("serve." + k) - v for k, v in counts0.items()})
        eng.close()
    assert got["jax"] == got["port"]
    c = got["port"]["counts"]
    assert c["replica_unhealthy"] == 1 and c["replica_recovered"] == 1
    assert c["replica_probes"] >= 2     # one failed probe, one good one


# -- 4. weight swap ---------------------------------------------------------
def test_refresh_params_from_swaps_in_place(jax_bert):
    _, params = jax_bert
    v1 = _port(params)
    tmx.random.seed(3)
    v2 = tmx.models.bert_small(device="cpu", **KW).eval()
    v1_before = {n: t.detach().clone() for n, t in v1.state_dict().items()}
    v2_before = {n: t.detach().clone() for n, t in v2.state_dict().items()}
    eng = _hold(_port_engine(v1, buckets=(1, 2), example_shape=(T,),
                             wire_dtype="int32", max_wait_us=0))
    eng.warmup()
    ptrs = {n: t.data_ptr() for n, t in eng._reps[0].params.items()}
    traces = tevents.get("serve.traces")
    swaps = tevents.get("serve.param_swaps")
    toks = _tokens(2, seed=9)
    eng.refresh_params_from(v2, version="v2")
    futs = [eng.submit(toks[0]), eng.submit_batch(toks[1:])]
    _drive(eng)
    with torch.inference_mode():
        ref = v2(torch.from_numpy(toks))
    torch.testing.assert_close(futs[0].result(timeout=0), ref[0], rtol=0,
                               atol=SWAP_TOL)
    torch.testing.assert_close(futs[1].result(timeout=0), ref[1:], rtol=0,
                               atol=SWAP_TOL)
    assert tevents.get("serve.traces") == traces            # no capture
    assert tevents.get("serve.param_swaps") == swaps + 1
    assert {n: t.data_ptr() for n, t in eng._reps[0].params.items()} \
        == ptrs
    for before, blk in ((v1_before, v1), (v2_before, v2)):
        for n, t in blk.state_dict().items():
            assert torch.equal(t, before[n]), n             # bit-equal
    assert eng.stats()["version"] == "v2"
    eng.close()


def test_refresh_params_from_mismatch_raises_like_jax(jax_bert):
    jnet, params = jax_bert
    msgs = {}
    with nameless_scope():
        jmx.random.seed(4)
        jwide = jtr.bert_small(vocab_size=V, max_length=T, units=32,
                               hidden_size=64, dropout=0.0)
        jwide.initialize()
        jwide(jmx.nd.array(np.zeros((1, T), np.int32), dtype="int32"))
        jdeep = jtr.bert_small(vocab_size=V, max_length=T, num_layers=3,
                               dropout=0.0)
        jdeep.initialize()
        jdeep(jmx.nd.array(np.zeros((1, T), np.int32), dtype="int32"))
    tmx.random.seed(4)
    twide = tmx.models.bert_small(device="cpu", vocab_size=V,
                                  max_length=T, units=32, hidden_size=64,
                                  dropout=0.0)
    tdeep = tmx.models.bert_small(device="cpu", vocab_size=V,
                                  max_length=T, num_layers=3, dropout=0.0)
    for name, eng, wide, deep in (
            ("jax", _jax_engine(jnet, buckets=(1,)), jwide, jdeep),
            ("port", _port_engine(_port(params), buckets=(1,)), twide,
             tdeep)):
        out = []
        for blk in (wide, deep):
            with pytest.raises(ValueError) as err:
                eng.refresh_params_from(blk)
            out.append(re.sub(r"serving shape.*", "", str(err.value)
                              .split(" — ")[0]))
        msgs[name] = out
        eng.close()
    assert "shape" in msgs["port"][0]
    assert msgs["port"][1].startswith("parameter tree mismatch")
    # the parameter's name differs (JAX auto-prefixes), the text not
    assert [m.split(" ")[0::2][:2] for m in msgs["jax"]] == \
        [m.split(" ")[0::2][:2] for m in msgs["port"]]
    assert msgs["jax"][1] == msgs["port"][1]


# -- 5. registry ------------------------------------------------------------
def _denied_terms(msg):
    """The numbers of an AdmissionDenied message: footprint, replicas,
    each device's free bytes, and the KV term where there is one."""
    return [int(x) for x in re.findall(r"(?<![\w.])(\d+)(?![\w.(])",
                                        re.sub(r"\w+[(:]\d+\)?", "", msg))]


def test_registry_admission_like_jax(jax_bert):
    jnet, params = jax_bert
    net = _port(params)
    jfp, jdet = jregistry_mod.project_footprint(jnet, BUCKETS, (T,),
                                                "int32")
    tfp, tdet = tregistry_mod.project_footprint(net, BUCKETS, (T,),
                                                "int32")
    assert tdet == jdet and tfp == jfp          # bytes exactly
    with nameless_scope():
        jmx.random.seed(0)
        jnmt = jtr.transformer_nmt_small(NMT_V, NMT_V, dropout=0.0)
        jnmt.initialize(force_reinit=True)
        jnmt(jmx.nd.array(np.ones((1, 4), np.int32)),
             jmx.nd.array(np.ones((1, 1), np.int32)))
    tnmt = tmx.weights.load_reference_params(
        tmx.models.transformer_nmt_small(NMT_V, NMT_V, dropout=0.0,
                                         device="cpu"),
        {n: p.data().asnumpy()
         for n, p in jnmt._collect_params_with_prefix().items()})
    budget = int(2.5 * tfp)
    got = {}
    for name, mod, blk, nmt, dev in (
            ("jax", jregistry_mod, jnet, jnmt, jmx.cpu(0)),
            ("port", tregistry_mod, net, tnmt, "cpu")):
        reg = mod.ModelRegistry(devices=[dev], hbm_budget=budget)
        out = []
        for m in ("a", "b", "c"):
            try:
                rec = reg.register(m, blk, example_shape=(T,),
                                   wire_dtype="int32", buckets=BUCKETS)
                out.append(("admit", rec["footprint_bytes"]))
            except mod.AdmissionDenied as e:
                out.append(("deny", _denied_terms(str(e))))
            out.append(("committed", list(reg._committed)))
        reg.unregister("b")
        out.append(("committed", list(reg._committed)))
        with pytest.raises(mod.AdmissionDenied) as err:
            reg.register_generator("nmt", nmt, BOS, EOS, slots=64,
                                   max_len=16, prompt_buckets=(4, 8))
        out.append(("deny_gen", _denied_terms(str(err.value))))
        assert "KV cache" in str(err.value)
        rec = reg.register_generator("nmt_small", nmt, BOS, EOS, slots=2,
                                     max_len=16, prompt_buckets=(4, 8))
        out.append(("admit_gen", rec["footprint_bytes"],
                    rec["detail"]["kv_bytes"]))
        out.append(("committed", list(reg._committed)))
        reg.close()
        got[name] = out
    assert got["jax"] == got["port"]
    assert [o[0] for o in got["port"][:6]] == [
        "admit", "committed", "admit", "committed", "deny", "committed"]


def test_registry_canary_promote_rollback_like_jax(jax_bert):
    jnet, params = jax_bert
    net = _port(params)
    with nameless_scope():
        jmx.random.seed(5)
        jv2 = jtr.bert_small(**KW)
        jv2.initialize()
        jv2(jmx.nd.array(np.zeros((1, T), np.int32), dtype="int32"))
    tv2 = _port({n: p.data().asnumpy()
                 for n, p in jv2._collect_params_with_prefix().items()})
    toks = _tokens(1, seed=13)[0]
    got = {}
    for name, mod, blk, v2, dev in (
            ("jax", jregistry_mod, jnet, jv2, jmx.cpu(0)),
            ("port", tregistry_mod, net, tv2, "cpu")):
        reg = mod.ModelRegistry(devices=[dev])
        reg.register("m", blk, example_shape=(T,), wire_dtype="int32",
                     buckets=(1,), queue_cap=256)
        rec = reg.register_version("m", v2, "v2", fraction=0.25,
                                   warmup=False)
        _hold(reg.engine("m"))
        _hold(reg.engine("m@v2"))
        for _ in range(200):
            reg.submit("m", toks)
        routed = (reg.engine("m")._q.qsize(),
                  reg.engine("m@v2")._q.qsize())
        route = reg.canary("m")
        reg.set_canary_fraction("m", 0.5)
        rolled = reg.rollback_version("m", reason="test")
        again = reg.rollback_version("m")
        reg.register_version("m", v2, "v3", fraction=0.1, warmup=False)
        promoted = reg.promote_version("m")
        st = reg.stats()["models"]
        got[name] = dict(
            rec=(rec["version"], rec["fraction"], rec["tainted"]),
            routed=routed, route=route,
            rolled=(rolled["version"], rolled["fraction"]),
            again=again, promoted=promoted,
            models=sorted(st), version=st["m"]["version"],
            canary=st["m"]["canary"])
        reg.close()
    assert got["jax"] == got["port"]
    assert got["port"]["routed"] == (150, 50)


def test_breaker_transitions_like_jax(clock):
    got = {}
    for name, mod in (("jax", jregistry_mod), ("port", tregistry_mod)):
        b = mod._Breaker("m", max_fails=2, cooldown_s=10.0)
        seq = []
        for op, dt in (("allow", 0), ("fail", 0), ("allow", 0),
                       ("fail", 0), ("allow", 1), ("allow", 9.5),
                       ("allow", 0), ("fail", 0), ("allow", 5),
                       ("allow", 6), ("ok", 0), ("allow", 0)):
            clock.now += dt
            r = getattr(b, op)()
            seq.append((op, r, b.state, b.streak))
        got[name] = seq
    assert got["jax"] == got["port"]
    assert [s[2] for s in got["port"]][-2:] == ["closed", "closed"]


# -- engine surface -----------------------------------------------------------
def test_engine_surface_sigterm_degrade_and_faults(jax_bert, no_retry):
    _, params = jax_bert
    net = _port(params)
    eng = _hold(_port_engine(net, buckets=(1,), example_shape=(T,),
                             wire_dtype="int32", max_wait_us=0,
                             handle_sigterm=True, cost_label="serve.infer:x",
                             version="v1"))
    assert eng._prev_sigterm is not None
    eng.warmup()
    toks = _tokens(1, seed=17)[0]
    ok = eng.submit(toks)
    _drive(eng)
    eng.degrade(0.0001)
    bad = eng.submit(toks)
    _drive(eng)
    torch.testing.assert_close(bad.result(timeout=0), -ok.result(timeout=0))
    eng.degrade(0)
    assert eng.stats()["degraded"] is False
    tfault.clear()
    tfault.install("serve.enqueue", at_calls=[1])
    with pytest.raises(tengine_mod.QueueFull, match="serve.enqueue"):
        eng.submit(toks)
    tfault.install("serve.infer", at_calls=[1])
    failed = eng.submit(toks)
    _drive(eng)
    assert isinstance(failed.exception(timeout=0), tfault.TransientFault)
    tfault.clear()
    rows = [r for r in tcosts.table() if r["label"] == "serve.infer:x[r0b1]"]
    assert len(rows) == 1 and rows[0]["invocations"] == 3
    assert rows[0]["param_bytes"] == tengine_mod.param_bytes(net)
    assert tcosts.footprint_bytes("serve.infer:x") == \
        rows[0]["argument_bytes"] + rows[0]["output_bytes"]
    eng.request_shutdown()
    with pytest.raises(tengine_mod.EngineClosed):
        eng.submit(toks)
    eng.close()
    assert eng._prev_sigterm is None
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tregistry_mod.ModelRegistry(devices=["cpu"]).register_quantized(
            "q", net)
    net.set_input_transform(lambda x: x)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _port_engine(net)
    net.set_input_transform(None)
