"""PyTorch port: generation serving (`serving.generation.GenerationEngine`)
against the JAX package's, on the CPU.

`transformer_nmt_small(23, 23, dropout=0.0)` is built and initialized in
JAX from seed 0 and its weights are carried into the port
(`weights.load_reference_params`).  Engines use 2-3 slots, max_len 16 and
prompt buckets (4, 8), as tests/python/unittest/test_generation.py builds
them.  On the CPU each of the engine's programs is the recorded aten ops
of its capture, replayed on the same storage (`graph_capture`), so frozen
Python values and stale storage show here as they would on the card.

Greedy tokens are held to the JAX `GenerationEngine` and to the JAX
`contrib.text.decode.greedy_translate` under the near-tie rule: a token
may differ only where the reference's top-2 logit gap at that step is
within the logits tolerance; that request's comparison then stops and
the gap is printed.

No test asserts on the wall clock.  Tests that need the scheduler in a
given state drive the decode loop's body (`_tick`) from the test thread,
with the loop thread never started; every wait has a timeout.
"""
import threading

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
from incubator_mxnet_tpu import nd
from incubator_mxnet_tpu.contrib.text.decode import greedy_translate
from incubator_mxnet_tpu.gluon.block import nameless_scope
from incubator_mxnet_tpu.models.transformer import \
    transformer_nmt_small as jax_nmt_small
from incubator_mxnet_tpu.serving import GenerationEngine as JaxEngine
from incubator_mxnet_tpu.serving.generation import \
    project_generation_footprint as jax_footprint
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import fault
from incubator_mxnet_tpu_torch.graph_capture import CaptureError
from incubator_mxnet_tpu_torch.monitor import events
from incubator_mxnet_tpu_torch.serving import (DeadlineExceeded,
                                               EngineClosed,
                                               GenerationEngine, Shed,
                                               project_generation_footprint)
from incubator_mxnet_tpu_torch.telemetry import flightrec, slo, spans

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

V, BOS, EOS = 23, 1, 2
SLOTS, MAX_LEN, BUCKETS = 3, 16, (4, 8)
# f32 logits of size ~1 through 2 + 2 layers, sums in another order
LOGIT_TOL = 2e-5
PARITY_NEW = 10
# greedy_translate runs the whole net once per prefix length (one JAX
# compile each): it is held to the first GREEDY_NEW tokens
GREEDY_NEW = 6
TIMEOUT = 60


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(3, V, (n,)).astype(np.int32)


# off-bucket (3 pads to 4) and on-bucket (8)
PARITY_PROMPTS = {"off_bucket": _prompt(7, 3), "on_bucket": _prompt(8, 8)}


def _trim(tokens):
    """Tokens up to and including the first eos."""
    toks = [int(t) for t in tokens]
    return toks[:toks.index(EOS) + 1] if EOS in toks else toks


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX net's weights, and its GenerationEngine's and
    greedy_translate's tokens for the parity prompts."""
    with nameless_scope():
        jmx.random.seed(0)
        jnet = jax_nmt_small(V, V, dropout=0.0)
        jnet.initialize(force_reinit=True)
        jnet(nd.array(np.ones((1, 4), np.int32)),
             nd.array(np.ones((1, 1), np.int32)))
    params = {n: p.data().asnumpy()
              for n, p in jnet._collect_params_with_prefix().items()}
    _, jdetail = jax_footprint(jnet, slots=2, max_len=MAX_LEN,
                               buckets=BUCKETS)
    eng = JaxEngine(jnet, bos=BOS, eos=EOS, slots=SLOTS, max_len=MAX_LEN,
                    prompt_buckets=BUCKETS)
    try:
        eng.warmup()
        engine = {k: _trim(eng.submit(p, max_new_tokens=PARITY_NEW)
                           .result(timeout=TIMEOUT))
                  for k, p in PARITY_PROMPTS.items()}
    finally:
        eng.close()
    # one compile per prefix length, not one per op and length
    jnet.hybridize()
    greedy = {k: _trim(greedy_translate(
        jnet, nd.array(p[None], dtype="int32"), BOS, EOS,
        max_len=GREEDY_NEW)[0]) for k, p in PARITY_PROMPTS.items()}
    return dict(params=params, engine=engine, greedy=greedy,
                footprint=jdetail)


@pytest.fixture
def net(jax_ref):
    m = tmx.models.transformer_nmt_small(V, V, dropout=0.0, device="cpu")
    return tmx.weights.load_reference_params(m, jax_ref["params"])


def _engine(net, slots=SLOTS, **kw):
    return GenerationEngine(net, bos=BOS, eos=EOS, ctx="cpu", slots=slots,
                            max_len=MAX_LEN, prompt_buckets=BUCKETS, **kw)


def _no_loop(eng):
    """Keep the decode loop thread from starting: the test drives the
    loop's body (`_tick`) itself."""
    eng._ensure_loop = lambda: None
    return eng


def _tick_until(eng, cond, limit=200):
    for _ in range(limit):
        if cond():
            return
        eng._tick()
    raise AssertionError("condition not reached in %d ticks" % limit)


@torch.no_grad()
def _eager_greedy(net, prompt, max_new, feed=None):
    """The port's eager greedy loop for one request alone (init_cache +
    decode_step at the engine's max_len and memory length): its tokens,
    and each step's top-2 logit gap.  With `feed`, the steps are fed
    those tokens instead of their own argmax."""
    src = torch.from_numpy(prompt[None].astype(np.int64))
    cache = net.init_cache(src, torch.tensor([prompt.size]),
                           max_len=MAX_LEN, mem_len=max(BUCKETS))
    tok, toks, gaps = torch.tensor([BOS]), [], []
    for i in range(max_new):
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
    """got == ref, but for a near tie: at the first differing step the
    reference's top-2 gap must be within LOGIT_TOL, and the comparison
    stops there."""
    got, ref = _trim(got), _trim(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        if g != r:
            _, gaps = _eager_greedy(net, prompt, i + 1, feed=ref)
            print("%s: near tie at step %d, top-2 gap %g"
                  % (what, i, gaps[i]))
            assert gaps[i] <= LOGIT_TOL, (what, i, got, ref)
            return
    assert got == ref, (what, got, ref)


# -- greedy parity ---------------------------------------------------------

@pytest.mark.parametrize("which", sorted(PARITY_PROMPTS))
def test_greedy_parity_with_jax_engine_and_greedy_translate(jax_ref, net,
                                                            which):
    prompt = PARITY_PROMPTS[which]
    eng = _engine(net)
    try:
        eng.warmup()
        got = eng.submit(prompt, max_new_tokens=PARITY_NEW) \
            .result(timeout=TIMEOUT)
    finally:
        eng.close()
    assert got.dtype == np.int32 and 1 <= got.size <= PARITY_NEW
    if got.size < PARITY_NEW:
        assert got[-1] == EOS       # only eos ends a request early
    eager, _ = _eager_greedy(net, prompt, PARITY_NEW)
    _assert_same_tokens(got, jax_ref["engine"][which], net, prompt,
                        "JAX GenerationEngine, " + which)
    _assert_same_tokens(got[:GREEDY_NEW], jax_ref["greedy"][which], net,
                        prompt, "JAX greedy_translate, " + which)
    _assert_same_tokens(got, eager, net, prompt, "port eager, " + which)


def test_slot_churn_each_request_decodes_as_alone(net):
    # 6 requests through 2 slots with staggered budgets: slot reuse may
    # not leak state across requests
    prompts = [_prompt(11 + i, n) for i, n in enumerate((3, 8, 3, 8, 3, 8))]
    budgets = [4, 9, 6, 11, 3, 7]
    eng = _engine(net, slots=2)
    try:
        eng.warmup()
        streams = [eng.submit(p, max_new_tokens=m)
                   for p, m in zip(prompts, budgets)]
        got = [s.result(timeout=TIMEOUT) for s in streams]
        assert events.get("gen.retires") >= len(prompts)
    finally:
        eng.close()
    for p, m, g in zip(prompts, budgets, got):
        ref, _ = _eager_greedy(net, p, m)
        _assert_same_tokens(g, ref, net, p, "churn")


def test_continuous_join_mid_generation(net):
    eng = _no_loop(_engine(net, slots=2))
    try:
        eng.warmup()
        p1, p2 = _prompt(5, 5), _prompt(6, 4)
        s1 = eng.submit(p1, max_new_tokens=14)
        eng._tick()                     # s1 joins and emits its first
        assert len(s1.tokens()) == 1 and not s1.done()
        joins = events.get("gen.joins")
        s2 = eng.submit(p2, max_new_tokens=4)
        eng._tick()                     # s2 joins beside the running s1
        assert events.get("gen.joins") == joins + 1
        assert eng.stats()["slots_live"] == 2 and not s1.done()
        _tick_until(eng, lambda: s1.done() and s2.done())
    finally:
        eng.close()
    for p, m, s in ((p1, 14, s1), (p2, 4, s2)):
        ref, _ = _eager_greedy(net, p, m)
        _assert_same_tokens(s.result(timeout=0), ref, net, p, "join")


# -- captures --------------------------------------------------------------

@pytest.mark.parametrize("buckets", [(4, 8), (2, 4, 8)])
def test_warmup_captures_exactly_the_program_set(net, buckets):
    t0 = events.get("serve.traces")
    eng = GenerationEngine(net, bos=BOS, eos=EOS, ctx="cpu", slots=2,
                           max_len=MAX_LEN, prompt_buckets=buckets)
    try:
        w = eng.warmup()
        assert events.get("serve.traces") - t0 == len(buckets) + 2
        assert w["prompt_buckets"] == list(buckets)
        assert sorted(map(str, eng._programs)) == sorted(
            ["decode", "join"] + [str(("prefill", b)) for b in buckets])
    finally:
        eng.close()


def test_zero_recapture_across_prompt_lengths(net):
    eng = _engine(net, slots=2)
    try:
        eng.warmup()
        t0 = events.get("serve.traces")
        streams = [eng.submit(_prompt(13, n), max_new_tokens=5)
                   for n in (1, 2, 3, 4, 5, 6, 7, 8, 3, 5)]
        for s in streams:
            s.result(timeout=TIMEOUT)
        assert events.get("serve.traces") == t0
    finally:
        eng.close()


def test_cold_engine_captures_lazily_on_first_traffic(net):
    eng = _engine(net, slots=2)
    try:
        t0 = events.get("serve.traces")
        got = eng.submit(PARITY_PROMPTS["on_bucket"], max_new_tokens=6) \
            .result(timeout=TIMEOUT)
        # the 8-bucket prefill, the join and the decode step
        assert events.get("serve.traces") - t0 == 3
    finally:
        eng.close()
    ref, _ = _eager_greedy(net, PARITY_PROMPTS["on_bucket"], 6)
    _assert_same_tokens(got, ref, net, PARITY_PROMPTS["on_bucket"], "cold")


def test_cache_is_updated_in_place(net):
    eng = _engine(net, slots=2)
    try:
        eng.warmup()
        copies = events.get("gen.donation_copy")
        ptrs = {k: t.data_ptr() for k, t in eng._state.leaves().items()}
        assert ptrs == eng._ptrs
        streams = [eng.submit(_prompt(20 + i, 3 + i), max_new_tokens=5)
                   for i in range(4)]
        for s in streams:
            s.result(timeout=TIMEOUT)
        assert eng._donation_checked
        assert {k: t.data_ptr()
                for k, t in eng._state.leaves().items()} == ptrs
        assert events.get("gen.donation_copy") == copies
        # the decode step writes back every self-attention K and V
        assert sorted(eng._written) == sorted(
            "%s%d" % (kv, i) for kv in "kv" for i in range(2))
    finally:
        eng.close()


def test_a_leaf_replaced_after_capture_is_reported(net):
    # the programs keep writing the captured storage: a cache leaf
    # rebound since must count gen.donation_copy and warn with the label
    eng = _no_loop(_engine(net, slots=2))
    try:
        eng.warmup()
        copies = events.get("gen.donation_copy")
        eng._state.cache["k0"] = eng._state.cache["k0"].clone()
        s = eng.submit(_prompt(3, 4), max_new_tokens=3)
        with pytest.warns(UserWarning, match="serve.gen:decode_step"):
            eng._tick()
        assert events.get("gen.donation_copy") == copies + 1
        _tick_until(eng, s.done)
    finally:
        eng.close()


def test_a_host_read_in_decode_step_fails_the_capture(net):
    class HostRead(type(net)):
        def decode_step(self, tok, pos, cache):
            if int(pos.max()) > 1000:       # a host read of a device value
                pos = pos * 0
            return super().decode_step(tok, pos, cache)

    bad = HostRead(V, V, units=64, hidden_size=128, num_layers=2,
                   num_heads=4, max_length=128, dropout=0.0, device="cpu")
    bad.load_state_dict(net.state_dict())
    eng = _engine(bad, slots=2)
    try:
        with pytest.raises(CaptureError, match="_local_scalar_dense"):
            eng.warmup()
        assert "decode" not in eng._programs
        steps = events.get("gen.steps")
        # nothing runs eager: the request that needs the step fails
        s = eng.submit(_prompt(1, 4), max_new_tokens=3)
        with pytest.raises(CaptureError):
            s.result(timeout=TIMEOUT)
        assert events.get("gen.steps") == steps and s.tokens() == []
    finally:
        eng.close()


# -- failures --------------------------------------------------------------

def test_a_failed_prefill_fails_only_its_request(net):
    eng = _no_loop(_engine(net, slots=2))
    try:
        eng.warmup()
        fault.install("serve.infer", at_calls=[1])
        try:
            s1 = eng.submit(_prompt(2, 3), max_new_tokens=3)
            eng._tick()
        finally:
            fault.clear()
        with pytest.raises(fault.TransientFault):
            s1.result(timeout=0)
        s2 = eng.submit(_prompt(2, 3), max_new_tokens=3)
        _tick_until(eng, s2.done)
        assert len(s2.result(timeout=0)) >= 1
    finally:
        eng.close()


@pytest.mark.parametrize("program", ["join", "decode"])
def test_a_failed_program_fails_live_slots_and_resets_the_cache(net,
                                                                program):
    eng = _no_loop(_engine(net, slots=2))
    try:
        eng.warmup()
        s1 = eng.submit(_prompt(4, 5), max_new_tokens=10)
        eng._tick()
        assert len(s1.tokens()) == 1
        prog = eng._programs[program]
        real = prog.replay

        def boom():
            prog.replay = real
            raise RuntimeError("injected %s failure" % program)
        prog.replay = boom
        s2 = eng.submit(_prompt(5, 4), max_new_tokens=10)
        eng._tick()
        if program == "join":
            # the joining request fails with the program's error, the
            # running one loses its state and is closed
            with pytest.raises(RuntimeError, match="injected join"):
                s2.result(timeout=0)
            with pytest.raises(EngineClosed, match="failed join"):
                s1.result(timeout=0)
        else:
            for s in (s1, s2):
                with pytest.raises(RuntimeError, match="injected decode"):
                    s.result(timeout=0)
        assert eng.stats()["slots_live"] == 0
        st = eng._state
        assert bool((st.tok == EOS).all()) and bool((st.pos == 0).all())
        assert all(bool((t == 0).all()) for t in st.cache.values())
        # the engine stays serviceable, on the same storage
        assert {k: t.data_ptr() for k, t in st.leaves().items()} \
            == eng._ptrs
        p3 = _prompt(6, 6)
        s3 = eng.submit(p3, max_new_tokens=5)
        _tick_until(eng, s3.done)
    finally:
        eng.close()
    ref, _ = _eager_greedy(net, p3, 5)
    _assert_same_tokens(s3.result(timeout=0), ref, net, p3, "after reset")


# -- deadlines and shedding ------------------------------------------------

def test_mid_decode_deadline_frees_slot(net):
    eng = _no_loop(_engine(net, slots=1))
    try:
        eng.warmup()
        shed0 = events.get("gen.shed")
        s = eng.submit(_prompt(17, 8), max_new_tokens=14, deadline=1.0)
        eng._tick()                     # first token, well inside 1 s
        assert len(s.tokens()) == 1 and not s.done()
        # every later step stalls past the deadline
        fault.install("serve.decode_slow", steps=range(10000), seconds=1.0)
        try:
            eng._tick()
        finally:
            fault.clear()
        with pytest.raises(DeadlineExceeded, match="after 2 token"):
            s.result(timeout=0)
        assert events.get("gen.shed") > shed0
        assert eng.stats()["slots_live"] == 0
        s2 = eng.submit(_prompt(18, 4), max_new_tokens=3)
        _tick_until(eng, s2.done)
        assert len(s2.result(timeout=0)) >= 1
    finally:
        eng.close()


def test_born_expired_and_lane_quota_shed(net):
    eng = _no_loop(GenerationEngine(
        net, bos=BOS, eos=EOS, ctx="cpu", slots=1, max_len=MAX_LEN,
        prompt_buckets=(4,), queue_cap=8, lanes=("hi", "lo"),
        lane_quotas=(1.0, 0.25)))
    try:
        with pytest.raises(DeadlineExceeded, match="not in the future"):
            eng.submit(np.array([3, 4, 5]), deadline=-1.0)
        # the low lane's cap is 0.25 x 8 = 2: the third submit is shed
        for _ in range(2):
            eng.submit(np.array([3, 4]), lane="lo", max_new_tokens=2)
        with pytest.raises(Shed, match="lane 'lo' over quota"):
            eng.submit(np.array([3, 4]), lane="lo", max_new_tokens=2)
        eng.submit(np.array([3, 4]), lane="hi", max_new_tokens=2)
        assert eng.stats()["lanes"]["depths"] == {"hi": 1, "lo": 2}
        assert eng.slo_lane_quotas() == {"hi": 1.0, "lo": 0.25}
        # no deadline accepted yet: the shed burn rules alone, budgeted
        # by the lane quotas
        assert eng.install_slo_rules() == ["gen-shed-hi", "gen-shed-lo"]
        assert [slo.rules()[n].budget for n in ("gen-shed-hi",
                                                 "gen-shed-lo")] \
            == [0.02, 0.75]
    finally:
        slo.clear_rules()
        eng.close()


def test_tenant_quota_and_infeasible_deadline_shed(net):
    eng = _no_loop(_engine(net, slots=1, tenant_quota=1))
    try:
        eng.warmup()
        eng.submit(np.array([3, 4]), tenant="a", max_new_tokens=2)
        with pytest.raises(Shed, match="tenant 'a' over quota"):
            eng.submit(np.array([3, 4]), tenant="a", max_new_tokens=2)
        # a prefill estimate beyond the deadline: shed at admission,
        # before any device work
        eng._prefill_ewma[4] = 100.0
        s = eng.submit(np.array([5, 6]), tenant="b", deadline=30.0)
        joins = events.get("gen.joins")
        _tick_until(eng, s.done)
        with pytest.raises(DeadlineExceeded, match="infeasible"):
            s.result(timeout=0)
        assert events.get("gen.joins") == joins + 1     # only tenant a's
        assert eng.slo_targets() == {"high": 30.0}
    finally:
        eng.close()


# -- lifecycle -------------------------------------------------------------

def test_close_resolves_every_stream_exactly_once(net):
    eng = _engine(net, slots=2)
    resolved = []
    try:
        eng.warmup()
        streams = [eng.submit(_prompt(23 + i, 4), max_new_tokens=12)
                   for i in range(8)]
        for s in streams:
            s.future.add_done_callback(resolved.append)
        assert eng.close(timeout=TIMEOUT)
        assert all(s.done() for s in streams)
        assert len(resolved) == len(streams)
        for s in streams:
            assert 1 <= len(s.result(timeout=0)) <= 12
        assert eng._q.unfinished_tasks == 0
        assert eng.stats()["slots_live"] == 0
        with pytest.raises(EngineClosed):
            eng.submit(np.array([3, 4]))
    finally:
        eng.close()


def test_close_flushes_queued_and_running_streams(net):
    eng = _no_loop(_engine(net, slots=2))
    eng.warmup()
    streams = [eng.submit(_prompt(30 + i, 4), max_new_tokens=12)
               for i in range(4)]
    eng._tick()                         # 2 run, 2 wait
    assert eng.stats()["slots_live"] == 2
    eng.close(timeout=5)
    for s in streams:
        with pytest.raises(EngineClosed):
            s.result(timeout=0)
    assert [len(s.tokens()) for s in streams] == [1, 1, 0, 0]
    assert eng._q.unfinished_tasks == 0
    eng.close()                         # idempotent
    assert eng._q.unfinished_tasks == 0


def test_stream_iterates_incrementally(net):
    eng = _no_loop(_engine(net, slots=1))
    try:
        eng.warmup()
        s = eng.submit(_prompt(1, 5), max_new_tokens=6)
        it = iter(s)
        eng._tick()
        first = next(it)                # available before the request ends
        assert not s.done() and s.tokens() == [first]
        _tick_until(eng, s.done)
        got = [first] + list(it)
        assert got == list(s.result(timeout=0))
        assert events.get("gen.ttft_us.n") >= 1
    finally:
        eng.close()


def test_drain_mode_admits_only_at_batch_boundary(net):
    eng = _no_loop(_engine(net, slots=2, continuous=False))
    try:
        eng.warmup()
        s1 = eng.submit(_prompt(29, 5), max_new_tokens=8)
        eng._tick()
        joins = events.get("gen.joins")
        s2 = eng.submit(_prompt(31, 4), max_new_tokens=2)
        while not s1.done():
            eng._tick()
            assert events.get("gen.joins") == joins     # a slot is free
        _tick_until(eng, s2.done)
        assert events.get("gen.joins") == joins + 1
        assert len(s2.result(timeout=0)) >= 1
    finally:
        eng.close()


def test_threaded_drain_waits_for_queued_work(net):
    eng = _engine(net, slots=1)
    try:
        eng.warmup()
        streams = [eng.submit(_prompt(40 + i, 3), max_new_tokens=4)
                   for i in range(3)]
        assert eng.drain(timeout=TIMEOUT)
        assert all(s.done() for s in streams)
        with pytest.raises(EngineClosed, match="draining"):
            eng.submit(np.array([3, 4]))
    finally:
        eng.close()
    assert not eng._thread.is_alive()


# -- footprint, telemetry, construction -----------------------------------

def test_footprint_matches_live_cache_and_jax(jax_ref, net):
    total, detail = project_generation_footprint(
        net, slots=2, max_len=MAX_LEN, buckets=BUCKETS)
    ref = jax_ref["footprint"]
    for key in ("kv_bytes_per_slot", "kv_bytes", "param_bytes", "mem_len",
                "max_len", "slots"):
        assert detail[key] == ref[key], key
    assert total == detail["param_bytes"] + detail["kv_bytes"] + \
        int(detail["temp_factor"] * 2 * V * 4)
    eng = _engine(net, slots=2)
    try:
        eng.warmup()
        kv = eng.kv_cache_bytes()
        live = sum(t.numel() * t.element_size()
                   for t in eng._state.leaves().values())
        assert kv["total"] == live
        # the engine adds the tok, pos and out rows to the model's leaves
        assert kv["per_slot"] - detail["kv_bytes_per_slot"] == \
            4 * (2 + MAX_LEN)
    finally:
        eng.close()


def test_occupancy_gauge_flightrec_and_spans(net):
    prev = spans.enable(True)
    eng = _no_loop(_engine(net, slots=2))
    try:
        flightrec.clear()
        eng.warmup()
        n0 = events.get("gen.slots_live.n")
        s = eng.submit(np.array([3, 4, 5, 6]), max_new_tokens=3)
        _tick_until(eng, s.done)
        assert events.get("gen.slots_live.n") > n0
        kinds = [(e["kind"], e["name"]) for e in flightrec.ring_snapshot()]
        for want in (("gen", "join"), ("gen", "retire"),
                     ("span", "serve.prefill"),
                     ("span", "serve.decode_step")):
            assert want in kinds, want
        join = next(e for e in flightrec.ring_snapshot()
                    if (e["kind"], e["name"]) == ("gen", "join"))
        assert join["live"] == 1 and join["free"] == 1
    finally:
        eng.close()
        spans.enable(prev)


def test_construction_without_cuda_raises_unless_cpu(net):
    if torch.cuda.is_available():
        pytest.skip("holds the behaviour without a CUDA device")
    for ctx in (None, "cuda:0"):
        with pytest.raises(tmx.MXNetError, match="no CUDA device"):
            GenerationEngine(net, bos=BOS, eos=EOS, ctx=ctx)
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        tmx.gpu(0)
    eng = GenerationEngine(net, bos=BOS, eos=EOS, ctx=tmx.cpu(), slots=1,
                           max_len=MAX_LEN, prompt_buckets=BUCKETS)
    eng.close()


def test_submit_validation(net):
    eng = _no_loop(_engine(net, slots=1))
    try:
        with pytest.raises(ValueError, match="largest prompt bucket"):
            eng.submit(np.arange(9) + 3)
        with pytest.raises(ValueError, match="max_new_tokens"):
            eng.submit(np.array([3]), max_new_tokens=MAX_LEN + 1)
        with pytest.raises(ValueError, match="unknown lane"):
            eng.submit(np.array([3]), lane="nope")
        with pytest.raises(ValueError, match="empty prompt"):
            eng.submit(np.array([], np.int32))
        with pytest.raises(ValueError, match="positional table"):
            GenerationEngine(net, bos=BOS, eos=EOS, ctx="cpu",
                             max_len=129)
        with pytest.raises(TypeError, match="explicit-cache"):
            GenerationEngine(tmx.gluon.nn.Dense(3, in_units=2,
                                                device="cpu"),
                             bos=BOS, eos=EOS, ctx="cpu")
    finally:
        eng.close()


def test_warmup_and_submit_from_inside_inference_mode(net):
    # the static state is allocated outside inference mode whatever the
    # caller's mode, and the loop thread enters its own no-grad scope
    # (torch's modes are thread-local), so its in-place writes are legal
    eng = _engine(net, slots=1)
    try:
        with torch.inference_mode():
            eng.warmup()
            s = eng.submit(_prompt(9, 4), max_new_tokens=4)
        assert not any(t.is_inference() for t in eng._state.leaves().values())
        assert any(t.name == "GenDecodeLoop" for t in threading.enumerate())
        ref, _ = _eager_greedy(net, _prompt(9, 4), 4)
        _assert_same_tokens(s.result(timeout=TIMEOUT), ref, net,
                            _prompt(9, 4), "inference mode")
    finally:
        eng.close()


def test_the_decode_loop_survives_an_error_and_leaves_a_dump(net):
    eng = _engine(net, slots=1)
    try:
        eng.warmup()
        errors, dumps = events.get("gen.loop_errors"), \
            events.get("blackbox.dumps")
        real = eng._admit

        def boom():
            eng._admit = real
            raise RuntimeError("injected loop error")
        eng._admit = boom
        s = eng.submit(_prompt(50, 4), max_new_tokens=3)
        assert len(s.result(timeout=TIMEOUT)) >= 1
        assert events.get("gen.loop_errors") == errors + 1
        assert events.get("blackbox.dumps") == dumps + 1
        assert ("fault", "gen.loop") in [
            (e["kind"], e["name"]) for e in flightrec.ring_snapshot()]
    finally:
        eng.close()
