"""PyTorch port: the admission and telemetry pieces that generation serving
copies from the JAX package, held against the JAX ones on the same inputs.

`_LaneQueue` (strict priority across lanes, earliest deadline first within
one, lane quotas, `evict_lowest`), `_parse_lanes`, `_parse_lane_quotas`,
`_parse_prompt_buckets`, `config.serve_lane_quota_fractions`, the
`monitor.events` percentiles (plain and labeled), the fault plan and its
firing sequence, and `retry_transient`.  Pure host code: no model, no
device.
"""
import queue
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import config as jcfg
from incubator_mxnet_tpu import fault as jfault
from incubator_mxnet_tpu.monitor import EventCounters as JaxCounters
from incubator_mxnet_tpu.parallel.resilience import \
    retry_transient as jax_retry
from incubator_mxnet_tpu.serving import engine as jengine
from incubator_mxnet_tpu.serving.generation import \
    _parse_prompt_buckets as jax_prompt_buckets
from incubator_mxnet_tpu_torch import config as tcfg
from incubator_mxnet_tpu_torch import fault as tfault
from incubator_mxnet_tpu_torch.monitor import EventCounters as PortCounters
from incubator_mxnet_tpu_torch.parallel.resilience import \
    retry_transient as port_retry
from incubator_mxnet_tpu_torch.serving import engine as tengine
from incubator_mxnet_tpu_torch.serving.generation import \
    _parse_prompt_buckets as port_prompt_buckets

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)


class _Req:
    """What `_LaneQueue` reads of a request."""

    def __init__(self, rid, lane, deadline):
        self.rid, self.lane, self.deadline = rid, lane, deadline
        self.future = Future()
        self.n = 1


def _script(seed, n=120):
    """A put / get / evict sequence over three lanes."""
    rs = np.random.RandomState(seed)
    ops = []
    for i in range(n):
        r = rs.rand()
        if r < 0.6:
            lane = ("hi", "mid", "lo")[rs.randint(3)]
            dl = None if rs.rand() < 0.3 else float(rs.randint(0, 20))
            ops.append(("put", i, lane, dl))
        elif r < 0.85:
            ops.append(("get",))
        elif r < 0.95:
            ops.append(("evict", ("hi", "mid", "lo")[rs.randint(2)]))
        else:
            ops.append(("done",))
    return ops


def _drive(mod, ops, cap, quotas):
    """Run `ops` against `mod`'s _LaneQueue; the observable trace."""
    lanes = mod._parse_lanes("hi,mid,lo")
    q = mod._LaneQueue(cap, lanes, mod._parse_lane_quotas(quotas, lanes,
                                                          cap))
    trace = []
    for op in ops:
        if op[0] == "put":
            try:
                q.put_nowait(_Req(op[1], op[2], op[3]))
                trace.append(("put", op[1]))
            except mod._OverQuota as e:
                trace.append(("over", e.lane, e.depth, e.cap))
            except queue.Full:
                trace.append(("full", op[1]))
        elif op[0] == "get":
            try:
                trace.append(("got", q.get_nowait().rid))
            except queue.Empty:
                trace.append(("empty",))
        elif op[0] == "evict":
            v = q.evict_lowest(op[1])
            trace.append(("evicted", None if v is None else v.rid))
        elif q.unfinished_tasks:
            q.task_done()
        trace.append((q.qsize(), q.unfinished_tasks,
                      tuple(sorted(q.lane_depths().items()))))
    while True:             # what is left comes out in the same order
        try:
            trace.append(("drain", q.get(timeout=0).rid))
        except queue.Empty:
            break
    return trace


@pytest.mark.parametrize("seed,cap,quotas", [
    (0, 16, ""), (1, 8, "1.0,0.5,0.25"), (2, 40, "1,1,1"), (3, 6, "0.5"),
])
def test_lane_queue_matches_jax(seed, cap, quotas):
    ops = _script(seed)
    assert _drive(tengine, ops, cap, quotas) == \
        _drive(jengine, ops, cap, quotas)


def test_lane_queue_task_done_below_zero_raises_as_in_jax():
    for mod in (tengine, jengine):
        q = mod._LaneQueue(4, ("a",), {"a": None})
        with pytest.raises(ValueError, match="too many times"):
            q.task_done()


@pytest.mark.parametrize("spec", [
    "high,normal,low", ["hi", "lo"], "a, b ,a,c", ("x",), " only ",
])
def test_parse_lanes_matches_jax(spec):
    assert tengine._parse_lanes(spec) == jengine._parse_lanes(spec)


@pytest.mark.parametrize("spec", ["", ",", None, []])
def test_parse_lanes_refuses_empty_as_jax(spec):
    for mod in (tengine, jengine):
        with pytest.raises(ValueError, match="empty"):
            mod._parse_lanes(spec)


@pytest.mark.parametrize("spec,n,cap", [
    ("", 3, 256), ("", 6, 10), ("1.0,0.5", 2, 256), ((1.0, 0.5), 2, 256),
    ("0.9", 3, 7), ([2.0, 0.01], 2, 100), ("1,0.75,0.5,0.25", 4, 1),
])
def test_lane_quotas_match_jax(spec, n, cap):
    lanes = tuple("l%d" % i for i in range(n))
    assert tengine._parse_lane_quotas(spec, lanes, cap) == \
        jengine._parse_lane_quotas(spec, lanes, cap)
    assert tcfg.serve_lane_quota_fractions(spec, n) == \
        jcfg.serve_lane_quota_fractions(spec, n)


@pytest.mark.parametrize("spec", ["0.5,0", "-1", [0.0]])
def test_lane_quotas_refuse_as_jax(spec):
    for cfg in (tcfg, jcfg):
        with pytest.raises(ValueError, match="positive fractions"):
            cfg.serve_lane_quota_fractions(spec, 2)


@pytest.mark.parametrize("spec,max_len", [
    ("", 128), ("", 16), ("", 5), ((16, 32, 64, 128), 128), ("4,8", 16),
    ([8, 4, 8], 16), ("3", 2),
])
def test_prompt_buckets_match_jax(spec, max_len):
    assert port_prompt_buckets(spec, max_len) == \
        jax_prompt_buckets(spec, max_len)


def _fill(counters, seed):
    rs = np.random.RandomState(seed)
    for x in rs.exponential(1000.0, 700):
        counters.observe("gen.ttft_us", float(x))
    for i, x in enumerate(rs.exponential(50.0, 500)):
        counters.observe("gen.ttft_us", int(x),
                         labels={"lane": ("hi", "lo")[i % 2]})
        counters.observe_time("gen.intertoken_us", x / 1e6,
                              labels={"lane": "hi"})
    for i in range(70):     # more labelsets than kept: the overflow set
        counters.incr("gen.shed", labels={"tenant": "t%d" % i})
    counters.add_time("gen.prefill_us", 0.25)
    counters.incr("gen.tokens", 7)


@pytest.mark.parametrize("pcts", [(50, 90, 99), (50, 99), (1, 25, 99.9)])
def test_event_percentiles_match_jax(pcts):
    port, ref = PortCounters(), JaxCounters()
    _fill(port, 3)
    _fill(ref, 3)
    assert port.percentiles("gen.ttft_us", pcts) == \
        ref.percentiles("gen.ttft_us", pcts)
    assert port.labeled_percentiles("gen.ttft_us", pcts) == \
        ref.labeled_percentiles("gen.ttft_us", pcts)
    assert port.latency_snapshot("gen.", pcts) == \
        ref.latency_snapshot("gen.", pcts)
    assert port.labeled_latency_snapshot("gen.", pcts) == \
        ref.labeled_latency_snapshot("gen.", pcts)
    assert port.snapshot() == ref.snapshot()
    assert port.labeled_snapshot() == ref.labeled_snapshot()
    assert port.percentiles("missing") == ref.percentiles("missing") == {}


@pytest.mark.parametrize("spec", [
    "serve.infer@3;serve.enqueue#2x3", "serve.decode_slow#1~0.2",
    " serve.oom@0 ; ;serve.infer#4x2~0.01", "",
])
def test_fault_plan_parsing_matches_jax(spec):
    assert tfault._parse_spec(spec) == jfault._parse_spec(spec)


@pytest.mark.parametrize("spec", ["serve.infer", "@3", "x#"])
def test_fault_plan_refuses_as_jax(spec):
    for mod in (tfault, jfault):
        with pytest.raises(ValueError):
            mod._parse_spec(spec)


def _firings(mod, plan):
    """Which of 12 calls of each site fire under `plan`."""
    mod.clear()
    try:
        for kw in plan:
            mod.install(**kw)
        out = [(site, step, mod.should_fire(site, step))
               for step in range(12)
               for site in ("serve.infer", "serve.enqueue")]
        return out, {s: mod.fired_count(s)
                     for s in ("serve.infer", "serve.enqueue")}
    finally:
        mod.clear()


@pytest.mark.parametrize("plan", [
    [dict(site="serve.infer", steps=[3, 5])],
    [dict(site="serve.enqueue", at_calls=[2], times=3)],
    [dict(site="serve.enqueue", at_calls=[1, 4]),
     dict(site="serve.infer", steps=range(12), times=2)],
    [dict(site="serve.infer")],
])
def test_fault_firings_match_jax(plan):
    assert _firings(tfault, plan) == _firings(jfault, plan)


def test_fault_plan_from_config(monkeypatch):
    monkeypatch.setenv("MXNET_FAULT_PLAN", "serve.infer@1;serve.enqueue#2")
    try:
        assert tfault.reset_from_config() == jfault.reset_from_config() \
            == ["serve.enqueue", "serve.infer"]
        for mod in (tfault, jfault):
            with pytest.raises(mod.TransientFault, match="serve.infer"):
                mod.maybe_raise("serve.infer", step=1)
    finally:
        tfault.clear()
        jfault.clear()


@pytest.mark.parametrize("fails,retries", [(0, 3), (2, 3), (4, 3)])
def test_retry_transient_matches_jax(fails, retries):
    def attempts(retry, mod):
        calls = []

        def fn():
            calls.append(1)
            if len(calls) <= fails:
                raise mod.TransientFault("blip %d" % len(calls))
            return len(calls)
        try:
            out = retry(fn, retries=retries, backoff=0.0, jitter=False,
                        event="test.retries")
        except mod.TransientFault as e:
            out = "raised: %s" % e
        return out, len(calls)
    assert attempts(port_retry, tfault) == attempts(jax_retry, jfault)
