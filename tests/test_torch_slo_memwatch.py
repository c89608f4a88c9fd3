"""PyTorch port: SLO rules, the memory observatory, the durable history
and the metrics exporter (`telemetry.slo`, `.memwatch`, `.history`,
`.export`) against the JAX package's, on the CPU.

The same synthetic counter and percentile series go into both packages'
`monitor.events` and the same rules are judged by both `slo.evaluate`
at the same fake times; the same sampler values and committed rows go
into both observatories.  Exact equality throughout: these are the same
integer counts and the same float formulas.
"""
import collections

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import config as jcfg
from incubator_mxnet_tpu.gluon.block import nameless_scope
from incubator_mxnet_tpu.models import transformer as jtr
from incubator_mxnet_tpu.monitor import EventCounters as JCounters
from incubator_mxnet_tpu.monitor import events as jevents
from incubator_mxnet_tpu.serving import generation as jgen
from incubator_mxnet_tpu.telemetry import export as jexport
from incubator_mxnet_tpu.telemetry import history as jhist
from incubator_mxnet_tpu.telemetry import memwatch as jmw
from incubator_mxnet_tpu.telemetry import slo as jslo
import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import config as tcfg
from incubator_mxnet_tpu_torch.monitor import EventCounters as TCounters
from incubator_mxnet_tpu_torch.monitor import events as tevents
from incubator_mxnet_tpu_torch.serving import generation as tgen
from incubator_mxnet_tpu_torch.telemetry import export as texport
from incubator_mxnet_tpu_torch.telemetry import history as thist
from incubator_mxnet_tpu_torch.telemetry import memwatch as tmw
from incubator_mxnet_tpu_torch.telemetry import slo as tslo

pytestmark = pytest.mark.torch_port

torch.set_num_threads(1)

BOTH = (("jax", jslo, jevents), ("port", tslo, tevents))


@pytest.fixture(autouse=True)
def isolated(tmp_path, monkeypatch):
    """No rules, no samples, dumps into tmp_path, in both packages."""
    monkeypatch.setenv("MXNET_BLACKBOX_DIR", str(tmp_path))
    for slo, mw in ((jslo, jmw), (tslo, tmw)):
        slo.clear_rules()
        mw.reset()
    yield
    for slo, mw in ((jslo, jmw), (tslo, tmw)):
        slo.clear_rules()
        mw.reset()


def _uniq(tag, i=0):
    """Series names of their own per test, so the process-wide counters
    of other tests never enter a window."""
    return "slotest.%s%d" % (tag, i)


def _judge(rules_of, feed, times):
    """Register `rules_of(slo)` in each package, then at each fake time
    feed both ledgers and evaluate; returns each package's transitions
    [(t, rule, firing)] and final active set."""
    out = {}
    for name, slo, events in BOTH:
        seen = []
        slo.register_action(lambda r, f, info, seen=seen:
                            seen.append((r, f)))
        for r in rules_of(slo):
            slo.register_rule(r)
        trans = []
        for k, t in enumerate(times):
            feed(events, k)
            n0 = len(seen)
            slo.evaluate(now=t)
            trans += [(t,) + x for x in seen[n0:]]
        out[name] = (trans, sorted(slo.active_alerts()))
        slo.clear_rules()
    assert out["jax"] == out["port"]
    return out["port"]


def test_threshold_rules_fire_and_clear_like_jax():
    cnt, lat = _uniq("errors"), _uniq("lat_us")
    vals = [10, 10, 500, 900, 20, 20, 20, 20]

    def feed(events, k):
        events.incr(cnt, 3 if k in (2, 3) else 0)
        for _ in range(30):
            events.observe(lat, vals[k], labels={"lane": "hi"})

    trans, active = _judge(lambda slo: [
        slo.ThresholdRule("thr-count", cnt, bound=4),
        slo.ThresholdRule("thr-p99", lat, bound=400, pct="p99",
                          labels={"lane": "hi"}),
        slo.ThresholdRule("thr-floor", cnt, bound=1, op=">=")],
        feed, [100.0 + k for k in range(len(vals))])
    assert ("thr-count", True) in [x[1:] for x in trans]
    assert ("thr-p99", True) in [x[1:] for x in trans]
    # the counter stays past its bound; the ring keeps the slow samples
    assert active == ["thr-count", "thr-p99"]


def test_burn_rate_rule_fires_and_clears_like_jax():
    bad, good = _uniq("shed"), _uniq("requests")
    # quiet, a sustained burn, then recovery
    sheds = [0, 0, 5, 5, 5, 5, 0, 0, 0, 0, 0, 0]

    def feed(events, k):
        events.incr(bad, sheds[k], labels={"lane": "lo"})
        events.incr(good, 10, labels={"lane": "lo"})

    trans, active = _judge(lambda slo: [slo.BurnRateRule(
        "burn", bad=bad, total=[good, bad], budget=0.1, fast_s=20,
        slow_s=60, labels={"lane": "lo"})], feed,
        [1000.0 + 10 * k for k in range(len(sheds))])
    assert [x[2] for x in trans] == [True, False]
    assert active == []


def test_anomaly_rule_against_history_like_jax(tmp_path, monkeypatch):
    series = _uniq("anom_us")
    base = [100, 104, 98, 101, 99, 103, 97, 102, 100, 101]
    for name, hist in (("jax", jhist), ("port", thist)):
        d = tmp_path / name
        w = hist.HistoryWriter(directory=str(d), run="20200101T000000-p1")
        for i, v in enumerate(base):
            w.append("pct", series, v, ts=5000.0 + i, p99=v)
    vals = [100, 400, 100]

    def feed(events, k):
        for _ in range(20):
            events.observe(series, vals[k])

    out = {}
    for name, slo, events in BOTH:
        monkeypatch.setenv("MXNET_HISTORY_DIR", str(tmp_path / name))
        (jhist if name == "jax" else thist).reset()
        seen = []
        slo.register_action(lambda r, f, i, seen=seen: seen.append(f))
        slo.register_rule(slo.AnomalyRule("anom", series, sigma=4.0,
                                          baseline_s=1e6))
        for k in range(3):
            feed(events, k)
            slo.evaluate(now=6000.0 + k)
        out[name] = seen
        slo.clear_rules()
    assert out["jax"] == out["port"] == [True, False]


def test_drift_rules_like_jax():
    rows = [[{"tenant": "a", "device": "cpu:0", "committed_bytes": 100,
              "measured_bytes": 300, "source": "x"},
             {"tenant": "b", "device": "cpu:0", "committed_bytes": 100,
              "measured_bytes": 110, "source": "x"}],
            [{"tenant": "a", "device": "cpu:0", "committed_bytes": 300,
              "measured_bytes": 300, "source": "x"}]]
    out = {}
    for name, slo, _ in BOTH:
        state, rec = {"k": 0}, []
        rule = slo.MemDriftRule(
            rows_fn=lambda state=state: rows[state["k"]],
            reconcile_fn=lambda t, rec=rec: rec.append(t) or True)
        slo.register_rule(rule)
        slo.register_rule(slo.CostDriftRule("cost", "bucket_mb", "x"))
        seen = []
        slo.register_action(lambda r, f, i, seen=seen:
                            seen.append((r, f, i.get("ratio"),
                                         i.get("top"))))
        slo.evaluate(now=1.0)
        state["k"] = 1
        slo.evaluate(now=2.0)
        out[name] = (seen, rec)
        slo.clear_rules()
    assert out["jax"] == out["port"]
    assert [s[:2] for s in out["port"][0]] == [("mem-drift", True),
                                               ("mem-drift", False)]


def test_default_rules_match_jax():
    got = {}
    for name, slo, _ in BOTH:
        rules = (slo.default_serving_rules(
            targets={"hi": 0.05}, lanes=["hi", "lo"],
            quotas={"hi": 1.0, "lo": 0.5}, fast_s=10, slow_s=30)
            + slo.default_generation_rules(targets={"lo": 0.2})
            + slo.default_memwatch_rules(factor=2.0))
        got[name] = [(r.name, r.kind, getattr(r, "budget", None),
                      getattr(r, "bound", None), getattr(r, "labels", None),
                      getattr(r, "bad", None), getattr(r, "total", None),
                      r.description) for r in rules]
    assert got["jax"] == got["port"]


def test_generation_engine_installs_the_jax_rules():
    with nameless_scope():
        jmx.random.seed(0)
        jnet = jtr.transformer_nmt_small(23, 23, dropout=0.0)
        jnet.initialize(force_reinit=True)
        jnet(jmx.nd.array(np.ones((1, 4), np.int32)),
             jmx.nd.array(np.ones((1, 1), np.int32)))
    tnet = tmx.weights.load_reference_params(
        tmx.models.transformer_nmt_small(23, 23, dropout=0.0,
                                         device="cpu"),
        {n: p.data().asnumpy()
         for n, p in jnet._collect_params_with_prefix().items()})
    kw = dict(slots=2, max_len=16, prompt_buckets=(4, 8),
              lanes=("hi", "lo"), lane_quotas=(1.0, 0.5))
    jeng = jgen.GenerationEngine(jnet, 1, 2, **kw)
    teng = tgen.GenerationEngine(tnet, 1, 2, ctx="cpu", **kw)
    for eng in (jeng, teng):        # deadlines the hi lane has seen
        eng._lane_deadline_s["hi"] = collections.deque([0.25, 0.5])
    names = jeng.install_slo_rules(), teng.install_slo_rules()
    assert names[0] == names[1] == ["gen-shed-hi", "gen-ttft-p99-hi",
                                    "gen-shed-lo"]
    assert sorted(jslo.rules()) == sorted(tslo.rules())
    assert [tslo.rules()[n].budget for n in ("gen-shed-hi", "gen-shed-lo")] \
        == [jslo.rules()[n].budget for n in ("gen-shed-hi", "gen-shed-lo")]
    assert tslo.rules()["gen-ttft-p99-hi"].bound == \
        jslo.rules()["gen-ttft-p99-hi"].bound == 0.25e6
    jeng.close()
    teng.close()


# -- memwatch -----------------------------------------------------------
def test_memwatch_watermarks_attribution_like_jax(monkeypatch):
    readings = [{"cpu:0": 1000}, {"cpu:0": 3000}, {"cpu:0": 2000},
                {"cpu:0": 5000, "cpu:1": 700}]
    rows = [{"tenant": "m1", "device": "cpu:0", "committed_bytes": 1500},
            {"tenant": "m2", "device": "cpu(0)", "committed_bytes": 500}]
    got = {}
    for name, mw in (("jax", jmw), ("port", tmw)):
        monkeypatch.setitem((jcfg if name == "jax" else tcfg)._OVERRIDES,
                            "MXNET_MEMWATCH_MIN_S", "0")
        it = iter(readings)
        mw.set_sampler(lambda it=it: {
            d: {"used_bytes": b, "peak_bytes": b, "limit_bytes": 0,
                "source": "test"} for d, b in next(it).items()})
        mw.register_source("test", lambda: rows)
        mw.sample()
        with mw.phase("warmup"):
            mw.sample()
        mw.sample()
        with mw.phase("deploy"):
            pass
        att = [{k: r[k] for k in ("tenant", "device", "committed_bytes",
                                  "measured_bytes", "drift")}
               for r in mw.attribution()]
        got[name] = dict(
            marks=mw.watermarks(),
            committed=[{k: v for k, v in r.items()}
                       for r in mw.committed_rows()],
            attribution=att, top=mw.top_consumers(n=2),
            reconcile=mw.reconcile_tenant("m1"),
            samples=len(mw.samples()),
            fresh=sorted(mw.fresh_device_bytes()))
    assert got["jax"] == got["port"]
    assert got["port"]["marks"]["warmup"] == {"cpu:0": 3000}


def test_memwatch_estimates_cpu_devices_only(monkeypatch):
    # the held-tensor sum stands in for a CPU device's allocator; a card
    # missing from the allocator's statistics is left out, and a failed
    # read of them gives no sample
    from incubator_mxnet_tpu_torch import storage
    monkeypatch.setattr(tmw, "_registry_devices",
                        lambda: {"cpu:0", "cuda:0"})
    monkeypatch.setattr(tmw, "_held_by_device",
                        lambda: {"cpu:0": 123, "cuda:0": 456})
    monkeypatch.setattr(storage, "memory_events", lambda: [])
    smp = tmw.sample(force=True)
    assert smp["devices"] == {"cpu:0": {
        "used_bytes": 123, "peak_bytes": 123, "limit_bytes": 0,
        "source": "sources"}}

    def unreadable():
        raise RuntimeError("allocator statistics unavailable")

    monkeypatch.setattr(storage, "memory_events", unreadable)
    assert tmw.sample(force=True) is None


def test_is_oom_and_guard_like_jax():
    cases = [MemoryError("x"), RuntimeError("RESOURCE_EXHAUSTED: y"),
             RuntimeError("CUDA out of memory. Tried to allocate 2 GiB"),
             ValueError("shape mismatch"), None]
    assert [jmw.is_oom(e) for e in cases] == \
        [tmw.is_oom(e) for e in cases] == [True, True, True, False, False]
    assert tmw.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    oom0 = tevents.get("memwatch.oom")
    assert tmw.guard_oom("test", torch.cuda.OutOfMemoryError("boom"))
    assert not tmw.guard_oom("test", ValueError("no"))
    assert tevents.get("memwatch.oom") == oom0 + 1


# -- history and export --------------------------------------------------
def test_history_rows_and_queries_like_jax(tmp_path):
    got = {}
    for name, hist, counters in (("jax", jhist, JCounters),
                                 ("port", thist, TCounters)):
        w = hist.HistoryWriter(directory=str(tmp_path / name),
                               run="20200101T000000-p7", shard_kb=1)
        for i in range(60):
            w.append("marker", "ckpt", 1.0, labels={"i": str(i % 3)},
                     ts=100.0 + i, step=i)
        rows = hist.query("ckpt", labels={"i": "1"},
                          directory=str(tmp_path / name))
        got[name] = dict(
            rows=[(r["name"], r["v"], r["labels"], r["step"]) for r in rows],
            runs=hist.runs(directory=str(tmp_path / name)),
            limited=len(hist.query(directory=str(tmp_path / name),
                                   limit=5)))
    assert got["jax"] == got["port"]
    assert len(got["port"]["rows"]) < 20        # compacted under 1 KB


def _feed_ledger(c):
    c.incr("serve.requests", 7)
    c.incr("serve.shed", 2, labels={"lane": "lo", "reason": "quota"})
    c.incr("serve.requests", 3, labels={"lane": "hi"})
    for v in (120, 80, 4000, 95, 310):
        c.observe_time("serve.e2e_us", v / 1e6)
        c.observe("serve.e2e_us", v, labels={"lane": "hi"})
    c.observe("gen.ttft_us", 12.5)
    c.incr('odd"name', 1, labels={"q": 'a"b\\c'})


def test_prometheus_text_like_jax(tmp_path):
    jc, tc = JCounters(), TCounters()
    _feed_ledger(jc)
    _feed_ledger(tc)
    jtext = jexport.MetricsExporter(counters=jc).prometheus_text()
    ttext = texport.MetricsExporter(counters=tc).prometheus_text()
    assert sorted(ttext.splitlines()) == sorted(jtext.splitlines())
    exp = texport.MetricsExporter(counters=tc)
    path = exp.export_file(str(tmp_path / "m.prom"))
    assert open(path).read() == ttext
    js = exp.json_dict()
    assert js["counters"]["serve.requests"] == 7


def test_alert_gauge_renders_rules():
    tslo.register_rule(tslo.ThresholdRule(
        "gauge-rule", _uniq("gauge"), bound=0))
    tevents.incr(_uniq("gauge"), 1)
    tslo.evaluate(now=1.0)
    text = texport.MetricsExporter().prometheus_text()
    assert 'mxnet_alert_active{rule="gauge-rule"} 1' in text.splitlines()
    tslo.clear_rules()
    text = texport.MetricsExporter().prometheus_text()
    assert 'alert_active{rule="gauge-rule"}' not in text
