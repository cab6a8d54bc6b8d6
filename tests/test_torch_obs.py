"""The observability layer of ``repro_torch``: the port's counterparts of
``tests/test_obs.py``.

* Metrics, tracer, Chrome export and trace validation, each also held
  against the JAX package's ``repro.obs`` on the same inputs (bucket
  bounds, Prometheus text, validator verdicts).
* **Disabled is free**: with observability off, plan calls (``ServeQ``,
  ``SelectQ``, a D–F join), the planner and a broker roundtrip with SELECTs
  make no tracer or obs-registry call (a tripwire).  The broker's always-on
  ``stats()`` counters are the documented exemption.
* **Enabled is consistent**: a traced broker run with lanes and SELECTs
  returns the answers of direct plan calls, its Chrome trace covers every
  query and passes ``validate_chrome_trace(require_queries=True)``, and
  the metrics agree with ``stats()``.
* ``Plan.cost_profile`` geometry and launch counts on the CPU.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.obs import metrics as jmetrics
from repro.obs import validate as jvalidate
from repro_torch import obs
from repro_torch.core import engine as eng, k2triples
from repro_torch.core.query import (
    AdmissionError, ExecConfig, JoinQ, ObsConfig, SelectQ, ServeQ, TriplePatternQ,
)
from repro_torch.data import rdf
from repro_torch.launch.broker import CoalescePolicy, ServeBroker
from repro_torch.obs import validate
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry, log_buckets
from repro_torch.obs.trace import NOOP_SPAN, Tracer
from repro_torch.obs.validate import validate_chrome_trace

CFG = ExecConfig(cap=256, device="cpu")


@pytest.fixture(autouse=True)
def _obs_off_after():
    """Observability is process-global state: never leak it across tests."""
    yield
    obs.disable()


@pytest.fixture(scope="module")
def store_and_truth():
    ds = rdf.generate(2500, n_subjects=50, n_preds=12, n_objects=70,
                      preds_per_subject=3, seed=17)
    store = k2triples.from_id_triples(
        ds.ids, n_so=ds.n_so, n_subjects=ds.n_subjects,
        n_objects=ds.n_objects, n_preds=ds.n_preds, device="cpu",
    )
    return store, set(map(tuple, ds.ids.tolist())), ds


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo,hi,per", [(1e-3, 1e3, 1), (1.0, 10.0, 3), (1e-6, 1e3, 3), (1e-3, 1e5, 3)])
def test_log_buckets_like_jax(lo, hi, per):
    b = log_buckets(lo, hi, per_decade=per)
    assert b == jmetrics.log_buckets(lo, hi, per_decade=per)
    assert list(b) == sorted(b) and b[0] <= lo and b[-1] >= hi
    with pytest.raises(ValueError):
        log_buckets(hi, lo)
    with pytest.raises(ValueError):
        log_buckets(lo, hi, per_decade=0)
    assert obs.LATENCY_MS_BUCKETS == jobs.LATENCY_MS_BUCKETS
    assert obs.DEFAULT_BUCKETS == jobs.DEFAULT_BUCKETS


def test_counter_gauge_roundtrip():
    reg = MetricsRegistry()
    c = reg.counter("x.count")
    c.inc()
    c.inc(4)
    assert c.value == 5 and reg.counter("x.count") is c
    g = reg.gauge("x.level")
    g.set(2.5)
    assert g.value == 2.5
    reg.reset()
    assert c.value == 0 and g.value == 0.0
    with pytest.raises(TypeError):
        reg.gauge("x.count")


def test_histogram_buckets_and_percentile():
    reg = MetricsRegistry()
    h = reg.histogram("lat", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 5.0, 50.0, 500.0):
        h.observe(v)
    assert h.count == 5 and h.sum == pytest.approx(560.5)
    snap = h._snapshot()
    assert snap["buckets"] == {"1.0": 1, "10.0": 2, "100.0": 1, "+Inf": 1}
    assert snap["min"] == 0.5 and snap["max"] == 500.0
    assert 1.0 <= h.percentile(50) <= 10.0 and h.percentile(100) == 500.0
    assert Histogram("e", (1.0,), reg._lock).percentile(50) is None
    with pytest.raises(ValueError):
        h.percentile(101)
    reg.reset()
    assert h.count == 0 and h._snapshot()["buckets"] == {}


def test_prometheus_and_snapshot_like_jax():
    regs = (MetricsRegistry(), jmetrics.MetricsRegistry())
    for reg in regs:
        reg.counter("broker.batches").inc(3)
        reg.gauge("queue.depth").set(7)
        reg.gauge("occ").set(0.25)
        h = reg.histogram("lat.ms", buckets=(1.0, 10.0))
        h.observe(0.5)
        h.observe(20.0)
    text = regs[0].to_prometheus()
    assert text == regs[1].to_prometheus()
    assert regs[0].snapshot() == regs[1].snapshot()
    assert "# TYPE broker_batches counter\nbroker_batches 3" in text
    assert 'lat_ms_bucket{le="+Inf"} 2' in text and "lat_ms_count 2" in text
    assert MetricsRegistry().to_prometheus() == ""


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_tracer_span_and_chrome_export():
    t = Tracer(capacity=64)
    with t.span("outer", cat="test", k=1):
        with t.span("inner"):
            pass
    t.instant("mark", note="hi")
    ev = t.events()
    assert [e["name"] for e in ev] == ["inner", "outer", "mark"]
    assert ev[1]["t0"] <= ev[0]["t0"] and ev[1]["t1"] >= ev[0]["t1"]
    ch = t.to_chrome(metadata={"run": "unit", "obj": object()})
    assert ch["otherData"]["run"] == "unit" and isinstance(ch["otherData"]["obj"], str)
    assert validate_chrome_trace(ch) == [] == jvalidate.validate_chrome_trace(ch)
    assert {"outer", "inner", "mark", "thread_name"} <= {e["name"] for e in ch["traceEvents"]}
    json.dumps(ch)


def test_tracer_error_annotation():
    t = Tracer(capacity=8)
    with pytest.raises(RuntimeError):
        with t.span("boom"):
            raise RuntimeError("x")
    (ev,) = t.events()
    assert ev["args"]["error"] == "RuntimeError"


def test_tracer_retroactive_and_async():
    t = Tracer(capacity=64)
    n0 = t.now()
    t.add("batch", n0, n0 + 1000, tid="batch-slot-0", cat="broker", bid=0)
    t.add_async("query", 7, n0, n0 + 500, tenant="a")
    t.add_async("queue", 7, n0, n0 + 100)
    ch = t.to_chrome()
    assert validate_chrome_trace(ch) == []
    b_events = [e for e in ch["traceEvents"] if e.get("ph") == "b"]
    e_events = [e for e in ch["traceEvents"] if e.get("ph") == "e"]
    assert len(b_events) == len(e_events) == 2 and all(e["id"] == "7" for e in b_events)
    meta = [e for e in ch["traceEvents"] if e.get("ph") == "M"]
    assert any(e["args"]["name"] == "batch-slot-0" for e in meta)


def test_tracer_ring_drops_oldest():
    t = Tracer(capacity=4)
    for i in range(10):
        t.add(f"s{i}", i, i + 1)
    assert t.dropped == 6
    assert [e["name"] for e in t.events()] == ["s6", "s7", "s8", "s9"]
    assert t.to_chrome()["droppedSpans"] == 6
    t.clear()
    assert t.dropped == 0 and t.events() == []
    with pytest.raises(ValueError):
        Tracer(capacity=0)
    with pytest.raises(ValueError):
        ObsConfig(trace_capacity=0)


def test_noop_span_and_enable_disable():
    assert obs.span("anything", k=1) is NOOP_SPAN
    with NOOP_SPAN as s:
        assert s is NOOP_SPAN
    assert not obs.enabled()
    tracer, metrics = obs.enable(ObsConfig(trace=False))
    assert tracer is None and isinstance(metrics, MetricsRegistry) and obs.enabled()
    tracer, metrics = obs.enable()
    assert isinstance(tracer, Tracer) and obs.STATE.tracer is tracer
    assert obs.span("x") is not NOOP_SPAN
    obs.disable()
    assert not obs.enabled() and obs.STATE.metrics is None


def test_annotations_bridge_to_torch_profiler():
    """``device_annotations`` wraps live spans in ``record_function``: a
    torch profile of the same run carries the span names."""
    tracer, _ = obs.enable(ObsConfig(device_annotations=True))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.span("planner.probe"):
            torch.ones(4).sum()
    assert any(e.key == "planner.probe" for e in prof.key_averages())
    assert [e["name"] for e in tracer.events()] == ["planner.probe"]


def test_provenance_reports_torch_not_jax():
    p = obs.provenance()
    assert p["torch_version"] == torch.__version__ and p["cuda_version"] == torch.version.cuda
    assert "git_sha" in p and "utc" in p and "device_kind" in p and "device_count" in p
    assert not any("jax" in k for k in p)
    json.dumps(p)


# ---------------------------------------------------------------------------
# trace validation
# ---------------------------------------------------------------------------

_BAD = {
    "empty_object": {},
    "no_events": {"traceEvents": []},
    "negative_dur": {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "dur": -1, "pid": 1, "tid": 1}]},
    "overlap": {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0, "dur": 10, "pid": 1, "tid": 1},
        {"name": "b", "ph": "X", "ts": 5, "dur": 10, "pid": 1, "tid": 1}]},
    "unbalanced": {"traceEvents": [
        {"name": "q", "ph": "b", "ts": 0, "cat": "query", "id": "1", "pid": 1, "tid": 0}]},
    "no_ts": {"traceEvents": [{"name": "a", "ph": "X", "dur": 1}]},
    "bad_phase": {"traceEvents": [{"name": "a", "ph": "Z", "ts": 0}]},
    "e_without_b": {"traceEvents": [{"name": "q", "ph": "e", "ts": 0, "cat": "c", "id": "1"}]},
}
_OK = {"traceEvents": [
    {"name": "a", "ph": "X", "ts": 0, "dur": 10, "pid": 1, "tid": 1},
    {"name": "b", "ph": "X", "ts": 2, "dur": 3, "pid": 1, "tid": 1}]}


@pytest.mark.parametrize("name", sorted(_BAD))
def test_validate_rejects_malformed_like_jax(name):
    got = validate_chrome_trace(_BAD[name])
    assert got and got == jvalidate.validate_chrome_trace(_BAD[name])


def test_validate_cli(tmp_path):
    assert validate_chrome_trace(_OK) == []
    assert any("query" in p for p in validate_chrome_trace(_OK, require_queries=True))
    good, bad = tmp_path / "ok.json", tmp_path / "bad.json"
    good.write_text(json.dumps(_OK))
    bad.write_text(json.dumps(_BAD["overlap"]))
    assert validate.main([str(good)]) == 0
    assert validate.main([str(good), "--require-queries"]) == 1
    assert validate.main([str(bad)]) == 1
    assert validate.main([]) == 2


# ---------------------------------------------------------------------------
# cost profiles
# ---------------------------------------------------------------------------


def test_cost_profile_geometry_and_launches_on_cpu(store_and_truth):
    store, _, ds = store_and_truth
    E = eng.Engine(store, device="cpu")
    plan = E.compile(ServeQ(unbounded=False), CFG.replace(cap=64))
    prof = plan.cost_profile()
    assert prof["geometry"] == {"lanes": 8, "padded_lanes": 8, "cap": 64, "u_width": 0,
                                "unbounded": False, "layout": None, "device": "cpu",
                                "sharded": False, "mesh": None}
    # the plain versions run on the CPU: no kernel launches, no device time
    assert prof["launches"] and not any(prof["launches"].values())
    assert "device_ms" not in prof and "cpu" in prof["device_ms_error"]
    ub = E.compile(ServeQ(), CFG.replace(cap=64)).cost_profile(
        eng.ServeBatch(np.array([0, 1, 3, -1], np.int32), *(ds.ids[:4].T.astype(np.int32))))
    assert ub["geometry"]["lanes"] == 3 and ub["geometry"]["padded_lanes"] == 4
    assert ub["geometry"]["u_width"] == store.pred_index.meta.max_degree
    assert ub["geometry"]["layout"] == "dac"
    with pytest.raises(NotImplementedError):
        E.compile(TriplePatternQ(1, 1, "?o"), CFG).cost_profile()
    with pytest.raises(NotImplementedError):
        E.compile(SelectQ(where=(TriplePatternQ("?s", 1, "?o"),)), CFG).cost_profile()


# ---------------------------------------------------------------------------
# the disabled-path tripwire
# ---------------------------------------------------------------------------


def _arm_tripwire(monkeypatch, *, counters=False):
    """Make every obs-layer recording surface raise.  ``Counter.inc`` stays
    unarmed unless asked: the broker's always-on ``stats()`` registry uses
    it whatever observability says."""

    def boom(name):
        def _(*a, **k):
            raise AssertionError(f"obs call {name} on the DISABLED path")
        return _

    for m in ("__init__", "begin", "end", "span", "add", "add_async", "instant", "_record"):
        monkeypatch.setattr(Tracer, m, boom(f"Tracer.{m}"))
    monkeypatch.setattr(Histogram, "observe", boom("Histogram.observe"))
    monkeypatch.setattr(Gauge, "set", boom("Gauge.set"))
    if counters:
        monkeypatch.setattr(Counter, "inc", boom("Counter.inc"))


def test_disabled_path_makes_no_obs_calls(monkeypatch, store_and_truth):
    """With observability off, ServeQ, SelectQ, BGP and join plan calls,
    fetches, decodes and plan compiles are obs-free (counters armed too)."""
    store, _, ds = store_and_truth
    E = eng.Engine(store, device="cpu")
    s, p, o = (int(v) for v in ds.ids[0])
    qb = eng.ServeBatch(np.full(8, eng.OP_CHECK, np.int32), *(ds.ids[:8].T.astype(np.int32)))
    sel = SelectQ(where=(TriplePatternQ(s, p, "?o"),),
                  optional=((TriplePatternQ("?o", "?q", "?z"),),), order_by=("?o",), limit=5)
    assert not obs.enabled()
    _arm_tripwire(monkeypatch, counters=True)
    plan = E.compile(ServeQ(unbounded=False), CFG)
    r = plan(qb)
    host = eng.host_result(plan.submit(qb), unbounded=False)
    assert eng.decode_lane(eng.OP_CHECK, host, 0) is True and bool(r.hit[0])
    assert len(E.compile(sel, CFG)()["?o"]) > 0
    assert E.compile(JoinQ("E", "s", "o", p1=p, c1=o), CFG)()
    with pytest.raises(AdmissionError):
        E.compile(TriplePatternQ(s, p, "?o"), CFG, admit=lambda k: False)


def test_disabled_path_broker_dispatch(monkeypatch, store_and_truth):
    """A broker roundtrip with lanes and SELECTs — enqueue, coalesce,
    dispatch, deliver, off-loop SELECT — is obs-free too (its bookkeeping
    counters excepted)."""
    store, _, ds = store_and_truth
    E = eng.Engine(store, device="cpu")
    s, p, _ = (int(v) for v in ds.ids[0])

    async def main():
        async with ServeBroker(E, CFG, unbounded=False,
                               coalesce=CoalescePolicy(max_batch=8, max_delay_s=0.002)) as b:
            _arm_tripwire(monkeypatch)
            futs = [b.submit_nowait("t", eng.OP_CHECK, *map(int, ds.ids[i])) for i in range(6)]
            futs.append(b.submit_select_nowait("t", SelectQ(where=(TriplePatternQ(s, p, "?o"),))))
            return await asyncio.gather(*futs)

    assert not obs.enabled()
    got = asyncio.run(main())
    assert all(got[:6]) and len(got[6]["?o"]) > 0


# ---------------------------------------------------------------------------
# enabled end-to-end: broker run under tracing + metrics
# ---------------------------------------------------------------------------


def _direct_truth(T, queries):
    out = []
    for op, s, p, o in queries:
        if op == eng.OP_CHECK:
            out.append((s, p, o) in T)
        elif op == eng.OP_ROW:
            out.append(sorted(oo for (ss, pp, oo) in T if ss == s and pp == p))
        else:
            out.append(sorted(ss for (ss, pp, oo) in T if pp == p and oo == o))
    return out


def test_enabled_broker_trace_covers_every_query(store_and_truth):
    store, T, ds = store_and_truth
    E = eng.Engine(store, device="cpu")
    tracer, metrics = obs.enable(ObsConfig())
    rng = np.random.default_rng(3)
    queries = []
    for i in rng.integers(0, len(ds.ids), 24):
        s, p, o = map(int, ds.ids[i])
        queries.append((int(rng.integers(0, 3)), s, p, o))
    selects = [SelectQ(where=(TriplePatternQ(q[1], q[2], "?o"),),
                       optional=((TriplePatternQ(q[1], 3, "?x"),),), order_by=("?o",), limit=16)
               for q in queries[:4]]

    async def main():
        async with ServeBroker(E, CFG, unbounded=False,
                               coalesce=CoalescePolicy(max_batch=8, max_delay_s=0.001)) as b:
            futs = [b.submit_nowait(f"t{i % 3}", *q) for i, q in enumerate(queries)]
            futs += [b.submit_select_nowait(f"t{i % 3}", q) for i, q in enumerate(selects)]
            got = await asyncio.gather(*futs)
            return b, got, b.stats()

    b, got, st = asyncio.run(main())
    for g, want in zip(got, _direct_truth(T, queries)):
        assert (g if isinstance(g, bool) else sorted(g)) == want
    for g, q in zip(got[len(queries):], selects):
        want = E.compile(q, CFG)()
        assert list(g) == list(want) and all(np.array_equal(g[k], want[k]) for k in want)

    ch = tracer.to_chrome(metadata=obs.provenance())
    assert validate_chrome_trace(ch, require_queries=True) == []
    assert jvalidate.validate_chrome_trace(ch, require_queries=True) == []
    per_query: dict = {}
    for e in ch["traceEvents"]:
        if e.get("ph") == "b":
            per_query.setdefault(e["id"], set()).add(e["name"])
    assert len(per_query) == len(queries) + len(selects)
    lanes = [names for names in per_query.values() if len(names) > 1]
    assert len(lanes) == len(queries)
    for names in lanes:
        assert {"query", "queue", "dispatch", "inflight", "fetch", "decode"} <= names
    names = {e["name"] for e in ch["traceEvents"] if e.get("ph") == "X"}
    assert {"broker.batch", "broker.select", "planner.order", "plan.submit", "plan.lanes",
            "engine.fetch", "plan.decode_lane", "engine.compile"} <= names
    batch_spans = [e for e in ch["traceEvents"] if e.get("ph") == "X" and e["name"] == "broker.batch"]
    assert len(batch_spans) == st["batches"]
    assert all(0 < e["args"]["occupancy"] <= 1 for e in batch_spans)

    snap = metrics.snapshot()
    assert snap["broker.query_latency_ms"]["count"] == st["queries"] == len(queries) + len(selects)
    assert snap["broker.batch_occupancy"]["count"] == st["batches"]
    book = b.metrics.snapshot()
    assert book["broker.batches"]["value"] == st["batches"]
    assert book["broker.lanes"]["value"] == st["lanes"] == len(queries)
    assert book["broker.selects"]["value"] == st["selects"] == len(selects)
    profiles = b.cost_profiles()
    assert profiles["base"]["geometry"]["cap"] == 256
    assert profiles["base"]["geometry"]["padded_lanes"] == 8


def test_serve_and_join_spans_split_host_and_device(store_and_truth):
    """A ``ServeQ`` call nests ``plan.dispatch`` and ``plan.sync`` in
    ``plan.call``; an E join adds ``plan.decode``."""
    store, _, ds = store_and_truth
    E = eng.Engine(store, device="cpu")
    s, p, o = (int(v) for v in ds.ids[0])
    tracer, _ = obs.enable()
    E.compile(ServeQ(), CFG)(eng.ServeBatch(*(np.array([[1, s, p, 0]], np.int32).T)))
    E.compile(JoinQ("E", "s", "o", p1=p, c1=o), CFG)()
    ev = tracer.events()
    calls = [e for e in ev if e["name"] == "plan.call"]
    assert len(calls) == 2 and calls[1]["args"]["category"] == "E"
    for call in calls:
        inner = [e["name"] for e in ev if e is not call and e["tid"] == call["tid"]
                 and call["t0"] <= e["t0"] and e["t1"] <= call["t1"]]
        assert {"plan.dispatch", "plan.sync"} <= set(inner)
    assert any(e["name"] == "plan.decode" for e in ev)


def test_engine_compile_metrics_absorb_plan_cache_stats(store_and_truth):
    store, _, _ = store_and_truth
    E = eng.Engine(store, device="cpu")
    tracer, metrics = obs.enable(ObsConfig(trace=True, metrics=True))
    cfg = CFG.replace(cap=128)
    q = ServeQ(unbounded=False)
    E.compile(q, cfg)
    E.compile(q, cfg)
    with pytest.raises(AdmissionError):
        E.compile(q, cfg.replace(cap=64), admit=lambda k: False)
    snap = metrics.snapshot()
    assert snap["engine.plan_cache.misses"]["value"] == 1
    assert snap["engine.plan_cache.hits"]["value"] == 1
    assert snap["engine.plan_cache.denied"]["value"] == 1
    assert E.plan_cache_stats == {"hits": 1, "misses": 1, "denied": 1, "size": 1}
    names = [e["name"] for e in tracer.events()]
    assert names.count("engine.compile") == 1 and "engine.admission_denied" in names


def test_cap_overflow_is_counted(store_and_truth):
    store, _, ds = store_and_truth
    E = eng.Engine(store, device="cpu")
    tracer, metrics = obs.enable()
    s, p = (int(v) for v in ds.ids[0, :2])
    E.compile(TriplePatternQ("?s", p, "?o"), CFG.replace(cap=64))({"p": [p]})
    assert metrics.snapshot()["plan.cap_overflow"]["value"] >= 1
    assert any(e["name"] == "plan.cap_overflow" for e in tracer.events())
