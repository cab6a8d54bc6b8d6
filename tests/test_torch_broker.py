"""The streaming broker of ``repro_torch`` on the CPU.

Broker answers are held against direct ``plan(batch)`` calls of the port
and against the JAX package's broker on the same ``make_trace``; the
shed policy, per-tenant cap growth and FIFO order through retries, the
growth budget, admission quotas and a ``run_bench`` smoke are covered.
``submit_select`` and a ``stream`` of lanes mixed with ``SelectQ`` items
(the trace of ``make_trace(select_frac=...)``) must answer as direct plan
calls do, while other tenants' lane traffic runs at the same time.
"""

import asyncio
import contextlib
import json
import time
from collections import Counter

import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core.query import ExecConfig as JExecConfig
from repro.launch import broker as jbroker
from repro.launch import serve as jserve
from repro_torch.core import engine as eng
from repro_torch.core.query import (
    AdmissionError, CapOverflow, ExecConfig, SelectQ, ServeQ, TriplePatternQ,
)
from repro_torch.data import rdf
from repro_torch.launch import serve
from repro_torch.launch.broker import (
    CoalescePolicy, QueueFull, ServeBroker, TenantPolicy, tail_percentile,
)
from repro_torch.obs import validate
from test_torch_select import same_columns, to_jax
from test_torch_store import build_pair

CPU = ExecConfig(cap=64, device="cpu")


def same_answer(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    if isinstance(a, (bool, np.bool_)):
        return bool(a) == bool(b)
    return np.array_equal(np.asarray(a), np.asarray(b))


def _trace_ds(name):
    st, jst, ids = build_pair(name)
    ds = rdf.RdfDataset(ids=ids, n_so=st.n_so, n_subjects=st.n_subjects,
                        n_objects=st.n_objects, n_preds=st.n_preds)
    return st, jst, ds


async def _serve(broker, trace):
    async with broker:
        return await serve._replay(broker, trace)


def test_broker_matches_direct_plan_and_jax_broker():
    st, jst, ds = _trace_ds("preds16")
    trace = serve.make_trace(ds, 160, 4, seed=3)
    assert trace == jserve.make_trace(ds, 160, 4, seed=3)
    e = eng.Engine(st, device="cpu")
    pol = CoalescePolicy(max_batch=32, max_delay_s=1e-3)
    got = asyncio.run(_serve(ServeBroker(e, CPU, coalesce=pol), trace))

    # direct plan(batch) over the whole trace
    lanes = np.array([row[1:] for row in trace], np.int32).T
    r = eng.host_result(e.compile(ServeQ(), CPU)(eng.ServeBatch(*lanes)))
    for i, row in enumerate(trace):
        assert same_answer(got[i], eng.decode_lane(row[1], r, i)), i

    # the JAX broker (jnp reference path) on the same trace
    jcfg = JExecConfig(backend="jnp", interpret=True, cap=64)
    jb = jbroker.ServeBroker(jeng.Engine(jst), jcfg, coalesce=jbroker.CoalescePolicy(
        max_batch=32, max_delay_s=1e-3))

    async def jrun():
        async with jb:
            return await asyncio.gather(*(jb.submit(t, *rest) for t, *rest in trace))

    want = asyncio.run(jrun())
    for i in range(len(trace)):
        assert same_answer(got[i], want[i]), i


def _hot_row(ids):
    (s, p), n = Counter(map(tuple, ids[:, :2].tolist())).most_common(1)[0]
    return s, p, n


def test_per_tenant_growth_keeps_fifo_and_base_cap():
    st, _, ds = _trace_ds("preds16")
    s, p, n = _hot_row(ds.ids)
    assert n > 2
    e = eng.Engine(st, device="cpu")
    cfg = ExecConfig(cap=2, device="cpu")
    truth = np.sort(ds.ids[(ds.ids[:, 0] == s) & (ds.ids[:, 1] == p), 2])
    light = [(eng.OP_CHECK, int(r[0]), int(r[1]), int(r[2])) for r in ds.ids[:12]]

    async def main():
        b = ServeBroker(e, cfg, coalesce=CoalescePolicy(max_batch=16, max_delay_s=5e-3))
        async with b:
            heavy = [b.submit_nowait("heavy", eng.OP_CHECK, *light[0][1:]),
                     b.submit_nowait("heavy", eng.OP_ROW, s, p),
                     b.submit_nowait("heavy", eng.OP_CHECK, *light[1][1:])]
            others = [b.submit_nowait("light", *q) for q in light]
            res = await asyncio.gather(*heavy, *others)
        return b, res

    b, res = asyncio.run(main())
    assert res[0] is True and res[2] is True
    assert np.array_equal(res[1], truth)
    assert all(r is True for r in res[3:])
    st_ = b.stats()
    assert st_["cap_growth_events"] >= 1
    assert st_["tenants"]["heavy"]["cap_level"] >= 1
    assert st_["tenants"]["light"]["cap_level"] == 0
    assert b.base_plan.effective_cap == 2


def test_growth_budget_and_admission_quota():
    st, _, ds = _trace_ds("preds16")
    s, p, _ = _hot_row(ds.ids)
    cfg = ExecConfig(cap=1, device="cpu")

    async def one(policy):
        # a fresh engine each time: plan-cache hits are never charged
        b = ServeBroker(eng.Engine(st, device="cpu"), cfg, tenant_policy=policy,
                        coalesce=CoalescePolicy(max_batch=8, max_delay_s=1e-3))
        async with b:
            fut = b.submit_nowait("t", eng.OP_ROW, s, p)
            try:
                await fut
            except (CapOverflow, AdmissionError) as exc:
                return b, exc
        return b, None

    b, exc = asyncio.run(one(TenantPolicy(max_cap_doublings=0)))
    assert isinstance(exc, CapOverflow) and b.stats()["tenants"]["t"]["failed"] == 1
    b, exc = asyncio.run(one(TenantPolicy(max_plans=0)))
    assert isinstance(exc, AdmissionError) and b.stats()["admission_denials"] == 1


def test_queue_full_sheds_newest():
    st, _, ds = _trace_ds("preds16")
    e = eng.Engine(st, device="cpu")

    async def main():
        b = ServeBroker(e, CPU, tenant_policy=TenantPolicy(queue_depth=3),
                        coalesce=CoalescePolicy(max_batch=64, max_delay_s=0.05))
        async with b:
            futs = [b.submit_nowait("a", eng.OP_CHECK, 1, 1, 1) for _ in range(3)]
            with pytest.raises(QueueFull):
                b.submit_nowait("a", eng.OP_CHECK, 1, 1, 1)
            other = b.submit_nowait("b", eng.OP_CHECK, 1, 1, 1)
            await asyncio.gather(*futs, other)
        with pytest.raises(RuntimeError):
            b.submit_nowait("a", eng.OP_CHECK, 1, 1, 1)
        return b.stats()

    stats = asyncio.run(main())
    assert stats["shed"] == 1 and stats["tenants"]["a"]["shed"] == 1
    assert stats["queries"] == 4 and stats["lanes"] == 4



def test_broker_refuses_ids_outside_int32_like_jax():
    """An id outside int32 stops both brokers' loops in ``_encode``, and
    leaving the context (``aclose``) re-raises the OverflowError."""
    st, jst, ids = build_pair("preds16")
    s, p = int(ids[0, 0]), int(ids[0, 1])

    async def run(b):
        async with b:
            b.submit_nowait("t", eng.OP_ROW, s, p)
            b.submit_nowait("t", eng.OP_ROW, s + 2**32, p)

    with pytest.raises(OverflowError):
        asyncio.run(run(ServeBroker(eng.Engine(st, device="cpu"), CPU)))
    jcfg = JExecConfig(backend="jnp", interpret=True, cap=64)
    with pytest.raises(OverflowError):
        asyncio.run(run(jbroker.ServeBroker(jeng.Engine(jst), jcfg)))

def test_tail_percentile_guard():
    assert tail_percentile([1.0], 50) is None
    assert tail_percentile(list(range(99)), 99) is None
    assert tail_percentile(list(range(100)), 99) == pytest.approx(98.01)
    with pytest.raises(ValueError):
        tail_percentile([1.0, 2.0], 100)


def test_run_bench_fast_cpu():
    row = serve.run_bench(device="cpu", n_triples=20_000, n_preds=16,
                          n_queries=256, max_batch=64, cap=256, warmup=32,
                          quiet=True)
    assert row["queries"] == 256 and row["qps"] > 0 and row["device"] == "cpu"
    assert row["p99_ms"] is not None and row["batches"] >= 4


def test_serve_trace_window_brackets_the_measured_run():
    """``serve_trace(window=...)`` enters its context manager once, after the
    warmup, and leaves it after the measured run's wall time is taken: a
    profiler there sees exactly the measured run."""
    st, _, ds = _trace_ds("preds16")
    trace = serve.make_trace(ds, 96, 4, select_frac=0.1, seed=6)
    seen = []

    @contextlib.contextmanager
    def window():
        seen.append(("enter", time.perf_counter()))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            yield
        seen.append(("exit", time.perf_counter(), prof))

    stats, answers, wall, _ = serve.serve_trace(
        eng.Engine(st, device="cpu"), trace, n_tenants=4, cap=64, max_batch=16, warmup=32,
        window=window)
    assert [e[0] for e in seen] == ["enter", "exit"]
    assert seen[1][1] - seen[0][1] >= wall > 0
    assert len(seen[1][2].events()) > 0
    assert stats["queries"] == len(trace) and all(a is not None for a in answers)


def test_mixed_stream_with_selects_matches_direct_plans():
    """A trace with 20% SELECTs (the JAX package's trace, draw for draw)
    through per-tenant streams: every lane equals the direct ``plan(batch)``
    answer and every SELECT the direct ``Engine.compile(SelectQ)()`` one,
    with the SELECT worker threads and the serve loop running together."""
    st, _, ds = _trace_ds("preds16")
    trace = serve.make_trace(ds, 160, 4, select_frac=0.2, seed=5)
    jtrace = jserve.make_trace(ds, 160, 4, select_frac=0.2, seed=5)
    assert [row[0] for row in trace] == [row[0] for row in jtrace]
    assert [to_jax(row[1]) if len(row) == 2 else row for row in trace] == [
        row[1] if len(row) == 2 else row for row in jtrace]
    n_sel = sum(len(row) == 2 for row in trace)
    assert 0 < n_sel < len(trace)
    e = eng.Engine(st, device="cpu")
    b = ServeBroker(e, CPU, coalesce=CoalescePolicy(max_batch=32, max_delay_s=1e-3))
    got = asyncio.run(_serve(b, trace))
    stats = b.stats()
    assert stats["selects"] == n_sel and stats["lanes"] == len(trace) - n_sel
    assert stats["queries"] == len(trace)
    plan = e.compile(ServeQ(), CPU)
    for i, row in enumerate(trace):
        if len(row) == 2:
            same_columns(got[i], e.compile(row[1], CPU)())
        else:
            r = eng.host_result(plan(eng.ServeBatch(*np.array([row[1:]], np.int32).T)))
            assert same_answer(got[i], eng.decode_lane(row[1], r, 0)), i


def test_submit_select_concurrent_with_lanes():
    """``submit_select`` from several tenants while a heavy tenant streams
    lanes: SELECT answers equal direct plan calls and lanes their oracle."""
    st, _, ds = _trace_ds("preds16")
    e = eng.Engine(st, device="cpu")
    rows = ds.ids[np.random.default_rng(8).integers(0, ds.ids.shape[0], 40)]
    qs = [SelectQ(where=(TriplePatternQ(int(r[0]), int(r[1]), "?o"),),
                  optional=((TriplePatternQ("?o", "?p", "?z"),),), order_by=("-?o",), limit=5)
          for r in rows[:8]]
    lanes = [(eng.OP_CHECK, int(r[0]), int(r[1]), int(r[2])) for r in rows]

    async def main():
        async with ServeBroker(e, CPU, coalesce=CoalescePolicy(max_batch=8, max_delay_s=1e-3)) as b:
            heavy = [b.submit_nowait("lanes", *q) for q in lanes]
            sel = [b.submit_select(f"sel-{i % 3}", q) for i, q in enumerate(qs)]
            return await asyncio.gather(*heavy), await asyncio.gather(*sel), b.stats()

    got_lanes, got_sel, stats = asyncio.run(main())
    assert all(got_lanes)
    for g, q in zip(got_sel, qs):
        same_columns(g, e.compile(q, CPU)())
    assert stats["selects"] == len(qs) and stats["tenants"]["sel-0"]["queries"] == 3


def test_select_budget_and_admission_quota():
    """A SELECT that overflows its cap fails with ``CapOverflow`` once the
    tenant's doubling budget is spent, and a tenant with no plan quota gets
    ``AdmissionError`` (counted), as lane retries do."""
    st, _, ds = _trace_ds("preds16")
    s, p, _ = _hot_row(ds.ids)
    q = SelectQ(where=(TriplePatternQ(s, p, "?o"),))

    async def one(policy):
        b = ServeBroker(eng.Engine(st, device="cpu"), ExecConfig(cap=1, device="cpu"),
                        tenant_policy=policy)
        async with b:
            try:
                await b.submit_select("t", q)
            except (CapOverflow, AdmissionError) as exc:
                return b, exc
        return b, None

    b, exc = asyncio.run(one(TenantPolicy(max_cap_doublings=0)))
    assert isinstance(exc, CapOverflow) and b.stats()["tenants"]["t"]["failed"] == 1
    b, exc = asyncio.run(one(TenantPolicy(max_plans=0)))
    assert isinstance(exc, AdmissionError) and b.stats()["admission_denials"] == 1
    b, exc = asyncio.run(one(TenantPolicy()))
    assert exc is None and b.stats()["tenants"]["t"]["queries"] == 1


def test_run_bench_select_frac_exports_valid_trace(tmp_path):
    trace_path, metrics_path = tmp_path / "t.json", tmp_path / "m.json"
    row = serve.run_bench(device="cpu", n_triples=20_000, n_preds=16, n_queries=256,
                          max_batch=64, cap=256, warmup=32, select_frac=0.05, quiet=True,
                          trace_path=str(trace_path), metrics_path=str(metrics_path))
    assert row["selects"] > 0 and row["obs"] and row["queries"] == 256
    assert validate.main([str(trace_path), "--require-queries"]) == 0
    doc = json.loads(metrics_path.read_text())
    assert doc["cost_profiles"]["base"]["geometry"]["padded_lanes"] == 64
    assert doc["broker"]["broker.selects"]["value"] == row["selects"]
    assert "broker_selects" in doc["prometheus"]
