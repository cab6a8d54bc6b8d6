"""The broker's write path over a dynamic store, ``repro_torch`` against the
JAX package's broker on the same scripted traffic:

  * live inserts/deletes are visible to queries submitted after them, and
    every broker answer equals the JAX broker's and the truth set;
  * a write that trips ``CompactionPolicy`` starts a BACKGROUND compaction
    in a worker thread; reads keep flowing during the rebuild, the epoch
    swap lands once, and answers stay equal across it;
  * per-tenant ``max_writes`` budgets raise ``WriteBudgetExhausted`` and
    refill at compaction;
  * a failed compaction warns and counts; writes to a static store are
    refused; an out-of-band compaction refreshes the base plan.
"""

import asyncio

import numpy as np
import pytest

from repro.core import compaction as jcpt
from repro.core import delta as jdelta
from repro.core import engine as jeng
from repro.core.query import ExecConfig as JExecConfig
from repro.launch import broker as jbroker
from repro_torch.core import compaction as cpt
from repro_torch.core import delta
from repro_torch.core import engine as eng
from repro_torch.core.query import ExecConfig
from repro_torch.launch import broker as broker_mod
from repro_torch.launch.broker import (
    CoalescePolicy, ServeBroker, TenantPolicy, WriteBudgetExhausted,
)
from test_torch_broker import same_answer
from test_torch_dynamic import _stores

E_, P_ = 24, 3
CFG = ExecConfig(cap=64, device="cpu")
JCFG = JExecConfig(backend="jnp", interpret=True, cap=64)


def _engines(seed=11):
    st, jst, ids = _stores(seed, n=110, E=E_, P=P_)
    return (eng.Engine(delta.DynamicStore(st), device="cpu"),
            jeng.Engine(store=jdelta.DynamicStore(jst)), set(map(tuple, ids.tolist())))


def _script(rng, T, n, write_frac=0.5):
    """Writes (``ins``/``del``) and reads of ROW / S?? / CHECK lanes, with ids
    up to 2 past the extents; ``T`` tracks the truth as the script goes."""
    out = []
    for _ in range(n):
        roll = rng.random()
        if roll < write_frac / 2 and T:
            t = sorted(T)[int(rng.integers(len(T)))]
            out.append(("del", t))
            T.discard(t)
        elif roll < write_frac:
            t = (int(rng.integers(1, E_ + 3)), int(rng.integers(1, P_ + 2)),
                 int(rng.integers(1, E_ + 3)))
            out.append(("ins", t))
            T.add(t)
        else:
            s, p, o = (int(rng.integers(1, E_ + 3)), int(rng.integers(1, P_ + 2)),
                       int(rng.integers(1, E_ + 3)))
            op = (eng.OP_ROW, eng.OP_S_ANY_ANY, eng.OP_CHECK)[int(rng.integers(3))]
            lane = {eng.OP_ROW: (op, s, p, 0), eng.OP_S_ANY_ANY: (op, s, 0, 0),
                    eng.OP_CHECK: (op, s, p, o)}[op]
            out.append(("q", lane, _truth(T, lane)))
    return out


def _truth(T, lane):
    op, s, p, o = lane
    if op == eng.OP_ROW:
        return sorted(oo for (ss, pp, oo) in T if ss == s and pp == p)
    if op == eng.OP_CHECK:
        return (s, p, o) in T
    want = {}
    for (ss, pp, oo) in sorted(T):
        if ss == s:
            want.setdefault(pp, []).append(oo)
    return want


def _plain(ans):
    if isinstance(ans, dict):
        return {int(k): sorted(np.asarray(v).tolist()) for k, v in ans.items()}
    if isinstance(ans, (bool, np.bool_)):
        return bool(ans)
    return sorted(np.asarray(ans).tolist())


async def _play(b, script):
    """Run ``script`` through broker ``b`` (port or JAX); -> the answers."""
    out = []
    for kind, item, *_ in script:
        if kind == "ins":
            await b.submit_insert("w", *item)
        elif kind == "del":
            await b.submit_delete("w", *item)
        else:
            out.append(await b.submit("r", *item))
    return out


def _both(script, make, jmake):
    async def main(mk):
        async with mk() as b:
            got = await _play(b, script)
            task = b._compaction_task
            if task is not None:
                await task
            return got, b.stats()

    return asyncio.run(main(make)), asyncio.run(main(jmake))


def test_writes_require_dynamic_store():
    st, _, _ = _stores(0, n=20, E=8, P=2)
    e = eng.Engine(st, device="cpu")

    async def main():
        async with ServeBroker(e, CFG, unbounded=False) as b:
            with pytest.raises(TypeError, match="DynamicStore"):
                b.submit_insert_nowait("t", 1, 1, 1)
            with pytest.raises(TypeError, match="DynamicStore"):
                await b.submit_delete("t", 1, 1, 1)
        with pytest.raises(RuntimeError, match="not accepting"):
            b.submit_insert_nowait("t", 1, 1, 1)

    asyncio.run(main())
    with pytest.raises(ValueError):
        TenantPolicy(max_writes=0)


def test_write_read_differential_like_jax():
    """Interleaved writes and reads: every answer equals the JAX broker's
    on the same script and the truth set, delta-only rows and tombstoned
    static rows included."""
    e, je, T = _engines()
    script = _script(np.random.default_rng(5), T, 40)
    pol = dict(max_batch=16, max_delay_s=1e-3)
    (got, st), (want, jst) = _both(
        script,
        lambda: ServeBroker(e, CFG, coalesce=CoalescePolicy(**pol)),
        lambda: jbroker.ServeBroker(je, JCFG, coalesce=jbroker.CoalescePolicy(**pol)),
    )
    reads = [row[2] for row in script if row[0] == "q"]
    assert len(got) == len(want) == len(reads) > 10
    for g, w, t in zip(got, want, reads):
        assert same_answer(g, w) and _plain(g) == _plain(t)
    for k in ("inserts", "deletes", "delta_triples", "tombstones", "compactions"):
        assert st[k] == jst[k], k
    assert st["delta_triples"] == e.store.delta.n_inserts > 0
    assert st["tenants"]["w"]["writes_resident"] == jst["tenants"]["w"]["writes_resident"]


def test_compaction_under_traffic_like_jax():
    """A write trips the policy mid-stream; reads before, during and after
    the background rebuild answer as the JAX broker's and the truth, the
    swap lands exactly once, and the budget refills."""
    e, je, T = _engines()
    script = _script(np.random.default_rng(9), T, 40, write_frac=0.4)
    pol = dict(max_batch=8, max_delay_s=1e-3)
    (got, st), (want, jst) = _both(
        script,
        lambda: ServeBroker(e, CFG, coalesce=CoalescePolicy(**pol),
                            compaction=cpt.CompactionPolicy(max_delta=10)),
        lambda: jbroker.ServeBroker(je, JCFG, coalesce=jbroker.CoalescePolicy(**pol),
                                    compaction=jcpt.CompactionPolicy(max_delta=10)),
    )
    for g, w, (_, _, t) in zip(got, want, [r for r in script if r[0] == "q"]):
        assert same_answer(g, w) and _plain(g) == _plain(t)
    assert st["compactions"] >= 1 and st["compaction_ms"] > 0 and st["compaction_errors"] == 0
    assert e.store.epoch == st["compactions"]
    assert st["tenants"]["w"]["writes_resident"] < st["inserts"] + st["deletes"]
    # post-swap: the folded store answers every live triple
    async def after():
        async with ServeBroker(e, CFG) as b:
            return [await b.submit("r", eng.OP_CHECK, *t) for t in sorted(T)[:8]]

    assert all(asyncio.run(after()))


def test_compaction_failure_is_observed(monkeypatch):
    """A failing background compaction surfaces when its task ends — a
    ``compaction_errors`` count and a RuntimeWarning — and the broker keeps
    serving the old epoch and the live delta."""
    e, _, _ = _engines()

    def boom(store):
        raise RuntimeError("rebuild exploded")

    monkeypatch.setattr(broker_mod, "compact", boom)

    async def main():
        async with ServeBroker(e, CFG, compaction=cpt.CompactionPolicy(max_delta=2)) as b:
            with pytest.warns(RuntimeWarning, match="compaction failed"):
                await b.submit_insert("w", 1, 1, 1)
                await b.submit_insert("w", 1, 1, 2)  # trips the policy
                assert b._compaction_task is not None
                await asyncio.gather(b._compaction_task, return_exceptions=True)
                await asyncio.sleep(0)  # let the done callback land
            st = b.stats()
            assert st["compaction_errors"] == 1 and st["compactions"] == 0
            assert e.store.epoch == 0
            assert await b.submit("r", eng.OP_CHECK, 1, 1, 1)

    asyncio.run(main())


def test_write_budget_exhausts_and_refills():
    e, _, _ = _engines()

    async def main():
        async with ServeBroker(e, CFG, tenant_policy=TenantPolicy(max_writes=4)) as b:
            for i in range(4):
                await b.submit_insert("w", 1, 1, i + 1)
            with pytest.raises(WriteBudgetExhausted):
                await b.submit_insert("w", 1, 1, 9)
            with pytest.raises(WriteBudgetExhausted):
                await b.submit_delete("w", 1, 1, 1)
            await b.submit_insert("calm", 2, 2, 2)  # another tenant's budget
            assert b.stats()["tenants"]["w"]["writes_resident"] == 4
            rep = await asyncio.to_thread(cpt.compact, e.store)
            b._refresh_base_plan()
            for st in b._tenants.values():
                st.writes_resident = 0
            await b.submit_insert("w", 1, 1, 9)
            assert rep.epoch == 1
            b.reset_stats()
            st = b.stats()
            assert st["inserts"] == 0 and st["tenants"]["w"]["writes_resident"] == 1

    asyncio.run(main())


def test_stale_plan_lane_refreshes_transparently():
    """An out-of-band compaction swaps the store under the base plan; the
    next dispatch meets StaleEpoch, refreshes, and serves correctly."""
    e, je, T = _engines()

    async def main():
        async with ServeBroker(e, CFG, coalesce=CoalescePolicy(max_batch=4, max_delay_s=1e-3)) as b:
            t = sorted(T)[0]
            assert await b.submit("r", eng.OP_CHECK, *t)
            e.store.insert(E_ + 1, 1, 2)
            T.add((E_ + 1, 1, 2))
            cpt.compact(e.store)  # behind the broker's back
            assert e.store.epoch == 1
            assert await b.submit("r", eng.OP_CHECK, E_ + 1, 1, 2)
            got = await b.submit("r", eng.OP_ROW, s=t[0], p=t[1])
            assert _plain(got) == _truth(T, (eng.OP_ROW, t[0], t[1], 0))
            assert b.base_plan.submit(eng.ServeBatch(*np.zeros((4, 8), np.int32))) is not None

    asyncio.run(main())


def test_retry_lanes_merge_the_delta():
    """A lane that overflows the base cap is retried on a doubled-cap plan
    through the same sanitize+merge path: its delta inserts survive."""
    e, _, T = _engines()
    s = 1
    for o in range(1, E_ + 3):
        e.store.insert(s, 1, o)
        T.add((s, 1, o))
    small = ExecConfig(cap=4, device="cpu")

    async def main():
        async with ServeBroker(e, small, coalesce=CoalescePolicy(max_batch=4, max_delay_s=1e-3)) as b:
            got = await b.submit("r", eng.OP_ROW, s=s, p=1)
            return got, b.stats()

    got, st = asyncio.run(main())
    assert _plain(got) == _truth(T, (eng.OP_ROW, s, 1, 0)) and len(got) == E_ + 2
    assert st["cap_growth_events"] >= 1
