"""The serve step and ``Engine.compile(ServeQ)`` of ``repro_torch`` against
the JAX package's, every ``ServeResult`` field bit for bit.

Mixed batches carry all six serve-IR ops plus dead (op = -1) lanes; the
cases cover the SP/OP-index unbounded lanes, the all-preds sweep without an
index, ``unbounded=False``, and cap growth through ``Plan.__call__``.
"""

import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core.query import ExecConfig as JExecConfig, ServeQ as JServeQ
from repro_torch.core import engine as eng
from repro_torch.core.query import CapOverflow, CapPolicy, ExecConfig, ServeQ
from test_torch_store import build_pair

JNP = JExecConfig(backend="jnp", interpret=True, cap=8)


def mixed_batch(ids, n, seed, *, ops_hi=6, dead=0.15):
    """Lanes drawn from real triples: every op, some dead lanes, and some
    S?PO lanes whose (s, o) pair is a real triple so predicates match."""
    rng = np.random.default_rng(seed)
    rows = ids[rng.integers(0, ids.shape[0], n)]
    op = rng.integers(0, ops_hi, n).astype(np.int32)
    op = np.where(rng.random(n) < dead, -1, op).astype(np.int32)
    s, p, o = (rows[:, i].astype(np.int32) for i in range(3))
    p = np.where(op >= 3, 0, p).astype(np.int32)
    # dead lanes carry junk the serve step must ignore
    s = np.where(op == -1, rng.integers(-3, 5, n), s).astype(np.int32)
    return eng.ServeBatch(op, s, p, o)


def _same(r, jr):
    for f in eng.RESULT_FIELDS:
        a, b = np.asarray(getattr(r, f)), np.asarray(getattr(jr, f))
        assert a.shape == b.shape and a.dtype == b.dtype, (f, a.shape, b.shape)
        assert np.array_equal(a, b), f


@pytest.mark.parametrize("name,mode", [
    ("preds16", "index"), ("preds600", "index"), ("preds16", "sweep"),
    ("preds16", "bounded"), ("preds600", "bounded"),
])
def test_serve_step_matches_jax(name, mode):
    st, jst, ids = build_pair(name)
    cap = 8
    seed = {"index": 1, "sweep": 2, "bounded": 3}[mode]
    batch = mixed_batch(ids, 48, seed=seed, ops_hi=6 if mode != "bounded" else 3)
    if mode == "index":
        pm, jpm = st.pred_index.meta, jst.pred_index.meta
        step = eng.make_serve_step(st.meta, cap, pmeta=pm)
        jstep = jeng.make_serve_step(jst.meta, cap, backend=JNP, pmeta=jpm)
        r = step(st.forest, eng.upload_batch(batch, st.device), st.pred_index.device)
        jr = jstep(jst.forest, jeng.ServeBatch(*batch), jst.pred_index.device)
    elif mode == "sweep":
        step = eng.make_serve_step(st.meta, cap, u_width=st.n_preds)
        jstep = jeng.make_serve_step(jst.meta, cap, backend=JNP, u_width=jst.n_preds)
        r = step(st.forest, eng.upload_batch(batch, st.device), None)
        jr = jstep(jst.forest, jeng.ServeBatch(*batch), None)
    else:
        step = eng.make_serve_step(st.meta, cap)
        jstep = jeng.make_serve_step(jst.meta, cap, backend=JNP)
        r = step(st.forest, eng.upload_batch(batch, st.device))
        jr = jstep(jst.forest, jeng.ServeBatch(*batch))
    r = eng.host_result(r)
    _same(r, jeng.host_result(jr))
    ops = np.asarray(batch.op)
    assert r.hit[ops == eng.OP_CHECK].any()
    assert not r.valid[ops == -1].any() and not r.hit[ops == -1].any()
    if mode != "bounded":
        assert r.u_valid.any() and r.valid[ops == eng.OP_S_ANY_O].any()


@pytest.mark.parametrize("unbounded", [True, False])
def test_plan_cap_growth_matches_jax(unbounded):
    st, jst, ids = build_pair("preds16")
    batch = mixed_batch(ids, 40, seed=5, ops_hi=6 if unbounded else 3)
    plan = eng.Engine(st, device="cpu").compile(
        ServeQ(unbounded=unbounded), ExecConfig(cap=2, device="cpu")
    )
    jplan = jeng.Engine(jst).compile(JServeQ(unbounded=unbounded), JNP.replace(cap=2))
    r = eng.host_result(plan(batch), unbounded=unbounded)
    jr = jeng.host_result(jplan(jeng.ServeBatch(*batch)), unbounded=unbounded)
    assert plan.effective_cap == jplan.effective_cap > 2  # grown by doubling
    _same(r, jr)
    assert not r.overflow.any()



def _row_lanes(ids):
    """Two OP_ROW lanes of one real (s, p): the second's s moved by 2**32."""
    s, p = int(ids[0, 0]), int(ids[0, 1])
    return [[eng.OP_ROW, eng.OP_ROW], [s, s + 2**32], [p, p], [0, 0]]


@pytest.mark.parametrize("form", ["tuple", "ServeBatch"])
def test_plan_refuses_list_ids_outside_int32_like_jax(form):
    st, jst, ids = build_pair("preds16")
    lanes = _row_lanes(ids)
    plan = eng.Engine(st, device="cpu").compile(ServeQ(), ExecConfig(cap=8, device="cpu"))
    jplan = jeng.Engine(jst).compile(JServeQ(), JNP)
    wrap = {"tuple": tuple, "ServeBatch": lambda a: eng.ServeBatch(*a)}[form]
    jwrap = {"tuple": tuple, "ServeBatch": lambda a: jeng.ServeBatch(*a)}[form]
    with pytest.raises(OverflowError):
        plan(wrap(lanes))
    with pytest.raises(OverflowError):
        plan.submit(wrap(lanes))
    with pytest.raises(OverflowError):
        jplan(jwrap(lanes))


def test_plan_wraps_int64_array_ids_like_jax():
    st, jst, ids = build_pair("preds16")
    lanes = np.array(_row_lanes(ids), np.int64)
    plan = eng.Engine(st, device="cpu").compile(ServeQ(), ExecConfig(cap=8, device="cpu"))
    jplan = jeng.Engine(jst).compile(JServeQ(), JNP)
    r = eng.host_result(plan(tuple(lanes)))
    _same(r, jeng.host_result(jplan(tuple(lanes))))
    # s + 2**32 wraps to s: both lanes answer s's objects
    assert r.count[0] > 0 and np.array_equal(r.ids[0], r.ids[1])

def test_plan_without_growth_raises_and_submit_never_grows():
    st, _, ids = build_pair("preds16")
    e = eng.Engine(st, device="cpu")
    batch = mixed_batch(ids, 40, seed=6)
    plan = e.compile(ServeQ(), ExecConfig(cap=1, device="cpu", cap_policy=CapPolicy(grow=False)))
    with pytest.raises(CapOverflow):
        plan(batch)
    grow = e.compile(ServeQ(), ExecConfig(cap=1, device="cpu"))
    raw = grow.submit(batch)
    assert eng.host_result(raw).overflow.any() and grow.effective_cap == 1


def test_engine_caches_and_admission():
    st, _, _ = build_pair("preds16")
    e = eng.Engine(st, device="cpu")
    cfg = ExecConfig(cap=4, device="cpu")
    p1 = e.compile(ServeQ(), cfg)
    p2 = e.compile(ServeQ(), cfg, admit=lambda key: False)  # a hit bypasses admission
    assert p1._executor is p2._executor
    from repro_torch.core.query import AdmissionError

    with pytest.raises(AdmissionError):
        e.compile(ServeQ(unbounded=False), cfg, admit=lambda key: False)
    assert e.plan_cache_stats == {"hits": 1, "misses": 1, "denied": 1, "size": 1}
    assert [e._pad_b(b) for b in (1, 8, 9, 300)] == [8, 8, 16, 512]
    with pytest.raises(ValueError):
        e.compile(ServeQ(), ExecConfig(device="meta"))


def test_take_and_decode_lanes():
    st, _, ids = build_pair("preds16")
    batch = mixed_batch(ids, 24, seed=7, dead=0.0)
    plan = eng.Engine(st, device="cpu").compile(ServeQ(), ExecConfig(cap=64, device="cpu"))
    r = eng.host_result(plan(batch))
    sub = eng.take_lanes(batch, [3, 1])
    rs = eng.host_result(plan(sub))
    for j, i in enumerate([3, 1]):
        a, b = eng.decode_lane(int(batch.op[i]), r, i), eng.decode_lane(int(sub.op[j]), rs, j)
        if isinstance(a, dict):
            assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        else:
            assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        eng.decode_lane(-1, r, 0)
