"""The dynamic (LSM-delta) store of ``repro_torch`` against the JAX package's.

The same seeded insert/delete sequences, with subjects, objects and a
predicate in the appended range past the static extents, go through a
port ``DynamicStore`` and a JAX one: their delta snapshots, ``sanitize_ops``
and ``merge_lanes`` must be equal.  Over the same dynamic state the port's
``Engine(device="cpu")`` answers all eight triple patterns (batched), the
pair enumeration, the dump, joins A–F over the four vpos pairs, raw
``ServeQ`` batches, and BGP/SELECT queries exactly as the JAX ``Engine``
(``backend="jnp"``) does, before and after a compaction, whose arenas,
report and epoch must be identical.  Epoch semantics, the racing-writes
fix and the string path (minted ids, unseen terms) get their own tests.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.core import compaction as jcompaction
from repro.core import delta as jdelta
from repro.core import engine as jeng
from repro.core import k2triples as jk2triples
from repro.core import planner as jplanner
from repro.core.predindex import PredBitmap as JPredBitmap
from repro.core.query import ExecConfig as JExecConfig
from repro.core.query import JoinQ as JJoinQ
from repro.core.query import TriplePatternQ as JTriplePatternQ
from repro_torch.core import algebra, compaction, delta, k2triples, planner
from repro_torch.core import engine as eng
from repro_torch.core.dictionary import ExtendedDictionary
from repro_torch.core.predindex import PredBitmap
from repro_torch.core.query import (
    BgpQ, ExecConfig, JoinQ, SelectQ, ServeQ, StaleEpoch, TriplePatternQ,
)
from test_torch_dictionary import same_arenas
from test_torch_patterns import SHAPES, same
from test_torch_select import same_columns, to_jax

E_, P_ = 24, 4
CAP = 128
VPOS = [("s", "s"), ("s", "o"), ("o", "s"), ("o", "o")]


def _stores(seed, n=130, E=E_, P=P_):
    rng = np.random.default_rng(seed)
    ids = np.unique(rng.integers(1, [E + 1, P + 1, E + 1], size=(n, 3)), axis=0)
    kw = dict(n_so=E, n_subjects=E, n_objects=E, n_preds=P)
    return (k2triples.from_id_triples(ids, device="cpu", **kw),
            jk2triples.from_id_triples(ids, **kw), ids)


def _dyn_pair(seed, **kw):
    st, jst, ids = _stores(seed, **kw)
    return delta.DynamicStore(st), jdelta.DynamicStore(jst), set(map(tuple, ids.tolist()))


def _churn(stores, T, rng, n_ops, E=E_, P=P_):
    """Random deletes of live triples and inserts that may carry ids past
    the static extents (entities E+1, E+2; predicate P+1), applied to every
    store in ``stores`` and to the truth set ``T``."""
    for _ in range(n_ops):
        if T and rng.random() < 0.4:
            t = sorted(T)[int(rng.integers(len(T)))]
            for ds in stores:
                ds.delete(*t)
            T.discard(t)
        else:
            t = (int(rng.integers(1, E + 3)), int(rng.integers(1, P + 2)),
                 int(rng.integers(1, E + 3)))
            for ds in stores:
                ds.insert(*t)
            T.add(t)


def same_snapshot(a, b):
    for attr in ("ins", "tomb", "n_subjects", "n_objects", "n_preds", "version",
                 "n_inserts", "n_tombstones", "empty", "so_preds", "tomb_so_preds",
                 "dirty_preds"):
        assert getattr(a, attr) == getattr(b, attr), attr
    for attr in ("s_preds", "o_preds", "tomb_s_preds", "tomb_o_preds"):
        assert getattr(a, attr)._bits == getattr(b, attr)._bits, attr


def _lanes(rng, n, E=E_, P=P_):
    """Random serve lanes of every op (and dead ones), ids up to 2 past the
    extents."""
    return (rng.integers(-1, 6, n).astype(np.int32), rng.integers(0, E + 3, n).astype(np.int32),
            rng.integers(0, P + 2, n).astype(np.int32), rng.integers(0, E + 3, n).astype(np.int32))


def test_opcodes_in_sync():
    """delta.py mirrors the serve-IR op constants instead of importing the
    engine (a circular import): the tripwire if they ever drift."""
    assert (delta.OP_CHECK, delta.OP_ROW, delta.OP_COL, delta.OP_S_ANY_ANY,
            delta.OP_ANY_ANY_O, delta.OP_S_ANY_O) == (
        eng.OP_CHECK, eng.OP_ROW, eng.OP_COL, eng.OP_S_ANY_ANY,
        eng.OP_ANY_ANY_O, eng.OP_S_ANY_O)
    assert set(delta._NEED_P) == {eng.OP_CHECK, eng.OP_ROW, eng.OP_COL}
    assert set(eng.UNBOUNDED_OPS) == {delta.OP_S_ANY_O, delta.OP_S_ANY_ANY, delta.OP_ANY_ANY_O}
    assert (delta._NEED_S, delta._NEED_O, delta._NEED_P) == (
        jdelta._NEED_S, jdelta._NEED_O, jdelta._NEED_P)


def test_pred_bitmap_matches_jax():
    a, b = PredBitmap(), JPredBitmap()
    for e, p in ((5, 3), (5, 1), (9, 64), (9, 200), (2, 2)):
        a.add(e, p)
        b.add(e, p)
    for e in (5, 9, 2, 7):
        assert a.preds_of(e).tolist() == b.preds_of(e).tolist()
        assert (e in a) == (e in b)
    assert a._bits == b._bits and len(a) == len(b) == 3
    assert sorted(a.entities()) == sorted(b.entities())


def test_delta_store_semantics_and_rebase_match_jax():
    st, jst, ids = _stores(0)
    d, jd = delta.DeltaStore(st), jdelta.DeltaStore(jst)
    t0 = tuple(int(v) for v in ids[0])
    for x in (d, jd):
        x.delete(*t0)
    assert d.snapshot().tomb_contains(*t0) and not d.snapshot().contains(*t0)
    for x in (d, jd):
        x.insert(*t0)  # clears the tombstone
    snap = d.snapshot()
    assert snap.contains(*t0) and not snap.tomb_contains(*t0)
    assert d.snapshot() is snap  # version-cached
    for x in (d, jd):
        x.insert(1, 1, 1)
        x.delete(1, 1, 1)  # drops the insert AND tombstones
    same_snapshot(d.snapshot(), jd.snapshot())
    assert not d.snapshot().contains(1, 1, 1) and d.snapshot().tomb_contains(1, 1, 1)
    absorbed, jabsorbed = d.snapshot(), jd.snapshot()
    for x in (d, jd):
        x.insert(4, 2, 5)  # after the compaction pin
        x.delete(6, 1, 7)
    r, jr = d.rebase(st, absorbed), jd.rebase(jst, jabsorbed)
    same_snapshot(r.snapshot(), jr.snapshot())
    assert r.snapshot().contains(4, 2, 5) and r.snapshot().tomb_contains(6, 1, 7)
    assert not r.snapshot().contains(*t0)
    for x in (d, jd):
        with pytest.raises(ValueError):
            x.insert(0, 1, 1)  # ids are 1-based


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_sequences_equal_snapshots_sanitize_merge(seed):
    """Snapshots, ``sanitize_ops`` and ``merge_lanes`` equal JAX's at every
    checkpoint of a random insert/delete sequence; the merge is fed the
    same static result (the port's ``Plan.submit`` of the sanitized batch)."""
    ds, jds, T = _dyn_pair(seed)
    e = eng.Engine(ds, device="cpu")
    plan = e.compile(ServeQ(), ExecConfig(cap=8, device="cpu"))  # small: truncations too
    rng = np.random.default_rng(100 + seed)
    for step in range(4):
        _churn((ds, jds), T, rng, 12)
        view, jview = delta.view_of(ds), jdelta.view_of(jds)
        same_snapshot(view.snap, jview.snap)
        assert (view.ext_static, view.preds_static, view.ext_minted, view.preds_minted,
                view.total_preds, view.needs_sanitize) == (
            jview.ext_static, jview.preds_static, jview.ext_minted, jview.preds_minted,
            jview.total_preds, jview.needs_sanitize)
        lanes = _lanes(rng, 64)
        ops = view.sanitize_ops(*lanes)
        assert ops.dtype == np.int32 and np.array_equal(ops, jview.sanitize_ops(*lanes))
        qb = view.sanitize_batch(eng.ServeBatch(*lanes))
        assert np.array_equal(qb.op, ops)
        dead = ops != lanes[0]
        assert all((a[dead] == 0).all() for a in qb[1:])  # no appended id reaches a kernel
        for p in range(0, P_ + 3):  # merge_pairs, delta-only preds included
            pairs = np.asarray(sorted(t[::2] for t in T if t[1] == p), np.int64).reshape(-1, 2)
            rng.shuffle(pairs)
            got = view.snap.merge_pairs(p, pairs[:, 0], pairs[:, 1])
            want = jview.snap.merge_pairs(p, pairs[:, 0], pairs[:, 1])
            assert all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(got, want))
        raw = eng.host_result(plan.submit(qb))
        got = view.merge_lanes(*lanes, raw)
        want = jview.merge_lanes(*lanes, jeng.ServeResult(**{
            f: getattr(raw, f) for f in eng.RESULT_FIELDS}))
        for f in eng.RESULT_FIELDS:
            a, b = getattr(got, f), np.asarray(getattr(want, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), (step, f)


def _pattern_queries(rng, ids, T, E=E_, P=P_, B=16):
    """(shape, spo, batch) of all eight shapes: constants from live triples
    and from the appended range."""
    live = np.asarray(sorted(T), np.int64)
    out = []
    for shape, bound in SHAPES.items():
        rows = live[rng.integers(0, live.shape[0], B)].copy()
        rows[:3] = [[E + 1, P + 1, E + 2], [E + 2, 1, 1], [1, P + 1, E + 1]]
        batch = {k: rows[:, i] for i, k in enumerate("spo") if bound[i]}
        if shape == "?P?":
            batch["p"] = np.arange(0, P + 3, dtype=np.int64)
        out.append((shape, tuple(int(v) for v in live[0]), batch or None))
    return out


def _q(cls, shape, spo):
    return cls(*(int(v) if b else f"?{k}" for k, v, b in zip("spo", spo, SHAPES[shape])))


def _join_args(rng, T, category):
    live = sorted(T)
    s1, p1, o1 = live[int(rng.integers(len(live)))]
    s2, p2, o2 = live[int(rng.integers(len(live)))]
    kw = dict(p1=p1, c1=o1, p2=p2, c2=o2)
    keep = {"A": "p1 c1 p2 c2", "B": "p1 c1 c2", "C": "c1 c2", "D": "p1 c1 p2",
            "E": "p1 c1", "F": "c1"}[category].split()
    return {k: kw[k] for k in keep}


def _compare_engines(e, je, cfg, jcfg, T, rng, shapes=tuple(SHAPES), vpos=VPOS):
    for shape, spo, batch in _pattern_queries(rng, None, T):
        if shape in shapes:
            same(e.compile(_q(TriplePatternQ, shape, spo), cfg)(batch),
                 je.compile(_q(JTriplePatternQ, shape, spo), jcfg)(batch))
    for category in "ABCDEF":
        for v1, v2 in vpos:
            kw = _join_args(rng, T, category)
            same(e.compile(JoinQ(category, v1, v2, **kw), cfg)(),
                 je.compile(JJoinQ(category, v1, v2, **kw), jcfg)())
    lanes = _lanes(rng, 40)
    got = e.compile(ServeQ(), cfg)(eng.ServeBatch(*lanes))
    want = je.compile(to_jax(ServeQ()), jcfg)(jeng.ServeBatch(*lanes))
    for f in eng.RESULT_FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def _truth_dump(T):
    want = {}
    for s, p, o in sorted(T):
        want.setdefault(p, []).append((s, o))
    return want


@pytest.mark.parametrize("layout", ["dac", "fixed"])
def test_engine_matches_jax_through_churn_and_compaction(layout):
    """The layout only reaches the unbounded shapes: the fixed layout runs
    those (and the raw batch) alone, the DAC one every shape and join."""
    ds, jds, T = _dyn_pair({"dac": 3, "fixed": 4}[layout])
    e, je = eng.Engine(ds, device="cpu"), jeng.Engine(store=jds)
    cfg = ExecConfig(cap=CAP, pred_index_layout=layout, device="cpu")
    jcfg = JExecConfig(backend="jnp", interpret=True, cap=CAP, pred_index_layout=layout)
    kw = {} if layout == "dac" else dict(shapes=("S?O", "S??", "??O"), vpos=())
    rng = np.random.default_rng(7)
    _churn((ds, jds), T, rng, 30)
    _compare_engines(e, je, cfg, jcfg, T, rng, **kw)
    dump = e.compile(TriplePatternQ("?s", "?p", "?o"), cfg)()
    assert {p: sorted(map(tuple, v.tolist())) for p, v in dump.items()} == _truth_dump(T)

    rep, jrep = compaction.compact(ds), jcompaction.compact(jds, backend="jnp")
    for f in ("epoch", "n_triples", "delta_merged", "tombstones_applied"):
        assert getattr(rep, f) == getattr(jrep, f), f
    assert ds.epoch == jds.epoch == 1 and ds.delta.empty and rep.n_triples == len(T)
    assert set(rep.split_ms) == {"dump_ms", "copy_ms", "tombstones_ms", "rebuild_ms", "swap_ms"}
    same_arenas(ds.static, jds.static)
    assert ds.static.device == ds.device  # rebuilt on the static store's device
    assert np.array_equal(compaction.dump_static_ids(ds.static),
                          jcompaction.dump_static_ids(jds.static))
    if layout == "fixed":
        return
    # plans recompile at epoch 1; then more churn on the compacted epoch
    # (the pair shapes against the truth set: the JAX range programs
    # recompile slowly on the CPU)
    _compare_engines(e, je, cfg, jcfg, T, rng, shapes=("SPO", "SP?", "S??"), vpos=())
    _churn((ds, jds), T, rng, 15)
    _compare_engines(e, je, cfg, jcfg, T, rng, shapes=tuple(SHAPES)[:6], vpos=VPOS[2:3])
    want = _truth_dump(T)
    pairs = e.compile(TriplePatternQ("?s", 1, "?o"), cfg)({"p": np.arange(1, P_ + 2)})
    assert {p + 1: sorted(map(tuple, v.tolist())) for p, v in enumerate(pairs) if len(v)} == want


def test_bgp_select_with_delta_match_jax():
    ds, jds, T = _dyn_pair(5)
    rng = np.random.default_rng(9)
    _churn((ds, jds), T, rng, 40)
    e, je = eng.Engine(ds, device="cpu"), jeng.Engine(store=jds)
    cfg = ExecConfig(cap=CAP, device="cpu")
    jcfg = JExecConfig(backend="jnp", interpret=True, cap=CAP)
    s0, p0, o0 = sorted(T)[3]
    queries = [
        # an unbounded ?p over SP/OP candidates plus the snapshot's
        BgpQ((TriplePatternQ(s0, "?p", "?x"), TriplePatternQ("?x", "?q", "?y"))),
        # a delta-only predicate and an appended object; a ground pattern
        BgpQ((TriplePatternQ("?a", P_ + 1, "?b"), TriplePatternQ("?a", "?p", E_ + 1),
              TriplePatternQ(s0, p0, o0))),
        SelectQ(select=("?a", "?b", "?c"), where=(TriplePatternQ("?a", 1, "?b"),
                                                  TriplePatternQ("?b", 2, "?c"))),
        # the range step over every predicate, delta-only ones merged in
        SelectQ(where=(TriplePatternQ("?s", "?p", "?o"),),
                optional=((TriplePatternQ("?o", P_ + 1, "?z"),),), order_by=("?s", "?o")),
    ]
    for q in queries:
        same_columns(e.compile(q, cfg)(), je.compile(to_jax(q), jcfg)())
    # the planner without a serve runner: the raw runner sanitizes and merges
    tree = algebra.from_select(queries[2])
    got = planner.execute(ds, tree, cap=CAP)
    want = jplanner.execute(jds, to_jax(tree), cap=CAP, exec_="jnp")
    same_columns(got.cols, want.cols)


def test_stale_epoch_submit_and_transparent_call():
    ds, jds, T = _dyn_pair(6)
    e = eng.Engine(ds, device="cpu")
    cfg = ExecConfig(cap=64, device="cpu")
    plan = e.compile(ServeQ(unbounded=False), cfg)
    ones = np.ones(8, np.int32)
    qb = eng.ServeBatch(np.zeros(8, np.int32), ones, ones, ones)
    assert plan.submit(qb) is not None  # fine at epoch 0
    ds.insert(1, 1, 1)
    assert compaction.compact(ds).epoch == ds.epoch == 1
    with pytest.raises(StaleEpoch):
        plan.submit(qb)  # the raw lane refuses: pinned at epoch 0
    assert bool(plan(qb).hit[0])  # __call__ recompiles and answers
    p2 = e.compile(TriplePatternQ(1, 1, None), cfg)
    ds.insert(1, 1, 9)
    compaction.compact(ds)
    assert 9 in p2().tolist()
    # the planner's statistics read the new epoch
    assert ds.host_nnz is ds.static.host_nnz
    assert int(ds.host_nnz.sum()) == ds.static.n_triples


def test_racing_writes_survive_compaction_swap():
    """Writes issued while compactions run must never land on an orphaned
    pre-rebase delta: the store lock orders them against ``swap``."""
    ds, _, T = _dyn_pair(5, n=80, E=20, P=3)
    errs: list[Exception] = []
    written = set()

    def writer():
        try:
            for i in range(300):
                t = (21 + i % 5, 1 + i % 3, 1 + i % 20)
                ds.insert(*t)
                written.add(t)
        except Exception as e:  # pragma: no cover - diagnostic only
            errs.append(e)

    def compactor():
        try:
            for _ in range(6):
                compaction.compact(ds)
        except Exception as e:  # pragma: no cover - diagnostic only
            errs.append(e)

    threads = [threading.Thread(target=writer), threading.Thread(target=compactor)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    compaction.compact(ds)
    assert ds.delta.empty
    assert set(map(tuple, compaction.dump_static_ids(ds.static).tolist())) == T | written


def test_dynamic_store_proxies_and_device(monkeypatch):
    ds, _, _ = _dyn_pair(0)
    st = ds.static
    assert ds.n_so == st.n_so and ds.n_preds == st.n_preds and ds.epoch == 0
    assert ds.device == st.device and ds.host_nnz is st.host_nnz
    assert isinstance(ds.to("cpu"), k2triples.K2TriplesStore)
    with pytest.raises(ValueError):
        ds.insert(0, 1, 1)
    # an engine on another device refuses the live store instead of moving
    # its static epoch away from the delta
    monkeypatch.setattr(eng, "resolve_device", lambda d: torch.device("cuda", 0))
    with pytest.raises(ValueError, match="own device"):
        eng.Engine(ds, device="cuda")
    with pytest.raises(AttributeError):
        ds._missing  # private names never proxy


def _string_store():
    strs = [("s:a", "p:x", "s:b"), ("s:b", "p:x", "o:c"),
            ("s:a", "p:y", "o:c"), ("s:d", "p:y", "s:a")]
    return delta.DynamicStore(k2triples.from_string_triples(strs, device="cpu")), strs


def test_view_of_sanitizes_minted_ids_with_empty_delta():
    ds, _ = _string_store()
    assert delta.view_of(ds) is None  # fresh: the static fast path
    d = ds.dictionary
    nid, qid = d.add_term("zz:new"), d.add_predicate("zz:q")
    v = delta.view_of(ds)
    assert ds.delta.empty and v is not None and v.snap.empty and v.needs_sanitize
    e = eng.Engine(ds, device="cpu")
    cfg = ExecConfig(cap=32, device="cpu")
    px, sa, sb = d.encode_predicate("p:x"), d.encode_subject("s:a"), d.encode_object("s:b")
    assert not bool(e.compile(TriplePatternQ(nid, px, sa), cfg)())
    assert e.compile(TriplePatternQ(nid, px, None), cfg)().tolist() == []
    assert e.compile(TriplePatternQ(None, px, nid), cfg)().tolist() == []
    assert e.compile(TriplePatternQ(sa, qid, None), cfg)().tolist() == []
    assert e.compile(TriplePatternQ(nid, None, None), cfg)() == {}
    assert e.compile(TriplePatternQ(None, qid, None), cfg)().shape == (0, 2)
    assert bool(e.compile(TriplePatternQ(sa, px, sb), cfg)())
    ds.insert(nid, px, sa)
    assert bool(e.compile(TriplePatternQ(nid, px, sa), cfg)())
    assert e.compile(TriplePatternQ(nid, px, None), cfg)().tolist() == [sa]


def test_unseen_term_inserts_and_id_stability():
    ds, _ = _string_store()
    e = eng.Engine(ds, device="cpu")
    cfg = ExecConfig(cap=32, device="cpu")
    d = ds.dictionary
    assert isinstance(d, ExtendedDictionary)
    assert ds.insert_strings([("new:e", "p:x", "s:a"), ("s:a", "new:q", "new:f")]) == 2
    e_id, f_id, q_id = d.encode_subject("new:e"), d.encode_object("new:f"), d.encode_predicate("new:q")
    assert e_id > d.ext_base and q_id > d.pred_base
    px, sa, sb = d.encode_predicate("p:x"), d.encode_subject("s:a"), d.encode_object("s:b")
    assert bool(e.compile(TriplePatternQ(e_id, px, sa), cfg)())
    assert e.compile(TriplePatternQ(sa, q_id, None), cfg)().tolist() == [f_id]
    assert ds.delete_strings([("s:a", "p:x", "s:b"), ("never", "seen", "terms")]) == 1
    assert not bool(e.compile(TriplePatternQ(sa, px, sb), cfg)())
    rep = compaction.compact(ds)
    assert rep.epoch == 1 and ds.static.dictionary is d.base
    assert (d.encode_subject("new:e"), d.encode_predicate("new:q")) == (e_id, q_id)
    assert d.decode_subject(e_id) == "new:e"
    assert bool(e.compile(TriplePatternQ(e_id, px, sa), cfg)())
    assert not bool(e.compile(TriplePatternQ(sa, px, sb), cfg)())
    assert d.encode_triples([("new:e", "p:x", "s:a")]).tolist() == [[e_id, px, sa]]
    with pytest.raises(ValueError, match="no dictionary"):
        delta.DynamicStore(_stores(0)[0]).insert_strings([("a", "b", "c")])


def test_compaction_report_fields():
    assert [f.name for f in dataclasses.fields(compaction.CompactionReport)][:5] == [
        f.name for f in dataclasses.fields(jcompaction.CompactionReport)]
    for bad in (dict(max_delta=0), dict(max_tombstone_frac=0.0), dict(max_tombstone_frac=1.5)):
        with pytest.raises(ValueError):
            compaction.CompactionPolicy(**bad)
    ds, jds, T = _dyn_pair(8)
    pol = compaction.CompactionPolicy(max_delta=5, min_tombstones=2, max_tombstone_frac=0.01)
    jpol = jcompaction.CompactionPolicy(max_delta=5, min_tombstones=2, max_tombstone_frac=0.01)
    rng = np.random.default_rng(4)
    for _ in range(6):
        _churn((ds, jds), T, rng, 1)
        assert compaction.needs_compaction(ds, pol) == jcompaction.needs_compaction(jds, jpol)
