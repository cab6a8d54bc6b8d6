"""The SELECT/BGP path of ``repro_torch`` against the JAX package.

The same seeded stores go through both packages' algebra, planner,
optimizer and ``Engine.compile(BgpQ | SelectQ)`` (JAX side: the ``jnp``
backend in interpret mode).  Answers are compared column for column:
the same column names in the same order, equal values in the same row
order, the same dtype (tolerance: exact).  Random BGPs run with and
without the SP/OP index; random algebra trees nest OPTIONAL, UNION,
FILTER, projection and ORDER/LIMIT.  The planner's chosen orders and its
estimates must equal the reference's on the tie, trap and pricing stores
of ``tests/test_planner.py``.
"""

import dataclasses
import itertools

import numpy as np
import pytest

from repro.core import algebra as jalgebra
from repro.core import engine as jeng
from repro.core import k2triples as jk2triples
from repro.core import planner as jplanner
from repro.core import query as jquery
from repro_torch import obs
from repro_torch.core import algebra, convert, k2triples, optimizer, planner
from repro_torch.core import engine as eng
from repro_torch.core.algebra import (
    And, Bound, Cmp, Filter, Join, LeftJoin, Not, Or, Project, Slice,
    TriplePattern, Union,
)
from repro_torch.core.query import (
    BgpQ, CapOverflow, ExecConfig, SelectQ, TriplePatternQ, shape_key,
)
from repro_torch.data import rdf
from test_torch_store import FOREST_FIELDS, INDEX_FIELDS, build_pair

CAP = 256
CFG = ExecConfig(cap=CAP, device="cpu")
JCFG = jquery.ExecConfig(backend="jnp", interpret=True, cap=CAP)


@pytest.fixture(autouse=True)
def _obs_off_after():
    yield
    obs.disable()


def to_jax(x):
    """The JAX package's counterpart of a port query / algebra value."""
    if dataclasses.is_dataclass(x):
        name = type(x).__name__
        cls = getattr(jalgebra, name, None) or getattr(jquery, name)
        return cls(*(to_jax(getattr(x, f.name)) for f in dataclasses.fields(x)))
    if isinstance(x, tuple):
        return tuple(to_jax(v) for v in x)
    return x


def same_columns(got: dict, want: dict):
    """Column for column: names and their order, values and row order, dtype."""
    assert list(got) == list(want), (list(got), list(want))
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, (k, got[k].dtype, w.dtype)
        assert np.array_equal(got[k], w), (k, got[k][:8], w[:8])


def same_table(got, want):
    assert got.n == want.n, (got.n, want.n)
    same_columns(got.cols, want.cols)


def _both(ids, *, n_subjects, n_objects, n_preds, n_so=None):
    kw = dict(n_so=min(n_subjects, n_objects) if n_so is None else n_so,
              n_subjects=n_subjects, n_objects=n_objects, n_preds=n_preds)
    ids = np.asarray(ids, np.int64)
    return (k2triples.from_id_triples(ids, device="cpu", **kw),
            jk2triples.from_id_triples(ids, **kw))


@pytest.fixture(scope="module")
def small():
    """``tests/test_bgp_differential.py``'s store, in both packages."""
    ds = rdf.generate(220, n_subjects=16, n_preds=5, n_objects=18, seed=17)
    st, jst = _both(ds.ids, n_so=ds.n_so, n_subjects=ds.n_subjects,
                    n_objects=ds.n_objects, n_preds=ds.n_preds)
    return st, jst, list(map(tuple, ds.ids.tolist())), ds


def _without_index(st, jst, with_index):
    if with_index:
        return st, jst
    return (dataclasses.replace(st, pred_index=None),
            jst.__class__(**{**jst.__dict__, "pred_index": None}))


# ---------------------------------------------------------------------------
# random BGPs and algebra trees (draws as in the JAX differential suites)
# ---------------------------------------------------------------------------

_POOL = ["?a", "?b", "?c", "?x"]


def _random_patterns(rng, ds, T, n_pats):
    while True:
        pats = []
        for _ in range(n_pats):
            s_, p_, o_ = T[rng.integers(0, len(T))]
            terms = []
            for const, extent in ((s_, ds.n_subjects), (p_, ds.n_preds), (o_, ds.n_objects)):
                r = rng.random()
                if r < 0.45:
                    terms.append(_POOL[rng.integers(0, len(_POOL))])
                elif r < 0.85:
                    terms.append(int(const))
                else:
                    terms.append(int(rng.integers(1, extent + 1)))
            pats.append(TriplePattern(*terms))
        if any(p.variables for p in pats):
            return pats


def _random_expr(rng, vars_, ds):
    def leaf():
        v = vars_[rng.integers(0, len(vars_))]
        r = rng.random()
        if r < 0.2:
            return Bound(v)
        if r < 0.3:  # out-of-scope variable: the 3-valued error path
            return Cmp(">", "?zz", int(rng.integers(1, 5)))
        op = ["==", "!=", "<", "<=", ">", ">="][rng.integers(0, 6)]
        rhs = (vars_[rng.integers(0, len(vars_))] if rng.random() < 0.3
               else int(rng.integers(1, max(ds.n_subjects, ds.n_objects) + 1)))
        return Cmp(op, v, rhs)

    e = leaf()
    if rng.random() < 0.5:
        e = [And, Or][rng.integers(0, 2)](e, leaf())
    if rng.random() < 0.2:
        e = Not(e)
    return e


def _random_tree(rng, ds, T, depth):
    if depth == 0 or rng.random() < 0.35:
        return algebra.bgp(_random_patterns(rng, ds, T, int(rng.integers(1, 3))))
    kind = ["join", "leftjoin", "union", "filter"][rng.integers(0, 4)]
    if kind == "filter":
        child = _random_tree(rng, ds, T, depth - 1)
        return Filter(_random_expr(rng, sorted(algebra.node_vars(child)), ds), child)
    left = _random_tree(rng, ds, T, depth - 1)
    right = algebra.bgp(_random_patterns(rng, ds, T, int(rng.integers(1, 3))))
    return {"join": Join, "leftjoin": LeftJoin, "union": Union}[kind](left, right)


def _finish_tree(rng, tree):
    names = sorted(algebra.node_vars(tree))
    if rng.random() < 0.4 and names:
        k = int(rng.integers(1, len(names) + 1))
        sel = sorted(rng.choice(names, size=k, replace=False).tolist())
        tree = Project(tree, tuple(sel))
        names = sel
    if rng.random() < 0.5 and names:
        v = names[rng.integers(0, len(names))]
        spec = ("-" + v) if rng.random() < 0.5 else v
        tree = Slice(tree, (spec,), int(rng.integers(1, 12)), int(rng.integers(0, 3)))
    return tree


@pytest.mark.parametrize("with_index", [True, False])
def test_random_bgps_like_jax(small, with_index):
    st, jst, T, ds = small
    st, jst = _without_index(st, jst, with_index)
    E, JE = eng.Engine(st, device="cpu"), jeng.Engine(jst)
    rng = np.random.default_rng(99 if with_index else 100)
    for _ in range(12):
        pats = _random_patterns(rng, ds, T, int(rng.integers(1, 4)))
        q = BgpQ(tuple(TriplePatternQ(p.s, p.p, p.o) for p in pats))
        same_columns(E.compile(q, CFG)(), JE.compile(to_jax(q), JCFG)())


@pytest.mark.parametrize("with_index", [True, False])
def test_random_trees_like_jax(small, with_index):
    st, jst, T, ds = small
    st, jst = _without_index(st, jst, with_index)
    rng = np.random.default_rng(7 if with_index else 8)
    for _ in range(10):
        tree = _finish_tree(rng, _random_tree(rng, ds, T, int(rng.integers(1, 4))))
        got = planner.execute(st, tree, cap=CAP)
        want = jplanner.execute(jst, to_jax(tree), cap=CAP, exec_="jnp")
        same_table(got, want)


def _absent_pair(T, ds):
    have = {(p, o) for _, p, o in T}
    return next((p, o) for p in range(1, ds.n_preds + 1)
                for o in range(1, ds.n_objects + 1) if (p, o) not in have)


def _select_cases(T, ds):
    s, p, o = T[3]
    p_dead, o_dead = _absent_pair(T, ds)
    return {
        "optional_order_limit": SelectQ(
            where=(TriplePatternQ("?a", 1, "?b"),),
            optional=((TriplePatternQ("?b", 2, "?c"),),),
            filter=(Cmp(">", "?a", 3),), order_by=("-?b",), limit=7),
        "optional_empty_side": SelectQ(
            where=(TriplePatternQ("?a", 1, "?b"),),
            optional=((TriplePatternQ("?a", p_dead, o_dead),),)),
        "optional_unbound_filter": SelectQ(
            where=(TriplePatternQ("?a", 1, "?b"),),
            optional=((TriplePatternQ("?b", 2, "?c"),),),
            filter=(Not(Bound("?c")),)),
        "union_projection": SelectQ(
            union=((TriplePatternQ("?x", 1, "?y"),), (TriplePatternQ("?x", "?p", "?y"),)),
            select=("?x", "?y")),
        "union_asymmetric_filter": SelectQ(
            union=((TriplePatternQ("?x", 1, "?y"),),
                   (TriplePatternQ("?x", 2, "?y"), TriplePatternQ("?y", 3, "?z"))),
            filter=(Or(Cmp("<", "?x", 8), Bound("?z")),)),
        "where_union_join": SelectQ(
            where=(TriplePatternQ("?x", p, "?y"),),
            union=((TriplePatternQ("?y", 1, "?z"),), (TriplePatternQ("?y", 2, "?z"),))),
        "anon_offset": SelectQ(
            where=(TriplePatternQ(None, p, "?y"), TriplePatternQ("?y", None, None)),
            order_by=("?y",), limit=4, offset=1),
        "serve_shape": SelectQ(
            where=(TriplePatternQ(s, p, "?o"),),
            optional=((TriplePatternQ(s, 2, "?x"),),), order_by=("?o",), limit=16),
        "star": SelectQ(where=(TriplePatternQ("?s", p, o), TriplePatternQ("?s", 2, "?x"))),
        "path": SelectQ(where=(TriplePatternQ(s, p, "?y"), TriplePatternQ("?y", 1, "?z"))),
        "fully_free": SelectQ(where=(TriplePatternQ(s, p, "?c"),
                                     TriplePatternQ("?e", "?f", "?g"))),
    }


@pytest.mark.parametrize("with_index", [True, False])
def test_select_shapes_like_jax(small, with_index):
    """OPTIONAL (empty side, unbound fill), UNION (overlap, asymmetric),
    FILTER, ORDER/LIMIT/OFFSET, anonymous positions, the serve benchmark's
    shape, stars, paths and a fully free pattern through
    ``Engine.compile(SelectQ)``: equal to the JAX engine's answers."""
    st, jst, T, ds = small
    st, jst = _without_index(st, jst, with_index)
    E, JE = eng.Engine(st, device="cpu"), jeng.Engine(jst)
    nonempty = 0
    for q in _select_cases(T, ds).values():
        got = E.compile(q, CFG)()
        same_columns(got, JE.compile(to_jax(q), JCFG)())
        nonempty += len(next(iter(got.values()))) > 0
    assert nonempty >= 8


def test_planner_direct_and_served_agree(small):
    """A tree through the raw ``k2forest`` calls and through the engine's
    pooled serve step gives the same table."""
    st, _, T, ds = small
    E = eng.Engine(st, device="cpu")
    rng = np.random.default_rng(4)
    for _ in range(6):
        tree = _finish_tree(rng, _random_tree(rng, ds, T, 2))
        same_table(planner.execute(st, tree, cap=CAP, serve=E._lanes_runner(CFG, CAP)),
                   planner.execute(st, tree, cap=CAP))


def test_run_bgp_and_cap_growth_like_jax(small):
    """``optimizer.run_bgp`` raises ``CapOverflow`` at a cap the data
    overflows, and the plan's cap policy grows past it as the JAX one does."""
    st, jst, T, ds = small
    pats = [TriplePattern("?a", 1, "?b"), TriplePattern("?b", "?p", "?c")]
    with pytest.raises(CapOverflow):
        optimizer.run_bgp(st, [TriplePattern("?s", 1, "?o")], cap=1)
    same_columns(optimizer.run_bgp(st, pats, cap=CAP),
                 jalgebra.project_named(
                     jplanner.execute(jst, to_jax(algebra.bgp(pats)), cap=CAP, exec_="jnp").cols))
    q = BgpQ(tuple(TriplePatternQ(p.s, p.p, p.o) for p in pats))
    plan = eng.Engine(st, device="cpu").compile(q, CFG.replace(cap=16))
    jplan = jeng.Engine(jst).compile(to_jax(q), JCFG.replace(cap=16))
    same_columns(plan(), jplan())
    assert plan.effective_cap == jplan.effective_cap > 16


# ---------------------------------------------------------------------------
# the planner's orders and estimates on the stores of test_planner.py
# ---------------------------------------------------------------------------


def _planner_stores():
    sym = [(s, 1, (s % 16) + 1) for s in range(1, 17)]
    trap = [(s, 1, 10 * s) for s in range(1, 5)]
    trap += [((i % 4) + 1, 2, 100 + i) for i in range(30)]
    trap += [(1, 3, 10), (2, 3, 20)]
    trap += [((i % 4) + 1, 3, 500 + i) for i in range(48)]
    pricing = [(s, 1, s) for s in range(1, 9)]
    pricing += [(s, 2, o) for s in range(1, 11) for o in range(1, 7)]
    return {
        "tie": (sym, dict(n_subjects=16, n_objects=16, n_preds=1),
                [TriplePattern("?a", 1, "?b"), TriplePattern("?b", 1, "?c"),
                 TriplePattern("?c", 1, "?d")]),
        "trap": (trap, dict(n_subjects=4, n_objects=1000, n_preds=3),
                 [TriplePattern("?s", 1, "?x"), TriplePattern("?s", 2, "?z"),
                  TriplePattern("?w", 3, "?x")]),
        "pricing": (pricing, dict(n_subjects=10, n_objects=10, n_preds=2),
                    [TriplePattern("?x", 1, "?y"), TriplePattern("?x", 2, 3)]),
    }


@pytest.mark.parametrize("name", ["tie", "trap", "pricing"])
def test_planner_order_like_jax(name):
    ids, kw, pats = _planner_stores()[name]
    st, jst = _both(ids, **kw)
    jpats = to_jax(tuple(pats))
    assert [planner.estimate_cardinality(st, p) for p in pats] == [
        jplanner.estimate_cardinality(jst, p) for p in jpats]
    for bound in (set(), {"?x"}, {"?s", "?b"}):
        assert [planner.step_estimate(st, p, bound) for p in pats] == [
            jplanner.step_estimate(jst, p, bound) for p in jpats]
        assert [planner.step_lane_price(p, bound) for p in pats] == [
            jplanner.step_lane_price(p, bound) for p in jpats]
    assert planner.cost_order(st, pats) == jplanner.cost_order(jst, list(jpats))
    for order in itertools.permutations(range(len(pats))):
        assert planner.order_cost(st, pats, order) == jplanner.order_cost(
            jst, list(jpats), order)
    assert planner.greedy_order(st, pats) == jplanner.greedy_order(jst, list(jpats))
    assert optimizer.plan(st, pats) == planner.greedy_order(st, pats)
    expect = {"tie": ([0, 1, 2], [0, 1, 2]), "trap": ([0, 1, 2], [0, 2, 1]),
              "pricing": ([1, 0], [0, 1])}[name]
    assert (planner.greedy_order(st, pats), planner.cost_order(st, pats)) == expect
    tree = algebra.bgp(pats)
    same_table(planner.execute(st, tree, cap=512),
               jplanner.execute(jst, to_jax(tree), cap=512, exec_="jnp"))


def test_dp_limit_falls_back_to_greedy(small):
    st, jst, _, _ = small
    pats = [TriplePattern(f"?v{i}", 1, f"?v{i + 1}") for i in range(9)]
    assert len(pats) > planner.DP_LIMIT == jplanner.DP_LIMIT
    assert planner.cost_order(st, pats) == planner.greedy_order(st, pats) == \
        jplanner.cost_order(jst, list(to_jax(tuple(pats))))


def test_push_filters_structure_like_jax():
    a = algebra.bgp([TriplePattern("?a", 1, "?b")])
    b = algebra.bgp([TriplePattern("?b", 2, "?c")])
    c_left, c_right = Cmp(">", "?a", 3), Cmp(">", "?c", 3)
    u = Union(a, algebra.bgp([TriplePattern("?a", 2, "?b")]))
    cases = [
        (Filter(And(c_left, c_right), LeftJoin(a, b)),
         Filter(c_right, LeftJoin(Filter(c_left, a), b))),
        (Filter(c_left, LeftJoin(a, b)), LeftJoin(Filter(c_left, a), b)),
        (Filter(c_left, u), Union(Filter(c_left, u.left), Filter(c_left, u.right))),
        (Filter(c_left, Union(a, b)), Filter(c_left, Union(a, b))),
        (Project(Filter(c_left, LeftJoin(a, b)), ("?a",)),
         Project(LeftJoin(Filter(c_left, a), b), ("?a",))),
        (Slice(Filter(c_left, LeftJoin(a, b)), ("-?a",), 3, 1),
         Slice(LeftJoin(Filter(c_left, a), b), ("-?a",), 3, 1)),
    ]
    for tree, want in cases:
        got = planner.push_filters(tree)
        assert got == want
        assert to_jax(got) == jplanner.push_filters(to_jax(tree))


def test_algebra_tables_like_jax():
    """The host table algebra on tables with UNBOUND holes, duplicates and
    empty sides: the same rows, order and dtypes as the JAX package's."""
    rng = np.random.default_rng(2)

    def table(mod, cols, n):
        return mod.Table({k: v.copy() for k, v in cols.items()}, n)

    for _ in range(20):
        na, nb = int(rng.integers(0, 7)), int(rng.integers(0, 7))
        ca = {v: rng.integers(0, 4, na) for v in ("?a", "?b")}
        cb = {v: rng.integers(0, 4, nb) for v in ("?b", "?c")}
        for fn in ("join_tables", "left_join_tables", "union_tables"):
            got = getattr(algebra, fn)(table(algebra, ca, na), table(algebra, cb, nb))
            want = getattr(jalgebra, fn)(table(jalgebra, ca, na), table(jalgebra, cb, nb))
            same_table(got, want)
        t = table(algebra, ca, na)
        same_table(algebra.distinct(t), jalgebra.distinct(table(jalgebra, ca, na)))
        same_table(algebra.sort_slice(t, ("-?b",), 3, 1),
                   jalgebra.sort_slice(table(jalgebra, ca, na), ("-?b",), 3, 1))
        same_columns(algebra.project_named(dict(ca)), jalgebra.project_named(dict(ca)))
    pats = [TriplePatternQ(None, 1, "?x"), TriplePatternQ("?x", None, None)]
    assert to_jax(tuple(algebra.name_anon(pats, start=3))) == tuple(
        jalgebra.name_anon(to_jax(tuple(pats)), start=3))


# ---------------------------------------------------------------------------
# validation, plan-cache keys, converted stores
# ---------------------------------------------------------------------------


def test_selectq_validation(small):
    st, _, _, _ = small
    E = eng.Engine(st, device="cpu")
    with pytest.raises(ValueError):
        SelectQ()
    with pytest.raises(ValueError):
        SelectQ(where=(TriplePatternQ("?a", 1, "?b"),), order_by=("b",))
    with pytest.raises(ValueError):
        SelectQ(where=(TriplePatternQ("?a", 1, "?b"),), limit=-1)
    with pytest.raises(ValueError):
        SelectQ(where=(TriplePatternQ("?a", 1, "?b"),), offset=-1)
    with pytest.raises(ValueError, match="reserved"):
        E.compile(SelectQ(where=(TriplePatternQ("?__x", 1, "?b"),)), CFG)
    with pytest.raises(ValueError, match="reserved"):
        E.compile(SelectQ(where=(TriplePatternQ("?a", 1, "?b"),), select=("?__a",)), CFG)
    with pytest.raises(ValueError, match="name at least one"):
        E.compile(SelectQ(where=(TriplePatternQ(1, 1, 2),)), CFG)
    with pytest.raises(TypeError):
        E.compile(SelectQ(where=(TriplePatternQ("?a", 1, "?b"),), filter=("?a > 3",)), CFG)
    plan = E.compile(SelectQ(where=(TriplePatternQ("?a", 1, "?b"),)), CFG)
    with pytest.raises(ValueError, match="no batch"):
        plan(np.zeros(4))
    with pytest.raises(ValueError, match="reserved"):
        E.compile(BgpQ(((f"{algebra.ANON}1", 1, "?b"),)), CFG)
    with pytest.raises(ValueError, match="name at least one"):
        E.compile(BgpQ(((None, 1, None),)), CFG)
    with pytest.raises(ValueError, match="no batch"):
        E.compile(BgpQ((("?a", 1, "?b"),)), CFG)({"s": [1]})
    with pytest.raises(ValueError):
        optimizer.run_bgp(st, [TriplePattern(1, 1, 1)])


def test_plan_cache_keys_like_jax(small):
    st, jst, _, _ = small
    E, JE = eng.Engine(st, device="cpu"), jeng.Engine(jst)
    qs = [SelectQ(where=(TriplePatternQ("?a", 1, "?b"),)),
          SelectQ(where=(TriplePatternQ("?x", 2, "?y"),), limit=3),
          BgpQ((("?a", 1, "?b"),)), BgpQ((("?a", 2, "?b"), ("?b", 1, "?c")))]
    for q in qs:
        E.compile(q, CFG)
        JE.compile(to_jax(q), JCFG)
        assert shape_key(q) == jquery.shape_key(to_jax(q))
    assert E.plan_cache_stats == JE.plan_cache_stats == {
        "hits": 2, "misses": 2, "denied": 0, "size": 2}


def test_converted_store_plans_like_jax(small):
    """A store carried across with the JAX store's host CSR plans and
    answers exactly as the reference; without the CSR a ``?p`` step that
    needs candidates raises."""
    _, jst, T, ds = small
    bi = jst.pred_index
    kw = dict(
        ks=jst.meta.ks,
        forest={f: np.asarray(getattr(jst.forest, f)) for f in FOREST_FIELDS},
        index={f: np.asarray(getattr(bi.device, f)) for f in INDEX_FIELDS},
        index_meta=dataclasses.asdict(bi.meta),
        n_so=jst.n_so, n_subjects=jst.n_subjects, n_objects=jst.n_objects,
        n_preds=jst.n_preds, n_triples=jst.n_triples, device="cpu",
    )
    carried = convert.store_from_arrays(
        **kw, host_offsets=bi.host_offsets, host_preds=bi.host_preds)
    s = T[0][0]
    pats = [TriplePattern(s, "?p", "?y"), TriplePattern("?y", "?q", "?z")]
    assert planner.estimate_cardinality(carried, pats[0]) == jplanner.estimate_cardinality(
        jst, to_jax(pats[0]))
    same_table(planner.execute(carried, algebra.bgp(pats), cap=CAP),
               jplanner.execute(jst, to_jax(algebra.bgp(pats)), cap=CAP, exec_="jnp"))
    bare = convert.store_from_arrays(**kw)
    with pytest.raises(ValueError, match="host CSR"):
        planner.execute(bare, algebra.bgp(pats), cap=CAP)
    with pytest.raises(ValueError):
        convert.store_from_arrays(**kw, host_offsets=bi.host_offsets)
    with pytest.raises(ValueError):
        convert.store_from_arrays(**kw, host_offsets=bi.host_offsets[:-1],
                                  host_preds=bi.host_preds)


def test_planner_order_span_and_sip_counter(small):
    st, _, _, _ = small
    tracer, metrics = obs.enable()
    tree = algebra.bgp([TriplePattern("?a", 1, "?b"), TriplePattern("?b", "?p", "?c")])
    t = planner.execute(st, tree, cap=CAP)
    assert t.n > 0
    spans = [e for e in tracer.events() if e["name"] == "planner.order"]
    args = spans[-1]["args"]
    assert args["patterns"] == 2 and len(args["order"]) == 2
    assert len(args["estimated"]) == len(args["actual"]) == 2
    assert args["actual"][-1] == t.n
    assert metrics.snapshot()["planner.sip_pruned_lanes"]["value"] > 0


def test_build_pair_stores_answer_selects_like_jax():
    """The larger seeded corpus of the store tests (16 predicates)."""
    st, jst, ids = build_pair("preds16")
    E, JE = eng.Engine(st, device="cpu"), jeng.Engine(jst)
    rng = np.random.default_rng(12)
    for row in ids[rng.integers(0, ids.shape[0], 4)]:
        s, p, o = (int(v) for v in row)
        p2 = int(rng.integers(1, 17))
        for q in (
            SelectQ(where=(TriplePatternQ(s, p, "?o"),),
                    optional=((TriplePatternQ(s, p2, "?x"),),), order_by=("?o",), limit=16),
            SelectQ(where=(TriplePatternQ("?s", p, o), TriplePatternQ("?s", p2, "?x"))),
            SelectQ(where=(TriplePatternQ(s, p, "?y"), TriplePatternQ("?y", p2, "?z"))),
            SelectQ(union=((TriplePatternQ(s, p, "?o"),), (TriplePatternQ(s, p2, "?o"),)),
                    filter=(Cmp(">", "?o", 10),)),
        ):
            same_columns(E.compile(q, CFG)(), JE.compile(to_jax(q), JCFG)())
