"""``Engine.compile(JoinQ)`` of ``repro_torch`` against the JAX package's,
bit for bit, and the pieces under it: ``core.sortedset`` and ``core.joins``.

Every join category A–F runs over the four (vpos1, vpos2) pairs with
constants drawn from real triples; the per-predicate overflow of D/E/F with
a tiny ``cap_y`` is compared raw (``JoinPairs`` fields, dead X slots
included); cap growth doubles ``cap`` and ``cap_y`` together; the set
algebra is compared with JAX's, overflow included.  The JAX side runs
``ExecConfig(backend="jnp")``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import joins as jjoins
from repro.core import sortedset as jsortedset
from repro.core.query import ExecConfig as JExecConfig
from repro.core.query import JoinQ as JJoinQ
from repro_torch.core import joins, sortedset
from repro_torch.core.query import CapOverflow, CapPolicy, ExecConfig, JoinQ
from test_torch_patterns import same, stores

CAP, CAP_Y = 64, 16
JNP = JExecConfig(backend="jnp", interpret=True, cap=CAP, cap_y=CAP_Y)
CFG = ExecConfig(cap=CAP, cap_y=CAP_Y, device="cpu")
VPOS = [("s", "s"), ("s", "o"), ("o", "s"), ("o", "o")]
FIELDS = {
    "A": ("p1", "c1", "p2", "c2"), "B": ("p1", "c1", "c2"), "C": ("c1", "c2"),
    "D": ("p1", "c1", "p2"), "E": ("p1", "c1"), "F": ("c1",),
}


def join_args(ids, category, vpos1, vpos2, seed):
    """Constants from real triples whose X also sits at ``vpos2`` of some
    triple, so pattern 2 can bind it: pattern 1 is that triple's
    (p, const) with ?X at ``vpos1``, pattern 2 another triple of X."""
    rng = np.random.default_rng(seed)
    x_all = ids[:, 0] if vpos1 == "s" else ids[:, 2]
    col = 0 if vpos2 == "s" else 2
    ok = np.nonzero(np.isin(x_all, ids[:, col]))[0]
    s1, p1, o1 = (int(v) for v in ids[rng.choice(ok)])
    x = s1 if vpos1 == "s" else o1
    s2, p2, o2 = (int(v) for v in ids[ids[:, col] == x][0])
    kw = dict(p1=p1, c1=o1 if vpos1 == "s" else s1, p2=p2, c2=o2 if vpos2 == "s" else s2)
    return {k: kw[k] for k in FIELDS[category]}


@pytest.mark.parametrize("vpos1,vpos2", VPOS)
@pytest.mark.parametrize("category", "ABCDEF")
def test_join_matches_jax(category, vpos1, vpos2):
    e, je, ids = stores("preds16")
    kw = join_args(ids, category, vpos1, vpos2, seed=ord(category) * 7 + len(vpos1 + vpos2))
    got = e.compile(JoinQ(category, vpos1, vpos2, **kw), CFG)()
    want = je.compile(JJoinQ(category, vpos1, vpos2, **kw), JNP)()
    same(got, want)
    assert len(got) > 0  # the constants share an X: the answer is non-empty


def _raw(r):
    return [np.asarray(x) for x in r]


@pytest.mark.parametrize("category", "DEF")
def test_rebind_overflow_per_pred(category):
    """cap_y == k0 truncates the longest Y lists: the raw JoinPairs (dead X
    slots, per-predicate overflow) equal JAX's, and every predicate with a
    truncated Y list flags."""
    e, je, ids = stores("preds16")
    st, jst = e.store, je.store
    cap_y = st.meta.ks[0]
    # patterns (?X, p1, o1)(?X, p2, ?Y): Y lists are the objects of (X, p2);
    # pick an X whose list under p2 is longer than cap_y
    sp, counts = np.unique(ids[:, [0, 1]], axis=0, return_counts=True)
    x, p2 = (int(v) for v in sp[np.argmax(counts)])
    assert counts.max() > cap_y
    _, p1, o1 = (int(v) for v in ids[ids[:, 0] == x][0])
    run = {
        "D": lambda m, f, mod, be: mod.join_d(m, f, p1, o1, "s", p2, "s", CAP, cap_y, *be),
        "E": lambda m, f, mod, be: mod.join_e(m, f, p1, o1, "s", "s", CAP, cap_y, *be),
        "F": lambda m, f, mod, be: mod.join_f(m, f, o1, "s", "s", CAP, cap_y, *be),
    }[category]
    got = run(st.meta, st.forest, joins, ())
    want = run(jst.meta, jst.forest, jjoins, (JNP,))
    for g, w in zip(_raw(got), _raw(want), strict=True):
        same(g, w)
    ovf = np.asarray(got.overflow).reshape(-1)
    xv = np.asarray(got.x_valid).reshape(-1, CAP)[0]
    xs = np.asarray(got.x_ids).reshape(-1, CAP)[0][xv]
    preds = [p2] if category == "D" else range(1, st.n_preds + 1)
    flagged = 0
    for k, pp in enumerate(preds):
        n_y = [np.unique(ids[(ids[:, 0] == xx) & (ids[:, 1] == pp), 2]).size for xx in xs]
        if max(n_y, default=0) > cap_y:
            assert ovf[k], pp
            flagged += 1
    assert flagged > 0
    if category != "D":
        assert ovf.shape == (st.n_preds,) and not ovf.all()


def test_join_cap_growth_doubles_both_caps():
    e, je, ids = stores("preds16")
    kw = join_args(ids, "D", "s", "o", seed=5)
    plan = e.compile(JoinQ("D", "s", "o", **kw), ExecConfig(cap=2, cap_y=1, device="cpu"))
    got = plan()
    assert plan.effective_cap > 2 and plan._executor.cap_y == plan.effective_cap // 2
    same(got, je.compile(JJoinQ("D", "s", "o", **kw), JNP)())
    strict = e.compile(JoinQ("D", "s", "o", **kw),
                       ExecConfig(cap=2, cap_y=1, device="cpu", cap_policy=CapPolicy(grow=False)))
    with pytest.raises(CapOverflow):
        strict()
    # a C union of more than cap ids (each side list within cap) raises
    # CapOverflow itself, and the plan grows past it
    sub = next(int(c) for c in np.unique(ids[:, 0])
               if np.unique(ids[ids[:, 0] == c, 2]).size > 8
               and np.unique(ids[ids[:, 0] == c, :2], axis=0, return_counts=True)[1].max() <= 2)
    kw = dict(c1=sub, c2=sub)
    with pytest.raises(CapOverflow, match="union"):
        e.compile(JoinQ("C", "o", "o", **kw),
                  ExecConfig(cap=8, device="cpu", cap_policy=CapPolicy(grow=False)))()
    plan = e.compile(JoinQ("C", "o", "o", **kw), ExecConfig(cap=8, device="cpu"))
    same(plan(), je.compile(JJoinQ("C", "o", "o", **kw), JNP)())
    assert plan.effective_cap > 8
    with pytest.raises(ValueError):
        plan({"c1": [1]})


def _sets(rng, n_rows, cap, hi):
    """Sorted, sentinel-padded rows of random lengths (some empty)."""
    ids = np.full((n_rows, cap), 2**31 - 1, np.int32)
    valid = np.zeros((n_rows, cap), np.bool_)
    for r in range(n_rows):
        k = int(rng.integers(0, cap + 1))
        vals = np.sort(rng.choice(np.arange(1, hi), k, replace=False))
        ids[r, :k], valid[r, :k] = vals, True
    return ids, valid


@pytest.mark.parametrize("cap", [3, 8, 40])
def test_sortedset_matches_jax(cap):
    rng = np.random.default_rng(cap)
    ids, valid = _sets(rng, 6, 12, 30)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    # union of all rows, truncated at cap (overflow when > cap unique ids)
    for ovf_in in (False, True):
        got = sortedset.union_rows(t(ids), t(valid), cap, ovf_in)
        want = jsortedset.union_rows(jnp.asarray(ids), jnp.asarray(valid), cap, ovf_in)
        for g, w in zip(got, want, strict=True):
            same(g.numpy(), np.asarray(w))
    if cap == 3:
        assert bool(got.overflow)
    # intersections: row 0 against each row, singly and batched
    a = sortedset.IdSet(t(ids[0]), t(valid[0]), torch.tensor(int(valid[0].sum()), dtype=torch.int32),
                        torch.tensor(False))
    ja = jsortedset.from_result(jnp.asarray(ids[0]), jnp.asarray(valid[0]), int(valid[0].sum()), True)
    bs = sortedset.IdSet(t(ids), t(valid), t(valid.sum(1).astype(np.int32)), torch.zeros(6, dtype=torch.bool))
    batched = sortedset.intersect(a, bs)
    for r in range(6):
        jb = jsortedset.IdSet(jnp.asarray(ids[r]), jnp.asarray(valid[r]),
                              jnp.int32(valid[r].sum()), jnp.asarray(False))
        want = jsortedset.intersect(ja, jb)
        got = sortedset.intersect(a._replace(overflow=torch.tensor(True)),
                                  sortedset.IdSet(t(ids[r]), t(valid[r]), torch.tensor(0), torch.tensor(False)))
        for g, w in zip(got, want, strict=True):
            same(g.numpy(), np.asarray(w))
        assert torch.equal(batched.ids[r], got.ids) and torch.equal(batched.valid[r], got.valid)

