"""``Engine.compile(TriplePatternQ)`` of ``repro_torch`` against the JAX
package's, bit for bit: values, order and dtype of every answer.

All eight triple-pattern shapes run single and batched (constants drawn
from real triples, with out-of-range predicates in the batches); the three
unbounded-``?P`` shapes run under both SP/OP index layouts, with the index
on and off.  Also: cap growth from cap 4, the repeated-variable rejection,
and a store converted from arrays.  The JAX side runs
``ExecConfig(backend="jnp")``.
"""

import numpy as np
import pytest

from repro.core import engine as jeng
from repro.core.query import ExecConfig as JExecConfig
from repro.core.query import TriplePatternQ as JTriplePatternQ
from repro_torch.core import convert, engine as eng
from repro_torch.core.query import ExecConfig, TriplePatternQ
from test_torch_store import build_pair

CAP = 128  # holds the largest predicate of the test stores: no growth
JNP = JExecConfig(backend="jnp", interpret=True, cap=CAP)
CFG = ExecConfig(cap=CAP, device="cpu")
B = 16

# bound mask -> (s, p, o) with "?" for a free position
SHAPES = {
    "SPO": (True, True, True), "SP?": (True, True, False),
    "?PO": (False, True, True), "S?O": (True, False, True),
    "S??": (True, False, False), "??O": (False, False, True),
    "?P?": (False, True, False), "???": (False, False, False),
}
SERVE_SHAPES = ("SPO", "SP?", "?PO", "S?O", "S??", "??O")
UNBOUNDED = ("S?O", "S??", "??O")

_stores = {}


def stores(name):
    """(port engine, JAX engine, ids) of a test corpus, built once."""
    if name not in _stores:
        st, jst, ids = build_pair(name)
        _stores[name] = (eng.Engine(st, device="cpu"), jeng.Engine(jst), ids)
    return _stores[name]


def same(a, b):
    """Recursive equality with dtype and shape (answers are arrays, dicts,
    bools or lists of those)."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), (list(a), list(b))
        for k in b:
            same(a[k], b[k])
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(b, (bool, np.bool_)):
        assert isinstance(a, (bool, np.bool_)) and bool(a) == bool(b)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b)


def _query(cls, shape, spo):
    return cls(*(int(v) if bound else f"?{k}" for k, v, bound in zip("spo", spo, SHAPES[shape])))


def _batch(shape, ids, seed):
    """Bound-position arrays from B real triples; a pair batch also asks for
    predicates 0 and P + 1, outside the forest."""
    rng = np.random.default_rng(seed)
    rows = ids[rng.integers(0, ids.shape[0], B)]
    batch = {k: rows[:, i].astype(np.int64) for i, k in enumerate("spo") if SHAPES[shape][i]}
    if shape == "?P?":
        batch["p"][:2] = [0, ids[:, 1].max() + 1]
    return batch


def _both(name, shape, cfg, jcfg, batch=None, spo=None):
    e, je, ids = stores(name)
    spo = ids[7] if spo is None else spo
    got = e.compile(_query(TriplePatternQ, shape, spo), cfg)(batch)
    want = je.compile(_query(JTriplePatternQ, shape, spo), jcfg)(batch)
    same(got, want)
    return got


@pytest.mark.parametrize("shape", list(SHAPES))
def test_single_pattern_matches_jax(shape):
    got = _both("preds16", shape, CFG, JNP)
    if shape in ("SPO",):
        assert got is True  # a real triple
    elif shape == "???":
        assert sum(len(v) for v in got.values()) == len(np.unique(stores("preds16")[2], axis=0))
    else:
        assert len(got) > 0


@pytest.mark.parametrize("shape", SERVE_SHAPES + ("?P?",))
def test_batched_pattern_matches_jax(shape):
    ids = stores("preds16")[2]
    got = _both("preds16", shape, CFG, JNP, batch=_batch(shape, ids, seed=len(shape) + ord(shape[0])))
    assert len(got) == B
    if shape == "?P?":
        assert all(g.dtype == np.int32 and g.shape[1] == 2 for g in got)


@pytest.mark.parametrize("name,layout,use_index", [
    ("preds16", "fixed", True),
    ("preds16", "dac", False),
    ("preds16", "dac", True),
    ("preds600", "fixed", True),
    ("preds600", "dac", True),
])
def test_unbounded_modes_match_jax(name, layout, use_index):
    e, _, ids = stores(name)
    kw = dict(cap=CAP, use_pred_index=use_index, pred_index_layout=layout)
    cfg, jcfg = ExecConfig(device="cpu", **kw), JExecConfig(backend="jnp", interpret=True, **kw)
    for shape in UNBOUNDED:
        _both(name, shape, cfg, jcfg, batch=_batch(shape, ids, seed=3))
    if name == "preds600":
        assert e.store.pred_index.select(layout)[1].bytes_per_pred == 2


def test_cap_growth_from_4():
    e, je, ids = stores("preds16")
    # subjects with the longest (s, p) lists: 5 objects > cap 4
    sp, counts = np.unique(ids[:, [0, 1]], axis=0, return_counts=True)
    rows = sp[np.argsort(-counts, kind="stable")[:B]]
    batch = {"s": rows[:, 0], "p": rows[:, 1]}
    plan = e.compile(TriplePatternQ(1, 1, "?o"), ExecConfig(cap=4, cap_y=2, device="cpu"))
    jplan = je.compile(JTriplePatternQ(1, 1, "?o"), JNP.replace(cap=4, cap_y=2))
    same(plan(batch), jplan(batch))
    assert plan.effective_cap == jplan.effective_cap == 8
    assert plan._executor.cap_y == 4  # cap_y doubles with cap
    same(plan(batch), jplan(batch))  # the grown cap is kept
    assert plan.effective_cap == 8
    # pair enumeration grows too, and agrees with a run at a large cap
    pairs = e.compile(TriplePatternQ("?s", 2, "?o"), ExecConfig(cap=4, device="cpu"))
    same(pairs(), e.compile(TriplePatternQ("?s", 2, "?o"), CFG)())
    assert pairs.effective_cap > 4


def test_repeated_variable_and_quantile_rejected():
    e, _, _ = stores("preds16")
    with pytest.raises(ValueError, match="repeated"):
        e.compile(TriplePatternQ("?x", 3, "?x"), CFG)
    # the reference's contract: (0, 1], a ValueError outside it
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError, match="u_width_quantile"):
            CFG.replace(u_width_quantile=bad)
    assert CFG.replace(u_width_quantile=0.5).u_width_quantile == 0.5
    plan = e.compile(TriplePatternQ(3, 4, "?o"), CFG)
    for bad in ({"o": [1, 2]}, {"s": [1, 2], "p": [1]}, {}):
        with pytest.raises(ValueError):
            plan(bad)
    with pytest.raises(ValueError):
        e.compile(TriplePatternQ("?s", "?p", "?o"), CFG)({"s": [1]})


def test_converted_store_serves_unbounded_patterns():
    """A store carried across from arrays has no host CSR; the unbounded
    patterns serve from its device index all the same."""
    e, _, ids = stores("preds16")
    s, p, o = (int(v) for v in ids[3])
    st = e.store
    pm = st.pred_index.meta
    conv = convert.store_from_arrays(
        ks=st.meta.ks, forest={k: v for k, v in st.forest.numpy().items()},
        n_so=st.n_so, n_subjects=st.n_subjects, n_objects=st.n_objects,
        n_preds=st.n_preds, n_triples=st.n_triples,
        index=st.pred_index.device.numpy(),
        index_meta={f: getattr(pm, f) for f in pm.__dataclass_fields__}, device="cpu",
    )
    assert conv.pred_index.host_offsets is None
    ce = eng.Engine(conv, device="cpu")
    for q in (TriplePatternQ(s, "?p", "?o"), TriplePatternQ("?s", "?p", o),
              TriplePatternQ(s, "?p", o)):
        same(ce.compile(q, CFG)(), e.compile(q, CFG)())
