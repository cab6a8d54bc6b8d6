"""Quantile-sized unbounded lanes of ``repro_torch`` against the JAX
package's (``ExecConfig.u_width_quantile`` below 1).

The lane width equals the JAX ``predindex.quantile_u_width`` and the
engine's memoised width; ``host_degrees`` equals the JAX one; pattern
plans of the three unbounded shapes at quantile 0.5, batched over
constants that include the entities whose lists outgrow the lane, return
the JAX package's answers (the outliers served by the all-preds sweep) and
the exact plans' answers, on one device and on a (2, 2) mesh; on a
store with hub entities (``rdf.with_hubs``) the widths equal the JAX
package's and the answers the exact plans'; a raw
``ServeQ`` refuses a quantile, ``ExecConfig`` checks its range, and a
store without the host CSR names it.  The JAX side runs
``backend="jnp"``; the store is ``tests/test_query_api.py``'s.
"""

import numpy as np
import pytest

from repro.core import engine as jeng, k2triples as jk2triples
from repro.core import predindex as jpredindex
from repro.core.query import ExecConfig as JExecConfig
from repro.core.query import TriplePatternQ as JTriplePatternQ
from repro_torch.core import convert, engine as eng, k2triples, predindex
from repro_torch.core.query import ExecConfig, ServeQ, TriplePatternQ
from repro_torch.data import rdf
from repro_torch.launch import mesh as meshlib
from test_torch_patterns import same

CFG = ExecConfig(cap=64, device="cpu")  # holds every list of the store
JNP = JExecConfig(backend="jnp", interpret=True, cap=64)
SHAPES = {"S??": (True, False, False), "??O": (False, False, True), "S?O": (True, False, True)}

_pair = {}


def engines():
    """(port engine, JAX engine, ids) over test_query_api's store."""
    if not _pair:
        ds = rdf.generate(2500, n_subjects=50, n_preds=12, n_objects=70,
                          preds_per_subject=3, seed=17)
        kw = dict(n_so=ds.n_so, n_subjects=ds.n_subjects, n_objects=ds.n_objects,
                  n_preds=ds.n_preds)
        st = k2triples.from_id_triples(ds.ids, device="cpu", **kw)
        _pair["e"] = (eng.Engine(st, device="cpu"),
                      jeng.Engine(jk2triples.from_id_triples(ds.ids, **kw)), ds.ids)
    return _pair["e"]


@pytest.mark.parametrize("q", [0.1, 0.5, 0.9, 1.0])
def test_u_width_matches_jax(q):
    e, je, _ = engines()
    got = predindex.quantile_u_width(e.store.pred_index, q)
    assert got == jpredindex.quantile_u_width(je.store.pred_index, q)
    assert e._u_width(CFG.replace(u_width_quantile=q)) == je._u_width(JNP.replace(u_width_quantile=q))
    if q < 1.0:  # the quantile prunes against the hub-driven maximum
        assert e._u_width(CFG.replace(u_width_quantile=q)) < e._u_width(CFG)


def test_host_degrees_matches_jax():
    e, je, _ = engines()
    n_rows = e.store.pred_index.host_offsets.shape[0] - 1
    rows = np.array([-5, -1, 0, 3, 49, 50, n_rows - 1, n_rows, n_rows + 7])
    got = predindex.host_degrees(e.store.pred_index, rows)
    want = jpredindex.host_degrees(je.store.pred_index, rows)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _batch(shape, ids, u_width, pidx):
    """Constants of 12 real triples, the two largest-degree entities of the
    position's axis first: objects outgrow the lane on this store (every
    subject lists 3 predicates, objects up to 12)."""
    rng = np.random.default_rng(9)
    rows = ids[rng.integers(0, ids.shape[0], 12)]
    key = 0 if SHAPES[shape][0] else 2
    ent = np.unique(ids[:, key])
    deg = predindex.host_degrees(pidx, ent - 1 if key == 0 else pidx.meta.n_subjects + ent - 1)
    hubs = ent[np.argsort(-deg, kind="stable")[:2]]
    assert (np.sort(deg)[-2:] > u_width).all() == (key == 2)
    for i, h in enumerate(hubs):
        rows[i] = ids[np.nonzero(ids[:, key] == h)[0][0]]
    return {k: rows[:, i] for i, k in enumerate("spo") if SHAPES[shape][i]}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_quantile_patterns_match_jax(shape):
    e, je, ids = engines()
    quant = CFG.replace(u_width_quantile=0.5)
    u_width = e._u_width(quant)
    batch = _batch(shape, ids, u_width, e.store.pred_index)
    q = TriplePatternQ(*(1 if b else f"?{k}" for k, b in zip("spo", SHAPES[shape])))
    jq = JTriplePatternQ(*(1 if b else None for b in SHAPES[shape]))
    got = e.compile(q, quant)(batch)
    same(got, je.compile(jq, JNP.replace(u_width_quantile=0.5))(batch))
    same(got, e.compile(q, CFG)(batch))
    # one constant through the single-query form as well
    one = {k: v[:1] for k, v in batch.items()}
    same(e.compile(TriplePatternQ(*(int(one[k][0]) if k in one else f"?{k}" for k in "spo")),
                   quant)(), got[0])


def test_quantile_on_a_mesh():
    """In-lane entities ride the sharded program, outliers the
    single-device sweep: answers equal the unsharded plans'."""
    e, _, ids = engines()
    mesh = meshlib.make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    quant = CFG.replace(u_width_quantile=0.5)
    for shape in SHAPES:
        batch = _batch(shape, ids, e._u_width(quant), e.store.pred_index)
        q = TriplePatternQ(*(1 if b else f"?{k}" for k, b in zip("spo", SHAPES[shape])))
        same(e.compile(q, quant.replace(mesh=mesh))(batch), e.compile(q, CFG)(batch))


def test_quantile_bounds_and_serveq_refusal():
    for bad in (0.0, -0.5, 1.5):
        with pytest.raises(ValueError, match="u_width_quantile"):
            ExecConfig(u_width_quantile=bad, device="cpu")
    e, _, _ = engines()
    with pytest.raises(ValueError, match="quantile"):
        e.compile(ServeQ(), CFG.replace(u_width_quantile=0.5))
    # bounded-only and index-free ServeQ plans have no lane to size
    e.compile(ServeQ(unbounded=False), CFG.replace(u_width_quantile=0.5))
    e.compile(ServeQ(), CFG.replace(u_width_quantile=0.5, use_pred_index=False))


def test_quantile_needs_the_host_csr():
    e, _, ids = engines()
    st = e.store
    pm = st.pred_index.meta
    conv = convert.store_from_arrays(
        ks=st.meta.ks, forest=st.forest.numpy(), n_so=st.n_so, n_subjects=st.n_subjects,
        n_objects=st.n_objects, n_preds=st.n_preds, n_triples=st.n_triples,
        index=st.pred_index.device.numpy(),
        index_meta={f: getattr(pm, f) for f in pm.__dataclass_fields__}, device="cpu",
    )
    ce = eng.Engine(conv, device="cpu")
    s = int(ids[0, 0])
    with pytest.raises(ValueError, match="host CSR"):
        ce.compile(TriplePatternQ(s, "?p", "?o"), CFG.replace(u_width_quantile=0.5))()
    # at quantile 1 the lane holds every list and needs no CSR
    same(ce.compile(TriplePatternQ(s, "?p", "?o"), CFG)(),
         e.compile(TriplePatternQ(s, "?p", "?o"), CFG)())


def test_hub_store_widths_and_answers():
    """``rdf.with_hubs``: every hub lists every predicate, so ``max_degree``
    is P while a quantile below 1 keeps the lane near the short lists;
    the widths equal the JAX package's and pattern plans over constants
    that include every hub equal the exact plans."""
    ds = rdf.with_hubs(rdf.generate(3000, n_subjects=200, n_preds=24, n_objects=300, seed=5),
                       2, seed=6)
    kw = dict(n_so=ds.n_so, n_subjects=ds.n_subjects, n_objects=ds.n_objects,
              n_preds=ds.n_preds)
    e = eng.Engine(k2triples.from_id_triples(ds.ids, device="cpu", **kw), device="cpu")
    jbi = jk2triples.from_id_triples(ds.ids, **kw).pred_index
    bi = e.store.pred_index
    assert bi.meta.max_degree == ds.n_preds
    for q in (0.5, 0.9, 1.0):
        assert predindex.quantile_u_width(bi, q) == jpredindex.quantile_u_width(jbi, q)
    assert e._u_width(CFG.replace(u_width_quantile=0.9)) < ds.n_preds
    rng = np.random.default_rng(7)
    for key, q in ((0, TriplePatternQ(1, "?p", "?o")), (2, TriplePatternQ("?s", "?p", 1))):
        ent = np.unique(ds.ids[:, key])
        rows = ent - 1 if key == 0 else bi.meta.n_subjects + ent - 1
        hubs = ent[predindex.host_degrees(bi, rows) == ds.n_preds]
        assert hubs.size == 2
        consts = np.concatenate([hubs, ds.ids[rng.integers(0, ds.n_triples, 14), key]])
        batch = {"s" if key == 0 else "o": consts}
        same(e.compile(q, CFG.replace(u_width_quantile=0.9))(batch), e.compile(q, CFG)(batch))
