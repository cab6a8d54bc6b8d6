"""The functional pattern/join API of ``repro_torch`` against the JAX
package's, bit for bit (values, dtypes and shapes of every field):

* ``k2forest``: ``check_all_preds``, ``row_scan`` / ``col_scan``, their
  ``_batch`` and ``_all_preds`` forms, ``range_scan`` and
  ``range_scan_all_preds``;
* ``predindex``: ``subject_row`` / ``object_row``, ``scan_pruned_batch``
  and ``check_pruned_batch`` under both index layouts, at the full lane
  width and at a truncating one;
* ``sortedset.from_result`` / ``to_dense_mask``;
* every function of ``patterns``, with and without the index;
* ``joins._side_list``, ``join_a``, ``join_b`` (``PerPredSets``) and
  ``join_c`` over the four (vpos1, vpos2) pairs.

Constants come from real triples of one store; the JAX side runs
``backend="jnp"`` under ``jax.jit`` (one compile per function and shape).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import joins as jjoins
from repro.core import k2forest as jk2forest
from repro.core import patterns as jpatterns
from repro.core import predindex as jpredindex
from repro.core import sortedset as jsortedset
from repro.core.query import ExecConfig as JExecConfig
from repro_torch.core import joins, k2forest, patterns, predindex, sortedset
from test_torch_patterns import stores

CAP = 128
JNP = JExecConfig(backend="jnp", interpret=True)
VPOS = [("s", "o"), ("o", "s")]  # each side list both as a row and a column scan


_JIT = {}


def jx(fn, *args, static=(), **kw):
    """``fn(*args, **kw)`` of the JAX package under ``jax.jit``: positions
    ``static`` and every keyword but ``index`` are static."""
    names = tuple(sorted(k for k in kw if k != "index"))
    key = (fn, static, names)
    if key not in _JIT:
        _JIT[key] = jax.jit(fn, static_argnums=static, static_argnames=names)
    return _JIT[key](*args, **kw)


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same_result(got, want):
    """Field-by-field equality of two result tuples (or two arrays)."""
    if isinstance(want, tuple):
        assert type(got).__name__ == type(want).__name__
        assert got._fields == want._fields
        for g, w in zip(got, want):
            same_result(g, w)
        return
    g, w = np_of(got), np_of(want)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
    assert np.array_equal(g, w)


def setup(seed=0, n=6):
    e, je, ids = stores("preds16")
    rows = ids[np.random.default_rng(seed).integers(0, ids.shape[0], n)]
    return e.store, je.store, rows


def test_check_all_preds_and_scans():
    st, jst, rows = setup(n=3)
    m, f, jm, jf = st.meta, st.forest, jst.meta, jst.forest
    for s, p, o in rows:
        s, p, o = int(s) - 1, int(p) - 1, int(o) - 1
        same_result(k2forest.check_all_preds(m, f, s, o),
                    jx(jk2forest.check_all_preds, jm, jf, jnp.int32(s), jnp.int32(o), static=(0,)))
        for fn, jfn, key in ((k2forest.row_scan, jk2forest.row_scan, s),
                             (k2forest.col_scan, jk2forest.col_scan, o)):
            same_result(fn(m, f, p, key, CAP), jx(jfn, jm, jf, p, key, CAP, JNP, static=(0, 4, 5)))
        for fn, jfn, key in ((k2forest.row_scan_all_preds, jk2forest.row_scan_all_preds, s),
                             (k2forest.col_scan_all_preds, jk2forest.col_scan_all_preds, o)):
            same_result(fn(m, f, key, CAP), jx(jfn, jm, jf, key, CAP, JNP, static=(0, 3, 4)))
    preds, subs, objs = (rows[:, i].astype(np.int32) - 1 for i in (1, 0, 2))
    # cap 1 truncates: the overflow bits agree too
    for cap in (CAP, 1):
        same_result(k2forest.row_scan_batch(m, f, preds, subs, cap),
                    jx(jk2forest.row_scan_batch, jm, jf, preds, subs, cap, JNP, static=(0, 4, 5)))
        same_result(k2forest.col_scan_batch(m, f, preds, objs, cap),
                    jx(jk2forest.col_scan_batch, jm, jf, preds, objs, cap, JNP, static=(0, 4, 5)))


def test_range_scans():
    """At cap 64 the larger predicates truncate (overflow set) and the
    smaller fit."""
    cap = 64
    st, jst, rows = setup()
    m, f, jm, jf = st.meta, st.forest, jst.meta, jst.forest
    for p in (int(rows[0, 1]) - 1, 0, f.n_preds - 1):
        same_result(k2forest.range_scan(m, f, p, cap),
                    jx(jk2forest.range_scan, jm, jf, p, cap, JNP, static=(0, 3, 4)))
    same_result(k2forest.range_scan_all_preds(m, f, cap),
                jx(jk2forest.range_scan_all_preds, jm, jf, cap, JNP, static=(0, 2, 3)))


@pytest.mark.parametrize("layout", ["dac", "fixed"])
@pytest.mark.parametrize("narrow", [False, True])
def test_pruned_batches(layout, narrow):
    st, jst, rows = setup(seed=1, n=8)
    index, pmeta = st.pred_index.select(layout)
    jindex, jpmeta = jst.pred_index.select(layout)
    u_width = 2 if narrow else max(pmeta.max_degree, 1)
    s, o = rows[:, 0].astype(np.int32), rows[:, 2].astype(np.int32)
    assert predindex.subject_row(s).tolist() == jpredindex.subject_row(s).tolist()
    assert (predindex.object_row(pmeta, o).tolist()
            == jpredindex.object_row(jpmeta, o).tolist())
    keys = np.where(np.arange(8) % 2, o, s).astype(np.int32) - 1
    axes = (np.arange(8) % 2).astype(np.int32)
    got = predindex.scan_pruned_batch(st.meta, st.forest, pmeta, index, keys, axes, 64, u_width)
    want = jx(jpredindex.scan_pruned_batch, jst.meta, jst.forest, jpmeta, jindex, keys, axes,
              64, u_width, JNP, static=(0, 2, 6, 7, 8))
    same_result(got, want)
    assert narrow == bool(np_of(got.truncated).any())
    same_result(
        predindex.check_pruned_batch(st.meta, st.forest, pmeta, index, s - 1, o - 1, u_width),
        jx(jpredindex.check_pruned_batch, jst.meta, jst.forest, jpmeta, jindex, s - 1, o - 1,
           u_width, JNP, static=(0, 2, 6, 7)),
    )


def test_sortedset_from_result_and_dense_mask():
    rng = np.random.default_rng(3)
    ids = np.sort(rng.choice(np.arange(1, 60), 12, replace=False)).astype(np.int32)
    valid = rng.random(12) < 0.7
    got = sortedset.from_result(torch.from_numpy(ids), torch.from_numpy(valid), 5, True)
    want = jsortedset.from_result(jnp.asarray(ids), jnp.asarray(valid), 5, True)
    same_result(got, want)
    for extent in (59, 40, 1):
        same_result(sortedset.to_dense_mask(got, extent), jsortedset.to_dense_mask(want, extent))


@pytest.mark.parametrize("indexed", [False, True])
def test_patterns(indexed):
    st, jst, rows = setup(seed=2)
    m, f, jm, jf = st.meta, st.forest, jst.meta, jst.forest
    kw, jkw = {}, {}
    if indexed:
        index, pmeta = st.pred_index.select("dac")
        jindex, jpmeta = jst.pred_index.select("dac")
        kw, jkw = dict(index=index, pmeta=pmeta), dict(index=jindex, pmeta=jpmeta)
    for s, p, o in rows.tolist():
        same_result(patterns.spo(m, f, s, p, o), jx(jpatterns.spo, jm, jf, s, p, o, static=(0,)))
        same_result(patterns.s_any_o(m, f, s, o, **kw),
                    jx(jpatterns.s_any_o, jm, jf, s, o, JNP, static=(0, 4), **jkw))
        same_result(patterns.sp_any(m, f, s, p, CAP),
                    jx(jpatterns.sp_any, jm, jf, s, p, CAP, JNP, static=(0, 4, 5)))
        same_result(patterns.any_po(m, f, p, o, CAP),
                    jx(jpatterns.any_po, jm, jf, p, o, CAP, JNP, static=(0, 4, 5)))
        for fn, jfn, key in ((patterns.s_any_any, jpatterns.s_any_any, s),
                             (patterns.any_any_o, jpatterns.any_any_o, o)):
            same_result(fn(m, f, key, CAP, **kw),
                        jx(jfn, jm, jf, key, CAP, JNP, static=(0, 3, 4), **jkw))
        if indexed:  # a lane narrower than the lists
            same_result(patterns.s_any_any(m, f, s, CAP, u_width=1, **kw),
                        jx(jpatterns.s_any_any, jm, jf, s, CAP, JNP, static=(0, 3, 4),
                           u_width=1, **jkw))
    s, p, o = (rows[:, i].astype(np.int32) for i in range(3))
    same_result(patterns.spo_batch(m, f, s, p, o),
                jx(jpatterns.spo_batch, jm, jf, s, p, o, static=(0,)))
    same_result(patterns.sp_any_batch(m, f, s, p, CAP),
                jx(jpatterns.sp_any_batch, jm, jf, s, p, CAP, JNP, static=(0, 4, 5)))
    same_result(patterns.any_po_batch(m, f, p, o, CAP),
                jx(jpatterns.any_po_batch, jm, jf, p, o, CAP, JNP, static=(0, 4, 5)))
    if not indexed:
        same_result(patterns.any_p_any(m, f, int(p[0]), 128),
                    jx(jpatterns.any_p_any, jm, jf, int(p[0]), 128, JNP, static=(0, 3, 4)))
        same_result(patterns.dump(m, f, 128), jx(jpatterns.dump, jm, jf, 128, JNP, static=(0, 2, 3)))


@pytest.mark.parametrize("vpos1, vpos2", VPOS)
def test_joins_abc(vpos1, vpos2):
    st, jst, rows = setup(seed=4, n=3)
    m, f, jm, jf = st.meta, st.forest, jst.meta, jst.forest
    for s, p, o in rows.tolist():
        c1 = o if vpos1 == "s" else s
        c2 = o if vpos2 == "s" else s
        same_result(joins._side_list(m, f, p, c1, vpos1, CAP),
                    jx(jjoins._side_list, jm, jf, p, c1, vpos1, CAP, JNP, static=(0, 4, 5, 6)))
        same_result(joins.join_a(m, f, p, c1, vpos1, p, c2, vpos2, CAP),
                    jx(jjoins.join_a, jm, jf, p, c1, vpos1, p, c2, vpos2, CAP, JNP,
                       static=(0, 4, 7, 8, 9)))
        same_result(joins.join_b(m, f, p, c1, vpos1, c2, vpos2, CAP),
                    jx(jjoins.join_b, jm, jf, p, c1, vpos1, c2, vpos2, CAP, JNP,
                       static=(0, 4, 6, 7, 8)))
        # cap 2 truncates the side lists: overflow travels through
        for cap in (CAP, 2) if vpos1 == "s" else (CAP,):
            same_result(joins.join_c(m, f, c1, vpos1, c2, vpos2, cap),
                        jx(jjoins.join_c, jm, jf, c1, vpos1, c2, vpos2, cap, JNP,
                           static=(0, 3, 5, 6, 7)))
