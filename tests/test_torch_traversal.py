"""The three kernel paths of ``repro_torch`` against the JAX package, bit for bit.

``k2forest.check``, ``k2forest.scan_batch_mixed`` and
``predindex.gather_batch`` of the port (plain versions, CPU) against the
JAX package's jnp reference, including cap overflow, empty frontiers,
negative and out-of-range keys and predicates, and the 600-predicate
multi-level DAC store.  One tiny case per kernel also runs the Pallas
kernel itself in interpret mode as the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import k2forest as jk2forest, k2tree as jk2tree
from repro.core import predindex as jpredindex
from repro.core.query import ExecConfig as JExecConfig
from repro.kernels import ops as jops
from repro_torch.core import k2forest, predindex
from repro_torch.kernels import ops
from test_torch_store import build_pair

JNP = JExecConfig(backend="jnp", interpret=True)
PALLAS = JExecConfig(backend="pallas", interpret=True)


def _lanes(rng, n, lo, hi):
    return rng.integers(lo, hi, n).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _keys(rng, st, ids, q, *, wild):
    """Real (pred, key) pairs, with out-of-range values mixed in when ``wild``."""
    rows = ids[rng.integers(0, ids.shape[0], q)]
    axes = _lanes(rng, q, 0, 2)
    preds = (rows[:, 1] - 1).astype(np.int32)
    keys = np.where(axes == 0, rows[:, 0] - 1, rows[:, 2] - 1).astype(np.int32)
    if wild:
        side = st.meta.side
        m = rng.random(q)
        keys = np.where(m < 0.15, _lanes(rng, q, -side - 5, 0), keys)
        keys = np.where((m >= 0.15) & (m < 0.3), _lanes(rng, q, side, 2 * side + 7), keys)
        n = st.n_preds
        m = rng.random(q)
        preds = np.where(m < 0.15, _lanes(rng, q, -2 * n - 3, 0), preds)
        preds = np.where((m >= 0.15) & (m < 0.3), _lanes(rng, q, n, 2 * n + 3), preds)
    return preds.astype(np.int32), keys.astype(np.int32), axes


def _same_result(got, want):
    for g, w, name in zip(got, want, ("ids", "valid", "count", "overflow")):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert np.array_equal(g, w), name


@pytest.mark.parametrize("name", ["preds16", "preds600", "single_level", "empty_preds"])
@pytest.mark.parametrize("wild", [False, True])
def test_check_matches_jax(name, wild):
    st, jst, ids = build_pair(name)
    rng = np.random.default_rng(7)
    q = 96
    preds, rows, _ = _keys(rng, st, ids, q, wild=wild)
    cols = (ids[rng.integers(0, ids.shape[0], q), 2] - 1).astype(np.int32)
    if wild:
        cols = np.where(rng.random(q) < 0.3, _lanes(rng, q, -50, 3 * st.meta.side), cols)
    # half the lanes are true triples so hits are exercised
    true = ids[rng.integers(0, ids.shape[0], q // 2)]
    preds[: q // 2] = true[:, 1] - 1
    rows[: q // 2] = true[:, 0] - 1
    cols[: q // 2] = true[:, 2] - 1
    got = k2forest.check(st.meta, st.forest, _t(preds), _t(rows), _t(cols))
    want = jk2forest.check(jst.meta, jst.forest, jnp.asarray(preds), jnp.asarray(rows), jnp.asarray(cols))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got[: q // 2].all()


@pytest.mark.parametrize("name,cap", [
    ("preds16", 16), ("preds16", 2), ("preds600", 8), ("single_level", 3),
    ("empty_preds", 5),
])
@pytest.mark.parametrize("wild", [False, True])
def test_scan_matches_jax(name, cap, wild):
    st, jst, ids = build_pair(name)
    rng = np.random.default_rng(8)
    preds, keys, axes = _keys(rng, st, ids, 64, wild=wild)
    got = k2forest.scan_batch_mixed(st.meta, st.forest, _t(preds), _t(keys), _t(axes), cap)
    want = jk2forest.scan_batch_mixed(
        jst.meta, jst.forest, jnp.asarray(preds), jnp.asarray(keys), jnp.asarray(axes), cap, JNP,
    )
    _same_result(got, want)
    if cap <= 3:
        assert got.overflow.any()  # cap overflow is covered
    if wild:
        assert (got.count == 0).any()  # so are empty frontiers


@pytest.mark.parametrize("name,cap", [("preds16", 16), ("preds16", 1), ("preds600", 24), ("empty_preds", 2)])
def test_gather_matches_jax(name, cap):
    st, jst, _ = build_pair(name)
    rng = np.random.default_rng(9)
    n_rows = st.n_subjects + st.n_objects
    rows = _lanes(rng, 128, -20, n_rows + 20)
    for layout in ("dac", "fixed"):
        dev, pmeta = st.pred_index.select(layout)
        jdev, jpmeta = jst.pred_index.select(layout)
        got = predindex.gather_batch(pmeta, dev, _t(rows), cap)
        want = jpredindex.gather_batch(jpmeta, jdev, jnp.asarray(rows), cap, JNP)
        _same_result(got, want)
    if name == "preds600":
        assert st.pred_index.meta.levels >= 2


def test_pallas_kernels_as_reference():
    """Q=8, cap=16: the TPU kernels themselves (interpret mode) agree."""
    st, jst, ids = build_pair("preds16")
    rng = np.random.default_rng(10)
    preds, keys, axes = _keys(rng, st, ids, 8, wild=True)
    got = k2forest.scan_batch_mixed(st.meta, st.forest, _t(preds), _t(keys), _t(axes), 16)
    want = jk2forest.scan_batch_mixed(
        jst.meta, jst.forest, jnp.asarray(preds), jnp.asarray(keys), jnp.asarray(axes), 16, PALLAS,
    )
    _same_result(got, want)

    rows = _lanes(rng, 8, 0, st.n_subjects + st.n_objects)
    dev, pmeta = st.pred_index.select("dac")
    jdev, jpmeta = jst.pred_index.select("dac")
    _same_result(
        predindex.gather_batch(pmeta, dev, _t(rows), 16),
        jpredindex.gather_batch(jpmeta, jdev, jnp.asarray(rows), 16, PALLAS),
    )


def test_check_single_tree_matches_pallas_k2_check():
    """At P=1 the forest check is the single-tree Pallas ``k2_check``."""
    st, jst, ids = build_pair("preds1")
    rng = np.random.default_rng(11)
    q = 8
    rows = (ids[rng.integers(0, ids.shape[0], q), 0] - 1).astype(np.int32)
    cols = (ids[rng.integers(0, ids.shape[0], q), 2] - 1).astype(np.int32)
    rows[:3] = ids[:3, 0] - 1
    cols[:3] = ids[:3, 2] - 1
    rows[6] = -3
    f = jst.forest
    tree = jk2tree.K2Tree(
        t=jk2tree.BitVec(f.t_words[0], f.t_rank[0], 0),
        l=jk2tree.BitVec(f.l_words[0], jnp.zeros_like(f.l_words[0], jnp.int32), 0),
        ones_before=f.ones_before[0], level_start=f.level_start[0], nnz=0,
    )
    want = jops.k2_check_tree(jst.meta, tree, jnp.asarray(rows), jnp.asarray(cols), block_q=8)
    got = k2forest.check(st.meta, st.forest, _t(np.zeros(q)), _t(rows), _t(cols))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got[:3].all()


def test_wrappers_reject_bad_inputs():
    st, _, _ = build_pair("preds16")
    f, meta = st.forest, st.meta
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.k2_check(meta, f, z.to(torch.int64), z, z)
    with pytest.raises(ValueError):
        ops.k2_scan(meta, f, z, z, torch.zeros(5, dtype=torch.int32), cap=4)
    with pytest.raises(ValueError):
        ops.k2_scan(meta, f, z, z, z, cap=0)
    with pytest.raises(ValueError):
        ops.k2_check(meta, f, torch.zeros((4, 2), dtype=torch.int32)[:, 0], z, z)
