"""The three kernel paths of ``repro_torch`` against the JAX package, bit for bit.

``k2forest.check``, ``k2forest.scan_batch_mixed`` and
``predindex.gather_batch`` of the port (plain versions, CPU) against the
JAX package's jnp reference, including cap overflow, empty frontiers,
negative and out-of-range keys and predicates, and the 600-predicate
multi-level DAC store.  One tiny case per kernel also runs the Pallas
kernel itself in interpret mode as the reference.
"""

import functools

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


def _same_tuple(got, want, names):
    assert len(got) == len(want) == len(names)
    for g, w, name in zip(got, want, names):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert np.array_equal(g, w), name


PAIR_FIELDS = ("rows", "cols", "valid", "count", "overflow")
REBIND_FIELDS = ("x_ids", "x_valid", "x_count", "x_overflow",
                 "y_ids", "y_valid", "y_count", "y_overflow")


def _wild_preds(rng, n, q):
    """In-range predicates plus 0 - 1, P and far outside on both sides."""
    fixed = np.array([-1, n, -n - 3, 2 * n + 1], np.int32)
    return np.concatenate([fixed, _lanes(rng, q - fixed.size, 0, n)])


@pytest.mark.parametrize("name,cap", [("preds16", 8), ("empty_preds", 200)])
def test_range_matches_jax(name, cap):
    st, jst, _ = build_pair(name)
    preds = _wild_preds(np.random.default_rng(12), st.n_preds, 8)
    got = k2forest.range_scan_batch(st.meta, st.forest, _t(preds), cap)
    want = jk2forest.range_scan_batch(jst.meta, jst.forest, jnp.asarray(preds), cap, JNP)
    _same_tuple(got, want, PAIR_FIELDS)
    assert bool(got.overflow.any()) == (cap == 8)
    assert (got.count > 0).any()


def test_range_level0_bit_test_before_compaction():
    """cap 4 below the root radix 16, two cells in root children 0 and 15:
    both are found and nothing overflows (the fixed level-0 semantics)."""
    from repro_torch.core import k2tree

    meta = k2tree.K2Meta(k2tree.hybrid_ks(900))
    assert meta.radices[0] == 16
    f, _ = k2forest.build_forest([(np.array([3, 870]), np.array([5, 2]))], meta, "cpu")
    r = k2forest.first_lane(k2forest.range_scan_batch(meta, f, [0], 4))
    assert int(r.count) == 2 and not bool(r.overflow)
    assert r.rows[r.valid].tolist() == [3, 870] and r.cols[r.valid].tolist() == [5, 2]


def test_scan_rebind_matches_jax():
    """cap_x 3 and cap_y 2 overflow both phases; short X lists leave dead
    X slots, whose Y rows are the real scans of key 0."""
    cap_x, cap_y = 3, 2
    st, jst, ids = build_pair("preds16")
    rng = np.random.default_rng(13)
    preds1, keys1, axes1 = _keys(rng, st, ids, 6, wild=True)
    preds2 = _wild_preds(rng, st.n_preds, 6)
    axes2 = _lanes(rng, 6, 0, 2)
    args = (preds1, keys1, axes1, preds2, axes2)
    got = k2forest.scan_rebind_batch(st.meta, st.forest, *map(_t, args), cap_x, cap_y)
    want = jk2forest.scan_rebind_batch(
        jst.meta, jst.forest, *map(jnp.asarray, args), cap_x, cap_y, JNP,
    )
    _same_tuple(got, want, REBIND_FIELDS)
    x_valid = got[1]
    assert (~x_valid).any() and x_valid.any() and got[3].any() and got[7].any()
    q, i = (int(v) for v in (~x_valid).nonzero()[0])
    key0 = k2forest.scan_batch_mixed(
        st.meta, st.forest, _t(preds2[q:q + 1]), _t([0]), _t(axes2[q:q + 1]), cap_y
    )
    for y, k0 in zip(got[4:], key0):
        assert torch.equal(y[q, i], k0[0])


def test_slice2_pallas_kernels_as_reference():
    """The TPU kernels themselves (interpret mode) against the plain versions:
    ``k2_range`` (Q=8), ``k2_scan_rebind`` (Q=3, dead X slots) and the
    fixed-layout ``pred_gather`` at 1 and 2 bytes per predicate."""
    st, jst, ids = build_pair("preds16")
    rng = np.random.default_rng(14)
    preds = _wild_preds(rng, st.n_preds, 8)
    _same_tuple(
        k2forest.range_scan_batch(st.meta, st.forest, _t(preds), 16),
        jk2forest.range_scan_batch(jst.meta, jst.forest, jnp.asarray(preds), 16, PALLAS),
        PAIR_FIELDS,
    )
    preds1, keys1, axes1 = _keys(rng, st, ids, 3, wild=True)
    args = (preds1, keys1, axes1, _wild_preds(rng, st.n_preds, 4)[1:], _lanes(rng, 3, 0, 2))
    got = k2forest.scan_rebind_batch(st.meta, st.forest, *map(_t, args), 8, 4)
    _same_tuple(got, jk2forest.scan_rebind_batch(
        jst.meta, jst.forest, *map(jnp.asarray, args), 8, 4, PALLAS,
    ), REBIND_FIELDS)
    assert (~got[1]).any()
    for name, bpp in (("preds16", 1), ("preds600", 2)):
        st, jst, _ = build_pair(name)
        dev, pmeta = st.pred_index.select("fixed")
        jdev, jpmeta = jst.pred_index.select("fixed")
        assert pmeta.bytes_per_pred == bpp
        rows = _lanes(rng, 16, 0, st.n_subjects + st.n_objects)
        for cap in (1, pmeta.max_degree):
            _same_tuple(
                predindex.gather_batch(pmeta, dev, _t(rows), cap),
                jpredindex.gather_batch(jpmeta, jdev, jnp.asarray(rows), cap, PALLAS),
                ("ids", "valid", "count", "overflow"),
            )


def _morton_pairs(meta, rows, cols):
    """A tree's pairs sorted in Morton order: by the level digits
    ``(r // sub % k) · k + c // sub % k``, root level first."""
    digits = [(rows // sub % k) * k + cols // sub % k
              for k, sub in zip(meta.ks, meta.subsides)]
    order = np.lexsort(digits[::-1])
    return rows[order], cols[order]


def test_range_cap_cuts_a_middle_level():
    """cap holds every node of the shallow levels but not those of a middle
    one: overflow is set and the lane holds exactly the first cap pairs in
    Morton order, as in JAX's jnp traversal."""
    st, jst, ids = build_pair("preds16")
    meta = st.meta
    p = int(np.bincount(ids[:, 1]).argmax())  # 1-based
    rows, cols = ids[ids[:, 1] == p, 0] - 1, ids[ids[:, 1] == p, 2] - 1
    nodes = [np.unique((rows // sub) * (meta.side // sub + 1) + cols // sub).size
             for sub in meta.subsides]
    cut = next(j for j in range(2, meta.n_levels - 1) if nodes[j] > nodes[j - 1])
    cap = nodes[cut - 1]  # holds levels 0..cut-1, not level `cut`
    assert nodes[0] < nodes[1] <= cap < rows.size
    preds = np.array([p - 1, p - 1, 0, st.n_preds - 1], np.int32)
    got = k2forest.range_scan_batch(meta, st.forest, _t(preds), cap)
    want = jk2forest.range_scan_batch(jst.meta, jst.forest, jnp.asarray(preds), cap, JNP)
    _same_tuple(got, want, PAIR_FIELDS)
    assert bool(got.overflow[0]) and int(got.count[0]) == cap
    r, c = _morton_pairs(meta, rows, cols)
    assert np.array_equal(got.rows[0][got.valid[0]].numpy(), r[:cap])
    assert np.array_equal(got.cols[0][got.valid[0]].numpy(), c[:cap])


@functools.cache
def _wide_row_pair():
    """Two trees of the 4096-side geometry built by both packages: tree 0
    holds row 5 and column 9 full plus 300 random cells, tree 1 only 300
    random cells.  A full row's frontier is 4, 16, 64, 256, 1024, 2048 and
    4096 nodes, level by level."""
    from repro_torch.core import k2tree

    rng = np.random.default_rng(12)
    full = np.arange(4096)
    coords = []
    for rows, cols in (
        (np.concatenate([np.full(4096, 5), full]), np.concatenate([full, np.full(4096, 9)])),
        (np.zeros(0, np.int64), np.zeros(0, np.int64)),
    ):
        cells = np.unique(np.concatenate([rows * 4096 + cols, rng.integers(0, 4096**2, 300)]))
        coords.append((cells // 4096, cells % 4096))
    meta = k2tree.K2Meta(k2tree.hybrid_ks(4096))
    jmeta = jk2tree.K2Meta(jk2tree.hybrid_ks(4096))
    return meta, k2forest.build_forest(coords, meta, "cpu")[0], jmeta, jk2forest.build_forest(coords, jmeta)[0]


@pytest.mark.parametrize("cap", [2, 31, 32, 33, 100])
def test_scan_wide_rows_matches_jax(cap):
    """The plain scan against the jnp traversal where frontiers are wide:
    cap 2 cuts level 0 (4 root children), 31–33 straddle a warp's 32 at
    level 2 (64 nodes), 100 cuts level 3 (256) in the middle of the tree."""
    meta, f, jmeta, jf = _wide_row_pair()
    preds = np.array([0, 0, 1, -1, 0, 2, -3, 0], np.int32)
    keys = np.array([5, 9, 5, 9, 77, 5, 1234, -2], np.int32)
    axes = np.array([0, 1, 0, 1, 0, 1, 1, 0], np.int32)
    got = k2forest.scan_batch_mixed(meta, f, _t(preds), _t(keys), _t(axes), cap)
    want = jk2forest.scan_batch_mixed(
        jmeta, jf, jnp.asarray(preds), jnp.asarray(keys), jnp.asarray(axes), cap, JNP,
    )
    _same_result(got, want)
    assert got.overflow[:2].all() and (got.count[:2] == cap).all()
    assert np.array_equal(got.ids[0][:cap].numpy(), np.arange(cap))
