"""The single-tree k²-tree API of ``repro_torch`` against the JAX package's,
exactly (values, dtypes and shapes of every field; tolerance: equality):

* ``bitvec``: ``bitvec_from_bits`` and the 1-D ``get_bit`` / ``rank1``,
  with positions before the start and past the end;
* ``k2tree.build``'s words, ranks and level tables byte for byte, and
  ``size_bits`` of host arrays and trees;
* ``check``, ``row_scan``, ``col_scan`` and ``range_scan``, and
  ``ops.k2_check_tree`` against the Pallas ``k2_check_tree`` in interpret
  mode, on empty, full, one-cell H = 1, random, dense-row and 3-ary trees,
  at caps below the root arity and the range level-0 overflow, with
  negative and too-large keys;
* ``convert.tree_from_arrays`` on a JAX tree;
* the lazy re-exports of ``repro_torch.core``.

The JAX side runs under ``jax.jit`` with static metas and caps (one
compile per case and cap).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitvec as jbitvec
from repro.core import k2tree as jk2tree
from repro.kernels import ops as jops
from repro_torch.core import bitvec, convert, k2tree
from repro_torch.kernels import ops

_RNG = np.random.default_rng(0)


def _random_cells(side, n, rng=_RNG):
    return rng.integers(0, side, n), rng.integers(0, side, n)


# case -> (ks, cells as (rows, cols), caps of the scans and the range)
CASES = {
    "empty": (k2tree.hybrid_ks(100), (np.zeros(0, np.int64), np.zeros(0, np.int64)), (2,)),
    # every cell of an 8 x 8 matrix: 16 root children set, 64 leaves
    "full": (k2tree.hybrid_ks(8), tuple(np.indices((8, 8)).reshape(2, -1)), (3, 16)),
    # side 3 -> one level of k = 4 (H = 1): T is empty, level 0 is L
    "one_cell_h1": (k2tree.hybrid_ks(3), (np.array([2]), np.array([1])), (1, 4)),
    "full_h1": (k2tree.hybrid_ks(4), tuple(np.indices((4, 4)).reshape(2, -1)), (2, 17)),
    "random": (k2tree.hybrid_ks(1000), _random_cells(1000, 2000), (3, 64)),
    # row 0 holds 60 cells: scans of row 0 overflow any cap below 60
    "dense_row": (k2tree.hybrid_ks(64), (np.zeros(60, np.int64), np.arange(60)), (16,)),
    "ks_333": ((3, 3, 3), _random_cells(27, 80), (2, 32)),
}


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same(got, want):
    """Field-by-field equality of two result tuples (or two arrays)."""
    if isinstance(want, tuple):
        assert type(got).__name__ == type(want).__name__ and got._fields == want._fields
        for g, w in zip(got, want):
            same(g, w)
        return
    g, w = np_of(got), np_of(want)
    if w.dtype == np.uint32:
        g = g.view(np.uint32)
    assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
    assert np.array_equal(g, w)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    ks, (rows, cols), caps = CASES[request.param]
    jmeta = jk2tree.K2Meta(tuple(ks))
    meta = k2tree.K2Meta(tuple(ks))
    jtree = jk2tree.build(rows, cols, jmeta)
    tree = k2tree.build(rows, cols, meta, device="cpu")
    return request.param, meta, tree, jmeta, jtree, (rows, cols), caps


def _keys(side):
    """Keys of every kind: negative, in range, at and past the side."""
    keys = [-(2**31), -3, -1, 0, 1, side // 2, side - 1, side, side + 5, 2**20, 2**31 - 1]
    return np.array(sorted(set(keys)), np.int32)


def _lanes(side, n=48, seed=1):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-3, side + 3, n).astype(np.int32)
    cols = rng.integers(-3, side + 3, n).astype(np.int32)
    rows[:6] = [-(2**31), -1, side, 2**20, 2**31 - 1, 0]
    cols[6:12] = [-(2**31), -1, side, 2**20, 2**31 - 1, 0]
    return rows, cols


_JIT = {}


def _jax_tree_queries(meta, tree, rows, cols, keys, cap):
    """check, vmapped row and column scans over ``keys`` and range_scan."""
    rs = jax.vmap(lambda k: jk2tree.row_scan(meta, tree, k, cap))(keys)
    cs = jax.vmap(lambda k: jk2tree.col_scan(meta, tree, k, cap))(keys)
    return jk2tree.check(meta, tree, rows, cols), rs, cs, jk2tree.range_scan(meta, tree, cap)


def jax_queries(meta, tree, rows, cols, keys, cap):
    fn = _JIT.setdefault("q", jax.jit(_jax_tree_queries, static_argnums=(0, 5)))
    return fn(meta, tree, jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(keys), cap)


def _jax_bitvec(words, rank_blocks, pos):
    return jbitvec.get_bit(words, pos), jbitvec.rank1(words, rank_blocks, pos)


def test_bitvec_1d_like_jax():
    rng = np.random.default_rng(3)
    fn = jax.jit(_jax_bitvec)
    for n in (0, 33, 200):
        bits = (rng.random(n) < 0.4).astype(np.uint8)
        jb = jbitvec.bitvec_from_bits(bits)
        b = bitvec.bitvec_from_bits(bits, "cpu")
        assert b.n_bits == jb.n_bits == n
        same(b.words, np.asarray(jb.words))
        same(b.rank_blocks, np.asarray(jb.rank_blocks))
        # every position from 40 before the start to 70 past the end, and
        # the int32 extremes, as a (2, 156) index array
        pos = np.concatenate([np.arange(-40, 270), [-(2**31), 2**31 - 1]]).astype(np.int32)
        pos = pos.reshape(2, -1)
        got = (bitvec.get_bit(b.words, torch.from_numpy(pos)),
               bitvec.rank1(b.words, b.rank_blocks, torch.from_numpy(pos)))
        for g, w in zip(got, fn(jb.words, jb.rank_blocks, jnp.asarray(pos))):
            same(g, w)


def test_build_byte_for_byte_and_size_bits(case):
    _, meta, tree, jmeta, jtree, (rows, cols), _ = case
    for part in ("t", "l"):
        got, want = getattr(tree, part), getattr(jtree, part)
        same(got.words, np.asarray(want.words))
        same(got.rank_blocks, np.asarray(want.rank_blocks))
        assert got.n_bits == want.n_bits
    same(tree.ones_before, np.asarray(jtree.ones_before))
    same(tree.level_start, np.asarray(jtree.level_start))
    assert tree.nnz == jtree.nnz
    assert k2tree.size_bits(tree) == jk2tree.size_bits(jtree)
    assert (k2tree.size_bits(k2tree.build_host(rows, cols, meta))
            == jk2tree.size_bits(jk2tree.build_host(rows, cols, jmeta)))


def test_queries_like_jax(case):
    name, meta, tree, jmeta, jtree, _, caps = case
    rows, cols = _lanes(meta.side)
    keys = _keys(meta.side)
    for cap in caps:
        jcheck, jrows, jcols, jrange = jax_queries(jmeta, jtree, rows, cols, keys, cap)
        same(k2tree.check(meta, tree, torch.from_numpy(rows), torch.from_numpy(cols)), jcheck)
        for i, key in enumerate(keys):
            for fn, want in ((k2tree.row_scan, jrows), (k2tree.col_scan, jcols)):
                got = fn(meta, tree, int(key), cap)
                same(got, type(want)(*(np.asarray(a)[i] for a in want)))
        same(k2tree.range_scan(meta, tree, cap), jrange)
    # any index shape, as JAX's elementwise check: 2-D, 0-d, broadcast
    jcheck = np.asarray(jcheck)
    t_rows, t_cols = torch.from_numpy(rows), torch.from_numpy(cols)
    same(k2tree.check(meta, tree, t_rows.reshape(6, 8), t_cols.reshape(6, 8)),
         jcheck.reshape(6, 8))
    same(k2tree.check(meta, tree, t_rows[7], t_cols[7]), jcheck[7])
    same(k2tree.check(meta, tree, t_rows[:1], t_cols[:12]),
         np.asarray(jk2tree.check(jmeta, jtree, jnp.asarray(rows[:1]), jnp.asarray(cols[:12]))))
    if name == "dense_row":  # a row scan below the row's 60 cells overflows
        assert bool(k2tree.row_scan(meta, tree, 0, caps[0]).overflow)
    if name == "full":  # 16 occupied root children: the range overflows at level 0
        r = k2tree.range_scan(meta, tree, caps[0])
        assert bool(r.overflow) and int(r.count) == caps[0]
    if meta.ks[0] > caps[0]:  # the first root children already exceed the cap
        assert bool(k2tree.row_scan(meta, tree, 0, caps[0]).overflow)


def test_k2_check_tree_like_pallas(case):
    _, meta, tree, jmeta, jtree, _, _ = case
    rows, cols = _lanes(meta.side, n=40, seed=4)
    fn = _JIT.setdefault("pallas", jax.jit(jops.k2_check_tree, static_argnums=0,
                                           static_argnames=("block_q",)))
    want = fn(jmeta, jtree, jnp.asarray(rows), jnp.asarray(cols), block_q=32)
    n0 = ops.LAUNCHES["k2_check"]
    got = ops.k2_check_tree(meta, tree, torch.from_numpy(rows), torch.from_numpy(cols))
    same(got, want)
    assert ops.LAUNCHES["k2_check"] == n0  # the CPU runs the plain version


def test_scan_refuses_a_batch_key(case):
    _, meta, tree, *_ = case
    with pytest.raises(ValueError):
        k2tree.row_scan(meta, tree, torch.tensor([0, 1], dtype=torch.int32), 4)


def test_tree_from_arrays_of_a_jax_tree(case):
    _, meta, tree, jmeta, jtree, _, caps = case

    def vec(b):
        return np.asarray(b.words), np.asarray(b.rank_blocks), b.n_bits

    got = convert.tree_from_arrays(
        t=vec(jtree.t), l=vec(jtree.l), ones_before=np.asarray(jtree.ones_before),
        level_start=np.asarray(jtree.level_start), nnz=jtree.nnz, device="cpu",
    )
    for part in ("t", "l"):
        for field in ("words", "rank_blocks"):
            assert torch.equal(getattr(getattr(got, part), field),
                               getattr(getattr(tree, part), field))
        assert getattr(got, part).n_bits == getattr(tree, part).n_bits
    assert torch.equal(got.ones_before, tree.ones_before)
    assert torch.equal(got.level_start, tree.level_start)
    assert got.nnz == tree.nnz
    same(k2tree.range_scan(meta, got, caps[-1]), k2tree.range_scan(meta, tree, caps[-1]))


def test_tree_from_arrays_refuses_bad_shapes(monkeypatch):
    jt = jk2tree.build(np.array([1]), np.array([2]), jk2tree.K2Meta((4, 4)))
    t = (np.asarray(jt.t.words), np.asarray(jt.t.rank_blocks), jt.t.n_bits)
    l_ = (np.asarray(jt.l.words), np.asarray(jt.l.rank_blocks), jt.l.n_bits)
    tables = dict(ones_before=np.asarray(jt.ones_before),
                  level_start=np.asarray(jt.level_start), nnz=1, device="cpu")
    assert convert.tree_from_arrays(t=t, l=l_, **tables).nnz == 1
    with pytest.raises(ValueError, match="bits"):
        convert.tree_from_arrays(t=(t[0], t[1], t[2] + 64), l=l_, **tables)
    with pytest.raises(ValueError, match="bits"):
        convert.tree_from_arrays(t=t, l=(l_[0], l_[1][:0], l_[2]), **tables)
    with pytest.raises(ValueError, match="level tables"):
        convert.tree_from_arrays(t=t, l=l_, **dict(tables, ones_before=np.zeros(3, np.int32)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        convert.tree_from_arrays(t=t, l=l_, **dict(tables, device="cuda"))


def test_core_reexports_lazily():
    code = (
        "import sys, repro_torch.core as c\n"
        "assert not [m for m in sys.modules if m.startswith(('repro_torch.core.engine',"
        " 'repro_torch.kernels'))], sorted(sys.modules)\n"
        "from repro_torch.core import query, engine\n"
        "names = ('ExecConfig', 'ObsConfig', 'CapPolicy', 'CapOverflow', 'Plan',"
        " 'TriplePatternQ', 'JoinQ', 'BgpQ', 'ServeQ')\n"
        "assert all(getattr(c, n) is getattr(query, n) for n in names)\n"
        "assert c.Engine is engine.Engine\n"
        "try:\n    c.Nope\nexcept AttributeError:\n    pass\nelse:\n    raise SystemExit(1)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(root, "src"), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
