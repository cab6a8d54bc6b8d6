"""Store arenas of ``repro_torch`` against the JAX package's, bit for bit.

Forest words (as uint32), rank directories, ``ones_before``,
``level_start``, ``nnz``, every DAC and fixed-layout index array and the
``PredIndexMeta`` must be identical for the same ID triples.  Also covers
the bit-vector helpers and the store carried across by ``core.convert``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitvec as jbitvec
from repro.core import k2triples as jk2triples
from repro.data import rdf as jrdf
from repro_torch.core import bitvec, convert, engine as eng, k2triples
from repro_torch.core.query import ExecConfig, ServeQ
from repro_torch.data import rdf

FOREST_FIELDS = ("t_words", "t_rank", "l_words", "ones_before", "level_start", "nnz")
INDEX_FIELDS = ("offsets", "words", "degs", "flags", "frank")


def _ids_single_level():
    # 3 subjects x 4 objects: extent 4 -> ks == (4,), one tree level
    return np.array([[1, 1, 1], [1, 2, 4], [2, 1, 3], [3, 2, 2], [3, 2, 4]], np.int64), 3, 4, 2


def _ids_empty_preds():
    # predicates 2, 4 and 5 of 5 have no triples
    rng = np.random.default_rng(5)
    s = rng.integers(1, 40, 300)
    p = rng.choice([1, 3], 300)
    o = rng.integers(1, 50, 300)
    return np.unique(np.stack([s, p, o], 1), axis=0), 40, 50, 5


def _dataset(name):
    """(ids, n_subjects, n_objects, n_preds, n_so) of a named test corpus."""
    if name == "single_level":
        ids, ns, no, npred = _ids_single_level()
        return ids, ns, no, npred, 1
    if name == "empty_preds":
        ids, ns, no, npred = _ids_empty_preds()
        return ids, ns, no, npred, 10
    n_preds = {"preds1": 1, "preds16": 16, "preds600": 600}[name]
    kw = dict(n_subjects=90, n_preds=n_preds, n_objects=120, seed=11)
    if n_preds == 600:
        kw.update(n_subjects=150, n_objects=150, pred_alpha=1.0)
    ds = rdf.generate(2500 if n_preds == 600 else 1200, **kw)
    return ds.ids, ds.n_subjects, ds.n_objects, ds.n_preds, ds.n_so


STORES = ("preds1", "preds16", "preds600", "single_level", "empty_preds")


def build_pair(name):
    """The same corpus built by both packages: (port store on CPU, JAX store, ids)."""
    ids, ns, no, npred, nso = _dataset(name)
    kw = dict(n_so=nso, n_subjects=ns, n_objects=no, n_preds=npred)
    return (
        k2triples.from_id_triples(ids, device="cpu", **kw),
        jk2triples.from_id_triples(ids, **kw),
        ids,
    )


def test_generators_match_jax():
    a = rdf.generate(800, n_subjects=40, n_preds=7, n_objects=60, preds_per_subject=3, seed=2)
    b = jrdf.generate(800, n_subjects=40, n_preds=7, n_objects=60, preds_per_subject=3, seed=2)
    assert np.array_equal(a.ids, b.ids) and a.n_so == b.n_so
    c, d = rdf.generate_like("geonames", 3000, seed=4), jrdf.generate_like("geonames", 3000, seed=4)
    assert np.array_equal(c.ids, d.ids) and c.n_preds == d.n_preds


@pytest.mark.parametrize("name", STORES)
def test_forest_arenas_identical(name):
    st, jst, ids = build_pair(name)
    assert st.meta.ks == jst.meta.ks
    assert k2triples.size_sextuple_gap_bits(ids) == jk2triples.size_sextuple_gap_bits(ids)
    got = st.forest.numpy()
    for f in FOREST_FIELDS:
        want = np.asarray(getattr(jst.forest, f))
        assert got[f].dtype == want.dtype, f
        assert np.array_equal(got[f], want), f
    assert st.stats.total_bits == jst.stats.total_bits
    assert st.stats.padded_bits == jst.stats.padded_bits
    assert k2triples.size_k2triples_bits(st, with_rank=True) == jk2triples.size_k2triples_bits(jst, with_rank=True)
    assert k2triples.size_pred_index_bits(st) == jk2triples.size_pred_index_bits(jst)
    n = st.n_triples
    assert k2triples.size_raw_triples_bits(n) == jk2triples.size_raw_triples_bits(n)
    assert k2triples.size_vertical_tables_bits(n) == jk2triples.size_vertical_tables_bits(n)
    if name == "single_level":
        assert st.meta.n_levels == 1


@pytest.mark.parametrize("name", STORES)
def test_pred_index_arrays_identical(name):
    st, jst, _ = build_pair(name)
    for layout in ("dac", "fixed"):
        dev, meta = st.pred_index.select(layout)
        jdev, jmeta = jst.pred_index.select(layout)
        assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta), layout
        got = dev.numpy()
        for f in INDEX_FIELDS:
            want = np.asarray(getattr(jdev, f))
            assert got[f].dtype == want.dtype and np.array_equal(got[f], want), (layout, f)
    assert st.pred_index.stats == jst.pred_index.stats
    assert np.array_equal(st.pred_index.host_offsets, jst.pred_index.host_offsets)
    assert np.array_equal(st.pred_index.host_preds, jst.pred_index.host_preds)
    if name == "preds600":
        assert st.pred_index.meta.bytes_per_pred == 2
        assert st.pred_index.meta.levels >= 2


def test_bitvec_matches_jax():
    rng = np.random.default_rng(1)
    words = rng.integers(0, 2**32, (3, 9), dtype=np.uint64).astype(np.uint32)
    rank = np.stack([jbitvec.rank_blocks_np(w) for w in words])
    pos = rng.integers(-70, 9 * 32 + 70, 400).astype(np.int32)
    row = rng.integers(-5, 6, 400).astype(np.int32)
    tw = torch.from_numpy(words.view(np.int32))
    assert np.array_equal(bitvec.popcount32(bitvec.u32(tw)).numpy(), jbitvec.popcount_np(words))
    assert np.array_equal(bitvec.rank_blocks_np(words[0]), rank[0])
    got_bit = bitvec.get_bit_2d(tw, torch.from_numpy(row), torch.from_numpy(pos)).numpy()
    want_bit = np.asarray(jbitvec.get_bit_2d(jnp.asarray(words), jnp.asarray(row), jnp.asarray(pos)))
    assert np.array_equal(got_bit, want_bit)
    got_rank = bitvec.rank1_2d(tw, torch.from_numpy(rank), torch.from_numpy(row), torch.from_numpy(pos)).numpy()
    want_rank = np.asarray(jbitvec.rank1_2d(jnp.asarray(words), jnp.asarray(rank), jnp.asarray(row), jnp.asarray(pos)))
    assert np.array_equal(got_rank, want_rank)


def test_convert_matches_own_build():
    st, jst, ids = build_pair("preds16")
    bi = jst.pred_index
    carried = convert.store_from_arrays(
        ks=jst.meta.ks,
        forest={f: np.asarray(getattr(jst.forest, f)) for f in FOREST_FIELDS},
        index={f: np.asarray(getattr(bi.device, f)) for f in INDEX_FIELDS},
        index_meta=dataclasses.asdict(bi.meta),
        n_so=jst.n_so, n_subjects=jst.n_subjects, n_objects=jst.n_objects,
        n_preds=jst.n_preds, n_triples=jst.n_triples, device="cpu",
    )
    assert carried.meta == st.meta
    assert carried.pred_index.meta == st.pred_index.meta
    a, b = carried.forest.numpy(), st.forest.numpy()
    for f in FOREST_FIELDS:
        assert np.array_equal(a[f], b[f]), f
    a, b = carried.pred_index.device.numpy(), st.pred_index.device.numpy()
    for f in INDEX_FIELDS:
        assert np.array_equal(a[f], b[f]), f
    # the carried store serves the same answers as the built one
    rng = np.random.default_rng(3)
    rows = ids[rng.integers(0, ids.shape[0], 24)]
    op = rng.integers(0, 6, 24).astype(np.int32)
    batch = eng.ServeBatch(op, rows[:, 0].astype(np.int32),
                           np.where(op >= 3, 0, rows[:, 1]).astype(np.int32),
                           rows[:, 2].astype(np.int32))
    cfg = ExecConfig(cap=64, device="cpu")
    r1 = eng.host_result(eng.Engine(carried, device="cpu").compile(ServeQ(), cfg)(batch))
    r2 = eng.host_result(eng.Engine(st, device="cpu").compile(ServeQ(), cfg)(batch))
    for f in eng.RESULT_FIELDS:
        assert np.array_equal(getattr(r1, f), getattr(r2, f)), f


def test_convert_rejects_bad_arrays():
    _, jst, _ = build_pair("preds1")
    forest = {f: np.asarray(getattr(jst.forest, f)) for f in FOREST_FIELDS}
    with pytest.raises(ValueError):
        convert.store_from_arrays(
            ks=jst.meta.ks + (2,), forest=forest, n_so=0, n_subjects=1,
            n_objects=1, n_preds=jst.n_preds, n_triples=1, device="cpu",
        )
    del forest["nnz"]
    with pytest.raises(ValueError):
        convert.store_from_arrays(
            ks=jst.meta.ks, forest=forest, n_so=0, n_subjects=1,
            n_objects=1, n_preds=jst.n_preds, n_triples=1, device="cpu",
        )
