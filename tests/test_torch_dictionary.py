"""The string dictionary of ``repro_torch`` against the JAX package's.

Elias–Fano, the front-coded pool and the three dictionary classes give the
same ids, decodes, sizes and ``KeyError``s as ``repro.core.dictionary``;
the batched ``encode_triples`` equals the JAX per-term encode (absent terms
included); ``from_string_triples`` builds arenas byte-identical to the JAX
store's; and the string corpora (``to_strings``, ``generate_strings``,
``parse_n3``) are the same lists.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import dictionary as jdict
from repro.core import k2triples as jk2triples
from repro.data import rdf as jrdf
from repro_torch.core import dictionary, k2triples
from repro_torch.data import rdf
from test_torch_store import FOREST_FIELDS, INDEX_FIELDS

CORPUS = rdf.generate_strings(3000, like="geonames", seed=4)
BUILDERS = {
    "plain": (dictionary.build_dictionary, jdict.build_dictionary),
    "compressed": (dictionary.build_compressed_dictionary, jdict.build_compressed_dictionary),
}
UNSEEN = ("http://nowhere/at/all", "", CORPUS[0][0] + "x", CORPUS[0][1])


def _pair(kind, triples=CORPUS):
    mine, theirs = BUILDERS[kind]
    return mine(triples), theirs(triples)


def same_arenas(st, jst):
    """Every forest and SP/OP index array (both layouts) equal in dtype and
    bits, and the same geometry and counts."""
    for attr in ("n_so", "n_subjects", "n_objects", "n_preds", "n_triples"):
        assert getattr(st, attr) == getattr(jst, attr), attr
    assert st.meta.ks == jst.meta.ks
    got = st.forest.numpy()
    for f in FOREST_FIELDS:
        want = np.asarray(getattr(jst.forest, f))
        assert got[f].dtype == want.dtype and np.array_equal(got[f], want), f
    assert (st.pred_index is None) == (jst.pred_index is None)
    if st.pred_index is None:
        return
    for layout in ("dac", "fixed"):
        dev, meta = st.pred_index.select(layout)
        jdev, jmeta = jst.pred_index.select(layout)
        assert dataclasses.asdict(meta) == dataclasses.asdict(jmeta), layout
        got = dev.numpy()
        for f in INDEX_FIELDS:
            want = np.asarray(getattr(jdev, f))
            assert got[f].dtype == want.dtype and np.array_equal(got[f], want), (layout, f)


def _extended_pair(kind):
    d = dictionary.ExtendedDictionary(_pair(kind)[0])
    jd = jdict.ExtendedDictionary(_pair(kind)[1])
    for x in (d, jd):
        x.add_term("zz:new-a")
        x.add_term(CORPUS[3][0])  # a base term: no mint
        x.add_term("zz:new-b")
        x.add_predicate("zz:p")
        x.add_predicate(CORPUS[0][1])
    return d, jd


def _same_outcome(fn, jfn, term):
    try:
        want = jfn(term)
    except KeyError as e:
        with pytest.raises(KeyError) as got:
            fn(term)
        assert got.value.args == e.args
        return
    assert fn(term) == want


def test_string_corpora_match_jax():
    assert CORPUS == jrdf.generate_strings(3000, like="geonames", seed=4)
    assert rdf.generate_strings(500, n_subjects=30, n_preds=4, n_objects=40, seed=2) == \
        jrdf.generate_strings(500, n_subjects=30, n_preds=4, n_objects=40, seed=2)
    ds = rdf.generate(400, n_subjects=20, n_preds=3, n_objects=25, seed=7)
    assert rdf.to_strings(ds) == jrdf.to_strings(ds)
    text = "\n".join([
        "# a comment", "",
        '<http://a/s> <http://a/p> <http://a/o> .',
        '<http://a/s>  <http://a/q> "a \\"quoted\\" literal" .',
        "_:b0 <http://a/p> plain-token",
        '<s> <p> "x y"',
    ])
    assert rdf.parse_n3(text) == jrdf.parse_n3(text)
    with pytest.raises(ValueError):
        rdf.parse_n3("<a> <b> .")
    with pytest.raises(ValueError):
        jrdf.parse_n3("<a> <b> .")


@pytest.mark.parametrize("values", [[], [0], list(range(64)), [i * 977 for i in range(100)],
                                    [0, 0, 3, 3, 3, 90, 1000, 1000, 70000]])
def test_elias_fano_matches_jax(values):
    ef, jef = dictionary.EliasFano(values), jdict.EliasFano(values)
    assert [ef[i] for i in range(len(ef))] == [jef[i] for i in range(len(jef))] == values
    assert (ef.size_bits(), ef.analytic_bits(), ef.universe) == \
        (jef.size_bits(), jef.analytic_bits(), jef.universe)
    for a, b in ((ef._low, jef._low), (ef._high, jef._high), (ef._cum, jef._cum)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("bucket", [1, 3, 8])
def test_front_coded_pool_matches_jax(bucket):
    terms = sorted({t for tr in CORPUS[:800] for t in tr} | {"", "aé", "aé中", "中文"})
    fc, jfc = dictionary.FrontCodedStrings(terms, bucket), jdict.FrontCodedStrings(terms, bucket)
    assert fc._blob == jfc._blob
    assert (fc.size_bits(), fc.analytic_bits(), fc.size_bytes()) == \
        (jfc.size_bits(), jfc.analytic_bits(), jfc.size_bytes())
    assert fc.terms() == terms == [jfc[i] for i in range(len(jfc))]
    for i, t in enumerate(terms):
        assert fc[i] == t and fc.locate(t) == jfc.locate(t) == i
    for t in UNSEEN + ("zzzz", terms[-1] + "!"):
        assert fc.locate(t) == jfc.locate(t)


@pytest.mark.parametrize("kind", ["plain", "compressed", "extended-plain", "extended-compressed"])
def test_dictionary_ids_decodes_sizes_match_jax(kind):
    if kind.startswith("extended"):
        d, jd = _extended_pair(kind.split("-")[1])
    else:
        d, jd = _pair(kind)
    for attr in ("n_so", "n_subjects", "n_objects", "n_preds", "matrix_extent"):
        assert getattr(d, attr) == getattr(jd, attr), attr
    if not kind.startswith("extended"):
        assert (d.so_terms, d.s_terms, d.o_terms, d.p_terms) == \
            (jd.so_terms, jd.s_terms, jd.o_terms, jd.p_terms)
    if kind == "compressed":
        assert (d.size_bits(), d.analytic_bits(), d.raw_bits()) == \
            (jd.size_bits(), jd.analytic_bits(), jd.raw_bits())
    terms = [t for tr in CORPUS[:300] for t in tr] + list(UNSEEN) + ["zz:new-a", "zz:p"]
    for t in terms:
        for role in ("subject", "object", "predicate"):
            _same_outcome(getattr(d, f"encode_{role}"), getattr(jd, f"encode_{role}"), t)
    ids = jd.encode_triples(CORPUS[:300])
    for s, p, o in ids.tolist():
        assert d.decode_subject(s) == jd.decode_subject(s)
        assert d.decode_predicate(p) == jd.decode_predicate(p)
        assert d.decode_object(o) == jd.decode_object(o)
    if kind.startswith("extended"):
        top = d.ext_base + d.n_ext_terms
        assert d.decode_subject(top) == jd.decode_subject(top) == "zz:new-b"
        assert d.decode_predicate(d.n_preds) == jd.decode_predicate(jd.n_preds) == "zz:p"


@pytest.mark.parametrize("kind", ["plain", "compressed", "extended-plain", "extended-compressed"])
def test_batched_encode_equals_per_term_encode(kind):
    if kind.startswith("extended"):
        d, jd = _extended_pair(kind.split("-")[1])
        extra = [("zz:new-a", "zz:p", CORPUS[5][2]), (CORPUS[1][0], CORPUS[1][1], "zz:new-b")]
    else:
        d, jd = _pair(kind)
        extra = []
    rng = np.random.default_rng(1)
    # every role, shuffled, with terms crossing roles (an SO term as object)
    triples = [CORPUS[i] for i in rng.permutation(len(CORPUS))] + extra
    got = d.encode_triples(iter(triples))
    want = jd.encode_triples(triples)
    assert got.dtype == want.dtype == np.int64 and np.array_equal(got, want)
    assert d.encode_triples([]).shape == jd.encode_triples([]).shape == (0, 3)
    # an absent term anywhere: the KeyError of the first triple holding one
    for pos in range(3):
        bad = list(triples[:50])
        t = list(bad[20])
        t[pos] = "http://absent/term"
        bad[20] = tuple(t)
        bad[40] = ("http://absent/first?", bad[40][1], bad[40][2])
        with pytest.raises(KeyError) as e_want:
            jd.encode_triples(bad)
        with pytest.raises(KeyError) as e_got:
            d.encode_triples(bad)
        assert e_got.value.args == e_want.value.args


def test_batched_encode_terms_ending_in_nul():
    """numpy's fixed-width strings drop trailing NULs: such a batch takes
    the per-term path and still equals the JAX encode."""
    triples = [("a\0", "p", "b"), ("a", "p", "b\0"), ("b", "p", "a")]
    for kind in ("plain", "compressed"):
        d, jd = _pair(kind, triples)
        assert np.array_equal(d.encode_triples(triples), jd.encode_triples(triples))
        with pytest.raises(KeyError):
            d.encode_triples([("a\0\0", "p", "b")])


@pytest.mark.parametrize("compressed", [True, False])
def test_from_string_triples_arenas_identical(compressed):
    st = k2triples.from_string_triples(CORPUS, compressed=compressed, device="cpu")
    jst = jk2triples.from_string_triples(CORPUS, compressed=compressed)
    assert type(st.dictionary).__name__ == type(jst.dictionary).__name__
    same_arenas(st, jst)
    assert k2triples.size_dictionary_bits(st) == jk2triples.size_dictionary_bits(jst) > 0
    assert k2triples.size_k2triples_bits(st) == jk2triples.size_k2triples_bits(jst)
    # an ID store carries no dictionary; the field is keyword-only
    ids = k2triples.from_id_triples(np.array([[1, 1, 1]]), n_so=1, n_subjects=1,
                                    n_objects=1, n_preds=1, device="cpu")
    assert ids.dictionary is None and k2triples.size_dictionary_bits(ids) == 0
    assert st.to("cpu").dictionary is st.dictionary
