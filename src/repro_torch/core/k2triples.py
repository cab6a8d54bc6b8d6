"""K2TriplesStore — the paper's engine state: dictionary + per-predicate
forest + SP/OP index.

Builds the vertical-partitioned k²-tree arena from 1-based ID triples on the
host and places it on one device, keeps the |SO| boundary, and exposes the
paper's size accounting.  :func:`from_string_triples` builds the 4-range
dictionary (``core.dictionary``, front-coded by default) on the host, where
it stays, and the store from the encoded ids; ``from_id_triples`` stores
carry no dictionary.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from repro_torch.core import k2forest, k2tree, predindex
from repro_torch.core.dictionary import (
    CompressedTripleDictionary,
    TripleDictionary,
    build_compressed_dictionary,
    build_dictionary,
)
from repro_torch.core.k2forest import ForestStats, K2Forest
from repro_torch.core.k2tree import K2Meta
from repro_torch.core.predindex import BuiltPredIndex
from repro_torch.core.query import resolve_device


@dataclasses.dataclass(frozen=True)
class K2TriplesStore:
    meta: K2Meta
    forest: K2Forest
    stats: ForestStats | None  # None for stores converted from foreign arrays
    n_so: int  # |SO| — cross-joins live in [0, n_so)²
    n_subjects: int
    n_objects: int
    n_preds: int
    n_triples: int
    # k²-triples+ (arXiv:1310.4954) SP/OP index; None = all-preds sweep
    pred_index: BuiltPredIndex | None = None
    # the host-side term <-> id mapping; None for ID-level stores
    dictionary: TripleDictionary | CompressedTripleDictionary | None = dataclasses.field(
        default=None, kw_only=True)

    @property
    def device(self):
        return self.forest.device

    @functools.cached_property
    def host_nnz(self) -> np.ndarray:
        """Triples per predicate, on the host: the planner's statistics."""
        return self.forest.nnz.cpu().numpy()

    def to(self, device) -> "K2TriplesStore":
        return dataclasses.replace(
            self, forest=self.forest.to(device),
            pred_index=(None if self.pred_index is None
                        else self.pred_index.to(device)),
        )


def from_id_triples(
    ids: np.ndarray,
    *,
    n_so: int,
    n_subjects: int,
    n_objects: int,
    n_preds: int,
    dictionary: TripleDictionary | CompressedTripleDictionary | None = None,
    k4_levels: int = k2tree.HYBRID_K4_LEVELS,
    with_pred_index: bool = True,
    device="cuda",
) -> K2TriplesStore:
    """Build the store from int64[N,3] 1-based (s, p, o) ID triples."""
    device = resolve_device(device)
    ids = np.asarray(ids, dtype=np.int64).reshape(-1, 3)
    extent = max(n_subjects, n_objects, 1)
    meta = K2Meta(k2tree.hybrid_ks(extent, k4_levels))

    order = np.lexsort((ids[:, 2], ids[:, 0], ids[:, 1]))
    ids = ids[order]
    bounds = np.searchsorted(ids[:, 1], np.arange(1, n_preds + 2))
    coords = [
        (ids[bounds[p]: bounds[p + 1], 0] - 1, ids[bounds[p]: bounds[p + 1], 2] - 1)
        for p in range(n_preds)
    ]
    forest, stats = k2forest.build_forest(coords, meta, device)
    pidx = (
        predindex.build(
            ids, n_subjects=n_subjects, n_objects=n_objects, n_preds=n_preds,
            device=device,
        )
        if with_pred_index
        else None
    )
    return K2TriplesStore(
        meta=meta, forest=forest, stats=stats, n_so=n_so,
        n_subjects=n_subjects, n_objects=n_objects, n_preds=n_preds,
        n_triples=int(ids.shape[0]), pred_index=pidx, dictionary=dictionary,
    )


def from_string_triples(triples, *, compressed: bool = True, device="cuda") -> K2TriplesStore:
    """String triples -> store.  ``compressed=True`` (default) keeps the
    dictionary as front-coded byte pools (:class:`CompressedTripleDictionary`,
    same API); ``compressed=False`` keeps plain Python string tuples.  The
    dictionary stays on the host; the arenas go to ``device``."""
    device = resolve_device(device)
    d = build_compressed_dictionary(triples) if compressed else build_dictionary(triples)
    ids = np.unique(d.encode_triples(triples), axis=0)  # the paper cleans duplicates
    return from_id_triples(
        ids, n_so=d.n_so, n_subjects=d.n_subjects, n_objects=d.n_objects,
        n_preds=d.n_preds, dictionary=d, device=device,
    )


# ---------------------------------------------------------------------------
# analytic size baselines (Table 2 comparisons, ID-space as in the paper)
# ---------------------------------------------------------------------------


def size_k2triples_bits(store: K2TriplesStore, *, with_rank: bool = False) -> int:
    """|T|+|L| summed over predicates; with_rank adds the int32-per-word rank
    directory the arena materializes."""
    if store.stats is None:
        raise ValueError("converted store carries no build stats")
    bits = store.stats.total_bits
    if with_rank:
        bits += store.stats.total_bits
    return bits


def size_pred_index_bits(store: K2TriplesStore) -> int:
    """SP+OP index overhead (payload + row pointers), 0 when not built."""
    if store.pred_index is None:
        return 0
    st = store.pred_index.stats
    if st is None:
        raise ValueError("converted store carries no index stats")
    return st.payload_bits + st.offsets_bits


def size_dictionary_bits(store: K2TriplesStore) -> int:
    """Measured dictionary bits: front-coded pools + EF offset indexes for a
    :class:`CompressedTripleDictionary`; raw UTF-8 bytes for a plain
    :class:`TripleDictionary`; 0 for ID-only stores."""
    d = store.dictionary
    if d is None:
        return 0
    if isinstance(d, CompressedTripleDictionary):
        return d.size_bits()
    return 8 * sum(
        len(t.encode())
        for terms in (d.so_terms, d.s_terms, d.o_terms, d.p_terms)
        for t in terms
    )


def size_raw_triples_bits(n_triples: int) -> int:
    return 3 * 32 * n_triples


def size_vertical_tables_bits(n_triples: int) -> int:
    """MonetDB-style: per-predicate [S,O] 2-column tables."""
    return 2 * 32 * n_triples


def size_sextuple_gap_bits(ids: np.ndarray) -> int:
    """RDF-3X-style: 6 sort orders, leading-column delta + varint bytes."""
    ids = np.asarray(ids, dtype=np.int64)
    total_bytes = 0
    for perm in ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)):
        arr = ids[:, perm]
        order = np.lexsort((arr[:, 2], arr[:, 1], arr[:, 0]))
        arr = arr[order]
        delta = arr.copy()
        delta[1:, 0] = arr[1:, 0] - arr[:-1, 0]
        same0 = delta[1:, 0] == 0
        delta[1:, 1] = np.where(same0, arr[1:, 1] - arr[:-1, 1], arr[1:, 1])
        same01 = same0 & (delta[1:, 1] == 0)
        delta[1:, 2] = np.where(same01, arr[1:, 2] - arr[:-1, 2], arr[1:, 2])
        v = np.abs(delta)
        nbytes = np.maximum(1, np.ceil(np.log2(v + 2) / 7)).sum()
        total_bytes += int(nbytes)
    return total_bytes * 8
