"""Carry a store or a tree built elsewhere (the JAX package) across as
numpy arrays.

The forest arenas, the DAC SP/OP index arrays and the static geometry are
all the state a ``K2TriplesStore`` serves from; the index's host CSR is
what the planner reads, so a converted store plans exactly as the store it
came from when the CSR comes along.  A single ``K2Tree`` is its two bit
vectors and its level tables.  This module wraps them in this package's
types on a device, without rebuilding anything and without importing the
package that built them.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import bitvec, k2forest, predindex
from repro_torch.core.bitvec import BitVec
from repro_torch.core.k2tree import K2Meta, K2Tree
from repro_torch.core.k2triples import K2TriplesStore
from repro_torch.core.query import resolve_device

FOREST_FIELDS = ("t_words", "t_rank", "l_words", "ones_before", "level_start", "nnz")
INDEX_FIELDS = ("offsets", "words", "degs", "flags", "frank")


def store_from_arrays(
    *,
    ks,
    forest: dict[str, np.ndarray],
    n_so: int,
    n_subjects: int,
    n_objects: int,
    n_preds: int,
    n_triples: int,
    index: dict[str, np.ndarray] | None = None,
    index_meta: dict | None = None,
    host_offsets: np.ndarray | None = None,
    host_preds: np.ndarray | None = None,
    device="cuda",
) -> K2TriplesStore:
    """A serving store from host arrays.

    ``forest`` maps the ``K2Forest`` field names to arrays (uint32 words
    or their int32 views); ``index`` the DAC ``PredIndex`` fields and
    ``index_meta`` the ``PredIndexMeta`` fields (``layout`` must be
    ``"dac"``); ``host_offsets`` (int64[R + 1]) and ``host_preds`` (int32,
    0-based, sorted within each row) the index's host CSR, both or
    neither.  Build statistics are not carried: ``stats`` is ``None``.
    """
    device = resolve_device(device)
    missing = [n for n in FOREST_FIELDS if n not in forest]
    if missing:
        raise ValueError(f"forest arrays missing {missing}")
    meta = K2Meta(tuple(int(k) for k in ks))
    p, h = np.shape(forest["level_start"])
    if h != meta.n_levels or p != n_preds:
        raise ValueError(
            f"level_start shape {(p, h)} does not match {n_preds} predicates "
            f"of {meta.n_levels} levels"
        )
    f = k2forest.forest_from_numpy(forest, device)
    pidx = None
    if index is not None:
        if index_meta is None or index_meta.get("layout") != "dac":
            raise ValueError("a carried index needs its PredIndexMeta with layout='dac'")
        missing = [n for n in INDEX_FIELDS if n not in index]
        if missing:
            raise ValueError(f"index arrays missing {missing}")
        pmeta = predindex.PredIndexMeta(**{
            k: tuple(v) if isinstance(v, (list, tuple)) else v
            for k, v in index_meta.items()
        })
        if (host_offsets is None) != (host_preds is None):
            raise ValueError("pass host_offsets and host_preds together")
        if host_offsets is not None:
            host_offsets = np.asarray(host_offsets, np.int64)
            host_preds = np.asarray(host_preds, np.int32)
            rows = pmeta.n_subjects + pmeta.n_objects
            if host_offsets.shape != (rows + 1,) or host_preds.shape != (host_offsets[-1],):
                raise ValueError(
                    f"host CSR shapes {host_offsets.shape}/{host_preds.shape} do not "
                    f"match {rows} index rows"
                )
        pidx = predindex.BuiltPredIndex(
            device=predindex.index_from_numpy(index, device), meta=pmeta,
            host_offsets=host_offsets, host_preds=host_preds,
        )
    return K2TriplesStore(
        meta=meta, forest=f, stats=None, n_so=n_so, n_subjects=n_subjects,
        n_objects=n_objects, n_preds=n_preds, n_triples=n_triples,
        pred_index=pidx,
    )


def _bitvec_from_arrays(name: str, words, rank_blocks, n_bits, device) -> BitVec:
    words, rank_blocks = np.asarray(words), np.asarray(rank_blocks)
    n_words = max(1, -(-int(n_bits) // bitvec.WORD_BITS))
    if words.shape != (n_words,) or rank_blocks.shape != (n_words,):
        raise ValueError(
            f"{name}: words {words.shape} and rank_blocks {rank_blocks.shape} do not "
            f"hold {n_bits} bits ({n_words} words)"
        )
    return BitVec(bitvec.to_device(words, device), bitvec.to_device(rank_blocks, device),
                  int(n_bits))


def tree_from_arrays(*, t, l, ones_before, level_start, nnz: int, device="cuda") -> K2Tree:
    """A ``K2Tree`` from host arrays.

    ``t`` and ``l`` are each ``(words, rank_blocks, n_bits)`` of a bit
    vector (uint32 words or their int32 views); ``ones_before`` is
    int32[max(H-1, 1)] and ``level_start`` int32[H].
    """
    device = resolve_device(device)
    ones_before, level_start = np.asarray(ones_before), np.asarray(level_start)
    h = level_start.shape[0] if level_start.ndim == 1 else 0
    if h < 1 or ones_before.shape != (max(h - 1, 1),):
        raise ValueError(
            f"level tables {ones_before.shape} / {level_start.shape} do not describe "
            "a tree of H >= 1 levels"
        )
    return K2Tree(
        t=_bitvec_from_arrays("t", *t, device), l=_bitvec_from_arrays("l", *l, device),
        ones_before=bitvec.to_device(ones_before, device),
        level_start=bitvec.to_device(level_start, device), nnz=int(nnz),
    )
