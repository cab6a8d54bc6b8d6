"""Carry a store built elsewhere (the JAX package) across as numpy arrays.

The forest arenas, the DAC SP/OP index arrays and the static geometry are
all the state a ``K2TriplesStore`` serves from; this module wraps them in
this package's types on a device, without rebuilding anything and without
importing the package that built them.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import k2forest, predindex
from repro_torch.core.k2tree import K2Meta
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
    device="cuda",
) -> K2TriplesStore:
    """A serving store from host arrays.

    ``forest`` maps the ``K2Forest`` field names to arrays (uint32 words
    or their int32 views); ``index`` the DAC ``PredIndex`` fields and
    ``index_meta`` the ``PredIndexMeta`` fields (``layout`` must be
    ``"dac"``).  Build statistics are not carried: ``stats`` is ``None``.
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
        pidx = predindex.BuiltPredIndex(
            device=predindex.index_from_numpy(index, device), meta=pmeta
        )
    return K2TriplesStore(
        meta=meta, forest=f, stats=None, n_so=n_so, n_subjects=n_subjects,
        n_objects=n_objects, n_preds=n_preds, n_triples=n_triples,
        pred_index=pidx,
    )
