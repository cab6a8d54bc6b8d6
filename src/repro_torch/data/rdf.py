"""Synthetic RDF corpora in the paper's ID space.

The paper's 2011 corpora are not redistributable offline, so benchmarks run
on synthetic datasets that mirror the published shape statistics (Table 1):
#triples and the |S| / |P| / |O| ratios, power-law predicate and object
frequencies, and an SO overlap.  A seed gives the same triples as the JAX
package's ``repro.data.rdf`` (same draws in the same order).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Table 1 of the paper (counts); used to scale synthetic corpora.
PAPER_DATASETS = {
    "geonames": dict(triples=9_415_253, subjects=2_203_561, preds=20, objects=3_031_664),
    "wikipedia": dict(triples=47_054_407, subjects=2_162_189, preds=9, objects=8_268_864),
    "dbtune": dict(triples=58_920_361, subjects=12_401_228, preds=394, objects=14_264_221),
    "uniprot": dict(triples=72_460_981, subjects=12_188_927, preds=126, objects=9_084_674),
    "dbpedia-en": dict(triples=232_542_405, subjects=18_425_128, preds=39_672, objects=65_200_769),
}


@dataclasses.dataclass(frozen=True)
class RdfDataset:
    """ID triples + the dictionary partition sizes they were drawn from."""

    ids: np.ndarray  # int64[N, 3] 1-based (s, p, o), unique
    n_so: int
    n_subjects: int
    n_objects: int
    n_preds: int

    @property
    def n_triples(self) -> int:
        return int(self.ids.shape[0])


def generate(
    n_triples: int,
    *,
    n_subjects: int,
    n_preds: int,
    n_objects: int,
    so_frac: float = 0.3,
    pred_alpha: float = 1.2,
    obj_alpha: float = 1.05,
    preds_per_subject: int | None = None,
    seed: int = 0,
) -> RdfDataset:
    """Power-law synthetic RDF in the paper's 4-range ID space.

    ``preds_per_subject``: every subject draws its predicates from an own
    pool of at most this many (a resource's class fixes its vocabulary).
    """
    rng = np.random.default_rng(seed)
    n_so = int(so_frac * min(n_subjects, n_objects))

    def powerlaw_ids(n, lo, hi, alpha):
        u = rng.random(n)
        span = hi - lo + 1
        ranks = np.floor(span * u ** alpha).astype(np.int64)
        return lo + np.clip(ranks, 0, span - 1)

    s = powerlaw_ids(n_triples, 1, n_subjects, 1.0)
    if preds_per_subject is None:
        p = powerlaw_ids(n_triples, 1, n_preds, pred_alpha)
    else:
        perm = rng.permutation(n_preds).astype(np.int64)
        pool_size = rng.integers(1, preds_per_subject + 1, n_subjects + 1)
        pool_start = rng.integers(0, n_preds, n_subjects + 1)
        slot = rng.integers(0, 1 << 30, n_triples) % pool_size[s]
        p = 1 + perm[(pool_start[s] + slot) % n_preds]
    o = powerlaw_ids(n_triples, 1, n_objects, obj_alpha)
    # a subject's objects cluster in dictionary order (Fernández et al.
    # 2010): 60% subject-correlated objects, 40% global power-law draws
    local = rng.random(n_triples) < 0.6
    spread = max(4, n_objects // 64)
    o_local = 1 + (
        (s - 1) * n_objects // max(n_subjects, 1)
        + rng.integers(0, spread, n_triples)
    ) % n_objects
    o = np.where(local, o_local, o)
    ids = np.unique(np.stack([s, p, o], axis=1), axis=0)  # duplicates removed
    return RdfDataset(
        ids=ids, n_so=n_so, n_subjects=n_subjects, n_objects=n_objects, n_preds=n_preds
    )


def generate_like(name: str, n_triples: int, seed: int = 0) -> RdfDataset:
    """Scale a paper dataset's ratios to ``n_triples``."""
    d = PAPER_DATASETS[name]
    f = n_triples / d["triples"]
    return generate(
        n_triples,
        n_subjects=max(4, int(d["subjects"] * f)),
        n_preds=max(2, min(d["preds"], int(np.ceil(d["preds"] * f)) + 2)),
        n_objects=max(4, int(d["objects"] * f)),
        seed=seed,
    )
