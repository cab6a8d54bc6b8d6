"""Background compaction: fold the delta into a rebuilt static store.

The LSM contract's second half: when the delta grows past
:class:`CompactionPolicy` thresholds, dump the static store's ID triples off
the device (one ``k2_range`` launch over every predicate at cap = the
largest tree's nnz — no retained source triples, the forest IS the store),
apply tombstones, union the inserts, and rebuild forest + SP/OP index on the
static store's own device with ``k2triples.from_id_triples``.  The rebuild
runs off the serve path (the broker does it in a worker thread);
``DynamicStore.swap`` then installs the new epoch atomically while
in-flight plans keep serving the old one — mutations that raced in after
the pinned snapshot survive in the rebased delta.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import k2forest
from repro_torch.core.delta import DeltaSnapshot, DynamicStore
from repro_torch.core.k2triples import K2TriplesStore, from_id_triples


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """When to fold the delta down.

    ``max_delta``: compact once inserts + tombstones exceed this many
    entries.  ``max_tombstone_frac``: compact once tombstones exceed this
    fraction of the static triple count (but only after
    ``min_tombstones`` — tiny stores shouldn't churn).
    """

    max_delta: int = 4096
    max_tombstone_frac: float = 0.2
    min_tombstones: int = 64

    def __post_init__(self):
        if self.max_delta < 1:
            raise ValueError("max_delta must be >= 1")
        if not (0.0 < self.max_tombstone_frac <= 1.0):
            raise ValueError("max_tombstone_frac must be in (0, 1]")


def needs_compaction(store: DynamicStore, policy: CompactionPolicy) -> bool:
    d = store.delta
    n_ins, n_tomb = d.n_inserts, d.n_tombstones
    if n_ins + n_tomb >= policy.max_delta:
        return True
    n_static = max(store.static.n_triples, 1)
    return (
        n_tomb >= policy.min_tombstones
        and n_tomb / n_static >= policy.max_tombstone_frac
    )


def dump_static_ids(static: K2TriplesStore, split: dict | None = None) -> np.ndarray:
    """Recover int64[N, 3] 1-based (s, p, o) triples from the forest, in
    predicate order and Morton order within a predicate.

    ``split`` (optional dict) receives ``dump_ms`` (host clock from the
    ``k2_range`` launch to its end), ``copy_ms`` (the copy to the host) and,
    on the card, ``dump_device_ms`` (CUDA events around the launch).
    """
    if static.n_triples == 0:
        return np.empty((0, 3), dtype=np.int64)
    cap = max(int(static.host_nnz.max()), 1)
    dev = static.device
    t0 = time.perf_counter()
    if dev.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record(torch.cuda.current_stream(dev))
    r = k2forest.range_scan_batch(
        static.meta, static.forest, np.arange(static.n_preds), cap
    )
    if dev.type == "cuda":
        ev[1].record(torch.cuda.current_stream(dev))
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    rows, cols, valid, overflow = (a.cpu().numpy() for a in (r.rows, r.cols, r.valid, r.overflow))
    if split is not None:
        split.update(dump_ms=(t1 - t0) * 1e3, copy_ms=(time.perf_counter() - t1) * 1e3)
        if dev.type == "cuda":
            split["dump_device_ms"] = ev[0].elapsed_time(ev[1])
    if overflow.any():  # cap == max nnz: cannot happen
        raise RuntimeError("static dump overflowed its own nnz cap")
    lanes, slots = np.nonzero(valid)
    return np.stack(
        [rows[lanes, slots] + 1, lanes + 1, cols[lanes, slots] + 1], axis=1
    ).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class CompactionReport:
    epoch: int
    n_triples: int
    delta_merged: int
    tombstones_applied: int
    duration_s: float
    # ms of each step: dump_ms, copy_ms, tombstones_ms (tombstones and
    # inserts folded in), rebuild_ms, swap_ms (and dump_device_ms on the card)
    split_ms: dict = dataclasses.field(default_factory=dict, compare=False)


def _member(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Mask of the (s, p, o) rows of ``a`` that are rows of ``b``: one
    ``np.isin`` over (s << 32 | o) keys a predicate (ids are below 2^31)."""
    hit = np.zeros(a.shape[0], dtype=bool)
    # a predicate absent from either side matches nothing: walk the smaller
    for p in np.unique(min(a, b, key=len)[:, 1]):
        sa = np.nonzero(a[:, 1] == p)[0]
        sb = b[b[:, 1] == p]
        hit[sa] = np.isin((a[sa, 0] << 32) | a[sa, 2], (sb[:, 0] << 32) | sb[:, 2])
    return hit


def _rows(pairs_by_pred: dict) -> np.ndarray:
    """int64[N, 3] (s, p, o) rows of per-pred (s, o) sets, by pred then (s, o)."""
    rows = [(s, p, o) for p, pairs in sorted(pairs_by_pred.items()) for (s, o) in sorted(pairs)]
    return np.asarray(rows, dtype=np.int64).reshape(-1, 3)


def compact(store: DynamicStore) -> CompactionReport:
    """Fold the current delta snapshot into a new static epoch.

    Pins a :class:`DeltaSnapshot`, rebuilds off-path on the static store's
    device, then ``swap``s — writes landing during the rebuild survive in
    the rebased delta.  The dictionary (including any appended-range
    extension) is carried through unchanged: ids never move across epochs.
    """
    t0 = time.perf_counter()
    static = store.static
    snap: DeltaSnapshot = store.delta.snapshot()
    split: dict = {}

    ids = dump_static_ids(static, split)
    t1 = time.perf_counter()
    # the dump's rows are a set, and so are each predicate's inserts: drop
    # the tombstoned rows, then add the inserts the static side lacks
    # (the reference's ``np.unique(axis=0)`` over the union, row for row)
    gone = _member(ids, _rows(snap.tomb))
    applied = int(gone.sum())
    ids = ids[~gone]
    extra = _rows(snap.ins)
    ids = np.concatenate([ids, extra[~_member(extra, ids)]], axis=0)
    t2 = time.perf_counter()

    d = store.dictionary
    if d is not None:
        n_subjects, n_objects, n_preds = d.n_subjects, d.n_objects, d.n_preds
    else:
        n_subjects = max(static.n_subjects, snap.n_subjects)
        n_objects = max(static.n_objects, snap.n_objects)
        n_preds = max(static.n_preds, snap.n_preds)

    new_static = from_id_triples(
        ids,
        n_so=static.n_so,
        n_subjects=n_subjects,
        n_objects=n_objects,
        n_preds=n_preds,
        dictionary=static.dictionary,
        with_pred_index=static.pred_index is not None,
        device=static.device,
    )
    if static.device.type == "cuda":
        torch.cuda.synchronize(static.device)
    t3 = time.perf_counter()
    epoch = store.swap(new_static, snap)
    t4 = time.perf_counter()
    split.update(tombstones_ms=(t2 - t1) * 1e3, rebuild_ms=(t3 - t2) * 1e3,
                 swap_ms=(t4 - t3) * 1e3)
    return CompactionReport(
        epoch=epoch,
        n_triples=int(ids.shape[0]),
        delta_merged=snap.n_inserts,
        tombstones_applied=applied,
        duration_s=t4 - t0,
        split_ms=split,
    )
