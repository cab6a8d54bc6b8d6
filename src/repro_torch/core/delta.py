"""LSM-style delta layer: live inserts/deletes over a frozen k²-triples store.

The paper's structure is build-once — ultra-compressed but immutable.  This
module takes the LSM route to mutability: a small write-optimized
:class:`DeltaStore` absorbs inserts (per-predicate sorted (s, o) arrays) and
deletes (a tombstone set), while the static forest + DAC index + front-coded
dictionary keep serving reads at full speed.  A :class:`DynamicStore` facade
wraps static + delta and is accepted everywhere a store is today (attribute
proxying); the engine grabs an immutable :class:`DynView` per dispatch and
merges the delta lane into the pooled ``_run_lanes`` results on the host:

    merged = (static − tombstones) ∪ inserts          (per lane, per pred)

Unseen terms get ids from an appended range (``dictionary.ExtendedDictionary``)
— static ids never move — and lanes whose constants fall outside the static
extents are masked to dead (op = -1), their constants zeroed, on the host
before the batch is uploaded, so no kernel is handed an id past the static
arenas; the merge then supplies the delta-only answer.  The delta and the
merge live on the host in numpy; only the static epoch is on the device.  Background compaction (``core/compaction.py``) folds the
delta into a rebuilt static store and atomically swaps it in under
``DynamicStore.swap``; the epoch counter lets plans detect staleness
(``query.StaleEpoch``).
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.core.dictionary import ExtendedDictionary
from repro_torch.core.k2triples import K2TriplesStore
from repro_torch.core.predindex import PredBitmap

# serve IR opcodes — mirrored from core.engine (kept in sync by
# tests/test_torch_dynamic.py::test_opcodes_in_sync); importing engine here
# would be circular (engine imports this module).
OP_CHECK = 0
OP_ROW = 1
OP_COL = 2
OP_S_ANY_ANY = 3
OP_ANY_ANY_O = 4
OP_S_ANY_O = 5

_NEED_S = (OP_CHECK, OP_ROW, OP_S_ANY_O, OP_S_ANY_ANY)
_NEED_O = (OP_CHECK, OP_COL, OP_S_ANY_O, OP_ANY_ANY_O)
_NEED_P = (OP_CHECK, OP_ROW, OP_COL)

_EMPTY = np.empty(0, dtype=np.int64)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """``np.unique`` of a 1-D array as a sort and an adjacent dedup (numpy
    2.3's hash-based ``np.unique`` is several times slower at 10^5-10^6)."""
    a = np.sort(a)
    return a[np.concatenate(([True], a[1:] != a[:-1]))] if a.size else a


class DeltaSnapshot:
    """Immutable point-in-time view of a :class:`DeltaStore`.

    All lookups the merge path needs are precomputed on the host: per-pred
    (s, o) pair sets, per-(s, o) predicate lists, and per-entity predicate
    bitmaps (:class:`~repro_torch.core.predindex.PredBitmap`) standing in for the
    SP/OP index on the delta side.
    """

    def __init__(
        self,
        ins: dict[int, frozenset],
        tomb: dict[int, frozenset],
        *,
        n_subjects: int,
        n_objects: int,
        n_preds: int,
        version: int,
    ):
        self.ins = ins
        self.tomb = tomb
        self.n_subjects = n_subjects
        self.n_objects = n_objects
        self.n_preds = n_preds
        self.version = version
        self.n_inserts = sum(len(v) for v in ins.values())
        self.n_tombstones = sum(len(v) for v in tomb.values())
        self.empty = not self.n_inserts and not self.n_tombstones

        # per-(s,o) predicate lists for (S, ?P, O)
        self.so_preds: dict[tuple[int, int], list[int]] = {}
        self.tomb_so_preds: dict[tuple[int, int], list[int]] = {}
        # per-entity predicate bitmaps for (S, ?P, ?O) / (?S, ?P, O)
        self.s_preds = PredBitmap()
        self.o_preds = PredBitmap()
        self.tomb_s_preds = PredBitmap()
        self.tomb_o_preds = PredBitmap()
        for src, so_map, sb, ob in (
            (ins, self.so_preds, self.s_preds, self.o_preds),
            (tomb, self.tomb_so_preds, self.tomb_s_preds, self.tomb_o_preds),
        ):
            for p in sorted(src):
                for (s, o) in src[p]:
                    so_map.setdefault((s, o), []).append(p)
                    sb.add(s, p)
                    ob.add(o, p)

        self.dirty_preds = frozenset(ins) | frozenset(tomb)
        # lazily materialized per-pred sorted arrays
        self._sp: dict[tuple, np.ndarray] = {}

    # --- point lookups -----------------------------------------------------

    def contains(self, s: int, p: int, o: int) -> bool:
        v = self.ins.get(p)
        return v is not None and (s, o) in v

    def tomb_contains(self, s: int, p: int, o: int) -> bool:
        v = self.tomb.get(p)
        return v is not None and (s, o) in v

    # --- per-pred scans ----------------------------------------------------

    def _scan(self, src: int, p: int, axis: int, key: int) -> np.ndarray:
        """Sorted ids on ``axis`` (0: objects of subject ``key``; 1: subjects
        of object ``key``) for pred ``p`` in pool ``src`` (0=ins, 1=tomb)."""
        ck = (src, p, axis)
        idx = self._sp.get(ck)
        if idx is None:
            pairs = (self.ins if src == 0 else self.tomb).get(p)
            if not pairs:
                idx = (_EMPTY, _EMPTY)
            else:
                a = np.asarray(sorted(pairs), dtype=np.int64)
                if axis == 0:  # keyed by s, yields o
                    idx = (a[:, 0], a[:, 1])
                else:  # keyed by o, yields s
                    order = np.lexsort((a[:, 0], a[:, 1]))
                    idx = (a[order, 1], a[order, 0])
            self._sp[ck] = idx
        keys, vals = idx
        lo = np.searchsorted(keys, key, side="left")
        hi = np.searchsorted(keys, key, side="right")
        out = vals[lo:hi]
        out = np.sort(out) if out.size else out
        return out

    def objects_of(self, s: int, p: int) -> np.ndarray:
        return self._scan(0, p, 0, s)

    def subjects_of(self, o: int, p: int) -> np.ndarray:
        return self._scan(0, p, 1, o)

    def tomb_objects_of(self, s: int, p: int) -> np.ndarray:
        return self._scan(1, p, 0, s)

    def tomb_subjects_of(self, o: int, p: int) -> np.ndarray:
        return self._scan(1, p, 1, o)

    def preds_linking(self, s: int, o: int) -> list[int]:
        return self.so_preds.get((s, o), [])

    def tomb_preds_linking(self, s: int, o: int) -> list[int]:
        return self.tomb_so_preds.get((s, o), [])

    def pairs_of(self, p: int) -> frozenset:
        return self.ins.get(p) or frozenset()

    def tomb_pairs_of(self, p: int) -> frozenset:
        return self.tomb.get(p) or frozenset()

    # --- pair-list merge (the (?S, P, ?O) / dump shapes) -------------------

    def merge_pairs(self, p: int, s_arr, o_arr):
        """Merge one static (s, o) pair list for pred ``p``.

        Untouched preds come back unchanged (Morton order preserved);
        touched preds come back lex-sorted by (s, o).
        """
        rm = self.tomb.get(p)
        add = self.ins.get(p)
        if not rm and not add:
            return s_arr, o_arr
        # (s << 32 | o) keys (ids are below 2^31): sorted unique keys are the
        # lex-sorted (s, o) pairs
        keys = _sorted_unique((_host(s_arr).astype(np.int64) << 32) | _host(o_arr).astype(np.int64))
        if rm:
            keys = np.setdiff1d(keys, self._keys(1, p), assume_unique=True)
        if add:
            keys = _sorted_unique(np.concatenate([keys, self._keys(0, p)]))
        if not keys.size:
            return _EMPTY, _EMPTY
        return keys >> 32, keys & 0xFFFFFFFF

    def _keys(self, src: int, p: int) -> np.ndarray:
        """Sorted (s << 32 | o) keys of pred ``p`` in pool ``src`` (0=ins,
        1=tomb), built once a snapshot."""
        ck = (src, p, "keys")
        keys = self._sp.get(ck)
        if keys is None:
            a = np.asarray(list((self.ins if src == 0 else self.tomb)[p]), np.int64)
            keys = self._sp[ck] = np.sort((a[:, 0] << 32) | a[:, 1])
        return keys


class DeltaStore:
    """Write-optimized mutable side of a :class:`DynamicStore`.

    Semantics (the LSM contract):

      * ``insert`` clears any tombstone for the triple and records it in the
        insert pool (delete-then-reinsert round-trips).
      * ``delete`` removes a delta-resident insert and records a tombstone
        unconditionally — a tombstone for a triple the static side never had
        is semantically inert (the merge subtracts nothing) and is swept at
        the next compaction.
      * answers = (static − tombstones) ∪ inserts.

    Thread-safe; ``snapshot()`` is version-cached so the read path only
    rebuilds host lookup tables after an actual mutation.
    """

    def __init__(self, static: K2TriplesStore, dictionary=None):
        self._lock = threading.Lock()
        self._ins: dict[int, set] = {}
        self._tomb: dict[int, set] = {}
        self._dict = dictionary
        self._version = 0
        self._snap: DeltaSnapshot | None = None
        self.n_subjects = static.n_subjects
        self.n_objects = static.n_objects
        self.n_preds = static.n_preds

    @property
    def n_inserts(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._ins.values())

    @property
    def n_tombstones(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._tomb.values())

    @property
    def empty(self) -> bool:
        with self._lock:
            return not self._ins and not self._tomb

    def _check_ids(self, s: int, p: int, o: int) -> None:
        if s < 1 or p < 1 or o < 1:
            raise ValueError(f"ids are 1-based, got ({s}, {p}, {o})")
        if self._dict is not None:
            ext = self._dict.matrix_extent
            if s > ext or o > ext or p > self._dict.n_preds:
                raise ValueError(
                    f"id ({s}, {p}, {o}) beyond dictionary extents "
                    f"({ext}, {self._dict.n_preds}) — add terms via "
                    "insert_strings / ExtendedDictionary.add_term first"
                )

    def insert(self, s: int, p: int, o: int) -> None:
        s, p, o = int(s), int(p), int(o)
        self._check_ids(s, p, o)
        with self._lock:
            t = self._tomb.get(p)
            if t is not None:
                t.discard((s, o))
                if not t:
                    del self._tomb[p]
            self._ins.setdefault(p, set()).add((s, o))
            self.n_subjects = max(self.n_subjects, s)
            self.n_objects = max(self.n_objects, o)
            self.n_preds = max(self.n_preds, p)
            self._version += 1

    def delete(self, s: int, p: int, o: int) -> None:
        s, p, o = int(s), int(p), int(o)
        with self._lock:
            v = self._ins.get(p)
            if v is not None:
                v.discard((s, o))
                if not v:
                    del self._ins[p]
            self._tomb.setdefault(p, set()).add((s, o))
            self.n_preds = max(self.n_preds, p)
            self._version += 1

    def snapshot(self) -> DeltaSnapshot:
        with self._lock:
            if self._snap is None or self._snap.version != self._version:
                self._snap = DeltaSnapshot(
                    {p: frozenset(v) for p, v in self._ins.items()},
                    {p: frozenset(v) for p, v in self._tomb.items()},
                    n_subjects=self.n_subjects,
                    n_objects=self.n_objects,
                    n_preds=self.n_preds,
                    version=self._version,
                )
            return self._snap

    def rebase(self, new_static: K2TriplesStore, absorbed: DeltaSnapshot) -> "DeltaStore":
        """Post-compaction delta: drop everything ``absorbed`` folded into
        ``new_static``, keep mutations that raced in after the snapshot."""
        out = DeltaStore(new_static, self._dict)
        with self._lock:
            for p, v in self._ins.items():
                rem = v - absorbed.ins.get(p, frozenset())
                if rem:
                    out._ins[p] = set(rem)
            for p, v in self._tomb.items():
                rem = v - absorbed.tomb.get(p, frozenset())
                if rem:
                    out._tomb[p] = set(rem)
            out.n_subjects = max(out.n_subjects, self.n_subjects)
            out.n_objects = max(out.n_objects, self.n_objects)
            out.n_preds = max(out.n_preds, self.n_preds)
            out._version = 1 if (out._ins or out._tomb) else 0
        return out


class DynamicStore:
    """Mutable facade: static :class:`K2TriplesStore` + :class:`DeltaStore`.

    Duck-compatible with the static store — every attribute the engine and
    planner read (``meta``/``forest``/``stats``/``n_*``/``pred_index``,
    ``device``/``host_nnz``/``to``) proxies to the current static epoch;
    ``dictionary`` upgrades to an
    :class:`~repro_torch.core.dictionary.ExtendedDictionary` so unseen terms get
    appended ids.  ``swap`` installs a compacted static store and bumps
    ``epoch`` atomically; in-flight reads keep the old epoch's objects alive
    via the :class:`DynView` they grabbed at dispatch.
    """

    def __init__(self, static: K2TriplesStore, *, dictionary=None):
        if dictionary is None and static.dictionary is not None:
            dictionary = ExtendedDictionary(static.dictionary)
        self._lock = threading.Lock()
        self._static = static
        self._dictionary = dictionary
        self._delta = DeltaStore(static, dictionary)
        self._epoch = 0

    # --- identity ----------------------------------------------------------

    @property
    def static(self) -> K2TriplesStore:
        return self._static

    @property
    def delta(self) -> DeltaStore:
        return self._delta

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def dictionary(self):
        return self._dictionary if self._dictionary is not None else self._static.dictionary

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._static, name)

    # --- writes ------------------------------------------------------------

    def insert(self, s: int, p: int, o: int) -> None:
        # under the store lock: ``swap`` rebases and REPLACES self._delta
        # while holding it, so a write loaded against the pre-rebase delta
        # outside the lock could land on the orphaned store after the
        # rebase copied it — silently dropped.  Lock order (store lock,
        # then delta lock inside DeltaStore.insert) matches swap/rebase.
        with self._lock:
            self._delta.insert(s, p, o)

    def delete(self, s: int, p: int, o: int) -> None:
        with self._lock:
            self._delta.delete(s, p, o)

    def insert_strings(self, triples) -> int:
        """Insert string triples, minting appended ids for unseen terms."""
        d = self._dictionary
        if d is None:
            raise ValueError("store has no dictionary; use insert(s, p, o)")
        n = 0
        for (s, p, o) in triples:
            self.insert(d.add_term(s), d.add_predicate(p), d.add_term(o))
            n += 1
        return n

    def delete_strings(self, triples) -> int:
        d = self.dictionary
        if d is None:
            raise ValueError("store has no dictionary; use delete(s, p, o)")
        n = 0
        for (s, p, o) in triples:
            try:
                ids = (d.encode_subject(s), d.encode_predicate(p), d.encode_object(o))
            except KeyError:
                continue  # unknown term -> triple cannot exist
            self.delete(*ids)
            n += 1
        return n

    # --- reads -------------------------------------------------------------

    def view(self) -> "DynView":
        with self._lock:
            d = self._dictionary
            return DynView(
                self._static, self._delta.snapshot(), self._epoch,
                ext_minted=d.matrix_extent if d is not None else 0,
                preds_minted=d.n_preds if d is not None else 0,
            )

    # --- compaction hand-off ----------------------------------------------

    def swap(self, new_static: K2TriplesStore, absorbed: DeltaSnapshot) -> int:
        """Install a compacted static store; returns the new epoch."""
        with self._lock:
            self._delta = self._delta.rebase(new_static, absorbed)
            self._static = new_static
            self._epoch += 1
            return self._epoch


# ---------------------------------------------------------------------------
# per-dispatch read view: sanitize + host-side merge
# ---------------------------------------------------------------------------


def view_of(store) -> "DynView | None":
    """The delta lane for ``store``, or None when reads are purely static.

    A view is returned not only when the delta snapshot holds mutations
    but also whenever ids beyond the static extents exist at all (the
    dictionary minted appended terms with no resident insert yet, e.g.
    ``add_term`` before the first write or between epochs) — those lanes
    still need sanitizing, or a clamped device gather would read the
    wrong row instead of answering empty.
    """
    if not isinstance(store, DynamicStore):
        return None
    v = store.view()
    if v.snap.empty and not v.needs_sanitize:
        return None
    return v


def snapshot_of(store) -> DeltaSnapshot | None:
    v = view_of(store)
    return v.snap if v is not None else None


def total_preds(store) -> int:
    """Predicate count including delta-only appended predicates."""
    if isinstance(store, DynamicStore):
        return max(store.static.n_preds, store.delta.n_preds)
    return store.n_preds


class DynView:
    """Immutable (static epoch, delta snapshot) pair used for one dispatch.

    ``sanitize_*`` masks lanes whose constants exceed the static extents to
    dead (op = -1) so the device program never gathers out of range;
    ``merge_*`` then folds the snapshot into the host-fetched results:
    subtract tombstones, union inserts, widen caps host-side so the delta
    can never cause a false overflow.
    """

    def __init__(
        self,
        static: K2TriplesStore,
        snap: DeltaSnapshot,
        epoch: int,
        *,
        ext_minted: int = 0,
        preds_minted: int = 0,
    ):
        self.static = static
        self.snap = snap
        self.epoch = epoch
        self.ext_static = max(static.n_subjects, static.n_objects)
        self.preds_static = static.n_preds
        # largest ids in existence anywhere — delta-resident OR merely
        # minted by the dictionary's appended range with no insert yet
        self.ext_minted = max(
            self.ext_static, snap.n_subjects, snap.n_objects, ext_minted
        )
        self.preds_minted = max(self.preds_static, snap.n_preds, preds_minted)

    @property
    def needs_sanitize(self) -> bool:
        """Ids beyond the static extents exist: lanes must be masked even
        when the delta snapshot itself is empty."""
        return (
            self.ext_minted > self.ext_static
            or self.preds_minted > self.preds_static
        )

    @property
    def total_preds(self) -> int:
        return max(self.preds_static, self.snap.n_preds)

    # --- sanitize ----------------------------------------------------------

    def sanitize_ops(self, ops, s, p, o) -> np.ndarray:
        ops = np.array(_host(ops), dtype=np.int32, copy=True).reshape(-1)
        s = _host(s).astype(np.int64, copy=False).reshape(-1)
        p = _host(p).astype(np.int64, copy=False).reshape(-1)
        o = _host(o).astype(np.int64, copy=False).reshape(-1)
        bad = np.isin(ops, _NEED_S) & (s > self.ext_static)
        bad |= np.isin(ops, _NEED_O) & (o > self.ext_static)
        bad |= np.isin(ops, _NEED_P) & (p > self.preds_static)
        ops[bad] = -1
        return ops

    def sanitize_batch(self, qb):
        """ServeBatch -> host ServeBatch with out-of-static-range lanes
        masked to dead and their constants zeroed (no kernel sees them)."""
        qb = qb._make(_host(a) for a in qb)
        ops = self.sanitize_ops(qb.op, qb.s, qb.p, qb.o)
        dead = ops != qb.op
        if not dead.any():
            return qb
        return qb._make([ops] + [np.where(dead, 0, a).astype(a.dtype) for a in qb[1:]])

    # --- merge -------------------------------------------------------------

    def _merge_check(self, hit: bool, s: int, p: int, o: int) -> bool:
        if self.snap.contains(s, p, o):
            return True
        if hit and self.snap.tomb_contains(s, p, o):
            return False
        return bool(hit)

    def check(self, s: int, p: int, o: int, static_hit: bool) -> bool:
        """(S, P, O) with the delta folded in (planner point lookups)."""
        return self._merge_check(static_hit, s, p, o)

    def _merge_sorted(self, base: np.ndarray, rm: np.ndarray, add) -> np.ndarray:
        out = base.astype(np.int64, copy=False)
        if len(rm):
            out = np.setdiff1d(out, rm, assume_unique=False)
        if len(add):
            out = np.union1d(out, np.asarray(add, dtype=np.int64))
        return out

    def merge_lanes(self, ops, s, p, o, r):
        """Fold the delta into one host-fetched ``ServeResult``.

        ``ops``/``s``/``p``/``o`` are the ORIGINAL (pre-sanitize) lane
        arrays; ``r`` is the numpy ``ServeResult`` of the sanitized batch.
        Returns ``r`` itself when no lane touches a dirty key; otherwise a
        rebuilt result whose ids/u blocks are widened host-side as needed.
        """
        snap = self.snap
        ops = _host(ops).reshape(-1)
        s = _host(s).astype(np.int64, copy=False).reshape(-1)
        p = _host(p).astype(np.int64, copy=False).reshape(-1)
        o = _host(o).astype(np.int64, copy=False).reshape(-1)
        b = ops.shape[0]

        new_hit: dict[int, bool] = {}
        new_ids: dict[int, np.ndarray] = {}
        new_u: dict[int, dict[int, np.ndarray]] = {}

        for i in range(b):
            op = int(ops[i])
            if op == OP_CHECK:
                si, pi, oi = int(s[i]), int(p[i]), int(o[i])
                h = self._merge_check(bool(r.hit[i]), si, pi, oi)
                if h != bool(r.hit[i]):
                    new_hit[i] = h
            elif op in (OP_ROW, OP_COL):
                pi = int(p[i])
                if pi not in snap.dirty_preds:
                    continue
                if op == OP_ROW:
                    key = int(s[i])
                    rm = snap.tomb_objects_of(key, pi)
                    add = snap.objects_of(key, pi)
                else:
                    key = int(o[i])
                    rm = snap.tomb_subjects_of(key, pi)
                    add = snap.subjects_of(key, pi)
                if not rm.size and not add.size:
                    continue
                base = np.asarray(r.ids[i])[np.asarray(r.valid[i])]
                new_ids[i] = self._merge_sorted(base, rm, add)
            elif op == OP_S_ANY_O:
                si, oi = int(s[i]), int(o[i])
                rm = snap.tomb_preds_linking(si, oi)
                add = snap.preds_linking(si, oi)
                if not rm and not add:
                    continue
                base = np.asarray(r.ids[i])[np.asarray(r.valid[i])]
                new_ids[i] = self._merge_sorted(
                    base, np.asarray(rm, dtype=np.int64), add
                )
            elif op in (OP_S_ANY_ANY, OP_ANY_ANY_O):
                if op == OP_S_ANY_ANY:
                    key = int(s[i])
                    dp = snap.s_preds.preds_of(key)
                    tp = snap.tomb_s_preds.preds_of(key)
                else:
                    key = int(o[i])
                    dp = snap.o_preds.preds_of(key)
                    tp = snap.tomb_o_preds.preds_of(key)
                if not dp.size and not tp.size:
                    continue
                per: dict[int, np.ndarray] = {}
                up = np.asarray(r.u_preds[i])
                for l in range(up.shape[0]):
                    pl = int(up[l])
                    if pl <= 0:
                        continue
                    v = np.asarray(r.u_valid[i, l])
                    per[pl] = np.asarray(r.u_ids[i, l])[v].astype(np.int64)
                for pl in tp.tolist():
                    if pl not in per:
                        continue
                    rm = (
                        snap.tomb_objects_of(key, pl)
                        if op == OP_S_ANY_ANY
                        else snap.tomb_subjects_of(key, pl)
                    )
                    if rm.size:
                        per[pl] = np.setdiff1d(per[pl], rm, assume_unique=False)
                for pl in dp.tolist():
                    add = (
                        snap.objects_of(key, pl)
                        if op == OP_S_ANY_ANY
                        else snap.subjects_of(key, pl)
                    )
                    if add.size:
                        cur = per.get(pl, _EMPTY)
                        per[pl] = np.union1d(cur, add)
                per = {pl: v for pl, v in sorted(per.items()) if v.size}
                new_u[i] = per

        if not new_hit and not new_ids and not new_u:
            return r

        hit = np.array(r.hit, dtype=np.bool_, copy=True)
        for i, h in new_hit.items():
            hit[i] = h

        ids, valid, count = r.ids, r.valid, r.count
        if new_ids:
            cap = ids.shape[1]
            cap2 = max(cap, max(len(v) for v in new_ids.values()))
            ids = np.zeros((b, cap2), dtype=np.int32)
            valid = np.zeros((b, cap2), dtype=np.bool_)
            ids[:, :cap] = r.ids
            valid[:, :cap] = r.valid
            count = np.array(r.count, copy=True)
            for i, m in new_ids.items():
                ids[i] = 0
                valid[i] = False
                ids[i, : len(m)] = m
                valid[i, : len(m)] = True
                count[i] = len(m)

        u_preds, u_ids, u_valid, u_count = r.u_preds, r.u_ids, r.u_valid, r.u_count
        if new_u:
            L, ucap = r.u_preds.shape[1], r.u_ids.shape[2]
            L2 = max(L, max(len(d) for d in new_u.values()), 1)
            ucap2 = max(
                ucap,
                max(
                    (max((len(a) for a in d.values()), default=0) for d in new_u.values()),
                    default=0,
                ),
                1,
            )
            u_preds = np.zeros((b, L2), dtype=np.int32)
            u_ids = np.zeros((b, L2, ucap2), dtype=np.int32)
            u_valid = np.zeros((b, L2, ucap2), dtype=np.bool_)
            u_count = np.zeros((b, L2), dtype=np.int32)
            u_preds[:, :L] = r.u_preds
            u_ids[:, :L, :ucap] = r.u_ids
            u_valid[:, :L, :ucap] = r.u_valid
            u_count[:, :L] = r.u_count
            for i, d in new_u.items():
                u_preds[i] = 0
                u_ids[i] = 0
                u_valid[i] = False
                u_count[i] = 0
                for l, (pl, arr) in enumerate(d.items()):
                    u_preds[i, l] = pl
                    u_ids[i, l, : len(arr)] = arr
                    u_valid[i, l, : len(arr)] = True
                    u_count[i, l] = len(arr)

        return dataclasses.replace(
            r,
            hit=hit,
            ids=ids,
            valid=valid,
            count=count,
            u_preds=u_preds,
            u_ids=u_ids,
            u_valid=u_valid,
            u_count=u_count,
        )
