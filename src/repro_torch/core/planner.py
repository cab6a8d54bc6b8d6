"""Cost-based query planner + algebra-tree executor over the serve IR.

This is the execution half of the SPARQL-shaped layer (``core.algebra``
holds the operator tree and the host-side table algebra).  Two jobs:

**Join ordering.**  :func:`estimate_cardinality` prices one triple pattern
from k²-triples statistics (per-predicate nnz, dictionary extents,
SP/OP-index predicate pruning — the PR-4 degree estimates);
:func:`step_estimate` refines it for a pattern entering a pipeline whose
variables are partially bound.  :func:`cost_order` runs a Selinger-style
dynamic program over pattern subsets (≤ 8 patterns; bitmask DP minimizing
the pipeline's total lane-work — the rows flowing into each step, see
:func:`order_cost`) and falls back to
:func:`greedy_order` — the original greedy selectivity order — beyond
that.  Both break estimate ties by **lowest pattern index** (strict
``<``), so plan order, and therefore plan-cache behaviour, is stable
across runs.

**Tree execution.**  :func:`execute` evaluates an algebra tree to a
:class:`~repro_torch.core.algebra.Table`.  Conjunctive regions
(``Join``-of-``Scan``) are flattened back into BGP blocks and run as ONE
sideways-information-passing pipeline: the block is cost-ordered, the
first pattern seeds the bindings, and every later pattern resolves
through :func:`_resolve_with_bindings` — existing bindings become the
next step's key batch through the engine's pooled flat-launch programs
(the ``serve`` runner), one serve-step dispatch per plan step.  A ``Join`` or
``LeftJoin`` whose right side flattens is *seeded* with the left result
(bindings ride through the same pipeline), so OPTIONAL blocks also cost
one dispatch per pattern; only genuinely non-conjunctive shapes (Union
arms, unseedable sides) fall back to the host-side table joins.  Without
a ``serve`` runner the steps call ``k2forest`` directly, with lane tensors
on the store's device: the hand-written kernels on a CUDA store, their
plain versions on a CPU one.

On a dynamic store (``core.delta.DynamicStore``) the planner reads the
delta too: predicate counts include delta-only appended predicates
(``delta.total_preds``), the SP/OP candidates of an unbounded ``?p`` gain
each key's delta predicates, pair enumeration merges every predicate's
pair list through the snapshot, ground patterns consult the snapshot
first, and without a ``serve`` runner the raw steps run through
:func:`_dyn_raw_runner`, which sanitizes and merges like the engine's.

Planner decisions are observable: when tracing is on, each block emits a
``planner.order`` span carrying the chosen order plus estimated-vs-actual
per-step cardinalities, and a ``planner.sip_pruned_lanes`` counter tallies
the lanes the SP/OP index pruned out of unbounded-``?p`` steps.  All of
it sits behind the usual ``obs.STATE`` ``None`` guards (tripwire-tested).
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np

from repro_torch import obs
from repro_torch.core import algebra, k2forest
from repro_torch.core import delta as dyn
from repro_torch.core.algebra import Table, TriplePattern
from repro_torch.core.k2triples import K2TriplesStore
from repro_torch.core.query import CapOverflow

Term = Any  # int (bound id) | str '?var'

# DP join-order search is exhaustive up to this many patterns per block;
# larger blocks use the greedy order (search is O(2^n · n²))
DP_LIMIT = 8


def _is_var(t: Term) -> bool:
    return isinstance(t, str)


# ---------------------------------------------------------------------------
# cardinality model
# ---------------------------------------------------------------------------


def _candidate_preds(store: K2TriplesStore, s: Term, o: Term) -> np.ndarray | None:
    """0-based candidate predicates for an unbounded-?p pattern, or None
    when neither position is a bound in-range id (no pruning possible)."""
    bi = store.pred_index
    if bi is None:
        return None
    cand = None
    if not _is_var(s):
        cand = (
            bi.host_list(s - 1)
            if 1 <= s <= store.n_subjects
            else np.zeros(0, np.int32)
        )
    if not _is_var(o):
        op_list = (
            bi.host_list(store.n_subjects + o - 1)
            if 1 <= o <= store.n_objects
            else np.zeros(0, np.int32)
        )
        cand = op_list if cand is None else np.intersect1d(cand, op_list)
    return cand


def estimate_cardinality(store: K2TriplesStore, pat: TriplePattern) -> float:
    """Expected result size from per-predicate nnz + dictionary extents,
    predicate-pruned through the SP/OP index when ?p rides a bound s/o."""
    nnz = np.asarray(store.host_nnz, np.float64)
    n_s = max(store.n_subjects, 1)
    n_o = max(store.n_objects, 1)
    if _is_var(pat.p):
        cand = _candidate_preds(store, pat.s, pat.o)
        total = float(nnz.sum()) if cand is None else float(nnz[cand].sum())
    else:
        total = float(nnz[pat.p - 1]) if 1 <= pat.p <= store.n_preds else 0.0
    sel = 1.0
    if not _is_var(pat.s):
        sel /= n_s
    if not _is_var(pat.o):
        sel /= n_o
    return max(total * sel, 1e-3)


def step_estimate(
    store: K2TriplesStore, pat: TriplePattern, bound_vars
) -> float:
    """Estimated per-row fanout of resolving ``pat`` when the variables in
    ``bound_vars`` already carry values: each bound position divides the
    stand-alone estimate by its dictionary extent (uniformity assumption —
    the same independence model :func:`estimate_cardinality` uses for
    constants)."""
    card = estimate_cardinality(store, pat)
    for term, extent in (
        (pat.s, store.n_subjects),
        (pat.p, store.n_preds),
        (pat.o, store.n_objects),
    ):
        if _is_var(term) and term in bound_vars:
            card /= max(extent, 1)
    return max(card, 1e-6)


# ---------------------------------------------------------------------------
# join-order search
# ---------------------------------------------------------------------------

# Per-op lane pricing: a pipeline step whose subject AND object are both
# realized at launch time (constants or already-bound variables) runs as
# OP_CHECK lanes — one fixed-depth traversal per lane, no frontier
# expansion, no cap-wide decode — while any step with a free s/o position
# runs OP_ROW/OP_COL scan lanes that expand a frontier and rake a cap-wide
# result window.  The JAX package's microbenches put a check lane at roughly
# a quarter of a scan lane, and the exact ratio matters less than the
# *ordering* signal: a cheap check over many rows can beat a selective
# scan (see ``tests/test_torch_select.py::test_planner_order_like_jax``).
LANE_PRICE_CHECK = 0.25
LANE_PRICE_SCAN = 1.0


def step_lane_price(pat: TriplePattern, bound_vars) -> float:
    """Lane price of resolving ``pat`` against rows where ``bound_vars``
    carry values: check-shaped steps (s and o both realized — the
    ``_resolve_with_bindings`` existence-check branch, whether or not ?p
    is free) are cheap; anything with a free s/o position scans."""

    def realized(t: Term) -> bool:
        return (not _is_var(t)) or t in bound_vars

    if realized(pat.s) and realized(pat.o):
        return LANE_PRICE_CHECK
    return LANE_PRICE_SCAN


def greedy_order(
    store: K2TriplesStore, patterns: list[TriplePattern], bound0=frozenset()
) -> list[int]:
    """Greedy selectivity-ordered, connectivity-respecting plan.

    Ties on the estimated cost break by LOWEST PATTERN INDEX (the strict
    ``<`` keeps the first candidate): equal estimates are common on
    symmetric patterns, and a stable order keeps plan-cache keys and
    differential runs reproducible.
    """
    n = len(patterns)
    cards = [estimate_cardinality(store, p) for p in patterns]
    order: list[int] = []
    bound_vars = set(bound0)
    if not bound0:
        # seed: np.argmin returns the lowest index on ties
        order.append(int(np.argmin(cards)))
        bound_vars |= patterns[order[0]].variables
    while len(order) < n:
        best, best_card = None, float("inf")
        for i in range(n):
            if i in order:
                continue
            connected = bool(patterns[i].variables & bound_vars)
            # already-bound variables shrink the estimate sharply
            card = cards[i] / (10.0 if connected else 1.0)
            if not connected:
                card *= 1e6  # cartesian products last
            if card < best_card:
                best, best_card = i, card
        order.append(best)
        bound_vars |= patterns[best].variables
    return order


def order_cost(
    store: K2TriplesStore,
    patterns: list[TriplePattern],
    order,
    bound0=frozenset(),
) -> float:
    """Modelled cost of executing ``patterns`` in ``order``: the sum of
    estimated rows flowing INTO each step, each weighted by the step's
    per-op lane price (:func:`step_lane_price` — check lanes cost a
    fraction of scan lanes).  The first unseeded step has no
    input rows; its cost is its own enumeration (estimated output,
    unpriced).  The final result cardinality is deliberately NOT counted:
    it is order-invariant in reality, but its *estimate* is
    order-sensitive, and letting it into the objective biases the search
    toward orders that merely under-estimate it."""
    bound = set(bound0)
    rows = 1.0
    cost = 0.0
    for k, i in enumerate(order):
        rows_in = rows
        price = step_lane_price(patterns[i], bound)
        rows *= step_estimate(store, patterns[i], bound)
        cost += rows if (k == 0 and not bound0) else rows_in * price
        bound |= patterns[i].variables
    return cost


def cost_order(
    store: K2TriplesStore, patterns: list[TriplePattern], bound0=frozenset(),
) -> list[int]:
    """Cost-based join order: exhaustive bitmask DP for blocks of ≤
    :data:`DP_LIMIT` patterns minimizing :func:`order_cost` (including
    its per-op lane pricing — the DP transition and :func:`order_cost`
    MUST price identically or the search optimizes the wrong objective);
    greedy beyond.  Cost ties break lexicographically by order tuple,
    i.e. by pattern index — same determinism contract as
    :func:`greedy_order`."""
    n = len(patterns)
    if n > DP_LIMIT:
        return greedy_order(store, patterns, bound0)
    # best[mask] = (cost, rows, order): cheapest way to have joined `mask`
    best: dict[int, tuple[float, float, tuple[int, ...]]] = {}
    for i in range(n):
        rows = step_estimate(store, patterns[i], bound0) if bound0 else (
            estimate_cardinality(store, patterns[i])
        )
        price = step_lane_price(patterns[i], bound0)
        # first-step cost mirrors order_cost: its enumeration when
        # unseeded, one (constant, priced) seeded launch otherwise
        best[1 << i] = (rows if not bound0 else price, rows, (i,))
    full = (1 << n) - 1
    for mask in range(1, full + 1):
        cur = best.get(mask)
        if cur is None:
            continue
        cost, rows, order = cur
        bound = set(bound0)
        for i in order:
            bound |= patterns[i].variables
        for j in range(n):
            bit = 1 << j
            if mask & bit:
                continue
            price = step_lane_price(patterns[j], bound)
            nrows = rows * step_estimate(store, patterns[j], bound)
            # lane-work model: the step costs its INPUT rows (launch
            # lanes) times its lane price, not its estimated output —
            # see order_cost
            cand = (cost + rows * price, nrows, order + (j,))
            prev = best.get(mask | bit)
            if prev is None or (cand[0], cand[2]) < (prev[0], prev[2]):
                best[mask | bit] = cand
    return list(best[full][2])


# ---------------------------------------------------------------------------
# one-pattern resolution (shared with the optimizer shims)
# ---------------------------------------------------------------------------


def _ragged_take(starts: np.ndarray, deg: np.ndarray):
    """Expand ragged rows: flat element indices ``starts[i] + j`` for
    ``j < deg[i]``, plus the owning row of each element."""
    row_idx = np.repeat(np.arange(deg.shape[0]), deg)
    within = np.arange(int(deg.sum())) - np.repeat(np.cumsum(deg) - deg, deg)
    return row_idx, np.repeat(starts, deg) + within


def _ragged_candidates(store: K2TriplesStore, keys: np.ndarray, axis: int):
    """Per-row candidate predicates from the SP (axis 0) / OP (axis 1) index.

    keys: int64[n] 1-based subject/object ids.  Returns ``(row_idx, cand)``
    — the flat (row, candidate) launch layout: candidate ``cand[j]``
    (0-based) belongs to binding row ``row_idx[j]``.
    """
    bi = store.pred_index
    if bi is None:  # index-free fallback: every predicate for every row
        n_rows = keys.shape[0]
        P = dyn.total_preds(store)
        return (
            np.repeat(np.arange(n_rows), P),
            np.tile(np.arange(P, dtype=np.int64), n_rows),
        )
    offs, host_preds = bi.csr()
    n_ent = store.n_subjects if axis == 0 else store.n_objects
    base = 0 if axis == 0 else store.n_subjects
    rows = base + np.clip(keys - 1, 0, max(n_ent - 1, 0))
    in_range = (keys >= 1) & (keys <= n_ent)
    start = np.where(in_range, offs[rows], 0)
    deg = np.where(in_range, offs[rows + 1] - offs[rows], 0)
    row_idx, elem = _ragged_take(start, deg)
    cand = host_preds[elem].astype(np.int64)
    snap = dyn.snapshot_of(store)
    if snap is not None:
        # the static SP/OP index knows nothing about recent inserts: union
        # each row's delta predicates from the snapshot's per-entity bitmap
        pm = snap.s_preds if axis == 0 else snap.o_preds
        extra_r: list[int] = []
        extra_c: list[np.ndarray] = []
        for i, k in enumerate(np.asarray(keys).tolist()):
            ps = pm.preds_of(int(k))
            if ps.size:
                extra_r.extend([i] * ps.size)
                extra_c.append(ps - 1)  # candidates are 0-based
        if extra_r:
            row_idx = np.concatenate([row_idx, np.asarray(extra_r)])
            cand = np.concatenate([cand, np.concatenate(extra_c)])
            big = np.int64(dyn.total_preds(store) + 1)
            uk = np.unique(row_idx * big + cand)  # dedup, (row, cand) order
            row_idx, cand = uk // big, uk % big
    return row_idx, cand


def _host(t) -> np.ndarray:
    return t.cpu().numpy()


def _resolve_with_bindings(
    store, pat, bindings: dict[str, np.ndarray], cap: int,
    serve=None, stats: dict | None = None,
):
    """Resolve one pattern given current bindings -> columnar solution arrays.

    Chooses the cheapest realization: check / row scan / col scan /
    pair enumeration, batched over existing binding rows; an unbounded ?p
    with a bound s/o position resolves over index-pruned candidates in ONE
    flat launch.

    ``serve`` is an optional serve-IR lane runner ``(ops, s, p, o) ->
    ServeResult`` on the host (the engine's pooled serve step, fetched);
    when given, check and bounded-scan steps run through it instead of raw
    ``k2forest`` calls, so an n-pattern BGP shares the serve programs with
    every other plan.  The raw calls take lane tensors on the store's
    device.

    ``stats`` (optional dict) accumulates planner observability counts —
    currently ``sip_pruned_lanes``: how many (row, predicate) lanes the
    SP/OP index pruned out of unbounded-``?p`` steps versus the
    every-predicate fallback.
    """
    meta, f = store.meta, store.forest
    dev = store.device
    view = dyn.view_of(store)
    if view is not None and serve is None:
        # no pooled engine runner handed in: a raw-launch runner keeps the
        # delta sanitize+merge around every check/scan lane
        serve = _dyn_raw_runner(store, view, cap)
    P_tot = dyn.total_preds(store)
    n_rows = len(next(iter(bindings.values()))) if bindings else 1
    pvar = _is_var(pat.p)

    def col(term, default):
        if _is_var(term) and term in bindings:
            return bindings[term].astype(np.int64), True
        if not _is_var(term):
            return np.full(n_rows, term, np.int64), True
        return np.full(n_rows, default, np.int64), False

    p_free = pvar and pat.p not in bindings
    s_arr, s_bound = col(pat.s, 1)
    o_arr, o_bound = col(pat.o, 1)
    p_arr, _ = col(pat.p, 1)
    out_cols: dict[str, list] = {v: [] for v in set(bindings) | pat.variables}

    def note_pruned(row_idx):
        if stats is not None and store.pred_index is not None:
            stats["sip_pruned_lanes"] = stats.get("sip_pruned_lanes", 0) + (
                n_rows * store.n_preds - int(row_idx.shape[0])
            )

    def emit(rows, cols_list):
        """Keep binding rows ``rows`` and append the new columns.

        ``cols_list`` is positional ``(term, values)`` pairs; a variable
        repeated across positions of ONE pattern (e.g. ``(S, ?b, ?b)``)
        contributes several columns and only rows where they agree survive.
        """
        new: dict[str, np.ndarray] = {}
        keep = np.ones(rows.shape[0], np.bool_)
        for term, vals in cols_list:
            if not _is_var(term) or term in bindings:
                continue
            vals = np.asarray(vals, np.int64)
            if term in new:
                keep &= new[term] == vals
            else:
                new[term] = vals
        rows = rows[keep]
        for v in bindings:
            out_cols[v].append(bindings[v][rows])
        for var, vals in new.items():
            out_cols[var].append(vals[keep])

    def finish():
        return {
            v: (np.concatenate(cs) if cs else np.zeros(0, np.int64))
            for v, cs in out_cols.items()
        }

    if s_bound and o_bound:  # existence check (maybe per candidate pred)
        if p_free:
            # SP(s) candidates (either index half prunes; SP keys the check)
            row_idx, cand = _ragged_candidates(store, s_arr, 0)
            note_pruned(row_idx)
        else:
            row_idx, cand = np.arange(n_rows), p_arr - 1
        # a binding value re-used in predicate position may be out of range
        ok = (cand >= 0) & (cand < P_tot)
        if serve is not None:
            from repro_torch.core import engine as _eng

            r = serve(
                np.where(ok, _eng.OP_CHECK, -1),
                s_arr[row_idx], np.where(ok, cand + 1, 0), o_arr[row_idx],
            )
            hit = np.asarray(r.hit) & ok
        else:
            hit = _host(
                k2forest.check(
                    meta, f, k2forest.as_lanes(np.where(ok, cand, 0), dev),
                    k2forest.as_lanes(s_arr[row_idx] - 1, dev),
                    k2forest.as_lanes(o_arr[row_idx] - 1, dev),
                )
            ) & ok
        keep = np.nonzero(hit)[0]
        emit(row_idx[keep], [(pat.p, cand[keep] + 1)])
        return finish()

    if s_bound or o_bound:  # one free s/o position -> batched scan
        axis = 0 if s_bound else 1
        key_arr = s_arr if s_bound else o_arr
        if p_free:
            row_idx, cand = _ragged_candidates(store, key_arr, axis)
            note_pruned(row_idx)
        else:
            row_idx, cand = np.arange(n_rows), p_arr - 1
        if row_idx.size == 0:  # no candidates anywhere: empty result
            emit(row_idx, [])
            return finish()
        ok = (cand >= 0) & (cand < P_tot)
        if serve is not None:
            from repro_torch.core import engine as _eng

            op = _eng.OP_ROW if axis == 0 else _eng.OP_COL
            keys = key_arr[row_idx]
            r = serve(
                np.where(ok, op, -1),
                keys if axis == 0 else np.zeros_like(keys),
                np.where(ok, cand + 1, 0),
                keys if axis == 1 else np.zeros_like(keys),
            )
            if bool((np.asarray(r.overflow) & ok).any()):
                raise CapOverflow("BGP scan truncated at cap")
            ids = np.asarray(r.ids)  # serve ids are already 1-based
        else:
            r = k2forest.scan_batch_mixed(
                meta, f, k2forest.as_lanes(np.where(ok, cand, 0), dev),
                k2forest.as_lanes(key_arr[row_idx] - 1, dev),
                k2forest.as_lanes(axis, dev, row_idx.shape[0]), cap,
            )
            r = type(r)(*(_host(a) for a in r))
            if bool((r.overflow & ok).any()):
                raise CapOverflow("BGP scan truncated at cap")
            ids = r.ids + 1
        lanes, slots = np.nonzero(np.asarray(r.valid) & ok[:, None])
        rows = row_idx[lanes]
        emit(rows, [
            (pat.p, cand[lanes] + 1),
            (pat.o if s_bound else pat.s, ids[lanes, slots]),
        ])
        return finish()

    # neither s nor o realized: enumerate candidate triples by range scan
    # and cross-product with the binding rows (cartesian steps land here)
    upreds = (
        np.arange(1, P_tot + 1, dtype=np.int64)
        if p_free
        else np.unique(np.clip(p_arr, 1, P_tot))
    )
    if view is None:
        pr = k2forest.range_scan_batch(meta, f, upreds - 1, cap)
        pr = type(pr)(*(_host(a) for a in pr))
        if bool(pr.overflow.any()):
            raise CapOverflow("BGP pair enumeration truncated at cap")
        pv = pr.valid
        prow, pcol = pr.rows + 1, pr.cols + 1
        counts = pv.sum(axis=1)
        pair_p = np.repeat(upreds, counts)
        lanes, slots = np.nonzero(pv)
        pair_s, pair_o = prow[lanes, slots], pcol[lanes, slots]
    else:
        # dynamic: scan only the static trees, then merge each predicate's
        # pair list through the snapshot, keeping pair_p grouped in
        # ascending predicate order for the searchsorted below
        sta = upreds[upreds <= view.preds_static]
        per: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        if sta.size:
            pr = k2forest.range_scan_batch(meta, f, sta - 1, cap)
            pr = type(pr)(*(_host(a) for a in pr))
            if bool(pr.overflow.any()):
                raise CapOverflow("BGP pair enumeration truncated at cap")
            for i, p in enumerate(sta.tolist()):
                per[p] = (
                    pr.rows[i][pr.valid[i]].astype(np.int64) + 1,
                    pr.cols[i][pr.valid[i]].astype(np.int64) + 1,
                )
        empty = np.empty(0, np.int64)
        pp, ps, po = [], [], []
        for p in upreds.tolist():
            ss, oo = per.get(p, (empty, empty))
            ss, oo = view.snap.merge_pairs(int(p), ss, oo)
            if len(ss):
                pp.append(np.full(len(ss), p, np.int64))
                ps.append(np.asarray(ss, np.int64))
                po.append(np.asarray(oo, np.int64))
        pair_p = np.concatenate(pp) if pp else empty
        pair_s = np.concatenate(ps) if ps else empty
        pair_o = np.concatenate(po) if po else empty
    if p_free:
        n_pairs = pair_p.shape[0]
        rows = np.repeat(np.arange(n_rows), n_pairs)
        sel = np.tile(np.arange(n_pairs), n_rows)
    else:  # row i may only use pairs of ITS predicate value
        starts = np.searchsorted(pair_p, p_arr)
        deg = np.searchsorted(pair_p, p_arr, side="right") - starts
        rows, sel = _ragged_take(starts, deg)
    emit(rows, [
        (pat.p, pair_p[sel]), (pat.s, pair_s[sel]), (pat.o, pair_o[sel]),
    ])
    return finish()


def _pattern_holds(store: K2TriplesStore, pat: TriplePattern) -> bool:
    """Ground (variable-free) pattern: does the triple exist?"""
    snap = dyn.snapshot_of(store)
    if snap is not None:
        if snap.contains(pat.s, pat.p, pat.o):
            return True
        if snap.tomb_contains(pat.s, pat.p, pat.o):
            return False
        if pat.s > store.n_subjects or pat.o > store.n_objects:
            return False  # appended-range id the static forest cannot hold
    if not (1 <= pat.p <= store.n_preds):
        return False
    dev = store.device
    return bool(
        _host(
            k2forest.check(
                store.meta, store.forest, k2forest.as_lanes([pat.p - 1], dev),
                k2forest.as_lanes([pat.s - 1], dev),
                k2forest.as_lanes([pat.o - 1], dev),
            )
        )[0]
    )


def _dyn_raw_runner(store, view, cap: int):
    """Serve-shaped CHECK/ROW/COL lane runner over raw ``k2forest`` calls,
    wrapped in the delta sanitize+merge: the fallback when
    :func:`_resolve_with_bindings` meets a dynamic store without a pooled
    engine runner.  Sanitized lanes reach the kernels with zeroed
    constants."""
    from repro_torch.core import engine as _eng

    meta, f, dev = store.meta, store.forest, store.device

    def run(ops, s, p, o):
        ops0 = np.asarray(ops, np.int32).reshape(-1)
        s = np.asarray(s, np.int64).reshape(-1)
        p = np.asarray(p, np.int64).reshape(-1)
        o = np.asarray(o, np.int64).reshape(-1)
        ops_r = view.sanitize_ops(ops0, s, p, o)
        b = ops_r.shape[0]
        hit = np.zeros(b, np.bool_)
        ids = np.zeros((b, cap), np.int32)
        valid = np.zeros((b, cap), np.bool_)
        count = np.zeros(b, np.int32)
        ovf = np.zeros(b, np.bool_)
        is_chk = ops_r == _eng.OP_CHECK
        if is_chk.any():
            hit = _host(k2forest.check(
                meta, f,
                k2forest.as_lanes(np.where(is_chk, p - 1, 0), dev),
                k2forest.as_lanes(np.where(is_chk, s - 1, 0), dev),
                k2forest.as_lanes(np.where(is_chk, o - 1, 0), dev),
            )) & is_chk
        is_scan = (ops_r == _eng.OP_ROW) | (ops_r == _eng.OP_COL)
        if is_scan.any():
            axis = (ops_r == _eng.OP_COL).astype(np.int32)
            key = np.where(axis == 1, o, s)
            r = k2forest.scan_batch_mixed(
                meta, f,
                k2forest.as_lanes(np.where(is_scan, p - 1, 0), dev),
                k2forest.as_lanes(np.where(is_scan, key - 1, 0), dev),
                k2forest.as_lanes(axis, dev), cap,
            )
            rv = _host(r.valid) & is_scan[:, None]
            ids = np.where(rv, _host(r.ids) + 1, 0).astype(np.int32)
            valid = rv
            count = rv.sum(axis=1).astype(np.int32)
            ovf = _host(r.overflow) & is_scan
        res = _eng.ServeResult(
            hit=hit, ids=ids, valid=valid, count=count, overflow=ovf,
            u_preds=np.zeros((b, 0), np.int32),
            u_ids=np.zeros((b, 0, cap), np.int32),
            u_valid=np.zeros((b, 0, cap), np.bool_),
            u_count=np.zeros((b, 0), np.int32),
        )
        return view.merge_lanes(ops0, s, p, o, res)

    return run


# ---------------------------------------------------------------------------
# block + tree execution
# ---------------------------------------------------------------------------


def _n_rows(bindings: dict[str, np.ndarray]) -> int:
    return len(next(iter(bindings.values()))) if bindings else 0


def _run_block(store, patterns, seed: Table | None, *, cap, serve):
    """Execute one conjunctive block as a SIP pipeline -> Table (multiset).

    ``seed`` carries bindings from an already-evaluated left side: its
    columns become the initial binding table and every pattern resolves
    against them (sideways information passing).  Without a seed the
    cheapest pattern is resolved stand-alone first.  Ground patterns are
    pure existence prefilters.
    """
    ground = [p for p in patterns if not p.variables]
    live = [p for p in patterns if p.variables]
    out_vars = sorted(
        set().union(set(seed.cols) if seed is not None else set(),
                    *(p.variables for p in live))
    )
    if any(not _pattern_holds(store, g) for g in ground):
        return Table.empty(out_vars)
    if not live:
        return Table(dict(seed.cols), seed.n) if seed is not None else Table.unit()

    bound0 = frozenset(seed.cols) if seed is not None else frozenset()
    order = cost_order(store, live, bound0)

    tracer = obs.STATE.tracer
    metrics = obs.STATE.metrics
    stats: dict | None = (
        {} if (metrics is not None or tracer is not None) else None
    )
    t0 = time.perf_counter_ns() if tracer is not None else 0
    estimated: list[float] = []
    if tracer is not None:
        rows_est = 1.0
        bound = set(bound0)
        for i in order:
            rows_est *= step_estimate(store, live[i], bound)
            estimated.append(round(rows_est, 3))
            bound |= live[i].variables

    actual: list[int] = []
    bindings = {v: c for v, c in seed.cols.items()} if seed is not None else {}
    empty = False
    for k, idx in enumerate(order):
        if k == 0 and seed is None:
            bindings = _resolve_with_bindings(
                store, live[idx], {}, cap, serve, stats=stats
            )
            bindings = {
                v: a for v, a in bindings.items() if v in live[idx].variables
            }
        else:
            if _n_rows(bindings) == 0:
                empty = True
                break
            bindings = _resolve_with_bindings(
                store, live[idx], bindings, cap, serve, stats=stats
            )
        actual.append(_n_rows(bindings))

    if tracer is not None:
        tracer.add(
            "planner.order", t0, time.perf_counter_ns(), cat="planner",
            order=list(order), estimated=estimated, actual=actual,
            seeded=seed is not None, patterns=len(live),
        )
    if metrics is not None and stats and stats.get("sip_pruned_lanes"):
        metrics.counter("planner.sip_pruned_lanes").inc(
            stats["sip_pruned_lanes"]
        )

    if empty:
        return Table.empty(out_vars)
    return Table.from_bindings(bindings)


def _conjuncts(expr) -> list:
    """Flatten a top-level ``And`` chain into its conjunct list."""
    if isinstance(expr, algebra.And):
        return _conjuncts(expr.a) + _conjuncts(expr.b)
    return [expr]


def _conjoin(conjuncts: list):
    out = conjuncts[0]
    for c in conjuncts[1:]:
        out = algebra.And(out, c)
    return out


def push_filters(node):
    """Rewrite an algebra tree, pushing safe conjunctive FILTERs down.

    Two rules, applied bottom-up until fixpoint:

      * ``Filter(c, LeftJoin(a, b))`` -> ``LeftJoin(Filter(c, a), b)`` for
        each conjunct ``c`` whose variables are all bound by ``a`` (the
        required side).  Safe because an OPTIONAL match never changes the
        left side's own columns — filtering before the join drops exactly
        the rows the outer filter would have dropped, matched or not.
      * ``Filter(c, Union(a, b))`` -> ``Union(Filter(c, a), Filter(c, b))``
        for each conjunct scoped inside BOTH arms (conservative: a conjunct
        mentioning a variable only one arm binds stays above the union).

    Conjuncts that don't qualify stay in a residual filter above the node.
    Pure rewrite — the differential tests check result equivalence.
    """
    if isinstance(node, algebra.Filter):
        child = push_filters(node.child)
        conjuncts = _conjuncts(node.expr)
        if isinstance(child, algebra.LeftJoin):
            lvars = algebra.node_vars(child.left)
            down = [c for c in conjuncts if algebra.expr_vars(c) <= lvars]
            stay = [c for c in conjuncts if not algebra.expr_vars(c) <= lvars]
            if down:
                child = algebra.LeftJoin(
                    push_filters(algebra.Filter(_conjoin(down), child.left)),
                    child.right,
                )
            return algebra.Filter(_conjoin(stay), child) if stay else child
        if isinstance(child, algebra.Union):
            avars = algebra.node_vars(child.left)
            bvars = algebra.node_vars(child.right)
            down = [
                c for c in conjuncts
                if algebra.expr_vars(c) <= avars
                and algebra.expr_vars(c) <= bvars
            ]
            stay = [c for c in conjuncts if c not in down]
            if down:
                e = _conjoin(down)
                child = algebra.Union(
                    push_filters(algebra.Filter(e, child.left)),
                    push_filters(algebra.Filter(e, child.right)),
                )
            return algebra.Filter(_conjoin(stay), child) if stay else child
        return algebra.Filter(node.expr, child)
    if isinstance(node, algebra.Join):
        return algebra.Join(push_filters(node.left), push_filters(node.right))
    if isinstance(node, algebra.LeftJoin):
        return algebra.LeftJoin(
            push_filters(node.left), push_filters(node.right)
        )
    if isinstance(node, algebra.Union):
        return algebra.Union(push_filters(node.left), push_filters(node.right))
    if isinstance(node, algebra.Project):
        return algebra.Project(push_filters(node.child), node.vars)
    if isinstance(node, algebra.Slice):
        return algebra.Slice(
            push_filters(node.child), node.order_by, node.limit, node.offset
        )
    return node


def _seedable(left: Table, patterns) -> bool:
    """A block can consume ``left`` as SIP seed when every shared variable
    column is fully bound — an UNBOUND (0) value is a compat-join
    wildcard, which the keyed serve lanes cannot express."""
    pat_vars = set().union(*(p.variables for p in patterns)) if patterns else set()
    return all(
        bool((c != algebra.UNBOUND).all())
        for v, c in left.cols.items()
        if v in pat_vars
    )


def execute(
    store: K2TriplesStore, node, *, cap: int = 2048, serve=None,
) -> Table:
    """Evaluate an algebra tree to a solution :class:`Table` (multiset —
    final semantics, DISTINCT included, are applied by ``Project`` /
    ``Slice`` nodes or by the caller via ``algebra.project_named``).

    Conjunctive regions run as cost-ordered SIP pipelines over the serve
    IR (see :func:`_run_block`); ``LeftJoin``/``Join`` sides that flatten
    to a BGP are seeded with the left result so they reuse the same
    pooled launches; everything else evaluates on host tables.
    """
    kw = dict(cap=cap, serve=serve)
    node = push_filters(node)

    def ev(n):
        if isinstance(n, (algebra.Scan, algebra.Join)):
            flat = algebra.flatten_bgp(n)
            if flat is not None:
                return _run_block(store, flat, None, **kw)
        if isinstance(n, algebra.Join):
            left = ev(n.left)
            rflat = algebra.flatten_bgp(n.right)
            if rflat is not None:
                if left.n == 0:
                    return Table.empty(
                        sorted(set(left.cols) | algebra.node_vars(n.right))
                    )
                if _seedable(left, rflat):
                    return _run_block(store, rflat, left, **kw)
            right = ev(n.right)
            return algebra.join_tables(left, right)
        if isinstance(n, algebra.LeftJoin):
            left = ev(n.left)
            rvars = algebra.node_vars(n.right)
            if left.n == 0:
                return Table.empty(sorted(set(left.cols) | rvars))
            rflat = algebra.flatten_bgp(n.right)
            if rflat is not None and _seedable(left, rflat):
                rowid = "?__ljrow"
                seed = Table(
                    {**left.cols, rowid: np.arange(left.n, dtype=np.int64)},
                    left.n,
                )
                j = _run_block(store, rflat, seed, **kw)
                matched = np.zeros(left.n, np.bool_)
                if j.n:
                    matched[j.cols[rowid]] = True
                miss = np.nonzero(~matched)[0]
                cols = {}
                for v in j.cols:
                    if v == rowid:
                        continue
                    pad = (
                        left.cols[v][miss]
                        if v in left.cols
                        else np.full(miss.shape[0], algebra.UNBOUND, np.int64)
                    )
                    cols[v] = np.concatenate([j.cols[v], pad])
                return Table(cols, j.n + int(miss.shape[0]))
            right = ev(n.right)
            return algebra.left_join_tables(left, right)
        if isinstance(n, algebra.Union):
            return algebra.union_tables(ev(n.left), ev(n.right))
        if isinstance(n, algebra.Filter):
            t = ev(n.child)
            scope = algebra.node_vars(n.child)
            val, err = algebra.eval_expr(n.expr, t, scope)
            return t.take(np.nonzero(val & ~err)[0])
        if isinstance(n, algebra.Project):
            t = ev(n.child)
            cols = {
                v: t.cols.get(v, np.full(t.n, algebra.UNBOUND, np.int64))
                for v in n.vars
            }
            return algebra.distinct(Table(cols, t.n))
        if isinstance(n, algebra.Slice):
            return algebra.sort_slice(
                ev(n.child), n.order_by, n.limit, n.offset
            )
        raise TypeError(f"not an algebra node: {n!r}")

    return ev(node)
