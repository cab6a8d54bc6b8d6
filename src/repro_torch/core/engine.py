"""Query engine: ``Engine.compile(query, config) -> Plan`` over one batched
``serve_step`` per geometry.

``TriplePatternQ`` plans lower the six keyed pattern shapes to serve-IR
lanes; (?S,P,?O) and the dump run the ``k2_range`` pair enumeration.
``JoinQ`` plans resolve categories A–C as serve-IR side lists plus the
sorted-set algebra of ``core.sortedset``, and D–F through ``core.joins``
(the fused ``k2_scan_rebind`` kernel for D and E).  ``ServeQ`` is the raw
serve-IR passthrough the broker streams through.

Serve IR: a ``ServeBatch`` lane is ``(op, s, p, o)`` with

    OP_CHECK      (S, P, O)     -> hit flag
    OP_ROW        (S, P, ?O)    -> object list            (ids/valid/count)
    OP_COL        (?S, P, O)    -> subject list           (ids/valid/count)
    OP_S_ANY_O    (S, ?P, O)    -> matching predicates    (ids/valid/count)
    OP_S_ANY_ANY  (S, ?P, ?O)   -> per-pred object lists  (u_* block)
    OP_ANY_ANY_O  (?S, ?P, O)   -> per-pred subject lists (u_* block)

and op ``-1`` marks a dead (padding) lane, whose outputs are zero.

Unbounded-``?P`` lanes gather their candidate predicates from the SP/OP
index (k²-triples+, arXiv:1310.4954) and run a pruned scan of ``u_width``
lanes per query; without an index they sweep all predicates.

A serve step launches, per batch: the forest check (B lanes), the mixed
scan (B lanes), and with unbounded lanes the index gather (B rows), the
pruned scan (B·u_width lanes) and the candidate check (B·u_width lanes).
On a CUDA store each is a hand-written kernel (``kernels/ops.py``); the
rest is elementwise torch.  Nothing on ``Plan.submit`` synchronises with
the device: the batch is uploaded from pinned memory without blocking, and
the fetch (:func:`host_result`) waits on an event recorded at dispatch.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import joins, k2forest, predindex, sortedset
from repro_torch.core.k2forest import K2Forest
from repro_torch.core.k2tree import K2Meta, compact
from repro_torch.core.k2triples import K2TriplesStore
from repro_torch.core.predindex import PredIndex, PredIndexMeta
from repro_torch.core.query import (
    AdmissionError, CapOverflow, ExecConfig, JoinQ, Plan, ServeQ,
    TriplePatternQ, resolve_device, run_with_policy, shape_key,
)
from repro_torch.core.sortedset import SENTINEL, IdSet

# serve IR ops
OP_CHECK = 0
OP_ROW = 1
OP_COL = 2
OP_S_ANY_ANY = 3
OP_ANY_ANY_O = 4
OP_S_ANY_O = 5
UNBOUNDED_OPS = (OP_S_ANY_O, OP_S_ANY_ANY, OP_ANY_ANY_O)


class ServeBatch(NamedTuple):
    """Encoded queries (1-based ids; 0 for positions an op leaves free)."""

    op: torch.Tensor | np.ndarray  # int32[B] serve IR op, -1 = dead lane
    s: torch.Tensor | np.ndarray  # int32[B] subject id (or 0)
    p: torch.Tensor | np.ndarray  # int32[B] predicate id (0 for unbounded ops)
    o: torch.Tensor | np.ndarray  # int32[B] object id (or 0)


RESULT_FIELDS = (
    "hit", "ids", "valid", "count", "overflow",
    "u_preds", "u_ids", "u_valid", "u_count",
)


@dataclasses.dataclass
class ServeResult:
    """Per-lane results: torch tensors on the device, or numpy on the host.

    ``ready`` is the CUDA event recorded after a dispatch's last launch
    (``None`` for CPU and host results); :func:`host_result` waits on it.
    """

    hit: object  # bool[B]        checks
    ids: object  # int32[B,cap]   scans + S?PO predicate lists (1-based)
    valid: object  # bool[B,cap]
    count: object  # int32[B]
    overflow: object  # bool[B]
    u_preds: object  # int32[B,L]   candidate predicate ids (1-based; 0 dead)
    u_ids: object  # int32[B,L,cap] per-candidate results (1-based)
    u_valid: object  # bool[B,L,cap]
    u_count: object  # int32[B,L]
    ready: object = dataclasses.field(default=None, repr=False, compare=False)


def take_lanes(q: ServeBatch, idx) -> ServeBatch:
    """The sub-batch of lanes ``idx`` (any numpy fancy index), on the host."""
    idx = np.asarray(idx)
    return ServeBatch(*(_host(a)[idx] for a in q))


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def host_result(r: ServeResult, *, unbounded: bool = True) -> ServeResult:
    """ONE blocking device->host fetch of a ``ServeResult`` (numpy fields).

    For a CUDA result the copy runs on a side stream that waits only on the
    result's ``ready`` event, so a batch submitted after this one keeps the
    card busy meanwhile (the broker's double buffering); it is safe to call
    from a worker thread.  ``unbounded=False`` skips the ``u_*`` block —
    the largest transfer — for batches without unbounded lanes.
    """
    names = RESULT_FIELDS if unbounded else RESULT_FIELDS[:5]
    if r.ready is None:
        out = {n: _host(getattr(r, n)) for n in names}
    else:
        dev = r.ids.device
        side = torch.cuda.Stream(device=dev)
        with torch.cuda.device(dev), torch.cuda.stream(side):
            side.wait_event(r.ready)
            pinned = {}
            for n in names:
                t = getattr(r, n)
                pinned[n] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                pinned[n].copy_(t, non_blocking=True)
        side.synchronize()
        out = {n: t.numpy() for n, t in pinned.items()}
    if not unbounded:
        b, cap = out["ids"].shape
        out.update(
            u_preds=np.zeros((b, 0), np.int32),
            u_ids=np.zeros((b, 0, cap), np.int32),
            u_valid=np.zeros((b, 0, cap), np.bool_),
            u_count=np.zeros((b, 0), np.int32),
        )
    return ServeResult(**out)


def decode_lane(op: int, r: ServeResult, i: int):
    """Decode ONE lane of a host-side ``ServeResult``:

      OP_CHECK -> bool;  OP_ROW / OP_COL -> sorted id array;
      OP_S_ANY_O -> matching predicate id array;
      OP_S_ANY_ANY / OP_ANY_ANY_O -> {pred id: id array}.
    """
    if op == OP_CHECK:
        return bool(r.hit[i])
    if op in (OP_ROW, OP_COL, OP_S_ANY_O):
        return r.ids[i][r.valid[i]]
    if op in (OP_S_ANY_ANY, OP_ANY_ANY_O):
        return {
            int(r.u_preds[i, l]): r.u_ids[i, l][r.u_valid[i, l]]
            for l in range(r.u_preds.shape[1])
            if r.u_preds[i, l] and r.u_valid[i, l].any()
        }
    raise ValueError(f"not a decodable serve op: {op}")


def _u_candidates(
    q: ServeBatch, f: K2Forest, u_width: int,
    index: PredIndex | None, pmeta: PredIndexMeta | None,
):
    """Candidate predicate lists for the unbounded lanes of a batch.

    Returns ``(is_u_pair, is_u_check, u_key, u_axis, cpreds, cvalid,
    ctrunc)``: 0-based candidates in ``cpreds[B, u_width]`` from the SP/OP
    index when given, else the all-preds sweep (requires u_width >= P).
    """
    is_u_pair = (q.op == OP_S_ANY_ANY) | (q.op == OP_ANY_ANY_O)
    is_u_check = q.op == OP_S_ANY_O
    is_u = is_u_pair | is_u_check
    u_axis = (q.op == OP_ANY_ANY_O).to(torch.int32)
    u_key = (torch.where(u_axis == 1, q.o, q.s) - 1).clamp(min=0)
    u_key = torch.where(is_u, u_key, 0)
    b = q.op.shape[0]
    if index is not None:
        rows = torch.where(u_axis == 1, pmeta.n_subjects + u_key, u_key)
        g = predindex.gather_batch(pmeta, index, torch.where(is_u, rows, 0), u_width)
        cpreds, cvalid, ctrunc = g.ids, g.valid, g.overflow
    else:
        if u_width < f.n_preds:
            raise ValueError(
                f"all-preds fallback needs u_width >= n_preds "
                f"({u_width} < {f.n_preds}); pass an index to prune"
            )
        lane = torch.arange(u_width, dtype=torch.int32, device=q.op.device)
        cpreds = lane.expand(b, u_width)
        cvalid = (lane < f.n_preds).expand(b, u_width)
        ctrunc = torch.zeros(b, dtype=torch.bool, device=q.op.device)
    cvalid = cvalid & is_u[:, None]
    return is_u_pair, is_u_check, u_key, u_axis, cpreds, cvalid, ctrunc


def _serve_local(
    meta: K2Meta, f: K2Forest, q: ServeBatch, cap: int, *,
    index: PredIndex | None = None, pmeta: PredIndexMeta | None = None,
    u_width: int = 0,
) -> ServeResult:
    """Resolve a batch against the forest.  ``u_width`` > 0 enables the
    unbounded-?P lanes (candidate slots per query); 0 leaves them out."""
    b = q.op.shape[0]
    dev = q.op.device
    pred = (q.p - 1).clamp(min=0)
    is_check = q.op == OP_CHECK
    # negative s/o of non-check lanes are fine: the check clips like JAX
    hit = k2forest.check(meta, f, pred, q.s - 1, q.o - 1) & is_check
    is_col = q.op == OP_COL
    axes = is_col.to(torch.int32)
    key = (torch.where(is_col, q.o, q.s) - 1).clamp(min=0)
    r = k2forest.scan_batch_mixed(meta, f, pred, key, axes, cap)
    scan_lane = (q.op == OP_ROW) | is_col
    valid = r.valid & scan_lane[:, None]
    ids = torch.where(valid, r.ids + 1, 0)
    count = torch.where(scan_lane, r.count, 0)
    overflow = r.overflow & scan_lane

    if u_width <= 0:
        return ServeResult(
            hit=hit, ids=ids, valid=valid, count=count, overflow=overflow,
            u_preds=torch.zeros((b, 0), dtype=torch.int32, device=dev),
            u_ids=torch.zeros((b, 0, cap), dtype=torch.int32, device=dev),
            u_valid=torch.zeros((b, 0, cap), dtype=torch.bool, device=dev),
            u_count=torch.zeros((b, 0), dtype=torch.int32, device=dev),
        )

    is_u_pair, is_u_check, u_key, u_axis, cpreds, cvalid, ctrunc = (
        _u_candidates(q, f, u_width, index, pmeta)
    )
    preds_f = torch.where(cvalid, cpreds, 0).reshape(b * u_width)
    keys_f = torch.repeat_interleave(u_key, u_width)

    # pair lanes: one pruned mixed scan replaces the P-way broadcast sweep
    ru = k2forest.scan_batch_mixed(
        meta, f, preds_f, keys_f, torch.repeat_interleave(u_axis, u_width), cap
    )
    pair_valid = cvalid & is_u_pair[:, None]
    u_valid = ru.valid.reshape(b, u_width, cap) & pair_valid[:, :, None]
    u_ids = torch.where(u_valid, ru.ids.reshape(b, u_width, cap) + 1, 0)
    u_count = torch.where(pair_valid, ru.count.reshape(b, u_width), 0)
    u_preds = torch.where(pair_valid, cpreds + 1, 0)
    overflow = overflow | (
        is_u_pair
        & ((ru.overflow.reshape(b, u_width) & pair_valid).any(dim=1) | ctrunc)
    )

    # S?PO lanes: check candidates, compact matching predicate ids into ids;
    # matches beyond cap truncate WITH the overflow bit set
    hitm = k2forest.check(
        meta, f, preds_f,
        torch.repeat_interleave((q.s - 1).clamp(min=0), u_width),
        torch.repeat_interleave((q.o - 1).clamp(min=0), u_width),
    ).reshape(b, u_width) & cvalid & is_u_check[:, None]
    valid5, count5, ovf5, (ids5,) = compact(hitm, cap, torch.where(hitm, cpreds + 1, 0))
    ids = torch.where(is_u_check[:, None], ids5, ids)
    valid = torch.where(is_u_check[:, None], valid5, valid)
    count = torch.where(is_u_check, count5, count)
    overflow = overflow | (is_u_check & (ovf5 | ctrunc))

    return ServeResult(
        hit=hit, ids=ids, valid=valid, count=count, overflow=overflow,
        u_preds=u_preds, u_ids=u_ids, u_valid=u_valid, u_count=u_count,
    )


def make_serve_step(
    meta: K2Meta, cap: int, *, pmeta: PredIndexMeta | None = None,
    u_width: int | None = None,
):
    """Serve program of one geometry: ``serve_step(forest, batch[, index])``.

    ``u_width`` candidate slots per unbounded lane (default:
    ``pmeta.max_degree`` when an index meta is given, else 0 = unbounded
    ops left out).  ``index=None`` with ``u_width >= n_preds`` runs the
    all-preds sweep.
    """
    if u_width is None:
        u_width = pmeta.max_degree if pmeta is not None else 0

    def serve_step(f: K2Forest, q: ServeBatch, index=None) -> ServeResult:
        return _serve_local(meta, f, q, cap, index=index, pmeta=pmeta, u_width=u_width)

    return serve_step


def int32_lanes(values) -> np.ndarray:
    """Python ints as an int32 array, refusing one outside int32 with
    ``OverflowError`` as numpy's element assignment does (an int64 array
    cast to int32 wraps instead)."""
    a = np.asarray(values, dtype=np.int64)
    bad = (a < -2**31) | (a >= 2**31)
    if bad.any():
        raise OverflowError(f"Python integer {a[bad].flat[0]} out of bounds for int32")
    return a.astype(np.int32)


def upload_batch(batch, device: torch.device) -> ServeBatch:
    """A ``ServeBatch`` of contiguous int32 tensors on ``device``.

    A list or tuple field refuses an id outside int32 (``OverflowError``,
    as the JAX package's ``jnp.asarray``); an array field is cast, so an
    int64 array wraps, as there.  Host batches go up as one (4, B) copy
    from pinned memory that does not block the host.
    """
    if all(isinstance(a, torch.Tensor) and a.device == device for a in batch):
        return ServeBatch(*(a.to(torch.int32).contiguous() for a in batch))
    host = torch.from_numpy(np.stack([
        int32_lanes(a) if isinstance(a, (list, tuple)) else np.asarray(_host(a), dtype=np.int32)
        for a in batch
    ]))
    if device.type == "cuda":
        host = host.pin_memory().to(device, non_blocking=True)
    return ServeBatch(*host.unbind(0))


_OP_FOR_SHAPE = {
    (True, True, True): OP_CHECK,
    (True, True, False): OP_ROW,
    (False, True, True): OP_COL,
    (True, False, True): OP_S_ANY_O,
    (True, False, False): OP_S_ANY_ANY,
    (False, False, True): OP_ANY_ANY_O,
}


class _ExecBase:
    """Executor state: one per ``(shape_key, config)`` cache slot.

    Holds the effective caps, grown in place by the :class:`CapPolicy`
    doubling loop, so every plan sharing this executor keeps a growth paid
    once.
    """

    def __init__(self, engine: "Engine", cfg: ExecConfig):
        self.engine = engine
        self.cfg = cfg
        self.cap = cfg.cap
        self.cap_y = cfg.cap_y

    def _grow(self, fn):
        out, self.cap, self.cap_y = run_with_policy(
            self.cfg.cap_policy, self.cap, self.cap_y, fn
        )
        return out

    def submit(self, q, batch):
        raise NotImplementedError(
            f"{type(self).__name__} has no raw device surface; "
            "Plan.submit is a ServeQ-only streaming hook"
        )

    @staticmethod
    def _overflow_guard(r):
        if bool(r.overflow.any()):
            raise CapOverflow(
                "result lane truncated at cap; CapPolicy(grow=True) doubles"
            )


class _PatternExec(_ExecBase):
    """Any of the eight triple-pattern shapes, single query or batched."""

    def run(self, q: TriplePatternQ, batch):
        s, p, o, b, single = self._consts(q, batch)
        bound = q.bound
        if bound == (False, True, False):  # (?S, P, ?O) pair enumeration
            out = self._grow(lambda cap, _: self._run_pairs(p, b, cap))
        elif bound == (False, False, False):  # (?S, ?P, ?O) dump
            if batch is not None:
                raise ValueError("the dump pattern takes no batch")
            out = self._grow(lambda cap, _: self._run_dump(cap))
        else:
            op = _OP_FOR_SHAPE[bound]
            out = self._grow(lambda cap, _: self._run_serve(op, s, p, o, b, cap))
        return out[0] if single else out

    def _consts(self, q: TriplePatternQ, batch):
        vals = {"s": q.s, "p": q.p, "o": q.o}
        bound = dict(zip("spo", q.bound))
        if batch is None:
            b, single = 1, True
            batch = {}
        else:
            if not batch:
                raise ValueError(
                    "batch must be a non-empty dict of bound-position id "
                    "arrays (or None to use the query's own constants)"
                )
            bad = set(batch) - {k for k in "spo" if bound[k]}
            if bad:
                raise ValueError(
                    f"batch keys {sorted(bad)} are not bound positions of {q!r}"
                )
            b, single = len(np.asarray(next(iter(batch.values())))), False
        arrs = []
        for k in "spo":
            if k in batch:
                a = np.asarray(batch[k], np.int64).reshape(-1)
                if a.shape[0] != b:
                    raise ValueError("batch arrays must share one length")
            else:
                a = np.full(b, vals[k] if bound[k] else 0, np.int64)
            arrs.append(a)
        return (*arrs, b, single)

    def _run_serve(self, op, s, p, o, b, cap):
        eng, cfg = self.engine, self.cfg
        with_index = False
        u_width = 0
        if op in UNBOUNDED_OPS:
            with_index = cfg.use_pred_index and eng.store.pred_index is not None
            u_width = eng._u_width() if with_index else max(eng.store.n_preds, 1)
        r = eng._run_lanes(cfg, cap, np.full(b, op, np.int32), s, p, o,
                           u_width=u_width, with_index=with_index)
        self._overflow_guard(r)
        return self._decode(op, r, range(b))

    @staticmethod
    def _decode(op, r, idxs):
        h = host_result(r, unbounded=op in UNBOUNDED_OPS)
        return [decode_lane(op, h, i) for i in idxs]

    def _run_pairs(self, p, b, cap):
        eng = self.engine
        r = k2forest.range_scan_batch(eng.meta, eng.forest, p - 1, cap)
        self._overflow_guard(r)
        rows, cols, valid = (_host(a) for a in (r.rows, r.cols, r.valid))
        return [
            np.stack([rows[i][valid[i]] + 1, cols[i][valid[i]] + 1], axis=1)
            for i in range(b)
        ]

    def _run_dump(self, cap):
        n = self.engine.store.n_preds
        pairs = self._run_pairs(np.arange(1, n + 1), n, cap)
        return [{pi + 1: pr for pi, pr in enumerate(pairs) if pr.shape[0]}]


class _JoinExec(_ExecBase):
    """Join categories A–F.  A–C are serve-IR side-list lanes through the
    shared serve programs plus ``sortedset`` algebra; D–F run
    ``core.joins``."""

    def run(self, q: JoinQ, batch):
        if batch is not None:
            raise ValueError("join plans take no batch")
        if q.category in "ABC":
            return self._grow(lambda cap, _: self._run_abc(q, cap))
        return self._grow(lambda cap, cap_y: self._run_def(q, cap, cap_y))

    @staticmethod
    def _lane(vpos, p, c):
        # ?X in subject position -> reverse neighbours (?S,P,O) = OP_COL;
        # ?X in object position -> direct neighbours (S,P,?O) = OP_ROW
        return (OP_COL, 0, p, c) if vpos == "s" else (OP_ROW, c, p, 0)

    @staticmethod
    def _idset(r, i) -> IdSet:
        return IdSet(
            torch.where(r.valid[i], r.ids[i], SENTINEL), r.valid[i], r.count[i],
            torch.zeros((), dtype=torch.bool, device=r.valid.device),
        )

    def _run_abc(self, q, cap):
        eng, cfg = self.engine, self.cfg
        Pn = eng.store.n_preds
        if q.category == "A":
            lanes = [self._lane(q.vpos1, q.p1, q.c1), self._lane(q.vpos2, q.p2, q.c2)]
        elif q.category == "B":
            lanes = [self._lane(q.vpos1, q.p1, q.c1)] + [
                self._lane(q.vpos2, pp, q.c2) for pp in range(1, Pn + 1)
            ]
        else:  # C
            lanes = [self._lane(q.vpos1, pp, q.c1) for pp in range(1, Pn + 1)] + [
                self._lane(q.vpos2, pp, q.c2) for pp in range(1, Pn + 1)
            ]
        arr = np.asarray(lanes, np.int64)
        r = eng._run_lanes(cfg, cap, arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3])
        self._overflow_guard(r)

        if q.category == "A":
            rr = sortedset.intersect(self._idset(r, 0), self._idset(r, 1))
            return _host(rr.ids)[_host(rr.valid)]
        if q.category == "B":
            v2 = r.valid[1:]
            b = IdSet(torch.where(v2, r.ids[1:], SENTINEL), v2,
                      v2.sum(dim=-1, dtype=torch.int32),
                      torch.zeros(Pn, dtype=torch.bool, device=v2.device))
            rr = sortedset.intersect(self._idset(r, 0), b)
            ids, valid = _host(rr.ids), _host(rr.valid)
            return {pi + 1: ids[pi][valid[pi]] for pi in range(Pn) if valid[pi].any()}
        ids = torch.where(r.valid, r.ids, SENTINEL)
        u1 = sortedset.union_rows(ids[:Pn], r.valid[:Pn], cap, False)
        u2 = sortedset.union_rows(ids[Pn:], r.valid[Pn:], cap, False)
        if bool(u1.overflow | u2.overflow):
            raise CapOverflow("side-list union truncated at cap")
        rr = sortedset.intersect(u1, u2)
        return _host(rr.ids)[_host(rr.valid)]

    def _run_def(self, q, cap, cap_y):
        m, f = self.engine.meta, self.engine.forest
        if q.category == "D":
            r = joins.join_d(m, f, q.p1, q.c1, q.vpos1, q.p2, q.vpos2,
                             cap_x=cap, cap_y=cap_y)
            self._overflow_guard(r)
            return _pairs_to_dict(r)
        if q.category == "E":
            r = joins.join_e(m, f, q.p1, q.c1, q.vpos1, q.vpos2,
                             cap_x=cap, cap_y=cap_y)
        else:  # F
            r = joins.join_f(m, f, q.c1, q.vpos1, q.vpos2, cap_x=cap, cap_y=cap_y)
        self._overflow_guard(r)
        return _pairs_to_dict_pred(r)


def _pairs_to_dict(r: joins.JoinPairs) -> dict[int, np.ndarray]:
    """{x: sorted y ids} over the valid X slots with a non-empty Y list."""
    xs, xv, ys, yv = (_host(a) for a in (r.x_ids, r.x_valid, r.y_ids, r.y_valid))
    return {
        int(xs[i]): ys[i][yv[i]]
        for i in range(xs.shape[0])
        if xv[i] and yv[i].any()
    }


def _pairs_to_dict_pred(r: joins.JoinPairs) -> dict[int, dict[int, np.ndarray]]:
    """{pred: {x: sorted y ids}} over the predicates with any binding."""
    xs, xv, ys, yv = (_host(a) for a in (r.x_ids, r.x_valid, r.y_ids, r.y_valid))
    out: dict[int, dict[int, np.ndarray]] = {}
    for p in range(xs.shape[0]):
        d = {
            int(xs[p, i]): ys[p, i][yv[p, i]]
            for i in range(xs.shape[1])
            if xv[p, i] and yv[p, i].any()
        }
        if d:
            out[p + 1] = d
    return out


class _ServeExec(_ExecBase):
    """Raw serve-IR passthrough: ``plan(ServeBatch) -> ServeResult``."""

    def _coerce(self, batch) -> ServeBatch:
        if batch is None:
            raise ValueError("ServeQ plans take a ServeBatch")
        return upload_batch(ServeBatch(*batch), self.engine.device)

    def run(self, q: ServeQ, batch) -> ServeResult:
        batch = self._coerce(batch)

        def fn(cap, _):
            r = self._call(batch, cap, q.unbounded)
            self._overflow_guard(r)
            return r

        return self._grow(fn)

    def submit(self, q: ServeQ, batch) -> ServeResult:
        """Streamed dispatch: device ``ServeResult`` with NO host sync; the
        overflow guard and any cap growth are the caller's job, and the
        executor's cap never grows through this path."""
        return self._call(self._coerce(batch), self.cap, q.unbounded)

    def _call(self, qb: ServeBatch, cap: int, unbounded: bool) -> ServeResult:
        eng, cfg = self.engine, self.cfg
        if not unbounded:
            r = eng._run_program(cfg, cap, qb)
        elif cfg.use_pred_index and eng.store.pred_index is not None:
            r = eng._run_program(cfg, cap, qb, u_width=eng._u_width(), with_index=True)
        else:
            r = eng._run_program(cfg, cap, qb, u_width=max(eng.store.n_preds, 1))
        if eng.device.type == "cuda":
            r.ready = torch.cuda.Event()
            r.ready.record(torch.cuda.current_stream(eng.device))
        return r


class Engine:
    """The query entry point over one store on one device.

    ``Engine.compile(query, config) -> Plan``; plans are cached on
    ``(shape_key(query), config)`` and the serve programs per geometry.
    """

    def __init__(self, store: K2TriplesStore, *, device="cuda"):
        self.device = resolve_device(device)
        self.store = store if store.device == self.device else store.to(self.device)
        self._plan_cache: dict = {}
        self._programs: dict = {}
        self._stats = {"hits": 0, "misses": 0, "denied": 0}

    @property
    def meta(self) -> K2Meta:
        return self.store.meta

    @property
    def forest(self) -> K2Forest:
        return self.store.forest

    @property
    def default_config(self) -> ExecConfig:
        return ExecConfig(device=str(self.device))

    @property
    def plan_cache_stats(self) -> dict:
        return dict(self._stats, size=len(self._plan_cache))

    def compile(self, q, config: ExecConfig | None = None, *, admit=None) -> Plan:
        """Lower ``q`` under ``config`` (default :attr:`default_config`).

        ``admit`` is the plan-cache admission hook: called with the cache
        key ONLY on a miss; a falsy return raises :class:`AdmissionError`
        instead of building an executor.  Hits bypass it.
        """
        cfg = config or self.default_config
        if resolve_device(cfg.device) != self.device:
            raise ValueError(
                f"config device {cfg.device!r} is not the engine's {self.device}"
            )
        self._validate(q)
        key = (shape_key(q), cfg)
        ex = self._plan_cache.get(key)
        if ex is None:
            if admit is not None and not admit(key):
                self._stats["denied"] += 1
                raise AdmissionError(f"plan-cache admission denied for {key[0]!r}")
            self._stats["misses"] += 1
            ex = self._plan_cache[key] = self._build_executor(q, cfg)
        else:
            self._stats["hits"] += 1
        return Plan(q, cfg, ex)

    @staticmethod
    def _validate(q) -> None:
        if isinstance(q, TriplePatternQ):
            named = q.variables
            if len(named) != len(set(named)):
                raise ValueError(
                    "a variable repeated inside one pattern needs join "
                    f"semantics, which this package does not plan: {q!r}"
                )

    def _build_executor(self, q, cfg: ExecConfig):
        if isinstance(q, TriplePatternQ):
            return _PatternExec(self, cfg)
        if isinstance(q, JoinQ):
            return _JoinExec(self, cfg)
        if isinstance(q, ServeQ):
            return _ServeExec(self, cfg)
        raise TypeError(f"not a Query of this package: {q!r}")

    def _u_width(self) -> int:
        return max(self.store.pred_index.meta.max_degree, 1)

    def _program(self, cfg: ExecConfig, cap: int, u_width: int, with_index: bool):
        """One cached serve program per geometry, shared by all executors."""
        key = (cap, u_width, with_index, cfg.pred_index_layout)
        fn = self._programs.get(key)
        if fn is None:
            pmeta = (
                self.store.pred_index.select(cfg.pred_index_layout)[1]
                if with_index else None
            )
            fn = self._programs[key] = make_serve_step(
                self.meta, cap, pmeta=pmeta, u_width=u_width
            )
        return fn

    def _pad_b(self, b: int) -> int:
        """pow2 bucket (>= 8) for a batch of ``b`` lanes."""
        n = 8
        while n < b:
            n <<= 1
        return n

    def _run_program(self, cfg: ExecConfig, cap: int, qb: ServeBatch, *,
                     u_width: int = 0, with_index: bool = False) -> ServeResult:
        """One uploaded batch through the cached program of its geometry."""
        fn = self._program(cfg, cap, u_width, with_index)
        if with_index:
            return fn(self.forest, qb, self.store.pred_index.select(cfg.pred_index_layout)[0])
        if u_width > 0:
            return fn(self.forest, qb, None)
        return fn(self.forest, qb)

    def _run_lanes(
        self, cfg: ExecConfig, cap: int, ops_a, s, p, o,
        *, u_width: int = 0, with_index: bool = False,
    ) -> ServeResult:
        """Run host serve-IR lanes through the cached program of their
        geometry: padded to a pow2 bucket with dead (op = -1) lanes, which
        the serve step zeroes, and sliced back to the ``b`` real lanes.
        Every pattern plan and join side list shares this dispatch."""
        b = int(np.shape(ops_a)[0])
        n = self._pad_b(b)

        def pad(a, fill):
            out = np.full(n, fill, np.int32)
            out[:b] = np.asarray(a, np.int64)
            return out

        qb = upload_batch(
            ServeBatch(pad(ops_a, -1), pad(s, 0), pad(p, 0), pad(o, 0)), self.device
        )
        r = self._run_program(cfg, cap, qb, u_width=u_width, with_index=with_index)
        return ServeResult(**{name: getattr(r, name)[:b] for name in RESULT_FIELDS})
