"""Query engine: ``Engine.compile(query, config) -> Plan`` over one batched
``serve_step`` per geometry.

``TriplePatternQ`` plans lower the six keyed pattern shapes to serve-IR
lanes; (?S,P,?O) and the dump run the ``k2_range`` pair enumeration.
``JoinQ`` plans resolve categories A–C as serve-IR side lists plus the
sorted-set algebra of ``core.sortedset``, and D–F through ``core.joins``
(the fused ``k2_scan_rebind`` kernel for D and E).  ``BgpQ`` and
``SelectQ`` plans lower to a ``core.algebra`` tree that ``core.planner``
executes, every check and bounded scan step through the same pooled serve
step.  ``ServeQ`` is the raw serve-IR passthrough the broker streams
through.

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

Quantile-sized lanes (``ExecConfig.u_width_quantile`` below 1): pattern
plans size the unbounded lane at a quantile of the entity degrees and
send the entities whose list is longer (read off the host CSR) to the
single-device all-preds sweep; raw ``ServeQ`` plans refuse it.

Distribution (the paper's vertical partitioning over a device mesh,
``ExecConfig.mesh``): the forest is split by predicate over the model
axis and a batch over the data axes; one process launches every shard's
step on its device and sums the masked partials on the mesh's lead device
(:func:`make_sharded_serve_step`).  Only serve-lane shapes are sharded:
pair enumeration, the dump, joins D–F and BGP/SELECT plans refuse a mesh.

Dynamic stores (``core.delta.DynamicStore``): every dispatch pins a
``DynView`` (static epoch + delta snapshot), masks the lanes whose
constants lie past the static extents to dead on the host before the
batch is uploaded, and folds the snapshot into the fetched result on the
host — (static − tombstones) ∪ inserts.  Executors pin the store epoch
they were compiled at and raise :class:`StaleEpoch` after a compaction
swap; ``compile`` drops every cached executor of an older epoch.

With observability on (``repro_torch.obs``) a ``ServeQ`` call records
``plan.call`` around ``plan.dispatch`` (the launches) and ``plan.sync``
(the overflow check, where the host waits for the card); a D–F join the
same three around its launches and wait, then ``plan.decode``; every
dispatch of host lanes ``plan.lanes``, every fetch ``engine.fetch``, every
lane decode ``plan.decode_lane`` and every plan-cache miss
``engine.compile``.  Each site costs one attribute read when it is off.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import (
    algebra, joins, k2forest, optimizer, planner, predindex, sortedset,
)
from repro_torch.core import delta as dyn
from repro_torch.core.k2forest import K2Forest
from repro_torch.core.k2tree import K2Meta, compact
from repro_torch.core.k2triples import K2TriplesStore
from repro_torch.core.predindex import PredIndex, PredIndexMeta
from repro_torch.core.query import (
    AdmissionError, BgpQ, CapOverflow, ExecConfig, JoinQ, Plan, SelectQ,
    ServeQ, StaleEpoch, TriplePatternQ, is_var, resolve_device,
    run_with_policy, shape_key,
)
from repro_torch.obs import cost as obs_cost
from repro_torch.core.sortedset import SENTINEL, IdSet
from repro_torch.dist import collectives as col
from repro_torch.launch.mesh import MODEL_AXIS

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
    t = obs.STATE.tracer
    if t is None:
        return _host_result(r, unbounded)
    with t.span("engine.fetch", cat="engine",
                b=int(r.ids.shape[0]), unbounded=unbounded):
        return _host_result(r, unbounded)


def _host_result(r: ServeResult, unbounded: bool) -> ServeResult:
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


def _on_device(r: ServeResult, device: torch.device) -> ServeResult:
    """A host (merged) result back on ``device``; tensors pass through."""
    return ServeResult(**{
        n: torch.as_tensor(getattr(r, n), device=device) for n in RESULT_FIELDS
    }, ready=r.ready)


def decode_lane(op: int, r: ServeResult, i: int):
    """Decode ONE lane of a host-side ``ServeResult``:

      OP_CHECK -> bool;  OP_ROW / OP_COL -> sorted id array;
      OP_S_ANY_O -> matching predicate id array;
      OP_S_ANY_ANY / OP_ANY_ANY_O -> {pred id: id array}.
    """
    t = obs.STATE.tracer
    if t is None:
        return _decode_lane(op, r, i)
    with t.span("plan.decode_lane", cat="plan", op=int(op)):
        return _decode_lane(op, r, i)


def _decode_lane(op: int, r: ServeResult, i: int):
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


# ---------------------------------------------------------------------------
# sharded serving: the forest split by predicate over a device mesh
# ---------------------------------------------------------------------------


def pad_preds(f: K2Forest, multiple: int) -> K2Forest:
    """Pad the predicate axis to a multiple of ``multiple`` with all-zero
    trees, which are valid empty trees: lanes routed to them answer
    nothing."""
    pad = (-f.n_preds) % multiple
    if pad == 0:
        return f
    return K2Forest(*(
        torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
        for a in (getattr(f, fld.name) for fld in dataclasses.fields(K2Forest))
    ))


def shard_forest(f: K2Forest, mesh) -> tuple[K2Forest, ...]:
    """The forest shard of every mesh position (``mesh.devices`` order):
    model shard ``j`` holds trees ``j·P/mp .. (j+1)·P/mp - 1``, local ids
    from 0.  On ``f``'s device a shard is a row view of the arena, with no
    copy; on another device one copy a (device, shard) is shared by the
    positions that name it.  ``f.n_preds`` must divide by the ``model``
    axis size (:func:`pad_preds`)."""
    mp = mesh.shape[MODEL_AXIS]
    if f.n_preds % mp:
        raise ValueError(f"{f.n_preds} trees do not split over {mp} shards; pad_preds first")
    p_loc = f.n_preds // mp
    arrays = [getattr(f, fld.name) for fld in dataclasses.fields(K2Forest)]
    views = [K2Forest(*(a[j * p_loc:(j + 1) * p_loc] for a in arrays)) for j in range(mp)]
    out: list = [None] * len(mesh.devices)
    copies: dict = {}
    coords = {pos: j for row in mesh.grid() for j, pos in enumerate(row)}
    for pos, j in coords.items():
        dev = mesh.devices[pos]
        if dev == f.device:
            out[pos] = views[j]
        else:
            if (dev, j) not in copies:
                copies[dev, j] = views[j].to(dev)
            out[pos] = copies[dev, j]
    return tuple(out)


def replicate_index(index: PredIndex, mesh) -> dict:
    """{device: the index on it} for every device of the mesh (the index is
    replicated: one copy a distinct device, none on the index's own)."""
    return {dev: (index if dev == index.offsets.device else index.to(dev))
            for dev in dict.fromkeys(mesh.devices)}


def _to(q: ServeBatch, dev: torch.device) -> ServeBatch:
    return q if q.op.device == dev else ServeBatch(*(a.to(dev) for a in q))


def _reduce(parts, lead: torch.device) -> torch.Tensor:
    """Sum int32 partials over the model axis on the lead device, in shard
    order.  A partial on another card is a peer copy: PyTorch orders it
    after the producing stream's work and makes the lead's stream wait on
    it (an event each way), so no second path is needed for it."""
    acc = parts[0].to(lead, non_blocking=True)
    for p in parts[1:]:
        acc = acc + p.to(lead, non_blocking=True)
    return acc


def make_sharded_serve_step(
    meta: K2Meta, mesh, cap: int, *,
    pmeta: PredIndexMeta | None = None, u_width: int | None = None,
):
    """Sharded serve program: ``fn(shards, batch[, indexes])`` with
    ``shards`` from :func:`shard_forest` and ``indexes`` from
    :func:`replicate_index`; the result lands on the mesh's lead device.

    The batch splits into equal slices over the data axes (every axis but
    ``model``).  Within a
    slice, every model shard holds P/mp trees; a lane of global predicate
    g is owned by shard g // P_loc and resolved there with local id
    g % P_loc, and the other shards see it dead (op -1).  With ``pmeta``
    the unbounded lanes are served too: candidates are gathered from the
    replicated index, each shard scans and checks only the candidates it
    owns.  Only masked int32 partials are summed over the model axis: the
    ids, one ``hit + 2·overflow`` word a lane, the unbounded ids + 1, one
    ``check hit + 2·count`` word a candidate and the pair-overflow flag;
    ``valid``, ``count`` and the S?PO compaction are re-derived after the
    sum, as the JAX package's ``make_sharded_serve_step`` does.
    """
    if u_width is None:
        u_width = pmeta.max_degree if pmeta is not None else 0
    if u_width > 0 and pmeta is None:
        raise ValueError("sharded unbounded serve requires a pred index (pmeta)")
    grid = mesh.grid()
    lead = mesh.lead

    def local(f_loc: K2Forest, j: int, q: ServeBatch, cand):
        """Shard ``j``'s masked partials for slice ``q`` (on its device)."""
        p_loc = f_loc.n_preds
        g = q.p - 1
        mine = torch.div(g, p_loc, rounding_mode="floor") == j
        q_loc = ServeBatch(torch.where(mine, q.op, -1), q.s,
                           torch.where(mine, g % p_loc, 0) + 1, q.o)
        r = _serve_local(meta, f_loc, q_loc, cap)
        parts = [
            torch.where(mine[:, None], r.ids, 0),
            torch.where(mine, r.hit.to(torch.int32) + 2 * r.overflow.to(torch.int32), 0),
        ]
        if u_width <= 0:
            return parts
        b = q.op.shape[0]
        is_u_pair, is_u_check, u_key, u_axis, cpreds, cvalid, _ = cand
        mine_u = cvalid & (torch.div(cpreds, p_loc, rounding_mode="floor") == j)
        preds_f = torch.where(mine_u, cpreds % p_loc, 0).reshape(b * u_width)
        ru = k2forest.scan_batch_mixed(
            meta, f_loc, preds_f, torch.repeat_interleave(u_key, u_width),
            torch.repeat_interleave(u_axis, u_width), cap,
        )
        pair_mine = mine_u & is_u_pair[:, None]
        uv_loc = ru.valid.reshape(b, u_width, cap) & pair_mine[:, :, None]
        hitm_loc = k2forest.check(
            meta, f_loc, preds_f,
            torch.repeat_interleave((q.s - 1).clamp(min=0), u_width),
            torch.repeat_interleave((q.o - 1).clamp(min=0), u_width),
        ).reshape(b, u_width) & mine_u & is_u_check[:, None]
        return parts + [
            torch.where(uv_loc, ru.ids.reshape(b, u_width, cap) + 1, 0),
            hitm_loc.to(torch.int32)
            + 2 * torch.where(pair_mine, ru.count.reshape(b, u_width), 0),
            (ru.overflow.reshape(b, u_width) & pair_mine).any(dim=1).to(torch.int32),
        ]

    def one_slice(shards, q: ServeBatch, indexes, row) -> ServeResult:
        b = q.op.shape[0]
        dev = q.op.device
        batches, cands = {lead: q}, {}
        partials = []
        for j, pos in enumerate(row):
            d = mesh.devices[pos]
            if d not in batches:
                batches[d] = _to(q, d)
            if u_width > 0 and d not in cands:
                cands[d] = _u_candidates(batches[d], shards[pos], u_width, indexes[d], pmeta)
            partials.append(local(shards[pos], j, batches[d], cands.get(d)))
        ids, flags, *u_parts = (_reduce(list(ps), lead) for ps in zip(*partials))
        valid = ids != 0
        hit = (flags & 1).to(torch.bool)
        overflow = ((flags >> 1) & 1).to(torch.bool)
        count = valid.sum(dim=-1, dtype=torch.int32)
        if u_width <= 0:
            return ServeResult(
                hit=hit, ids=ids, valid=valid, count=count, overflow=overflow,
                u_preds=torch.zeros((b, 0), dtype=torch.int32, device=dev),
                u_ids=torch.zeros((b, 0, cap), dtype=torch.int32, device=dev),
                u_valid=torch.zeros((b, 0, cap), dtype=torch.bool, device=dev),
                u_count=torch.zeros((b, 0), dtype=torch.int32, device=dev),
            )
        u_ids, packed, pair_ovf = u_parts
        if lead not in cands:
            cands[lead] = _u_candidates(q, shards[0], u_width, indexes[lead], pmeta)
        is_u_pair, is_u_check, _, _, cpreds, cvalid, ctrunc = cands[lead]
        hitm = (packed & 1) == 1
        valid5, count5, ovf5, (ids5,) = compact(hitm, cap, torch.where(hitm, cpreds + 1, 0))
        return ServeResult(
            hit=hit,
            ids=torch.where(is_u_check[:, None], ids5, ids),
            valid=torch.where(is_u_check[:, None], valid5, valid),
            count=torch.where(is_u_check, count5, count),
            overflow=(overflow | (is_u_pair & ((pair_ovf > 0) | ctrunc))
                      | (is_u_check & (ovf5 | ctrunc))),
            u_preds=torch.where(cvalid & is_u_pair[:, None], cpreds + 1, 0),
            u_ids=u_ids, u_valid=u_ids != 0, u_count=packed >> 1,
        )

    def step(shards, q: ServeBatch, indexes=None) -> ServeResult:
        n = q.op.shape[0]
        if n % len(grid):
            raise ValueError(f"a batch of {n} lanes does not split over {len(grid)} data slices")
        if u_width > 0 and indexes is None:
            raise ValueError("sharded unbounded serve requires the replicated index")
        w = n // len(grid)
        outs = col.each_slice(lambda i, row: one_slice(
            shards, ServeBatch(*(a[i * w:(i + 1) * w] for a in q)), indexes, row), mesh, grid)
        if len(outs) == 1:
            return outs[0]
        with col.once():
            return ServeResult(**{name: torch.cat([getattr(o, name) for o in outs])
                                  for name in RESULT_FIELDS})

    return step


def make_sharded_unbounded_scan(meta: K2Meta, mesh, cap: int):
    """(S,?P,?O) / (?S,?P,O) sweep: ``fn(shards, keys, axes) -> (ids, valid,
    count)`` shaped ``[B, P_padded, cap]``, on the lead device.

    Each shard scans all its local predicates for its data slice's keys
    (1-based) in one flat (b·P_loc)-lane scan launch; the shards' blocks
    are concatenated along P in shard order (the JAX package's tiled
    ``all_gather``).  The index-free reference of the pruned unbounded
    lanes.
    """
    grid = mesh.grid()
    lead = mesh.lead

    def local(f_loc: K2Forest, keys, axes):
        p_loc = f_loc.n_preds
        b = keys.shape[0]
        preds_f = torch.arange(p_loc, dtype=torch.int32, device=keys.device).repeat(b)
        r = k2forest.scan_batch_mixed(
            meta, f_loc, preds_f, torch.repeat_interleave(keys - 1, p_loc),
            torch.repeat_interleave(axes, p_loc), cap,
        )
        ids = torch.where(r.valid, r.ids + 1, 0).reshape(b, p_loc, cap)
        return ids, r.valid.reshape(b, p_loc, cap), r.count.reshape(b, p_loc)

    def fn(shards, keys, axes):
        keys = k2forest.as_lanes(keys, lead)
        axes = k2forest.as_lanes(axes, lead, keys.shape[0])
        n = keys.shape[0]
        if n % len(grid):
            raise ValueError(f"{n} keys do not split over {len(grid)} data slices")
        w = n // len(grid)

        def one_slice(i, row):
            k, a = keys[i * w:(i + 1) * w], axes[i * w:(i + 1) * w]
            parts = [local(shards[pos], k.to(mesh.devices[pos]), a.to(mesh.devices[pos]))
                     for pos in row]
            return [torch.cat([p[x].to(lead, non_blocking=True) for p in parts], dim=1)
                    for x in range(3)]

        slices = col.each_slice(one_slice, mesh, grid)
        with col.once():
            return tuple(torch.cat([s[x] for s in slices]) for x in range(3))

    return fn


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
        # the store epoch this executor was compiled at: running it after a
        # compaction swap would serve dropped triples from the old forest
        self.epoch = engine.store_epoch

    def _grow(self, fn):
        self.engine._check_epoch(self.epoch)
        t, m = obs.STATE.tracer, obs.STATE.metrics
        if t is not None or m is not None:
            inner = fn

            def fn(cap, cap_y):
                try:
                    return inner(cap, cap_y)
                except CapOverflow:
                    # the policy loop re-runs at doubled caps: the retry
                    # is the event worth counting
                    if m is not None:
                        m.counter("plan.cap_overflow").inc()
                    if t is not None:
                        t.instant("plan.cap_overflow", cap=cap, cap_y=cap_y)
                    raise

        out, self.cap, self.cap_y = run_with_policy(
            self.cfg.cap_policy, self.cap, self.cap_y, fn
        )
        return out

    def submit(self, q, batch):
        raise NotImplementedError(
            f"{type(self).__name__} has no raw device surface; "
            "Plan.submit is a ServeQ-only streaming hook"
        )

    def cost_profile(self, q, batch):
        raise NotImplementedError(
            f"{type(self).__name__} has no serve-program cost surface"
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
        if op not in UNBOUNDED_OPS:
            return self._lanes(op, cfg, cap, s, p, o)
        bi = eng.store.pred_index if cfg.use_pred_index else None
        sweep = max(eng.store.n_preds, 1)
        if bi is None:
            if cfg.mesh is not None:
                raise ValueError(
                    "sharded unbounded-?P serving needs the SP/OP index; "
                    "build the store with its index or drop mesh"
                )
            return self._lanes(op, cfg, cap, s, p, o, u_width=sweep)
        u_width = eng._u_width(cfg)
        if cfg.u_width_quantile >= 1.0:  # the lane holds every list
            return self._lanes(op, cfg, cap, s, p, o, u_width=u_width, with_index=True)
        # quantile-sized lanes: entities whose list is longer than the lane
        # (the gather's overflow bit, read off the host CSR) go to the
        # single-device all-preds sweep, exact at any quantile
        rows = bi.meta.n_subjects + o - 1 if op == OP_ANY_ANY_O else s - 1
        outlier = predindex.host_degrees(bi, rows) > u_width
        out = [None] * b
        for idx, run_cfg, width, with_index in (
            (np.nonzero(~outlier)[0], cfg, u_width, True),
            (np.nonzero(outlier)[0], cfg.replace(mesh=None), sweep, False),
        ):
            if idx.size:
                got = self._lanes(op, run_cfg, cap, s[idx], p[idx], o[idx],
                                  u_width=width, with_index=with_index)
                for j, res in zip(idx, got):
                    out[j] = res
        return out

    def _lanes(self, op, cfg, cap, s, p, o, *, u_width=0, with_index=False):
        """One dispatch of host lanes of ``op``, overflow-guarded, decoded."""
        b = len(s)
        r = self.engine._run_lanes(cfg, cap, np.full(b, op, np.int32), s, p, o,
                                   u_width=u_width, with_index=with_index)
        self._overflow_guard(r)
        return self._decode(op, r, range(b))

    @staticmethod
    def _decode(op, r, idxs):
        h = host_result(r, unbounded=op in UNBOUNDED_OPS)
        return [decode_lane(op, h, i) for i in idxs]

    def _static_pairs(self, p, b, cap):
        eng = self.engine
        r = k2forest.range_scan_batch(eng.meta, eng.forest, p - 1, cap)
        self._overflow_guard(r)
        rows, cols, valid = (_host(a) for a in (r.rows, r.cols, r.valid))
        return [
            np.stack([rows[i][valid[i]] + 1, cols[i][valid[i]] + 1], axis=1)
            for i in range(b)
        ]

    def _run_pairs(self, p, b, cap):
        view = self.engine.dynamic_view()
        if view is None:
            return self._static_pairs(p, b, cap)
        # dynamic: delta-only preds (past the static forest) are clamped to
        # tree 1 for dispatch and answered from the snapshot alone
        eng = self.engine
        p = np.asarray(p, np.int64).reshape(-1)
        safe = p <= view.preds_static
        empty = np.empty(0, np.int64)
        if safe.any():
            r = k2forest.range_scan_batch(eng.meta, eng.forest, np.where(safe, p, 1) - 1, cap)
            rows, cols, valid, ovf = (_host(a) for a in (r.rows, r.cols, r.valid, r.overflow))
            if (ovf & safe).any():
                raise CapOverflow("result lane truncated at cap; CapPolicy(grow=True) doubles")
        out = []
        for i in range(b):
            if safe[i]:
                ss = rows[i][valid[i]].astype(np.int64) + 1
                oo = cols[i][valid[i]].astype(np.int64) + 1
            else:
                ss, oo = empty, empty
            ss, oo = view.snap.merge_pairs(int(p[i]), ss, oo)
            out.append(np.stack([ss, oo], axis=1).reshape(-1, 2))
        return out

    def _run_dump(self, cap):
        view = self.engine.dynamic_view()
        n = self.engine.store.n_preds
        pairs = self._static_pairs(np.arange(1, n + 1), n, cap)
        out = {pi + 1: pr for pi, pr in enumerate(pairs) if pr.shape[0]}
        if view is None:
            return [out]
        merged = {}
        empty = np.empty(0, np.int64)
        for p in range(1, view.total_preds + 1):
            pr = out.get(p)
            ss = pr[:, 0].astype(np.int64) if pr is not None else empty
            oo = pr[:, 1].astype(np.int64) if pr is not None else empty
            ss, oo = view.snap.merge_pairs(p, ss, oo)
            if len(ss):
                merged[p] = np.stack([np.asarray(ss), np.asarray(oo)], axis=1)
        return [merged]


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
        # the B/C side lists cover delta-only appended predicates too: their
        # lanes go dead on the card and the snapshot answers them
        Pn = dyn.total_preds(eng.store)
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
        r = _on_device(r, eng.device)

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
        if self.engine.dynamic_view() is not None:
            # the fused scan->rebind kernels read only the static forest;
            # with a live delta the join decomposes into two serve-lane
            # stages, each through the sanitize+merge path
            return self._run_def_dynamic(q, cap, cap_y)
        t = obs.STATE.tracer
        if t is None:
            return self._def_call(q, cap, cap_y)
        with t.span("plan.call", cat="plan", category=q.category, cap=cap, cap_y=cap_y):
            return self._def_call(q, cap, cap_y)

    def _def_call(self, q, cap, cap_y):
        m, f = self.engine.meta, self.engine.forest
        with obs.span("plan.dispatch", cat="plan"):
            if q.category == "D":
                r = joins.join_d(m, f, q.p1, q.c1, q.vpos1, q.p2, q.vpos2,
                                 cap_x=cap, cap_y=cap_y)
            elif q.category == "E":
                r = joins.join_e(m, f, q.p1, q.c1, q.vpos1, q.vpos2,
                                 cap_x=cap, cap_y=cap_y)
            else:  # F
                r = joins.join_f(m, f, q.c1, q.vpos1, q.vpos2, cap_x=cap, cap_y=cap_y)
        with obs.span("plan.sync", cat="plan"):
            self._overflow_guard(r)
        with obs.span("plan.decode", cat="plan"):
            return _pairs_to_dict(r) if q.category == "D" else _pairs_to_dict_pred(r)


    def _run_def_dynamic(self, q, cap, cap_y):
        eng, cfg = self.engine, self.cfg
        pe = _PatternExec(eng, cfg)
        # stage 1: the shared-variable side list X
        if q.category in ("D", "E"):
            lane = np.asarray([self._lane(q.vpos1, q.p1, q.c1)], np.int64)
            r = eng._run_lanes(cfg, cap, lane[:, 0], lane[:, 1], lane[:, 2], lane[:, 3])
            self._overflow_guard(r)
            r = host_result(r, unbounded=False)
            xs = r.ids[0][r.valid[0]].astype(np.int64)
        else:  # F: ?X linked to c1 by ANY predicate: an unbounded lane, unioned
            op1 = OP_ANY_ANY_O if q.vpos1 == "s" else OP_S_ANY_ANY
            key = np.asarray([q.c1], np.int64)
            zero = np.zeros(1, np.int64)
            s1, o1 = (zero, key) if q.vpos1 == "s" else (key, zero)
            per = pe._run_serve(op1, s1, zero, o1, 1, cap)[0]
            xs = (
                np.unique(np.concatenate([np.asarray(v) for v in per.values()])).astype(np.int64)
                if per else np.empty(0, np.int64)
            )
        if not xs.size:
            return {}
        # stage 2: re-bind each x
        if q.category == "D":
            if q.vpos2 == "s":
                ops2 = np.full(xs.size, OP_ROW, np.int32)
                s2, o2 = xs, np.zeros(xs.size, np.int64)
            else:
                ops2 = np.full(xs.size, OP_COL, np.int32)
                s2, o2 = np.zeros(xs.size, np.int64), xs
            p2 = np.full(xs.size, q.p2, np.int64)
            r2 = eng._run_lanes(cfg, cap_y, ops2, s2, p2, o2)
            self._overflow_guard(r2)
            r2 = host_result(r2, unbounded=False)
            return {
                int(x): r2.ids[i][r2.valid[i]]
                for i, x in enumerate(xs)
                if r2.valid[i].any()
            }
        op2 = OP_S_ANY_ANY if q.vpos2 == "s" else OP_ANY_ANY_O
        zero = np.zeros(xs.size, np.int64)
        s2, o2 = (xs, zero) if q.vpos2 == "s" else (zero, xs)
        per_x = pe._run_serve(op2, s2, zero, o2, xs.size, cap_y)
        out: dict[int, dict[int, np.ndarray]] = {}
        for i, x in enumerate(xs):
            for pl, ys in per_x[i].items():
                if len(ys):
                    out.setdefault(int(pl), {})[int(x)] = np.asarray(ys)
        return {p: d for p, d in sorted(out.items())}


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


class _BgpExec(_ExecBase):
    """Basic graph patterns: the planner orders per call (its join order is
    data-dependent), and every check / bounded-scan step resolves through
    the engine's pooled serve step.

    ``None`` positions are EXISTENTIAL: they join like variables inside
    the planner but are projected away from the result — only named
    variables come back, with distinct rows over those columns.
    """

    def run(self, q: BgpQ, batch):
        if batch is not None:
            raise ValueError("BGP plans take no batch")
        pats = algebra.name_anon(q.patterns)

        def fn(cap, _):
            return optimizer.run_bgp(
                self.engine.store, pats, cap=cap,
                serve=self.engine._lanes_runner(self.cfg, cap),
            )

        # run_bgp dedups over ALL columns; dropping the anonymous ones can
        # leave duplicate rows in the named ones
        return algebra.project_named(self._grow(fn))


class _SelectExec(_ExecBase):
    """SPARQL-shaped SELECT: the query lowers to a ``core.algebra`` operator
    tree and ``core.planner`` executes it — cost-ordered (DP) conjunctive
    blocks with sideways information passing, every check / bounded-scan
    step through the engine's pooled serve step.

    Returns columnar named bindings like ``_BgpExec``; with ``order_by``
    the row order is the query's (a deterministic total order), otherwise
    rows come back in dedup order (set semantics either way).
    """

    def run(self, q: SelectQ, batch):
        if batch is not None:
            raise ValueError("SELECT plans take no batch")
        tree = algebra.from_select(q)

        def fn(cap, _):
            return planner.execute(
                self.engine.store, tree, cap=cap,
                serve=self.engine._lanes_runner(self.cfg, cap),
            )

        # the tree ends in Project (+ Slice): the columns are already the
        # named selection, the rows distinct (and ordered if asked)
        return dict(self._grow(fn).cols)


class _ServeExec(_ExecBase):
    """Raw serve-IR passthrough: ``plan(ServeBatch) -> ServeResult``."""

    def _coerce(self, batch) -> ServeBatch:
        if batch is None:
            raise ValueError("ServeQ plans take a ServeBatch")
        return upload_batch(ServeBatch(*batch), self.engine.device)

    def run(self, q: ServeQ, batch) -> ServeResult:
        if batch is None:
            raise ValueError("ServeQ plans take a ServeBatch")
        batch = ServeBatch(*batch)
        uploaded = []  # the static path uploads once, whatever the growth

        def one(cap):
            view = self.engine.dynamic_view()
            if view is None:
                if not uploaded:
                    uploaded.append(self._coerce(batch))
                return self._call(uploaded[0], cap, q.unbounded)
            # sanitize on the host before the upload, merge after the fetch
            # against the ORIGINAL lane constants
            r = self._call(self._coerce(view.sanitize_batch(batch)), cap, q.unbounded)
            return view.merge_lanes(*batch, host_result(r, unbounded=q.unbounded))

        def fn(cap, _):
            t = obs.STATE.tracer
            if t is None:
                r = one(cap)
                self._overflow_guard(r)
                return r
            with t.span("plan.call", cat="plan", b=int(batch.op.shape[0]),
                        cap=cap, unbounded=q.unbounded):
                with t.span("plan.dispatch", cat="plan"):
                    r = one(cap)
                # the overflow check reads the result: the host waits here
                with t.span("plan.sync", cat="plan"):
                    self._overflow_guard(r)
            return r

        return self._grow(fn)

    def submit(self, q: ServeQ, batch) -> ServeResult:
        """Streamed dispatch: device ``ServeResult`` with NO host sync; the
        overflow guard and any cap growth are the caller's job, and the
        executor's cap never grows through this path.

        Dynamic stores: this is the STATIC lane only — the caller pins
        ``Engine.dynamic_view()``, sanitizes the batch before this call and
        merges the same view into the fetched result (the broker does)."""
        self.engine._check_epoch(self.epoch)
        t = obs.STATE.tracer
        if t is None:
            return self._call(self._coerce(batch), self.cap, q.unbounded)
        batch = self._coerce(batch)
        with t.span("plan.submit", cat="plan", b=int(batch.op.shape[0]),
                    cap=self.cap, unbounded=q.unbounded):
            return self._call(batch, self.cap, q.unbounded)

    def _u_width_of(self, unbounded: bool) -> int:
        eng, cfg = self.engine, self.cfg
        if not unbounded:
            return 0
        if cfg.use_pred_index and eng.store.pred_index is not None:
            return eng._u_width(cfg)
        if cfg.mesh is not None:
            raise ValueError("sharded unbounded-?P serving needs the SP/OP index")
        return max(eng.store.n_preds, 1)

    def _call(self, qb: ServeBatch, cap: int, unbounded: bool) -> ServeResult:
        eng, cfg = self.engine, self.cfg
        u_width = self._u_width_of(unbounded)
        with_index = u_width > 0 and cfg.use_pred_index and eng.store.pred_index is not None
        return eng._run_program(cfg, cap, qb, u_width=u_width, with_index=with_index)

    def cost_profile(self, q: ServeQ, batch=None) -> dict:
        """One call's geometry, kernel launches and (on the card) device ms
        at this plan's cap, for ``batch`` (default: 8 check lanes of id 0,
        as the JAX package profiles)."""
        eng, cfg = self.engine, self.cfg
        if batch is None:
            z = np.zeros(eng._pad_b(1, cfg), np.int32)
            batch = ServeBatch(z, z, z, z)
        qb = self._coerce(batch)
        u_width = self._u_width_of(q.unbounded)
        geometry = {
            "lanes": int((_host(qb.op) >= 0).sum()),
            "padded_lanes": int(qb.op.shape[0]),
            "cap": self.cap,
            "u_width": u_width,
            "unbounded": q.unbounded,
            "layout": cfg.pred_index_layout if u_width and cfg.use_pred_index else None,
            "device": str(eng.device),
            "sharded": cfg.mesh is not None,
            "mesh": None if cfg.mesh is None else cfg.mesh.shape,
        }
        return obs_cost.profile_call(
            lambda: self._call(qb, self.cap, q.unbounded), geometry, eng.device
        )


class Engine:
    """The query entry point over one store on one device.

    ``Engine.compile(query, config) -> Plan``; plans are cached on
    ``(shape_key(query), config)`` and the serve programs per geometry.
    """

    def __init__(self, store: K2TriplesStore | dyn.DynamicStore, *, device="cuda"):
        self.device = resolve_device(device)
        if isinstance(store, dyn.DynamicStore) and store.device != self.device:
            raise ValueError(
                f"a DynamicStore serves from its own device ({store.device}); "
                f"build its static store on {self.device}"
            )
        self.store = store if store.device == self.device else store.to(self.device)
        self._plan_cache: dict = {}
        self._programs: dict = {}
        # per (mesh, model axis): the static epoch's shards, and per (mesh,
        # layout) its index replicas, each beside the static store it was
        # cut from, so a compaction swap never meets old shards
        self._sharded: dict = {}
        self._stats = {"hits": 0, "misses": 0, "denied": 0}
        # the store epoch the caches were built at; a DynamicStore bumps it
        # at a compaction swap and ``compile`` then drops every executor
        self._built_epoch = self.store_epoch

    @property
    def store_epoch(self) -> int:
        """Compaction epoch of a dynamic store (0 for a static one)."""
        return getattr(self.store, "epoch", 0)

    def _check_epoch(self, epoch: int) -> None:
        cur = self.store_epoch
        if epoch != cur:
            raise StaleEpoch(
                f"plan compiled at store epoch {epoch}, store is now at "
                f"{cur} (compacted); recompile"
            )

    def dynamic_view(self):
        """The delta read view for this dispatch, or ``None`` when the
        store is static (or the delta is empty): the static fast path."""
        return dyn.view_of(self.store)

    def _static(self) -> K2TriplesStore:
        """The current static epoch (the store itself when static)."""
        return self.store.static if isinstance(self.store, dyn.DynamicStore) else self.store

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
        if cfg.mesh is not None:
            if cfg.mesh.lead != self.device:
                raise ValueError(
                    f"the mesh's lead device {cfg.mesh.lead} is not the engine's {self.device}"
                )
            cfg.mesh.grid()  # raises on a mesh without a model axis
        cur = self.store_epoch
        if self._built_epoch != cur:
            # after a compaction swap every cached executor serves the old
            # epoch: drop them all before compiling
            self._plan_cache.clear()
            self._programs.clear()
            self._sharded.clear()
            self._built_epoch = cur
        self._validate(q, cfg)
        key = (shape_key(q), cfg)
        t, m = obs.STATE.tracer, obs.STATE.metrics
        ex = self._plan_cache.get(key)
        if ex is None:
            if admit is not None and not admit(key):
                self._stats["denied"] += 1
                if m is not None:
                    m.counter("engine.plan_cache.denied").inc()
                if t is not None:
                    t.instant("engine.admission_denied", shape=str(key[0]))
                raise AdmissionError(f"plan-cache admission denied for {key[0]!r}")
            self._stats["misses"] += 1
            if m is not None:
                m.counter("engine.plan_cache.misses").inc()
            if t is not None:
                with t.span("engine.compile", cat="engine", shape=str(key[0]),
                            device=str(self.device), cap=cfg.cap, hit=False):
                    ex = self._build_executor(q, cfg)
            else:
                ex = self._build_executor(q, cfg)
            self._plan_cache[key] = ex
        else:
            self._stats["hits"] += 1
            if m is not None:
                m.counter("engine.plan_cache.hits").inc()
        return Plan(q, cfg, ex)

    def _validate(self, q, cfg: ExecConfig) -> None:
        if isinstance(q, TriplePatternQ):
            named = q.variables
            if len(named) != len(set(named)):
                raise ValueError(
                    "a variable repeated inside one pattern needs join "
                    f"semantics; wrap it in BgpQ: {q!r}"
                )
        # a mesh is never dropped in silence: only the serve-lane shapes are
        # sharded.  Pair enumeration and the dump (k2_range), the fused
        # re-binds of joins D-F and the BGP/SELECT planner's enumeration
        # steps run on the unsharded forest, so they refuse a mesh.
        if cfg.mesh is not None:
            if isinstance(q, TriplePatternQ) and q.bound in (
                (False, True, False), (False, False, False)
            ):
                raise ValueError(
                    "pair-enumeration/dump plans are not sharded; drop "
                    "ExecConfig.mesh for this shape"
                )
            if isinstance(q, JoinQ) and q.category in "DEF":
                raise ValueError(
                    f"join category {q.category} (fused scan->rebind) is "
                    "not sharded; drop ExecConfig.mesh"
                )
            if isinstance(q, (BgpQ, SelectQ)):
                raise ValueError(
                    "BGP/SELECT plans are not sharded (enumeration steps "
                    "run single-device); drop ExecConfig.mesh"
                )
        if (
            isinstance(q, ServeQ) and q.unbounded and cfg.u_width_quantile < 1.0
            and cfg.use_pred_index and self.store.pred_index is not None
        ):
            raise ValueError(
                "quantile-sized unbounded lanes need the pattern plans' sweep "
                "fallback; raw ServeQ plans require u_width_quantile=1.0 "
                "(use TriplePatternQ plans for quantile sizing)"
            )
        if isinstance(q, BgpQ):
            names = {v for tp in q.patterns for v in tp.variables}
            if any(v.startswith(algebra.ANON) for v in names):
                raise ValueError(
                    f"variable names starting with {algebra.ANON!r} are reserved "
                    "for anonymous (None) positions"
                )
            if not names and any(
                is_var(t) for tp in q.patterns for t in (tp.s, tp.p, tp.o)
            ):
                raise ValueError(
                    "a BGP whose variables are all anonymous has no "
                    "projectable columns; name at least one variable "
                    "(or use a TriplePatternQ check shape)"
                )
        if isinstance(q, SelectQ):
            blocks = (q.where,) + q.optional + q.union
            names = {v for blk in blocks for tp in blk for v in tp.variables}
            reserved = [v for v in names if v.startswith(algebra.INTERNAL)]
            if q.select:
                reserved += [v for v in q.select if v.startswith(algebra.INTERNAL)]
            if reserved:
                raise ValueError(
                    f"variable names starting with {algebra.INTERNAL!r} "
                    f"are reserved for internal columns: {reserved!r}"
                )
            if not names:
                raise ValueError(
                    "a SELECT whose variables are all anonymous has no "
                    "projectable columns; name at least one variable"
                )
            for ex in q.filter:  # raises TypeError on non-expressions
                algebra.expr_vars(ex)

    def _build_executor(self, q, cfg: ExecConfig):
        if isinstance(q, TriplePatternQ):
            return _PatternExec(self, cfg)
        if isinstance(q, JoinQ):
            return _JoinExec(self, cfg)
        if isinstance(q, BgpQ):
            return _BgpExec(self, cfg)
        if isinstance(q, SelectQ):
            return _SelectExec(self, cfg)
        if isinstance(q, ServeQ):
            return _ServeExec(self, cfg)
        raise TypeError(f"not a Query of this package: {q!r}")

    def _u_width(self, cfg: ExecConfig) -> int:
        """Unbounded-lane width: ``max_degree``, or at a quantile below 1
        ``predindex.quantile_u_width``, memoised per quantile (the pass
        walks the whole host CSR)."""
        bi = self.store.pred_index
        if cfg.u_width_quantile >= 1.0:
            return max(bi.meta.max_degree, 1)
        key = ("u_width", cfg.u_width_quantile)
        w = self._programs.get(key)
        if w is None:
            w = self._programs[key] = max(predindex.quantile_u_width(bi, cfg.u_width_quantile), 1)
        return w

    def _program(self, st: K2TriplesStore, cfg: ExecConfig, cap: int, u_width: int,
                 with_index: bool):
        """One cached serve program per geometry of the static store ``st``,
        shared by all executors (keyed by the metas' values, so a program
        never meets a forest of another geometry)."""
        pmeta = st.pred_index.select(cfg.pred_index_layout)[1] if with_index else None
        key = (cap, u_width, st.meta, pmeta, cfg.mesh)
        fn = self._programs.get(key)
        if fn is None:
            if cfg.mesh is None:
                fn = make_serve_step(st.meta, cap, pmeta=pmeta, u_width=u_width)
            else:
                fn = make_sharded_serve_step(st.meta, cfg.mesh, cap, pmeta=pmeta,
                                             u_width=u_width)
            self._programs[key] = fn
        return fn

    def _sharded_entry(self, st: K2TriplesStore, key, build):
        """The cached ``build()`` for ``key``, rebuilt when it was cut from
        another static epoch than ``st``."""
        entry = self._sharded.get(key)
        if entry is None or entry[0] is not st:
            entry = self._sharded[key] = (st, build())
        return entry[1]

    def _shards(self, st: K2TriplesStore, cfg: ExecConfig):
        mp = cfg.mesh.shape[MODEL_AXIS]
        return self._sharded_entry(
            st, ("forest", cfg.mesh),
            lambda: shard_forest(pad_preds(st.forest, mp), cfg.mesh),
        )

    def _index_replicas(self, st: K2TriplesStore, cfg: ExecConfig):
        return self._sharded_entry(
            st, ("index", cfg.mesh, cfg.pred_index_layout),
            lambda: replicate_index(st.pred_index.select(cfg.pred_index_layout)[0], cfg.mesh),
        )

    def _pad_b(self, b: int, cfg: ExecConfig | None = None) -> int:
        """pow2 bucket (>= 8) for a batch of ``b`` lanes; under a mesh also
        a multiple of the data slices."""
        n = 8
        while n < b:
            n <<= 1
        if cfg is not None and cfg.mesh is not None:
            d = len(cfg.mesh.grid())
            n = -(-max(n, d) // d) * d
        return n

    def _run_program(self, cfg: ExecConfig, cap: int, qb: ServeBatch, *,
                     u_width: int = 0, with_index: bool = False) -> ServeResult:
        """One uploaded batch through the cached program of its geometry;
        on the card, ``ready`` records the stream after its last launch."""
        st = self._static()  # one epoch for the program, forest and index
        fn = self._program(st, cfg, cap, u_width, with_index)
        if cfg.mesh is not None:
            if u_width > 0 and not with_index:
                raise ValueError("sharded unbounded-?P serving needs the SP/OP index")
            r = fn(self._shards(st, cfg), qb,
                   self._index_replicas(st, cfg) if with_index else None)
        elif with_index:
            r = fn(st.forest, qb, st.pred_index.select(cfg.pred_index_layout)[0])
        elif u_width > 0:
            r = fn(st.forest, qb, None)
        else:
            r = fn(st.forest, qb)
        # recorded after the model-axis reduce: the fetch waits on all of it
        if self.device.type == "cuda":
            r.ready = torch.cuda.Event()
            r.ready.record(torch.cuda.current_stream(self.device))
        return r

    def _run_lanes(
        self, cfg: ExecConfig, cap: int, ops_a, s, p, o,
        *, u_width: int = 0, with_index: bool = False,
    ) -> ServeResult:
        """Run host serve-IR lanes through the cached program of their
        geometry: padded to a pow2 bucket with dead (op = -1) lanes, which
        the serve step zeroes, and sliced back to the ``b`` real lanes.
        Every pattern plan, join side list and BGP/SELECT step shares this
        dispatch."""
        b = int(np.shape(ops_a)[0])
        n = self._pad_b(b, cfg)
        t = obs.STATE.tracer
        if t is None:
            return self._run_lanes_inner(cfg, cap, ops_a, s, p, o, b, n, u_width, with_index)
        with t.span("plan.lanes", cat="plan", b=b, padded=n, cap=cap, u_width=u_width):
            return self._run_lanes_inner(cfg, cap, ops_a, s, p, o, b, n, u_width, with_index)

    def _run_lanes_inner(self, cfg, cap, ops_a, s, p, o, b, n, u_width, with_index):

        def pad(a, fill):
            out = np.full(n, fill, np.int32)
            out[:b] = np.asarray(a, np.int64)
            return out

        view = self.dynamic_view()
        qb = ServeBatch(pad(ops_a, -1), pad(s, 0), pad(p, 0), pad(o, 0))
        if view is not None:
            qb = view.sanitize_batch(qb)  # on the host, before the upload
        r = self._run_program(cfg, cap, upload_batch(qb, self.device),
                              u_width=u_width, with_index=with_index)
        r = ServeResult(**{name: getattr(r, name)[:b] for name in RESULT_FIELDS},
                        ready=r.ready)
        if view is not None:
            # the delta lane: subtract tombstones, union inserts and widen
            # caps on the host, so the delta never causes a false overflow
            r = view.merge_lanes(ops_a, s, p, o, host_result(r, unbounded=u_width > 0))
        return r

    def _lanes_runner(self, cfg: ExecConfig, cap: int):
        """Bound-pred serve-lane callable handed to the planner: dispatches
        CHECK/ROW/COL lanes and returns the fetched host ``ServeResult``
        (merged with the delta on a dynamic store)."""
        return lambda ops_a, s, p, o: host_result(
            self._run_lanes(cfg, cap, ops_a, s, p, o), unbounded=False
        )
