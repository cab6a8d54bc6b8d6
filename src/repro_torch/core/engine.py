"""Query engine, serve slice: ``Engine.compile(ServeQ, config) -> Plan`` over
one batched ``serve_step``.

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

from repro_torch.core import k2forest, predindex
from repro_torch.core.k2forest import K2Forest
from repro_torch.core.k2tree import K2Meta, compact
from repro_torch.core.k2triples import K2TriplesStore
from repro_torch.core.predindex import PredIndex, PredIndexMeta
from repro_torch.core.query import (
    AdmissionError, CapOverflow, ExecConfig, Plan, ServeQ, resolve_device,
    run_with_policy, shape_key,
)

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


def upload_batch(batch, device: torch.device) -> ServeBatch:
    """A ``ServeBatch`` of contiguous int32 tensors on ``device``.

    Host batches go up as one (4, B) copy from pinned memory that does not
    block the host.
    """
    if all(isinstance(a, torch.Tensor) and a.device == device for a in batch):
        return ServeBatch(*(a.to(torch.int32).contiguous() for a in batch))
    host = torch.from_numpy(np.stack([np.asarray(_host(a), dtype=np.int32) for a in batch]))
    if device.type == "cuda":
        host = host.pin_memory().to(device, non_blocking=True)
    return ServeBatch(*host.unbind(0))


class _ServeExec:
    """Raw serve-IR passthrough: ``plan(ServeBatch) -> ServeResult``.

    One per ``(shape_key, config)`` cache slot; holds the effective cap,
    grown in place by the :class:`CapPolicy` loop of ``Plan.__call__``.
    """

    def __init__(self, engine: "Engine", cfg: ExecConfig):
        self.engine = engine
        self.cfg = cfg
        self.cap = cfg.cap
        self.cap_y = cfg.cap_y

    def _coerce(self, batch) -> ServeBatch:
        if batch is None:
            raise ValueError("ServeQ plans take a ServeBatch")
        return upload_batch(ServeBatch(*batch), self.engine.device)

    def run(self, q: ServeQ, batch) -> ServeResult:
        batch = self._coerce(batch)

        def fn(cap, _):
            r = self._call(batch, cap, q.unbounded)
            if bool(r.overflow.any()):
                raise CapOverflow(
                    "result lane truncated at cap; CapPolicy(grow=True) doubles"
                )
            return r

        out, self.cap, self.cap_y = run_with_policy(
            self.cfg.cap_policy, self.cap, self.cap_y, fn
        )
        return out

    def submit(self, q: ServeQ, batch) -> ServeResult:
        """Streamed dispatch: device ``ServeResult`` with NO host sync; the
        overflow guard and any cap growth are the caller's job, and the
        executor's cap never grows through this path."""
        return self._call(self._coerce(batch), self.cap, q.unbounded)

    def _call(self, qb: ServeBatch, cap: int, unbounded: bool) -> ServeResult:
        eng, cfg = self.engine, self.cfg
        f = eng.forest
        if not unbounded:
            r = eng._program(cfg, cap, 0, False)(f, qb)
        else:
            bi = eng.store.pred_index if cfg.use_pred_index else None
            if bi is None:
                r = eng._program(cfg, cap, max(eng.store.n_preds, 1), False)(f, qb, None)
            else:
                r = eng._program(cfg, cap, eng._u_width(), True)(
                    f, qb, bi.select(cfg.pred_index_layout)[0]
                )
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
        key = (shape_key(q), cfg)
        ex = self._plan_cache.get(key)
        if ex is None:
            if admit is not None and not admit(key):
                self._stats["denied"] += 1
                raise AdmissionError(f"plan-cache admission denied for {key[0]!r}")
            self._stats["misses"] += 1
            ex = self._plan_cache[key] = _ServeExec(self, cfg)
        else:
            self._stats["hits"] += 1
        return Plan(q, cfg, ex)

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
