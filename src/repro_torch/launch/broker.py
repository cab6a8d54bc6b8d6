"""Streaming multi-tenant serve broker over compiled ``ServeQ`` plans (read path)
and SPARQL-shaped ``SelectQ`` queries.

Many tenants submit single queries as async streams; the broker coalesces
them into mixed-op ``ServeBatch``es under a deadline/size policy,
double-buffers host-side decode against device serve, and streams each
tenant's results back as its lanes decode.

    broker = ServeBroker(engine, ExecConfig(cap=512))
    async with broker:
        objs = await broker.submit("tenant-a", eng.OP_ROW, s=12, p=3)

Pipeline (one background task)::

    submit() ──▶ global FIFO ──▶ coalesce (deadline/size) ──▶ Plan.submit
                                                              (device, async)
         futures ◀── per-lane streamed decode ◀── host_result ◀─┘
                     (batch N decodes while batch N+1 runs on device)

* **The shared base plan never grows.**  Dispatch rides ``Plan.submit``, so
  one tenant's overflowing queries cannot widen the program every other
  tenant is served by.
* **Cap growth is per tenant and budgeted** (:class:`TenantPolicy`):
  overflowed lanes are retried on doubled-cap plans; a tenant past its
  budget gets :class:`~repro_torch.core.query.CapOverflow` on that query.
* **Plan-cache admission is quota'd**: retry plans charge the tenant's
  ``max_plans`` on cache misses only (:class:`AdmissionError` past it).
* **Back-pressure is shed-newest, fail-fast**: a submit over the tenant's
  ``queue_depth`` raises :class:`QueueFull`; nothing accepted is dropped.
* **Per-tenant FIFO**: a tenant with a retried lane has its later lanes in
  that batch held until the retry lands.
* **SELECTs ride beside the lanes**: ``submit_select`` shares the tenant's
  queue bound, growth budget and admission quota, and runs each query off
  the event loop through ``Engine.compile(SelectQ)``; ``stream`` takes lane
  tuples and ``SelectQ`` items mixed.
* **Writes (dynamic stores)**: over a :class:`~repro_torch.core.delta.
  DynamicStore`, ``submit_insert`` / ``submit_delete`` apply live mutations
  to its delta synchronously (an in-memory set op), budgeted per tenant by
  ``TenantPolicy.max_writes`` (:class:`WriteBudgetExhausted` past it; the
  budget refills at compaction).  Reads stay on the raw static lane:
  dispatch pins the delta view and sanitizes the batch on the host, and
  decode merges the SAME view off the event loop.  With a
  :class:`~repro_torch.core.compaction.CompactionPolicy`, a write that
  trips it starts a background compaction in a worker thread on the
  engine's device; the epoch swap is atomic, in-flight batches finish
  against the old epoch, and the base plan is rebuilt right after so the
  serve loop meets ``StaleEpoch`` at most once (it then refreshes and
  retries).  A failed compaction warns (``RuntimeWarning``) and counts in
  ``compaction_errors``; the broker keeps serving the old epoch.

``stats()`` reads an always-on ``MetricsRegistry`` of counters.  With
observability on (``repro_torch.obs``) the broker also records batch
occupancy, queue depth, queue wait and per-query latency histograms, and
once a batch has delivered, its timeline as retroactive spans: a
``broker.batch`` span over ``broker.coalesce`` / ``dispatch`` /
``inflight`` / ``fetch`` / ``decode_deliver`` on a ``batch-slot-*`` track,
each query's lifetime as async ``query`` events with its ``queue`` →
``dispatch`` → ``inflight`` → ``fetch`` → ``decode`` phases, a
``broker.compaction`` span around each background compaction and the
``broker.epoch`` gauge after its swap.
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import math
import time
import warnings

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import delta as dyn
from repro_torch.core import engine as eng
from repro_torch.core.compaction import CompactionPolicy, compact, needs_compaction
from repro_torch.core.query import (
    AdmissionError, CapOverflow, CapPolicy, ExecConfig, SelectQ, ServeQ,
    StaleEpoch,
)
from repro_torch.obs import LATENCY_MS_BUCKETS, MetricsRegistry

__all__ = [
    "CoalescePolicy", "TenantPolicy", "QueueFull", "ServeBroker",
    "WriteBudgetExhausted", "tail_percentile",
]


class QueueFull(RuntimeError):
    """Shed signal: the tenant's bounded queue is at ``queue_depth``; the
    request was NOT enqueued."""


class WriteBudgetExhausted(RuntimeError):
    """The tenant spent its ``TenantPolicy.max_writes`` budget; the write
    was NOT applied.  The budget counts writes resident in the delta and
    refills when a compaction folds the delta into a new static epoch."""


@dataclasses.dataclass(frozen=True)
class CoalescePolicy:
    """A batch dispatches when ``max_batch`` requests are pending OR the
    oldest pending request has waited ``max_delay_s``.  Batches are padded
    to ``max_batch`` with dead (op = -1) lanes so every dispatch has one
    geometry.  ``max_inflight`` bounds device batches awaiting decode; 2 is
    the double buffer."""

    max_batch: int = 256
    max_delay_s: float = 2e-3
    max_inflight: int = 2

    def __post_init__(self):
        if self.max_batch < 1 or self.max_inflight < 1:
            raise ValueError("max_batch and max_inflight must be >= 1")
        if self.max_delay_s < 0:
            raise ValueError("max_delay_s must be >= 0")


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant budgets: ``queue_depth`` accepted-but-unresolved requests,
    ``max_cap_doublings`` cap growth above the base cap, ``max_plans``
    plan-cache misses (one per distinct retry cap level), ``max_writes``
    inserts + deletes resident in the delta at once."""

    queue_depth: int = 1024
    max_cap_doublings: int = 4
    max_plans: int = 4
    max_writes: int = 4096

    def __post_init__(self):
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if self.max_cap_doublings < 0 or self.max_plans < 0:
            raise ValueError("budgets must be >= 0")
        if self.max_writes < 1:
            raise ValueError("max_writes must be >= 1")


def tail_percentile(samples, q: float) -> float | None:
    """``np.percentile`` guarded by sample count: ``None`` unless there are
    at least ``ceil(100 / (100 - q))`` samples (p99 needs 100, p50 needs 2)."""
    n = len(samples)
    if not 0 <= q < 100:
        raise ValueError(f"q must be in [0, 100), got {q}")
    need = max(1, math.ceil(100.0 / (100.0 - q)))
    if n < need:
        return None
    return float(np.percentile(np.asarray(samples), q))


# _Req.op marker for SELECT queries (serve-IR ops are >= 0, dead lanes
# -1): selects never ride the coalesced ServeBatch
OP_SELECT = -2


@dataclasses.dataclass
class _Req:
    tenant: str
    op: int
    s: int
    p: int
    o: int
    t_submit: float
    future: asyncio.Future
    seq: int = 0  # global submission sequence: the per-query trace id
    t_deliver: float = 0.0  # stamped at resolve/fail time


@dataclasses.dataclass
class _BatchMeta:
    """Timeline of one dispatched batch (``time.perf_counter`` seconds):
    coalesce ``[tc0, tc1]`` → encode+dispatch ``[td0, td1]`` → inflight →
    fetch ``[tf0, tf1]`` → decode/deliver.  Feeds the retroactive trace
    spans emitted once the batch has delivered."""

    bid: int
    n_padded: int
    tc0: float = 0.0
    tc1: float = 0.0
    td0: float = 0.0
    td1: float = 0.0
    tf0: float = 0.0
    tf1: float = 0.0


@dataclasses.dataclass
class _TenantState:
    name: str
    pending: int = 0  # accepted, not yet resolved
    shed: int = 0
    completed: int = 0
    failed: int = 0
    cap_level: int = 0  # highest doubling level this tenant reached
    plans_charged: int = 0  # plan-cache misses charged against max_plans
    cap_growth_events: int = 0
    admission_denials: int = 0
    inserts: int = 0
    deletes: int = 0
    writes_resident: int = 0  # writes in the live delta (budget state)
    lat_s: list = dataclasses.field(default_factory=list)


_COUNTERS = (
    "batches", "lanes", "flush_size", "flush_deadline", "flush_drain",
    "shed", "cap_growth_events", "admission_denials", "selects",
    "inserts", "deletes", "compactions", "compaction_ms", "compaction_errors",
)


class ServeBroker:
    """Async multi-tenant request broker over one ``Engine``.

    Runs on the engine's device (its config's ``device``).  ``unbounded=
    False`` leaves the ``u_*`` block out of the base plan.
    """

    def __init__(
        self,
        engine: eng.Engine,
        config: ExecConfig | None = None,
        *,
        unbounded: bool = True,
        coalesce: CoalescePolicy = CoalescePolicy(),
        tenant_policy: TenantPolicy = TenantPolicy(),
        compaction: CompactionPolicy | None = None,
    ):
        self.engine = engine
        self.compaction = compaction
        cfg = config or engine.default_config
        # growth is broker-managed (per tenant); the base plan never grows
        self.config = cfg.replace(cap_policy=CapPolicy(grow=False))
        self.coalesce = coalesce
        self.tenant_policy = tenant_policy
        self.unbounded = unbounded
        self._query = ServeQ(unbounded=unbounded)
        self.base_plan = engine.compile(self._query, self.config)
        # a pow2 bucket, and under a mesh a multiple of the data slices
        self._pad_to = engine._pad_b(coalesce.max_batch, self.config)

        self._queue: collections.deque[_Req] = collections.deque()
        self._inflight: collections.deque = collections.deque()
        self._tenants: dict[str, _TenantState] = {}
        self._wake: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self._draining = False
        self._running = False
        # always-on bookkeeping registry backing ``stats()``; the obs-layer
        # extras (histograms, spans) live in ``repro_torch.obs.STATE``
        self.metrics = MetricsRegistry()
        self._c = {name: self.metrics.counter(f"broker.{name}") for name in _COUNTERS}
        # SELECTs run off-loop (each is a host-planned multi-dispatch
        # pipeline, not a lane); the semaphore bounds their threads
        self._select_sem = asyncio.Semaphore(max(2, coalesce.max_inflight))
        self._select_tasks: set[asyncio.Task] = set()
        self._compaction_task: asyncio.Task | None = None
        self.last_compaction: dict | None = None  # its report and refresh ms
        self._queue_peak = 0
        self._seq = 0  # per-query trace ids
        self._bid = 0  # batch ids
        self._retry_cfgs: set[ExecConfig] = set()  # cap levels ever compiled

    # -- lifecycle ------------------------------------------------------

    async def __aenter__(self) -> "ServeBroker":
        await self.start()
        return self

    async def __aexit__(self, *exc):
        await self.aclose()

    async def start(self) -> None:
        if self._running:
            raise RuntimeError("broker already started")
        self._wake = asyncio.Event()
        self._draining = False
        self._running = True
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def aclose(self) -> None:
        """Drain: serve everything accepted, then stop the loop."""
        if not self._running:
            return
        self._draining = True
        self._wake.set()
        try:
            await self._task
            if self._select_tasks:  # selects accepted before the drain finish
                await asyncio.gather(*self._select_tasks)
            if self._compaction_task is not None and not self._compaction_task.done():
                await asyncio.gather(self._compaction_task, return_exceptions=True)
        finally:
            self._running = False

    # -- submission -----------------------------------------------------

    def submit_nowait(self, tenant: str, op: int, s: int = 0, p: int = 0,
                      o: int = 0) -> asyncio.Future:
        """Enqueue one query; the future resolves to its decoded answer
        (``engine.decode_lane``).  Raises :class:`QueueFull` at the tenant's
        ``queue_depth`` and ``RuntimeError`` when not accepting."""
        if not self._running or self._draining:
            raise RuntimeError("broker is not accepting requests")
        self._admit_request(tenant)
        fut = asyncio.get_running_loop().create_future()
        self._queue.append(
            _Req(tenant, int(op), int(s), int(p), int(o), time.perf_counter(), fut,
                 seq=self._next_seq())
        )
        self._queue_peak = max(self._queue_peak, len(self._queue))
        self._wake.set()
        return fut

    def _admit_request(self, tenant: str) -> None:
        """The shed policy: count the request against the tenant's queue
        bound, or raise :class:`QueueFull`."""
        st = self._tenant(tenant)
        if st.pending >= self.tenant_policy.queue_depth:
            st.shed += 1
            self._c["shed"].inc()
            raise QueueFull(
                f"tenant {tenant!r} at queue_depth="
                f"{self.tenant_policy.queue_depth}; shed-newest"
            )
        st.pending += 1

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq - 1

    async def submit(self, tenant: str, op: int, s: int = 0, p: int = 0,
                     o: int = 0):
        return await self.submit_nowait(tenant, op, s, p, o)

    # -- the write path -------------------------------------------------

    def submit_insert_nowait(self, tenant: str, s: int, p: int, o: int) -> None:
        """Insert one id triple into the dynamic store's delta.

        Applies synchronously and is visible to every batch dispatched after
        this call.  Raises ``TypeError`` unless the engine serves a
        :class:`~repro_torch.core.delta.DynamicStore`, and
        :class:`WriteBudgetExhausted` past the tenant's ``max_writes``; may
        start a background compaction when a ``CompactionPolicy`` is set.
        """
        self._write(tenant, s, p, o, insert=True)

    async def submit_insert(self, tenant: str, s: int, p: int, o: int) -> None:
        self.submit_insert_nowait(tenant, s, p, o)

    def submit_delete_nowait(self, tenant: str, s: int, p: int, o: int) -> None:
        """Delete one id triple (tombstone it in the delta); the contract of
        :meth:`submit_insert_nowait`."""
        self._write(tenant, s, p, o, insert=False)

    async def submit_delete(self, tenant: str, s: int, p: int, o: int) -> None:
        self.submit_delete_nowait(tenant, s, p, o)

    def _write(self, tenant: str, s: int, p: int, o: int, *, insert: bool):
        if not self._running or self._draining:
            raise RuntimeError("broker is not accepting requests")
        store = self.engine.store
        if not isinstance(store, dyn.DynamicStore):
            raise TypeError(
                "writes need a DynamicStore; wrap the static store in "
                "repro_torch.core.delta.DynamicStore"
            )
        st = self._tenant(tenant)
        if st.writes_resident >= self.tenant_policy.max_writes:
            raise WriteBudgetExhausted(
                f"tenant {tenant!r} has {st.writes_resident} writes resident "
                f"(max_writes={self.tenant_policy.max_writes}); budget "
                "refills at the next compaction"
            )
        if insert:
            store.insert(s, p, o)
            st.inserts += 1
            self._c["inserts"].inc()
        else:
            store.delete(s, p, o)
            st.deletes += 1
            self._c["deletes"].inc()
        st.writes_resident += 1
        self._maybe_compact()

    def _maybe_compact(self):
        """Start a background compaction when the policy says the delta is
        due and none is running.  Reads keep serving the old epoch until the
        swap lands."""
        if self.compaction is None or not needs_compaction(self.engine.store, self.compaction):
            return
        if self._compaction_task is not None and not self._compaction_task.done():
            return
        task = asyncio.get_running_loop().create_task(self._run_compaction())
        task.add_done_callback(self._observe_compaction)
        self._compaction_task = task

    def _observe_compaction(self, task: asyncio.Task) -> None:
        """Surface a failed background compaction when its task ends: count
        it and warn.  The broker keeps serving the old epoch; the delta
        grows until the next write re-triggers the policy."""
        if task.cancelled():
            return
        exc = task.exception()
        if exc is not None:
            self._c["compaction_errors"].inc()
            warnings.warn(f"background compaction failed: {exc!r}", RuntimeWarning,
                          stacklevel=2)

    async def _run_compaction(self):
        # writes resident now are the entries the pinned snapshot absorbs;
        # writes racing in during the rebuild stay resident in the rebased
        # delta and keep paying budget, so the refill below subtracts this
        # capture instead of zeroing (a write between the capture and the
        # pin is absorbed but stays counted: strict, never lenient)
        absorbed = {name: st.writes_resident for name, st in self._tenants.items()}
        with obs.span("broker.compaction", cat="broker"):
            rep = await asyncio.to_thread(self._compact_on_device)
            # the swap bumped the epoch: rebuild the base plan now, off the
            # loop, so dispatch meets StaleEpoch at most once
            t0 = time.perf_counter()
            await asyncio.to_thread(self._refresh_base_plan)
            refresh_ms = (time.perf_counter() - t0) * 1e3
        for name, st in self._tenants.items():
            st.writes_resident = max(0, st.writes_resident - absorbed.get(name, 0))
        self._c["compactions"].inc()
        self._c["compaction_ms"].inc(rep.duration_s * 1e3)
        self.last_compaction = dict(report=rep, refresh_ms=refresh_ms)
        m = obs.STATE.metrics
        if m is not None:
            m.gauge("broker.epoch").set(rep.epoch)
        return rep

    def _compact_on_device(self):
        """``compact`` in a worker thread, with the engine's card current
        (the rebuild allocates on the static store's own device)."""
        dev = self.engine.device
        if dev.type != "cuda":
            return compact(self.engine.store)
        with torch.cuda.device(dev):
            return compact(self.engine.store)

    def _refresh_base_plan(self):
        self.base_plan = self.engine.compile(self._query, self.config)
        self._retry_cfgs.clear()  # stale cap levels; recompiled on demand

    def _submit_dyn(self, plan, qb: eng.ServeBatch):
        """Static-lane dispatch for a possibly dynamic store: pin the view,
        sanitize the host batch (delta-only ids never reach the card),
        submit raw, and return ``(raw, view)`` — decode merges the SAME
        view.  ``view`` is None for static stores and empty deltas."""
        view = self.engine.dynamic_view()
        return plan.submit(qb if view is None else view.sanitize_batch(qb)), view

    def submit_select_nowait(self, tenant: str, q: SelectQ) -> asyncio.Future:
        """Enqueue one :class:`~repro_torch.core.query.SelectQ`; the future
        resolves to its columnar named bindings.

        Selects share the tenant's bounded queue and its latency and
        completion stats with the lane path, but never ride the coalesced
        ``ServeBatch``: each runs off the event loop through
        ``Engine.compile`` with cap growth budgeted by the tenant's
        ``max_cap_doublings`` and plan-cache misses charged to its
        ``max_plans`` (the ``("select",)`` executor is shared across
        tenants: a miss is charged to whoever compiles a cap level first).
        """
        if not self._running or self._draining:
            raise RuntimeError("broker is not accepting requests")
        self._admit_request(tenant)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        r = _Req(tenant, OP_SELECT, 0, 0, 0, time.perf_counter(), fut, seq=self._next_seq())
        self._c["selects"].inc()
        task = loop.create_task(self._run_select(r, q))
        self._select_tasks.add(task)
        task.add_done_callback(self._select_tasks.discard)
        return fut

    async def submit_select(self, tenant: str, q: SelectQ):
        return await self.submit_select_nowait(tenant, q)

    async def _run_select(self, r: _Req, q: SelectQ):
        async with self._select_sem:
            try:
                value = await asyncio.to_thread(self._select_call, r, q)
            except AdmissionError as e:
                self._tenants[r.tenant].admission_denials += 1
                self._c["admission_denials"].inc()
                self._fail(r, e)
            except Exception as e:  # lowering, validation, CapOverflow -> caller
                self._fail(r, e)
            else:
                self._resolve(r, value)

    def _select_call(self, r: _Req, q: SelectQ):
        """Blocking (off-loop) SELECT under the tenant's growth budget.  The
        engine puts every tensor on its own device, whatever the worker
        thread's current device."""
        st = self._tenants[r.tenant]
        # mesh=None: SELECT plans run single-device (the engine refuses a
        # sharded one); the base serve plan stays sharded
        cfg = self.config.replace(
            mesh=None,
            cap_policy=CapPolicy(grow=True, max_doublings=self.tenant_policy.max_cap_doublings),
        )
        with obs.span("broker.select", cat="broker", tenant=r.tenant, seq=r.seq):
            return self.engine.compile(q, cfg, admit=self._admit(st))()

    async def stream(self, tenant: str, queries):
        """Submit a tenant's stream of ``(op, s, p, o)`` lane tuples and/or
        :class:`~repro_torch.core.query.SelectQ` queries, yielding results
        in submission order while staying inside the tenant's queue bound."""
        window: collections.deque[asyncio.Future] = collections.deque()
        for item in queries:
            while window and window[0].done():
                yield await window.popleft()
            while (
                window
                and self._tenant(tenant).pending >= self.tenant_policy.queue_depth
            ):
                yield await window.popleft()
            if isinstance(item, SelectQ):
                window.append(self.submit_select_nowait(tenant, item))
            else:
                window.append(self.submit_nowait(tenant, *item))
        while window:
            yield await window.popleft()

    # -- the serve loop -------------------------------------------------

    async def _run(self):
        while True:
            if len(self._inflight) >= self.coalesce.max_inflight:
                await self._deliver(*self._inflight.popleft())
                continue
            reqs, tc0, tc1 = await self._collect(block=not self._inflight)
            if reqs:
                self._dispatch(reqs, tc0, tc1)
            elif self._inflight:
                await self._deliver(*self._inflight.popleft())
            elif self._draining and not self._queue:
                return

    async def _collect(self, *, block: bool):
        """Coalesce: returns ``(reqs, tc0, tc1)``, the batch and the
        perf-counter window the coalesce wait spanned."""
        pol = self.coalesce
        while not self._queue:
            if not block or self._draining:
                return [], 0.0, 0.0
            self._wake.clear()
            await self._wake.wait()
        tc0 = time.perf_counter()
        # the deadline of the OLDEST pending request governs the flush
        deadline = self._queue[0].t_submit + pol.max_delay_s
        while len(self._queue) < pol.max_batch and not self._draining:
            now = time.perf_counter()
            if now >= deadline:
                break
            self._wake.clear()
            try:
                await asyncio.wait_for(self._wake.wait(), deadline - now)
            except asyncio.TimeoutError:
                break
        if len(self._queue) >= pol.max_batch:
            self._c["flush_size"].inc()
        elif self._draining:
            self._c["flush_drain"].inc()
        else:
            self._c["flush_deadline"].inc()
        n = min(len(self._queue), pol.max_batch)
        return [self._queue.popleft() for _ in range(n)], tc0, time.perf_counter()

    def _dispatch(self, reqs: list[_Req], tc0: float = 0.0, tc1: float = 0.0):
        td0 = time.perf_counter()
        qb = self._encode(reqs, self._pad_to)
        # the view is pinned AT dispatch and decode merges the same one:
        # writes landing mid-flight wait for the next batch
        try:
            raw, view = self._submit_dyn(self.base_plan, qb)
        except StaleEpoch:  # a compaction swapped under the base plan
            self._refresh_base_plan()
            raw, view = self._submit_dyn(self.base_plan, qb)
        meta = _BatchMeta(
            bid=self._bid, n_padded=int(qb.op.shape[0]),
            tc0=tc0 or td0, tc1=tc1 or td0, td0=td0, td1=time.perf_counter(),
        )
        self._bid += 1
        self._inflight.append((raw, reqs, meta, qb, view))
        self._c["batches"].inc()
        self._c["lanes"].inc(len(reqs))
        m = obs.STATE.metrics
        if m is not None:
            m.histogram("broker.batch_occupancy").observe(len(reqs) / meta.n_padded)
            m.gauge("broker.queue_depth").set(len(self._queue))
            h = m.histogram("broker.queue_wait_ms", LATENCY_MS_BUCKETS)
            for r in reqs:
                h.observe((td0 - r.t_submit) * 1e3)

    def _encode(self, reqs: list[_Req], pad_to: int) -> eng.ServeBatch:
        n = max(pad_to, self.engine._pad_b(len(reqs), self.config))
        lanes = np.zeros((4, n), np.int32)
        lanes[0] = -1  # dead lanes: masked to zero output
        if reqs:  # an id outside int32 raises OverflowError, as in the JAX broker
            lanes[:, : len(reqs)] = eng.int32_lanes([(r.op, r.s, r.p, r.o) for r in reqs]).T
        return eng.ServeBatch(*lanes)

    # -- streamed decode + per-tenant growth ----------------------------

    async def _deliver(self, raw, reqs: list[_Req], meta: _BatchMeta,
                       qb: eng.ServeBatch, view):
        has_u = any(r.op in eng.UNBOUNDED_OPS for r in reqs)
        meta.tf0 = time.perf_counter()

        # the blocking fetch (and the delta merge of a dynamic store) runs
        # off-loop so submitters keep filling the next batch meanwhile
        def fetch():
            host = eng.host_result(raw, unbounded=has_u and self.unbounded)
            if view is not None:
                # against the ORIGINAL lane constants: lanes masked off the
                # card get their delta-only answers here
                host = view.merge_lanes(*qb, host)
            return host

        host = await asyncio.to_thread(fetch)
        meta.tf1 = time.perf_counter()
        retry_tenants = {
            reqs[i].tenant for i in np.nonzero(host.overflow[: len(reqs)])[0]
        }
        for i, r in enumerate(reqs):
            if r.tenant not in retry_tenants:
                self._resolve(r, eng.decode_lane(r.op, host, i))
        for tenant in sorted(retry_tenants):
            segment = [(i, r) for i, r in enumerate(reqs) if r.tenant == tenant]
            await self._retry_tenant(tenant, segment, host)
        if obs.STATE.tracer is not None:
            self._trace_batch(reqs, meta)

    def _trace_batch(self, reqs: list[_Req], meta: _BatchMeta):
        """Emit the batch's retroactive spans now that every timestamp of
        its lifetime is known.

        Batch stages land as complete spans on ``batch-slot-*`` tracks
        (slot = ``bid`` mod ``2 * max_inflight``: the inflight bound
        guarantees a slot's previous batch has delivered before reuse, so
        spans of one track never overlap).  Each query's lifetime lands as
        async events keyed by its ``seq``: queue → dispatch → inflight →
        fetch → decode under one ``query`` span.
        """
        t = obs.STATE.tracer
        ns = _ns
        t_end = time.perf_counter()
        slot = f"batch-slot-{meta.bid % (2 * self.coalesce.max_inflight)}"
        t.add("broker.batch", ns(meta.tc0), ns(t_end), tid=slot, cat="broker",
              bid=meta.bid, lanes=len(reqs), padded=meta.n_padded,
              occupancy=round(len(reqs) / meta.n_padded, 4))
        for name, a, b in (
            ("broker.coalesce", meta.tc0, meta.tc1),
            ("broker.dispatch", meta.td0, meta.td1),
            ("broker.inflight", meta.td1, meta.tf0),
            ("broker.fetch", meta.tf0, meta.tf1),
            ("broker.decode_deliver", meta.tf1, t_end),
        ):
            t.add(name, ns(a), ns(b), tid=slot, cat="broker", bid=meta.bid)
        for i, r in enumerate(reqs):
            td = r.t_deliver or t_end
            t.add_async("query", r.seq, ns(r.t_submit), ns(td),
                        tenant=r.tenant, op=r.op, lane=i, bid=meta.bid)
            for name, a, b in (
                ("queue", r.t_submit, meta.td0),
                ("dispatch", meta.td0, meta.td1),
                ("inflight", meta.td1, meta.tf0),
                ("fetch", meta.tf0, meta.tf1),
                ("decode", meta.tf1, td),
            ):
                t.add_async(name, r.seq, ns(a), ns(min(b, td)))

    def _resolve(self, r: _Req, value):
        st = self._tenants[r.tenant]
        st.pending -= 1
        st.completed += 1
        r.t_deliver = time.perf_counter()
        lat = r.t_deliver - r.t_submit
        st.lat_s.append(lat)
        m = obs.STATE.metrics
        if m is not None:
            m.histogram("broker.query_latency_ms", LATENCY_MS_BUCKETS).observe(lat * 1e3)
        if r.op == OP_SELECT and obs.STATE.tracer is not None:
            self._trace_select(r)
        if not r.future.cancelled():
            r.future.set_result(value)

    def _fail(self, r: _Req, exc: BaseException):
        st = self._tenants[r.tenant]
        st.pending -= 1
        st.failed += 1
        r.t_deliver = time.perf_counter()
        if r.op == OP_SELECT and obs.STATE.tracer is not None:
            self._trace_select(r)
        if not r.future.cancelled():
            r.future.set_exception(exc)

    def _trace_select(self, r: _Req):
        """A SELECT's lifetime as one async ``query`` event keyed by its
        ``seq`` (its planner and dispatch spans sit on the worker's track)."""
        obs.STATE.tracer.add_async("query", r.seq, _ns(r.t_submit), _ns(r.t_deliver),
                                   tenant=r.tenant, op=r.op, select=True)

    async def _retry_tenant(self, tenant, segment, host):
        """Re-run a tenant's overflowed lanes on doubled-cap plans, then
        release its held segment in submission order."""
        grow = [(i, r) for (i, r) in segment if bool(host.overflow[i])]
        try:
            done = await asyncio.to_thread(
                self._grow_and_run, tenant, [r for (_, r) in grow]
            )
            regrown, err = dict(zip((i for i, _ in grow), done)), None
        except (CapOverflow, AdmissionError) as e:
            regrown, err = {}, e
        for i, r in segment:
            if i in regrown:
                self._resolve(r, regrown[i])
            elif err is not None and bool(host.overflow[i]):
                self._fail(r, err)
            else:
                self._resolve(r, eng.decode_lane(r.op, host, i))

    def _grow_and_run(self, tenant: str, rs: list[_Req]):
        """Blocking (off-loop) escalation: double the cap from the tenant's
        remembered level until the lanes fit or the budget runs out."""
        st = self._tenants[tenant]
        pol = self.tenant_policy
        level = max(st.cap_level, 1)
        while True:
            if level > pol.max_cap_doublings:
                raise CapOverflow(
                    f"tenant {tenant!r} exhausted its cap budget "
                    f"(max_cap_doublings={pol.max_cap_doublings})"
                )
            cfg = self.config.replace(
                cap=self.config.cap << level, cap_y=self.config.cap_y << level
            )
            try:
                plan = self.engine.compile(self._query, cfg, admit=self._admit(st))
            except AdmissionError:
                st.admission_denials += 1
                self._c["admission_denials"].inc()
                raise
            st.cap_growth_events += 1
            self._c["cap_growth_events"].inc()
            st.cap_level = max(st.cap_level, level)
            self._retry_cfgs.add(cfg)
            with obs.span("broker.retry", cat="broker", tenant=tenant,
                          level=level, cap=cfg.cap, lanes=len(rs)):
                qb = self._encode(rs, 0)
                try:
                    raw, view = self._submit_dyn(plan, qb)
                except StaleEpoch:  # a compaction swapped mid-retry
                    plan = self.engine.compile(self._query, cfg, admit=self._admit(st))
                    raw, view = self._submit_dyn(plan, qb)
                host = eng.host_result(
                    raw, unbounded=any(r.op in eng.UNBOUNDED_OPS for r in rs),
                )
                if view is not None:
                    host = view.merge_lanes(*qb, host)
            if not host.overflow[: len(rs)].any():
                return [eng.decode_lane(r.op, host, i) for i, r in enumerate(rs)]
            level += 1

    def _admit(self, st: _TenantState):
        """Charge plan-cache MISSES against ``max_plans``."""

        def admit(_key):
            if st.plans_charged >= self.tenant_policy.max_plans:
                return False
            st.plans_charged += 1
            return True

        return admit

    def _tenant(self, name: str) -> _TenantState:
        st = self._tenants.get(name)
        if st is None:
            st = self._tenants[name] = _TenantState(name)
        return st

    # -- stats ----------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero every counter ``stats()`` reports (the benchmark warmup
        boundary).  Budget state (``cap_level``, ``plans_charged``,
        ``writes_resident``) stays, and ``delta_triples`` / ``tombstones``
        are live gauges of the store."""
        self.metrics.reset()
        self._queue_peak = 0
        for st in self._tenants.values():
            st.lat_s.clear()
            st.completed = st.failed = st.shed = 0
            st.cap_growth_events = st.admission_denials = 0
            st.inserts = st.deletes = 0

    def stats(self) -> dict:
        """Structured serving stats (JSON-ready), since ``reset_stats``;
        ``delta_triples`` / ``tombstones`` are live store gauges (0 for a
        static store)."""
        all_lat = [t for st in self._tenants.values() for t in st.lat_s]
        counts = {name: c.value for name, c in self._c.items()}
        batches = counts["batches"]
        store = self.engine.store
        d = store.delta if isinstance(store, dyn.DynamicStore) else None
        return {
            **counts,
            "delta_triples": d.n_inserts if d is not None else 0,
            "tombstones": d.n_tombstones if d is not None else 0,
            "coalesce_factor": counts["lanes"] / batches if batches else 0.0,
            "queue_depth": len(self._queue),
            "queue_peak": self._queue_peak,
            "queries": len(all_lat),
            "p50_ms": _ms(tail_percentile(all_lat, 50)),
            "p99_ms": _ms(tail_percentile(all_lat, 99)),
            "tenants": {
                name: {
                    "queries": st.completed,
                    "failed": st.failed,
                    "shed": st.shed,
                    "pending": st.pending,
                    "cap_level": st.cap_level,
                    "plans_charged": st.plans_charged,
                    "cap_growth_events": st.cap_growth_events,
                    "inserts": st.inserts,
                    "deletes": st.deletes,
                    "writes_resident": st.writes_resident,
                    "p50_ms": _ms(tail_percentile(st.lat_s, 50)),
                    "p99_ms": _ms(tail_percentile(st.lat_s, 99)),
                }
                for name, st in sorted(self._tenants.items())
            },
        }


    def cost_profiles(self) -> dict:
        """Cost profiles of every serve program this broker has dispatched
        through: the base plan at its dispatch geometry, then each
        doubled-cap retry level a tenant compiled (plan-cache hits:
        profiling never charges admission quotas)."""
        out = {"base": self.base_plan.cost_profile(self._encode([], self._pad_to))}
        for cfg in sorted(self._retry_cfgs, key=lambda c: c.cap):
            plan = self.engine.compile(self._query, cfg)
            out[f"retry_cap_{cfg.cap}"] = plan.cost_profile(self._encode([], 0))
        return out


def _ns(sec: float) -> int:
    """``time.perf_counter`` seconds as the tracer's nanoseconds."""
    return int(sec * 1e9)


def _ms(v: float | None) -> float | None:
    return None if v is None else v * 1e3
