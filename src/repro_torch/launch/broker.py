"""Streaming multi-tenant serve broker over compiled ``ServeQ`` plans (read path).

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
"""

from __future__ import annotations

import asyncio
import collections
import dataclasses
import math
import time

import numpy as np

from repro_torch.core import engine as eng
from repro_torch.core.query import (
    AdmissionError, CapOverflow, CapPolicy, ExecConfig, ServeQ,
)

__all__ = [
    "CoalescePolicy", "TenantPolicy", "QueueFull", "ServeBroker",
    "tail_percentile",
]


class QueueFull(RuntimeError):
    """Shed signal: the tenant's bounded queue is at ``queue_depth``; the
    request was NOT enqueued."""


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
    plan-cache misses (one per distinct retry cap level)."""

    queue_depth: int = 1024
    max_cap_doublings: int = 4
    max_plans: int = 4

    def __post_init__(self):
        if self.queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        if self.max_cap_doublings < 0 or self.max_plans < 0:
            raise ValueError("budgets must be >= 0")


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


@dataclasses.dataclass
class _Req:
    tenant: str
    op: int
    s: int
    p: int
    o: int
    t_submit: float
    future: asyncio.Future


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
    lat_s: list = dataclasses.field(default_factory=list)


_COUNTERS = (
    "batches", "lanes", "flush_size", "flush_deadline", "flush_drain",
    "shed", "cap_growth_events", "admission_denials",
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
    ):
        self.engine = engine
        cfg = config or engine.default_config
        # growth is broker-managed (per tenant); the base plan never grows
        self.config = cfg.replace(cap_policy=CapPolicy(grow=False))
        self.coalesce = coalesce
        self.tenant_policy = tenant_policy
        self.unbounded = unbounded
        self._query = ServeQ(unbounded=unbounded)
        self.base_plan = engine.compile(self._query, self.config)
        self._pad_to = engine._pad_b(coalesce.max_batch)

        self._queue: collections.deque[_Req] = collections.deque()
        self._inflight: collections.deque = collections.deque()
        self._tenants: dict[str, _TenantState] = {}
        self._wake: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self._draining = False
        self._running = False
        self._c = dict.fromkeys(_COUNTERS, 0)
        self._queue_peak = 0

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
        st = self._tenant(tenant)
        if st.pending >= self.tenant_policy.queue_depth:
            st.shed += 1
            self._c["shed"] += 1
            raise QueueFull(
                f"tenant {tenant!r} at queue_depth="
                f"{self.tenant_policy.queue_depth}; shed-newest"
            )
        st.pending += 1
        fut = asyncio.get_running_loop().create_future()
        self._queue.append(
            _Req(tenant, int(op), int(s), int(p), int(o), time.perf_counter(), fut)
        )
        self._queue_peak = max(self._queue_peak, len(self._queue))
        self._wake.set()
        return fut

    async def submit(self, tenant: str, op: int, s: int = 0, p: int = 0,
                     o: int = 0):
        return await self.submit_nowait(tenant, op, s, p, o)

    async def stream(self, tenant: str, queries):
        """Submit a tenant's ``(op, s, p, o)`` stream, yielding results in
        submission order while staying inside the tenant's queue bound."""
        window: collections.deque[asyncio.Future] = collections.deque()
        for item in queries:
            while window and window[0].done():
                yield await window.popleft()
            while (
                window
                and self._tenant(tenant).pending >= self.tenant_policy.queue_depth
            ):
                yield await window.popleft()
            window.append(self.submit_nowait(tenant, *item))
        while window:
            yield await window.popleft()

    # -- the serve loop -------------------------------------------------

    async def _run(self):
        while True:
            if len(self._inflight) >= self.coalesce.max_inflight:
                await self._deliver(*self._inflight.popleft())
                continue
            reqs = await self._collect(block=not self._inflight)
            if reqs:
                self._dispatch(reqs)
            elif self._inflight:
                await self._deliver(*self._inflight.popleft())
            elif self._draining and not self._queue:
                return

    async def _collect(self, *, block: bool) -> list[_Req]:
        pol = self.coalesce
        while not self._queue:
            if not block or self._draining:
                return []
            self._wake.clear()
            await self._wake.wait()
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
            self._c["flush_size"] += 1
        elif self._draining:
            self._c["flush_drain"] += 1
        else:
            self._c["flush_deadline"] += 1
        n = min(len(self._queue), pol.max_batch)
        return [self._queue.popleft() for _ in range(n)]

    def _dispatch(self, reqs: list[_Req]):
        raw = self.base_plan.submit(self._encode(reqs, self._pad_to))
        self._inflight.append((raw, reqs))
        self._c["batches"] += 1
        self._c["lanes"] += len(reqs)

    def _encode(self, reqs: list[_Req], pad_to: int) -> eng.ServeBatch:
        n = max(pad_to, self.engine._pad_b(len(reqs)))
        lanes = np.zeros((4, n), np.int32)
        lanes[0] = -1  # dead lanes: masked to zero output
        if reqs:  # an id outside int32 raises OverflowError, as in the JAX broker
            lanes[:, : len(reqs)] = eng.int32_lanes([(r.op, r.s, r.p, r.o) for r in reqs]).T
        return eng.ServeBatch(*lanes)

    # -- streamed decode + per-tenant growth ----------------------------

    async def _deliver(self, raw, reqs: list[_Req]):
        has_u = any(r.op in eng.UNBOUNDED_OPS for r in reqs)
        # the blocking fetch runs off-loop so submitters keep filling the
        # next batch while this one decodes
        host = await asyncio.to_thread(
            eng.host_result, raw, unbounded=has_u and self.unbounded
        )
        retry_tenants = {
            reqs[i].tenant for i in np.nonzero(host.overflow[: len(reqs)])[0]
        }
        for i, r in enumerate(reqs):
            if r.tenant not in retry_tenants:
                self._resolve(r, eng.decode_lane(r.op, host, i))
        for tenant in sorted(retry_tenants):
            segment = [(i, r) for i, r in enumerate(reqs) if r.tenant == tenant]
            await self._retry_tenant(tenant, segment, host)

    def _resolve(self, r: _Req, value):
        st = self._tenants[r.tenant]
        st.pending -= 1
        st.completed += 1
        st.lat_s.append(time.perf_counter() - r.t_submit)
        if not r.future.cancelled():
            r.future.set_result(value)

    def _fail(self, r: _Req, exc: BaseException):
        st = self._tenants[r.tenant]
        st.pending -= 1
        st.failed += 1
        if not r.future.cancelled():
            r.future.set_exception(exc)

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
                self._c["admission_denials"] += 1
                raise
            st.cap_growth_events += 1
            self._c["cap_growth_events"] += 1
            st.cap_level = max(st.cap_level, level)
            host = eng.host_result(
                plan.submit(self._encode(rs, 0)),
                unbounded=any(r.op in eng.UNBOUNDED_OPS for r in rs),
            )
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
        boundary).  Budget state (``cap_level``, ``plans_charged``) stays."""
        self._c = dict.fromkeys(_COUNTERS, 0)
        self._queue_peak = 0
        for st in self._tenants.values():
            st.lat_s.clear()
            st.completed = st.failed = st.shed = 0
            st.cap_growth_events = st.admission_denials = 0

    def stats(self) -> dict:
        """Structured serving stats (JSON-ready), since ``reset_stats``."""
        all_lat = [t for st in self._tenants.values() for t in st.lat_s]
        batches = self._c["batches"]
        return {
            **self._c,
            "coalesce_factor": self._c["lanes"] / batches if batches else 0.0,
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
                    "p50_ms": _ms(tail_percentile(st.lat_s, 50)),
                    "p99_ms": _ms(tail_percentile(st.lat_s, 99)),
                }
                for name, st in sorted(self._tenants.items())
            },
        }


def _ms(v: float | None) -> float | None:
    return None if v is None else v * 1e3
