"""The compiled-plan query API: ``Query`` → ``Engine.compile(ExecConfig)`` → ``Plan``.

This module is the one place execution knobs enter the system.  A
:class:`ExecConfig` is a frozen, hashable dataclass that keys the plan and
program caches; it resolves without reading the environment.

Query kinds: ``TriplePatternQ(s, p, o)`` (any of the paper's eight triple
patterns; ints bind a position, ``"?x"`` / ``None`` free it),
``JoinQ(category, vpos1, vpos2, p1, c1, p2, c2)`` (join categories A–F),
``BgpQ(patterns)`` (a basic graph pattern), ``SelectQ(...)`` (a
SPARQL-shaped SELECT with OPTIONAL, UNION, FILTER, ORDER BY and LIMIT)
and ``ServeQ(unbounded)`` (the raw serve-IR passthrough).  ``ObsConfig``
holds the knobs of ``repro_torch.obs.enable``.

Cap policy: fixed result capacities make every batch one set of kernel
launches, and truncation is never silent.  On overflow ``Plan.__call__``
re-runs at doubled cap (:class:`CapPolicy`); ``Plan.submit`` — the broker's
streaming hook — never grows and leaves the overflow bits to its caller.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

Term = Any  # int (bound 1-based id) | str "?name" | None (anonymous variable)

PRED_INDEX_LAYOUTS = ("dac", "fixed")


def is_var(t: Term) -> bool:
    """Variables are ``None`` (anonymous) or ``"?name"`` strings."""
    return t is None or isinstance(t, str)


class CapOverflow(RuntimeError):
    """A fixed-capacity result buffer truncated and the policy forbids (or
    exhausted) growth."""


class AdmissionError(RuntimeError):
    """Plan-cache admission denied: the ``admit`` callback of
    ``Engine.compile`` vetoed a cache miss."""


class StaleEpoch(RuntimeError):
    """A compiled plan outlived a compaction swap of its dynamic store.

    Executors pin the store epoch they were compiled against; running one
    after ``DynamicStore.swap`` would silently serve dropped triples from
    the old forest, so the engine raises this instead.  ``Plan.__call__``
    recompiles transparently; ``Plan.submit`` (the raw device path) lets it
    propagate so the broker can refresh its base plan."""


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; CUDA without a card raises.

    A bare ``"cuda"`` resolves to the current card, so two spellings of one
    card compare equal.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but no CUDA card is available; "
                "pass device='cpu' explicitly to run the plain versions"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (want 'cuda' or 'cpu')")
    return dev


@dataclasses.dataclass(frozen=True)
class CapPolicy:
    """``grow=True``: re-run at doubled cap, at most ``max_doublings``
    times.  ``grow=False``: raise :class:`CapOverflow` immediately."""

    grow: bool = True
    max_doublings: int = 6


@dataclasses.dataclass(frozen=True)
class ExecConfig:
    """Frozen, hashable execution config — the only way knobs reach a plan.

    ``cap`` / ``cap_y``
        Result capacities: ``cap`` for scan, side-list and X lanes,
        ``cap_y`` for the re-bind (Y) lanes of join categories D–F; both
        double together under the cap policy.
    ``cap_policy``
        Overflow handling; see :class:`CapPolicy`.
    ``use_pred_index``
        Serve unbounded-``?P`` lanes through the SP/OP index when the store
        carries one; ``False`` forces the all-preds sweep.
    ``u_width_quantile``
        Sizes the unbounded candidate lane at this quantile of the
        per-entity predicate-degree distribution (per axis, then the
        larger: ``predindex.quantile_u_width``) instead of ``max_degree``.
        Pattern plans route the entities whose list exceeds the lane to
        the all-preds sweep, so answers stay exact; raw ``ServeQ`` plans
        refuse a quantile below 1.  ``1.0`` = ``max_degree``.
    ``pred_index_layout``
        On-device layout of the SP/OP index: "dac" (default) or "fixed"
        (byte-packed); results are identical across layouts.
    ``device``
        The device plans run on; must be the engine's.
    ``mesh``
        With a ``launch.mesh.Mesh``, serve-lane plans run the sharded
        serve step: the forest split by predicate over its ``model`` axis,
        the batch over every other axis.  The mesh's lead device must be
        ``device``.
    """

    cap: int = 4096
    cap_y: int = 256
    cap_policy: CapPolicy = CapPolicy()
    use_pred_index: bool = True
    u_width_quantile: float = 1.0
    pred_index_layout: str = "dac"
    device: str = "cuda"
    mesh: Any = None  # launch.mesh.Mesh | None (hashable)

    def __post_init__(self):
        if not (0.0 < self.u_width_quantile <= 1.0):
            raise ValueError(
                f"u_width_quantile must be in (0, 1], got {self.u_width_quantile}"
            )
        if self.cap < 1 or self.cap_y < 1:
            raise ValueError("cap and cap_y must be >= 1")
        if self.pred_index_layout not in PRED_INDEX_LAYOUTS:
            raise ValueError(
                f"unknown pred_index_layout {self.pred_index_layout!r} "
                f"(want one of {PRED_INDEX_LAYOUTS})"
            )

    def replace(self, **kw) -> "ExecConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Frozen observability config — the knobs behind ``repro_torch.obs.enable``.

    ``trace``
        Record host-side spans into a ring-buffered tracer (exported as
        Chrome ``trace_event`` JSON, loadable in Perfetto).
    ``metrics``
        Record timing histograms / gauges into the global
        ``repro_torch.obs`` metrics registry.  (The broker's own bookkeeping
        registry backing ``ServeBroker.stats()`` is always on; this knob
        governs only the obs-layer extras.)
    ``trace_capacity``
        Ring size in spans; when full, the OLDEST spans are dropped and
        counted — a long run degrades to a suffix window, never to
        back-pressure.
    ``device_annotations``
        Bridge live spans into ``torch.profiler.record_function`` so a
        torch profile captured around the same run carries the same span
        names.
    """

    trace: bool = True
    metrics: bool = True
    trace_capacity: int = 1 << 16
    device_annotations: bool = False

    def __post_init__(self):
        if self.trace_capacity < 1:
            raise ValueError("trace_capacity must be >= 1")

    def replace(self, **kw) -> "ObsConfig":
        return dataclasses.replace(self, **kw)


def run_with_policy(policy: CapPolicy, cap: int, cap_y: int, fn):
    """Run ``fn(cap, cap_y)`` under the cap policy; on :class:`CapOverflow`
    both caps double and ``fn`` re-runs.  Returns ``(result, cap, cap_y)``."""
    doublings = 0
    while True:
        try:
            return fn(cap, cap_y), cap, cap_y
        except CapOverflow:
            if not policy.grow or doublings >= policy.max_doublings:
                raise
            doublings += 1
            cap *= 2
            cap_y *= 2


@dataclasses.dataclass(frozen=True)
class TriplePatternQ:
    """One triple pattern: ints bind a position, ``"?x"``/``None`` free it."""

    s: Term = None
    p: Term = None
    o: Term = None

    @property
    def bound(self) -> tuple[bool, bool, bool]:
        return (not is_var(self.s), not is_var(self.p), not is_var(self.o))

    @property
    def variables(self) -> tuple[str, ...]:
        return tuple(t for t in (self.s, self.p, self.o) if isinstance(t, str))


JOIN_CATEGORIES = "ABCDEF"
# which of (p1, c1, p2, c2) each category requires (vpos1/vpos2 always)
_JOIN_FIELDS = {
    "A": ("p1", "c1", "p2", "c2"),
    "B": ("p1", "c1", "c2"),
    "C": ("c1", "c2"),
    "D": ("p1", "c1", "p2"),
    "E": ("p1", "c1"),
    "F": ("c1",),
}


@dataclasses.dataclass(frozen=True)
class JoinQ:
    """A paper join category A–F (two patterns sharing variable ?X).

    ``vpos1``/``vpos2`` name the position ("s"/"o") of ?X in each pattern;
    ``p*``/``c*`` are the bound predicate / non-join constant of each side
    (which ones are required depends on the category: ``_JOIN_FIELDS``).
    """

    category: str
    vpos1: str
    vpos2: str
    p1: int | None = None
    c1: int | None = None
    p2: int | None = None
    c2: int | None = None

    def __post_init__(self):
        if self.category not in JOIN_CATEGORIES:
            raise ValueError(f"unknown join category {self.category!r}")
        if self.vpos1 not in ("s", "o") or self.vpos2 not in ("s", "o"):
            raise ValueError("vpos1/vpos2 must be 's' or 'o'")
        for fld in _JOIN_FIELDS[self.category]:
            if getattr(self, fld) is None:
                raise ValueError(f"join category {self.category} requires {fld}=")


@dataclasses.dataclass(frozen=True)
class BgpQ:
    """Basic graph pattern: a conjunction of ≥1 triple patterns."""

    patterns: tuple[TriplePatternQ, ...]

    def __post_init__(self):
        object.__setattr__(self, "patterns", _coerce_block(self.patterns))


def _coerce_block(ps):
    return tuple(
        p if isinstance(p, TriplePatternQ) else TriplePatternQ(*p) for p in ps
    )


@dataclasses.dataclass(frozen=True)
class SelectQ:
    """SPARQL-shaped SELECT over one group graph pattern.

    ``where`` is the base conjunction; each entry of ``union`` is an
    alternative branch (the branches' union is joined with ``where``);
    each entry of ``optional`` is an OPTIONAL block left-joined in
    declaration order; ``filter`` holds ``core.algebra`` expressions
    (``Cmp``/``Bound``/``And``/``Or``/``Not``, SPARQL 3-valued logic);
    ``select`` projects (``None`` = every named variable), ``order_by``
    entries are ``"?v"`` ascending / ``"-?v"`` descending, and
    ``limit``/``offset`` slice the ordered result.  Results are DISTINCT
    (set semantics, like ``BgpQ``); the ORDER BY ties break over the
    remaining columns in sorted-name order, so a LIMIT cut is
    deterministic.

    Lowered by ``core.algebra.from_select`` to an operator tree and
    executed by ``core.planner``: cost-ordered conjunctive blocks with
    sideways information passing over the engine's pooled serve step.
    """

    where: tuple[TriplePatternQ, ...] = ()
    optional: tuple[tuple[TriplePatternQ, ...], ...] = ()
    union: tuple[tuple[TriplePatternQ, ...], ...] = ()
    filter: tuple[Any, ...] = ()
    select: tuple[str, ...] | None = None
    order_by: tuple[str, ...] = ()
    limit: int | None = None
    offset: int = 0

    def __post_init__(self):
        object.__setattr__(self, "where", _coerce_block(self.where))
        object.__setattr__(
            self, "optional", tuple(_coerce_block(b) for b in self.optional)
        )
        object.__setattr__(
            self, "union", tuple(_coerce_block(b) for b in self.union)
        )
        object.__setattr__(self, "filter", tuple(self.filter))
        if self.select is not None:
            object.__setattr__(self, "select", tuple(self.select))
        object.__setattr__(self, "order_by", tuple(self.order_by))
        if not self.where and not self.union:
            raise ValueError("SelectQ needs a WHERE or UNION block")
        for spec in self.order_by:
            v = spec[1:] if spec.startswith("-") else spec
            if not v.startswith("?"):
                raise ValueError(
                    f"order_by entries are '?v' or '-?v', got {spec!r}"
                )
        if self.limit is not None and self.limit < 0:
            raise ValueError("limit must be >= 0")
        if self.offset < 0:
            raise ValueError("offset must be >= 0")


@dataclasses.dataclass(frozen=True)
class ServeQ:
    """Raw serve-IR passthrough: ``Plan(batch)`` takes a ``ServeBatch``.

    ``unbounded=False`` leaves the unbounded-``?P`` lanes out entirely.
    """

    unbounded: bool = True


def shape_key(query):
    """The plan-cache key component: what selects a program, not its inputs
    (the constant ids are runtime inputs)."""
    if isinstance(query, TriplePatternQ):
        return ("pattern", query.bound)
    if isinstance(query, JoinQ):
        return ("join", query.category, query.vpos1, query.vpos2)
    if isinstance(query, BgpQ):
        # BGP planning is data-dependent (cardinality estimates), so the
        # host plan re-runs per call; the serve programs underneath are
        # shared with every other plan of the engine
        return ("bgp",)
    if isinstance(query, SelectQ):
        # like BgpQ: planning re-runs per call over the shared serve step
        return ("select",)
    if isinstance(query, ServeQ):
        return ("serve", query.unbounded)
    raise TypeError(f"not a Query of this package: {query!r}")


class Plan:
    """Compile-once / run-many handle returned by ``Engine.compile``.

    Plans with the same ``(shape_key(query), config)`` share one executor,
    and so one effective (possibly grown) cap.
    """

    __slots__ = ("query", "config", "_executor")

    def __init__(self, query, config: ExecConfig, executor):
        self.query = query
        self.config = config
        self._executor = executor

    def __call__(self, batch=None):
        """Run with the config's :class:`CapPolicy` (syncs on overflow).

        ``batch``: ``None`` runs the query's own constants; a dict of
        bound position -> id array re-runs a ``TriplePatternQ`` shape over
        many constants; a ``ServeBatch`` feeds a ``ServeQ``."""
        try:
            return self._executor.run(self.query, batch)
        except StaleEpoch:
            # the store was compacted under us: recompile against the new
            # epoch (ids are stable across swaps, so the query means the
            # same thing) and retry once
            eng = self._executor.engine
            self._executor = eng.compile(self.query, self.config)._executor
            return self._executor.run(self.query, batch)

    def submit(self, batch=None):
        """Asynchronous dispatch: launch and return DEVICE results at once —
        no host sync, no overflow guard, no cap growth (``ServeQ`` only)."""
        return self._executor.submit(self.query, batch)

    @property
    def effective_cap(self) -> int:
        return self._executor.cap

    def cost_profile(self, batch=None) -> dict:
        """Cost profile of one call of the underlying serve program (``ServeQ``
        only): its geometry, the kernel launches it makes and, on the card,
        its device ms — see ``repro_torch.obs.cost``."""
        return self._executor.cost_profile(self.query, batch)

    def __repr__(self):
        return f"Plan({self.query!r}, device={self.config.device!r}, cap={self.effective_cap})"
