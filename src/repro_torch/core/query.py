"""The compiled-plan query API: ``ServeQ`` → ``Engine.compile(ExecConfig)`` → ``Plan``.

This module is the one place execution knobs enter the system.  A
:class:`ExecConfig` is a frozen, hashable dataclass that keys the plan and
program caches; it resolves without reading the environment.

Cap policy: fixed result capacities make every batch one set of kernel
launches, and truncation is never silent.  On overflow ``Plan.__call__``
re-runs at doubled cap (:class:`CapPolicy`); ``Plan.submit`` — the broker's
streaming hook — never grows and leaves the overflow bits to its caller.
"""

from __future__ import annotations

import dataclasses

import torch

PRED_INDEX_LAYOUTS = ("dac", "fixed")


class CapOverflow(RuntimeError):
    """A fixed-capacity result buffer truncated and the policy forbids (or
    exhausted) growth."""


class AdmissionError(RuntimeError):
    """Plan-cache admission denied: the ``admit`` callback of
    ``Engine.compile`` vetoed a cache miss."""


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
        Result capacities (``cap_y`` doubles with ``cap`` and is kept for
        the join plans of later slices).
    ``cap_policy``
        Overflow handling; see :class:`CapPolicy`.
    ``use_pred_index``
        Serve unbounded-``?P`` lanes through the SP/OP index when the store
        carries one; ``False`` forces the all-preds sweep.
    ``u_width_quantile``
        Only ``1.0`` (lane width = ``max_degree``) in this package so far.
    ``pred_index_layout``
        "dac" (default) or "fixed" (plain version only; raises on CUDA).
    ``device``
        The device plans run on; must be the engine's.
    """

    cap: int = 4096
    cap_y: int = 256
    cap_policy: CapPolicy = CapPolicy()
    use_pred_index: bool = True
    u_width_quantile: float = 1.0
    pred_index_layout: str = "dac"
    device: str = "cuda"

    def __post_init__(self):
        if self.u_width_quantile != 1.0:
            raise NotImplementedError(
                "u_width_quantile < 1 needs the sweep fallback of the pattern "
                "plans, which this package does not have yet"
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
class ServeQ:
    """Raw serve-IR passthrough: ``Plan(batch)`` takes a ``ServeBatch``.

    ``unbounded=False`` leaves the unbounded-``?P`` lanes out entirely.
    """

    unbounded: bool = True


def shape_key(query):
    """The plan-cache key component: what selects a program, not its inputs."""
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
        """Run with the config's :class:`CapPolicy` (syncs on overflow)."""
        return self._executor.run(self.query, batch)

    def submit(self, batch=None):
        """Asynchronous dispatch: launch and return DEVICE results at once —
        no host sync, no overflow guard, no cap growth."""
        return self._executor.submit(self.query, batch)

    @property
    def effective_cap(self) -> int:
        return self._executor.cap

    def __repr__(self):
        return f"Plan({self.query!r}, device={self.config.device!r}, cap={self.effective_cap})"
