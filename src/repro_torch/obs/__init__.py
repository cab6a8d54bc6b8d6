"""repro_torch.obs — tracing, metrics and cost profiles for the serve stack.

One process-global observability state (``STATE``) holds an optional
:class:`~repro_torch.obs.trace.Tracer` and an optional
:class:`~repro_torch.obs.metrics.MetricsRegistry`.  Both default to
``None`` — observability OFF — and every instrumentation site in the
engine, the planner and the broker guards on that ``None`` before doing
anything: the disabled cost of a site is one attribute read and one
branch (tripwire-tested in ``tests/test_torch_obs.py``).

Enable with :func:`enable` (optionally with an
:class:`~repro_torch.core.query.ObsConfig`), tear down with
:func:`disable`::

    tracer, metrics = obs.enable()
    ...serve...
    json.dump(tracer.to_chrome(metadata=obs.provenance()), fh)
    print(metrics.to_prometheus())
    obs.disable()

:func:`span` is the one-liner for instrumentation sites that just want a
context manager: it returns the shared no-op span when tracing is off.
"""

from __future__ import annotations

from repro_torch.obs.metrics import (  # noqa: F401  (re-exports)
    Counter,
    DEFAULT_BUCKETS,
    Gauge,
    Histogram,
    LATENCY_MS_BUCKETS,
    MetricsRegistry,
    log_buckets,
)
from repro_torch.obs.trace import NOOP_SPAN, Tracer  # noqa: F401

__all__ = [
    "STATE", "enable", "disable", "enabled", "span", "provenance",
    "Tracer", "NOOP_SPAN",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "log_buckets",
    "DEFAULT_BUCKETS", "LATENCY_MS_BUCKETS",
]


class _State:
    """Global observability switches.  ``None`` means OFF."""

    __slots__ = ("tracer", "metrics")

    def __init__(self):
        self.tracer: Tracer | None = None
        self.metrics: MetricsRegistry | None = None


STATE = _State()


def enabled() -> bool:
    return STATE.tracer is not None or STATE.metrics is not None


def enable(config=None):
    """Turn observability on; returns ``(tracer, metrics)``.

    ``config`` is an :class:`repro_torch.core.query.ObsConfig` (imported
    lazily: ``repro_torch.core`` imports this package, not the other way
    round); ``None`` enables both tracing and metrics with defaults.
    Either component is ``None`` in the result if the config disabled it.
    """
    if config is None:
        from repro_torch.core.query import ObsConfig

        config = ObsConfig()
    STATE.tracer = (
        Tracer(config.trace_capacity, annotate=config.device_annotations)
        if config.trace
        else None
    )
    STATE.metrics = MetricsRegistry() if config.metrics else None
    return STATE.tracer, STATE.metrics


def disable() -> None:
    """Turn observability off (instrumentation reverts to the no-op path)."""
    STATE.tracer = None
    STATE.metrics = None


def span(name: str, **attrs):
    """Context manager for one span; the shared no-op when tracing is off."""
    t = STATE.tracer
    return NOOP_SPAN if t is None else t.span(name, **attrs)


def provenance() -> dict:
    """Self-describing run header: git SHA and dirty flag, UTC timestamp,
    torch and CUDA versions, the card's name and count, and its name and
    power limit as ``nvidia-smi`` prints them when a card is present.
    Embedded in trace and metrics exports so a number can be tied back to
    the code and the hardware that produced it.  Every field is
    best-effort: one that cannot be had is ``None`` or an ``*_error``
    string."""
    import datetime
    import os
    import subprocess

    import torch

    out = {
        "utc": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"
        ),
    }
    # anchor git to the package's own checkout, not the process cwd
    here = os.path.dirname(os.path.abspath(__file__))
    try:
        out["git_sha"] = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, check=True, cwd=here,
        ).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain"], capture_output=True,
            text=True, timeout=5, check=True, cwd=here,
        ).stdout.strip()
        out["git_dirty"] = bool(dirty)
    except (OSError, subprocess.SubprocessError):
        out["git_sha"] = None
    out["torch_version"] = torch.__version__
    out["cuda_version"] = torch.version.cuda
    if torch.cuda.is_available():
        out["device_kind"] = torch.cuda.get_device_name(0)
        out["device_count"] = torch.cuda.device_count()
        try:
            out["nvidia_smi"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30, check=True,
            ).stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError) as e:
            out["nvidia_smi_error"] = f"{type(e).__name__}: {e}"
    else:
        out["device_kind"] = "cpu"
        out["device_count"] = 0
    return out
