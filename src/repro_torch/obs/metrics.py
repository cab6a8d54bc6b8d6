"""Typed metrics registry: counters, gauges, histograms with fixed
log-spaced buckets, a JSON snapshot, and a Prometheus-style exposition.

This replaces ad-hoc ``collections.Counter`` stat dicts across the serve
stack: metrics are declared once by name, typed (re-registering a name as
a different kind raises), thread-safe (one registry lock — serve decode
runs off-loop in a worker thread), and resettable as a unit
(``registry.reset()`` — the broker's warmup boundary).

Histogram buckets are FIXED and log-spaced (``log_buckets``): bucket
geometry never adapts to data, so two snapshots — or two processes — are
always mergeable bucket-by-bucket, the property Prometheus histograms are
built on.  ``Histogram.percentile`` gives the standard
interpolated-within-bucket estimate for quick reads; exact tails stay
with the broker's sample lists (``tail_percentile``).
"""

from __future__ import annotations

import bisect
import math
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "log_buckets",
    "DEFAULT_BUCKETS", "LATENCY_MS_BUCKETS",
]


def log_buckets(lo: float, hi: float, per_decade: int = 3) -> tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds covering ``[lo, hi]``.

    ``per_decade`` bounds per factor-of-10, snapped to exact decade
    multiples so bucket edges are stable, human-readable values
    (1, 2.15, 4.64, 10, ... for ``per_decade=3``).
    """
    if not (0 < lo < hi):
        raise ValueError(f"need 0 < lo < hi, got ({lo}, {hi})")
    if per_decade < 1:
        raise ValueError("per_decade must be >= 1")
    d0 = math.floor(math.log10(lo) * per_decade)
    d1 = math.ceil(math.log10(hi) * per_decade)
    return tuple(round(10.0 ** (i / per_decade), 12) for i in range(d0, d1 + 1))


# general-purpose default: 1e-6 .. 1e3 (covers ns..ks in seconds, B..GB, ...)
DEFAULT_BUCKETS = log_buckets(1e-6, 1e3, per_decade=3)
# per-query serve latency in milliseconds: 1 us .. 100 s
LATENCY_MS_BUCKETS = log_buckets(1e-3, 1e5, per_decade=3)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._v = 0
        self._lock = lock

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v

    def _reset(self) -> None:
        self._v = 0

    def _snapshot(self) -> dict:
        return {"type": "counter", "value": self._v}


class Gauge:
    """Last-written value."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._v = 0.0
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self) -> float:
        return self._v

    def _reset(self) -> None:
        self._v = 0.0

    def _snapshot(self) -> dict:
        return {"type": "gauge", "value": self._v}


class Histogram:
    """Fixed-bucket histogram: counts per log-spaced bucket + sum/min/max.

    ``bounds[i]`` is the INCLUSIVE upper edge of bucket ``i``; one
    overflow bucket catches everything above the last bound.
    """

    __slots__ = ("name", "bounds", "_counts", "_sum", "_count", "_min",
                 "_max", "_lock")

    def __init__(self, name: str, bounds: tuple[float, ...],
                 lock: threading.Lock):
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError("bounds must be a non-empty ascending sequence")
        self.name = name
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf
        self._lock = lock

    def observe(self, v: float) -> None:
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float | None:
        """Bucket-interpolated quantile estimate (``None`` when empty)."""
        if not 0 <= q <= 100:
            raise ValueError(f"q must be in [0, 100], got {q}")
        if self._count == 0:
            return None
        target = self._count * q / 100.0
        acc = 0
        for i, c in enumerate(self._counts):
            if acc + c >= target and c:
                lo = self.bounds[i - 1] if i > 0 else min(self._min, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else self._max
                frac = (target - acc) / c
                return min(max(lo + (hi - lo) * frac, self._min), self._max)
            acc += c
        return self._max

    def _reset(self) -> None:
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0
        self._min = math.inf
        self._max = -math.inf

    def _snapshot(self) -> dict:
        return {
            "type": "histogram",
            "count": self._count,
            "sum": self._sum,
            "min": None if self._count == 0 else self._min,
            "max": None if self._count == 0 else self._max,
            "buckets": {
                ("+Inf" if i == len(self.bounds) else repr(self.bounds[i])): c
                for i, c in enumerate(self._counts)
                if c
            },
        }


class MetricsRegistry:
    """Named, typed metric store.

    ``counter``/``gauge``/``histogram`` create-or-return by name — a name
    registered as one kind can never silently come back as another.
    ``snapshot()`` is the JSON-ready view; ``to_prometheus()`` the text
    exposition; ``reset()`` zeroes every metric in place (registered
    metric objects stay valid — callers may hold them)."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind, factory):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = factory()
        if not isinstance(m, kind):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, "
                f"not a {kind.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name, self._lock))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name, self._lock))

    def histogram(self, name: str,
                  buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        """First registration fixes the buckets; later calls return the
        existing histogram (their ``buckets`` argument is ignored)."""
        return self._get(
            name, Histogram, lambda: Histogram(name, buckets, self._lock)
        )

    def reset(self) -> None:
        with self._lock:
            for m in self._metrics.values():
                m._reset()

    def snapshot(self) -> dict:
        """``{name: {"type": ..., ...}}`` sorted by name."""
        with self._lock:
            return {
                name: self._metrics[name]._snapshot()
                for name in sorted(self._metrics)
            }

    def to_prometheus(self) -> str:
        """Prometheus text exposition (names sanitized ``.`` -> ``_``)."""
        lines = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            pn = _prom_name(name)
            if isinstance(m, Counter):
                lines += [f"# TYPE {pn} counter", f"{pn} {m.value}"]
            elif isinstance(m, Gauge):
                lines += [f"# TYPE {pn} gauge", f"{pn} {_prom_num(m.value)}"]
            else:
                lines.append(f"# TYPE {pn} histogram")
                acc = 0
                for i, b in enumerate(m.bounds):
                    acc += m._counts[i]
                    lines.append(f'{pn}_bucket{{le="{_prom_num(b)}"}} {acc}')
                acc += m._counts[-1]
                lines.append(f'{pn}_bucket{{le="+Inf"}} {acc}')
                lines.append(f"{pn}_sum {_prom_num(m.sum)}")
                lines.append(f"{pn}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_name(name: str) -> str:
    out = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def _prom_num(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))
