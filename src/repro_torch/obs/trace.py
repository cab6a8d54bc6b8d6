"""Low-overhead host-side span tracer with a Chrome ``trace_event`` export.

The serve stack's timeline instrument: a fixed-capacity ring buffer of
spans stamped with the monotonic clock (``time.perf_counter_ns`` — the
same clock base the broker's latency samples use), recorded either live
(``begin``/``end`` or the ``span`` context manager) or retroactively
(``add``/``add_async`` with explicit timestamps — how the broker emits
per-query phase spans at delivery time, when every timestamp of the
batch is known).

Design rules:

* **Disabled is free.**  The tracer only exists while observability is
  enabled (``repro_torch.obs.enable``); every instrumentation site guards on
  ``obs.STATE.tracer is None`` — one attribute read and one branch, no
  tracer method calls, no allocation (``tests/test_torch_obs.py``
  tripwires this).
* **Recording never blocks the serve path.**  A record is a dict append
  into a pre-sized ring under a (practically uncontended) lock; when the
  ring wraps, the OLDEST spans are dropped and counted (``dropped``) —
  tracing a long run degrades to a suffix window, never to back-pressure.
* **Hierarchy is time containment.**  Spans carry a track id (``tid`` —
  the thread id by default, or an explicit string track like
  ``"batch-slot-0"``); within a track, nesting is by interval
  containment, exactly the Chrome/Perfetto model, so no parent pointers
  are threaded through async hops.  Overlapping per-query lifetimes ride
  Chrome *async* events (``ph: "b"/"e"`` with an ``id``) instead, which
  Perfetto renders as per-id nested tracks.

The optional ``torch.profiler`` bridge (``annotate=True``) wraps every
live span in a ``torch.profiler.record_function`` so a torch profile
captured around the same run carries the same span names, on the CPU and
on the card.
"""

from __future__ import annotations

import threading
import time

__all__ = ["Tracer", "NOOP_SPAN"]


class _NoopSpan:
    """The shared disabled-path context manager: no state, no effect."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_SPAN = _NoopSpan()


class _LiveSpan:
    """Handle for an open ``begin``/``end`` span."""

    __slots__ = ("name", "cat", "t0", "tid", "args", "ann")

    def __init__(self, name, cat, t0, tid, args, ann):
        self.name = name
        self.cat = cat
        self.t0 = t0
        self.tid = tid
        self.args = args
        self.ann = ann


class _SpanCM:
    __slots__ = ("tracer", "live", "name", "attrs")

    def __init__(self, tracer, name, attrs):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.live = None

    def __enter__(self):
        self.live = self.tracer.begin(self.name, **self.attrs)
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is not None:
            self.live.args = dict(self.live.args, error=exc_type.__name__)
        self.tracer.end(self.live)
        return False


class Tracer:
    """Ring-buffered hierarchical span recorder.

    All timestamps are ``time.perf_counter_ns`` integers (``Tracer.now``);
    retroactive ``add*`` callers holding ``time.perf_counter`` float
    seconds convert with ``int(t * 1e9)`` — same clock, same epoch.
    """

    def __init__(self, capacity: int = 1 << 16, *, annotate: bool = False):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.annotate = annotate
        self._ring: list = [None] * capacity
        self._n = 0  # total records ever (ring cursor = _n % capacity)
        self._lock = threading.Lock()
        self.t_epoch = time.perf_counter_ns()
        self._profiler = None
        if annotate:
            import torch.profiler  # deferred: only the bridge needs it

            self._profiler = torch.profiler

    # -- recording ------------------------------------------------------

    @staticmethod
    def now() -> int:
        return time.perf_counter_ns()

    def _record(self, rec: dict) -> None:
        with self._lock:
            self._ring[self._n % self.capacity] = rec
            self._n += 1

    def begin(self, name: str, **attrs) -> _LiveSpan:
        """Open a live span on the current thread's track."""
        ann = None
        if self._profiler is not None:
            ann = self._profiler.record_function(name)
            ann.__enter__()
        return _LiveSpan(
            name, attrs.pop("cat", ""), time.perf_counter_ns(),
            attrs.pop("tid", None), attrs, ann,
        )

    def end(self, live: _LiveSpan, **extra) -> None:
        t1 = time.perf_counter_ns()
        if live.ann is not None:
            live.ann.__exit__(None, None, None)
        args = dict(live.args, **extra) if extra else live.args
        self._record({
            "kind": "X", "name": live.name, "cat": live.cat,
            "t0": live.t0, "t1": t1,
            "tid": live.tid if live.tid is not None else threading.get_ident(),
            "args": args,
        })

    def span(self, name: str, **attrs) -> _SpanCM:
        """``with tracer.span("engine.compile", shape=...):`` — live span."""
        return _SpanCM(self, name, attrs)

    def add(self, name: str, t0: int, t1: int, *, tid=None, cat: str = "",
            **attrs) -> None:
        """Retroactive complete span with explicit ns timestamps."""
        self._record({
            "kind": "X", "name": name, "cat": cat, "t0": int(t0), "t1": int(t1),
            "tid": tid if tid is not None else threading.get_ident(),
            "args": attrs,
        })

    def add_async(self, name: str, aid, t0: int, t1: int, *,
                  cat: str = "query", **attrs) -> None:
        """Retroactive async (overlappable) span — one ``b``/``e`` pair
        under ``id=aid`` in the Chrome export.  Same-id slices nest by
        time, so per-query phase breakdowns share the query's id."""
        self._record({
            "kind": "async", "name": name, "cat": cat or "async",
            "id": aid, "t0": int(t0), "t1": int(t1), "tid": 0, "args": attrs,
        })

    def instant(self, name: str, *, tid=None, **attrs) -> None:
        t = time.perf_counter_ns()
        self._record({
            "kind": "I", "name": name, "cat": "", "t0": t, "t1": t,
            "tid": tid if tid is not None else threading.get_ident(),
            "args": attrs,
        })

    # -- inspection -----------------------------------------------------

    @property
    def dropped(self) -> int:
        """Spans overwritten by ring wrap (oldest-first)."""
        return max(0, self._n - self.capacity)

    def events(self) -> list[dict]:
        """Retained records, oldest first."""
        with self._lock:
            n = self._n
            if n <= self.capacity:
                out = self._ring[:n]
            else:
                cur = n % self.capacity
                out = self._ring[cur:] + self._ring[:cur]
            return list(out)

    def clear(self) -> None:
        """Drop everything recorded so far (the warmup boundary)."""
        with self._lock:
            self._ring = [None] * self.capacity
            self._n = 0
            self.t_epoch = time.perf_counter_ns()

    # -- Chrome trace_event export --------------------------------------

    def to_chrome(self, *, metadata: dict | None = None) -> dict:
        """The Perfetto-loadable ``{"traceEvents": [...]}`` object.

        Complete spans become ``ph: "X"`` events nested by time per
        track; async records become ``ph: "b"``/``"e"`` pairs; string
        track ids are mapped to integer tids with ``thread_name``
        metadata so Perfetto shows readable track names.
        """
        events = self.events()
        t_base = min((e["t0"] for e in events), default=self.t_epoch)
        tids: dict = {}

        def tid_of(raw):
            if raw not in tids:
                tids[raw] = len(tids) + 1
            return tids[raw]

        out = []
        for e in events:
            ts = (e["t0"] - t_base) / 1e3  # us
            args = {k: _jsonable(v) for k, v in e["args"].items()}
            if e["kind"] == "X":
                out.append({
                    "ph": "X", "name": e["name"], "cat": e["cat"] or "span",
                    "ts": ts, "dur": max(0.0, (e["t1"] - e["t0"]) / 1e3),
                    "pid": 1, "tid": tid_of(e["tid"]), "args": args,
                })
            elif e["kind"] == "async":
                common = {
                    "name": e["name"], "cat": e["cat"], "id": str(e["id"]),
                    "pid": 1, "tid": 0,
                }
                out.append({"ph": "b", "ts": ts, "args": args, **common})
                out.append({
                    "ph": "e", "ts": (e["t1"] - t_base) / 1e3, **common,
                })
            else:  # instant
                out.append({
                    "ph": "i", "name": e["name"], "cat": e["cat"] or "span",
                    "ts": ts, "s": "t", "pid": 1, "tid": tid_of(e["tid"]),
                    "args": args,
                })
        for raw, tid in tids.items():
            out.append({
                "ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                "args": {"name": raw if isinstance(raw, str) else f"thread-{raw}"},
            })
        trace = {"traceEvents": out, "displayTimeUnit": "ms"}
        if self.dropped:
            trace["droppedSpans"] = self.dropped
        if metadata:
            trace["otherData"] = {k: _jsonable(v) for k, v in metadata.items()}
        return trace


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)
