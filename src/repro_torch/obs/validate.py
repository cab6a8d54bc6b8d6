"""Minimal Chrome ``trace_event`` schema validator.

A ``launch/serve.py --trace-path`` run (or ``chip_smoke.py``'s traced
broker run) is validated here: non-empty, every event carries the
required keys, complete (``X``) spans have non-negative durations and
are well-nested per ``(pid, tid)`` track, and async ``b``/``e`` events
balance per ``(cat, id)``.  Usable as a library
(:func:`validate_chrome_trace` returns a list of problem strings) or as
a CLI::

    PYTHONPATH=src python -m repro_torch.obs.validate serve_trace.json --require-queries

exiting non-zero when the trace is malformed (or, with
``--require-queries``, when it contains no per-query async spans).
"""

from __future__ import annotations

import json
import sys

_REQUIRED = ("name", "ph")


def validate_chrome_trace(obj, *, require_queries: bool = False) -> list[str]:
    """Return a list of problems (empty == valid)."""
    problems: list[str] = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' array"]
    events = obj["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["'traceEvents' must be a non-empty array"]

    tracks: dict = {}   # (pid, tid) -> [(ts, dur, i, name)] complete spans
    asyncs: dict = {}   # (cat, id) -> open-begin depth
    n_query_asyncs = 0
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            problems.append(f"event {i}: not an object")
            continue
        for k in _REQUIRED:
            if k not in e:
                problems.append(f"event {i}: missing required key {k!r}")
        ph = e.get("ph")
        if ph == "M":
            continue  # metadata events carry no timestamp
        if "ts" not in e:
            problems.append(f"event {i}: missing required key 'ts'")
            continue
        ts = e["ts"]
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i}: 'ts' must be a number")
            continue
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i}: 'X' event needs numeric dur >= 0")
                continue
            key = (e.get("pid"), e.get("tid"))
            tracks.setdefault(key, []).append((ts, dur, i, e.get("name")))
        elif ph in ("b", "e"):
            key = (e.get("cat"), e.get("id"))
            if key[1] is None:
                problems.append(f"event {i}: async event missing 'id'")
                continue
            d = asyncs.get(key, 0)
            if ph == "b":
                asyncs[key] = d + 1
                if e.get("cat") == "query":
                    n_query_asyncs += 1
            else:
                if d <= 0:
                    problems.append(
                        f"event {i}: async 'e' for {key} with no open 'b'"
                    )
                else:
                    asyncs[key] = d - 1
        elif ph not in ("i", "I", "C", "s", "t", "f"):
            problems.append(f"event {i}: unsupported phase {ph!r}")
    # X events on one track must nest once sorted by start time (events
    # are recorded at span END, so file order is not timeline order —
    # Perfetto sorts by ts, and so do we; longer spans first on ties so
    # a parent precedes children that start at the same instant).
    # Tolerance: ts/dur are ns-resolution clocks exported in float µs, so
    # adjacent distinct instants differ by >= 1e-3 while double rounding
    # of ts + dur is ~ULP(ts) (4e-9 at µs-timestamps in the 1e8 range);
    # 1e-4 sits safely between the two.
    tol = 1e-4
    for key, spans in tracks.items():
        stack: list[float] = []  # end timestamps of enclosing spans
        for ts, dur, i, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            while stack and ts >= stack[-1] - tol:
                stack.pop()
            if stack and ts + dur > stack[-1] + tol:
                problems.append(
                    f"event {i}: span {name!r} overlaps the enclosing "
                    f"span on track {key} without nesting"
                )
            stack.append(ts + dur)
    for key, depth in asyncs.items():
        if depth:
            problems.append(f"async {key}: {depth} unmatched 'b' event(s)")
    if require_queries and n_query_asyncs == 0:
        problems.append("no 'query'-category async spans found")
    return problems


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    require_queries = "--require-queries" in argv
    paths = [a for a in argv if not a.startswith("--")]
    if len(paths) != 1:
        print("usage: python -m repro_torch.obs.validate PATH [--require-queries]",
              file=sys.stderr)
        return 2
    with open(paths[0]) as fh:
        obj = json.load(fh)
    problems = validate_chrome_trace(obj, require_queries=require_queries)
    if problems:
        for p in problems:
            print(f"TRACE INVALID: {p}", file=sys.stderr)
        return 1
    n = len(obj["traceEvents"])
    print(f"trace OK: {paths[0]} ({n} events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
