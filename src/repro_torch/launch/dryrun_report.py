"""Reports over directories of dry-run records (``launch/dryrun.py``).

    python -m repro_torch.launch.dryrun_report diff NEW OLD [OLD ...]
        each cell of NEW whose record differs from the OLD directories' in
        a key but the times, with the keys; a record whose ``link_detail``
        OLD lacks must hold every byte under NVLink

    python -m repro_torch.launch.dryrun_report table PROD NODE [FORCED]
        PROD's records (the production meshes) as rows of ``PERF.md``'s
        table: compute / memory / collective ms, NVLink / network GB a
        device, the peak a device against the card's 80 GB (bottleneck),
        the dry run's seconds against the same cell's on 2x4 in NODE; with
        FORCED (2x4 records run with ``--shortcut on``), each such cell's
        per-device peak beside NODE's (the full emulation's)
"""

from __future__ import annotations

import glob
import json
import os
import sys

TIMES = ("t_build_s", "t_run_s")
CARD_BYTES = 80e9


def load(path: str) -> dict:
    """The records of ``path`` by (arch, shape, mesh)."""
    out = {}
    for f in sorted(glob.glob(os.path.join(path, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        out[r["arch"], r["shape"], r["mesh"]] = r
    return out


def seconds(r: dict) -> float:
    return r["t_build_s"] + r["t_run_s"]


def diff(new: dict, old: dict) -> dict:
    """Cell -> the keys (but the times) in which ``new``'s record differs
    from ``old``'s; a ``link_detail`` ``old`` lacks counts as a difference
    unless it holds no network byte."""
    out = {}
    for cell, r in new.items():
        o = old.get(cell)
        if o is None:
            out[cell] = ["missing"]
            continue
        keys = sorted(k for k in (set(r) | set(o)) - set(TIMES)
                      if k != "link_detail" and r.get(k) != o.get(k))
        if "link_detail" not in o and r.get("link_detail", {}).get("network", 0):
            keys.append("link_detail")
        if keys:
            out[cell] = keys
    return out


def _g(x: float) -> str:
    return f"{x:.3g}"


def _ms(t: float) -> str:
    return f"{t:.3g} s" if t >= 1 else _g(t * 1e3)


def row(r: dict, node: dict | None, forced: dict | None) -> str:
    """One cell of the table."""
    links = r["link_detail"]
    peak = r["peak_mem_bytes"]
    text = (f"`{r['shape']}` {_ms(r['t_compute'])} / {_ms(r['t_memory'])} / "
            f"{_ms(r['t_collective'])}; {_g(links['nvlink'] / 1e9)} / "
            f"{_g(links['network'] / 1e9)} GB; {_g(peak / 1e9)} GB "
            f"{'fits' if peak < CARD_BYTES else 'over'} ({r['bottleneck']})")
    if node is not None:
        text += f"; {seconds(r):.2f} s ({seconds(r) / seconds(node):.1f}× 2x4)"
    if forced is not None and node is not None:
        text += (f"; 2x4 shortcut {_g(forced['peak_mem_bytes'] / 1e9)} against "
                 f"{_g(node['peak_mem_bytes'] / 1e9)} GB")
    return text


def table(prod: dict, node: dict, forced: dict, mesh: str = "32x8") -> list[str]:
    """The rows of ``PERF.md``'s production table for ``mesh``."""
    archs: dict = {}
    for (arch, shape, m), r in prod.items():
        if m == mesh and r.get("ok"):
            archs.setdefault(arch, []).append(row(r, node.get((arch, shape, "2x4")),
                                                  forced.get((arch, shape, "2x4"))))
    return [f"| {a} | {'<br>'.join(cells)} |" for a, cells in archs.items()]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) >= 3 and argv[0] == "diff":
        new, old = load(argv[1]), {}
        for path in argv[2:]:
            old.update(load(path))
        bad = diff(new, old)
        for cell, keys in sorted(bad.items()):
            o, r = old.get(cell, {}), new[cell]
            print("__".join(cell), ", ".join(
                f"{k} {o.get(k)} -> {r.get(k)}" if isinstance(r.get(k), (int, float)) else k
                for k in keys))
        print(f"{len(new) - len(bad)} of {len(new)} records equal but the times")
        return 0
    if len(argv) in (3, 4) and argv[0] == "table":
        forced = load(argv[3]) if len(argv) == 4 else {}
        prod, node = load(argv[1]), load(argv[2])
        for line in table(prod, node, forced):
            print(line)
        for mesh in sorted({m for _, _, m in prod}):
            cells = [(c, r) for c, r in prod.items() if c[2] == mesh and r.get("ok")]
            within = sum(seconds(r) <= 3 * seconds(node[c[0], c[1], "2x4"]) for c, r in cells)
            print(f"{mesh}: {len(cells)} ok, {within} within 3x their 2x4 seconds")
        return 0
    print(__doc__)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
