"""Multi-tenant serving benchmark: drive the streaming broker with a skewed
tenant trace and report sustained queries/sec + per-QUERY tail latency.

    python -m repro_torch.launch.serve --like geonames --triples 9415253
    python -m repro_torch.launch.serve --fast --device cpu

The harness builds a store on the device, compiles ONE base ``ServeQ``
plan through :class:`repro_torch.launch.broker.ServeBroker`, replays a
Zipf-skewed multi-tenant trace of mixed serve-IR ops through per-tenant
async streams, and reports the broker's stats.  Latency is per query
(submit -> decoded result); a p99 is only reported with 100+ samples.
The default device is the CUDA card; without one the run raises.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time

import numpy as np
import torch

from repro_torch.launch.broker import CoalescePolicy, ServeBroker, TenantPolicy

# mixed-op trace composition: production traffic is mostly point lookups
# and bounded scans, with a thin unbounded-?P tail (the paper's worst case)
_OP_WEIGHTS = {
    0: 0.30,  # OP_CHECK
    1: 0.25,  # OP_ROW
    2: 0.25,  # OP_COL
    3: 0.08,  # OP_S_ANY_ANY
    4: 0.07,  # OP_ANY_ANY_O
    5: 0.05,  # OP_S_ANY_O
}


def zipf_weights(n_tenants: int, a: float) -> np.ndarray:
    """Normalized Zipf(a) tenant weights: tenant 0 is the heaviest."""
    w = 1.0 / np.arange(1, n_tenants + 1, dtype=np.float64) ** a
    return w / w.sum()


def make_trace(
    ds, n_queries: int, n_tenants: int, *, zipf_a: float = 1.1,
    unbounded: bool = True, seed: int = 0,
) -> list[tuple]:
    """A skewed multi-tenant trace of ``(tenant, op, s, p, o)`` lane rows.

    Tenants are Zipf(a)-weighted; ops follow ``_OP_WEIGHTS`` (bounded-only
    when ``unbounded=False``); ids come from real triples.  A seed gives
    the JAX package's lane trace (same draws in the same order).
    """
    rng = np.random.default_rng(seed)
    ops_pool = [op for op in _OP_WEIGHTS if unbounded or op < 3]
    p_ops = np.array([_OP_WEIGHTS[op] for op in ops_pool])
    p_ops = p_ops / p_ops.sum()
    ops = rng.choice(ops_pool, size=n_queries, p=p_ops)
    tenants = rng.choice(n_tenants, size=n_queries, p=zipf_weights(n_tenants, zipf_a))
    rows = ds.ids[rng.integers(0, ds.n_triples, n_queries)]
    trace = []
    for i in range(n_queries):
        s, p, o = map(int, rows[i])
        if ops[i] >= 3:
            p = 0  # unbounded-?P ops leave the predicate free
        trace.append((f"tenant-{tenants[i]}", int(ops[i]), s, p, o))
    return trace


async def _replay(broker: ServeBroker, trace) -> list:
    """Replay the trace as one async stream per tenant (per-tenant FIFO);
    returns the decoded answers in trace order."""
    per_tenant: dict[str, list[int]] = {}
    for i, (tenant, *_rest) in enumerate(trace):
        per_tenant.setdefault(tenant, []).append(i)
    answers: list = [None] * len(trace)

    async def one(idxs):
        it = iter(idxs)
        async for ans in broker.stream(trace[idxs[0]][0], (trace[i][1:] for i in idxs)):
            answers[next(it)] = ans

    await asyncio.gather(*(one(idxs) for idxs in per_tenant.values()))
    return answers


def serve_trace(
    engine, trace, *, n_tenants: int, cap: int = 1024, max_batch: int = 256,
    deadline_ms: float = 2.0, unbounded: bool = True, warmup: int = 64,
):
    """Serve ``trace`` through a broker after a warmup prefix.

    Returns ``(stats, answers, wall_s)``: the broker's stats for the
    measured run, the decoded answer of every trace row, and the wall time.
    """
    cfg = engine.default_config.replace(cap=cap)
    # bound per-tenant windows so ~two coalesced batches stay outstanding
    depth = max(16, (2 * max_batch) // max(n_tenants, 1))

    async def main():
        broker = ServeBroker(
            engine, cfg, unbounded=unbounded,
            coalesce=CoalescePolicy(max_batch=max_batch, max_delay_s=deadline_ms * 1e-3),
            tenant_policy=TenantPolicy(queue_depth=depth),
        )
        async with broker:
            await _replay(broker, trace[: min(warmup, len(trace))])
            broker.reset_stats()
            t0 = time.perf_counter()
            answers = await _replay(broker, trace)
            wall = time.perf_counter() - t0
        return broker.stats(), answers, wall

    return asyncio.run(main())


def run_bench(
    *,
    device="cuda",
    n_triples: int = 100_000,
    n_preds: int = 64,
    like: str | None = None,
    n_tenants: int = 8,
    n_queries: int = 4096,
    zipf_a: float = 1.1,
    cap: int = 1024,
    max_batch: int = 256,
    deadline_ms: float = 2.0,
    unbounded: bool = True,
    warmup: int = 64,
    seed: int = 0,
    quiet: bool = False,
) -> dict:
    """Build a store, serve a skewed multi-tenant trace through the broker,
    and return one machine-readable serving row.

    ``like`` scales a paper dataset (``data/rdf.py``'s ``PAPER_DATASETS``)
    to ``n_triples``; otherwise a generic corpus of ``n_preds`` predicates.
    """
    from repro_torch.core import engine as eng, k2triples
    from repro_torch.core.query import resolve_device
    from repro_torch.data import rdf

    dev = resolve_device(device)
    if like is not None:
        ds = rdf.generate_like(like, n_triples, seed=seed)
    else:
        ds = rdf.generate(
            n_triples, n_subjects=max(64, n_triples // 12), n_preds=n_preds,
            n_objects=max(64, n_triples // 8), preds_per_subject=min(6, n_preds),
            seed=seed,
        )
    t0 = time.perf_counter()
    store = k2triples.from_id_triples(
        ds.ids, n_so=ds.n_so, n_subjects=ds.n_subjects,
        n_objects=ds.n_objects, n_preds=ds.n_preds, device=dev,
    )
    build_s = time.perf_counter() - t0
    if not quiet:
        print(
            f"store: {store.n_triples} triples, {store.n_preds} preds, "
            f"side {store.meta.side}, "
            f"{store.stats.total_bits / max(store.n_triples, 1):.2f} bits/triple, "
            f"built in {build_s:.1f}s on the host"
        )
    engine = eng.Engine(store, device=dev)
    trace = make_trace(ds, n_queries, n_tenants, zipf_a=zipf_a,
                       unbounded=unbounded, seed=seed + 1)
    stats, answers, wall = serve_trace(
        engine, trace, n_tenants=n_tenants, cap=cap, max_batch=max_batch,
        deadline_ms=deadline_ms, unbounded=unbounded, warmup=warmup,
    )
    if sum(a is not None for a in answers) != n_queries:
        raise RuntimeError("the broker left queries unanswered")
    row = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        "dataset": like or "generic",
        "triples": store.n_triples,
        "preds": store.n_preds,
        "build_s": build_s,
        "tenants": n_tenants,
        "zipf_a": zipf_a,
        "unbounded": unbounded,
        "queries": n_queries,
        "cap": cap,
        "max_batch": max_batch,
        "deadline_ms": deadline_ms,
        "wall_s": wall,
        "qps": n_queries / wall,
        "p50_ms": stats["p50_ms"],
        "p99_ms": stats["p99_ms"],
        "coalesce_factor": stats["coalesce_factor"],
        "batches": stats["batches"],
        "shed": stats["shed"],
        "cap_growth_events": stats["cap_growth_events"],
        "queue_peak": stats["queue_peak"],
        "per_tenant": stats["tenants"],
    }
    if not quiet:
        print(format_row(row))
    return row


def format_row(row: dict) -> str:
    def pct(v):
        return f"{v:.3f} ms" if v is not None else "n/a (insufficient samples)"

    return (
        f"{row['device']}: {row['queries']} queries, {row['tenants']} tenants "
        f"(zipf {row['zipf_a']}): {row['qps']:,.0f} queries/s sustained, "
        f"per-query p50 {pct(row['p50_ms'])}, p99 {pct(row['p99_ms'])}, "
        f"coalesce x{row['coalesce_factor']:.1f} ({row['batches']} batches), "
        f"{row['cap_growth_events']} cap growths, {row['shed']} shed"
    )


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--triples", type=int, default=100_000)
    ap.add_argument("--preds", type=int, default=64)
    ap.add_argument("--like", default=None, help="paper dataset to scale, e.g. geonames")
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--zipf", type=float, default=1.1, help="tenant skew exponent")
    ap.add_argument("--queries", type=int, default=4096, help="trace length")
    ap.add_argument("--batch", type=int, default=256, help="coalesce max_batch")
    ap.add_argument("--deadline-ms", type=float, default=2.0,
                    help="coalesce deadline for the oldest pending query")
    ap.add_argument("--cap", type=int, default=1024)
    ap.add_argument("--bounded-only", action="store_true",
                    help="trace without unbounded-?P ops")
    ap.add_argument("--fast", action="store_true", help="tiny smoke-test trace")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the serving row as JSON ({'serving': [...]})")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    kw = dict(
        device=args.device, n_triples=args.triples, n_preds=args.preds,
        like=args.like, n_tenants=args.tenants, n_queries=args.queries,
        zipf_a=args.zipf, cap=args.cap, max_batch=args.batch,
        deadline_ms=args.deadline_ms, unbounded=not args.bounded_only,
        seed=args.seed,
    )
    if args.fast:
        kw.update(n_triples=20_000, n_preds=16, n_queries=256, max_batch=64,
                  cap=256, warmup=32)
    row = run_bench(**kw)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"serving": [row]}, fh, indent=2, default=float)
        print(f"# wrote {args.json}")


if __name__ == "__main__":
    main()
