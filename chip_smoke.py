#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--triples 9415253]

Phases (any failure exits non-zero before the result line):

1. refuse to run without a CUDA card or outside a checkout; print the card;
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` each, in parallel) and print ptxas registers / smem / spills;
3. hold each kernel against its plain torch version on the card, bit for
   bit: a 600-predicate store (two-level DAC, 2-byte predicate ids), a
   cap-overflow case, and the single-tree (P=1) check;
4. build the geonames-sized store (paper Table 1) from ``--seed``, capture
   the kernel inputs of one 256-lane serve step, and hold every kernel
   against its plain version on exactly those main-path inputs;
5. the main path: ``Engine`` + ``ServeBroker`` (cap 1024, batch 256, 2 ms
   deadline) serve a 4096-query, 8-tenant Zipf(1.1) trace after warmup,
   with every launch counter reset just before; every query must be
   answered, every kernel launched, and 512 sampled lanes must match a
   numpy oracle over the dataset's id triples;
6. time each kernel at the main-path shapes (CUDA events around calls
   enqueued behind a sleep kernel, so host launch overhead is excluded;
   the wrapper's back-to-back time is reported beside it), time its plain
   version back to back, and print the ``{"kernels": [...]}`` line, the card's
   name and power limit, and the final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GEONAMES_TRIPLES = 9_415_253
# NVIDIA H100 SXM data sheet: HBM3 bandwidth; the 67 TFLOP/s fp32 non-tensor
# rate stands in as the peak of 32-bit integer ALU operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
CSRC = "src/repro_torch/kernels/csrc"
KERNELS = {
    "k2_scan": dict(source=f"{CSRC}/k2_scan.cu", replaces="src/repro/kernels/k2_scan.py:169"),
    "k2_check": dict(source=f"{CSRC}/k2_check.cu", replaces="src/repro/kernels/k2_check.py:85"),
    "pred_gather_dac": dict(source=f"{CSRC}/pred_gather_dac.cu",
                            replaces="src/repro/kernels/pred_gather.py:218"),
}


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str):
    print(f"== {name}", flush=True)


def cuda_device():
    import torch

    return torch.device("cuda", torch.cuda.current_device())


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def plain_of(name, meta_or_pmeta, store_part, args, kw):
    """Run the plain version of kernel ``name`` on a wrapper's arguments."""
    from repro_torch.kernels import ref

    if name == "k2_scan":
        f = store_part
        preds, keys, axes = args
        return ref.k2_scan_ref(meta_or_pmeta, f.t_words, f.t_rank, f.l_words,
                               f.ones_before, f.level_start, preds, keys, axes,
                               cap=kw["cap"])
    if name == "k2_check":
        f = store_part
        preds, rows, cols = args
        return ref.k2_check_ref(meta_or_pmeta, f.t_words, f.t_rank, f.l_words,
                                f.ones_before, f.level_start, preds, rows, cols)
    pm, ix = meta_or_pmeta, store_part
    (rows,) = args
    return ref.pred_gather_dac_ref(
        rows, ix.offsets, ix.words, ix.degs, ix.flags, ix.frank,
        levels=pm.levels, level_byte_start=pm.level_byte_start,
        flag_word_start=pm.flag_word_start, deg_width=pm.deg_width,
        rows_per_block=pm.rows_per_block, cap=kw["cap"],
    )


def max_abs_err(got, want) -> int:
    """Largest elementwise difference (0 = bit-exact); shapes/dtypes must match."""
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"shape/dtype mismatch {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item()) if g.numel() else 0)
    return err


class Recorder:
    """Wraps the three ops wrappers: records every call's inputs and holds
    the kernel's output against the plain version on the same inputs."""

    def __init__(self):
        from repro_torch.kernels import ops

        self.ops = ops
        self.calls: dict[str, list] = {k: [] for k in KERNELS}
        self.err: dict[str, int] = dict.fromkeys(KERNELS, 0)
        self.orig = {k: getattr(ops, k) for k in KERNELS}

    def check(self, name, a, b, args, kw, out):
        want = plain_of(name, a, b, args, kw)
        self.err[name] = max(self.err[name], max_abs_err(out, want))
        return out

    def __enter__(self):
        def make(name):
            orig = self.orig[name]

            def wrapped(a, b, *args, **kw):
                out = orig(a, b, *args, **kw)
                self.calls[name].append((a, b, args, kw, out))
                return self.check(name, a, b, args, kw, out)

            return wrapped

        for name in KERNELS:
            setattr(self.ops, name, make(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


def small_store_checks(device, seed: int) -> dict[str, int]:
    """600-predicate store (two-level DAC, bpp=2), cap overflow, and P=1."""
    import numpy as np
    import torch

    from repro_torch.core import k2triples
    from repro_torch.data import rdf
    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    rec = Recorder()

    def build(n_preds, n):
        ds = rdf.generate(n, n_subjects=n // 16, n_preds=n_preds, n_objects=n // 16,
                          pred_alpha=1.0, seed=seed)
        return ds, k2triples.from_id_triples(
            ds.ids, n_so=ds.n_so, n_subjects=ds.n_subjects, n_objects=ds.n_objects,
            n_preds=ds.n_preds, device=device,
        )

    def lanes(lo, hi, q):
        return torch.from_numpy(rng.integers(lo, hi, q).astype(np.int32)).to(device)

    ds, st = build(600, 40_000)
    dev, pm = st.pred_index.select("dac")
    if pm.levels < 2 or pm.bytes_per_pred != 2:
        fail(f"600-predicate store has levels={pm.levels}, bytes_per_pred={pm.bytes_per_pred}")
    f, meta, q = st.forest, st.meta, 2048
    with rec:
        for cap in (1024, 2):  # cap 2 < k0: overflow on every non-empty lane
            r = ops.k2_scan(meta, f, lanes(-650, 650, q), lanes(-9, meta.side + 9, q),
                            lanes(0, 2, q), cap=cap)
            if cap == 2 and not bool(r[3].any()):
                fail("the cap-overflow case did not overflow")
        rows = ds.ids[rng.integers(0, ds.n_triples, q)]
        t = torch.from_numpy((rows - 1).astype(np.int32)).to(device)
        ops.k2_check(meta, f, t[:, 1].contiguous(), t[:, 0].contiguous(), t[:, 2].contiguous())
        ops.k2_check(meta, f, lanes(-650, 650, q), lanes(-9, meta.side, q), lanes(-9, meta.side, q))
        n_rows = st.n_subjects + st.n_objects
        for cap in (pm.max_degree, 3):
            ops.pred_gather_dac(pm, dev, lanes(0, n_rows, q), cap=cap)
        ds1, st1 = build(1, 20_000)
        rows = ds1.ids[rng.integers(0, ds1.n_triples, q)]
        t = torch.from_numpy((rows - 1).astype(np.int32)).to(device)
        hit = ops.k2_check(st1.meta, st1.forest, torch.zeros_like(t[:, 1]),
                           t[:, 0].contiguous(), t[:, 2].contiguous())
        if not bool(hit.all()):
            fail("single-tree check missed a stored triple")
    print(f"small stores: max_abs_err {rec.err}", flush=True)
    return rec.err


# ---------------------------------------------------------------------------
# the numpy oracle over the dataset's id triples
# ---------------------------------------------------------------------------


class Oracle:
    def __init__(self, ids):
        import numpy as np

        self.np = np
        self.by_s = ids[np.lexsort((ids[:, 2], ids[:, 1], ids[:, 0]))]
        self.by_o = ids[np.lexsort((ids[:, 0], ids[:, 1], ids[:, 2]))]

    def _slice(self, arr, col, v):
        lo, hi = self.np.searchsorted(arr[:, col], [v, v + 1])
        return arr[lo:hi]

    def answer(self, op, s, p, o):
        np = self.np
        if op in (0, 1, 3, 5):
            r = self._slice(self.by_s, 0, s)
            if op == 0:
                return bool(((r[:, 1] == p) & (r[:, 2] == o)).any())
            if op == 1:
                return r[r[:, 1] == p, 2]
            if op == 3:
                return {int(q): r[r[:, 1] == q, 2] for q in np.unique(r[:, 1])}
            return np.unique(r[r[:, 2] == o, 1])
        r = self._slice(self.by_o, 2, o)
        if op == 2:
            return r[r[:, 1] == p, 0]
        return {int(q): r[r[:, 1] == q, 0] for q in np.unique(r[:, 1])}


def same_answer(a, b) -> bool:
    import numpy as np

    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(
            np.array_equal(a[k], b[k]) for k in b
        )
    if isinstance(b, bool):
        return bool(a) == b
    return np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def wrapper_ms(fn, iters: int) -> float:
    """Per-call time of back-to-back calls, host launch overhead included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int) -> float:
    """Device time per call.  A sleep kernel holds the stream while every
    call is enqueued, so the events bracket device work only; the sleep is
    sized from the host time of one call and the hold is verified."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(4e9 * max(host_s * iters, 1e-3))
    for _ in range(4):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / iters
        cycles *= 4
    fail("could not hold the stream while enqueuing the timed calls")


def bound(name, meta_or_pmeta, out) -> tuple[float, str, int, int]:
    """Least time for this call's work: (bound_ms, bound_by, bytes, ops).

    Bytes: lane inputs read once, outputs written once, plus the arena
    bytes this data needs (see PERF.md); ops: 32-bit ALU operations.
    """
    import numpy as np

    if name == "k2_scan":
        meta = meta_or_pmeta
        ids, valid = out[0].cpu().numpy(), out[1].cpu().numpy()
        q, cap = ids.shape
        lane = np.nonzero(valid)[0].astype(np.int64)
        vid = ids[valid].astype(np.int64)
        arena, cand = 4 * q, 0  # each lane reads its root word
        for lvl in range(meta.n_levels - 1):
            sub = meta.subsides[lvl]
            n_l = np.unique(lane * (meta.side // sub + 1) + vid // sub).size
            arena += n_l * (4 + meta.radices[lvl + 1] / 8)  # rank + child bits
            cand += n_l * meta.ks[lvl + 1]
        nbytes = 12 * q + 5 * q * cap + 5 * q + arena
        ops_ = 25 * cand + 2 * q * cap
    elif name == "k2_check":
        meta = meta_or_pmeta
        hit = out.cpu().numpy()
        q = hit.size
        nbytes = 13 * q + hit.sum() * meta.n_levels * 8 + (q - hit.sum()) * 4
        ops_ = 25 * meta.n_levels * hit.sum() + 25 * (q - hit.sum())
    else:
        pm = meta_or_pmeta
        count = out[2].cpu().numpy().clip(min=0)
        q, cap = out[0].shape
        nbytes = 4 * q + 5 * q * cap + 5 * q + 8 * q + count.sum() * (1 + 4 * (pm.levels - 1))
        ops_ = 10 * q * cap + 10 * count.sum() * pm.levels
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops_ / PEAK_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            int(nbytes), int(ops_))


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--triples", type=int, default=GEONAMES_TRIPLES,
                    help="geonames-like corpus size (default: the paper's full size)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    phase("1. device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs an NVIDIA card")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (src/repro_torch missing)")
    from repro_torch.core import engine as eng, k2triples
    from repro_torch.core.query import ServeQ
    from repro_torch.data import rdf
    from repro_torch.kernels import build, ops
    from repro_torch.launch import serve

    device = cuda_device()
    card = gpu_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    phase("2. build kernels")
    t0 = time.perf_counter()
    build.load_all()
    print(f"built {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f}s", flush=True)
    for name, log in build.ptxas_report().items():
        info = [ln.split("info    : ")[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"ptxas {name}: {'; '.join(info)}", flush=True)

    phase("3. kernels vs plain on small stores")
    err = small_store_checks(device, args.seed)

    phase("4. geonames store and main-path kernel inputs")
    t0 = time.perf_counter()
    ds = rdf.generate_like("geonames", args.triples, seed=args.seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = k2triples.from_id_triples(
        ds.ids, n_so=ds.n_so, n_subjects=ds.n_subjects, n_objects=ds.n_objects,
        n_preds=ds.n_preds, device=device,
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    pm = store.pred_index.meta
    f = store.forest
    print(
        f"store: {store.n_triples} triples, {store.n_preds} preds, "
        f"{store.n_subjects} subjects, {store.n_objects} objects, ks={store.meta.ks}, "
        f"t_words {tuple(f.t_words.shape)}, l_words {tuple(f.l_words.shape)}, "
        f"max_degree {pm.max_degree}, DAC levels {pm.levels}; "
        f"generated in {gen_s:.1f}s, built in {build_s:.1f}s",
        flush=True,
    )
    engine = eng.Engine(store, device=device)
    n_queries, n_tenants, cap, max_batch = 4096, 8, 1024, 256
    trace = serve.make_trace(ds, n_queries, n_tenants, zipf_a=1.1, seed=args.seed + 1)
    plan = engine.compile(ServeQ(), engine.default_config.replace(cap=cap))
    lanes = np.array([row[1:] for row in trace[:max_batch]], np.int32).T
    rec = Recorder()
    with rec:
        eng.host_result(plan.submit(eng.ServeBatch(*lanes)))
    for name in KERNELS:
        err[name] = max(err[name], rec.err[name])
        shapes = [tuple(c[4][0].shape) if isinstance(c[4], tuple) else tuple(c[4].shape)
                  for c in rec.calls[name]]
        print(f"main-path inputs {name}: calls {shapes}, max_abs_err {rec.err[name]}", flush=True)
    if any(err.values()):
        fail(f"kernels disagree with their plain versions: {err}")

    phase("5. main path: broker over the geonames store")
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launches()
    stats, answers, wall = serve.serve_trace(
        engine, trace, n_tenants=n_tenants, cap=cap, max_batch=max_batch,
        deadline_ms=2.0, warmup=64,
    )
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    mem = torch.cuda.max_memory_allocated(device)
    unanswered = sum(a is None for a in answers)
    if len(answers) != n_queries or unanswered:
        fail(f"{unanswered} of {n_queries} queries unanswered")
    print(
        f"served {n_queries} queries in {wall:.3f}s: {n_queries / wall:.1f} qps, "
        f"p50 {stats['p50_ms']} ms, p99 {stats['p99_ms']} ms, "
        f"{stats['batches']} batches (coalesce x{stats['coalesce_factor']:.1f}), "
        f"{stats['cap_growth_events']} cap growths, {stats['shed']} shed; "
        f"max_memory_allocated {mem} bytes; launches {launches}",
        flush=True,
    )
    if not all(launches[k] > 0 for k in KERNELS):
        fail(f"a kernel of the main path never launched: {launches}")

    oracle = Oracle(ds.ids)
    rng = np.random.default_rng(args.seed + 2)
    sample = rng.choice(n_queries, 512, replace=False)
    ops_seen = {trace[i][1] for i in sample}
    if ops_seen != set(range(6)):
        fail(f"the oracle sample covers ops {sorted(ops_seen)}, not all six")
    bad = [int(i) for i in sample if not same_answer(answers[i], oracle.answer(*trace[i][1:]))]
    if bad:
        fail(f"{len(bad)} of 512 sampled lanes disagree with the oracle, e.g. {trace[bad[0]]}")
    print("oracle: 512 sampled lanes (all six ops) match", flush=True)

    phase("6. kernel times at the main-path shapes")
    rows = []
    for name in KERNELS:
        best = None
        shapes = {}
        for a, b, cargs, kw, out in rec.calls[name]:
            orig = rec.orig[name]
            ms = time_ms(lambda: orig(a, b, *cargs, **kw), 50)
            wrapped = wrapper_ms(lambda: orig(a, b, *cargs, **kw), 50)
            # the plain version enqueues hundreds of small kernels per call,
            # more than the launch queue holds behind a sleep: timed back to
            # back, host launch overhead included
            plain = wrapper_ms(lambda: plain_of(name, a, b, cargs, kw), 5)
            b_ms, by, nbytes, nops = bound(name, a, out)
            q = cargs[0].shape[0]
            shapes[f"Q={q}" + (f",cap={kw['cap']}" if "cap" in kw else "")] = dict(
                ms=ms, wrapper_ms=wrapped, plain_ms=plain, bound_ms=b_ms,
                bound_by=by, bytes=nbytes, ops=nops)
            if best is None or q > best[0]:
                best = (q, ms, plain, b_ms, by)
        _, ms, plain, b_ms, by = best
        rows.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=launches[name],
            max_abs_err=err[name], ms=ms, plain_ms=plain, bound_ms=b_ms,
            bound_by=by, library_ms=None, shapes=shapes,
        ))
    print(json.dumps({"kernels": rows}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
