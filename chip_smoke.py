#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--triples 9415253]

Phases (any failure exits non-zero before the result line):

1. refuse to run without a CUDA card or outside a checkout; print the card;
2. build the nine CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` each, in parallel) and the empty ``launch_floor`` kernel, print
   ptxas registers / smem / spills, fail if the warp-per-lane kernels spill
   (``k2_scan``, ``k2_scan_rebind``, ``k2_check``, ``pred_gather_dac``),
   and fail unless ``cuobjdump -sass`` of the
   ``block_spmm`` library shows ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA
   load) instructions;
3. hold each kernel against its plain torch version on the card, bit for
   bit: a 600-predicate store (two-level DAC, 2-byte predicate ids), a
   20-predicate store (1-byte ids), cap-overflow cases, predicates out of
   range on both sides, dead X slots of the re-bind, and the single-tree
   (P=1) check;
4. build the geonames-sized store (paper Table 1) from ``--seed``, capture
   the kernel inputs of one 256-lane serve step, and hold every kernel
   against its plain version on exactly those main-path inputs;
5. the main path: ``Engine`` + ``ServeBroker`` (cap 1024, batch 256, 2 ms
   deadline) serve a 4096-query, 8-tenant Zipf(1.1) trace after warmup,
   with every launch counter reset just before; every query must be
   answered, every serve kernel launched, and 512 sampled lanes must match
   a numpy oracle over the dataset's id triples;
5b. the pattern and join path over the same store, run once with every
   kernel call held against its plain version, then again with the launch
   counters reset just before: the six serve-lane triple patterns batched
   at 256 queries under both SP/OP index layouts, (?S,P,?O) for every
   predicate in one batch and the dump at cap 2^20, and join categories
   A-F over the four (vpos1, vpos2) pairs, 8 queries each (cap 1024,
   cap_y 256); every answer must match the numpy oracle, every kernel of
   the path must have launched, and each shape's and category's host-clock
   latency is printed;
6. time each path kernel at every distinct shape recorded on the serve
   step and in phase 5b, ``k2_scan``, ``k2_check`` and ``pred_gather_dac``
   also at Q=1 (one lane's latency) (CUDA events around calls enqueued
   behind a sleep kernel, so host launch overhead is excluded; the
   wrapper's back-to-back time is reported beside it) and its plain
   version back to back, and its device and bound ms summed over every
   recorded call of the serve step and of phase 5b; then the launch floor,
   an empty kernel timed the same way;
7. kernel entry points: first at small sizes against their plain versions
   (``popcount`` also on an unaligned view; ``sorted_intersect_mask`` with
   cb = 1, 3, a power of two, negative ids, ids above max(b), repeated
   values; ``block_spmm`` in f32 and bf16, block sizes below and above 128,
   NaN in a masked-off tile, negative mask entries), after phases 5 and 5b
   so that cuBLAS's workspace stays out of their memory peak; then at
   store scale, with the launch counters reset just before: ``ops.popcount`` over the geonames ``t_words`` and ``l_words``
   arenas (flattened, zero-padded to (M, 1024)), whose per-tree exclusive
   cumsum must rebuild ``t_rank`` exactly; ``ops.sorted_intersect_mask`` on
   2^16 ids in 2^18 drawn from 10^7, on the subjects of the two largest
   predicates, and on every (A, B row) that ``sortedset.intersect``
   received in phase 5b's joins A-C (the mask must keep exactly its
   lanes); ``ops.block_spmm`` at M = K = 1024, D = 512 and M = K = 16384,
   D = 256 in f32 and bf16, 0/1 A at 5%, masks from ``mask_from_k2_level``
   through both branches at 25% of tiles, NaN in a masked-off tile; each
   against its plain version (``block_spmm`` within ``K·2^-24·(|A|@|X|) +
   1e-6`` and within the statistical ``sqrt(K)·2^-24·(|A|@|X|) + 1e-6``
   that separates f32 products from TF32 ones), each ``block_spmm`` case
   with the variant (kernel, tile rows, tile columns, k chunk, threads) that
   ``ops.block_spmm_variant`` chose for it, timed as in phase 6 beside one
   PyTorch call (``torch.isin``, ``torch.matmul``) where there is one.  Then the
   ``{"kernels": [...]}`` line, the card's name and power limit, and the
   final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GEONAMES_TRIPLES = 9_415_253
# NVIDIA H100 SXM data sheet: HBM3 bandwidth; the 67 TFLOP/s fp32 non-tensor
# rate stands in as the peak of 32-bit integer ALU operations; the dense
# bf16 tensor-core rate bounds a bf16 product
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
PEAK_BF16_FLOPS = 989e12
# 32-bit operations a traversal needs per child bit it tests: the bit's
# position, the word shift, the mask and the compaction's prefix-sum add
OPS_PER_CANDIDATE = 4
CSRC = "src/repro_torch/kernels/csrc"
KERNELS = {
    "k2_scan": dict(source=f"{CSRC}/k2_scan.cu", replaces="src/repro/kernels/k2_scan.py:169"),
    "k2_check": dict(source=f"{CSRC}/k2_check.cu", replaces="src/repro/kernels/k2_check.py:85"),
    "pred_gather_dac": dict(source=f"{CSRC}/pred_gather_dac.cu",
                            replaces="src/repro/kernels/pred_gather.py:218"),
    "pred_gather": dict(source=f"{CSRC}/pred_gather.cu",
                        replaces="src/repro/kernels/pred_gather.py:85"),
    "k2_range": dict(source=f"{CSRC}/k2_range.cu", replaces="src/repro/kernels/k2_range.py:128"),
    "k2_scan_rebind": dict(source=f"{CSRC}/k2_scan_rebind.cu",
                           replaces="src/repro/kernels/k2_scan.py:269"),
    "popcount": dict(source=f"{CSRC}/popcount.cu", replaces="src/repro/kernels/popcount.py:40"),
    "sorted_intersect_mask": dict(source=f"{CSRC}/sorted_intersect.cu",
                                  replaces="src/repro/kernels/sorted_intersect.py:46"),
    "block_spmm": dict(source=f"{CSRC}/block_spmm.cu",
                       replaces="src/repro/kernels/block_spmm.py:48"),
}
SERVE_KERNELS = ("k2_scan", "k2_check", "pred_gather_dac")  # the broker's path
QUERY_KERNELS = SERVE_KERNELS + ("pred_gather", "k2_range", "k2_scan_rebind")  # patterns, joins
OPS_KERNELS = ("popcount", "sorted_intersect_mask", "block_spmm")  # entry points only
PAIR_CAP = 1 << 20  # holds the largest geonames predicate (775,682 pairs)
SPMM_SHAPES = ((1024, 1024, 512), (16384, 16384, 256))  # (M, K, D): the bench's, then large
SENTINEL = 2**31 - 1


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


def sass_check(build) -> None:
    """Fail unless the built ``block_spmm`` library holds tensor-core
    (``HGMMA``) and TMA load (``UTMALDG``) instructions."""
    lib = build.build_all(["block_spmm"])["block_spmm"]
    tool = Path(build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    print(f"sass block_spmm: {counts}", flush=True)
    if not all(counts.values()):
        fail(f"block_spmm's SASS lacks wgmma or TMA instructions: {counts}")


def spill_check(build) -> None:
    """Fail if ptxas spilled registers of a warp-per-lane kernel (its lane
    state must stay in registers)."""
    for name in ("k2_scan", "k2_scan_rebind", "k2_check", "pred_gather_dac"):
        log = build.ptxas_report().get(name)
        if log is None:
            print(f"spills {name}: built by an earlier process, no ptxas report", flush=True)
            continue
        spilled = [int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
        if not spilled or any(spilled):
            fail(f"ptxas spill report for {name}: {spilled}")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def plain_of(name, args, kw):
    """Run the plain version of kernel ``name`` on a wrapper's arguments.

    ``k2_range`` runs one lane at a time: at cap 2^20 its cap·k²
    temporaries for a whole batch would not fit on the card.
    """
    import torch

    from repro_torch.kernels import ref

    if name == "popcount":
        return ref.popcount_ref(*args)
    if name == "sorted_intersect_mask":
        return ref.sorted_intersect_mask_ref(*args)
    if name == "block_spmm":
        return ref.block_spmm_ref(*args, kw.get("block_m", 128), kw.get("block_k", 128))
    meta_or_pmeta, store_part, args = args[0], args[1], args[2:]
    if name in ("pred_gather", "pred_gather_dac"):
        pm, ix = meta_or_pmeta, store_part
        (rows,) = args
        if name == "pred_gather":
            return ref.pred_gather_ref(rows, ix.offsets, ix.words,
                                       bytes_per_pred=pm.bytes_per_pred, cap=kw["cap"])
        return ref.pred_gather_dac_ref(
            rows, ix.offsets, ix.words, ix.degs, ix.flags, ix.frank,
            levels=pm.levels, level_byte_start=pm.level_byte_start,
            flag_word_start=pm.flag_word_start, deg_width=pm.deg_width,
            rows_per_block=pm.rows_per_block, cap=kw["cap"],
        )
    meta, f = meta_or_pmeta, store_part
    arenas = (f.t_words, f.t_rank, f.l_words, f.ones_before, f.level_start)
    if name == "k2_scan":
        return ref.k2_scan_ref(meta, *arenas, *args, cap=kw["cap"])
    if name == "k2_check":
        return ref.k2_check_ref(meta, *arenas, *args)
    if name == "k2_scan_rebind":
        return ref.k2_scan_rebind_ref(meta, *arenas, *args, **kw)
    (preds,) = args
    lanes = [ref.k2_range_ref(meta, *arenas, preds[i:i + 1], cap=kw["cap"])
             for i in range(preds.shape[0])]
    return tuple(torch.cat(parts) for parts in zip(*lanes))


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
    """Wraps the path kernels' ops wrappers: records every call's inputs and
    holds the kernel's output against the plain version on the same inputs.
    Also records every (A ids, B row ids, kept ids) that
    ``sortedset.intersect`` computes, one entry per row of B's batch."""

    def __init__(self):
        from repro_torch.core import sortedset
        from repro_torch.kernels import ops

        self.ops, self.sortedset = ops, sortedset
        self.calls: dict[str, list] = {k: [] for k in QUERY_KERNELS}
        self.err: dict[str, int] = dict.fromkeys(QUERY_KERNELS, 0)
        self.orig = {k: getattr(ops, k) for k in QUERY_KERNELS}
        self.orig_intersect = sortedset.intersect
        self.intersects: list = []

    def check(self, name, args, kw, out):
        want = plain_of(name, args, kw)
        self.err[name] = max(self.err[name], max_abs_err(out, want))
        return out

    def intersect(self, a, b):
        out = self.orig_intersect(a, b)
        if a.ids.dim() != 1:
            fail(f"sortedset.intersect got a batched A {tuple(a.ids.shape)}")
        b_ids = b.ids.reshape(-1, b.ids.shape[-1])
        ids = out.ids.reshape(b_ids.shape[0], -1)
        valid = out.valid.reshape(b_ids.shape[0], -1)
        for i in range(b_ids.shape[0]):
            self.intersects.append((a.ids, b_ids[i].contiguous(), ids[i][valid[i]]))
        return out

    def __enter__(self):
        def make(name):
            orig = self.orig[name]

            def wrapped(*args, **kw):
                out = orig(*args, **kw)
                self.calls[name].append((args, kw, out))
                return self.check(name, args, kw, out)

            return wrapped

        for name in QUERY_KERNELS:
            setattr(self.ops, name, make(name))
        self.sortedset.intersect = self.intersect
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)
        self.sortedset.intersect = self.orig_intersect


def small_store_checks(device, seed: int) -> dict[str, int]:
    """600-predicate store (two-level DAC, bpp=2), 20-predicate store
    (bpp=1), cap overflow, out-of-range predicates, dead X slots, P=1."""
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
        # fixed-layout gather at 2 bytes per predicate, then range and
        # re-bind with predicates out of range on both sides
        fdev, fpm = st.pred_index.select("fixed")
        if fpm.bytes_per_pred != 2:
            fail(f"600-predicate store has fixed bytes_per_pred={fpm.bytes_per_pred}")
        for cap in (fpm.max_degree, 3):
            ops.pred_gather(fpm, fdev, lanes(0, n_rows, q), cap=cap)
        wild = lanes(-1300, 1300, 256)
        largest = int(np.bincount(ds.ids[:, 1]).max())
        for cap in (largest, 16):  # exact fit, then overflow
            r = ops.k2_range(meta, f, wild, cap=cap)
            if bool(r[4].any()) != (cap == 16):
                fail(f"k2_range overflow flags at cap {cap}: {int(r[4].sum())} lanes")
        rows = ds.ids[rng.integers(0, ds.n_triples, 256)]
        t = torch.from_numpy((rows - 1).astype(np.int32)).to(device)
        axes1 = lanes(0, 2, 256)
        keys1 = torch.where(axes1 == 0, t[:, 0], t[:, 2]).contiguous()
        for cap_x, cap_y in ((64, 16), (8, 2)):  # cap_y 2 < k0: Y overflow
            r = ops.k2_scan_rebind(meta, f, t[:, 1].contiguous(), keys1, axes1,
                                   lanes(-1300, 1300, 256), lanes(0, 2, 256),
                                   cap_x=cap_x, cap_y=cap_y)
            if not (bool((~r[1]).any()) and bool(r[1].any())):
                fail("the re-bind case has no dead (or no live) X slots")
            if cap_y == 2 and not bool(r[7].any()):
                fail("the cap_y-overflow case did not overflow")
        ds20, st20 = build(20, 40_000)
        fdev, fpm = st20.pred_index.select("fixed")
        if fpm.bytes_per_pred != 1:
            fail(f"20-predicate store has bytes_per_pred={fpm.bytes_per_pred}")
        n_rows = st20.n_subjects + st20.n_objects
        for cap in (fpm.max_degree, 2):
            ops.pred_gather(fpm, fdev, lanes(-5, n_rows + 5, q).clamp(0, n_rows - 1), cap=cap)
        r = ops.k2_range(st20.meta, st20.forest, lanes(-45, 45, 64), cap=64)
        if not bool(r[4].any()):
            fail("k2_range at cap 64 on the 20-predicate store did not overflow")
        ds1, st1 = build(1, 20_000)
        rows = ds1.ids[rng.integers(0, ds1.n_triples, q)]
        t = torch.from_numpy((rows - 1).astype(np.int32)).to(device)
        hit = ops.k2_check(st1.meta, st1.forest, torch.zeros_like(t[:, 1]),
                           t[:, 0].contiguous(), t[:, 2].contiguous())
        if not bool(hit.all()):
            fail("single-tree check missed a stored triple")
    print(f"small stores: max_abs_err {rec.err}", flush=True)
    return rec.err


def spmm_check(args, kw, got) -> tuple[float, float, float]:
    """``block_spmm``'s output against its plain version: finite, within
    the rigorous ``K·2^-24·(|A|@|X|) + 1e-6`` elementwise (f32 accumulation
    of the same products in two orders; |A| over the ON tiles only), and
    within the statistical ``sqrt(K)·2^-24·(|A|@|X|) + 1e-6`` (rounding
    errors of an f32 sum add like a random walk; products rounded to TF32,
    2^-11, exceed it).  Returns (max_abs_err, worst ratio to each limit)."""
    import torch

    mask, a, x = args
    bm, bk = kw.get("block_m", 128), kw.get("block_k", 128)
    want = plain_of("block_spmm", args, kw)
    if got.dtype != torch.float32 or got.shape != want.shape:
        fail(f"block_spmm gave {got.dtype}{tuple(got.shape)}, want float32{tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail("block_spmm output is not finite")
    on = mask.repeat_interleave(bm, 0).repeat_interleave(bk, 1) != 0
    absprod = torch.where(on, a.float().abs(), 0.0) @ x.float().abs()
    err = (got - want).abs()
    k = a.shape[1]
    ratio = float((err / (k * 2.0**-24 * absprod + 1e-6)).max().item())
    stat = float((err / (k**0.5 * 2.0**-24 * absprod + 1e-6)).max().item())
    if ratio > 1 or stat > 1:
        fail(f"block_spmm is {ratio:.3f}x its error bound and {stat:.3f}x its statistical limit")
    return float(err.max().item()), ratio, stat


def ops_small_checks(device, seed: int) -> dict:
    """The three entry-point kernels at small sizes against their plain
    versions: the integer ones bit for bit (also against numpy),
    ``block_spmm`` within its bound.  Returns max_abs_err by kernel."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    rng = np.random.default_rng(seed)
    err = dict.fromkeys(OPS_KERNELS, 0)
    for m, n in ((8, 128), (16, 256), (32, 512), (8, 1024), (24, 256)):
        w = rng.integers(0, 2**32, (m, n), dtype=np.uint32)
        t = torch.from_numpy(w.view(np.int32)).to(device)
        # the arena, and a view of it that is not 16-byte aligned
        views = [t]
        if t.numel() > 8 * 128:
            views.append(t.reshape(-1)[1:1 + 8 * 128].reshape(8, 128))
        for words in views:
            got = ops.popcount(words)
            err["popcount"] = max(err["popcount"], max_abs_err(got, plain_of("popcount", (words,), {})))
        want = np.unpackbits(w.view(np.uint8), axis=1).reshape(m, n, 32).sum(-1)
        if not np.array_equal(ops.popcount(t).cpu().numpy(), want):
            fail("popcount disagrees with numpy")
    cases = [
        ([-3, 4, 9, SENTINEL], [4]), ([1, 2, 5, 7, 8, 11, 12, SENTINEL], [2, 7, 11]),
        ([0, 3, 4, SENTINEL], [0, 3, 6, 9, 12, 15, SENTINEL, SENTINEL]),  # b[1] of 2^k lanes
        ([-2**31, -900, -5, -1, 0, 3, 4, 6], [-2**31, -901, -5, 0, 4, SENTINEL]),
        ([10, 20, 30, 40, 1000, 2**31 - 2, SENTINEL, SENTINEL], [10, 30, 35]),
        ([1, 3, 5, 7, 9, 11, 13, 15], [3, 3, 3, 7, 7, 9, 15, 15, 15, SENTINEL]),
    ]
    for ca, cb in ((2048, 1024), (4096, 3000)):
        b = np.sort(rng.choice(20_000, cb, replace=False) - 10_000)
        a = np.union1d(rng.choice(b, ca // 4), rng.integers(-12_000, 12_000, ca // 2))
        cases.append((np.concatenate([a, np.full(ca - a.size, SENTINEL)]), b))
    for a, b in cases:
        a, b = np.asarray(a, np.int32), np.asarray(b, np.int32)
        ta, tb = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
        got = ops.sorted_intersect_mask(ta, tb)
        e = max_abs_err(got, plain_of("sorted_intersect_mask", (ta, tb), {}))
        err["sorted_intersect_mask"] = max(err["sorted_intersect_mask"], e)
        if not np.array_equal(got.cpu().numpy(), np.isin(a, b) & (a != SENTINEL)):
            fail(f"sorted_intersect_mask disagrees with numpy on {a[:8]}... in {b[:8]}...")
    g = torch.Generator(device=device).manual_seed(seed)
    worst = [0.0, 0.0]
    for (m, k, d), blocks in (((256, 256, 128), (128, 128, 128)), ((512, 384, 256), (128, 128, 128)),
                              ((512, 768, 256), (256, 64, 128)), ((256, 192, 256), (64, 32, 128)),
                              ((240, 120, 96), (48, 24, 96))):  # edges inside a 128 tile
        bm, bk, bd = blocks
        kw = dict(block_m=bm, block_k=bk, block_d=bd)
        mask = (torch.rand((m // bm, k // bk), generator=g, device=device) < 0.5).to(torch.int32)
        mask[0, 0], mask[-1, -1] = -2, 0
        a = (torch.rand((m, k), generator=g, device=device) < 0.05).float()
        a[-bm:, -bk:] = float("nan")  # a masked-off tile
        x = torch.randn((k, d), generator=g, device=device)
        for dtype in (torch.float32, torch.bfloat16):
            args = (mask, a.to(dtype), x.to(dtype))
            e, *ratios = spmm_check(args, kw, ops.block_spmm(*args, **kw))
            err["block_spmm"] = max(err["block_spmm"], e)
            worst = [max(w, r) for w, r in zip(worst, ratios)]
    # Inf in X's second K band, which is on for row bands 0 and 3 only: in
    # one 128-row tile some rows meet it and some must not
    mask = torch.tensor([[1, 1], [1, 0], [1, 0], [1, 1], [1, 0]], dtype=torch.int32, device=device)
    a = torch.ones((240, 48), device=device)
    x = torch.randn((48, 96), generator=g, device=device)
    x[24:] = float("inf")
    kw = dict(block_m=48, block_k=24, block_d=96)
    for dtype in (torch.float32, torch.bfloat16):
        args = (mask, a.to(dtype), x.to(dtype))
        got, want = ops.block_spmm(*args, **kw), plain_of("block_spmm", args, kw)
        fin = torch.isfinite(want)
        x_fin = args[2].float().nan_to_num(posinf=0.0)  # what the finite rows meet
        limit = 48 * 2.0**-24 * (a @ x_fin.abs()) + 1e-6
        if (not torch.equal(torch.isfinite(got), fin) or not torch.equal(got[~fin], want[~fin])
                or bool(((got - want).abs()[fin] > limit[fin]).any())):
            fail(f"block_spmm lets an Inf of X into rows whose tile is off ({dtype})")
    print(f"entry-point kernels, small: max_abs_err {err}, block_spmm worst ratio "
          f"{worst[0]:.4f} of its bound, {worst[1]:.4f} of its statistical limit", flush=True)
    return err


# ---------------------------------------------------------------------------
# the numpy oracle over the dataset's id triples
# ---------------------------------------------------------------------------


class Oracle:
    """Answers from the dataset's id triples with numpy: the serve ops, the
    pair patterns and the join categories, independent of the port."""

    def __init__(self, ids):
        import numpy as np

        self.np = np
        self.by_s = ids[np.lexsort((ids[:, 2], ids[:, 1], ids[:, 0]))]
        self.by_o = ids[np.lexsort((ids[:, 0], ids[:, 1], ids[:, 2]))]
        self.by_p = ids[np.lexsort((ids[:, 2], ids[:, 0], ids[:, 1]))]
        self.n_preds = int(ids[:, 1].max())

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

    def pairs(self, p):
        """(s, o) pairs of predicate ``p``, sorted by (s, o)."""
        return self._slice(self.by_p, 1, p)[:, [0, 2]]

    # join categories (paper Table 4): ?X sits at vpos of each pattern
    def _side(self, p, c, vpos):
        if vpos == "s":  # (?X, p, c)
            return self.answer(2, 0, p, c)
        return self.answer(1, c, p, 0)  # (c, p, ?X)

    def _side_any(self, c, vpos):
        if vpos == "s":
            return self.np.unique(self._slice(self.by_o, 2, c)[:, 0])
        return self.np.unique(self._slice(self.by_s, 0, c)[:, 2])

    def _rebind(self, p, x, vpos2):
        # ?X at vpos2 of pattern 2, ?Y at the other end
        return self.answer(1, x, p, 0) if vpos2 == "s" else self.answer(2, 0, p, x)

    def join(self, q):
        np = self.np
        preds = range(1, self.n_preds + 1)
        if q.category == "A":
            return np.intersect1d(self._side(q.p1, q.c1, q.vpos1), self._side(q.p2, q.c2, q.vpos2))
        if q.category == "B":
            a = self._side(q.p1, q.c1, q.vpos1)
            out = {pp: np.intersect1d(a, self._side(pp, q.c2, q.vpos2)) for pp in preds}
            return {pp: v for pp, v in out.items() if v.size}
        if q.category == "C":
            return np.intersect1d(self._side_any(q.c1, q.vpos1), self._side_any(q.c2, q.vpos2))
        xs = self._side_any(q.c1, q.vpos1) if q.category == "F" else self._side(q.p1, q.c1, q.vpos1)

        def bind(pp):
            out = {int(x): self._rebind(pp, x, q.vpos2) for x in xs}
            return {x: y for x, y in out.items() if y.size}

        if q.category == "D":
            return bind(q.p2)
        out = {pp: bind(pp) for pp in preds}
        return {pp: d for pp, d in out.items() if d}


def same_answer(a, b) -> bool:
    """Equal answers: bools, id arrays, or (nested) dicts of them."""
    import numpy as np

    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(
            same_answer(a[k], b[k]) for k in b
        )
    if isinstance(b, bool):
        return bool(a) == b
    return np.array_equal(np.asarray(a), np.asarray(b))


def same_pairs(got, want) -> bool:
    """Pair arrays equal as sets (the port emits Morton order)."""
    import numpy as np

    got = np.asarray(got)
    if got.ndim != 2 or got.shape[1:] != (2,) or got.shape[0] != want.shape[0]:
        return False
    got = got[np.lexsort((got[:, 1], got[:, 0]))]
    return np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the pattern and join path
# ---------------------------------------------------------------------------

# (name, bound mask of (s, p, o), serve op the oracle answers it with)
PATTERN_SHAPES = (
    ("(S,P,O)", (True, True, True), 0), ("(S,P,?O)", (True, True, False), 1),
    ("(?S,P,O)", (False, True, True), 2), ("(S,?P,O)", (True, False, True), 5),
    ("(S,?P,?O)", (True, False, False), 3), ("(?S,?P,O)", (False, False, True), 4),
)
JOIN_FIELDS = {
    "A": ("p1", "c1", "p2", "c2"), "B": ("p1", "c1", "c2"), "C": ("c1", "c2"),
    "D": ("p1", "c1", "p2"), "E": ("p1", "c1"), "F": ("c1",),
}
VPOS = (("s", "s"), ("s", "o"), ("o", "s"), ("o", "o"))


def query_work(ds, oracle, seed: int, batch: int = 256, per_join: int = 8) -> list:
    """The pattern and join workload: ``(label, query, config, batch)``
    items with constants drawn from real triples (join constants so that
    pattern 2 can bind pattern 1's X: most answers are non-empty)."""
    import numpy as np

    from repro_torch.core.query import ExecConfig, JoinQ, TriplePatternQ

    rng = np.random.default_rng(seed)
    ids = ds.ids
    work = []
    for layout in ("dac", "fixed"):
        cfg = ExecConfig(cap=1024, pred_index_layout=layout)
        for name, bound, _ in PATTERN_SHAPES:
            rows = ids[rng.integers(0, ds.n_triples, batch)]
            q = TriplePatternQ(*(1 if b else f"?{k}" for k, b in zip("spo", bound)))
            b = {k: rows[:, i] for i, k in enumerate("spo") if bound[i]}
            work.append((f"pattern {name} {layout}", q, cfg, b))
    big = ExecConfig(cap=PAIR_CAP)
    work.append(("pattern (?S,P,?O) all preds", TriplePatternQ("?s", 1, "?o"), big,
                 {"p": np.arange(1, ds.n_preds + 1)}))
    work.append(("pattern (?S,?P,?O) dump", TriplePatternQ("?s", "?p", "?o"), big, None))

    jcfg = ExecConfig(cap=1024, cap_y=256)
    extent = max(ds.n_subjects, ds.n_objects) + 1
    is_s = np.zeros(extent, np.bool_)
    is_o = np.zeros(extent, np.bool_)
    is_s[ids[:, 0]] = True
    is_o[ids[:, 2]] = True
    for v1, v2 in VPOS:
        x_all = ids[:, 0] if v1 == "s" else ids[:, 2]
        cand = np.nonzero((is_s if v2 == "s" else is_o)[x_all])[0]
        for cat in "ABCDEF":
            for row in ids[rng.choice(cand, per_join)]:
                s1, p1, o1 = (int(v) for v in row)
                x = s1 if v1 == "s" else o1
                arr, col = (oracle.by_s, 0) if v2 == "s" else (oracle.by_o, 2)
                s2, p2, o2 = (int(v) for v in oracle._slice(arr, col, x)[0])
                kw = dict(p1=p1, c1=o1 if v1 == "s" else s1, p2=p2,
                          c2=o2 if v2 == "s" else s2)
                q = JoinQ(cat, v1, v2, **{k: kw[k] for k in JOIN_FIELDS[cat]})
                work.append((f"join {cat} {v1}{v2}", q, jcfg, None))
    return work


def run_work(engine, work) -> list:
    """Run every item through ``Engine.compile(query, config)(batch)``;
    returns ``(answer, host seconds, effective cap)`` per item (a plan
    keeps a cap grown by an earlier overflow of its shape)."""
    import torch

    out = []
    for _, q, cfg, batch in work:
        plan = engine.compile(q, cfg.replace(device=str(engine.device)))
        t0 = time.perf_counter()
        ans = plan(batch)
        torch.cuda.synchronize()
        out.append((ans, time.perf_counter() - t0, plan.effective_cap))
    return out


def check_work(work, results, oracle, n_unique: int) -> dict:
    """Every answer against the oracle; returns ``{label: [seconds, ...]}``
    and the per-label count of non-empty answers."""
    lat, nonempty = {}, {}
    for (label, q, _, batch), (ans, sec, cap) in zip(work, results):
        lat.setdefault(label, []).append((sec, cap))
        if label.startswith("join"):
            want = oracle.join(q)
            if not same_answer(ans, want):
                fail(f"{label} {q} disagrees with the oracle")
            nonempty[label] = nonempty.get(label, 0) + bool(len(want))
        elif label.endswith("all preds"):
            for p, got in zip(batch["p"], ans):
                if not same_pairs(got, oracle.pairs(int(p))):
                    fail(f"(?S,{p},?O) disagrees with the oracle")
        elif label.endswith("dump"):
            total = sum(v.shape[0] for v in ans.values())
            if total != n_unique:
                fail(f"the dump returned {total} triples, not {n_unique}")
            for p in range(1, oracle.n_preds + 1):
                if not same_pairs(ans.get(p, oracle.pairs(p)[:0]), oracle.pairs(p)):
                    fail(f"the dump of predicate {p} disagrees with the oracle")
        else:
            op = next(op for name, _, op in PATTERN_SHAPES if label.split()[1] == name)
            n = len(ans)
            for i in range(n):
                args = [int(batch[k][i]) if k in batch else 0 for k in "spo"]
                if not same_answer(ans[i], oracle.answer(op, *args)):
                    fail(f"{label} lane {i} {args} disagrees with the oracle")
    return lat, nonempty


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
    sized from the host time of one call and the hold is verified.  When it
    does not hold, the next try sleeps 4x longer over 4x fewer calls: a call
    of many launches (``k2_range`` queues three a tree level) can fill the
    launch queue, which then blocks the host until the sleep has ended."""
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
        iters = max(1, iters // 4)
    fail("could not hold the stream while enqueuing the timed calls")


def iters_for(fn, budget_ms: float, most: int) -> int:
    """How many timed calls of ``fn`` fit a budget (one call measured after
    a warmup, host clock around a synchronised call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return max(1, min(most, int(budget_ms / max(ms, 1e-3))))


def _scan_work(meta, ids, valid) -> tuple[float, int]:
    """Arena bytes and child candidates of a batch of scan lanes: a 4 B
    root word per lane, then per 1-node on a result path its 4 B rank
    entry and k²/8 B of child bits (nodes = distinct result prefixes)."""
    import numpy as np

    ids, valid = ids.cpu().numpy(), valid.cpu().numpy()
    q = ids.shape[0]
    lane = np.nonzero(valid)[0].astype(np.int64)
    vid = ids[valid].astype(np.int64)
    arena, cand = 4 * q, 0
    for lvl in range(meta.n_levels - 1):
        sub = meta.subsides[lvl]
        n_l = np.unique(lane * (meta.side // sub + 1) + vid // sub).size
        arena += n_l * (4 + meta.radices[lvl + 1] / 8)
        cand += n_l * meta.ks[lvl + 1]
    return arena, cand


def _check_levels(meta, f, preds, rows, cols) -> int:
    """Tree levels the check lanes read, summed: each lane's levels down to
    its first 0 bit, all H for a hit (the walk of ``ref.k2_check_ref``)."""
    import torch

    from repro_torch.core import bitvec, k2tree

    p = bitvec.row_index(preds, f.t_words.shape[0])
    rd, cd = k2tree.row_digits(meta, rows), k2tree.row_digits(meta, cols)
    alive = torch.ones(rows.shape, dtype=torch.bool, device=rows.device)
    walked = torch.zeros(rows.shape, dtype=torch.int64, device=rows.device)
    pos = rd[0] * meta.ks[0] + cd[0]
    for lvl in range(meta.n_levels):
        walked += alive
        last = lvl == meta.n_levels - 1
        alive &= bitvec.get_bit_2d(f.l_words if last else f.t_words, p, pos) == 1
        if not last:
            j = bitvec.rank1_2d(f.t_words, f.t_rank, p, pos) - f.ones_before[p, lvl]
            pos = f.level_start[p, lvl + 1] + j * meta.radices[lvl + 1] + (
                rd[lvl + 1] * meta.ks[lvl + 1] + cd[lvl + 1])
    return int(walked.sum().item())


def _word_span(ranges) -> int:
    """Number of distinct words covered by inclusive ``(lo, hi)`` ranges."""
    n, end = 0, -1
    for lo, hi in sorted(ranges):
        lo = max(lo, end + 1)
        if hi >= lo:
            n += hi - lo + 1
            end = hi
    return n


def _range_nodes(meta, level_start, p, rows, cols):
    """Per depth of tree ``p``, the bit positions of the 1-nodes above the
    given pairs.  Pairs come out in Morton order, so the nodes of a depth
    are runs of equal prefixes in level order, and the children of node i
    of depth j sit at ``level_start[p, j + 1] + i·k² + digit``."""
    import numpy as np

    out, parent = [], None
    for j in range(meta.n_levels):
        sub, k = meta.subsides[j], meta.ks[j]
        rq, cq = rows // sub, cols // sub
        key = rq * (meta.side // sub + 1) + cq
        start = np.ones(key.size, np.bool_)
        start[1:] = key[1:] != key[:-1]
        digit = (rq % k) * k + cq % k
        pos = digit if j == 0 else level_start[p, j] + parent * meta.radices[j] + digit
        out.append(pos[start])
        parent = np.cumsum(start) - 1
    return out


def _range_work(meta, f, preds, rows, cols, valid) -> tuple[float, int]:
    """Arena bytes and child candidates of range lanes: the distinct 32-bit
    words of ``t_words`` and ``l_words`` whose bits a lane tests (every
    root child, then the k² child bits of every expanded 1-node) and the
    distinct ``t_rank`` entries its expanded 1-nodes read, counted from
    the pairs it returned."""
    import numpy as np

    H, P = meta.n_levels, f.n_preds
    level_start = f.level_start.cpu().numpy().astype(np.int64)
    preds = preds.cpu().numpy()
    rows, cols, valid = (a.cpu().numpy() for a in (rows, cols, valid))
    arena, cand = 0, 0
    for i in range(preds.shape[0]):
        p = int(preds[i]) + (P if preds[i] < 0 else 0)
        p = min(max(p, 0), P - 1)  # the kernels' pred_row
        root = [(0, (meta.radices[0] - 1) >> 5)]
        t_ranges, l_ranges = ([], root) if H == 1 else (root, [])
        rank_words = [np.zeros(0, np.int64)]
        cand += meta.radices[0]
        r, c = rows[i][valid[i]].astype(np.int64), cols[i][valid[i]].astype(np.int64)
        if r.size:
            nodes = _range_nodes(meta, level_start, p, r, c)
            for j in range(H - 1):
                n = nodes[j].size
                lo = int(level_start[p, j + 1])
                hi = lo + n * meta.radices[j + 1] - 1
                (l_ranges if j + 2 == H else t_ranges).append((lo >> 5, hi >> 5))
                rank_words.append(nodes[j] >> 5)
                cand += n * meta.radices[j + 1]
        n_rank = np.unique(np.concatenate(rank_words)).size
        arena += 4 * (_word_span(t_ranges) + _word_span(l_ranges) + n_rank)
    return arena, cand


def bound(name, args, kw, out) -> tuple[float, str, int, int]:
    """Least time for this call's work: (bound_ms, bound_by, bytes, ops).

    Bytes: lane inputs read once, outputs written once, plus the arena
    bytes this data needs (see PERF.md); ops: 32-bit ALU operations, or
    for ``block_spmm`` the flops of its ON tiles at the f32 FMA peak (f32)
    or the dense bf16 tensor-core peak (bf16).
    """
    import torch

    peak = PEAK_OPS_PER_S
    if name in OPS_KERNELS:
        meta_or_pmeta = store_part = None
    else:
        meta_or_pmeta, store_part, args = args[0], args[1], args[2:]
    if name == "popcount":
        n = args[0].numel()
        nbytes, ops_ = 8 * n, n  # one POPC a word
    elif name == "sorted_intersect_mask":
        ca, cb = args[0].numel(), args[1].numel()
        # each search step: a compare, two selects and the midpoint
        nbytes, ops_ = 5 * ca + 4 * cb, 4 * ca * cb.bit_length()
    elif name == "block_spmm":
        mask, a, x = args
        bm, bk = kw.get("block_m", 128), kw.get("block_k", 128)
        n_on = int((mask != 0).sum().item())
        (m, k), d, elt = a.shape, x.shape[1], a.element_size()
        nbytes = n_on * bm * bk * elt + k * d * elt + m * d * 4 + 4 * mask.numel()
        ops_ = 2 * n_on * bm * bk * d
        if a.dtype != torch.float32:
            peak = PEAK_BF16_FLOPS
    elif name == "k2_scan":
        q, cap = out[0].shape
        arena, cand = _scan_work(meta_or_pmeta, out[0], out[1])
        nbytes = 12 * q + 5 * q * cap + 5 * q + arena
        ops_ = OPS_PER_CANDIDATE * cand + 2 * q * cap
    elif name == "k2_scan_rebind":
        # the k2_scan work of the X lanes plus that of every Y lane (dead
        # X slots scan key 0 and are counted like any other Y lane)
        q, cap_x = out[0].shape
        cap_y = out[4].shape[-1]
        ax, cx = _scan_work(meta_or_pmeta, out[0], out[1])
        ay, cy = _scan_work(meta_or_pmeta, out[4].reshape(q * cap_x, cap_y),
                            out[5].reshape(q * cap_x, cap_y))
        nbytes = 20 * q + 5 * q * cap_x + 5 * q + 5 * q * cap_x * cap_y + 5 * q * cap_x + ax + ay
        ops_ = OPS_PER_CANDIDATE * (cx + cy) + 2 * q * cap_x * (1 + cap_y)
    elif name == "k2_range":
        q, cap = out[0].shape
        arena, cand = _range_work(meta_or_pmeta, store_part, args[0], *out[:3])
        nbytes = 4 * q + 9 * q * cap + 5 * q + arena
        ops_ = OPS_PER_CANDIDATE * cand + 3 * q * cap
    elif name == "k2_check":
        q = out.numel()
        walked = _check_levels(meta_or_pmeta, store_part, *args)
        nbytes = 13 * q + 8 * walked
        ops_ = 25 * walked
    elif name == "pred_gather":
        pm = meta_or_pmeta
        count = out[2].cpu().numpy().clip(min=0)
        q, cap = out[0].shape
        nbytes = 12 * q + count.sum() * pm.bytes_per_pred + 5 * q * cap + 5 * q
        ops_ = 10 * q * cap
    else:
        pm = meta_or_pmeta
        count = out[2].cpu().numpy().clip(min=0)
        q, cap = out[0].shape
        nbytes = 4 * q + 5 * q * cap + 5 * q + 8 * q + count.sum() * (1 + 4 * (pm.levels - 1))
        ops_ = 10 * q * cap + 10 * count.sum() * pm.levels
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops_ / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            int(nbytes), int(ops_))


def path_ms(name, *recorders) -> dict:
    """Device ms and bound ms of a kernel summed over every call a recorder
    captured (the serve step of phase 4, the pattern/join run of phase 5b),
    each call timed on its own inputs: the weight of the kernel on a path."""
    out = {}
    for label, recorder in zip(("serve_step", "patterns_joins"), recorders):
        dev = low = 0.0
        for cargs, kw, res in recorder.calls[name]:
            dev += time_ms(lambda f=recorder.orig[name], a=cargs, k=kw: f(*a, **k), 5)
            low += float(bound(name, cargs, kw, res)[0])
        out[label] = dict(calls=len(recorder.calls[name]), device_ms=dev, bound_ms=low)
    return out


def main_path_shapes(name, *recorders):
    """Every recorded call of kernel ``name`` on the serve step and on phase
    5b, and for the warp-per-lane kernels also the serve step's first lane
    alone (Q=1): one lane's latency."""
    calls = [c for recorder in recorders for c in recorder.calls[name]]
    if name in ("k2_scan", "k2_check", "pred_gather_dac") and calls:
        (meta, f, *lanes), kw, _ = calls[0]
        one = (meta, f, *(t[:1].contiguous() for t in lanes))
        calls.append((one, kw, recorders[0].orig[name](*one, **kw)))
    return calls


def launch_floor(build, device) -> dict:
    """Device ms of an empty kernel timed as ``time_case`` times a kernel
    (``csrc/launch_floor.cu``), and its back-to-back ms through ctypes."""
    import ctypes

    import torch

    fn = build.load("launch_floor").launch_floor_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream

    def call():
        if fn(stream, device.index) != 0:
            fail("the empty launch_floor kernel did not launch")

    n_it = iters_for(call, 300.0, 50)
    return dict(ms=time_ms(call, n_it), wrapper_ms=wrapper_ms(call, n_it), iters=n_it)


def time_case(name, fn, args, kw, out, library=None) -> dict:
    """One call's times: device ms (CUDA events around calls queued behind a
    sleep kernel), the wrapper's and the plain version's ms (back to back,
    host launch overhead included: the plain version enqueues more kernels
    than the launch queue holds behind a sleep), the library call's ms (back
    to back: it may synchronise), and the call's bound."""
    def call():
        return fn(*args, **kw)

    def plain():
        return plain_of(name, args, kw)

    n_it = iters_for(call, 300.0, 50)
    ms = time_ms(call, n_it)
    wrapped = wrapper_ms(call, n_it)
    plain_ms = wrapper_ms(plain, iters_for(plain, 2000.0, 5))
    lib_ms = None if library is None else wrapper_ms(library, iters_for(library, 300.0, 50))
    b_ms, by, nbytes, nops = bound(name, args, kw, out)
    return dict(ms=ms, wrapper_ms=wrapped, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=by, bytes=nbytes, ops=nops, iters=n_it)


# ---------------------------------------------------------------------------
# phase 7: the entry-point kernels at store scale
# ---------------------------------------------------------------------------


def arena_1024(words2d):
    """A (P, W) word arena flattened and zero-padded to (M, 1024), M % 8 == 0."""
    import torch

    flat = words2d.reshape(-1)
    out = torch.zeros(-(-flat.numel() // 8192) * 8192, dtype=torch.int32, device=flat.device)
    out[: flat.numel()] = flat
    return out.reshape(-1, 1024)


def padded_ids(ids, device, mult: int = 2048):
    """Ascending int32 ids, ``SENTINEL``-padded to a multiple of ``mult``."""
    import numpy as np
    import torch

    out = np.full(max(mult, -(-len(ids) // mult) * mult), SENTINEL, np.int32)
    out[: len(ids)] = ids
    return torch.from_numpy(out).to(device)


def spmm_inputs(side: int, d: int, device, seed: int):
    """0/1 A (side x side) at 5% and normal X (side x d) from the seed, and
    two tile masks from ``mask_from_k2_level`` at 25% of tiles (one at
    least): through the repeat branch (a level of side nb/2, each cell 2x2
    tiles) and through the OR-reduce branch (a level of side 4·nb whose
    on-cells lie in the on tiles), and the repeat branch again at 64-row
    blocks (the same on elements; 64-row kernel tiles).  One
    tile off in every mask holds NaN.  Returns A, X and {label: (mask,
    block)}."""
    import torch

    from repro_torch.kernels.block_spmm import mask_from_k2_level

    g = torch.Generator(device=device).manual_seed(seed)
    nb = side // 128
    coarse = (torch.rand((nb // 2, nb // 2), generator=g, device=device) < 0.25).to(torch.int32)
    coarse[0, 0] = 1  # at least one cell on, also on a tiny grid
    mask_rep = mask_from_k2_level(coarse, side=side, block=128)
    if not torch.equal(mask_rep, coarse.repeat_interleave(2, 0).repeat_interleave(2, 1)):
        fail("mask_from_k2_level (repeat) is not the level's 2x2 blow-up")
    tiles = torch.rand((nb, nb), generator=g, device=device) < 0.25
    tiles[-1, -1] = True
    cells = torch.rand((4 * nb, 4 * nb), generator=g, device=device) < 0.2
    cells &= tiles.repeat_interleave(4, 0).repeat_interleave(4, 1)
    on = tiles.nonzero()
    cells[on[:, 0] * 4, on[:, 1] * 4] = True  # every on tile holds an on cell
    mask_or = mask_from_k2_level(cells.to(torch.int32), side=side, block=128)
    if not torch.equal(mask_or, tiles.to(torch.int32)):
        fail("mask_from_k2_level (OR-reduce) is not the level's tile occupancy")
    a = (torch.rand((side, side), generator=g, device=device) < 0.05).float()
    x = torch.randn((side, d), generator=g, device=device)
    off = ((mask_rep == 0) & (mask_or == 0)).nonzero()
    if not off.shape[0]:
        fail("no tile is off in both masks")
    i, j = (128 * int(v) for v in off[0])
    a[i:i + 128, j:j + 128] = float("nan")
    mask_64 = mask_from_k2_level(coarse, side=side, block=64)
    return a, x, {"repeat mask": (mask_rep, 128), "or-reduce mask": (mask_or, 128),
                  "repeat mask, 64-blocks": (mask_64, 64)}


def entry_point_phase(store, ds, intersects, device, seed: int, err: dict) -> list:
    """Phase 7: drive ``ops.popcount``, ``ops.sorted_intersect_mask`` and
    ``ops.block_spmm`` at store scale with the launch counters reset just
    before, check every output (plain version, numpy, ``t_rank``, the kept
    lanes of ``sortedset.intersect``), time each distinct case and return
    the three kernels' rows of the ``{"kernels": ...}`` line."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False  # plain and library f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    # after the serve and query phases: cuBLAS keeps its workspace, which
    # would otherwise count in the serve phase's memory peak
    err.update(ops_small_checks(device, seed))
    if err["popcount"] or err["sorted_intersect_mask"]:
        fail(f"entry-point kernels disagree with their plain versions: {err}")
    f = store.forest
    cases = []  # (kernel, label, args, kw)
    for arena in ("t_words", "l_words"):
        words = getattr(f, arena)
        padded = arena_1024(words)
        cases.append(("popcount", f"{arena} {tuple(words.shape)} as {tuple(padded.shape)}",
                      (padded,), {}))
    rng = np.random.default_rng(seed)
    a = np.sort(rng.choice(10**7, 2**16, replace=False)).astype(np.int32)
    b = np.sort(rng.choice(10**7, 2**18, replace=False)).astype(np.int32)
    members = [(a, b)]
    cases.append(("sorted_intersect_mask", "2^16 ids in 2^18, from 10^7",
                  (torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)), {}))
    p1, p2 = np.argsort(-np.bincount(ds.ids[:, 1]), kind="stable")[:2]
    a, b = (np.unique(ds.ids[ds.ids[:, 1] == p, 0]) - 1 for p in (p1, p2))
    members.append((a, b))
    cases.append(("sorted_intersect_mask",
                  f"subjects of pred {p1} ({a.size}) in pred {p2} ({b.size})",
                  (padded_ids(a, device), padded_ids(b, device)), {}))
    n_join = len(intersects)
    for a_ids, b_row, _ in intersects:
        ca = a_ids.shape[0]
        if ca % min(2048, ca):
            a_ids = padded_ids(a_ids.cpu().numpy(), device)
        cases.append(("sorted_intersect_mask", f"join A-C: A {ca} in B {b_row.shape[0]}",
                      (a_ids, b_row), {}))
    for side, _, d in SPMM_SHAPES:
        a, x, masks = spmm_inputs(side, d, device, seed)
        for dtype in (torch.float32, torch.bfloat16):
            ad, xd = a.to(dtype), x.to(dtype)
            for branch, (mask, blk) in masks.items():
                kw = {} if blk == 128 else dict(block_m=blk, block_k=blk, block_d=blk)
                cases.append(("block_spmm", f"M=K={side}, D={d}, {str(dtype)[6:]}, {branch}",
                              (mask, ad, xd), kw))
    torch.cuda.synchronize()

    ops.reset_launches()
    outs = [getattr(ops, name)(*args, **kw) for name, _, args, kw in cases]
    torch.cuda.synchronize()
    launches = {k: ops.LAUNCHES[k] for k in OPS_KERNELS}
    print(f"entry-point path: {len(cases)} calls, launches {launches}", flush=True)
    if not all(launches.values()):
        fail(f"a kernel of the entry-point path never launched: {launches}")

    worst = [0.0, 0.0]
    for (name, label, args, kw), out in zip(cases, outs):
        if name == "block_spmm":
            e, *ratios = spmm_check(args, kw, out)
            worst = [max(w, r) for w, r in zip(worst, ratios)]
            print(f"block_spmm {label}: variant {ops.block_spmm_variant(*args[1:], **kw)}, "
                  f"max_abs_err {e:.3g}, ratio {ratios[0]:.4f} of its bound, "
                  f"{ratios[1]:.4f} of its statistical limit, "
                  f"{int((args[0] != 0).sum())} of {args[0].numel()} tiles on", flush=True)
        else:
            e = max_abs_err(out, plain_of(name, args, kw))
        err[name] = max(err[name], e)
    if err["popcount"] or err["sorted_intersect_mask"]:
        fail(f"entry-point kernels disagree with their plain versions: {err}")
    p, w = f.t_words.shape
    per_word = outs[0].reshape(-1)[: p * w].reshape(p, w).to(torch.int64)
    if not torch.equal(torch.cumsum(per_word, 1) - per_word, f.t_rank.to(torch.int64)):
        fail("t_rank is not the exclusive cumsum of popcount over t_words")
    print(f"popcount: t_rank of all {p} trees rebuilt exactly from {p * w} word counts", flush=True)
    for (a, b), out in zip(members, outs[2:4]):
        if not np.array_equal(out[: a.size].cpu().numpy(), np.isin(a, b)) or bool(out[a.size:].any()):
            fail("sorted_intersect_mask disagrees with numpy membership")
    kept = 0
    for (a_ids, _, want), out in zip(intersects, outs[4:4 + n_join]):
        got = a_ids[out[: a_ids.shape[0]]]
        if not torch.equal(got, want):
            fail("sorted_intersect_mask keeps other lanes than sortedset.intersect")
        kept += want.numel()
    print(f"sorted_intersect_mask: numpy membership holds; {n_join} intersections of joins "
          f"A-C keep exactly intersect's {kept} lanes", flush=True)

    by_kernel = {k: [] for k in OPS_KERNELS}
    seen = set()
    for (name, label, args, kw), out in zip(cases, outs):
        if label in seen:
            continue
        seen.add(label)
        library = None
        if name == "sorted_intersect_mask":
            def library(a=args[0], b=args[1]):
                return torch.isin(a, b)
        elif name == "block_spmm":
            mask, a, x = args
            blk = kw.get("block_m", 128)
            on = mask.repeat_interleave(blk, 0).repeat_interleave(blk, 1) != 0
            premasked = torch.where(on, a, torch.zeros((), dtype=a.dtype, device=a.device))

            def library(a=premasked, x=x):
                return torch.matmul(a, x)  # bf16 inputs give a bf16 output
        times = time_case(name, getattr(ops, name), args, kw, out, library)
        library = premasked = None
        times["label"] = label
        if name == "block_spmm":
            times["variant"] = ops.block_spmm_variant(*args[1:], **kw)
        by_kernel[name].append(times)
        print(f"{name} {label}: {times.get('variant', '')} "
              f"device {times['ms']:.5f} ms, wrapper {times['wrapper_ms']:.5f}, "
              f"plain {times['plain_ms']:.5f}, library {times['library_ms']}, bound "
              f"{times['bound_ms']:.6f} ({times['bound_by']})", flush=True)
    rows = []
    for name in OPS_KERNELS:
        best = max(by_kernel[name], key=lambda t: t["bound_ms"])
        rows.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"], launches=launches[name],
            launches_by_path={"ops": launches[name]}, max_abs_err=err[name],
            ms=best["ms"], plain_ms=best["plain_ms"], bound_ms=best["bound_ms"],
            bound_by=best["bound_by"], library_ms=best["library_ms"],
            shapes={t.pop("label"): t for t in by_kernel[name]},
        ))
    print(f"block_spmm worst ratio {worst[0]:.4f} of its bound, {worst[1]:.4f} of its "
          f"statistical limit; peaks: f32 {PEAK_OPS_PER_S:.3g} FLOP/s "
          f"(FMA), bf16 {PEAK_BF16_FLOPS:.3g} FLOP/s (dense tensor core)", flush=True)
    return rows


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
    print(f"built {len(build.SOURCES)} libraries ({len(KERNELS)} kernels and the launch "
          f"floor) in {time.perf_counter() - t0:.2f}s", flush=True)
    for name, log in build.ptxas_report().items():
        info = [ln.split("info    : ")[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"ptxas {name}: {'; '.join(info)}", flush=True)
    sass_check(build)
    spill_check(build)

    phase("3. kernels vs plain on small stores")
    err = small_store_checks(device, args.seed)
    if any(err[k] for k in QUERY_KERNELS):
        fail(f"kernels disagree with their plain versions: {err}")

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
    for name in SERVE_KERNELS:
        err[name] = max(err[name], rec.err[name])
        shapes = [tuple(c[2][0].shape) if isinstance(c[2], tuple) else tuple(c[2].shape)
                  for c in rec.calls[name]]
        print(f"main-path inputs {name}: calls {shapes}, max_abs_err {rec.err[name]}", flush=True)
    if any(err[k] for k in QUERY_KERNELS):
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
    if not all(launches[k] > 0 for k in SERVE_KERNELS):
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

    phase("5b. patterns and joins over the geonames store")
    work = query_work(ds, oracle, args.seed + 3)
    rec_q = Recorder()
    t0 = time.perf_counter()
    with rec_q:
        run_work(engine, work)
    torch.cuda.synchronize()
    for name in QUERY_KERNELS:
        err[name] = max(err[name], rec_q.err[name])
    print(f"kernel checks on the pattern/join inputs: "
          f"{ {k: len(v) for k, v in rec_q.calls.items()} } calls, max_abs_err {rec_q.err}, "
          f"{len(rec_q.intersects)} intersections recorded "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    if any(err[k] for k in QUERY_KERNELS):
        fail(f"kernels disagree with their plain versions: {err}")
    ops.reset_launches()
    t0 = time.perf_counter()
    results = run_work(engine, work)
    torch.cuda.synchronize()
    q_launches = dict(ops.LAUNCHES)
    q_wall = time.perf_counter() - t0
    lat, nonempty = check_work(work, results, oracle, ds.n_triples)
    print(f"pattern/join path: {len(work)} plan calls in {q_wall:.3f}s; launches {q_launches}; "
          f"oracle: every answer matches (dump: {ds.n_triples} triples)", flush=True)
    for label, runs in lat.items():
        batch = next(b for lb, _, _, b in work if lb == label)
        secs = [sec for sec, _ in runs]
        caps = sorted({cap for _, cap in runs})
        if label.startswith("join"):
            print(f"latency {label}: {len(secs)} queries, median {1e3 * np.median(secs):.3f} ms, "
                  f"max {1e3 * max(secs):.3f} ms per query, {nonempty[label]} non-empty, "
                  f"cap {caps}", flush=True)
            if not nonempty[label]:
                fail(f"every {label} answer is empty: the workload exercises nothing")
        else:
            n = len(next(iter(batch.values()))) if batch else 1
            print(f"latency {label}: {n} queries in one call, {1e3 * secs[0]:.3f} ms per call, "
                  f"{1e6 * secs[0] / n:.1f} us per query, cap {caps}", flush=True)
    if not all(q_launches[k] > 0 for k in QUERY_KERNELS):
        fail(f"a kernel of the pattern/join path never launched: {q_launches}")

    phase("6. kernel times at the main-path shapes")
    rows = []
    for name in QUERY_KERNELS:
        best, shapes, seen = None, {}, set()
        for cargs, kw, out in main_path_shapes(name, rec, rec_q):
            key = (tuple(tuple(t.shape) for t in cargs[2:]), tuple(sorted(kw.items())))
            if key in seen:
                continue
            seen.add(key)
            times = time_case(name, rec.orig[name], cargs, kw, out)
            q = cargs[2].shape[0]
            shapes[",".join([f"Q={q}"] + [f"{k}={v}" for k, v in sorted(kw.items())])] = times
            if best is None or q > best[0]:
                best = (q, times)
        times = best[1]
        rows.append(dict(
            name=name, route="cuda", source=KERNELS[name]["source"],
            replaces=KERNELS[name]["replaces"],
            launches=launches[name] + q_launches[name],
            launches_by_path={"serve": launches[name], "patterns_joins": q_launches[name]},
            max_abs_err=err[name], ms=times["ms"], plain_ms=times["plain_ms"],
            bound_ms=times["bound_ms"], bound_by=times["bound_by"], library_ms=None,
            shapes=shapes, path_ms=path_ms(name, rec, rec_q),
        ))
        print(f"{name}: device ms summed over each path's recorded calls {rows[-1]['path_ms']}",
              flush=True)
    print(f"launch floor: {json.dumps(launch_floor(build, device))}", flush=True)

    phase("7. kernel entry points at store scale")
    rows += entry_point_phase(store, ds, rec_q.intersects, device, args.seed, err)
    print(json.dumps({"kernels": rows}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
