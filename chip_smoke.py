#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed 0] [--triples 9415253] [--trace-out PATH]

Phases (any failure exits non-zero before the result line):

1. refuse to run without a CUDA card or outside a checkout; print the card;
2. build the nine CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` each, in parallel) and the empty ``launch_floor`` kernel, print
   ptxas registers / smem / spills, fail if ptxas spills in ``k2_scan``,
   ``k2_scan_rebind``, ``k2_check``, ``pred_gather_dac``, ``pred_gather``
   or ``sorted_intersect_mask``, and fail unless ``cuobjdump -sass`` of the
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
   latency is printed; then one E and one F join under the tracer give
   the host/device split of a join (``plan.dispatch`` / ``plan.sync`` /
   ``plan.decode`` spans beside the join's device ms);
5c. the SELECT/BGP path over the same store (cap 1024), run once with
   every kernel call held against its plain version, then again with the
   launch counters reset just before: 256 ``SelectQ`` of the serve
   benchmark's shape (WHERE (s,p,?o), OPTIONAL (s,p2,?x), ORDER BY ?o, LIMIT
   16), 64 subject stars (?s,p1,o)(?s,p2,?x), 64 paths (s,p1,?y)(?y,p2,?z),
   32 UNIONs of two predicates under a FILTER on ?o, and 8 BGPs joining a
   one-row key with the fully free pattern of the smallest predicate (the
   ``k2_range`` step, at the cap that predicate needs); every answer must
   equal a numpy evaluation over the id triples, ``k2_scan``, ``k2_check``
   and ``k2_range`` must have launched, and each shape's median and max
   host-clock latency is printed, with one traced query a shape split into
   its spans; then the broker serves phase 5's trace again under tracing
   and under ``torch.profiler`` (CUDA activity only), and the 4096-query
   trace with 5% of it SELECTs (``make_trace(select_frac=0.05)``) with
   observability off, on, and under the profiler: every lane and SELECT
   answer of every run must equal the numpy evaluation, the traced SELECT
   run's exported Chrome trace (written to ``--trace-out`` when given)
   must pass ``validate_chrome_trace(require_queries=True)``, every run's
   qps is printed, the spans give the host split of a serve batch beside
   ``Plan.cost_profile``'s device ms of one 256-lane batch, and each
   profiled run's device busy time (the union of its kernel and copy
   intervals) gives the device idle share of an untraced run;
6. time each path kernel at every distinct shape recorded on the serve
   step and in phases 5b and 5c, ``k2_scan``, ``k2_check``, ``pred_gather_dac`` and
   ``pred_gather`` also at Q=1 (one lane's latency) (CUDA events around
   calls enqueued behind a sleep kernel, so host launch overhead is excluded; the
   wrapper's back-to-back time is reported beside it) and its plain
   version back to back, and its device and bound ms summed over every
   recorded call of the serve step and of phases 5b and 5c; then the launch floor,
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
   predicates, on 2,048 ids spread over 2^20 (a tile's share of B past the
   kernel's shared window: a thread a lane in global memory), and on every
   (A, B row) that ``sortedset.intersect``
   received in phase 5b's joins A-C (the mask must keep exactly its
   lanes); ``ops.block_spmm`` at M = K = 1024, D = 512 and M = K = 16384,
   D = 256 in f32 and bf16, 0/1 A at 5%, masks from ``mask_from_k2_level``
   through both branches at 25% of tiles, NaN in a masked-off tile; each
   against its plain version (``block_spmm`` within ``K·2^-24·(|A|@|X|) +
   1e-6`` and within the statistical ``sqrt(K)·2^-24·(|A|@|X|) + 1e-6``
   that separates f32 products from TF32 ones), each ``block_spmm`` case
   with the variant (kernel, tile rows, tile columns, k chunk, threads) that
   ``ops.block_spmm_variant`` chose for it, timed as in phase 6 beside one
   PyTorch call (``torch.isin``, ``torch.matmul``) where there is one;
8. the dynamic store (``core.delta``, ``core.compaction``) and the string
   path, with the launch counters reset just before each timed run:
   8a. phase 4's store wrapped in a ``DynamicStore`` (no rebuild) and
   churned (half tombstones of static triples, half inserts, 5% of them
   with subjects, 5% with objects past the static extents and 5% on the
   appended predicate ``n_preds + 1``) to 0, 4,096 and 5% of its triples;
   at each size 100 ``ServeQ`` batches of 256 lanes in the serve mix at cap
   1024, constants a third each from tombstoned, inserted and untouched
   triples, every lane against a numpy oracle of (static − tombstones) ∪
   inserts, with p50/p99 a batch and the snapshot's build time; at 4,096
   also phase 5b's pattern and join work (the six serve-lane patterns
   under both layouts, (?S,P,?O) of every predicate and the dump, joins
   A-F over the four vpos pairs), first with every kernel call held against
   its plain version;
   8b. a ``ServeBroker`` with the default ``CompactionPolicy`` over a fresh
   ``DynamicStore`` of a 1 M-triple geonames-shaped store built in the
   phase (``COMPACT_TRIPLES``; cut from phase 4's 9.4 M, whose host
   rebuild took 116 s of the script's 1,200), 8 Zipf(1.1) tenants, phase 5's
   coalescing: rounds of 512 writes then 256 reads checked against the
   oracle until the 4,096th write trips a compaction; rounds of 8 writes
   (at most 1,024) and 256 reads while it rebuilds; every raced write read
   back after the swap; two more rounds at epoch 1; read qps and p99
   before, during and after the rebuild, the compaction's split, the peak
   device memory; the compacted epoch's ``k2_range`` dump in full against
   its plain version, and its ids with the rebased delta against the truth;
   8c. ``from_string_triples`` over 500,000 geonames-like string triples
   (``--string-triples``), the dictionary's build and encode seconds and
   bits per triple beside the k²-triples', 256 string queries (encode,
   serve lanes, decode) against a Python evaluation over the strings, then
   ``insert_strings`` of unseen terms and ``delete_strings`` read back
   before and after a ``compact``, whose ids must not move.
9. predicate-sharded serving, quantile-sized lanes and the functional
   API on phase 4's store (no rebuild), every kernel call recorded and a
   sample of each kernel's calls (the first 4, then every 16th) held
   against its plain version:
   9a. ``Engine.compile(ServeQ(), ExecConfig(mesh=...))`` on meshes that
   repeat the card, (1, 4), (2, 4) and (1, 8) (20 trees padded to 24):
   two 256-lane serve-mix batches each (all six ops, unbounded lanes
   through the DAC index, one (2, 4) batch through the fixed layout)
   equal the unsharded plan field by field, with
   sampled lanes against the oracle; the six serve-lane patterns of phase
   5b (256 constants each) on the (2, 4) mesh equal the unsharded plans;
   ``make_sharded_unbounded_scan`` on 64 keys over the (1, 8) mesh equals
   the unsharded all-preds sweep; pairs, dump, joins D-F, BGP and SELECT
   refuse a mesh and ``run_bench(sharded=True)`` refuses one card; then
   the broker serves phase 5's trace unsharded, twice on the (1, 4) mesh,
   and unsharded again, every answer against the oracle, with qps,
   p50/p99, launches a batch, ``cost_profile`` device ms of one 256-lane
   batch, the shards' devices and bytes and the device memory peak; one
   profiled sharded run gives the idle share and one untimed sharded run
   is recorded;
   9b. (S,?P,?O) and (?S,?P,O) on 256 real constants each at
   ``u_width_quantile`` 0.5 and 1.0, single-device and on the (1, 4) mesh,
   every answer against the oracle, with both widths, the share of lanes
   routed to the sweep and the median ms of a call; then the same shapes
   at 0.5, 0.9, 0.99 and 1.0 on a 1 M dbpedia-en-shaped store with hub
   entities that touch every predicate (single-device);
   9c. every ``patterns`` function (with and without the index),
   ``row_scan_all_preds`` and ``range_scan`` on 8 real constants, the
   dump, and ``join_a`` / ``join_b`` / ``join_c`` on 8 queries each,
   against the oracle and the matching plan.
10. the single-tree API and the arch registry's engine programs:
   10a. ``k2tree.build`` on the card of ``benchmarks/bench_kernels.py``'s
   tree (100,000 random cells of a 100,000-side matrix): 65,536 point
   checks (half of them real cells), 64 row and 64 column scans at cap
   1024 and ``range_scan`` at cap 2^17 against a numpy evaluation of the
   cells, then an H = 1 tree and an empty tree, every kernel call held
   against its plain version; ``size_bits`` and the device, wrapper and
   plain ms of the check, one scan and the range;
   10b. ``programs.build("k2triples", "serve_64k")`` at the full config
   (``rdf.generate(1_000_000, 80,000 subjects, 512 predicates, 280,000
   objects)``) on a (1, 1) mesh of the card: one 65,536-lane batch of the
   serve benchmark's bounded op mix equal to the unsharded serve step
   field by field and, on 4,096 sampled lanes, to the oracle; the same
   program on a (1, 4) mesh equal to it; step ms, launches and peak
   device memory;
   10c. ``unbounded_4k`` at full size (4,096 keys over all 512 predicates,
   cap 1024; the largest power of two that fits if not, printed as a
   cut): peak device memory, 64 sampled keys against the oracle and the
   all-preds scans.  The kernel calls of 10b-10c are held against their
   plain versions on 4,096 random lanes a call.
11. the transformer LM's serving path (no kernel of its own; products
   are torch's, and none of the nine kernels may launch):
   11a. the five LM archs' smoke configs, the same seeded weights and
   ``TokenStream`` prompts on the card and the CPU: prefill of 2 x 24
   tokens, then 4 decode steps fed the CPU's greedy tokens, every step's
   logits within 5e-2 (rtol and atol), the greedy tokens printed;
   11b. ``tinyllama-1.1b`` at full width through ``programs.build`` and
   ``programs.lm_inputs``: ``prefill_32k`` cut to B = 8 x S = 4,096 (tokens
   a second, peak memory), 32 greedy decode steps on its cache, the first
   against a prefill of the S + 1 tokens (logits within 5e-2);
   ``decode_32k`` cut to B = 8 and ``long_500k`` uncut (B = 1, 524,288
   slots), each against a seeded bf16 cache filled to its last slot, the
   median ms of 8 steps; in each decode layer 0's ``decode_attention``
   against a float64 softmax on the card (within 1e-2);
   11c. ``olmoe-1b-7b`` at full width: ``prefill_32k`` cut to B = 4 x S =
   2,048 (capacity 1,280; the share of (token, expert) pairs dropped), 8
   greedy decode steps (capacity 4), and one MoE layer on 256 tokens on
   the card and the CPU with the same inputs and gates:
   the routing (``_moe_route``: ``_moe_dispatch_indices``' idx / wslot /
   valid and each token's slots) equal, the output within 1e-2 relative
   L2.  Each run
   prints its time, peak memory and bound (``lm_bound``) beside the card.
12. the transformer LM's training path (no kernel of its own: the flash
   backward is an autograd function over torch products, the optimizers
   elementwise torch; none of the nine kernels may launch):
   12a. each LM arch's smoke ``train_4k`` program (B 2 x S 64, the arch's
   AdamW or Adafactor) 3 steps on the card and the CPU from the same
   ``lm_inputs`` and batch: every step's loss and grad_norm, the optimizer
   state and parameters after step 1 held (``_step_held``); then
   ``chunked_attention``'s output and gradients at tinyllama's attention
   shapes (B 1, S 4,096, H 32 / Kv 4, dh 64, causal) against a float64
   dense softmax's autograd on the card (relative L2 1e-2);
   12b. ``tinyllama-1.1b:train_4k`` at full width (22 layers, f32 AdamW),
   the batch cut to B 8 x S 4,096: 3 steps on one ``TokenStream`` batch,
   the last loss below the first;
   12c. ``olmoe-1b-7b:train_4k`` at full width, depth cut to 4 of 16
   layers, the batch to B 4 x S 2,048: 4 steps on one batch, the
   router's gradient nonzero, the dropped (token, expert) share.  Each prints its losses,
   step ms (median of steps 2 on), tokens a second, peak memory, a
   training-step bound (``train_bound``) and one profiled step's device
   idle share and top kernels beside the card.
13. the LM family's serving programs on meshes of the card (``dist/``,
   ``models/transformer_mesh.py``; no kernel of their own, none of the
   nine may launch):
   13a. the five smoke archs' ``prefill_32k``, ``decode_32k`` and
   ``long_500k`` programs on a (2, 4) mesh of the card against the same
   on a (2, 4) mesh of ``cpu`` and against the card's (1, 1) programs, the
   same ``lm_inputs``: layer 0's k / v within 1e-2 relative L2, every
   other layer's within 5e-2 and the logits within 0.1 (a bf16 partial
   sum rounds once a model shard, and random smoke weights grow it; an
   MoE prefill's (1, 1) comparison runs on (1, 4): a (2, 4) mesh sizes
   capacity by each data slice's tokens);
   13b. ``olmoe-1b-7b:prefill_32k`` at full width, cut to B = 4 x S =
   2,048 (11c's cut), on (1, 1), (1, 4) and (2, 2) meshes of the card:
   tokens a second, peak memory, the dropped (token, expert) share; no
   byte added by placing the parameters on a mesh; layer 0's MoE on the
   prompt's embeddings on (1, 4) routes exactly as the single-shard
   ``moe_ffn`` (slots and ``valid`` equal, the same pairs dropped);
   13c. ``tinyllama-1.1b:long_500k`` uncut on (1, 4): ms a step against
   (1, 1) on the same cache, a profiled step's top kernels (whether
   cuBLAS still picks ``gemmSN`` for the 131,072-long products), one
   decode layer on identical inputs within 2e-2 relative L2 of (1, 1)'s;
   13d. ``tinyllama-1.1b:decode_32k`` on (1, 4) at B = 8 (11b's cut), as
   13c.
14. the LM training programs on meshes of the card and xDeepFM (no
   kernel of their own, none of the nine may launch): 14a the five smoke
   ``train_4k`` programs on a (2, 4) mesh against a cpu mesh, a mesh of
   distinct devices and (1, 1); 14b ``tinyllama-1.1b`` and 14c
   ``olmoe-1b-7b`` (cut as 12b / 12c) on (1, 4); 14d ``xdeepfm`` at its
   full config on (1, 1) and (1, 4).
15. the GNN family (EGNN, MACE, GraphCast, EquiformerV2; no kernel of
   their own, none of the nine may launch):
   15a. every arch's smoke program on all four graph shapes, one step on
   the card against the same step on the CPU (loss, grad_norm, the new
   parameters); EGNN, MACE and EquiformerV2 under a rotation of the
   positions on the card; EquiformerV2 with 3 edge chunks against one
   (loss and gradients) on the card;
   15b. every arch x shape at the full config (16 cells), each shape's
   host graph built once and timed (``minibatch_lg`` samples 1,024 seeds
   15-10 from a 232,965-node, 114.6 M-edge graph): each cell's footprint
   estimate at full size (one-step probes: at 1 and 2 layers for
   ``minibatch_lg``, also at a second graph scale for ``ogb_products``),
   "uncut" or its cut with the reason (memory: depth for ``minibatch_lg``,
   the graph's scale for ``ogb_products``; then the script's time, a step
   within 2.5 s), ms a step (median of steps 2-3), nodes and edges a second,
   peak memory, the loss and a bound (``gnn_bound``: model flops at the
   products' dtype's rate), and one profiled ``minibatch_lg`` step an
   arch (idle share, top kernels);
   15c. the GNN programs on meshes of the card (node and edge arrays over
   the data axes, the halo gather and the summed scatter of
   ``dist/collectives.py``): each arch's smoke program on (1, 4), (2, 2)
   and (2, 4) against the card's (1, 1) step and the same mesh on the CPU
   (15a's bounds); each arch's ``minibatch_lg`` cell at full width on
   (2, 2) (EquiformerV2 at 1 layer), ms a step beside 15b's (1, 1)
   and the bytes its halo gathers and summed scatters move a step.
16. the dry run (``launch/dryrun.py``) on the card's host of the cells
   measured above at the same shapes (10b ``serve_64k`` (1, 1), 12b, 14d
   ``train_batch`` (1, 1), the four 15b ``minibatch_lg`` cells), on
   ``meta`` copies of their inputs: flops by dtype, bytes, the three H100
   SXM roofline terms (``launch/roofline.py``, analytic bounds), the wire
   bytes by kind and the peak estimate beside the measured ms and
   ``max_memory_allocated``; fails unless each estimate lies within
   0.5x-2x of the measured footprint.  Then the full ``tinyllama-1.1b``
   ``train_4k`` on a (2, 4) ``meta`` mesh under ``seq_sp`` and with the
   residual whole: fails unless ``seq_sp``'s per-device peak is the lower
   and the two collective terms lie within 10% of each other.
17. the four ``examples/torch_*.py`` on the card at small sizes, side by
   side as processes: each must exit 0.
   Then the ``{"kernels": [...]}`` line (``launches_by_path`` gains
   ``dynamic``, phase 8's launches, ``sharded``, those of 9a's and 9b's
   mesh runs, ``functional``, those of 9c, ``tree``, those of 10a,
   ``registry``, those of the programs' runs in 10b-10c, ``train``,
   phase 12's, ``lm_mesh``, phase 13's, ``train_mesh`` and ``recsys``,
   phase 14's, and ``gnn``, phase 15's, all 0), the card's name and
   power limit, and the final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import roofline  # noqa: E402  (the H100 peaks' one home)

GEONAMES_TRIPLES = 9_415_253
# NVIDIA H100 SXM data sheet (``roofline.py``): HBM3 bandwidth; 67 T/s of
# 32-bit integer ALU operations; the 67 TFLOP/s f32 non-tensor rate; the
# dense bf16 tensor-core rate bounds a bf16 product
PEAK_BYTES_PER_S = roofline.HBM_BW
PEAK_OPS_PER_S = roofline.PEAK_INT32
PEAK_F32_FLOPS = roofline.PEAK_F32
PEAK_BF16_FLOPS = roofline.PEAK_BF16
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
    """Fail if ptxas spilled registers of a lane-latency-bound kernel (its
    lane state must stay in registers)."""
    for name in ("k2_scan", "k2_scan_rebind", "k2_check", "pred_gather_dac", "pred_gather",
                 "sorted_intersect_mask"):
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

    def __init__(self, every: int = 1, lanes: int | None = None, seed: int = 0):
        import torch

        from repro_torch.core import sortedset
        from repro_torch.kernels import ops

        self.ops, self.sortedset = ops, sortedset
        # with every > 1 only a sample is kept and checked: each kernel's
        # first 4 calls and every ``every``-th after
        self.every = every
        # with lanes, a k2_scan or k2_check call of more lanes is held on
        # that many random lanes (drawn from ``seed``) and its last
        # TAIL_LANES lanes, where the grid's last, partial run of lanes
        # falls, and is not kept: only for calls whose plain version at full
        # width does not fit beside them on the card (10c's 2^21-lane sweep)
        self.lanes = lanes
        self.gen = torch.Generator().manual_seed(seed)
        self.sampled = dict.fromkeys(QUERY_KERNELS, 0)
        self.seen = dict.fromkeys(QUERY_KERNELS, 0)
        self.calls: dict[str, list] = {k: [] for k in QUERY_KERNELS}
        self.err: dict[str, int] = dict.fromkeys(QUERY_KERNELS, 0)
        self.orig = {k: getattr(ops, k) for k in QUERY_KERNELS}
        self.orig_intersect = sortedset.intersect
        self.intersects: list = []

    def check(self, name, args, kw, out):
        want = plain_of(name, args, kw)
        self.err[name] = max(self.err[name], max_abs_err(out, want))
        return out

    def check_lanes(self, name, args, kw, out):
        """Hold ``self.lanes`` random lanes and the last TAIL_LANES lanes of
        a lane-parallel call."""
        import torch

        q = args[2].shape[0]
        head = q - min(q, TAIL_LANES)
        idx = torch.cat([torch.randperm(head, generator=self.gen)[:self.lanes].sort().values,
                         torch.arange(head, q)]).to(args[2].device)
        sub = (*args[:2], *(t[idx].contiguous() for t in args[2:]))
        got = tuple(o[idx] for o in out) if isinstance(out, tuple) else out[idx]
        self.err[name] = max(self.err[name], max_abs_err(got, plain_of(name, sub, kw)))
        self.sampled[name] += 1
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
                n = self.seen[name]
                self.seen[name] += 1
                if (self.lanes and name in ("k2_scan", "k2_check")
                        and args[2].shape[0] > self.lanes):
                    return self.check_lanes(name, args, kw, out)
                if n >= 4 and n % self.every:
                    return out
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
        s, p, o = ids[:, 0], ids[:, 1], ids[:, 2]
        self.by_s = ids[self._order(s, p, o)]
        self.by_o = ids[self._order(o, p, s)]
        self.by_p = ids[self._order(p, s, o)]
        self.n_preds = int(ids[:, 1].max()) if len(ids) else 0

    def _order(self, *cols):
        """``np.lexsort`` of the columns (most significant first) as one
        stable argsort of packed keys when they fit in 63 bits."""
        np = self.np
        bits = [int(c.max()).bit_length() if len(c) else 1 for c in cols]
        if sum(bits) > 63 or any(len(c) and c.min() < 0 for c in cols):
            return np.lexsort(cols[::-1])
        key = np.zeros(len(cols[0]), np.int64)
        for c, b in zip(cols, bits):
            key = (key << b) | c
        return np.argsort(key, kind="stable")

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
    for _, q, cfg, batch, *_ in work:
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


def join_split(engine, work, device) -> dict:
    """Host/device split of one E and one F join of ``work``: the traced
    ``plan.call`` with its ``plan.dispatch`` (launches), ``plan.sync`` (the
    host waiting on the card) and ``plan.decode`` (the Y block's copy and
    decode) spans, beside the join's device ms (``time_ms`` around its
    kernels alone)."""
    import torch

    from repro_torch import obs
    from repro_torch.core import joins

    m, f = engine.meta, engine.forest
    out = {}
    for cat in "EF":
        label, q, cfg, _ = next(w for w in work if w[0].startswith(f"join {cat}"))
        plan = engine.compile(q, cfg.replace(device=str(engine.device)))
        plan()
        tracer, _ = obs.enable()
        try:
            plan()
        finally:
            obs.disable()
        spans = {e["name"]: (e["t1"] - e["t0"]) / 1e6 for e in tracer.events()}
        ex = plan._executor
        # constants uploaded once: a Python int would be copied to the card
        # in every call, which waits for the stream the timing holds
        p1, c1 = (torch.tensor(v, dtype=torch.int32, device=device) for v in (q.p1 or 1, q.c1))
        if cat == "E":
            call = lambda: joins.join_e(m, f, p1, c1, q.vpos1, q.vpos2,  # noqa: E731
                                        cap_x=ex.cap, cap_y=ex.cap_y)
        else:
            call = lambda: joins.join_f(m, f, c1, q.vpos1, q.vpos2,  # noqa: E731
                                        cap_x=ex.cap, cap_y=ex.cap_y)
        dev_ms = time_ms(call, 5)
        row = {k: spans[k] for k in ("plan.call", "plan.dispatch", "plan.sync", "plan.decode")}
        row.update(device_ms=dev_ms, device_idle_share=1.0 - dev_ms / spans["plan.call"])
        out[label] = row
    return out


# ---------------------------------------------------------------------------
# the SELECT/BGP path (phase 5c)
# ---------------------------------------------------------------------------

SELECT_SHAPES = ("select serve-shape", "select star", "select path",
                 "select union+filter", "bgp fully-free")


def select_work(ds, oracle, seed: int) -> list:
    """Phase 5c's workload: ``(label, query, config, None, params)`` items
    (no batch) with constants from real triples; ``params`` feed the numpy
    evaluation."""
    import numpy as np

    from repro_torch.core.algebra import Cmp
    from repro_torch.core.query import BgpQ, ExecConfig, SelectQ
    from repro_torch.core.query import TriplePatternQ as T
    from repro_torch.launch import serve

    rng = np.random.default_rng(seed)
    ids = ds.ids
    cfg = ExecConfig(cap=1024)
    work = []

    def other_pred(s):
        mine = oracle._slice(oracle.by_s, 0, s)
        return int(mine[rng.integers(0, len(mine)), 1])

    for s, p, _ in ids[rng.integers(0, ds.n_triples, 256)].tolist():
        p2 = int(rng.integers(1, ds.n_preds + 1))
        work.append(("select serve-shape", serve.select_query(s, p, p2), cfg, None, (s, p, p2)))
    for s, p1, o in ids[rng.integers(0, ds.n_triples, 64)].tolist():
        p2 = other_pred(s)
        work.append(("select star", SelectQ(where=(T("?s", p1, o), T("?s", p2, "?x"))),
                     cfg, None, (p1, o, p2)))
    is_s = np.zeros(max(ds.n_subjects, ds.n_objects) + 1, np.bool_)
    is_s[ids[:, 0]] = True
    for s, p1, y in ids[rng.choice(np.nonzero(is_s[ids[:, 2]])[0], 64)].tolist():
        p2 = other_pred(y)
        work.append(("select path", SelectQ(where=(T(s, p1, "?y"), T("?y", p2, "?z"))),
                     cfg, None, (s, p1, p2)))
    for s, p1, _ in ids[rng.integers(0, ds.n_triples, 32)].tolist():
        p2 = other_pred(s)
        cut = int(np.median(oracle._slice(oracle.by_s, 0, s)[:, 2]))
        q = SelectQ(union=((T(s, p1, "?o"),), (T(s, p2, "?o"),)), filter=(Cmp(">=", "?o", cut),))
        work.append(("select union+filter", q, cfg, None, (s, p1, p2, cut)))
    sizes = [oracle.pairs(p).shape[0] for p in range(1, ds.n_preds + 1)]
    p_small = 1 + int(np.argmin(sizes))
    big = ExecConfig(cap=1 << int(np.ceil(np.log2(sizes[p_small - 1]))))
    keys = oracle.by_s[:, :2]
    first = np.ones(len(keys), np.bool_)
    first[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    starts = np.nonzero(first)[0]
    single = starts[np.diff(np.append(starts, len(keys))) == 1]
    for s, p, _ in oracle.by_s[rng.choice(single, 8, replace=False)].tolist():
        q = BgpQ(((s, p, "?y"), ("?a", p_small, "?b")))
        work.append(("bgp fully-free", q, big, None, (s, p, p_small)))
    return work


def select_answer(oracle, label, params) -> dict:
    """The numpy evaluation of one phase-5c query over the id triples: the
    dataset's per-(s, p) / (p, o) slices joined with plain numpy, rows
    distinct and in the order the query asks (sorted-name columns; ORDER
    BY ?o then ?x; LIMIT 16)."""
    import numpy as np

    def rows(cols, parts):
        arr = np.concatenate(parts) if parts else np.zeros((0, len(cols)), np.int64)
        arr = np.unique(arr.astype(np.int64).reshape(-1, len(cols)), axis=0)
        return arr

    if label == "select serve-shape":
        s, p, p2 = params
        os_, xs = oracle.answer(1, s, p, 0), oracle.answer(1, s, p2, 0)
        xs = xs if xs.size else np.zeros(1, np.int64)
        arr = rows("ox", [np.stack(np.meshgrid(os_, xs, indexing="ij"), -1).reshape(-1, 2)])[:16]
        return {"?o": arr[:, 0], "?x": arr[:, 1]}
    if label == "select star":
        p1, o, p2 = params
        parts = [np.stack([np.full(len(xs), s), xs], 1)
                 for s in oracle.answer(2, 0, p1, o) for xs in [oracle.answer(1, s, p2, 0)]]
        arr = rows("sx", parts)
        return {"?s": arr[:, 0], "?x": arr[:, 1]}
    if label == "select path":
        s, p1, p2 = params
        parts = [np.stack([np.full(len(zs), y), zs], 1)
                 for y in oracle.answer(1, s, p1, 0) for zs in [oracle.answer(1, y, p2, 0)]]
        arr = rows("yz", parts)
        return {"?y": arr[:, 0], "?z": arr[:, 1]}
    if label == "select union+filter":
        s, p1, p2, cut = params
        os_ = np.concatenate([oracle.answer(1, s, p1, 0), oracle.answer(1, s, p2, 0)])
        arr = rows("o", [os_[os_ >= cut][:, None]])
        return {"?o": arr[:, 0]}
    s, p, p_small = params
    pairs = oracle.pairs(p_small)
    parts = [np.concatenate([pairs, np.full((len(pairs), 1), y)], 1)
             for y in oracle.answer(1, s, p, 0)]
    arr = rows("aby", parts)
    return {"?a": arr[:, 0], "?b": arr[:, 1], "?y": arr[:, 2]}


def same_select(ans, want) -> bool:
    """Same columns in the same order, equal int64 values in the same row
    order."""
    import numpy as np

    return list(ans) == list(want) and all(
        ans[k].dtype == np.int64 and np.array_equal(ans[k], want[k]) for k in want)


def check_select_work(work, results, oracle) -> dict:
    """Every phase-5c answer against the numpy evaluation (same columns in
    the same order, equal int64 values in the same row order); returns
    ``{label: (seconds, ...)}`` and the per-label non-empty counts."""
    lat, nonempty = {}, {}
    for (label, q, _, _, params), (ans, sec, _) in zip(work, results):
        want = select_answer(oracle, label, params)
        if not same_select(ans, want):
            fail(f"{label} {q} disagrees with the numpy evaluation")
        lat.setdefault(label, []).append(sec)
        nonempty[label] = nonempty.get(label, 0) + bool(len(next(iter(want.values()))))
    return lat, nonempty


def select_split(engine, work) -> dict:
    """Where one query of each phase-5c shape spends its host clock: the
    traced call's span sums (``planner.order`` blocks, ``plan.lanes``
    dispatches, ``engine.fetch`` waits and copies, ``engine.compile``)
    beside its wall; the rest is lowering, host table algebra and dedup."""
    import torch

    from repro_torch import obs

    out = {}
    for label in SELECT_SHAPES:
        _, q, cfg, _, _ = next(w for w in work if w[0] == label)
        plan = engine.compile(q, cfg.replace(device=str(engine.device)))
        tracer, _ = obs.enable()
        try:
            t0 = time.perf_counter()
            plan()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            obs.disable()
        sums: dict = {}
        for e in tracer.events():
            if e["kind"] == "X":
                sums[e["name"]] = sums.get(e["name"], 0.0) + (e["t1"] - e["t0"]) / 1e6
        blocks = sums.get("planner.order", 0.0)
        out[label] = dict(wall_ms=wall, **{f"{k}_ms": v for k, v in sorted(sums.items())},
                          outside_blocks_ms=wall - blocks)
    return out


def device_busy(prof) -> dict:
    """Device busy time of a ``torch.profiler`` window: the union of its
    kernel, memcpy and memset intervals, read from the profiler's Chrome
    export.  Fails when the profiler recorded no device activity."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "profile.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    device = [e for e in events if e.get("ph") == "X"
              and str(e.get("cat", "")).lower() in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        fail("the CUDA profiler recorded no device activity")
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device):
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    kernels = sum(str(e["cat"]).lower() == "kernel" for e in device)
    return dict(busy_ms=busy_us / 1e3, kernels=kernels, copies_and_sets=len(device) - kernels)


def serve_obs_phase(engine, ds, oracle, n_queries, n_tenants, cap, max_batch, seed,
                    main_wall: float, trace_out: str | None) -> dict:
    """The broker trace of phase 5 traced and under the CUDA profiler
    (lanes only), then the trace with 5% SELECTs with observability off, on,
    and under the profiler: every query of every run answered and equal to
    the numpy oracle, the traced SELECT run's Chrome trace valid with
    per-query spans, the qps of every run, the host split of a serve batch
    from the spans, and the device idle share of the untraced runs from the
    profiler's busy time."""
    import contextlib

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import engine as eng
    from repro_torch.core.query import ObsConfig, ServeQ
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.obs.validate import validate_chrome_trace

    lanes_trace = serve.make_trace(ds, n_queries, n_tenants, zipf_a=1.1, seed=seed)
    sel_trace = serve.make_trace(ds, n_queries, n_tenants, zipf_a=1.1, select_frac=0.05,
                                 seed=seed)
    profiled: dict = {}

    @contextlib.contextmanager
    def cuda_profile():
        before = dict(ops.LAUNCHES)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            yield
        profiled.update(prof=prof, launches=sum(ops.LAUNCHES[k] - before[k] for k in before))

    runs, chromes, busy = {}, {}, {}
    for label, trace, mode in (
        ("lanes, obs on", lanes_trace, "obs"), ("lanes, profiled", lanes_trace, "profile"),
        ("5% SELECT, obs off", sel_trace, None), ("5% SELECT, obs on", sel_trace, "obs"),
        ("5% SELECT, profiled", sel_trace, "profile"),
    ):
        n_sel = sum(len(row) == 2 for row in trace)
        tracer = obs.enable(ObsConfig(trace_capacity=1 << 18))[0] if mode == "obs" else None
        try:
            stats, answers, wall, _ = serve.serve_trace(
                engine, trace, n_tenants=n_tenants, cap=cap, max_batch=max_batch,
                deadline_ms=2.0, warmup=64, window=cuda_profile if mode == "profile" else None)
            torch.cuda.synchronize()
            chrome = None if tracer is None else tracer.to_chrome(metadata=obs.provenance())
        finally:
            obs.disable()
        unanswered = sum(a is None for a in answers)
        if unanswered or stats["selects"] != n_sel or stats["queries"] != n_queries:
            fail(f"{label}: {unanswered} unanswered, {stats['selects']} of {n_sel} selects, "
                 f"{stats['queries']} of {n_queries} queries")
        for i, row in enumerate(trace):
            if len(row) == 2:
                q = row[1]
                want = select_answer(oracle, "select serve-shape",
                                     (q.where[0].s, q.where[0].p, q.optional[0][0].p))
                ok = same_select(answers[i], want)
            else:
                ok = same_answer(answers[i], oracle.answer(*row[1:]))
            if not ok:
                fail(f"{label}: query {i} {row} disagrees with the numpy evaluation")
        runs[label] = dict(qps=n_queries / wall, wall_s=wall, p50_ms=stats["p50_ms"],
                           p99_ms=stats["p99_ms"], batches=stats["batches"])
        chromes[label] = chrome
        if mode == "profile":
            busy[label] = dict(device_busy(profiled["prof"]), launches=profiled["launches"])
            if busy[label]["kernels"] < profiled["launches"]:
                fail(f"{label}: the profiler saw {busy[label]['kernels']} kernels, "
                     f"fewer than the {profiled['launches']} launches of the port's kernels")
        print(f"broker, {label} ({n_sel} SELECTs): {n_queries / wall:.1f} qps, "
              f"p50 {stats['p50_ms']} ms, p99 {stats['p99_ms']} ms, "
              f"{stats['batches']} batches; every answer equals the numpy evaluation",
              flush=True)
    chrome = chromes["5% SELECT, obs on"]
    problems = validate_chrome_trace(chrome, require_queries=True)
    if problems:
        fail(f"the exported trace is invalid: {problems[:5]}")
    queries = {e["id"] for e in chrome["traceEvents"] if e.get("ph") == "b" and e["name"] == "query"}
    if len(queries) != n_queries:
        fail(f"the trace covers {len(queries)} of {n_queries} queries")
    if trace_out is not None:
        Path(trace_out).parent.mkdir(parents=True, exist_ok=True)
        Path(trace_out).write_text(json.dumps(chrome))
    lanes = np.array([row[1:] for row in lanes_trace[:max_batch]], np.int32).T
    plan = engine.compile(ServeQ(), engine.default_config.replace(cap=cap))
    prof = plan.cost_profile(eng.ServeBatch(*lanes))
    if prof.get("device_ms") is None:
        fail(f"no device ms in the serve step's cost profile: {prof}")
    print(f"cost profile of a 256-lane serve batch: {json.dumps(prof)}", flush=True)
    # the device's idle share over each untraced window: the profiled run's
    # busy time over its own wall, and over the wall of the same trace
    # served with neither tracing nor the profiler (phase 5's run for lanes)
    idle = {}
    for label, clean_wall in (("lanes, profiled", main_wall),
                              ("5% SELECT, profiled", runs["5% SELECT, obs off"]["wall_s"])):
        b = busy[label]
        idle[label] = dict(b, wall_ms=runs[label]["wall_s"] * 1e3,
                           batches=runs[label]["batches"],
                           device_idle_share=1.0 - b["busy_ms"] / (runs[label]["wall_s"] * 1e3),
                           idle_share_of_untraced_wall=1.0 - b["busy_ms"] / (clean_wall * 1e3))
        print(f"device idle share, {label} (torch.profiler, CUDA activity only): "
              f"{json.dumps(idle[label])}", flush=True)
    splits = {}
    for label in ("lanes, obs on", "5% SELECT, obs on"):
        spans: dict = {}
        for e in chromes[label]["traceEvents"]:
            if e.get("ph") == "X":
                spans.setdefault(e["name"], []).append(e["dur"] / 1e3)
        med = {k: float(np.median(v)) for k, v in spans.items()}
        split = {
            "batch_ms": med["broker.batch"], "dispatch_ms": med["broker.dispatch"],
            "plan_submit_ms": med["plan.submit"], "inflight_ms": med["broker.inflight"],
            "fetch_ms": med["broker.fetch"], "decode_deliver_ms": med["broker.decode_deliver"],
            "engine_fetch_ms": med["engine.fetch"], "device_ms_per_batch": prof["device_ms"],
        }
        if "broker.select" in med:
            split.update(select_ms=med["broker.select"], planner_block_ms=med["planner.order"],
                         plan_lanes_ms=med["plan.lanes"])
        splits[label] = split
        print(f"serve batch host split, {label} (span medians, ms): {json.dumps(split)}",
              flush=True)
    print(f"obs overhead: lanes {n_queries / main_wall:.1f} -> "
          f"{runs['lanes, obs on']['qps']:.1f} qps, "
          f"5% SELECT {runs['5% SELECT, obs off']['qps']:.1f} -> "
          f"{runs['5% SELECT, obs on']['qps']:.1f} qps; trace: {len(chrome['traceEvents'])} "
          f"events, {len(queries)} queries, valid", flush=True)
    return dict(runs=runs, splits=splits, idle=idle, cost_profile=prof)


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
    launch queue, which then blocks the host until the sleep has ended.
    After four tries the run fails."""
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
        peak = PEAK_F32_FLOPS if a.dtype == torch.float32 else PEAK_BF16_FLOPS
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
    return (*roofline.bound_ms(nbytes, ops_, peak), int(nbytes), int(ops_))


def path_ms(name, *recorders) -> dict:
    """Device ms and bound ms of a kernel summed over every call a recorder
    captured (the serve step of phase 4, the pattern/join run of phase 5b,
    the SELECT run of phase 5c),
    each call timed on its own inputs: the weight of the kernel on a path."""
    out = {}
    for label, recorder in zip(("serve_step", "patterns_joins", "select"), recorders):
        dev = low = 0.0
        for cargs, kw, res in recorder.calls[name]:
            dev += time_ms(lambda f=recorder.orig[name], a=cargs, k=kw: f(*a, **k), 5)
            low += float(bound(name, cargs, kw, res)[0])
        out[label] = dict(calls=len(recorder.calls[name]), device_ms=dev, bound_ms=low)
    return out


def main_path_shapes(name, *recorders):
    """Every recorded call of kernel ``name`` on the serve step and in phases
    5b and 5c, and for the lane-latency-bound kernels also the first recorded
    call's first lane alone (Q=1): one lane's latency."""
    calls = [c for recorder in recorders for c in recorder.calls[name]]
    if name in ("k2_scan", "k2_check", "pred_gather_dac", "pred_gather") and calls:
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
    # sparse A in dense B: a tile's share of B exceeds the shared window
    b = np.sort(rng.choice(10**8, 2**20, replace=False)).astype(np.int32)
    a = np.sort(np.concatenate([rng.choice(b, 1024, replace=False),
                                rng.integers(0, 10**8, 1024)])).astype(np.int32)
    members.append((a, b))
    cases.append(("sorted_intersect_mask", "fallback: 2048 ids spread over 2^20",
                  (torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)), {}))
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
    joins = 2 + len(members)  # the first output of the joins' intersections
    for (a, b), out in zip(members, outs[2:joins]):
        if not np.array_equal(out[: a.size].cpu().numpy(), np.isin(a, b)) or bool(out[a.size:].any()):
            fail("sorted_intersect_mask disagrees with numpy membership")
    kept = 0
    for (a_ids, _, want), out in zip(intersects, outs[joins:joins + n_join]):
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
          f"statistical limit; peaks: f32 {PEAK_F32_FLOPS:.3g} FLOP/s "
          f"(FMA), bf16 {PEAK_BF16_FLOPS:.3g} FLOP/s (dense tensor core)", flush=True)
    return rows


# ---------------------------------------------------------------------------
# phase 8: the dynamic store and the string path
# ---------------------------------------------------------------------------

DELTA_FRAC = 0.05  # benchmarks/bench_dynamic.py's middle delta fraction
APPENDED = 64  # appended-range entities the inserts draw from
ROUND_WRITES, ROUND_READS, RACED_WRITES = 512, 256, 1024
READ_BATCHES = 100  # 8a's batches a delta size: p99 needs 100
# 8c's string corpus: cut from 1,000,000 (host-bound, 37-61 s) for the script's 1,200 s
STRING_TRIPLES = 500_000
COMPACT_TRIPLES = 1_000_000  # 8b's geonames-shaped store (phase 4's is 9.4 M)


def pack(ids):
    """int64 (s, p, o) keys ordered as the rows (o < 2^26, p < 64)."""
    return (ids[:, 0] << 32) | (ids[:, 1] << 26) | ids[:, 2]


def union_keys(*keys):
    """Sorted unique keys of the arrays together (a sort and an adjacent
    dedup: numpy 2.3's hash-based ``np.unique`` is slow at this size)."""
    import numpy as np

    k = np.sort(np.concatenate(keys))
    return k[np.concatenate(([True], k[1:] != k[:-1]))] if k.size else k


def unpack(keys):
    import numpy as np

    return np.stack([keys >> 32, (keys >> 26) & 63, keys & ((1 << 26) - 1)], axis=1)


class Churn:
    """Writes in the shape of ``bench_dynamic._churn``, mirrored on the host:
    half tombstones of static triples (each at most once), half fresh
    inserts from real subjects, objects and predicates, 5% of them with a
    subject and 5% with an object in the appended range past the static
    extents, and 5% on the appended predicate ``n_preds + 1``.  ``ins`` and
    ``tomb`` follow ``DeltaStore``'s semantics; the truth is
    (static − tomb) ∪ ins."""

    def __init__(self, ds, seed: int):
        import numpy as np

        self.np = np
        self.rng = np.random.default_rng(seed)
        self.static = ds.ids
        self.ext = max(ds.n_subjects, ds.n_objects)
        self.n_preds = ds.n_preds
        self.order = self.rng.permutation(ds.n_triples)
        self.next_tomb = 0
        self.ins: set = set()
        self.tomb: set = set()

    def draw(self, n: int) -> list:
        np, rng, st = self.np, self.rng, self.static
        half = n // 2
        dels = st[self.order[self.next_tomb: self.next_tomb + half]]
        self.next_tomb += half
        m = n - half
        s = st[rng.integers(0, st.shape[0], m), 0]
        o = st[rng.integers(0, st.shape[0], m), 2]
        p = rng.integers(1, self.n_preds + 1, m)
        u = rng.random((3, m))
        s = np.where(u[0] < 0.05, self.ext + 1 + rng.integers(0, APPENDED, m), s)
        o = np.where(u[1] < 0.05, self.ext + 1 + rng.integers(0, APPENDED, m), o)
        p = np.where(u[2] < 0.05, self.n_preds + 1, p)
        ins = np.stack([s, p, o], axis=1)
        out = []
        for i in range(max(half, m)):
            if i < half:
                out.append(("del", tuple(int(v) for v in dels[i])))
            if i < m:
                out.append(("ins", tuple(int(v) for v in ins[i])))
        return out

    def apply(self, kind: str, t) -> None:
        if kind == "ins":
            self.tomb.discard(t)
            self.ins.add(t)
        else:
            self.ins.discard(t)
            self.tomb.add(t)

    def arrays(self):
        np = self.np
        as_arr = lambda ts: np.asarray(sorted(ts), np.int64).reshape(-1, 3)  # noqa: E731
        return as_arr(self.ins), as_arr(self.tomb)

    def truth_ids(self):
        """The merged id triples, unique and sorted."""
        np = self.np
        ins, tomb = self.arrays()
        keys = np.setdiff1d(pack(self.static), pack(tomb), assume_unique=True)
        return unpack(union_keys(keys, pack(ins)))

    def pools(self, live_sample: int, seed: int):
        """Constant pools: tombstoned, inserted, untouched static triples."""
        np = self.np
        ins, tomb = self.arrays()
        rng = np.random.default_rng(seed)
        rest = self.static[self.order[rng.integers(self.next_tomb, len(self.order), live_sample)]]
        return [a for a in (tomb, ins, rest) if len(a)]


class DeltaOracle:
    """(static − tombstones) ∪ inserts per lane, from an ``Oracle`` of the
    static triples and one each of the inserts and the tombstones."""

    def __init__(self, base, churn):
        import numpy as np

        self.np = np
        self.base = base
        ins, tomb = churn.arrays()
        self.ins, self.tomb = Oracle(ins), Oracle(tomb)

    def answer(self, op, s, p, o):
        np = self.np
        a, i, t = (x.answer(op, s, p, o) for x in (self.base, self.ins, self.tomb))
        if op == 0:
            return (a and not t) or i
        if op in (1, 2, 5):
            return np.union1d(np.setdiff1d(a, t), i)
        e = np.zeros(0, np.int64)
        out = {}
        for q in sorted(set(a) | set(i)):
            v = np.union1d(np.setdiff1d(a.get(q, e), t.get(q, e)), i.get(q, e))
            if v.size:
                out[q] = v
        return out


def mixed_lanes(rng, pools, n: int):
    """``n`` serve lanes in ``launch/serve.py``'s op mix, constants from the
    pools in equal thirds (unbounded ops leave the predicate free)."""
    import numpy as np

    from repro_torch.launch import serve

    ops_pool = list(serve._OP_WEIGHTS)
    w = np.array([serve._OP_WEIGHTS[op] for op in ops_pool])
    ops = rng.choice(ops_pool, size=n, p=w / w.sum()).astype(np.int32)
    which = rng.integers(0, len(pools), n)
    rows = np.stack([pools[k][rng.integers(0, len(pools[k]))] for k in which])
    p = np.where(ops >= 3, 0, rows[:, 1])
    return np.stack([ops, rows[:, 0], p, rows[:, 2]]).astype(np.int32)


def check_lanes(lanes, host, oracle, where: str) -> None:
    from repro_torch.core import engine as eng

    for i in range(lanes.shape[1]):
        op, s, p, o = (int(v) for v in lanes[:, i])
        if not same_answer(eng.decode_lane(op, host, i), oracle.answer(op, s, p, o)):
            fail(f"{where}: lane {(op, s, p, o)} disagrees with the oracle")


def serve_batches(engine, rng, pools, oracle, n_batches: int, label: str) -> dict:
    """``n_batches`` 256-lane ``ServeQ`` batches at cap 1024, every lane
    checked; -> p50/p99 ms a batch (``plan(batch)`` to the host result)."""
    import torch

    from repro_torch.core import engine as eng
    from repro_torch.core.query import ServeQ
    from repro_torch.launch.broker import tail_percentile

    plan = engine.compile(ServeQ(), engine.default_config.replace(cap=1024))
    secs = []
    for _ in range(n_batches):
        lanes = mixed_lanes(rng, pools, 256)
        t0 = time.perf_counter()
        host = eng.host_result(plan(eng.ServeBatch(*lanes)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        check_lanes(lanes, host, oracle, label)
    ms = lambda q: None if tail_percentile(secs, q) is None else 1e3 * tail_percentile(secs, q)  # noqa: E731
    return dict(batches=n_batches, p50_ms=ms(50), p99_ms=ms(99), max_ms=1e3 * max(secs))


def reads_8a(store, ds, oracle, device, seed: int, n_batches: int):
    """Phase 8a: the geonames store wrapped in a ``DynamicStore`` (no
    rebuild), churned to 0, 4,096 and 5% of its triples; at each size 256-
    lane batches against the merged oracle, and at 4,096 the pattern and
    join work.  -> (launches of the timed runs, kernel-check errors)."""
    import numpy as np
    import torch

    from repro_torch.core import delta, engine as eng
    from repro_torch.kernels import ops

    dyn = delta.DynamicStore(store)
    engine = eng.Engine(dyn, device=device)
    churn = Churn(ds, seed)
    rng = np.random.default_rng(seed + 1)
    launches = dict.fromkeys(KERNELS, 0)
    err = dict.fromkeys(QUERY_KERNELS, 0)
    sizes = sorted({0, 4096, int(DELTA_FRAC * ds.n_triples)})
    for size in sizes:
        t0 = time.perf_counter()
        for kind, t in churn.draw(size - len(churn.ins) - len(churn.tomb)):
            (dyn.insert if kind == "ins" else dyn.delete)(*t)
            churn.apply(kind, t)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        view = delta.view_of(dyn)
        snap_s = time.perf_counter() - t0
        held = 0 if view is None else view.snap.n_inserts + view.snap.n_tombstones
        if held != len(churn.ins) + len(churn.tomb):
            fail(f"8a: the delta holds {held} entries, not {len(churn.ins) + len(churn.tomb)}")
        t0 = time.perf_counter()
        merged = churn.truth_ids() if size else ds.ids
        m_oracle = Oracle(merged) if size else oracle
        oracle_s = time.perf_counter() - t0
        pools = churn.pools(4096, seed + size)
        if size == 4096:
            work = delta_work(ds, churn, m_oracle, pools, seed)
            rec = Recorder()
            with rec:  # the kernels against their plain versions on these inputs
                run_work(engine, work)
                serve_batches(engine, rng, pools, m_oracle, 1, "8a recorded")
            torch.cuda.synchronize()
            for k in QUERY_KERNELS:
                err[k] = max(err[k], rec.err[k])
            print(f"8a kernel checks on the delta inputs: "
                  f"{ {k: len(v) for k, v in rec.calls.items()} } calls, max_abs_err {rec.err}",
                  flush=True)
            del rec
        ops.reset_launches()
        stats = serve_batches(engine, rng, pools, m_oracle, n_batches, f"8a delta {size}")
        if size == 4096:
            t0 = time.perf_counter()
            results = run_work(engine, work)
            torch.cuda.synchronize()
            q_wall = time.perf_counter() - t0
            lat, nonempty = check_work(work, results, m_oracle, merged.shape[0])
            print(f"8a delta {size}: {len(work)} pattern/join plan calls in {q_wall:.3f}s, every "
                  f"answer equals the merged oracle (dump: {merged.shape[0]} triples, "
                  f"{len(m_oracle.pairs(ds.n_preds + 1))} on the appended predicate)", flush=True)
            for label, runs in lat.items():
                secs = [sec for sec, _ in runs]
                print(f"8a latency {label}: {len(secs)} calls, median {1e3 * np.median(secs):.3f} ms, "
                      f"max {1e3 * max(secs):.3f} ms, {nonempty.get(label, '-')} non-empty",
                      flush=True)
        torch.cuda.synchronize()
        for k, v in ops.LAUNCHES.items():
            launches[k] += v
        print(f"8a delta {size}: {len(churn.ins)} inserts + {len(churn.tomb)} tombstones written "
              f"in {write_s:.3f}s, snapshot built in {1e3 * snap_s:.3f} ms, merged oracle in "
              f"{oracle_s:.1f}s; {stats['batches']} batches of 256 lanes: p50 {stats['p50_ms']} "
              f"ms, p99 {stats['p99_ms']} ms, max {stats['max_ms']} ms a batch; every lane "
              f"equals the oracle; launches {dict(ops.LAUNCHES)}", flush=True)
    return launches, err


def delta_work(ds, churn, m_oracle, pools, seed: int) -> list:
    """Phase 5b's pattern and join work over the dynamic store: the six
    serve-lane patterns with constants from the three pools, (?S,P,?O) of
    every predicate (the appended one included) and the dump, and joins
    A-F over the four vpos pairs with constants from live triples."""
    import types

    import numpy as np

    ext = churn.ext + APPENDED
    mix = np.concatenate(pools)
    like = lambda ids: types.SimpleNamespace(  # noqa: E731
        ids=ids, n_triples=ids.shape[0], n_preds=ds.n_preds + 1, n_subjects=ext, n_objects=ext)
    patterns = [w for w in query_work(like(mix), m_oracle, seed, per_join=0)]
    live = np.concatenate(pools[1:]) if len(pools) > 1 else pools[0]
    joins = [w for w in query_work(like(live), m_oracle, seed + 1, per_join=1)
             if w[0].startswith("join")]
    return patterns + joins


async def writes_8b(engine, oracle, churn, n_tenants: int, seed: int) -> dict:
    """Phase 8b: rounds of 512 writes then 256 checked reads through a
    ``ServeBroker`` with the default ``CompactionPolicy``, until one
    compaction trips and lands (rounds of 8 writes while it rebuilds, at
    most 1,024 of them), then two full rounds at epoch 1."""
    import asyncio

    import numpy as np
    import torch

    from repro_torch.core import compaction
    from repro_torch.launch import serve
    from repro_torch.launch.broker import CoalescePolicy, ServeBroker

    rng = np.random.default_rng(seed)
    tenants = [f"tenant-{i}" for i in range(n_tenants)]
    zipf = serve.zipf_weights(n_tenants, 1.1)
    b = ServeBroker(engine, engine.default_config.replace(cap=1024),
                    coalesce=CoalescePolicy(max_batch=256, max_delay_s=2e-3),
                    compaction=compaction.CompactionPolicy())
    out = {"rounds": {}, "raced": []}

    def write(n):
        for kind, t in churn.draw(n):
            tenant = tenants[rng.choice(n_tenants, p=zipf)]
            (b.submit_insert_nowait if kind == "ins" else b.submit_delete_nowait)(tenant, *t)
            churn.apply(kind, t)
            if out.get("t_trip") is None and b._compaction_task is not None:
                out["t_trip"] = time.perf_counter()
            elif out.get("t_trip") is not None and not b._compaction_task.done():
                out["raced"].append((kind, t))

    async def read(label):
        d_oracle = DeltaOracle(oracle, churn)
        lanes = mixed_lanes(rng, churn.pools(4096, int(rng.integers(1 << 30))), ROUND_READS)
        who = rng.choice(n_tenants, size=ROUND_READS, p=zipf)
        t0 = time.perf_counter()
        futs = [b.submit_nowait(tenants[w], *(int(v) for v in lanes[:, i]))
                for i, w in enumerate(who)]
        answers = await asyncio.gather(*futs)
        wall = time.perf_counter() - t0
        for i, ans in enumerate(answers):
            op, s, p, o = (int(v) for v in lanes[:, i])
            if not same_answer(ans, d_oracle.answer(op, s, p, o)):
                fail(f"8b {label}: lane {(op, s, p, o)} disagrees with the oracle")
        r = out["rounds"].setdefault(label, dict(reads=0, wall=0.0))
        r["reads"] += ROUND_READS
        r["wall"] += wall

    def close(label):
        st = b.stats()
        out["rounds"].setdefault(label, dict(reads=0, wall=0.0)).update(
            p50_ms=st["p50_ms"], p99_ms=st["p99_ms"])
        b.reset_stats()

    torch.cuda.reset_peak_memory_stats(engine.device)
    async with b:
        b.reset_stats()
        while b._compaction_task is None:
            write(ROUND_WRITES)
            if b._compaction_task is not None:
                close("before")
            await read("before" if b._compaction_task is None else "during")
        while not b._compaction_task.done():
            write(8 if len(out["raced"]) < RACED_WRITES else 0)
            await read("during")
        rep = await b._compaction_task
        out["t_swap"] = time.perf_counter()
        out["peak_bytes"] = torch.cuda.max_memory_allocated(engine.device)
        close("during")
        out["epoch"] = engine.store.epoch
        # every write that raced the rebuild survives the swap
        d_oracle = DeltaOracle(oracle, churn)
        futs = [b.submit_nowait(tenants[0], 0, *t) for _, t in out["raced"]]
        for (kind, t), ans in zip(out["raced"], await asyncio.gather(*futs)):
            if bool(ans) != d_oracle.answer(0, *t):
                fail(f"8b: the raced {kind} of {t} did not survive the swap")
        for _ in range(2):
            write(ROUND_WRITES)
            await read("after")
        out["stats"] = b.stats()
        close("after")
        out["compaction"] = b.last_compaction
    out["report"] = rep
    return out


def strings_8c(device, n_triples: int, seed: int) -> dict:
    """Phase 8c: ``from_string_triples`` over ``n_triples`` geonames-like
    string triples, 256 string queries (encode, serve lanes, decode) against
    a Python evaluation over the strings, then ``insert_strings`` of unseen
    terms and ``delete_strings`` read back before and after ``compact``."""
    import numpy as np
    import torch

    from repro_torch.core import compaction, delta, dictionary, engine as eng, k2triples
    from repro_torch.core.query import ServeQ
    from repro_torch.data import rdf

    out = {}
    t0 = time.perf_counter()
    strs = rdf.generate_strings(n_triples, like="geonames", seed=seed)
    out["generate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = dictionary.build_compressed_dictionary(strs)
    out["dictionary_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d.encode_triples(strs)
    out["encode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    store = k2triples.from_string_triples(strs, device=device)
    torch.cuda.synchronize()
    out["from_string_triples_s"] = time.perf_counter() - t0
    n = store.n_triples
    out.update(n_string_triples=len(strs), n_triples=n,
               dictionary_bits_per_triple=k2triples.size_dictionary_bits(store) / n,
               k2_bits_per_triple=k2triples.size_k2triples_bits(store) / n,
               pred_index_bits_per_triple=k2triples.size_pred_index_bits(store) / n)

    # the Python evaluation over the string triples
    by_s, by_o = {}, {}
    for t in set(strs):
        by_s.setdefault(t[0], []).append(t)
        by_o.setdefault(t[2], []).append(t)

    def truth(op, s, p, o):
        if op == 0:
            return any(t[1] == p and t[2] == o for t in by_s.get(s, ()))
        if op == 1:
            return sorted(t[2] for t in by_s.get(s, ()) if t[1] == p)
        if op == 2:
            return sorted(t[0] for t in by_o.get(o, ()) if t[1] == p)
        if op == 5:
            return sorted(t[1] for t in by_s.get(s, ()) if t[2] == o)
        res = {}
        for t in (by_s.get(s, ()) if op == 3 else by_o.get(o, ())):
            res.setdefault(t[1], []).append(t[2] if op == 3 else t[0])
        return {k: sorted(v) for k, v in res.items()}

    def run(engine, queries, where):
        dd = engine.store.dictionary
        lanes = np.zeros((4, len(queries)), np.int32)
        for i, (op, s, p, o) in enumerate(queries):
            lanes[:, i] = (op, dd.encode_subject(s) if s else 0, dd.encode_predicate(p) if p else 0,
                           dd.encode_object(o) if o else 0)
        plan = engine.compile(ServeQ(), engine.default_config.replace(cap=1024))
        host = eng.host_result(plan(eng.ServeBatch(*lanes)))
        for i, (op, s, p, o) in enumerate(queries):
            got = eng.decode_lane(op, host, i)
            dec_o = dd.decode_object if op in (1, 3) else dd.decode_subject
            if op == 0:
                got = bool(got)
            elif op == 5:
                got = sorted(dd.decode_predicate(int(v)) for v in got)
            elif op in (1, 2):
                got = sorted(dec_o(int(v)) for v in got)
            else:
                got = {dd.decode_predicate(k): sorted(dec_o(int(v)) for v in vs)
                       for k, vs in got.items()}
            if got != truth(op, s, p, o):
                fail(f"{where}: string query {(op, s, p, o)} disagrees with the evaluation")

    rng = np.random.default_rng(seed)
    engine = eng.Engine(store, device=device)
    picks = [strs[i] for i in rng.integers(0, len(strs), 256)]
    ops_ = rng.choice(6, 256)
    queries = [(int(op), s if op in (0, 1, 3, 5) else None, p if op in (0, 1, 2) else None,
                o if op in (0, 2, 4, 5) else None) for op, (s, p, o) in zip(ops_, picks)]
    t0 = time.perf_counter()
    run(engine, queries, "8c")
    out["queries_s"] = time.perf_counter() - t0

    # writes through the dictionary: unseen terms mint appended ids
    dyn = delta.DynamicStore(store)
    engine = eng.Engine(dyn, device=device)
    new = [(f"http://ex.org/new/s{i:04d}", "http://ex.org/p/new" if i % 4 == 0 else picks[i][1],
            f"http://ex.org/new/o{i:04d}" if i % 2 else picks[i][2]) for i in range(64)]
    gone = picks[64:128]
    dyn.insert_strings(new)
    dyn.delete_strings(gone)
    for t in new:
        by_s.setdefault(t[0], []).append(t)
        by_o.setdefault(t[2], []).append(t)
    for t in set(gone):
        by_s[t[0]].remove(t)
        by_o[t[2]].remove(t)
    dd = dyn.dictionary
    ids_before = dd.encode_triples(new)
    if not (ids_before[:, 0] > dd.ext_base).all():
        fail("8c: unseen subjects did not get appended ids")
    reads = ([(0, *t) for t in new + gone] + [(1, s, p, None) for s, p, _ in new]
             + [(3, s, None, None) for s, _, _ in new] + [(2, None, p, o) for _, p, o in gone])
    run(engine, reads, "8c before compaction")
    t0 = time.perf_counter()
    rep = compaction.compact(dyn)
    out["compact_s"] = time.perf_counter() - t0
    if rep.epoch != 1 or not np.array_equal(dd.encode_triples(new), ids_before):
        fail("8c: an id moved across the compaction")
    run(engine, reads, "8c at epoch 1")
    out.update(epoch=dyn.epoch, written=len(new) + len(gone), reads=len(reads))
    return out


def dynamic_phase(store, ds, oracle, device, n_tenants: int, args) -> dict:
    """Phase 8 (8a reads over a delta, 8b broker writes and a compaction,
    8c strings); -> the launches of its timed runs and its kernel checks."""
    import asyncio

    import numpy as np
    import torch

    from repro_torch.core import compaction, delta, engine as eng, k2triples
    from repro_torch.data import rdf
    from repro_torch.kernels import ops

    phase("8a. reads over a delta on the geonames store")
    t0 = time.perf_counter()
    launches, err = reads_8a(store, ds, oracle, device, args.seed + 5, n_batches=READ_BATCHES)
    if any(err.values()):
        fail(f"kernels disagree with their plain versions on the delta inputs: {err}")
    if not all(launches[k] for k in SERVE_KERNELS + ("pred_gather", "k2_range")):
        fail(f"a kernel of the dynamic read path never launched: {launches}")
    print(f"8a done in {time.perf_counter() - t0:.1f}s", flush=True)

    phase(f"8b. broker writes and one compaction on a {COMPACT_TRIPLES}-triple geonames-shaped "
          "store")
    t0 = time.perf_counter()
    # cut from phase 4's store: the compaction's host rebuild of 9.4 M triples took 116 of
    # 8b's 134.9 s, and the script runs within 1,200 s
    cds = rdf.generate_like("geonames", COMPACT_TRIPLES, seed=args.seed + 15)
    cstore = k2triples.from_id_triples(
        cds.ids, n_so=cds.n_so, n_subjects=cds.n_subjects, n_objects=cds.n_objects,
        n_preds=cds.n_preds, device=device)
    coracle = Oracle(cds.ids)
    print(f"8b store: {cstore.n_triples} triples, {cstore.n_preds} preds, built with its oracle "
          f"in {time.perf_counter() - t0:.1f}s", flush=True)
    engine = eng.Engine(delta.DynamicStore(cstore), device=device)
    churn = Churn(cds, args.seed + 6)
    ops.reset_launches()
    out = asyncio.run(writes_8b(engine, coracle, churn, n_tenants, args.seed + 7))
    torch.cuda.synchronize()
    for k, v in ops.LAUNCHES.items():
        launches[k] += v
    st, rep, comp = out["stats"], out["report"], out["compaction"]
    if out["epoch"] != 1 or rep.epoch != 1 or comp["report"] is not rep:
        fail(f"8b: the store is at epoch {out['epoch']} after one compaction")
    rounds = {k: dict(v, qps=v["reads"] / v["wall"]) for k, v in out["rounds"].items()}
    print(f"8b: {json.dumps(rounds)}", flush=True)
    print(f"8b compaction: epoch {rep.epoch}, {rep.n_triples} triples, {rep.delta_merged} inserts "
          f"merged, {rep.tombstones_applied} tombstones applied, {1e3 * rep.duration_s:.1f} ms "
          f"(split ms {json.dumps(rep.split_ms)}, base-plan refresh {comp['refresh_ms']:.1f} ms), "
          f"tripped to swapped {out['t_swap'] - out['t_trip']:.1f}s; {len(out['raced'])} writes "
          f"raced the rebuild and survived; peak device memory {out['peak_bytes']} bytes; "
          f"broker after: inserts {st['inserts']}, deletes {st['deletes']}, delta "
          f"{st['delta_triples']} + {st['tombstones']} tombstones", flush=True)
    new = engine.store.static
    # the compacted epoch's dump in full against the plain version, and its
    # ids against the truth: (dump − rebased tombstones) ∪ rebased inserts
    cap = max(int(new.host_nnz.max()), 1)
    preds = torch.arange(new.n_preds, dtype=torch.int32, device=device)
    got = ops.k2_range(new.meta, new.forest, preds, cap=cap)
    e = max_abs_err(got, plain_of("k2_range", (new.meta, new.forest, preds), dict(cap=cap)))
    err["k2_range"] = max(err["k2_range"], e)
    snap = engine.store.delta.snapshot()
    rins = np.asarray([(s, p, o) for p, v in snap.ins.items() for s, o in v], np.int64).reshape(-1, 3)
    rtomb = np.asarray([(s, p, o) for p, v in snap.tomb.items() for s, o in v], np.int64).reshape(-1, 3)
    keys = union_keys(np.setdiff1d(pack(compaction.dump_static_ids(new)), pack(rtomb),
                                   assume_unique=True), pack(rins))
    if e or not np.array_equal(keys, pack(churn.truth_ids())):
        fail(f"8b: the compacted epoch's dump disagrees (max_abs_err {e}) or its ids miss the truth")
    print(f"8b: the compacted dump ({new.n_triples} triples, cap {cap}) equals its plain version "
          f"and, with the rebased delta, the truth; done in {time.perf_counter() - t0:.1f}s",
          flush=True)

    phase("8c. the string path")
    ops.reset_launches()
    t0 = time.perf_counter()
    sres = strings_8c(device, args.string_triples, args.seed + 8)
    torch.cuda.synchronize()
    for k, v in ops.LAUNCHES.items():
        launches[k] += v
    print(f"8c: {json.dumps(sres)}; done in {time.perf_counter() - t0:.1f}s", flush=True)
    return dict(launches=launches, err=err)


# ---------------------------------------------------------------------------
# phase 9: sharded serving, quantile-sized lanes and the functional API
# ---------------------------------------------------------------------------

MESHES = ((1, 4), (2, 4), (1, 8))  # of the one card, repeated; (1, 8) pads 20 -> 24


class Tally:
    """The kernel launches of the calls made inside ``with tally:`` (or
    through ``tally(fn, ...)``), so that a path's count leaves out the
    unsharded runs it is compared with."""

    def __init__(self):
        self.counts = dict.fromkeys(KERNELS, 0)

    def __enter__(self):
        from repro_torch.kernels import ops

        self.before = dict(ops.LAUNCHES)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for k in self.counts:
            self.counts[k] += ops.LAUNCHES[k] - self.before[k]

    def __call__(self, fn, *args, **kw):
        with self:
            return fn(*args, **kw)


def same_result(got, want, where: str) -> None:
    """Two ``ServeResult``s equal field by field (values, dtypes, shapes)."""
    from repro_torch.core import engine as eng

    for name in eng.RESULT_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if g.dtype != w.dtype or g.shape != w.shape or not (g == w).all():
            fail(f"{where}: field {name} differs from the unsharded plan")


def check_decoded(ops_, lanes, host, oracle, idx, where: str) -> None:
    from repro_torch.core import engine as eng

    for i in idx:
        args = [int(v) for v in lanes[1:, i]]
        if not same_answer(eng.decode_lane(int(ops_[i]), host, i), oracle.answer(int(ops_[i]), *args)):
            fail(f"{where}: lane {i} {int(ops_[i])} {args} disagrees with the oracle")


def sharded_9a(engine, ds, oracle, trace, work, device, tally, seed: int) -> dict:
    """Sharded serve plans on three meshes of the card against the
    unsharded plan and the oracle, the six serve-lane patterns on (2, 4),
    the sharded all-preds sweep, the refusals.  -> the meshes by shape."""
    import numpy as np
    import torch

    from repro_torch.core import engine as eng
    from repro_torch.core.query import (
        BgpQ, ExecConfig, JoinQ, SelectQ, ServeQ, TriplePatternQ,
    )
    from repro_torch.launch import mesh as meshlib, serve

    rng = np.random.default_rng(seed)
    base = ExecConfig(cap=1024, device=str(device))
    meshes = {shape: meshlib.make_mesh(shape, ("data", "model"), [device] * (shape[0] * shape[1]))
              for shape in MESHES}
    lanes_all = np.array([row[1:] for row in trace], np.int32).T
    n_checked = 0
    for k, (shape, mesh) in enumerate(meshes.items()):
        for b in range(2):
            # the second batch on (2, 4) reads the fixed-layout index
            cfg = base.replace(pred_index_layout="fixed" if (shape, b) == ((2, 4), 1) else "dac")
            plain = engine.compile(ServeQ(), cfg)
            plan = engine.compile(ServeQ(), cfg.replace(mesh=mesh))
            lo = (2 * k + b) * 256
            lanes = lanes_all[:, lo:lo + 256]
            if set(lanes[0]) != set(range(6)):
                fail(f"9a: batch {lo} covers ops {sorted(set(lanes[0]))}, not all six")
            qb = eng.ServeBatch(*lanes)
            got, want = eng.host_result(tally(plan, qb)), eng.host_result(plain(qb))
            same_result(got, want, f"9a mesh {shape} batch {lo}")
            idx = rng.choice(256, 512 // (2 * len(meshes)) + 1, replace=False)
            check_decoded(lanes[0], lanes, got, oracle, idx, f"9a mesh {shape}")
            n_checked += len(idx)
    print(f"9a: ServeQ on meshes {list(meshes)} of {device}: 6 batches of 256 lanes (all six "
          f"ops, unbounded through the DAC index, one batch through the fixed layout) equal "
          f"the unsharded plan field by field; "
          f"{n_checked} sampled lanes match the oracle", flush=True)

    mesh24 = meshes[(2, 4)]
    n_pat = 0
    for label, q, cfg, batch in work:
        if not label.startswith("pattern (") or label.split()[-1] != "dac" or batch is None:
            continue
        got = tally(engine.compile(q, cfg.replace(device=str(device), mesh=mesh24)), batch)
        want = engine.compile(q, cfg.replace(device=str(device)))(batch)
        if not all(same_answer(g, w) for g, w in zip(got, want)) or len(got) != len(want):
            fail(f"9a: {label} on the (2, 4) mesh disagrees with the unsharded plan")
        n_pat += 1
    if n_pat != 6:
        fail(f"9a: {n_pat} serve-lane pattern shapes ran on the mesh, not 6")
    print("9a: the six serve-lane TriplePatternQ shapes (256 constants each) on the (2, 4) "
          "mesh equal the unsharded plans", flush=True)

    mesh18 = meshes[(1, 8)]
    st = engine.store
    shards = eng.shard_forest(eng.pad_preds(st.forest, 8), mesh18)
    rows = ds.ids[rng.integers(0, ds.n_triples, 64)]
    axes = (np.arange(64) % 2).astype(np.int32)
    keys = np.where(axes == 1, rows[:, 2], rows[:, 0]).astype(np.int32)
    cap = 1024
    ids_u, valid_u, count_u = tally(eng.make_sharded_unbounded_scan(st.meta, mesh18, cap),
                                    shards, keys, axes)
    P = st.n_preds
    kt = torch.as_tensor(keys, device=device)
    at = torch.as_tensor(axes, device=device)
    r = eng.k2forest.scan_batch_mixed(
        st.meta, st.forest, torch.arange(P, dtype=torch.int32, device=device).repeat(64),
        torch.repeat_interleave(kt - 1, P), torch.repeat_interleave(at, P), cap)
    want_ids = torch.where(r.valid, r.ids + 1, 0).reshape(64, P, cap)
    if (ids_u.shape != (64, -(-P // 8) * 8, cap) or not torch.equal(ids_u[:, :P], want_ids)
            or not torch.equal(valid_u[:, :P], r.valid.reshape(64, P, cap))
            or not torch.equal(count_u[:, :P], r.count.reshape(64, P))
            or valid_u[:, P:].any() or count_u[:, P:].any()):
        fail("9a: make_sharded_unbounded_scan disagrees with the unsharded all-preds sweep")
    print(f"9a: make_sharded_unbounded_scan on 64 keys over the (1, 8) mesh ({P} trees padded "
          f"to {ids_u.shape[1]}) equals the unsharded all-preds sweep", flush=True)

    refused = 0
    cfg = base.replace(mesh=meshes[(1, 4)])
    for q in (TriplePatternQ("?s", 1, "?o"), TriplePatternQ("?s", "?p", "?o"),
              JoinQ("D", "s", "o", p1=1, c1=1, p2=1), JoinQ("E", "s", "o", p1=1, c1=1),
              JoinQ("F", "s", "o", c1=1), BgpQ((TriplePatternQ(1, "?p", "?o"),)),
              SelectQ(where=(TriplePatternQ(1, 2, "?o"),))):
        try:
            engine.compile(q, cfg)
        except ValueError:
            refused += 1
    if refused != 7:
        fail(f"9a: {7 - refused} of the 7 mesh refusals did not raise")
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        try:
            serve.run_bench(sharded=True, n_triples=1000, n_queries=8, quiet=True)
            fail("9a: run_bench(sharded=True) served on one card")
        except ValueError:
            bench = "run_bench(sharded=True) refuses one card"
    else:
        bench = f"run_bench(sharded=True) not tried: {n_cards} cards can serve it"
    print(f"9a: pairs, dump, joins D-F, BGP and SELECT refuse a mesh; {bench}", flush=True)
    return meshes


def sharded_broker_9a(engine, trace, oracle, meshes, device, tally, rec, n_tenants, cap,
                      max_batch) -> dict:
    """The broker over the (1, 4) mesh beside the unsharded broker, on
    phase 5's trace: every answer against the oracle, qps, p50/p99,
    launches and device ms a batch, the shards and the memory peak; a
    sharded run under ``torch.profiler`` (CUDA activity only) gives the
    device's idle share, and an untimed one under ``rec`` holds its
    kernel calls against their plain versions."""
    import numpy as np
    import torch

    from repro_torch.core import engine as eng
    from repro_torch.core.query import ServeQ
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    mesh = meshes[(1, 4)]
    out = {}
    profiled = {}

    @contextlib.contextmanager
    def cuda_profile():
        before = dict(ops.LAUNCHES)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            yield
        profiled.update(prof=prof, launches=sum(ops.LAUNCHES[k] - before[k] for k in before))

    for label, m in (("unsharded", None), ("sharded (1, 4)", mesh), ("sharded (1, 4) again", mesh),
                     ("unsharded again", None), ("sharded (1, 4) profiled", mesh),
                     ("sharded (1, 4) recorded", mesh)):
        torch.cuda.reset_peak_memory_stats(device)
        before = dict(ops.LAUNCHES)
        with contextlib.ExitStack() as held:
            if m is not None:
                held.enter_context(tally)
            if label.endswith("recorded"):
                held.enter_context(rec)
            stats, answers, wall, _ = serve.serve_trace(
                engine, trace, n_tenants=n_tenants, cap=cap, max_batch=max_batch,
                deadline_ms=2.0, warmup=64, mesh=m,
                window=cuda_profile if label.endswith("profiled") else None)
        torch.cuda.synchronize()
        launches = {k: v - before[k] for k, v in ops.LAUNCHES.items()}
        bad = [i for i, a in enumerate(answers) if a is None or not same_answer(a, oracle.answer(*trace[i][1:]))]
        if bad:
            fail(f"9a broker {label}: {len(bad)} of {len(trace)} answers disagree with the oracle")
        if label.endswith("recorded"):  # checked, not timed
            continue
        batches = stats["batches"]
        out[label] = dict(qps=len(trace) / wall, p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"],
                          batches=batches,
                          launches_a_batch=sum(launches.values()) / max(batches, 1),
                          peak_bytes=torch.cuda.max_memory_allocated(device))
    busy = device_busy(profiled["prof"])
    if busy["kernels"] < profiled["launches"]:
        fail(f"9a: the profiler saw {busy['kernels']} kernels, fewer than the "
             f"{profiled['launches']} launches of the port's kernels")
    untraced = (out["sharded (1, 4)"]["qps"] + out["sharded (1, 4) again"]["qps"]) / 2
    out["sharded (1, 4) profiled"].update(
        busy, device_idle_share=1.0 - busy["busy_ms"] * out["sharded (1, 4) profiled"]["qps"]
        / (1e3 * len(trace)),
        idle_share_of_untraced_wall=1.0 - busy["busy_ms"] * untraced / (1e3 * len(trace)))
    lanes = np.array([row[1:] for row in trace[:max_batch]], np.int32).T
    for label, m in (("unsharded", None), ("sharded (1, 4)", mesh)):
        cfg = engine.default_config.replace(cap=cap, mesh=m)
        prof = engine.compile(ServeQ(), cfg).cost_profile(eng.ServeBatch(*lanes))
        out[label].update(device_ms_a_batch=prof.get("device_ms", prof.get("device_ms_error")),
                          launches_a_batch_profile=sum(prof["launches"].values()),
                          geometry=prof["geometry"])
    shards = engine._shards(engine._static(), engine.default_config.replace(mesh=mesh))
    views = sorted({(str(f.t_words.device), f.t_words.data_ptr()) for f in shards})
    out["shards"] = dict(
        devices=sorted({str(f.t_words.device) for f in shards}), count=len(shards),
        trees_each=shards[0].n_preds,
        bytes_each=[sum(getattr(f, n).nbytes for n in ("t_words", "t_rank", "l_words",
                                                         "ones_before", "level_start", "nnz"))
                    for f in shards],
        distinct_arenas=len(views))
    print(f"9a broker over phase 5's {len(trace)}-query trace, every answer equal to the "
          f"oracle: {json.dumps(out)}", flush=True)
    return out


def quantile_9b(engine, ds, oracle, meshes, device, tally, seed: int) -> dict:
    """(S,?P,?O) and (?S,?P,O) on 256 real constants each at quantile 0.5
    and 1.0, single-device and on the (1, 4) mesh, every answer against
    the oracle; widths, the share routed to the sweep, ms a call."""
    import numpy as np
    import torch

    from repro_torch.core import predindex
    from repro_torch.core.query import ExecConfig, TriplePatternQ

    rng = np.random.default_rng(seed)
    bi = engine.store.pred_index
    base = ExecConfig(cap=1024, device=str(device))
    out = {}
    for name, q, key, op in (("(S,?P,?O)", TriplePatternQ(1, "?p", "?o"), "s", 3),
                             ("(?S,?P,O)", TriplePatternQ("?s", "?p", 1), "o", 4)):
        col = 0 if key == "s" else 2
        consts = ds.ids[rng.integers(0, ds.n_triples, 256), col]
        rows = consts - 1 if key == "s" else bi.meta.n_subjects + consts - 1
        for qq in (0.5, 1.0):
            cfg = base.replace(u_width_quantile=qq)
            width = engine._u_width(cfg)
            share = float((predindex.host_degrees(bi, rows) > width).mean())
            for where, m in (("single", None), ("mesh (1, 4)", meshes[(1, 4)])):
                plan = engine.compile(q, cfg.replace(mesh=m))
                # the single-device runs stay out of the sharded path's count
                got = tally(plan, {key: consts}) if m is not None else plan({key: consts})
                for i, c in enumerate(consts):
                    args = (int(c), 0, 0) if key == "s" else (0, 0, int(c))
                    if not same_answer(got[i], oracle.answer(op, *args)):
                        fail(f"9b: {name} at quantile {qq} {where}, constant {c}, disagrees")
                secs = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    plan({key: consts})
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t0)
                out[f"{name} q={qq} {where}"] = dict(
                    u_width=width, share_to_sweep=share, ms_a_call=1e3 * float(np.median(secs)))
    print(f"9b: every answer equals the oracle; {json.dumps(out)}", flush=True)
    return out


HUB_TRIPLES, HUB_COUNT = 1_000_000, 64  # dbpedia-en's Table 1 ratios (173 preds at 1 M)


def hub_cell_9b(device, seed: int) -> dict:
    """The other side of the width choice: a dbpedia-en-shaped store of
    1 M triples with 64 subject and 64 object hubs that touch every
    predicate (``rdf.with_hubs``), so ``max_degree`` is P while the other
    lists stay short.  (S,?P,?O) and (?S,?P,O) on 256 real constants each
    at quantile 0.5, 0.9, 0.99 and 1.0, single-device, every answer
    against the oracle; widths, the share routed to the sweep, ms a call."""
    import numpy as np
    import torch

    from repro_torch.core import engine as eng, k2triples, predindex
    from repro_torch.core.query import ExecConfig, TriplePatternQ
    from repro_torch.data import rdf

    t0 = time.perf_counter()
    ds = rdf.with_hubs(rdf.generate_like("dbpedia-en", HUB_TRIPLES, seed=seed), HUB_COUNT,
                       seed=seed)
    store = k2triples.from_id_triples(
        ds.ids, n_so=ds.n_so, n_subjects=ds.n_subjects, n_objects=ds.n_objects,
        n_preds=ds.n_preds, device=device,
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    engine, oracle, bi = eng.Engine(store, device=device), Oracle(ds.ids), store.pred_index
    rng = np.random.default_rng(seed)
    base = ExecConfig(cap=1024, device=str(device))
    out = dict(store=dict(triples=store.n_triples, preds=store.n_preds,
                          max_degree=bi.meta.max_degree, built_s=build_s))
    for name, q, key, op in (("(S,?P,?O)", TriplePatternQ(1, "?p", "?o"), "s", 3),
                             ("(?S,?P,O)", TriplePatternQ("?s", "?p", 1), "o", 4)):
        col = 0 if key == "s" else 2
        consts = ds.ids[rng.integers(0, ds.n_triples, 256), col]
        rows = consts - 1 if key == "s" else bi.meta.n_subjects + consts - 1
        for qq in (0.5, 0.9, 0.99, 1.0):
            cfg = base.replace(u_width_quantile=qq)
            width = engine._u_width(cfg)
            plan = engine.compile(q, cfg)
            got = plan({key: consts})
            for i, c in enumerate(consts):
                args = (int(c), 0, 0) if key == "s" else (0, 0, int(c))
                if not same_answer(got[i], oracle.answer(op, *args)):
                    fail(f"9b hubs: {name} at quantile {qq}, constant {c}, disagrees")
            secs = []
            for _ in range(3):
                t0 = time.perf_counter()
                plan({key: consts})
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            out[f"{name} q={qq}"] = dict(
                u_width=width,
                share_to_sweep=float((predindex.host_degrees(bi, rows) > width).mean()),
                ms_a_call=1e3 * float(np.median(secs)))
    print(f"9b hubs: every answer equals the oracle; {json.dumps(out)}", flush=True)
    return out


def functional_9c(engine, ds, oracle, work, device, T, seed: int) -> None:
    """Each ``patterns`` function, ``join_a/b/c``, ``row_scan_all_preds``
    and ``range_scan`` on 8 real constants against the oracle and the
    matching plan."""
    import numpy as np
    import torch

    from repro_torch.core import joins, k2forest, patterns
    from repro_torch.core.query import ExecConfig, TriplePatternQ

    st = engine.store
    m, f = st.meta, st.forest
    index, pmeta = st.pred_index.select("dac")
    cap = 1024
    cfg = ExecConfig(cap=cap, device=str(device))
    rows = ds.ids[np.random.default_rng(seed).integers(0, ds.n_triples, 8)]

    def ids_of(r):
        if bool(torch.as_tensor(r.overflow).any()):
            fail("9c: a functional call overflowed cap 1024")
        return r.ids[r.valid].cpu().numpy()

    def plan(s, p, o):
        q = TriplePatternQ(*(v if v else f"?{k}" for k, v in zip("spo", (s, p, o))))
        return engine.compile(q, cfg)()

    def check(label, got, want, planned):
        if not (same_answer(got, want) and same_answer(got, planned)):
            fail(f"9c: {label} disagrees with the oracle or its plan")

    for s, p, o in (tuple(int(v) for v in row) for row in rows):
        check("spo", bool(T(patterns.spo, m, f, s, p, o)), oracle.answer(0, s, p, o), plan(s, p, o))
        hits = T(patterns.s_any_o, m, f, s, o).cpu().numpy()
        check("s_any_o", np.nonzero(hits)[0] + 1, oracle.answer(5, s, 0, o), plan(s, 0, o))
        check("s_any_o index", ids_of(T(patterns.s_any_o, m, f, s, o, index=index, pmeta=pmeta)),
              oracle.answer(5, s, 0, o), plan(s, 0, o))
        check("sp_any", ids_of(T(patterns.sp_any, m, f, s, p, cap)), oracle.answer(1, s, p, 0),
              plan(s, p, 0))
        check("any_po", ids_of(T(patterns.any_po, m, f, p, o, cap)), oracle.answer(2, 0, p, o),
              plan(0, p, o))
        for fn, op, key, args in ((patterns.s_any_any, 3, s, (s, 0, 0)),
                                  (patterns.any_any_o, 4, o, (0, 0, o))):
            r = T(fn, m, f, key, cap)
            per = {pi + 1: ids_of(type(r)(*(a[pi] for a in r))) for pi in range(st.n_preds)}
            check(fn.__name__, {k: v for k, v in per.items() if v.size},
                  oracle.answer(op, *args), plan(*args))
            r = T(fn, m, f, key, cap, index=index, pmeta=pmeta)
            if bool(r.truncated) or bool(r.overflow.any()):
                fail(f"9c: {fn.__name__} through the index overflowed")
            per = {int(r.preds[i]): r.ids[i][r.valid[i]].cpu().numpy()
                   for i in range(r.preds.shape[0]) if r.pvalid[i] and r.valid[i].any()}
            check(f"{fn.__name__} index", per, oracle.answer(op, *args), plan(*args))
        r = T(k2forest.row_scan_all_preds, m, f, s - 1, cap)
        per = {pi + 1: ids_of(type(r)(*(a[pi] for a in r))) + 1 for pi in range(st.n_preds)}
        check("row_scan_all_preds", {k: v for k, v in per.items() if v.size != 0},
              oracle.answer(3, s, 0, 0), plan(s, 0, 0))
        for r, label in ((T(k2forest.range_scan, m, f, p - 1, PAIR_CAP), "range_scan"),
                         (T(patterns.any_p_any, m, f, p, PAIR_CAP), "any_p_any")):
            pairs = torch.stack([r.rows[r.valid], r.cols[r.valid]], 1).cpu().numpy()
            pairs = pairs + (1 if label == "range_scan" else 0)
            if not same_pairs(pairs, oracle.pairs(p)) or bool(r.overflow):
                fail(f"9c: {label} of predicate {p} disagrees with the oracle")
    s, p, o = (rows[:, i].astype(np.int32) for i in range(3))
    if not np.array_equal(T(patterns.spo_batch, m, f, s, p, o).cpu().numpy(),
                          np.array([oracle.answer(0, *t) for t in rows.tolist()])):
        fail("9c: spo_batch disagrees with the oracle")
    for fn, op, args in ((patterns.sp_any_batch, 1, (s, p)), (patterns.any_po_batch, 2, (p, o))):
        r = T(fn, m, f, *args, cap)
        for i, t in enumerate(rows.tolist()):
            want = oracle.answer(op, t[0], t[1], 0) if op == 1 else oracle.answer(op, 0, t[1], t[2])
            if not same_answer(r.ids[i][r.valid[i]].cpu().numpy(), want):
                fail(f"9c: {fn.__name__} lane {i} disagrees with the oracle")
    d = T(patterns.dump, m, f, PAIR_CAP)
    total = int(d.valid.sum())
    if total != ds.n_triples:
        fail(f"9c: the dump holds {total} triples, not {ds.n_triples}")
    n_join = 0
    for label, q, jcfg, _ in work:
        if not label.startswith("join") or q.category not in "ABC" or n_join >= 24:
            continue
        kw = dict(cap=jcfg.cap)
        if q.category == "A":
            r = T(joins.join_a, m, f, q.p1, q.c1, q.vpos1, q.p2, q.c2, q.vpos2, **kw)
            got = r.ids[r.valid].cpu().numpy()
        elif q.category == "B":
            r = T(joins.join_b, m, f, q.p1, q.c1, q.vpos1, q.c2, q.vpos2, **kw)
            got = {int(r.preds[i]): r.ids[i][r.valid[i]].cpu().numpy()
                   for i in range(r.preds.shape[0]) if r.valid[i].any()}
        else:
            r = T(joins.join_c, m, f, q.c1, q.vpos1, q.c2, q.vpos2, **kw)
            got = r.ids[r.valid].cpu().numpy()
        if bool(torch.as_tensor(r.overflow).any()):
            fail(f"9c: {label} overflowed cap {jcfg.cap}")
        check(label, got, oracle.join(q), engine.compile(q, jcfg.replace(device=str(device)))())
        n_join += 1
    print(f"9c: every patterns function, row_scan_all_preds, range_scan ({len(rows)} constants), "
          f"the dump ({total} triples) and {n_join} joins A-C (join_a/b/c) equal the oracle and "
          f"their plans", flush=True)


def sharded_phase(engine, ds, oracle, trace, work, device, n_tenants, cap, max_batch,
                  seed: int) -> dict:
    """Phase 9; -> the launches of the sharded and quantile runs (9a, 9b)
    and of the functional calls (9c), the kernel checks and the numbers."""
    import torch

    phase("9a. sharded serving over meshes of the card")
    t0 = time.perf_counter()
    rec = Recorder(every=16)
    sharded, functional = Tally(), Tally()
    with rec:
        meshes = sharded_9a(engine, ds, oracle, trace, work, device, sharded, seed)
    broker = sharded_broker_9a(engine, trace, oracle, meshes, device, sharded, rec, n_tenants,
                               cap, max_batch)
    phase("9b. quantile-sized unbounded lanes")
    with rec:
        quant = quantile_9b(engine, ds, oracle, meshes, device, sharded, seed + 1)
        quant["hubs"] = hub_cell_9b(device, seed + 3)
    torch.cuda.synchronize()
    print(f"9a-9b done in {time.perf_counter() - t0:.1f}s; launches {sharded.counts}", flush=True)

    phase("9c. the functional pattern/join API")
    t0 = time.perf_counter()
    with rec:
        functional_9c(engine, ds, oracle, work, device, functional, seed + 2)
    torch.cuda.synchronize()
    held = {k: len(v) for k, v in rec.calls.items()}
    print(f"9c done in {time.perf_counter() - t0:.1f}s; launches {functional.counts}; kernel "
          f"calls of phase 9 {rec.seen}, held against their plain versions {held}, "
          f"max_abs_err {rec.err}", flush=True)
    if any(rec.err.values()):
        fail(f"kernels disagree with their plain versions in phase 9: {rec.err}")
    for k in ("k2_scan", "k2_check", "pred_gather_dac", "pred_gather"):
        if not sharded.counts[k]:
            fail(f"{k} never launched on the sharded path: {sharded.counts}")
    for k in ("k2_scan", "k2_check", "pred_gather_dac", "k2_range"):
        if not functional.counts[k]:
            fail(f"{k} never launched on the functional path: {functional.counts}")
    return dict(sharded=sharded.counts, functional=functional.counts, err=rec.err,
                broker=broker, quantile=quant)


# ---------------------------------------------------------------------------
# phase 10: the single-tree API and the registry's engine programs
# ---------------------------------------------------------------------------

TREE_SIDE = 100_000  # benchmarks/bench_kernels.py's k2_check tree: 100,000 cells of this side
TREE_CHECKS = 65_536
TREE_SCANS = 64
TREE_CAP = 1024
TREE_RANGE_CAP = 1 << 17
SERVE_SAMPLE = 4096  # 10b's lanes held against the oracle
SWEEP_SAMPLE = 64  # 10c's keys held against the oracle and the all-preds scans
SWEEP_LANES = 4096  # 10c's random scan lanes held against the plain version
# and its last lanes: a scan grid of at least one 4-warp block an SM gives
# each warp a run of at most 2^21 / (132 * 4) < 4,096 lanes, so the last,
# partial run lies inside them
TAIL_LANES = 4096


class TreeOracle:
    """The cells of one tree as sorted numpy codes: checks, row and column
    lists and the full pair set, independent of the port."""

    def __init__(self, rows, cols, side: int):
        import numpy as np

        self.np, self.side = np, side
        rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
        self.by_row = np.unique(rows * side + cols)
        self.by_col = np.unique(cols * side + rows)

    def check(self, rows, cols):
        return self.np.isin(rows.astype(self.np.int64) * self.side + cols, self.by_row)

    def line(self, key: int, axis: int):
        codes = self.by_col if axis else self.by_row
        lo, hi = self.np.searchsorted(codes, [key * self.side, (key + 1) * self.side])
        return codes[lo:hi] - key * self.side


def _tree_answers(meta, tree, oracle, rng, n_checks, keys, where: str) -> dict:
    """Checks of real and random cells, a row and a column scan of every
    key, and the full range of one tree, against the oracle; -> the calls."""
    import numpy as np
    import torch

    from repro_torch.core import k2tree

    dev = tree.t.words.device
    side = oracle.side
    real = np.stack([oracle.by_row // side, oracle.by_row % side], 1)
    pick = real[rng.integers(0, len(real), n_checks // 2)] if len(real) else np.zeros((0, 2))
    qr = np.concatenate([pick[:, 0], rng.integers(0, side, n_checks - len(pick))]).astype(np.int32)
    qc = np.concatenate([pick[:, 1], rng.integers(0, side, n_checks - len(pick))]).astype(np.int32)
    hit = k2tree.check(meta, tree, torch.from_numpy(qr).to(dev), torch.from_numpy(qc).to(dev))
    if not np.array_equal(hit.cpu().numpy(), oracle.check(qr, qc)):
        fail(f"{where}: k2tree.check disagrees with the cells")
    for axis, fn in ((0, k2tree.row_scan), (1, k2tree.col_scan)):
        for key in keys:
            r = fn(meta, tree, int(key), TREE_CAP)
            want = oracle.line(int(key), axis)
            got = r.ids[r.valid].cpu().numpy()
            if (not np.array_equal(got, want[:TREE_CAP]) or int(r.count) != min(len(want), TREE_CAP)
                    or bool(r.overflow) != (len(want) > TREE_CAP)):
                fail(f"{where}: {fn.__name__} of {key} disagrees with the cells")
    r = k2tree.range_scan(meta, tree, TREE_RANGE_CAP)
    v = r.valid.cpu().numpy()
    codes = np.sort(r.rows.cpu().numpy()[v].astype(np.int64) * side + r.cols.cpu().numpy()[v])
    if not np.array_equal(codes, oracle.by_row) or bool(r.overflow):
        fail(f"{where}: range_scan disagrees with the cells")
    return dict(checks=n_checks, scans=2 * len(keys), pairs=int(r.count))


def tree_10a(device, seed: int, tally: Tally) -> tuple[dict, "Recorder"]:
    """Phase 10a: ``k2tree.build`` of ``bench_kernels.py``'s tree on the
    card, its checks, scans and range against numpy and, call by call, the
    plain versions; then an H = 1 and an empty tree.  -> numbers, recorder."""
    import numpy as np
    import torch

    from repro_torch.core import k2tree

    rng = np.random.default_rng(seed)
    meta = k2tree.K2Meta(k2tree.hybrid_ks(TREE_SIDE))
    rows = rng.integers(0, TREE_SIDE, TREE_SIDE)
    cols = rng.integers(0, TREE_SIDE, TREE_SIDE)
    t0 = time.perf_counter()
    tree = k2tree.build(rows, cols, meta, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    oracle = TreeOracle(rows, cols, TREE_SIDE)
    keys = np.concatenate([rows[rng.integers(0, TREE_SIDE, TREE_SCANS - 3)],
                           [0, TREE_SIDE - 1, meta.side - 1]])
    rec = Recorder()
    with rec, tally:
        out = dict(big=_tree_answers(meta, tree, oracle, rng, TREE_CHECKS, keys, "10a tree"))
        # keys outside the matrix: held against the plain versions only
        for key in (-1, meta.side, 2**31 - 1):
            k2tree.row_scan(meta, tree, key, TREE_CAP)
            k2tree.col_scan(meta, tree, key, TREE_CAP)
        # an H = 1 tree (T empty, level 0 in L) and an empty tree
        small = k2tree.K2Meta(k2tree.hybrid_ks(4))
        r1, c1 = rng.integers(0, 4, 6), rng.integers(0, 4, 6)
        h1 = k2tree.build(r1, c1, small, device=device)
        out["h1"] = _tree_answers(small, h1, TreeOracle(r1, c1, 4), rng, 64, range(4), "10a H=1")
        for cap in (1, 3):  # caps below the root arity
            k2tree.row_scan(small, h1, 1, cap)
            k2tree.range_scan(small, h1, cap)
        none = np.zeros(0, np.int64)
        empty = k2tree.build(none, none, meta, device=device)
        out["empty"] = _tree_answers(meta, empty, TreeOracle(none, none, TREE_SIDE), rng, 4096,
                                     keys[:8], "10a empty")
    torch.cuda.synchronize()
    # the 65,536-lane check, the first row scan and the full range, timed
    cases = {
        f"tree Q={TREE_CHECKS}": ("k2_check", next(
            c for c in rec.calls["k2_check"] if c[2].shape[0] == TREE_CHECKS)),
        f"tree Q=1 cap={TREE_CAP}": ("k2_scan", next(
            c for c in rec.calls["k2_scan"] if c[1]["cap"] == TREE_CAP)),
        f"tree Q=1 cap={TREE_RANGE_CAP}": ("k2_range", next(
            c for c in rec.calls["k2_range"] if c[1]["cap"] == TREE_RANGE_CAP)),
    }
    times = {label: (name, time_case(name, rec.orig[name], *call))
             for label, (name, call) in cases.items()}
    out.update(size_bits=k2tree.size_bits(tree), nnz=tree.nnz, levels=meta.n_levels,
               build_s=build_s, times=times)
    return out, rec


def _arch_store(cfg, device, seed: int):
    """The arch's store as ``tests/test_configs_smoke.py`` builds it."""
    from repro_torch.core import k2triples
    from repro_torch.data import rdf

    ds = rdf.generate(cfg.n_triples, n_subjects=cfg.n_subjects, n_preds=cfg.n_preds,
                      n_objects=cfg.n_objects, seed=seed)
    return ds, k2triples.from_id_triples(ds.ids, n_so=ds.n_so, n_subjects=ds.n_subjects,
                                         n_objects=ds.n_objects, n_preds=ds.n_preds,
                                         device=device)


def serve_10b(store, ds, oracle, device, seed: int, tally: Tally, rec) -> dict:
    """Phase 10b: ``k2triples:serve_64k`` on (1, 1) and (1, 4) meshes of the
    card against the unsharded serve step and the oracle."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.core import engine as eng
    from repro_torch.launch import mesh as meshlib, programs, serve

    arch = ARCHS["k2triples"]
    b = arch.shape("serve_64k").dims["batch"]
    trace = serve.make_trace(ds, b, 8, unbounded=False, seed=seed)
    lanes = np.array([row[1:] for row in trace], np.int32).T
    batch = eng.ServeBatch(*lanes)
    mesh = meshlib.make_mesh((1, 1), ("data", "model"), [device])
    prog = programs.build("k2triples", "serve_64k", mesh)
    args = programs.inputs(prog, store, mesh, batch)
    with rec, tally:
        got = prog.fn(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    secs = []
    with tally:
        for _ in range(6):
            t0 = time.perf_counter()
            prog.fn(*args)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(device)
    note_dry("10b k2triples:serve_64k (1, 1)",
             lambda m: programs.build("k2triples", "serve_64k", m).fn, args,
             float(np.median([1e3 * x for x in secs[1:]])), peak, base, args_in_base=True,
             mesh_shape=(1, 1))
    before = dict(tally.counts)
    with tally:
        prog.fn(*args)
    launches = {k: tally.counts[k] - before[k] for k in KERNELS if tally.counts[k] != before[k]}
    want = eng.make_serve_step(store.meta, arch.cfg.cap)(store.forest, args[1])
    same_result(got, want, "10b serve_64k on (1, 1) against the unsharded step")
    host = eng.host_result(got, unbounded=False)
    idx = np.random.default_rng(seed + 1).choice(b, SERVE_SAMPLE, replace=False)
    check_decoded(lanes[0], lanes, host, oracle, idx, "10b serve_64k")
    wide = meshlib.make_mesh((1, 4), ("data", "model"), [device] * 4)
    prog4 = programs.build("k2triples", "serve_64k", wide)
    with rec, tally:
        got4 = prog4.fn(*programs.inputs(prog4, store, wide, batch))
    same_result(got4, got, "10b serve_64k on (1, 4) against (1, 1)")
    return dict(batch=b, ops=np.bincount(lanes[0], minlength=3).tolist(),
                step_ms=[1e3 * x for x in secs[1:]], launches_a_step=launches,
                peak_bytes=peak, base_bytes=base, model_flops=prog.model_flops)


def sweep_10c(store, ds, oracle, device, seed: int, tally: Tally, rec) -> dict:
    """Phase 10c: ``k2triples:unbounded_4k`` at full size (B keys over every
    predicate, cap 1024) on a (1, 1) mesh of the card, its peak memory, and
    64 sampled keys against the oracle and the all-preds scans; at the
    largest power of two of keys that fits when B does not."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.core import k2forest
    from repro_torch.launch import mesh as meshlib, programs

    arch = ARCHS["k2triples"]
    shape = arch.shape("unbounded_4k")
    cap = arch.cfg.cap
    mesh = meshlib.make_mesh((1, 1), ("data", "model"), [device])
    rng = np.random.default_rng(seed)
    b = shape.dims["batch"]
    while True:
        rows = ds.ids[rng.integers(0, ds.n_triples, b)]
        axes = (np.arange(b) % 2).astype(np.int32)
        keys = np.where(axes == 1, rows[:, 2], rows[:, 0]).astype(np.int32)
        prog = programs.build_engine(
            arch, dataclasses.replace(shape, dims=dict(shape.dims, batch=b)), mesh)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        try:
            t0 = time.perf_counter()
            with rec, tally:
                ids, valid, count = prog.fn(*programs.inputs(prog, store, mesh, (keys, axes)))
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            break
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            print(f"10c: B = {b} keys do not fit on the card; trying {b // 2}", flush=True)
            b //= 2
            if b < 1:
                fail("10c: not even one key fits")
    peak = torch.cuda.max_memory_allocated(device)
    if b != shape.dims["batch"]:
        print(f"10c CUT: unbounded_4k runs at B = {b}, not {shape.dims['batch']}", flush=True)
    p = store.n_preds
    if tuple(ids.shape) != (b, p, cap):
        fail(f"10c: ids of shape {tuple(ids.shape)}, not {(b, p, cap)}")
    for i in np.random.default_rng(seed + 1).choice(b, SWEEP_SAMPLE, replace=False):
        key, axis = int(keys[i]), int(axes[i])
        scan = k2forest.col_scan_all_preds if axis else k2forest.row_scan_all_preds
        r = scan(store.meta, store.forest, key - 1, cap)
        if not (torch.equal(ids[i], torch.where(r.valid, r.ids + 1, 0))
                and torch.equal(valid[i], r.valid) and torch.equal(count[i], r.count)):
            fail(f"10c: key {key} axis {axis} differs from the all-preds scan")
        ans = oracle.answer(4 if axis else 3, key, 0, key)
        got_ids, got_valid = ids[i].cpu().numpy(), valid[i].cpu().numpy()
        for q in range(1, p + 1):
            want = ans.get(q, np.zeros(0, np.int64))
            if not np.array_equal(got_ids[q - 1][got_valid[q - 1]], want[:cap]):
                fail(f"10c: key {key} axis {axis} pred {q} disagrees with the oracle")
    return dict(batch=b, lanes=b * p, cap=cap, seconds=secs, peak_bytes=peak, base_bytes=base,
                result_bytes=ids.numel() * 4 + valid.numel() + count.numel() * 4,
                model_flops=prog.model_flops)


def registry_phase(device, seed: int) -> dict:
    """Phase 10; -> the launches of the tree path (10a) and of the
    registry's programs (10b-10c), the kernel checks and the numbers."""
    import torch

    from repro_torch.configs import ARCHS

    phase("10a. the single-tree API at bench_kernels.py's shape")
    t0 = time.perf_counter()
    tree, registry = Tally(), Tally()
    out, rec_t = tree_10a(device, seed, tree)
    print(f"10a tree: {TREE_SIDE} cells of side {TREE_SIDE} ({out['nnz']} distinct, "
          f"{out['levels']} levels), size_bits {out['size_bits']} "
          f"({out['size_bits'] / out['nnz']:.2f} bits a cell), built in {out['build_s']:.2f}s; "
          f"answers {out['big']}, H=1 {out['h1']}, empty {out['empty']} equal the cells; "
          f"kernel calls {rec_t.seen}, max_abs_err against the plain versions {rec_t.err}",
          flush=True)
    for label, (name, t) in out["times"].items():
        print(f"10a {name} {label}: device {t['ms']:.5f} ms, wrapper {t['wrapper_ms']:.5f} ms, "
              f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.7f} ms ({t['bound_by']}) "
              f"on {gpu_line()}", flush=True)
    print(f"10a done in {time.perf_counter() - t0:.1f}s; launches {tree.counts}", flush=True)

    phase("10b. k2triples:serve_64k at the full config")
    cfg = ARCHS["k2triples"].cfg
    t0 = time.perf_counter()
    ds, store = _arch_store(cfg, device, seed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    f = store.forest
    print(f"10b store: {store.n_triples} triples, {store.n_preds} preds, {store.n_subjects} "
          f"subjects, {store.n_objects} objects, ks={store.meta.ks}, t_words "
          f"{tuple(f.t_words.shape)}, l_words {tuple(f.l_words.shape)}; built in {build_s:.1f}s",
          flush=True)
    oracle = Oracle(ds.ids)
    rec = Recorder()  # every call of 10b held at full width
    sv = serve_10b(store, ds, oracle, device, seed + 1, registry, rec)
    rec.calls = {k: [] for k in rec.calls}  # free the kept calls before 10c's peak
    print(f"10b serve_64k: B = {sv['batch']} (ops check/row/col {sv['ops']}), step ms "
          f"{[round(x, 3) for x in sv['step_ms']]} (host clock, synchronised), launches a step "
          f"{sv['launches_a_step']}, peak device memory {sv['peak_bytes']} bytes "
          f"({sv['base_bytes']} resident before); equal to the unsharded step and, on "
          f"{SERVE_SAMPLE} sampled lanes, to the oracle; (1, 4) equal to (1, 1); "
          f"model_flops {sv['model_flops']:.4g}; kernel calls {rec.seen}, each equal to its "
          f"plain version at full width, max_abs_err {rec.err}; {gpu_line()}", flush=True)

    phase("10c. k2triples:unbounded_4k at full size")
    rec_c = Recorder(lanes=SWEEP_LANES, seed=seed)
    sw = sweep_10c(store, ds, oracle, device, seed + 2, registry, rec_c)
    torch.cuda.synchronize()
    print(f"10c unbounded_4k: B = {sw['batch']} keys x {store.n_preds} preds = {sw['lanes']} "
          f"lanes at cap {sw['cap']} in {sw['seconds']:.3f}s (with the sampled plain checks); "
          f"result {sw['result_bytes']} bytes; peak device memory {sw['peak_bytes']} bytes "
          f"({sw['base_bytes']} resident before); {SWEEP_SAMPLE} sampled keys equal the oracle "
          f"and the all-preds scans; {gpu_line()}", flush=True)
    print(f"10b-10c done in {time.perf_counter() - t0:.1f}s; launches {registry.counts}; 10c "
          f"kernel calls {rec_c.seen}, {rec_c.sampled} held on {SWEEP_LANES} random lanes (seed "
          f"{seed}) and the last {TAIL_LANES}, others whole; max_abs_err {rec_c.err}", flush=True)
    if not rec_c.sampled["k2_scan"]:
        fail(f"10c: no sweep scan was held against its plain version: {rec_c.seen}")
    err = {k: max(r.err[k] for r in (rec_t, rec, rec_c)) for k in rec.err}
    if any(err.values()):
        fail(f"kernels disagree with their plain versions in phase 10: {err}")
    for k in ("k2_check", "k2_scan", "k2_range"):
        if not tree.counts[k]:
            fail(f"{k} never launched on the single-tree path: {tree.counts}")
    for k in ("k2_check", "k2_scan"):
        if not registry.counts[k]:
            fail(f"{k} never launched on the registry's programs: {registry.counts}")
    return dict(tree=tree.counts, registry=registry.counts, err=err, times=out["times"])


# ---------------------------------------------------------------------------
# phase 11: the transformer LM's serving path (prefill, KV-cache decode)
# ---------------------------------------------------------------------------

LM_ARCHS = ("tinyllama-1.1b", "gemma2-27b", "command-r-plus-104b", "olmoe-1b-7b",
            "kimi-k2-1t-a32b")
# a bf16 attention output against float64 on the same inputs, value by value: two bf16 steps
BF16_TOL = 1e-2
# a bf16 tensor (hidden states, k / v, an MoE layer's output) against another device's or
# path's computation of the same inputs: relative L2, ~2.5 steps of bf16's 2^-8 (a value by
# value bound fails where a residual sum cancels: its rounding is that of its larger terms)
REL_TOL = 1e-2
# f32 logits of the same bf16 hidden states: one f32 product, summed in another order
F32_TOL = 1e-4
SMOKE_PROMPT = (2, 24)  # 11a: B x S, then SMOKE_STEPS decode steps
SMOKE_STEPS = 4
DENSE_PREFILL = (8, 4096)  # 11b: prefill_32k cut from 32 x 32,768
DENSE_STEPS = 32
DENSE_DECODE_B = 8  # decode_32k cut from 128 sequences
MOE_PREFILL = (4, 2048)  # 11c: prefill_32k cut from 32 x 32,768
MOE_STEPS = 8
MOE_LAYER_TOKENS = 256
TIMED_STEPS = 8  # decode steps timed a decode cell (median)


class MoeTally:
    """While active, wraps ``transformer._moe_route`` and keeps
    per call, on the device (no sync), the (token, expert) pairs, those
    kept under capacity and the experts that received a token."""

    def __enter__(self):
        from repro_torch.models import transformer as tfm

        self.tfm, self.orig, self.calls = tfm, tfm._moe_route, []

        def counted(gates, E, K, C, e0=0, e_count=None):
            out = self.orig(gates, E, K, C, e0, e_count)
            valid = out[2]
            self.calls.append((gates.shape[0] * K, valid.sum(), valid.view(-1, C).any(1).sum()))
            return out

        tfm._moe_route = counted
        return self

    def __exit__(self, *exc):
        self.tfm._moe_route = self.orig

    def totals(self) -> tuple[int, int, int]:
        """(pairs, kept pairs, experts reached) summed over every call."""
        return (sum(c[0] for c in self.calls), sum(int(c[1]) for c in self.calls),
                sum(int(c[2]) for c in self.calls))


def _lm_products(cfg) -> tuple[int, int]:
    """Per token and layer: the parameters of the attention projections,
    and those of the dense FFN or, for MoE, of the router."""
    D, H, Kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    attn = D * H * dh + 2 * D * Kv * dh + H * dh * D
    return attn, (D * cfg.moe.n_experts if cfg.moe else 3 * D * cfg.d_ff)


def lm_bound(cfg, elt: int, *, B: int, S: int, ctx: int, kept: int = 0,
             reached: int | None = None) -> tuple[float, str, int, int]:
    """Least time of a prefill (``ctx == 0``: B x S prompt tokens) or of
    one decode step (B new tokens against ``ctx`` cache positions):
    (bound_ms, bound_by, bytes, flops).  Bytes: every parameter read once
    at ``elt`` bytes (the embedding table only for the rows gathered, all
    of it when tied; MoE: the expert weights of the ``reached`` experts,
    all when None), tokens, the cache written (prefill) or read and the new
    k/v written (decode), the f32 logits.  Flops: every product at the bf16
    tensor-core rate, its operands being bf16 with f32 accumulation (the
    attention scores and values, the unembedding): projections, the FFN or
    the router plus 6·D·F_e a kept (token, expert) pair, causal attention
    (4·dh flops a (query, key) pair and head), the unembedding of the last
    position."""
    L, D, H, Kv, dh, V = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                          cfg.vocab)
    attn, ffn = _lm_products(cfg)
    expert = 3 * D * cfg.moe.d_ff_expert if cfg.moe else 0
    rows = B * (S if ctx == 0 else 1)
    layer_params = L * (attn + ffn + 2 * D)
    if cfg.moe:
        layer_params += expert * (L * cfg.moe.n_experts if reached is None else reached)
    embed_rows = V if cfg.tie_embeddings else min(V, rows)
    nbytes = elt * (layer_params + D + embed_rows * D + (0 if cfg.tie_embeddings else D * V))
    kv = 2 * L * Kv * dh * 2  # k and v, bf16, a position
    if ctx == 0:
        pairs = B * S * (S + 1) // 2
        nbytes += 4 * B * S + kv * B * S + 4 * B * V
    else:
        pairs = B * ctx
        nbytes += 8 * B + kv * B * ctx + kv * B + 4 * B * V
    flops = 2 * rows * L * (attn + ffn) + 2 * expert * kept + 4 * H * dh * L * pairs + 2 * B * D * V
    return (*roofline.bound_ms(nbytes, flops, PEAK_BF16_FLOPS), int(nbytes), int(flops))


def _allclose(got, want, tol: float, what: str) -> float:
    """Fail unless |got - want| <= tol + tol·|want| everywhere; -> max |got - want|."""
    import torch

    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} against {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite values")
    err = (got - want).abs()
    bad = err > tol + tol * want.abs()
    if bad.any():
        worst = int((err - tol * want.abs()).argmax())
        rel = float((got - want).norm() / max(float(want.norm()), 1e-30))
        fail(f"{what}: {int(bad.sum())} of {err.numel()} values past {tol} (rtol and atol), "
             f"max |diff| {float(err.max()):.4g}, worst {float(got.flatten()[worst]):.6g} "
             f"against {float(want.flatten()[worst]):.6g}; relative L2 {rel:.3g}")
    return float(err.max())


def _rel_l2(got, want, tol: float, what: str) -> float:
    """Fail unless ||got - want|| <= tol·||want|| (L2 over the tensor);
    -> the relative L2 difference."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if got.shape != want.shape:
        fail(f"{what}: shape {tuple(got.shape)} against {tuple(want.shape)}")
    rel = float((got - want).norm() / max(float(want.norm()), 1e-30))
    if not rel <= tol:
        fail(f"{what}: relative L2 difference {rel:.4g} past {tol}, max |diff| "
             f"{float((got - want).abs().max()):.4g}")
    return rel


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _pad_cache(cache, extra: int):
    import torch

    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, extra)) for k, v in cache.items()}


def _greedy(logits):
    """The next token of each row: its logits' argmax, as int32."""
    return logits.argmax(dim=-1).int()


def _prefill_layers(cfg, params, toks, device=None):
    """A prefill layer by layer (``transformer._layer``), each layer fed
    the previous layer's output of ``params``' own run; with ``device``
    each layer is run again there on that same input (its own copy of the
    parameters).  -> (hidden states entering each layer and the last
    one's output, k / v of each layer, the device's layer outputs and k / v
    or None)."""
    import torch

    from repro_torch.models import transformer as tfm

    x = tfm._embed(params, toks)
    B, S = toks.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    states, kvs, other = [x], [], []
    for i, is_local in enumerate(tfm.local_flags(cfg)):
        x, kv = tfm._layer(cfg, tfm._layer_params(params, i), x, positions, is_local)
        if device is not None:
            there = _tree_to(tfm._layer_params(params, i), device)
            other.append(tfm._layer(cfg, there, states[-1].to(device), positions.to(device),
                                    is_local))
        states.append(x)
        kvs.append(kv)
    return states, kvs, other or None


def _logits_of(cfg, params, x):
    """The last position's logits of final hidden states x [B, S, D]."""
    from repro_torch.models import layers as L, transformer as tfm

    return tfm.unembed_logits(cfg, params, L.rms_norm(x[:, -1:], params["final_norm"]))[:, 0]


def smoke_11a(device, seed: int) -> dict:
    """Each LM arch's smoke config on the card and the CPU, the same
    seeded weights and tokens.  Free-running, prefill then decode steps fed
    the CPU's greedy tokens, logits compared and printed (not held: with
    random weights a bf16 rounding that lands the other way grows through
    the layers).  Held, on identical inputs: every layer of the prefill and
    of each decode step (fed the CPU's layer input and, in decode, the
    CPU's cache) within ``REL_TOL``, its k / v and cache writes too, and
    the logits of the CPU's final hidden states within ``F32_TOL``."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as tfm

    out = {}
    for i, arch in enumerate(LM_ARCHS):
        spec = ARCHS[arch]
        cfg = spec.smoke_cfg
        dt = torch.bfloat16 if spec.param_dtype == "bfloat16" else torch.float32
        params = tfm.init(cfg, torch.Generator().manual_seed(seed + i), device="cpu", dtype=dt)
        card = _tree_to(params, device)
        B, S = SMOKE_PROMPT
        toks = torch.from_numpy(TokenStream(cfg.vocab, S, seed=seed + i).batch(B)["tokens"])
        # free-running
        runs = []  # the CPU's, then the card's: (params, cache, logits of each step)
        for dev, p in (("cpu", params), (device, card)):
            logits, cache = tfm.prefill(cfg, p, toks.to(dev))
            runs.append((p, _pad_cache(cache, SMOKE_STEPS), [logits.cpu()]))
        greedy = [_greedy(runs[0][2][0])]
        lengths = torch.full((B,), S, dtype=torch.int32)
        for step in range(SMOKE_STEPS):
            for dev, (p, cache, logits) in zip(("cpu", device), runs):
                new, _ = tfm.decode_step(cfg, p, cache, greedy[-1].to(dev),
                                         (lengths + step).to(dev))
                logits.append(new.cpu())
            greedy.append(_greedy(runs[0][2][-1]))
        free = max(float((a - b).abs().max()) for a, b in zip(runs[1][2], runs[0][2]))
        same = all(torch.equal(_greedy(a), b) for a, b in zip(runs[1][2], greedy))
        # held, layer by layer on identical inputs
        err = dict(layer=0.0, kv=0.0, logits=0.0)
        states, kvs, there = _prefill_layers(cfg, params, toks, device)
        for k, ((x, kv), want_x, want_kv) in enumerate(zip(there, states[1:], kvs)):
            err["layer"] = max(err["layer"], _rel_l2(
                x, want_x, REL_TOL, f"11a {arch} prefill layer {k}"))
            for a, b in zip(kv, want_kv):
                err["kv"] = max(err["kv"], _rel_l2(
                    a, b, REL_TOL, f"11a {arch} prefill k/v {k}"))
        cache = _pad_cache({"k": torch.stack([kv[0] for kv in kvs]),
                            "v": torch.stack([kv[1] for kv in kvs])}, SMOKE_STEPS)
        x = states[-1]
        for step in range(SMOKE_STEPS + 1):
            err["logits"] = max(err["logits"], _allclose(
                _logits_of(cfg, card, x.to(device)), _logits_of(cfg, params, x), F32_TOL,
                f"11a {arch} step {step}: logits of the same hidden states"))
            if step == SMOKE_STEPS:
                break
            pos = lengths + step
            x = tfm._embed(params, greedy[step])
            for k, is_local in enumerate(tfm.local_flags(cfg)):
                kc, vc = cache["k"][k], cache["v"][k]
                kc_d, vc_d = kc.to(device), vc.to(device)  # before the CPU's write
                lp = tfm._layer_params(params, k)
                y = tfm._decode_layer(cfg, _tree_to(lp, device), x.to(device), kc_d, vc_d,
                                      pos.to(device), is_local)
                x = tfm._decode_layer(cfg, lp, x, kc, vc, pos, is_local)
                err["layer"] = max(err["layer"], _rel_l2(
                    y, x, REL_TOL, f"11a {arch} step {step} layer {k}"))
                for a, b in ((kc_d, kc), (vc_d, vc)):
                    err["kv"] = max(err["kv"], _rel_l2(
                        a, b, REL_TOL, f"11a {arch} step {step} cache {k}"))
            x = x[:, None, :]
        out[arch] = dict(err=err, free=free, same_greedy=same,
                         greedy=torch.stack(greedy, 1).tolist())
    return out


def _held_layer(cfg, params, cache, tokens_new, lengths, where: str) -> float:
    """Layer 0 of the decode step just run: its ``decode_attention`` on the
    card against a float64 softmax on the card over the same q and cache;
    -> max |diff|."""
    import torch

    from repro_torch.models import layers as L, transformer as tfm

    lp = tfm._layer_params(params, 0)
    h = L.rms_norm(tfm._embed(params, tokens_new), lp["attn_norm"])
    pos = lengths.to(torch.int32)
    q = L.rope(tfm._proj(h, lp["wq"])[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    kc, vc = cache["k"][0], cache["v"][0]
    window = cfg.window if tfm.local_flags(cfg)[0] else None
    got = L.decode_attention(q, kc, vc, length=pos + 1, window=window,
                             attn_softcap=cfg.attn_softcap)
    B, H, dh = q.shape
    S, Kv = kc.shape[1], kc.shape[2]
    q64 = q.double().reshape(B, Kv, H // Kv, dh)
    s = torch.einsum("bkgd,bskd->bkgs", q64, kc.double()) / dh ** 0.5
    if cfg.attn_softcap is not None:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    p_ = torch.arange(S, device=q.device)
    ln = (pos + 1)[:, None, None, None]
    mask = p_ < ln
    if window is not None:
        mask = mask & (p_ > ln - 1 - window)
    s = torch.where(mask, s, -torch.inf)
    want = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, dim=-1), vc.double()).reshape(B, H, dh)
    del s, q64
    return _allclose(got, want, BF16_TOL, f"{where}: layer 0's decode_attention against float64")


def _against_prefill(cfg, params, toks, first, padded, logits, written) -> dict:
    """The first decode step (token ``first`` at position S into the
    prefill's cache ``padded``) against a prefill of the S + 1 tokens.
    Held, each layer on identical inputs: the decode layer, fed the S + 1
    prefill's hidden state at S and the S-token prefill's cache, gives that
    prefill's next hidden state at S and its k / v there, within
    ``REL_TOL``.  Reported: the free-running step's logits (``logits``)
    against the S + 1 prefill's, and per layer the relative L2 difference
    between the k the free-running step wrote at S (``written`` [L, B, Kv,
    dh]) and the S + 1 prefill's (how a rounding difference grows)."""
    import torch

    from repro_torch.models import transformer as tfm

    B, S = toks.shape
    states, kvs, _ = _prefill_layers(cfg, params, torch.cat([toks, first[:, None]], dim=1))
    ext = _logits_of(cfg, params, states[-1][:, S:])
    pos = torch.full((B,), S, dtype=torch.int32, device=toks.device)
    layer = kv = 0.0
    growth = []
    for k, is_local in enumerate(tfm.local_flags(cfg)):
        kc, vc = padded["k"][k].clone(), padded["v"][k].clone()
        y = tfm._decode_layer(cfg, tfm._layer_params(params, k), states[k][:, S], kc, vc, pos,
                              is_local)
        layer = max(layer, _rel_l2(y, states[k + 1][:, S], REL_TOL,
                                   f"11b: decode layer {k} against the S + 1 prefill"))
        for a, b in ((kc[:, S], kvs[k][0][:, S]), (vc[:, S], kvs[k][1][:, S])):
            kv = max(kv, _rel_l2(a, b, REL_TOL, f"11b: layer {k}'s k/v at S"))
        growth.append(float((written[k] - kvs[k][0][:, S]).float().norm()
                            / kvs[k][0][:, S].float().norm()))
    return dict(layer_err=layer, kv_err=kv, free=float((logits - ext).abs().max()),
                same_argmax=float((_greedy(logits) == _greedy(ext)).float().mean()),
                growth=growth)


def _decode_steps(cfg, prog, params, cache, tokens_new, lengths, n: int, *, greedy: bool):
    """``n`` decode steps through the program, each timed on the host clock
    around a synchronised call; -> (per-step ms, logits of each step,
    tokens fed); greedy feeds each step's argmax to the next, otherwise the
    same token and lengths repeat."""
    import torch

    ms, logits, fed = [], [], [tokens_new]
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, cache = prog.fn(params, cache, fed[-1], lengths + i if greedy else lengths)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        logits.append(out)
        if greedy:
            fed.append(_greedy(out))
    return ms, logits, fed


def _profiled(fn) -> dict:
    """One run of ``fn`` under the CUDA profiler: wall ms (host clock, ended
    by a synchronise), device busy ms (``device_busy``), the idle share,
    the launches and the five kernels of most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = device_busy(prof)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    top = sorted(((e.key, dev_us(e) / 1e3, e.count) for e in prof.key_averages()),
                 key=lambda t: -t[1])[:5]
    return dict(wall_ms=wall, busy_ms=busy["busy_ms"], idle=1 - busy["busy_ms"] / wall,
                kernels=busy["kernels"], top=[(k[:60], round(ms, 3), n) for k, ms, n in top])


def _prof_line(label: str, p: dict) -> str:
    return (f"{label} profiled: wall {p['wall_ms']:.3f} ms, device busy {p['busy_ms']:.3f} ms "
            f"(idle {p['idle']:.3f}), {p['kernels']} kernels; most device time (name, ms, "
            f"calls): {p['top']}")


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _peak_reset(device) -> int:
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def dense_11b(device, seed: int) -> dict:
    """``tinyllama-1.1b`` at full width through ``programs.build``:
    prefill_32k cut to ``DENSE_PREFILL`` then ``DENSE_STEPS`` greedy
    decode steps (the first against a prefill of S + 1 tokens);
    decode_32k cut to ``DENSE_DECODE_B`` sequences and long_500k uncut,
    each against a seeded cache filled to its last slot."""
    import numpy as np
    import torch

    from repro_torch.launch import programs

    arch = "tinyllama-1.1b"
    out = {}
    prog = programs.build(arch, "prefill_32k")
    cfg = prog.cfg
    B, S = DENSE_PREFILL
    base = _peak_reset(device)
    params, toks = programs.lm_inputs(prog, device, seed=seed, batch=B, seq_len=S)
    elt = params["embed"].element_size()
    prog.fn(params, toks[:, :512])  # warm-up: cuBLAS picks its kernels
    (logits, cache), secs = _timed(lambda: prog.fn(params, toks))
    peak = torch.cuda.max_memory_allocated(device)
    out["prefill"] = dict(B=B, S=S, seconds=secs, tokens_per_s=B * S / secs, peak=peak,
                          base=base, bound=lm_bound(cfg, elt, B=B, S=S, ctx=0),
                          prof=_profiled(lambda: prog.fn(params, toks)))
    # decode: the prefill cache padded by the steps to come
    dec = programs.build(arch, "decode_32k")
    cache = _pad_cache(cache, DENSE_STEPS)
    padded = {k: v.clone() for k, v in cache.items()}  # before the steps' writes
    first = _greedy(logits)
    lengths = torch.full((B,), S, dtype=torch.int32, device=device)
    _peak_reset(device)
    ms, steps, fed = _decode_steps(cfg, dec, params, cache, first, lengths, DENSE_STEPS,
                                   greedy=True)
    peak = torch.cuda.max_memory_allocated(device)
    held = _held_layer(cfg, params, cache, fed[-2], lengths + DENSE_STEPS - 1,
                       "11b prefill's decode")
    written = cache["k"][:, :, S].clone()
    prof = _profiled(lambda: dec.fn(params, cache, fed[-2], lengths + DENSE_STEPS - 1))
    del cache
    out["decode_after_prefill"] = dict(
        B=B, ctx=S + DENSE_STEPS, ms=ms, median_ms=float(np.median(ms)), peak=peak,
        bound=lm_bound(cfg, elt, B=B, S=1, ctx=S + DENSE_STEPS // 2), held=held, prof=prof,
        greedy=torch.stack(fed, 1)[:2, :8].tolist(),
        **_against_prefill(cfg, params, toks, first, padded, steps[0], written))
    del steps, logits, toks, padded
    for shape, b in (("decode_32k", DENSE_DECODE_B), ("long_500k", None)):
        prog = programs.build(arch, shape)
        del params
        base = _peak_reset(device)
        params, cache, new, lengths = programs.lm_inputs(prog, device, seed=seed, batch=b)
        b, ctx = cache["k"].shape[1], cache["k"].shape[2]
        dec_ms, steps, _ = _decode_steps(cfg, prog, params, cache, new, lengths, TIMED_STEPS + 1,
                                         greedy=False)
        peak = torch.cuda.max_memory_allocated(device)
        for x in steps:
            if not torch.isfinite(x).all() or tuple(x.shape) != (b, cfg.vocab):
                fail(f"11b {shape}: logits of shape {tuple(x.shape)}, finite {bool(torch.isfinite(x).all())}")
        held = _held_layer(cfg, params, cache, new, lengths, f"11b {shape}")
        out[shape] = dict(B=b, ctx=ctx, ms=dec_ms[1:], median_ms=float(np.median(dec_ms[1:])),
                          peak=peak, base=base, held=held,
                          prof=_profiled(lambda: prog.fn(params, cache, new, lengths)),
                          cache_bytes=sum(v.numel() * v.element_size() for v in cache.values()),
                          bound=lm_bound(cfg, elt, B=b, S=1, ctx=ctx))
        del cache, steps
    del params
    return out


def moe_11c(device, seed: int) -> dict:
    """``olmoe-1b-7b`` at full width: prefill_32k cut to ``MOE_PREFILL``
    (its capacity drops counted), ``MOE_STEPS`` greedy decode steps, and
    one MoE layer on ``MOE_LAYER_TOKENS`` tokens on the card and the CPU
    with the same inputs and gates."""
    import numpy as np
    import torch

    from repro_torch.launch import programs
    from repro_torch.models import transformer as tfm

    arch = "olmoe-1b-7b"
    out = {}
    prog = programs.build(arch, "prefill_32k")
    cfg = prog.cfg
    B, S = MOE_PREFILL
    base = _peak_reset(device)
    params, toks = programs.lm_inputs(prog, device, seed=seed, batch=B, seq_len=S)
    elt = params["embed"].element_size()
    with MoeTally() as tally:  # also the warm-up
        prog.fn(params, toks)
    pairs, kept, _ = tally.totals()
    _peak_reset(device)
    (logits, cache), secs = _timed(lambda: prog.fn(params, toks))
    peak = torch.cuda.max_memory_allocated(device)
    out["prefill"] = dict(B=B, S=S, seconds=secs, tokens_per_s=B * S / secs, peak=peak,
                          base=base, capacity=tfm.moe_capacity(cfg, B * S), pairs=pairs,
                          kept=kept, dropped_share=1 - kept / pairs,
                          bound=lm_bound(cfg, elt, B=B, S=S, ctx=0, kept=kept),
                          prof=_profiled(lambda: prog.fn(params, toks)))
    dec = programs.build(arch, "decode_32k")
    cache = _pad_cache(cache, MOE_STEPS)
    lengths = torch.full((B,), S, dtype=torch.int32, device=device)
    _peak_reset(device)
    with MoeTally() as tally:
        ms, steps, fed = _decode_steps(cfg, dec, params, cache, _greedy(logits), lengths,
                                       MOE_STEPS, greedy=True)
    peak = torch.cuda.max_memory_allocated(device)
    d_pairs, d_kept, reached = tally.totals()
    held = _held_layer(cfg, params, cache, fed[-2], lengths + MOE_STEPS - 1, "11c decode")
    prof = _profiled(lambda: dec.fn(params, cache, fed[-2], lengths + MOE_STEPS - 1))
    for x in steps:
        if not torch.isfinite(x).all():
            fail("11c: non-finite decode logits")
    out["decode"] = dict(B=B, ctx=S + MOE_STEPS, layers=cfg.n_layers, ms=ms, median_ms=float(np.median(ms)), peak=peak,
                         capacity=tfm.moe_capacity(cfg, B), pairs=d_pairs, kept=d_kept,
                         reached_per_step=reached / MOE_STEPS, held=held, prof=prof,
                         bound=lm_bound(cfg, elt, B=B, S=1, ctx=S + MOE_STEPS // 2,
                                        kept=d_kept // MOE_STEPS, reached=reached // MOE_STEPS),
                         greedy=torch.stack(fed, 1)[:2].tolist())
    del cache, steps, logits
    # one MoE layer at full width: the card against the CPU, the same gates
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((MOE_LAYER_TOKENS, cfg.d_model), generator=g).bfloat16()
    lp_card = {k: params["layers"][k][0] for k in ("router", "we1", "we3", "we2")}
    lp_cpu = {k: v.cpu() for k, v in lp_card.items()}
    m = cfg.moe
    C = tfm.moe_capacity(cfg, MOE_LAYER_TOKENS)
    gates = tfm.moe_gates(lp_cpu, x)
    t0 = time.perf_counter()
    want_idx = tfm._moe_route(gates, m.n_experts, m.top_k, C)
    want = tfm._moe_expert_compute(lp_cpu, x, *want_idx[:3], m.n_experts, C, want_idx[3])
    cpu_s = time.perf_counter() - t0
    got_idx = tfm._moe_route(gates.to(device), m.n_experts, m.top_k, C)
    for name, a, b in zip(("idx", "wslot", "valid", "tab"), got_idx, want_idx):
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            fail(f"11c: the routing's {name} differs between the card and the CPU")
    got = tfm._moe_expert_compute(lp_card, x.to(device), *got_idx[:3], m.n_experts, C,
                                  got_idx[3])
    out["layer"] = dict(T=MOE_LAYER_TOKENS, C=C, kept=int(want_idx[2].sum()), cpu_s=cpu_s,
                        err=_rel_l2(got, want, REL_TOL,
                                    "11c: the MoE layer's output, card against the CPU"))
    del params
    return out


def lm_phase(device, seed: int) -> dict:
    """Phase 11; fails unless every check holds and none of the nine kernels
    launched (the LM path has none)."""
    import torch

    from repro_torch.kernels import ops

    t_all = time.perf_counter()
    before = dict(ops.LAUNCHES)
    print(f"11: torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32} (f32 products in full f32)", flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 f32 products are on: the LM's f32 attention products would lose bits")

    phase("11a. the five LM smoke configs, card against the CPU")
    t0 = time.perf_counter()
    smoke = smoke_11a(device, seed)
    for arch, r in smoke.items():
        e = r["err"]
        print(f"11a {arch}: prefill {SMOKE_PROMPT[0]} x {SMOKE_PROMPT[1]} + {SMOKE_STEPS} decode "
              f"steps; on identical inputs, card against the CPU, relative L2: every layer "
              f"{e['layer']:.3g}, k/v and cache {e['kv']:.3g} (tol {REL_TOL}); logits "
              f"{e['logits']:.3g} (tol {F32_TOL}); free-running logits max |diff| "
              f"{r['free']:.3g} (not held), the card's argmax the CPU's at every step: "
              f"{r['same_greedy']}; greedy tokens (CPU) {r['greedy']}", flush=True)
    print(f"11a done in {time.perf_counter() - t0:.1f}s", flush=True)

    card = gpu_line()
    phase("11b. tinyllama-1.1b at full width")
    t0 = time.perf_counter()
    d = dense_11b(device, seed)
    pf, da = d["prefill"], d["decode_after_prefill"]
    print(f"11b prefill_32k cut to B = {pf['B']} x S = {pf['S']} (from 32 x 32,768): "
          f"{pf['seconds']:.4f}s, {pf['tokens_per_s']:.1f} tokens/s, peak device memory "
          f"{pf['peak']} bytes ({pf['base']} resident before); bound {pf['bound'][0]:.3f} ms "
          f"({pf['bound'][1]}; {pf['bound'][2]} bytes, {pf['bound'][3]} flops); {card}",
          flush=True)
    print(_prof_line("11b prefill", pf["prof"]), flush=True)
    print(f"11b {DENSE_STEPS} greedy decode steps on the prefill's cache (B = {da['B']}, "
          f"{da['ctx']} slots): median {da['median_ms']:.3f} ms a step (min "
          f"{min(da['ms']):.3f}, max {max(da['ms']):.3f}), peak {da['peak']} bytes; bound "
          f"{da['bound'][0]:.4f} ms ({da['bound'][1]}; {da['bound'][2]} bytes); layer 0 "
          f"against float64 {da['held']:.3g}; tokens (2 rows, 8 steps) {da['greedy']}; {card}",
          flush=True)
    print(_prof_line("11b a decode step on the prefill's cache", da["prof"]), flush=True)
    print(f"11b the first decode step against a prefill of the S + 1 tokens: each decode layer "
          f"on the prefill's inputs, relative L2 {da['layer_err']:.3g}, its k/v at S "
          f"{da['kv_err']:.3g} (tol {REL_TOL}); free-running logits max |diff| "
          f"{da['free']:.4g} (not held), argmax equal on {da['same_argmax']:.3f} of rows; "
          f"relative L2 of the k written at S, layer by layer "
          f"{[round(g, 5) for g in da['growth']]}", flush=True)
    for shape in ("decode_32k", "long_500k"):
        r = d[shape]
        cut = (f"cut to B = {r['B']} (from 128)" if shape == "decode_32k" else "uncut")
        print(f"11b {shape} {cut}, {r['ctx']} cache slots ({r['cache_bytes']} bytes of bf16 "
              f"cache): median {r['median_ms']:.3f} ms a step over {len(r['ms'])} (min "
              f"{min(r['ms']):.3f}, max {max(r['ms']):.3f}), peak {r['peak']} bytes "
              f"({r['base']} before); bound {r['bound'][0]:.4f} ms ({r['bound'][1]}; "
              f"{r['bound'][2]} bytes); layer 0 against float64 {r['held']:.3g}; {card}",
              flush=True)
        print(_prof_line(f"11b a {shape} step", r["prof"]), flush=True)
    print(f"11b done in {time.perf_counter() - t0:.1f}s", flush=True)

    phase("11c. olmoe-1b-7b at full width")
    t0 = time.perf_counter()
    m = moe_11c(device, seed + 1)
    pf, dc, ly = m["prefill"], m["decode"], m["layer"]
    print(f"11c prefill_32k cut to B = {pf['B']} x S = {pf['S']} (from 32 x 32,768), capacity "
          f"C = {pf['capacity']}: {pf['seconds']:.4f}s, {pf['tokens_per_s']:.1f} tokens/s, "
          f"peak {pf['peak']} bytes ({pf['base']} before); (token, expert) pairs dropped by "
          f"capacity {pf['pairs'] - pf['kept']} of {pf['pairs']} ({pf['dropped_share']:.5f}); "
          f"bound {pf['bound'][0]:.3f} ms ({pf['bound'][1]}; {pf['bound'][2]} bytes, "
          f"{pf['bound'][3]} flops); {card}", flush=True)
    print(_prof_line("11c prefill", pf["prof"]), flush=True)
    print(f"11c {MOE_STEPS} greedy decode steps (B = {dc['B']}, C = {dc['capacity']}): median "
          f"{dc['median_ms']:.3f} ms a step (min {min(dc['ms']):.3f}, max {max(dc['ms']):.3f}), "
          f"peak {dc['peak']} bytes; pairs kept {dc['kept']} of {dc['pairs']}, experts reached "
          f"{dc['reached_per_step']:.1f} a step over {dc['layers']} layers; bound "
          f"{dc['bound'][0]:.4f} ms ({dc['bound'][1]}); layer 0 against float64 "
          f"{dc['held']:.3g}; tokens (2 rows) {dc['greedy']}; {card}", flush=True)
    print(_prof_line("11c a decode step", dc["prof"]), flush=True)
    print(f"11c one MoE layer on {ly['T']} tokens (C = {ly['C']}, {ly['kept']} pairs kept): "
          f"idx / wslot / valid / slots equal on the card and the CPU, output relative L2 "
          f"{ly['err']:.3g} (tol {REL_TOL}); the CPU layer took {ly['cpu_s']:.2f}s", flush=True)
    print(f"11c done in {time.perf_counter() - t0:.1f}s", flush=True)
    launched = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}
    if launched:
        fail(f"phase 11 launched kernels of the k²-triples path: {launched}")
    print(f"11 done in {time.perf_counter() - t_all:.1f}s; none of the nine kernels launched",
          flush=True)
    return dict(smoke=smoke, dense=d, moe=m)


# ---------------------------------------------------------------------------
# phase 12: the transformer LM's training path (flash backward, optimizers)
# ---------------------------------------------------------------------------

TRAIN_SMOKE_STEPS = 3  # 12a: train_4k smoke programs (B 2 x S 64), card against the CPU
FLASH_SHAPE = (1, 4096, 32, 4, 64)  # 12a: B, S, H, Kv, dh of tinyllama's attention
DENSE_TRAIN = (8, 4096)  # 12b: train_4k cut from 256 x 4,096
DENSE_TRAIN_STEPS = 3  # cut from 6, then 4, for the script's time
MOE_TRAIN = (4, 2048)  # 12c: train_4k cut from 256 x 4,096
MOE_TRAIN_LAYERS = 4  # 12c: olmoe's depth cut from 16 (AdamW state of 16 layers: ~110 GB)
MOE_TRAIN_STEPS = 4
# One step from the same inputs, card against the CPU: the loss and grad_norm relative, the
# optimizer state relative L2 a leaf, the new parameters by the optimizer's rule (AdamW: the
# share of elements an update of the other sign moved, each by at most 2.02·lr; f32 Adafactor:
# the update's relative L2; bf16 parameters: the share of elements a bf16 step apart).
# Measured on an H100 80GB HBM3 at 700 W, 6 seeds an arch: loss <= 1.8e-4, grad_norm <= 5.2e-3,
# state <= 3.6e-2, AdamW share <= 7.8e-3, Adafactor update <= 4.0e-2, bf16 share <= 3.6e-2;
# gemma2 grad_norm <= 3.8e-2, state <= 0.21, share <= 4.7e-2.  With random weights the smoke
# configs amplify a rounding that lands the other way (gemma2 most: a 1e-6 relative nudge of
# its parameters moves its grad_norm by up to 21% on the CPU alone), so gemma2 has its own row.
STEP_TOL = dict(loss=1e-3, grad_norm=2e-2, state=1e-1, share=2e-2, update=1e-1, bf16=1e-1)
STEP_TOL_OF = {"gemma2-27b": dict(STEP_TOL, grad_norm=1e-1, state=5e-1, share=1e-1)}
# later steps start from parameters that differ where a first update differed (measured: loss
# <= 2.8e-3, grad_norm <= 0.25 relative)
LATER_TOL = dict(loss=1e-2, grad_norm=0.5)


def train_bound(cfg, elt: int, state_bytes: int, *, B: int, S: int,
                kept: int = 0) -> tuple[float, str, int, int]:
    """Least time of one training step on B x S tokens: (bound_ms,
    bound_by, bytes, flops).  Flops at the bf16 tensor-core rate: 6 per
    parameter of a product and token (forward 2, backward 4: the
    attention projections, the FFN or the router, the unembedding), 18·D·F_e
    a kept (token, expert) pair, causal attention 12·dh a (query, key) pair
    and head (forward 4, backward 8).  Bytes: every parameter read and
    written (``elt`` bytes each), its gradient written and read, the
    optimizer state (``state_bytes``) read and written, the tokens and
    labels."""
    L, D, H, dh, V = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_head, cfg.vocab
    attn, ffn = _lm_products(cfg)
    tokens = B * S
    pairs = B * S * (S + 1) // 2
    flops = (6 * tokens * (L * (attn + ffn) + D * V) + 18 * D * cfg.moe.d_ff_expert * kept
             if cfg.moe else 6 * tokens * (L * (attn + ffn) + D * V))
    flops += 12 * H * dh * L * pairs
    nbytes = 4 * cfg.n_params * elt + 2 * state_bytes + 8 * tokens
    return (*roofline.bound_ms(nbytes, flops, PEAK_BF16_FLOPS), int(nbytes), int(flops))


def _distinct(t) -> list:
    """A leaf's distinct tensors: itself, or a ``Sharded``'s parts once each."""
    from repro_torch.dist import sharding as shd

    return shd.distinct(t) if isinstance(t, shd.Sharded) else [t]


def _tree_bytes(tree) -> int:
    """Bytes a tree holds (a ``Sharded`` leaf's distinct tensors once)."""
    from repro_torch.tree import leaves

    return sum(p.numel() * p.element_size() for _, t in leaves(tree) for p in _distinct(t))


def _step_held(arch, spec, got, want, where: str, tol=None) -> dict:
    """One train step's metrics, state and new parameters, card (``got``)
    against CPU (``want``), each a (params, state, metrics, params before)
    tuple, within ``tol`` (default ``STEP_TOL`` / ``STEP_TOL_OF[arch]``;
    ``tol["bf16_step"]`` false drops the one-bf16-step rule for bf16
    parameters); -> the measured figures."""
    import torch

    from repro_torch.tree import leaves

    tol = tol or STEP_TOL_OF.get(arch, STEP_TOL)
    (gp, gs, gm, _), (wp, ws, wm, p0) = got, want
    err = dict(loss=abs(float(gm["loss"]) / float(wm["loss"]) - 1),
               grad_norm=abs(float(gm["grad_norm"]) / float(wm["grad_norm"]) - 1), state=0.0,
               params=0.0)
    for key in ("loss", "grad_norm"):
        if not err[key] <= tol[key]:
            fail(f"{where}: {key} {float(gm[key])} on the card, {float(wm[key])} on the CPU "
                 f"(tol {tol[key]})")
    for (path, a), (_, b) in zip(leaves(gs), leaves(ws)):
        if path == ("step",):
            if int(a) != int(b):
                fail(f"{where}: step {int(a)} against {int(b)}")
        elif float(b.norm()):
            err["state"] = max(err["state"], _rel_l2(a, b, tol["state"],
                                                     f"{where}: optimizer state {path}"))
    lr = 1e-3 if spec.optimizer == "adafactor" else 3e-4
    for (path, a), (_, b), (_, a0) in zip(leaves(gp), leaves(wp), leaves(p0)):
        a, b, a0 = a.detach().double().cpu(), b.double(), a0.double()
        off = (a - b).abs()
        if spec.optimizer == "adamw":
            share = float((off > 1e-6 + 1e-6 * b.abs()).double().mean())
            if float(off.max()) > 2.02 * lr or share > tol["share"]:
                fail(f"{where}: {path} max |diff| {float(off.max()):.3g} (at most 2.02·lr), "
                     f"{share:.4f} of its elements off (at most {tol['share']})")
            err["params"] = max(err["params"], share)
        elif spec.param_dtype == "float32":
            if not torch.equal(a, b):
                err["params"] = max(err["params"], _rel_l2(a - a0, b - a0, tol["update"],
                                                           f"{where}: {path}'s update"))
        else:
            share = float((off > 0).double().mean())
            steps = float(off.max()) > 2.0 ** -7 * float(b.abs().max())
            if (steps and tol.get("bf16_step", True)) or share > tol["bf16"]:
                fail(f"{where}: {path} max |diff| {float(off.max()):.3g} (one bf16 step of "
                     f"its largest value), {share:.4f} of its elements differ (at most "
                     f"{tol['bf16']})")
            err["params"] = max(err["params"], share)
    return err


def _flash_check(device, seed: int) -> dict:
    """``chunked_attention``'s output and ``_Flash``'s gradients at
    ``FLASH_SHAPE`` (causal) against a float64 dense softmax's autograd on
    the card; the fwd + bwd ms of each."""
    import torch

    from repro_torch.models import layers as L

    B, S, H, Kv, dh = FLASH_SHAPE
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v, w = (torch.randn(s, generator=g, device=device)
                  for s in ((B, S, H, dh), (B, S, Kv, dh), (B, S, Kv, dh), (B, S, H, dh)))
    ins = [t.bfloat16().requires_grad_() for t in (q, k, v)]

    def flash():
        out = L.chunked_attention(*ins, causal=True)
        (out.float() * w).sum().backward()
        return out

    flash()  # warm-up
    for t in ins:
        t.grad = None
    out, flash_s = _timed(flash)
    dense = [t.detach().double().requires_grad_() for t in ins]

    def exact():
        qd, kd, vd = dense
        kx, vx = (t.repeat_interleave(H // Kv, dim=2) for t in (kd, vd))
        s = torch.einsum("bqhd,bkhd->bhqk", qd, kx) / dh ** 0.5
        s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool, device=device).tril(), float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vx)
        (o * w.double()).sum().backward()
        return o

    want, exact_s = _timed(exact)
    err = {"out": _rel_l2(out, want, REL_TOL, "12a flash output against float64")}
    for name, a, b in zip("qkv", ins, dense):
        err[f"d{name}"] = _rel_l2(a.grad, b.grad, REL_TOL, f"12a flash d{name} against float64")
    return dict(err=err, flash_ms=flash_s * 1e3, exact_ms=exact_s * 1e3)


def smoke_12a(device, seed: int) -> dict:
    """Each LM arch's smoke ``train_4k`` program (B 2 x S 64, its
    optimizer) ``TRAIN_SMOKE_STEPS`` steps on the card and the CPU from
    the same ``lm_inputs`` on the same batch: every step's loss and
    grad_norm, the state and parameters after step 1 held."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.launch import programs
    from repro_torch.tree import tree_map

    out = {}
    for i, arch in enumerate(LM_ARCHS):
        spec = ARCHS[arch]
        prog = programs.build(arch, "train_4k", smoke=True)
        params, state, batch = programs.lm_inputs(prog, "cpu", seed=seed + i)
        card = [tree_map(lambda t: t.to(device, copy=True), x) for x in (params, state, batch)]
        losses, errs = [], None
        p0 = tree_map(torch.clone, params)  # the steps update in place
        for step in range(TRAIN_SMOKE_STEPS):
            got = (*prog.fn(*card), None)
            want = (*prog.fn(params, state, batch), p0)
            losses.append((float(got[2]["loss"]), float(want[2]["loss"])))
            if step == 0:
                errs = _step_held(arch, spec, got, want, f"12a {arch} step 1")
            else:
                for key, tol in LATER_TOL.items():
                    a, b = float(got[2][key]), float(want[2][key])
                    if not abs(a / b - 1) <= tol:
                        fail(f"12a {arch} step {step + 1}: {key} {a} on the card, {b} on the "
                             f"CPU (tol {tol})")
        out[arch] = dict(err=errs, losses=losses, optimizer=spec.optimizer)
    return out


def _train_run(prog, device, seed: int, B: int, S: int, steps: int, on_first=None,
               note: str | None = None) -> dict:
    """``steps`` steps of a train program on one ``lm_inputs`` batch of B x
    S (the same batch each step, so a falling loss is the optimizer's
    descent and not the spread between batches), then one profiled step:
    the losses, step ms, peak memory; ``on_first(state)`` after the first
    step goes to ``first``; ``note``: kept for phase 16 under that label."""
    import numpy as np
    import torch

    from repro_torch.launch import programs

    base = _peak_reset(device)
    params, state, batch = programs.lm_inputs(prog, device, seed=seed, batch=B, seq_len=S)
    resident = torch.cuda.memory_allocated(device)
    hist, first = [], None
    for step in range(steps):
        (_, state, m), secs = _timed(lambda: prog.fn(params, state, batch))
        hist.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), ms=secs * 1e3))
        if not all(np.isfinite([hist[-1]["loss"], hist[-1]["grad_norm"]])):
            fail(f"{prog.name}: step {step + 1} gave loss {hist[-1]['loss']}, grad_norm "
                 f"{hist[-1]['grad_norm']}")
        if step == 0 and on_first is not None:
            first = on_first(state)
    peak = torch.cuda.max_memory_allocated(device)
    median = float(np.median([h["ms"] for h in hist[1:]]))
    if note is not None:
        note_dry(note, prog.fn, (params, state, batch), median, peak, base, args_in_base=False)
    prof = _profiled(lambda: prog.fn(params, state, batch))
    return dict(B=B, S=S, hist=hist, median_ms=median, tokens_per_s=B * S / (median / 1e3),
                peak=peak, base=base, resident=resident, prof=prof, first=first,
                elt=_distinct(params["embed"])[0].element_size(), state_bytes=_tree_bytes(state))


def dense_12b(device, seed: int) -> dict:
    """``tinyllama-1.1b:train_4k`` at full width, f32 AdamW, the batch cut
    to ``DENSE_TRAIN``: ``DENSE_TRAIN_STEPS`` steps, the last loss below
    the first."""
    from repro_torch.launch import programs

    prog = programs.build("tinyllama-1.1b", "train_4k")
    B, S = DENSE_TRAIN
    r = _train_run(prog, device, seed, B, S, DENSE_TRAIN_STEPS,
                   note=f"12b tinyllama-1.1b:train_4k B {B} x S {S}")
    if not r["hist"][-1]["loss"] < r["hist"][0]["loss"]:
        fail(f"12b: the loss did not fall over {DENSE_TRAIN_STEPS} steps: "
             f"{[h['loss'] for h in r['hist']]}")
    r.update(bound=train_bound(prog.cfg, r["elt"], r["state_bytes"], B=B, S=S),
             layers=prog.cfg.n_layers, n_params=prog.cfg.n_params)
    return r


def moe_12c(device, seed: int) -> dict:
    """``olmoe-1b-7b:train_4k`` at full width through ``programs.build_lm``,
    depth cut to ``MOE_TRAIN_LAYERS``, the batch to ``MOE_TRAIN``:
    ``MOE_TRAIN_STEPS`` steps; the router's gradient (AdamW's first moment
    after step 1 is 0.1·g) nonzero; the dropped (token, expert) share of
    the first batch."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.launch import programs
    from repro_torch.models import transformer as tfm

    spec = ARCHS["olmoe-1b-7b"]
    cut = dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, n_layers=MOE_TRAIN_LAYERS))
    prog = programs.build_lm(cut, cut.shape("train_4k"))
    cfg = prog.cfg
    B, S = MOE_TRAIN
    params, _, batch = programs.lm_inputs(prog, device, seed=seed, batch=B, seq_len=S)
    with torch.no_grad(), MoeTally() as tally:
        tfm.loss_fn(cfg, params, batch)
    pairs, kept, _ = tally.totals()
    del params, batch
    r = _train_run(prog, device, seed, B, S, MOE_TRAIN_STEPS,
                   on_first=lambda st: float(st["mu"]["layers"]["router"].norm()) / 0.1)
    if not r["first"] > 0:
        fail("12c: the router's gradient is zero")
    r.update(pairs=pairs, kept=kept, dropped_share=1 - kept / pairs,
             capacity=tfm.moe_capacity(cfg, B * S), layers=cfg.n_layers, n_params=cfg.n_params,
             bound=train_bound(cfg, r["elt"], r["state_bytes"], B=B, S=S, kept=kept))
    return r


def _train_line(label: str, r: dict, card: str) -> str:
    ls = [round(h["loss"], 4) for h in r["hist"]]
    ms = [round(h["ms"], 1) for h in r["hist"]]
    return (f"{label}: losses {ls}, grad_norm {[round(h['grad_norm'], 3) for h in r['hist']]}; "
            f"step ms {ms}, median of steps 2-{len(ms)} {r['median_ms']:.1f} ms, "
            f"{r['tokens_per_s']:.1f} tokens/s; peak device memory {r['peak']} bytes "
            f"({r['resident']} resident after inputs, {r['base']} before; optimizer state "
            f"{r['state_bytes']} bytes); bound {r['bound'][0]:.3f} ms ({r['bound'][1]}; "
            f"{r['bound'][2]} bytes, {r['bound'][3]} flops); {card}")


def train_phase(device, seed: int) -> dict:
    """Phase 12; fails unless every check holds and none of the nine
    kernels launched (the training path has none).  -> the nine kernels'
    launches in the phase (all 0) under ``launches``, 12b's run under
    ``dense``."""
    from repro_torch.kernels import ops

    t_all = time.perf_counter()
    before = dict(ops.LAUNCHES)
    phase("12a. the five LM smoke train_4k programs, card against the CPU; flash gradients")
    t0 = time.perf_counter()
    smoke = smoke_12a(device, seed)
    for arch, r in smoke.items():
        e = r["err"]
        tol = STEP_TOL_OF.get(arch, STEP_TOL)
        print(f"12a {arch} ({r['optimizer']}): {TRAIN_SMOKE_STEPS} steps of B 2 x S 64, losses "
              f"(card, CPU) {[(round(a, 5), round(b, 5)) for a, b in r['losses']]} (later steps "
              f"tol {LATER_TOL}); step 1 relative: loss {e['loss']:.3g} (tol {tol['loss']}), "
              f"grad_norm {e['grad_norm']:.3g} (tol {tol['grad_norm']}), optimizer state "
              f"relative L2 {e['state']:.3g} (tol {tol['state']}), parameters {e['params']:.3g} "
              f"(AdamW / bf16: share of elements off; f32 Adafactor: the update's relative L2)",
              flush=True)
    fl = _flash_check(device, seed)
    print(f"12a flash at B {FLASH_SHAPE[0]} x S {FLASH_SHAPE[1]}, H {FLASH_SHAPE[2]} / Kv "
          f"{FLASH_SHAPE[3]}, dh {FLASH_SHAPE[4]} (causal, chunks 512 / 1024) against a float64 "
          f"dense softmax's autograd, relative L2 (tol {REL_TOL}): "
          f"{ {k: float(f'{v:.4g}') for k, v in fl['err'].items()} }; forward + backward "
          f"{fl['flash_ms']:.2f} ms (float64 dense {fl['exact_ms']:.2f} ms)", flush=True)
    print(f"12a done in {time.perf_counter() - t0:.1f}s", flush=True)

    card = gpu_line()
    phase("12b. tinyllama-1.1b:train_4k at full width")
    t0 = time.perf_counter()
    d = dense_12b(device, seed)
    print(f"12b batch cut to B = {d['B']} x S = {d['S']} (from 256 x 4,096), {d['layers']} "
          f"layers ({d['n_params']} parameters), f32 AdamW, {DENSE_TRAIN_STEPS} steps on one "
          f"TokenStream batch", flush=True)
    print(_train_line("12b", d, card), flush=True)
    print(_prof_line("12b a step", d["prof"]), flush=True)
    print(f"12b done in {time.perf_counter() - t0:.1f}s", flush=True)

    phase("12c. olmoe-1b-7b:train_4k at full width, depth cut")
    t0 = time.perf_counter()
    m = moe_12c(device, seed + 1)
    print(f"12c depth cut to {m['layers']} of 16 layers ({m['n_params']} parameters), batch cut "
          f"to B = {m['B']} x S = {m['S']} (from 256 x 4,096), f32 AdamW, {MOE_TRAIN_STEPS} "
          f"steps on one batch; capacity C = {m['capacity']}, (token, expert) pairs dropped "
          f"{m['pairs'] - m['kept']} of {m['pairs']} ({m['dropped_share']:.5f}); the router's "
          f"gradient norm at step 1 {m['first']:.4g}", flush=True)
    print(_train_line("12c", m, card), flush=True)
    print(_prof_line("12c a step", m["prof"]), flush=True)
    print(f"12c done in {time.perf_counter() - t0:.1f}s", flush=True)
    launched = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}
    if launched:
        fail(f"phase 12 launched kernels of the k²-triples path: {launched}")
    print(f"12 done in {time.perf_counter() - t_all:.1f}s; none of the nine kernels launched",
          flush=True)
    return {"launches": {k: ops.LAUNCHES[k] - before[k] for k in before}, "dense": d}



# ---------------------------------------------------------------------------
# phase 13: the LM family's serving programs on meshes of the card
# ---------------------------------------------------------------------------

MESH_SMOKE = (2, 4)  # 13a
# relative L2 (tests/test_torch_lm_mesh.py's measured bounds): 13a's k / v of layer 0 and of the
# others, and logits; one layer's output on identical inputs, a mesh against (1, 1) (13c, 13d)
MESH_TOL = dict(layer0=1e-2, layer=5e-2, logits=0.1, one_layer=2e-2)
MESH_MOE = ((1, 4), (2, 2))  # 13b: olmoe prefill_32k at MOE_PREFILL
MESH_DECODE = (1, 4)  # 13c, 13d


def _mesh_of(device, shape, spread: bool = False):
    """A ``shape`` mesh of ``device`` repeated or, with ``spread``, of the
    first distinct cards (device 0 first)."""
    from repro_torch.launch import mesh as meshlib

    n = shape[0] * shape[1]
    return meshlib.make_mesh(shape, ("data", "model"), None if spread else [device] * n)


def layout_of(prog, B: int, S: int) -> str:
    """The residual stream's layout of an LM program on a mesh at B x S:
    S split over the rules' ``"seq_sp"`` axes (the sequence-parallel
    layout) or whole (S does not divide, the rule is None, a decode
    step's one token)."""
    from repro_torch.dist.sharding import axes_of
    from repro_torch.models import transformer_mesh as tmesh

    if prog.mesh is None:
        return "one device"
    axes = axes_of(tmesh.seq_entry(prog.mesh, (B, S, prog.cfg.d_model), prog.rules))
    if not axes:
        return "layout: residual whole"
    return f"layout: seq_sp, S / {prog.mesh.size(axes)} a position over {', '.join(axes)}"


def _unsharded(x):
    from repro_torch.dist.sharding import Sharded

    return x.unshard() if isinstance(x, Sharded) else x


def _serve_out(prog, args):
    """(logits, k, v) of one run of ``prog`` on ``args``, the cache
    gathered: a decode writes a copy of the given cache."""
    args = list(args)
    if len(args) > 2:
        args[1] = {k: v.clone() for k, v in args[1].items()}
    logits, cache = prog.fn(*args)
    return logits, _unsharded(cache["k"]), _unsharded(cache["v"])


def _mesh_held(got, want, where: str) -> dict:
    """``got`` (logits, k, v) against ``want`` by ``MESH_TOL``; -> the
    relative L2 of the logits and the largest of any layer's k / v."""
    logits, k, v = got
    layer = 0.0
    for i in range(k.shape[0]):
        tol = MESH_TOL["layer0"] if i == 0 else MESH_TOL["layer"]
        for a, b, n in ((k[i], want[1][i], "k"), (v[i], want[2][i], "v")):
            layer = max(layer, _rel_l2(a, b, tol, f"{where}: layer {i}'s {n}"))
    return dict(logits=_rel_l2(logits, want[0], MESH_TOL["logits"], f"{where}: logits"),
                layer=layer)


def mesh_smoke_13a(device, seed: int) -> dict:
    """Each smoke arch's three serving programs on a ``MESH_SMOKE`` mesh
    of the card, of ``cpu`` and on the card's (1, 1) mesh, the same inputs.
    An MoE prefill routes each data slice apart (capacity from its tokens),
    so (1, 4) of the card stands in for ``MESH_SMOKE`` against (1, 1)."""
    import torch

    from repro_torch.launch import programs

    out = {}
    cpu = torch.device("cpu")
    for arch in LM_ARCHS:
        for shape in ("prefill_32k", "decode_32k", "long_500k"):
            single = programs.build(arch, shape, _mesh_of(device, (1, 1)), smoke=True)
            card = programs.build(arch, shape, _mesh_of(device, MESH_SMOKE), smoke=True)
            host = programs.build(arch, shape, _mesh_of(cpu, MESH_SMOKE), smoke=True)
            args = programs.lm_inputs(single, device, seed=seed)
            args_cpu = [_tree_to(a, cpu) if isinstance(a, dict) else a.cpu() for a in args]
            got = _serve_out(card, args)
            if not all(isinstance(x, torch.Tensor) and x.device == device for x in got):
                fail(f"13a {arch}:{shape}: the card mesh's results are not on {device}")
            cpu_held = _mesh_held(got, _serve_out(host, args_cpu), f"13a {arch}:{shape} cpu mesh")
            if single.cfg.moe and shape == "prefill_32k":
                got = _serve_out(programs.build(arch, shape, _mesh_of(device, (1, 4)), smoke=True),
                                 args)
            B, S = (args[1].shape if shape == "prefill_32k" else (args[2].shape[0], 1))
            out[f"{arch}:{shape}"] = dict(
                single=_mesh_held(got, _serve_out(single, args), f"13a {arch}:{shape} (1, 1)"),
                cpu=cpu_held, moe_prefill=bool(single.cfg.moe) and shape == "prefill_32k",
                layout=layout_of(card, B, S))
    return out


def _placed_bytes(prog, params) -> int:
    """Bytes allocated on the mesh's cards by placing ``params`` on
    ``prog``'s mesh (0 on a repeated card: every shard a view)."""
    import torch

    from repro_torch.launch import programs

    cards = list(dict.fromkeys(prog.mesh.devices))
    before = sum(torch.cuda.memory_allocated(d) for d in cards)
    placed = programs.shard_params(params, prog.mesh, prog.rules)
    grown = sum(torch.cuda.memory_allocated(d) for d in cards) - before
    del placed
    return grown


def moe_mesh_13b(device, seed: int, spread: bool = False) -> dict:
    """``olmoe-1b-7b:prefill_32k`` at ``MOE_PREFILL`` on (1, 1) and the
    ``MESH_MOE`` meshes (of distinct cards with ``spread``); layer 0's MoE
    on (1, 4) against ``moe_ffn``."""
    import torch

    from repro_torch.launch import programs
    from repro_torch.models import layers as L, transformer as tfm

    arch = "olmoe-1b-7b"
    B, S = MOE_PREFILL
    single = programs.build(arch, "prefill_32k", _mesh_of(device, (1, 1)))
    cfg = single.cfg
    base = _peak_reset(device)
    params, toks = programs.lm_inputs(single, device, seed=seed, batch=B, seq_len=S)
    pairs = B * S * cfg.moe.top_k * cfg.n_layers
    out = {}
    for shape in ((1, 1),) + MESH_MOE:
        prog = single if shape == (1, 1) else programs.build(arch, "prefill_32k",
                                                             _mesh_of(device, shape, spread))
        grown = 0 if shape == (1, 1) else _placed_bytes(prog, params)
        if grown and not spread:
            fail(f"13b {shape}: placing the parameters on the mesh allocated {grown} bytes")
        args = programs.lm_place(prog, (params, toks))
        with MoeTally() as tally:  # also the warm-up
            prog.fn(*args)
        kept = tally.totals()[1]
        _peak_reset(device)
        (logits, _), secs = _timed(lambda: prog.fn(*args))
        peak = torch.cuda.max_memory_allocated(device)
        del args
        if not torch.isfinite(logits).all() or tuple(logits.shape) != (B, cfg.vocab):
            fail(f"13b {shape}: logits of shape {tuple(logits.shape)}")
        out[shape] = dict(seconds=secs, tokens_per_s=B * S / secs, peak=peak, base=base,
                          kept=kept, dropped_share=1 - kept / pairs, logits=logits, grown=grown,
                          layout=layout_of(prog, B, S))
    for shape in MESH_MOE:
        r = out[shape]
        r["vs_single"] = float((r["logits"] - out[(1, 1)]["logits"]).norm()
                               / out[(1, 1)]["logits"].norm())
    # layer 0's MoE on the prompt's embeddings: (1, 4) routes as moe_ffn
    lp = tfm._layer_params(params, 0)
    x = L.rms_norm(tfm._embed(params, toks), lp["ffn_norm"])
    m = cfg.moe
    C = tfm.moe_capacity(cfg, B * S)
    want = tfm._moe_route(tfm.moe_gates(lp, x.reshape(-1, cfg.d_model)), m.n_experts, m.top_k, C)
    mesh = _mesh_of(device, (1, 4), spread)
    routes = []
    orig = tfm._moe_route

    def recorded(*a):
        r = orig(*a)
        routes.append((a[4], r[:3]))
        return r

    tfm._moe_route = recorded
    try:
        y = tfm.moe_ffn_shmap(cfg, lp, x, mesh=mesh, dp_axes=("data",))
    finally:
        tfm._moe_route = orig
    E_loc = m.n_experts // 4
    for e0, r in routes:
        sl = slice(e0 * C, (e0 + E_loc) * C)
        for name, a, b in zip(("idx", "wslot", "valid"), r, want[:3]):
            if not torch.equal(a.to(b.device), b[sl]):
                fail(f"13b: layer 0's MoE on (1, 4), experts {e0}.., {name} differs from moe_ffn's")
    ref = tfm._moe_expert_compute(lp, x.reshape(-1, cfg.d_model), *want[:3], m.n_experts, C,
                                  want[3])
    out["layer"] = dict(T=B * S, C=C, kept=int(want[2].sum()), routes=len(routes),
                        err=_rel_l2(y.reshape(-1, cfg.d_model), ref, REL_TOL,
                                    "13b: layer 0's MoE on (1, 4) against moe_ffn"))
    del params
    return out


def _one_layer(cfg, params, cache):
    """Layer 0 alone: a one-layer config, its parameters and cache views."""
    import dataclasses

    return (dataclasses.replace(cfg, n_layers=1),
            dict(params, layers={k: v[:1] for k, v in params["layers"].items()}),
            {k: v[:1] for k, v in cache.items()})


def decode_mesh_13cd(device, seed: int, shape: str, batch, spread: bool = False) -> dict:
    """``tinyllama-1.1b`` decode ``shape`` on (1, 1) and ``MESH_DECODE``
    meshes of the card (of distinct cards with ``spread``) on one seeded
    cache: ms a step, peak memory, a profiled step; layer 0 on identical
    inputs held (1, 4) against (1, 1)."""
    import numpy as np
    import torch

    from repro_torch.launch import programs
    from repro_torch.models import transformer as tfm, transformer_mesh as tmesh

    arch = "tinyllama-1.1b"
    single = programs.build(arch, shape, _mesh_of(device, (1, 1)))
    prog = programs.build(arch, shape, _mesh_of(device, MESH_DECODE, spread))
    cfg = single.cfg
    base = _peak_reset(device)
    params, cache, new, lengths = programs.lm_inputs(single, device, seed=seed, batch=batch)
    b, ctx = cache["k"].shape[1], cache["k"].shape[2]
    out = dict(B=b, ctx=ctx, base=base, grown=_placed_bytes(prog, params),
               bound=lm_bound(cfg, params["embed"].element_size(), B=b, S=1, ctx=ctx),
               layout=layout_of(prog, b, 1))
    if out["grown"] and not spread:
        fail(f"13 {shape}: placing the parameters on the mesh allocated {out['grown']} bytes")
    for name, p in (("single", single), ("mesh", prog)):
        a = programs.lm_place(p, (params, cache, new, lengths))  # views: the same cache
        _peak_reset(device)
        ms, steps, _ = _decode_steps(cfg, p, *a, TIMED_STEPS + 1, greedy=False)
        x = steps[-1]
        if not torch.isfinite(x).all() or tuple(x.shape) != (b, cfg.vocab):
            fail(f"13 {shape} {name}: logits of shape {tuple(x.shape)}")
        out[name] = dict(ms=ms[1:], median_ms=float(np.median(ms[1:])), logits=x,
                         peak=torch.cuda.max_memory_allocated(device),
                         prof=_profiled(lambda: p.fn(*a)))
        del a, steps
    out["free"] = float((out["mesh"]["logits"] - out["single"]["logits"]).norm()
                        / out["single"]["logits"].norm())
    # layer 0 on identical inputs: a one-layer model's logits, (1, 4) against (1, 1)
    cfg1, p1, c1 = _one_layer(cfg, params, cache)
    want, _ = tfm.decode_step(cfg1, p1, c1, new, lengths)
    got, _ = tmesh.decode_step(cfg1, *programs.lm_place(prog, (p1, c1, new, lengths)),
                               mesh=prog.mesh)
    out["layer"] = _rel_l2(got, want, MESH_TOL["one_layer"],
                           f"13 {shape}: layer 0 on (1, 4) against (1, 1)")
    del params, cache
    return out


def mesh_phase(device, seed: int, spread: bool = False) -> dict:
    """Phase 13; fails unless every check holds and none of the nine kernels
    launched.  -> the nine kernels' launches in the phase (all 0).  With
    ``spread`` (four or more cards) 13b-13d's meshes lie on distinct cards,
    the lead card the first."""
    from repro_torch.kernels import ops

    t_all = time.perf_counter()
    before = dict(ops.LAUNCHES)
    card = gpu_line()
    phase("13a. the five LM smoke archs' serving programs on a (2, 4) mesh of the card")
    t0 = time.perf_counter()
    for cell, r in mesh_smoke_13a(device, seed).items():
        moe = " (against (1, 1) on (1, 4))" if r["moe_prefill"] else ""
        print(f"13a {cell} on {MESH_SMOKE} ({r['layout']}){moe}: against the card's (1, 1) "
              f"logits relative L2 "
              f"{r['single']['logits']:.3g}, k / v {r['single']['layer']:.3g}; against a "
              f"{MESH_SMOKE} mesh of cpu logits {r['cpu']['logits']:.3g}, k / v "
              f"{r['cpu']['layer']:.3g} (tol {MESH_TOL})", flush=True)
    print(f"13a done in {time.perf_counter() - t0:.1f}s", flush=True)

    phase(f"13b. olmoe-1b-7b:prefill_32k at full width on meshes of "
          f"{'distinct cards' if spread else 'the card'}")
    t0 = time.perf_counter()
    m = moe_mesh_13b(device, seed + 1, spread)
    for shape in ((1, 1),) + MESH_MOE:
        r = m[shape]
        extra = "" if shape == (1, 1) else (f", logits relative L2 to (1, 1) {r['vs_single']:.3g} "
                                            "(not held: random weights grow a rounding through "
                                            "16 layers)")
        print(f"13b {shape} ({r['layout']}) prefill B = {MOE_PREFILL[0]} x S = "
              f"{MOE_PREFILL[1]}: "
              f"{r['seconds']:.4f}s, {r['tokens_per_s']:.1f} tokens/s, peak {r['peak']} bytes "
              f"on the lead ({r['base']} resident before; {r['grown']} bytes added placing "
              f"the parameters), pairs kept {r['kept']}, dropped share "
              f"{r['dropped_share']:.5f}{extra}; {card}", flush=True)
    ly = m["layer"]
    print(f"13b layer 0's MoE on the prompt ({ly['T']} tokens, C = {ly['C']}): on (1, 4) each "
          f"of {ly['routes']} model shards' idx / wslot / valid equal to moe_ffn's slots of its "
          f"experts ({ly['kept']} pairs kept), output relative L2 {ly['err']:.3g} (tol "
          f"{REL_TOL})", flush=True)
    print(f"13b done in {time.perf_counter() - t0:.1f}s", flush=True)

    for label, shape, batch in (("13c", "long_500k", None), ("13d", "decode_32k", DENSE_DECODE_B)):
        phase(f"{label}. tinyllama-1.1b:{shape} on a {MESH_DECODE} mesh of "
              f"{'distinct cards' if spread else 'the card'}")
        t0 = time.perf_counter()
        d = decode_mesh_13cd(device, seed + 2, shape, batch, spread)
        for name in ("single", "mesh"):
            r = d[name]
            where = (1, 1) if name == "single" else MESH_DECODE
            lay = "one device" if name == "single" else d["layout"]
            print(f"{label} {shape} {where} ({lay}), B = {d['B']}, {d['ctx']} slots: median "
                  f"{r['median_ms']:.3f} ms a step over {len(r['ms'])} (min {min(r['ms']):.3f}, "
                  f"max {max(r['ms']):.3f}), peak {r['peak']} bytes ({d['base']} before); bound "
                  f"{d['bound'][0]:.4f} ms ({d['bound'][1]}); {card}", flush=True)
            print(_prof_line(f"{label} a {where} step", r["prof"]), flush=True)
        print(f"{label} layer 0 on identical inputs, {MESH_DECODE} against (1, 1): relative L2 "
              f"{d['layer']:.3g} (tol {MESH_TOL['one_layer']}); the whole step's logits {d['free']:.3g} (not "
              f"held: random weights grow a rounding through 22 layers); parameters placed "
              f"with {d['grown']} bytes added", flush=True)
        print(f"{label} done in {time.perf_counter() - t0:.1f}s", flush=True)
    launched = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}
    if launched:
        fail(f"phase 13 launched kernels of the k²-triples path: {launched}")
    print(f"13 done in {time.perf_counter() - t_all:.1f}s; none of the nine kernels launched",
          flush=True)
    return {k: ops.LAUNCHES[k] - before[k] for k in before}


# ---------------------------------------------------------------------------
# phase 14: training on meshes of the card (the LM's train_4k) and the xDeepFM recsys family
# ---------------------------------------------------------------------------

TRAIN_MESH = (2, 4)  # 14a
TRAIN_MESH_STEPS = 3
# 14a, step 1 (relative, by ``_step_held``'s rules).  "cpu": the card's mesh against the same
# mesh of cpu, and "distinct": a mesh over distinct devices against the card's mesh (the same
# layout; the card's and the CPU's roundings): PR 23's card-against-CPU ``STEP_TOL``, the
# distinct mesh's f32 Adafactor update at 0.15.  "layout": the card's mesh against its (1, 1)
# program (each model shard's bf16 partial rounded before the sum, grown through the smoke
# layers), no one-bf16-step rule (an Adafactor update of a near-zero leaf may change sign).
# Measured on an H100 80GB HBM3 at 700 W, 4 seeds an arch (``measure_14a``): cpu loss <=
# 3.3e-5, grad_norm <= 1.4e-4, state <= 2.2e-2, shares <= 1.4e-2, update <= 5.1e-2 (gemma2:
# 2.7e-4, 2.7e-2, 0.24, 5.5e-2); distinct loss <= 3.3e-5, grad_norm <= 6.0e-3, state <=
# 2.6e-2, shares <= 4.8e-2, update <= 7.4e-2 (gemma2 state 0.11); layout loss <= 5.4e-4,
# grad_norm <= 0.10, state <= 0.49, AdamW share <= 7.8e-2, update <= 0.38, bf16 share <=
# 0.30 (gemma2: grad_norm 0.23, state 0.64, share 0.14) - ``measure_14a`` on seeds 100, 200,
# 300, 400 and the phase's own; on four cards (model shard m on card m) distinct loss 0,
# grad_norm <= 1.7e-3, state <= 2.8e-2, shares <= 5.2e-2.  Later steps start from parameters
# a first update moved apart: a layout's loss 1.6e-2 apart at step 3 (kimi), and on four
# cards kimi's distinct grad_norm 0.75 apart at step 3 (its loss within 1e-2).
MESH_STEP_TOL = {
    "cpu": STEP_TOL, "distinct": dict(STEP_TOL, update=0.15),
    "layout": dict(loss=2e-3, grad_norm=0.3, state=1.0, share=0.15, update=0.75, bf16=0.6,
                   bf16_step=False),
}
MESH_STEP_TOL_OF = {"gemma2-27b": {"cpu": STEP_TOL_OF["gemma2-27b"],
                                   "distinct": STEP_TOL_OF["gemma2-27b"],
                                   "layout": dict(MESH_STEP_TOL["layout"], grad_norm=0.6,
                                                  state=1.5, share=0.3)}}
# steps 2 on: loss and grad_norm, relative
MESH_LATER_TOL = {"cpu": LATER_TOL, "distinct": dict(LATER_TOL, grad_norm=1.0),
                  "layout": dict(loss=5e-2, grad_norm=0.5)}
DENSE_MESH = (1, 4)  # 14b, 14c
DENSE_MESH_STEPS = 2  # 14b: on 12b's B 8 x S 4,096 batch (3 before phases 15c-17)
MOE_MESH_STEPS = 3  # 14c: on 12c's B 4 x S 2,048 batch, 12c's depth cut
RECSYS_MESH = (1, 4)  # 14d
RECSYS_STEPS = 3
SERVE_CALLS = 8  # 14d: serve_p99 and retrieval_cand, median of the calls after a warm-up
BULK_CALLS = 3
# 14d: the full-config programs on (1, 4) against (1, 1), relative L2: the lookups' psum has
# one nonzero term and the dense part runs once a data slice, so forward and retrieval are the
# same computation; a train step's parameters differ where the tables' gradient sums another
# way.  The smoke programs card against CPU (f32 products summed in another order).
RECSYS_TOL = dict(forward=1e-6, retrieval=1e-6, loss=1e-6, params=1e-5, smoke=1e-4)
# 14d: serve_bulk's peak above its inputs: the CIN's chunks (<= CIN_CHUNK_BYTES of z, its
# output and the pooled maps) and the DNN's activations, far below the 81.8 GB of one
# unchunked [B, H, F, D] layer
BULK_GROWTH = 8 << 30


def _whole(tree):
    """A copy of ``tree`` on the CPU, ``Sharded`` leaves gathered."""
    from repro_torch.dist.sharding import Sharded
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.unshard(device="cpu") if isinstance(t, Sharded)
                    else t.detach().to("cpu", copy=True), tree)


def _spread_mesh(device, shape):
    """A ``shape`` mesh whose positions lie on distinct devices: four cards
    (model shard m on card m) when the run has them, else the card and the
    CPU alternated; -> (mesh, label)."""
    import torch

    from repro_torch.launch import mesh as meshlib

    n = shape[0] * shape[1]
    if torch.cuda.device_count() >= 4:
        devs, label = [torch.device("cuda", i % 4) for i in range(n)], "four cards"
    else:
        devs = [device if i % 2 == 0 else torch.device("cpu") for i in range(n)]
        label = "the card and the CPU alternated"
    return meshlib.make_mesh(shape, ("data", "model"), devs), label


def _mesh_steps(prog, base, device, steps: int):
    """``steps`` steps of a train program from copies of ``base`` (params,
    state, batch on the CPU) made on ``device`` and placed on its mesh, the
    same batch each step; -> (each step's loss / grad_norm, step 1's
    (params, state, metrics) gathered on the CPU)."""
    from repro_torch.launch import programs
    from repro_torch.tree import tree_map

    args = programs.lm_place(prog, tuple(tree_map(lambda t: t.to(device, copy=True), a)
                                         for a in base))
    hist, first = [], None
    for step in range(steps):
        p, s, m = prog.fn(*args)
        hist.append({k: float(v) for k, v in m.items()})
        if step == 0:
            first = (_whole(p), _whole(s), m, None)
    return hist, first


def train_mesh_14a(device, seed: int) -> dict:
    """Each smoke arch's ``train_4k`` program ``TRAIN_MESH_STEPS`` steps on
    a ``TRAIN_MESH`` mesh of the card, of ``cpu``, of distinct devices
    (``_spread_mesh``) and on the card's (1, 1) program, from the same
    ``lm_inputs``: step 1 held by ``MESH_STEP_TOL``, later steps' loss and
    grad_norm by ``MESH_LATER_TOL``.  An MoE's capacity is a data slice's,
    so its (1, 1) comparison runs on (1, 4)."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.launch import programs

    cpu = torch.device("cpu")
    spread, label = _spread_mesh(device, TRAIN_MESH)
    out = {}
    for i, arch in enumerate(LM_ARCHS):
        spec = ARCHS[arch]
        moe = spec.smoke_cfg.moe is not None
        single = programs.build(arch, "train_4k", _mesh_of(device, (1, 1)), smoke=True)
        base = programs.lm_inputs(single, "cpu", seed=seed + i)
        p0 = _whole(base[0])
        runs = {}
        for name, mesh, dev in (("card", _mesh_of(device, TRAIN_MESH), device),
                                ("cpu", _mesh_of(cpu, TRAIN_MESH), cpu),
                                ("distinct", spread, device),
                                ("single", _mesh_of(device, (1, 1)), device)):
            prog = single if name == "single" else programs.build(arch, "train_4k", mesh,
                                                                  smoke=True)
            runs[name] = _mesh_steps(prog, base, dev, TRAIN_MESH_STEPS)
        layout = runs["card"]
        if moe:
            layout = _mesh_steps(programs.build(arch, "train_4k", _mesh_of(device, (1, 4)),
                                                smoke=True), base, device, TRAIN_MESH_STEPS)
        tols = MESH_STEP_TOL_OF.get(arch, MESH_STEP_TOL)
        errs = {}
        for kind, got, want in (("cpu", runs["card"], runs["cpu"]),
                                ("distinct", runs["distinct"], runs["card"]),
                                ("layout", layout, runs["single"])):
            where = f"14a {arch} {kind}"
            errs[kind] = _step_held(arch, spec, got[1], (*want[1][:3], p0), where, tols[kind])
            for step in range(1, TRAIN_MESH_STEPS):
                for key, tol in MESH_LATER_TOL[kind].items():
                    a, b = got[0][step][key], want[0][step][key]
                    if not abs(a / b - 1) <= tol:
                        fail(f"{where} step {step + 1}: {key} {a} against {b} (tol {tol})")
        B, S = base[2]["tokens"].shape
        out[arch] = dict(err=errs, optimizer=spec.optimizer, moe=moe, label=label,
                         losses={k: [h["loss"] for h in v[0]] for k, v in runs.items()},
                         layout=layout_of(programs.build(arch, "train_4k", spread, smoke=True),
                                          B, S))
    return out


def measure_14a(device, seeds=(100, 200, 300, 400)) -> int:
    """14a on each of ``seeds``, every step-1 figure printed and a check
    that would fail printed in place of failing: the measurement behind
    ``MESH_STEP_TOL``.  -> the count of checks that would fail."""
    global fail
    would = []
    fatal = fail
    fail = lambda msg: (would.append(msg), print(f"would fail: {msg}", flush=True))  # noqa: E731
    try:
        for seed in seeds:
            for arch, r in train_mesh_14a(device, seed).items():
                print(f"seed {seed} {arch} " + "; ".join(
                    f"{k} {_errs(e)}" for k, e in r["err"].items()), flush=True)
    finally:
        fail = fatal
    return len(would)


def _unshard_norm(t) -> float:
    from repro_torch.dist.sharding import Sharded

    return float((t.unshard() if isinstance(t, Sharded) else t).norm())


def dense_mesh_14b(device, seed: int) -> dict:
    """``tinyllama-1.1b:train_4k`` at full width on a ``DENSE_MESH`` mesh of
    the card, 12b's batch cut: ``DENSE_MESH_STEPS`` steps on one batch, the
    loss falling."""
    from repro_torch.launch import programs

    prog = programs.build("tinyllama-1.1b", "train_4k", _mesh_of(device, DENSE_MESH))
    B, S = DENSE_TRAIN
    r = _train_run(prog, device, seed, B, S, DENSE_MESH_STEPS)
    if not r["hist"][-1]["loss"] < r["hist"][0]["loss"]:
        fail(f"14b: the loss did not fall over {DENSE_MESH_STEPS} steps: "
             f"{[h['loss'] for h in r['hist']]}")
    r.update(bound=train_bound(prog.cfg, r["elt"], r["state_bytes"], B=B, S=S),
             layers=prog.cfg.n_layers, n_params=prog.cfg.n_params, layout=layout_of(prog, B, S))
    return r


def moe_mesh_14c(device, seed: int) -> dict:
    """``olmoe-1b-7b:train_4k`` at full width on a ``DENSE_MESH`` mesh of
    the card (the expert-parallel MoE's backward), 12c's depth and batch
    cut: ``MOE_MESH_STEPS`` steps on one batch, the loss falling, the
    router's gradient nonzero."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.launch import programs

    spec = ARCHS["olmoe-1b-7b"]
    cut = dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, n_layers=MOE_TRAIN_LAYERS))
    prog = programs.build_lm(cut, cut.shape("train_4k"), _mesh_of(device, DENSE_MESH))
    B, S = MOE_TRAIN
    r = _train_run(prog, device, seed, B, S, MOE_MESH_STEPS,
                   on_first=lambda st: _unshard_norm(st["mu"]["layers"]["router"]) / 0.1)
    if not r["first"] > 0:
        fail("14c: the router's gradient is zero")
    if not r["hist"][-1]["loss"] < r["hist"][0]["loss"]:
        fail(f"14c: the loss did not fall over {MOE_MESH_STEPS} steps: "
             f"{[h['loss'] for h in r['hist']]}")
    r.update(layers=prog.cfg.n_layers, n_params=prog.cfg.n_params,
             bound=train_bound(prog.cfg, r["elt"], r["state_bytes"], B=B, S=S),
             layout=layout_of(prog, B, S))
    return r


def recsys_bound(cfg, kind: str, rows: int) -> tuple[float, str]:
    """Least time of a recsys call: its model flops (``flops_forward``, ×3
    for a train step) at the card's f32 rate (the products run in f32), or
    the bytes it must move, whichever is larger: the gathered rows (F
    fields of D + 1 f32 values a row), the ids, the dense parameters, the
    outputs; a train step adds every parameter and AdamW moment read and
    written; retrieval the candidate rows and the user's."""
    from repro_torch.models.recsys import xdeepfm

    F, D = cfg.n_fields, cfg.embed_dim
    dense = cfg.n_params - F * cfg.rows_per_field * (D + 1)
    if kind == "retrieval":
        flops, nbytes = 2.0 * rows * D, rows * (4 * D + 4) + 4 * F * (D + 1) + 4 * rows
    else:
        flops = xdeepfm.flops_forward(cfg, rows) * (3 if kind == "train" else 1)
        nbytes = rows * F * (4 * D + 4 + 4) + 4 * dense + 4 * rows
        if kind == "train":
            nbytes += 4 * cfg.n_params * 2 * 3  # parameters and both moments, read and written
    return roofline.bound_ms(nbytes, flops, PEAK_F32_FLOPS)


def _rel(a, b) -> float:
    a, b = a.detach().double(), b.detach().double().to(a.device)
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _recsys_calls(prog, args, n: int):
    """``n`` timed calls of a forward program (after one warm-up); -> (ms
    of each, the last output)."""
    import torch

    with torch.no_grad():
        prog.fn(*args)
        ms = []
        for _ in range(n):
            out, secs = _timed(lambda: prog.fn(*args))
            ms.append(secs * 1e3)
    return ms, out


def recsys_14d(device, seed: int) -> dict:
    """``xdeepfm`` at the full config (39 fields x 10^6 rows x 10, CIN
    200-200-200, DNN 400-400), uncut, on (1, 1) and ``RECSYS_MESH`` meshes
    of the card: ``train_batch`` ``RECSYS_STEPS`` steps on one batch (the
    loss falling), ``serve_p99`` and ``retrieval_cand`` median ms,
    ``serve_bulk`` rows a second and its peak within ``BULK_GROWTH`` of its
    inputs; each mesh's outputs and first step against (1, 1)'s by
    ``RECSYS_TOL``; the four smoke programs card against CPU."""
    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.launch import programs
    from repro_torch.models.recsys import xdeepfm
    from repro_torch.tree import leaves, tree_map

    cfg = ARCHS["xdeepfm"].cfg
    specs = xdeepfm.param_specs(cfg)
    out = {"chunk_rows": xdeepfm.cin_chunk_rows(
        specs["cin"], torch.empty(1, cfg.n_fields, cfg.embed_dim, device="meta")),
        "chunk_bytes": xdeepfm.CIN_CHUNK_BYTES, "cfg": cfg}
    for shape in ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"):
        res = {}
        for mshape in ((1, 1), RECSYS_MESH):
            prog = programs.build("xdeepfm", shape, _mesh_of(device, mshape))
            base = _peak_reset(device)
            args = programs.recsys_inputs(prog, device, seed=seed)
            resident = torch.cuda.memory_allocated(device)
            r = dict(base=base, resident=resident)
            if shape == "train_batch":
                hist = []
                for step in range(RECSYS_STEPS):
                    m, secs = _timed(lambda: prog.fn(*args)[2])
                    hist.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                     ms=secs * 1e3))
                    if step == 0:  # the parameters after step 1 (``args`` is updated in place)
                        r["first"] = tree_map(lambda t: t.unshard() if hasattr(t, "unshard")
                                              else t.clone(), args[0])
                if not hist[-1]["loss"] < hist[0]["loss"]:
                    fail(f"14d {shape} {mshape}: the loss did not fall: "
                         f"{[h['loss'] for h in hist]}")
                rows = prog.in_specs[2]["ids"].shape[0]
                median = float(np.median([h["ms"] for h in hist[1:]]))
                if mshape == (1, 1):
                    note_dry("14d xdeepfm:train_batch (1, 1)", prog.fn, args, median,
                             torch.cuda.max_memory_allocated(device), base, args_in_base=False)
                r.update(hist=hist, median_ms=median, rows_per_s=rows / median * 1e3,
                         output=torch.tensor(hist[0]["loss"]))
                kind = "train"
            else:
                rows = args[-1].shape[0]
                ms, got = _recsys_calls(prog, args, BULK_CALLS if shape == "serve_bulk"
                                        else SERVE_CALLS)
                if not torch.isfinite(got).all() or tuple(got.shape) != (rows,):
                    fail(f"14d {shape} {mshape}: an output of shape {tuple(got.shape)}")
                median = float(np.median(ms))
                r.update(ms=ms, median_ms=median, rows_per_s=rows / median * 1e3, output=got)
                kind = "retrieval" if shape == "retrieval_cand" else "forward"
            r.update(peak=torch.cuda.max_memory_allocated(device), rows=rows,
                     bound=recsys_bound(cfg, kind, rows))
            if shape == "serve_bulk" and r["peak"] - resident > BULK_GROWTH:
                fail(f"14d serve_bulk {mshape}: peak {r['peak']} bytes, {r['peak'] - resident} "
                     f"above its inputs (at most {BULK_GROWTH}: no [B, H, F, D] whole)")
            del args
            res[mshape] = r
        single, mesh = res[(1, 1)], res[RECSYS_MESH]
        if shape == "train_batch":
            key, err = "loss", abs(float(mesh["output"]) / float(single["output"]) - 1)
            perr = max(_rel(a, b) for (_, a), (_, b) in zip(leaves(mesh["first"]),
                                                           leaves(single["first"])))
            if not perr <= RECSYS_TOL["params"]:
                fail(f"14d train_batch: step 1's parameters on {RECSYS_MESH} against (1, 1): "
                     f"relative L2 {perr:.3g} (tol {RECSYS_TOL['params']})")
            mesh["params_err"] = perr
            for r in (single, mesh):
                r.pop("first")
        else:
            key = "retrieval" if shape == "retrieval_cand" else "forward"
            err = _rel(mesh["output"], single["output"])
        if not err <= RECSYS_TOL[key]:
            fail(f"14d {shape}: {RECSYS_MESH} against (1, 1): {key} {err:.3g} (tol "
                 f"{RECSYS_TOL[key]})")
        mesh["err"] = err
        out[shape] = res
    # the smoke programs, card against the CPU, on (1, 1) and (2, 4), from the same inputs
    smoke = 0.0
    cpu = torch.device("cpu")
    for shape in ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"):
        for mshape in ((1, 1), (2, 4)):
            host = programs.recsys_inputs(
                programs.build("xdeepfm", shape, _mesh_of(cpu, (1, 1)), smoke=True), "cpu",
                seed=seed)
            got = []
            for dev in (device, cpu):
                prog = programs.build("xdeepfm", shape, _mesh_of(dev, mshape), smoke=True)
                o = prog.fn(*(tree_map(lambda t: t.to(dev, copy=True), a) for a in host))
                got.append((torch.stack([o[2]["loss"], o[2]["grad_norm"]])
                            if isinstance(o, tuple) else o).cpu())
            e = _rel(got[0], got[1])
            if not e <= RECSYS_TOL["smoke"]:
                fail(f"14d smoke {shape} {mshape}: card against CPU {e:.3g} (tol "
                     f"{RECSYS_TOL['smoke']})")
            smoke = max(smoke, e)
    out["smoke"] = smoke
    return out


def train_mesh_phase(device, seed: int, dense_12b=None) -> dict:
    """Phase 14; fails unless every check holds and none of the nine
    kernels launched.  ``dense_12b``: phase 12b's run, printed beside 14b.
    -> the nine kernels' launches in 14a-14c (``train_mesh``) and in 14d
    (``recsys``), all 0."""
    from repro_torch.kernels import ops

    t_all = time.perf_counter()
    before = dict(ops.LAUNCHES)
    card = gpu_line()
    phase(f"14a. the five LM smoke train_4k programs on a {TRAIN_MESH} mesh of the card")
    t0 = time.perf_counter()
    for arch, r in train_mesh_14a(device, seed).items():
        e = r["err"]
        extra = " (layout on (1, 4): an MoE's capacity is a data slice's)" if r["moe"] else ""
        print(f"14a {arch} ({r['optimizer']}; {r['layout']}), {TRAIN_MESH_STEPS} steps of "
              f"B 2 x S 64, step 1 "
              f"relative (loss, grad_norm, state, parameters): card mesh against cpu mesh "
              f"{_errs(e['cpu'])}; distinct devices ({r['label']}) against the card mesh "
              f"{_errs(e['distinct'])}; card mesh against the card's (1, 1){extra} "
              f"{_errs(e['layout'])}; losses "
              f"{ {k: [round(x, 5) for x in v] for k, v in r['losses'].items()} }"
              f" (tol {MESH_STEP_TOL_OF.get(arch, MESH_STEP_TOL)}, later steps "
              f"{MESH_LATER_TOL})", flush=True)
    print(f"14a done in {time.perf_counter() - t0:.1f}s", flush=True)

    phase(f"14b. tinyllama-1.1b:train_4k at full width on a {DENSE_MESH} mesh of the card")
    t0 = time.perf_counter()
    d = dense_mesh_14b(device, seed)
    print(f"14b batch cut to B = {d['B']} x S = {d['S']} (from 256 x 4,096), {d['layers']} "
          f"layers ({d['n_params']} parameters), f32 AdamW, {DENSE_MESH_STEPS} steps on one "
          f"TokenStream batch", flush=True)
    print(_train_line(f"14b {DENSE_MESH} ({d['layout']})", d, card), flush=True)
    print(_prof_line(f"14b a {DENSE_MESH} step", d["prof"]), flush=True)
    if dense_12b is not None:
        print(f"14b beside 12b's (1, 1) step in this run: {d['median_ms']:.1f} against "
              f"{dense_12b['median_ms']:.1f} ms ({d['median_ms'] / dense_12b['median_ms']:.3f}x), "
              f"peak {d['peak']} against {dense_12b['peak']} bytes, kernels a profiled step "
              f"{d['prof']['kernels']} against {dense_12b['prof']['kernels']}, idle "
              f"{d['prof']['idle']:.3f} against {dense_12b['prof']['idle']:.3f}", flush=True)
    print(f"14b done in {time.perf_counter() - t0:.1f}s", flush=True)

    phase(f"14c. olmoe-1b-7b:train_4k at full width on a {DENSE_MESH} mesh of the card, "
          "depth cut")
    t0 = time.perf_counter()
    m = moe_mesh_14c(device, seed + 1)
    print(f"14c depth cut to {m['layers']} of 16 layers ({m['n_params']} parameters), batch cut "
          f"to B = {m['B']} x S = {m['S']}, f32 AdamW, {MOE_MESH_STEPS} steps on one batch; the "
          f"router's gradient norm at step 1 {m['first']:.4g}", flush=True)
    print(_train_line(f"14c {DENSE_MESH} ({m['layout']})", m, card), flush=True)
    print(_prof_line(f"14c a {DENSE_MESH} step", m["prof"]), flush=True)
    print(f"14c done in {time.perf_counter() - t0:.1f}s", flush=True)
    mid = dict(ops.LAUNCHES)

    phase("14d. xdeepfm at the full config on (1, 1) and "
          f"{RECSYS_MESH} meshes of the card")
    t0 = time.perf_counter()
    x = recsys_14d(device, seed + 2)
    c = x["cfg"]
    print(f"14d full config, uncut: {c.n_fields} fields x {c.rows_per_field} rows x "
          f"{c.embed_dim}, CIN {c.cin_layers}, DNN {c.mlp_dims}, {c.n_params} f32 parameters; "
          f"CIN chunks of {x['chunk_rows']} rows (<= {x['chunk_bytes']} bytes of z)", flush=True)
    for shape in ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand"):
        for mshape, r in x[shape].items():
            what = (f"losses {[round(h['loss'], 5) for h in r['hist']]}, step ms "
                    f"{[round(h['ms'], 2) for h in r['hist']]}, median of steps 2 on "
                    if shape == "train_batch" else f"{len(r['ms'])} calls, median ")
            vs = "" if mshape == (1, 1) else (
                f"; against (1, 1): relative {r['err']:.3g}" + (
                    f", step 1's parameters {r['params_err']:.3g}" if "params_err" in r else ""))
            print(f"14d {shape} {mshape} B = {r['rows']}: {what}{r['median_ms']:.3f} ms, "
                  f"{r['rows_per_s']:.1f} rows/s; peak {r['peak']} bytes ({r['resident']} after "
                  f"inputs, {r['base']} before); bound {r['bound'][0]:.4f} ms ({r['bound'][1]})"
                  f"{vs}; {card}", flush=True)
    print(f"14d smoke programs card against CPU on (1, 1) and (2, 4): largest relative "
          f"{x['smoke']:.3g} (tol {RECSYS_TOL['smoke']})", flush=True)
    print(f"14d done in {time.perf_counter() - t0:.1f}s", flush=True)
    launched = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}
    if launched:
        fail(f"phase 14 launched kernels of the k²-triples path: {launched}")
    print(f"14 done in {time.perf_counter() - t_all:.1f}s; none of the nine kernels launched",
          flush=True)
    return {"train_mesh": {k: mid[k] - before[k] for k in before},
            "recsys": {k: ops.LAUNCHES[k] - mid[k] for k in before}}


# ---------------------------------------------------------------------------
# phase 15: the GNN family on one card
# ---------------------------------------------------------------------------

# phase 16: the cells measured on the card whose dry run phase 16 holds against them
DRY_CELLS: dict = {}
# phase 16: a dry run's peak estimate within this factor of the measured footprint
DRY_PEAK_RANGE = (0.5, 2.0)


def _meta_like(x, memo=None, meta_mesh=None):
    """``x`` with every tensor as a ``meta`` tensor of its shape, dtype and
    strides, tensors that share a storage sharing one of its size; a
    ``Sharded`` value laid out on ``meta_mesh`` (a mesh of ``meta`` devices
    of its mesh's shape)."""
    import torch

    from repro_torch.dist.sharding import Sharded

    import dataclasses

    memo = {} if memo is None else memo
    if isinstance(x, torch.Tensor):
        s = x.untyped_storage()
        if s._cdata not in memo:
            memo[s._cdata] = torch.empty(s.nbytes(), dtype=torch.uint8, device="meta")
        base = memo[s._cdata]
        flat = base if x.dtype == torch.uint8 else base[: s.nbytes() - s.nbytes()
                                                        % x.element_size()].view(x.dtype)
        return flat.as_strided(x.shape, x.stride(), x.storage_offset())
    if isinstance(x, Sharded):
        return Sharded(tuple(_meta_like(t, memo) for t in x.parts), meta_mesh, x.spec)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):  # a K2Forest
        return dataclasses.replace(x, **{f.name: _meta_like(getattr(x, f.name), memo, meta_mesh)
                                         for f in dataclasses.fields(x) if f.init})
    if isinstance(x, dict):
        return {k: _meta_like(v, memo, meta_mesh) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_meta_like(v, memo, meta_mesh) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_meta_like(v, memo, meta_mesh) for v in x)
    return x


def note_dry(label: str, fn, args, ms: float, peak: int, base: int, *, args_in_base: bool,
             mesh_shape=None) -> None:
    """Keep a cell measured on the card for phase 16: ``fn`` (built on a
    mesh of ``meta`` devices of ``mesh_shape`` when given, ``fn(mesh)``),
    ``meta`` copies of its arguments, its step ms and its memory:
    ``peak`` (``max_memory_allocated``) and ``base``, the bytes allocated
    before its inputs, or after them (``args_in_base``: its footprint then
    adds its arguments' bytes)."""
    from repro_torch.launch import dryrun

    meta_mesh = None
    if mesh_shape is not None:
        meta_mesh = dryrun.meta_mesh(mesh_shape)
        fn = fn(meta_mesh)
    footprint = peak - base + (dryrun.storage_bytes(args) if args_in_base else 0)
    DRY_CELLS[label] = dict(fn=fn, args=_meta_like(args, meta_mesh=meta_mesh), ms=ms,
                            peak=peak, base=base, footprint=footprint)


GNN_ARCHS = ("mace", "graphcast", "egnn", "equiformer-v2")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
# 15a, a smoke step on the card against the CPU: the card's segment sums add with atomics
# in an order of their own (the CPU tests hold the CPU against the JAX package); GraphCast's
# bf16 states carry the difference through its layers
GNN_SMOKE_TOL = dict(loss=1e-4, grad_norm=1e-3)
GNN_SMOKE_TOL_OF = {"graphcast": dict(loss=2e-2, grad_norm=5e-2)}
GNN_LR = 3e-4  # AdamW's: a first update moves a parameter by at most 2.02·lr either side
GNN_ROT_TOL = 2e-4  # 15a: outputs under a rotation of the positions
GNN_CHUNKS = 3  # 15a: EquiformerV2's chunked attention against one chunk
GNN_CHUNK_TOL = dict(loss=1e-5, grad=1e-4, floor=1e-6)
GNN_STEPS = 3  # 15b: steps a cell; ms is the median of steps 2-3
# 15b: a cut keeps its predicted peak within this share of the card's free memory
GNN_MEMORY = 0.85
# 15b: the one-step probes (layers, graph scale) whose peaks and times size a cell's cut:
# minibatch_lg's graph is fixed, ogb_products' is probed at two scales
GNN_PROBES = {"layers": ((1, 1.0), (2, 1.0)),
              "scale": ((1, 1 / 256), (2, 1 / 256), (1, 1 / 128))}
# 15b: a cut cell's size also keeps its predicted step within this (the script's time limit)
GNN_STEP_MS = 2500  # 4,000 before phases 15c-17
GNN_EST_KINDS = {"full_graph_sm": None, "molecule": None, "minibatch_lg": "layers",
                 "ogb_products": "scale"}


def gnn_bound(flops: float, bf16: bool) -> tuple[float, str]:
    """Least time of a GNN training step: its model flops
    (``programs.gnn_flops``) at the card's rate for the products' dtype,
    989 TFLOP/s bf16 (GraphCast's processor) or 67 TFLOP/s f32."""
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    return flops / peak * 1e3, "operations, bf16" if bf16 else "operations, f32"


def _gnn_step_errs(got, want, params_card, params_cpu) -> dict:
    """Card step against CPU step: loss and grad_norm relative, and the
    largest parameter move apart in units of lr."""
    from repro_torch.tree import leaves

    off = max(float((a.cpu() - b).abs().max()) for (_, a), (_, b) in
              zip(leaves(params_card), leaves(params_cpu)))
    return dict(loss=abs(float(got["loss"]) / float(want["loss"]) - 1),
                grad_norm=abs(float(got["grad_norm"]) / float(want["grad_norm"]) - 1),
                params_lr=off / GNN_LR)


def gnn_smoke_15a(device, seed: int) -> dict:
    """Every arch's smoke program on all four shapes, one step on the card
    against the same step on the CPU from the same ``gnn_inputs``; EGNN,
    MACE and EquiformerV2 under a rotation of the positions on the card;
    EquiformerV2's chunked attention against one chunk on the card."""
    import dataclasses

    import torch

    from repro_torch.launch import programs
    from repro_torch.models.gnn import equiformer_v2 as eq
    from repro_torch.train.trainer import value_and_grad
    from repro_torch.tree import leaves, tree_map

    cpu = torch.device("cpu")
    out = {"steps": {}, "rotation": {}}
    for arch in GNN_ARCHS:
        tol = GNN_SMOKE_TOL_OF.get(arch, GNN_SMOKE_TOL)
        for shape in GNN_SHAPES:
            host = programs.build(arch, shape, _mesh_of(cpu, (1, 1)), smoke=True)
            card = programs.build(arch, shape, _mesh_of(device, (1, 1)), smoke=True)
            params, state, batch = programs.gnn_inputs(host, cpu, seed=seed)
            cp, cs = (tree_map(lambda t: t.to(device, copy=True), x) for x in (params, state))
            _, _, got = card.fn(cp, cs, batch.to(device))
            _, _, want = host.fn(params, state, batch)
            e = _gnn_step_errs(got, want, cp, params)
            if not (e["loss"] <= tol["loss"] and e["grad_norm"] <= tol["grad_norm"]
                    and e["params_lr"] <= 2.02):
                fail(f"15a {arch}:{shape}: card against CPU {e} (tol {tol}, parameters 2.02 lr)")
            out["steps"][(arch, shape)] = dict(e, loss_value=float(got["loss"]))
    rot = torch.tensor([[0.36, 0.48, -0.8], [-0.8, 0.6, 0.0], [0.48, 0.64, 0.6]],
                       device=device)
    for arch in ("egnn", "mace", "equiformer-v2"):
        prog = programs.build(arch, "molecule", _mesh_of(device, (1, 1)), smoke=True)
        params, _, g = programs.gnn_inputs(prog, device, seed=seed)
        mod = programs.GNN_MODULES[arch]
        with torch.no_grad():
            a = mod.forward(prog.cfg, params, g)
            b = mod.forward(prog.cfg, params, g._replace(positions=g.positions @ rot.T))
        err = float((a - b).abs().max() / max(float(a.abs().max()), 1e-30))
        if not err <= GNN_ROT_TOL:
            fail(f"15a {arch}: a rotation of the positions moved the output by {err:.3g} "
                 f"(relative to its largest, tol {GNN_ROT_TOL})")
        out["rotation"][arch] = err
    prog = programs.build("equiformer-v2", "molecule", _mesh_of(device, (1, 1)), smoke=True)
    params, _, g = programs.gnn_inputs(prog, device, seed=seed)
    runs = [value_and_grad(lambda p, b, c=c: eq.loss_fn(
        dataclasses.replace(prog.cfg, edge_chunks=c), p, b), params, g) for c in (1, GNN_CHUNKS)]
    lerr = abs(float(runs[1][0]) / float(runs[0][0]) - 1)
    total = float(torch.sqrt(sum((b.double() ** 2).sum() for _, b in leaves(runs[0][1]))))
    gerr, whole = 0.0, 0.0
    for (path, a), (_, b) in zip(leaves(runs[1][1]), leaves(runs[0][1])):
        err = float((a - b).norm())
        whole = max(whole, err / total)
        if err > GNN_CHUNK_TOL["floor"] * total:  # a leaf zero but for rounding aside
            gerr = max(gerr, err / float(b.norm()))
    if not (lerr <= GNN_CHUNK_TOL["loss"] and gerr <= GNN_CHUNK_TOL["grad"]):
        fail(f"15a equiformer-v2: {GNN_CHUNKS} edge chunks against one: loss {lerr:.3g}, "
             f"gradient leaves {gerr:.3g} (tol {GNN_CHUNK_TOL})")
    out["chunks"] = dict(loss=lerr, grad=gerr, whole=whole)
    return out


def _gnn_run(prog, device, seed: int, graph=None, steps: int = GNN_STEPS,
             profile: bool = False, note: str | None = None) -> dict:
    """``steps`` AdamW steps of a GNN program on one ``gnn_inputs`` batch
    from ``graph``: losses, step ms, the batch's nodes and edges (and the
    real ones: its masks), peak device memory; with ``profile`` one more
    step under the profiler; ``note``: kept for phase 16 under that
    label."""
    import numpy as np
    import torch

    from repro_torch.launch import programs

    base = _peak_reset(device)
    params, state, b = programs.gnn_inputs(prog, device, seed=seed, graph=graph)
    resident = torch.cuda.memory_allocated(device)
    hist = []
    for step in range(steps):
        (_, _, m), secs = _timed(lambda: prog.fn(params, state, b))
        hist.append(dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), ms=secs * 1e3))
        if not all(np.isfinite([hist[-1]["loss"], hist[-1]["grad_norm"]])):
            fail(f"{prog.name}: step {step + 1} gave loss {hist[-1]['loss']}, grad_norm "
                 f"{hist[-1]['grad_norm']}")
    peak = torch.cuda.max_memory_allocated(device)
    median = float(np.median([h["ms"] for h in hist[1:]])) if steps > 1 else hist[0]["ms"]
    if note is not None:
        note_dry(note, prog.fn, (params, state, b), median, peak, base, args_in_base=False)
    prof = _profiled(lambda: prog.fn(params, state, b)) if profile else None
    n, e = b.node_feat.shape[0], b.edge_src.shape[0]
    return dict(hist=hist, median_ms=median, peak=peak, base=base, resident=resident, prof=prof,
                n=n, e=e, real_n=int(b.node_mask.sum()), real_e=int(b.edge_mask.sum()),
                nodes_per_s=n / median * 1e3, edges_per_s=e / median * 1e3)


def _gnn_cell(arch: str, shape: str, device, seed: int, graph, free: int) -> dict:
    """One 15b cell at the full config: its footprint estimate at full size
    and ``GNN_STEPS`` steps, uncut or cut.  A cell's size is its depth L
    and, for ``ogb_products``, its graph's scale s; a small shape runs
    uncut and its footprint is its peak.  Otherwise one-step probes at
    ``GNN_PROBES`` (L, s) fit peak = a + s·(c + L·d) and step ms = t0 +
    L·(g + h·s) (``minibatch_lg``'s graph is fixed: c = h = 0), which give
    the full size's footprint; past ``GNN_MEMORY`` of the free memory the
    cell is cut (``minibatch_lg`` in depth, ``ogb_products`` in scale) to
    the largest size predicted to fit, and then, to keep a step within
    ``GNN_STEP_MS``, in scale and past the smallest probed scale in depth.
    A run out of memory retries at 3/4 of its size."""
    import dataclasses

    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.launch import programs

    spec = ARCHS[arch]
    prog = programs.build(arch, shape, _mesh_of(device, (1, 1)))
    kind = GNN_EST_KINDS[shape]
    dims = spec.shape(shape).dims
    depth = prog.cfg.n_layers

    def at(L, s):
        """(program, graph) at depth ``L`` and graph scale ``s``."""
        p = prog
        if L != depth:
            cut = dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, n_layers=L))
            p = programs.build_gnn(cut, spec.shape(shape), _mesh_of(device, (1, 1)))
        if s == 1.0:
            return p, graph
        return p, programs.gnn_graph(prog, seed=seed, n_nodes=max(1, int(s * dims["n_nodes"])),
                                     n_edges=int(s * dims["n_edges"]))

    def described(L, s):
        out = [f"depth cut to {L} of {depth} layers"] if L != depth else []
        if s != 1.0:
            out.append(f"graph cut to scale {s}: {max(1, int(s * dims['n_nodes']))} nodes x "
                       f"{int(s * dims['n_edges'])} edges (d_feat {dims['d_feat']}, "
                       f"{dims['n_classes']} classes, mean degree and skew kept)")
        return ", ".join(out)

    base = _peak_reset(device)
    budget = base + GNN_MEMORY * free
    L, s, est, cut = depth, 1.0, None, "uncut"
    if kind is not None:
        probes = GNN_PROBES[kind]
        got = []
        for v in probes:
            p, g_ = at(*v)
            r = _gnn_run(p, device, seed, g_, steps=1)
            got.append((r["peak"], round(r["hist"][0]["ms"], 1)))
        (p11, t11), (p21, t21) = got[:2]  # (1, s1) and (2, s1)
        s1 = probes[0][1]
        d = (p21 - p11) / s1
        g_h = t21 - t11  # g + h·s1: a layer's step time at s1
        if kind == "layers":
            c, h, g = 0.0, 0.0, g_h
        else:
            (p12, t12), s2 = got[2], probes[2][1]
            c = (p12 - p11) / (s2 - s1) - d
            h = (t12 - t11) / (s2 - s1)
            g = g_h - h * s1
        a = p11 - s1 * (c + d)
        t0 = t11 - g_h

        def peak(L, s):
            return a + s * (c + L * d)

        def step_ms(L, s):
            return t0 + L * (g + h * s)

        est = peak(depth, 1.0)
        seen = f"probes at (layers, scale) {list(probes)}: peaks {[q[0] for q in got]} bytes, " \
               f"first steps {[q[1] for q in got]} ms"
        if d <= 0:
            fail(f"15b {arch}:{shape}: the probes' peaks do not grow with depth ({seen})")
        if est > budget:
            cut = (f"the full size's footprint estimate {int(est)} bytes is past {GNN_MEMORY} of "
                   f"the card's {free} free bytes")
            if kind == "layers":
                L = max(1, int((budget - a) / d))
            else:
                s = (budget - a) / (c + depth * d)
            if step_ms(L, s) > GNN_STEP_MS:  # the script's time limit
                cut += (f", and a step at the largest size that fits is predicted past "
                        f"{GNN_STEP_MS} ms (the script runs within 1,200 s)")
                if kind == "scale" and step_ms(L, s1) <= GNN_STEP_MS:  # a scale past s1 will do
                    s = min(s, ((GNN_STEP_MS - t0) / L - g) / h) if h > 0 else s
                elif kind == "scale":  # the smallest probed scale, then fewer layers
                    s = min(s, s1)
                if step_ms(L, s) > GNN_STEP_MS and g + h * s > 0:
                    L = max(1, min(L, int((GNN_STEP_MS - t0) / (g + h * s))))
            s = s if s == 1.0 else int(s * 1000) / 1000
            if s <= 0:
                fail(f"15b {arch}:{shape}: no graph scale fits ({seen}, {free} bytes free)")
            cut = f"{described(L, s)}: {cut} ({seen})"
    for attempt in range(4):
        try:
            p, g_ = at(L, s)
            r = _gnn_run(p, device, seed, g_, profile=shape == "minibatch_lg",
                         note=f"15b {arch}:{shape}" if shape == "minibatch_lg" else None)
            break
        except torch.cuda.OutOfMemoryError:
            if kind is None or attempt == 3:
                raise
        if kind == "layers":
            L = max(1, int(L * 0.75))
        else:
            s = int(s * 750) / 1000
        cut = f"{described(L, s)}, out of memory at the predicted size ({cut})"
    r.update(arch=arch, shape=shape, cfg=p.cfg, est=r["peak"] if est is None else est, cut=cut,
             flops=programs.gnn_flops(programs.GNN_MODULES[arch].param_specs(p.cfg), r["n"],
                                      r["e"]))
    r["bound"] = gnn_bound(r["flops"], arch == "graphcast")
    return r


def gnn_full_15b(device, seed: int, card: str) -> tuple[list, object]:
    """Every arch x shape at the full config (16 cells), each shape's host
    graph built once and shared by the four archs (``ogb_products``' cut
    graphs are each arch's own); prints each cell.  -> the rows and the
    ``minibatch_lg`` host graph (15c samples it again)."""
    import torch

    from repro_torch.launch import programs

    graphs = {}
    for shape in ("full_graph_sm", "minibatch_lg", "molecule"):
        t0 = time.perf_counter()
        graphs[shape] = programs.gnn_graph(
            programs.build(GNN_ARCHS[0], shape, _mesh_of(device, (1, 1))), seed=seed)
        if graphs[shape] is not None:
            g = graphs[shape]
            print(f"15b host graph {shape}: {g.n_nodes} nodes, {g.n_edges} edges, "
                  f"{g.feat.shape[1]} features, built in {time.perf_counter() - t0:.1f}s",
                  flush=True)
    graphs["ogb_products"] = None
    rows = []
    for shape in GNN_SHAPES:
        for arch in GNN_ARCHS:
            t0 = time.perf_counter()
            _peak_reset(device)
            free = torch.cuda.mem_get_info(device)[0]
            r = _gnn_cell(arch, shape, device, seed, graphs[shape], free)
            c = r["cfg"]
            real = (f" ({r['real_n']} real nodes, {r['real_e']} real edges)"
                    if (r["real_n"], r["real_e"]) != (r["n"], r["e"]) else "")
            print(f"15b {arch}:{shape} {c.n_layers} layers, d {c.d_hidden}, "
                  f"{r['n']} nodes x {r['e']} edges{real}: {r['cut']}; footprint estimate at "
                  f"full size {int(r['est'])} bytes; losses {[round(h['loss'], 4) for h in r['hist']]}, "
                  f"step ms {[round(h['ms'], 2) for h in r['hist']]}, median of steps 2-"
                  f"{GNN_STEPS} {r['median_ms']:.3f} ms, {r['nodes_per_s']:.1f} nodes/s, "
                  f"{r['edges_per_s']:.1f} edges/s; peak device memory {r['peak']} bytes "
                  f"({r['resident']} after inputs, {r['base']} before); bound "
                  f"{r['bound'][0]:.4f} ms ({r['bound'][1]}; {r['flops']:.4g} model flops); "
                  f"{time.perf_counter() - t0:.1f}s; {card}", flush=True)
            if r["prof"] is not None:
                print(_prof_line(f"15b {arch}:{shape} a step", r["prof"]), flush=True)
            rows.append(r)
    return rows, graphs["minibatch_lg"]


# 15c: the smoke programs on meshes of the card, each against the card's (1, 1) step and
# the same mesh on the CPU (one cell an arch, the CPU tests' first shapes)
GNN_MESHES = ((1, 4), (2, 2), (2, 4))
GNN_MESH_CELLS = (("egnn", "minibatch_lg"), ("graphcast", "full_graph_sm"),
                  ("mace", "molecule"), ("equiformer-v2", "ogb_products"))
GNN_MESH_FULL = (2, 2)  # 15c: each arch's minibatch_lg cell at full width on this mesh
# 15c: depth cuts on GNN_MESH_FULL: one EquiformerV2 layer's recompute peaks at ~60 GB on one
# card (15b's probe) and the mesh adds a whole-graph copy of the states and their gradient
# (one layer on (2, 2) peaked at 70.1 GB; two or three ran out of memory, my chip runs 1-3)
GNN_MESH_DEPTH = {"equiformer-v2": 1}


def gnn_mesh_15c(device, seed: int, rows: list, graph, card: str) -> dict:
    """15c: each arch's smoke program on ``GNN_MESHES`` meshes of the card
    against the card's (1, 1) step and against the mesh on the CPU, from
    the same inputs, by 15a's bounds; then each arch's ``minibatch_lg``
    cell at full width on ``GNN_MESH_FULL`` (at 15b's depth, or
    ``GNN_MESH_DEPTH``'s), ``GNN_STEPS`` steps,
    its ms a step beside 15b's (1, 1) and the bytes its halo gathers and
    summed scatters move a step."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.dist import collectives as col
    from repro_torch.launch import programs
    from repro_torch.tree import leaves, tree_map

    cpu = torch.device("cpu")
    out = {"smoke": {}, "full": {}}
    for arch, shape in GNN_MESH_CELLS:
        tol = GNN_SMOKE_TOL_OF.get(arch, GNN_SMOKE_TOL)
        host = programs.build(arch, shape, _mesh_of(cpu, (1, 1)), smoke=True)
        params, state, batch = programs.gnn_inputs(host, cpu, seed=seed)

        def step(dev, mshape):
            prog = programs.build(arch, shape, _mesh_of(dev, mshape), smoke=True)
            p, st = (tree_map(lambda t: t.to(dev, copy=True), x) for x in (params, state))
            b = batch.to(dev)
            if prog.mesh is not None:
                n, e = programs._gnn_padded(prog.mesh, b.node_feat.shape[0], b.edge_src.shape[0])
                p, st, b = programs.gnn_place_on(prog.mesh, prog.in_shardings,
                                                 (p, st, programs.gnn_pad(b, n, e)))
            new, _, m = prog.fn(p, st, b)
            return m, tree_map(lambda t: t.unshard(cpu) if hasattr(t, "unshard") else t.cpu(),
                               new)

        one, one_p = step(device, (1, 1))
        for mshape in GNN_MESHES:
            got, got_p = step(device, mshape)
            on_cpu, cpu_p = step(cpu, mshape)
            errs = {"(1, 1)": _gnn_step_errs(got, one, got_p, one_p),
                    "cpu": _gnn_step_errs(got, on_cpu, got_p, cpu_p)}
            for against, e in errs.items():
                if not (e["loss"] <= tol["loss"] and e["grad_norm"] <= tol["grad_norm"]
                        and e["params_lr"] <= 2.02):
                    fail(f"15c {arch}:{shape} on {mshape} against {against}: {e} (tol {tol}, "
                         f"parameters 2.02 lr)")
            out["smoke"][arch, mshape] = errs
            print(f"15c {arch}:{shape} smoke on {mshape}: against the card's (1, 1) step "
                  f"{ {k: float(f'{v:.3g}') for k, v in errs['(1, 1)'].items()} }, against the "
                  f"mesh on the CPU { {k: float(f'{v:.3g}') for k, v in errs['cpu'].items()} } "
                  f"(tol {tol}, parameters 2.02 lr)", flush=True)

    single = {r["arch"]: r for r in rows if r["shape"] == "minibatch_lg"}
    for arch in GNN_ARCHS:
        spec = ARCHS[arch]
        L = GNN_MESH_DEPTH.get(arch, single[arch]["cfg"].n_layers)
        note = "" if L == spec.cfg.n_layers else f", depth cut to {L} of {spec.cfg.n_layers}"
        cut = dataclasses.replace(spec, cfg=dataclasses.replace(spec.cfg, n_layers=L))
        prog = programs.build_gnn(cut, spec.shape("minibatch_lg"), _mesh_of(device, GNN_MESH_FULL))
        base = _peak_reset(device)
        params, state, b = programs.gnn_inputs(prog, device, seed=seed, graph=graph)
        hist, wire = [], []
        for _ in range(GNN_STEPS):
            col.reset_wire()
            m, secs = _timed(lambda: prog.fn(params, state, b)[2])
            wire.append(dict(col.GRAPH_WIRE))
            hist.append(dict(loss=float(m["loss"]), ms=secs * 1e3))
        peak = torch.cuda.max_memory_allocated(device)
        if not all(np.isfinite([h["loss"] for h in hist])):
            fail(f"15c {arch}:minibatch_lg on {GNN_MESH_FULL}: losses {hist}")
        median = float(np.median([h["ms"] for h in hist[1:]]))
        r = dict(median_ms=median, single_ms=single[arch]["median_ms"], wire=wire[-1],
                 peak=peak, base=base, layers=L)
        out["full"][arch] = r
        del params, state, b
        gc.collect()  # what the mesh step left in reference cycles
        print(f"15c {arch}:minibatch_lg at full width on {GNN_MESH_FULL}{note}: "
              f"{prog.in_specs[2].node_feat.shape[0]} nodes x "
              f"{prog.in_specs[2].edge_src.shape[0]} edges, losses "
              f"{[round(h['loss'], 4) for h in hist]}, step ms {[round(h['ms'], 2) for h in hist]}, "
              f"median of steps 2-{GNN_STEPS} {median:.3f} ms against 15b's (1, 1) "
              f"{single[arch]['median_ms']:.3f} ms ({single[arch]['cfg'].n_layers} layers); a step's "
              f"halo {wire[-1]['halo']:.6g} bytes, summed scatter {wire[-1]['scatter']:.6g} bytes "
              f"(ring bytes over the mesh's positions, both directions); peak device memory "
              f"{peak} bytes ({base} before); {card}", flush=True)
    return out


def dryrun_phase(card: str) -> dict:
    """Phase 16: the dry run (``launch/dryrun.py``) of each cell kept by
    ``note_dry``, on ``meta`` copies of the inputs it was measured on:
    flops (by dtype), bytes, the collectives' wire bytes by kind, the three
    H100 roofline terms and the peak estimate, beside the measured ms and
    memory; fails unless each estimate lies within ``DRY_PEAK_RANGE`` of
    the measured footprint (``max_memory_allocated`` less the bytes held
    before the cell's inputs)."""
    from repro_torch.launch import dryrun, roofline

    out = {}
    for label, c in DRY_CELLS.items():
        t0 = time.perf_counter()
        got = dryrun.measure(c["fn"], c["args"])
        # the footprint is the whole mesh's on one card: the dry run's whole-mesh peak
        r = roofline.analyze(label, "1x1", 1, got["cost"], got["wire"], 0.0, got["mesh_peak"])
        ratio = got["mesh_peak"] / c["footprint"]
        out[label] = dict(r.to_dict(), ratio=ratio, ms=c["ms"])
        print(f"16 {label}: {got['cost'].flops:.6g} flops (bf16 products "
              f"{got['cost'].flops_bf16:.6g}, f32 products {got['cost'].flops_f32:.6g}, other "
              f"{got['cost'].flops_other:.6g}), {got['cost'].bytes_naive:.6g} bytes; analytic H100 "
              f"SXM bounds: compute {r.t_compute * 1e3:.4f} ms, memory {r.t_memory * 1e3:.4f} ms, "
              f"collective {r.t_collective * 1e3:.4f} ms ({r.bottleneck}); wire bytes "
              f"{_wire_text(r.coll_detail)}; peak estimate "
              f"{got['mesh_peak']} bytes against the measured footprint {c['footprint']} bytes "
              f"(max_memory_allocated {c['peak']}, {c['base']} before; ratio {ratio:.3f}); "
              f"measured {c['ms']:.3f} ms a step; dry run {time.perf_counter() - t0:.1f}s; {card}",
              flush=True)
        lo, hi = DRY_PEAK_RANGE
        if not lo <= ratio <= hi:
            fail(f"16 {label}: the peak estimate {got['mesh_peak']} bytes is {ratio:.3f} x the "
                 f"measured "
                 f"{c['footprint']} (want {lo}-{hi})")
    for name in ("10b", "12b", "14d", "15b"):
        if not any(k.startswith(name) for k in out):
            fail(f"16: no {name} cell was measured")
    out["seq_sp"] = dry_layouts(card)
    return out


DRY_LAYOUT_CELL = ("tinyllama-1.1b", "train_4k", (2, 4))  # 16: the full config, both layouts
# 16: the largest share by which the two layouts' collective terms may differ (ring bytes are
# equal but for seq_sp's embedding all-gather)
DRY_LAYOUT_COLLECTIVE_GAP = 0.10


def _wire_text(detail: dict) -> str:
    """A record's ``coll_detail`` (bytes a device by kind) as text."""
    return ", ".join(f"{k} {v:.6g}" for k, v in detail.items())


def dry_layouts(card: str) -> dict:
    """16: the dry run of ``DRY_LAYOUT_CELL`` at its full config under the
    sequence-parallel residual stream and with it whole (``"seq_sp"`` ->
    None): per-device and whole-mesh peaks, the collective term and the
    wire bytes by kind; fails unless ``seq_sp``'s per-device peak is the
    lower and the two collective terms lie within
    ``DRY_LAYOUT_COLLECTIVE_GAP`` of each other."""
    import multiprocessing as mp
    import tempfile
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch.launch import dryrun

    arch, shape, ms = DRY_LAYOUT_CELL
    layouts = (("seq_sp", None), ("whole", {"seq_sp": None}))
    with tempfile.TemporaryDirectory() as tmp, ProcessPoolExecutor(
            len(layouts), mp_context=mp.get_context("spawn")) as pool:  # both at once
        got = pool.map(dryrun._run_one, [(arch, shape, ms, tmp, True, False, rules)
                                         for _, rules in layouts])
        recs = {name: rec for (name, _), rec in zip(layouts, got)}
    for name, rec in recs.items():
        if not rec["ok"]:
            fail(f"16 {arch}:{shape} {ms} {name}: {rec.get('error')}")
        rec["seconds"] = rec["t_build_s"] + rec["t_run_s"]
    sp, whole = recs["seq_sp"], recs["whole"]
    print(f"16 {arch}:{shape} full config on a {ms} meta mesh, per-device peak (the largest "
          f"position's, as the JAX record's): seq_sp {sp['peak_mem_bytes']} bytes, residual whole "
          f"{whole['peak_mem_bytes']} bytes ({whole['peak_mem_bytes'] - sp['peak_mem_bytes']} "
          f"lower under seq_sp); the whole mesh's {sp['mesh_peak_mem_bytes']} / "
          f"{whole['mesh_peak_mem_bytes']}; collective term {sp['t_collective'] * 1e3:.2f} / "
          f"{whole['t_collective'] * 1e3:.2f} ms (analytic H100 SXM); wire bytes a device "
          f"seq_sp {_wire_text(sp['coll_detail'])} / whole {_wire_text(whole['coll_detail'])}; "
          f"dry runs {sp['seconds']:.1f} / {whole['seconds']:.1f} s; {card}", flush=True)
    if not sp["peak_mem_bytes"] < whole["peak_mem_bytes"]:
        fail(f"16 {arch}:{shape} {ms}: the per-device peak under seq_sp "
             f"({sp['peak_mem_bytes']}) is not below the whole residual's "
             f"({whole['peak_mem_bytes']})")
    gap = abs(sp["t_collective"] / whole["t_collective"] - 1)
    if not gap <= DRY_LAYOUT_COLLECTIVE_GAP:
        fail(f"16 {arch}:{shape} {ms}: the collective terms differ by {gap:.3f} "
             f"(seq_sp {sp['t_collective']}, whole {whole['t_collective']} s; want at most "
             f"{DRY_LAYOUT_COLLECTIVE_GAP})")
    return recs


# phase 17: the examples on the card, each a process of its own (small sizes)
EXAMPLES = {
    "torch_quickstart": [],
    "torch_serve_sparql": ["--fast"],
    "torch_train_lm": ["--steps", "20", "--ckpt-dir", "build/examples/torch_train_lm"],
    "torch_gnn_molecules": ["--steps", "20", "--ckpt-dir", "build/examples/torch_gnn_molecules"],
}


def examples_phase(card: str) -> dict:
    """Phase 17: the four ``examples/torch_*.py`` on the card at small sizes,
    run side by side as processes; fails unless each exits 0."""
    import shutil

    shutil.rmtree(ROOT / "build" / "examples", ignore_errors=True)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, str(ROOT / "examples" / f"{name}.py"), *argv],
                                    cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name, argv in EXAMPLES.items()}
    out = {}
    for name, proc in procs.items():
        try:
            so, se = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            so, se = proc.communicate()
        tail = so.strip().splitlines()[-2:]
        out[name] = proc.returncode
        print(f"17 {name} {' '.join(EXAMPLES[name])}: exit {proc.returncode}; {tail}", flush=True)
        if proc.returncode != 0:
            fail(f"17 {name} exited {proc.returncode}: {se[-2000:]}")
    print(f"17 done in {time.perf_counter() - t0:.1f}s; {card}", flush=True)
    return out


def gnn_phase(device, seed: int) -> dict:
    """Phase 15; fails unless every check holds and none of the nine
    kernels launched.  -> the nine kernels' launches (``gnn``), all 0."""
    from repro_torch.kernels import ops

    t_all = time.perf_counter()
    before = dict(ops.LAUNCHES)
    card = gpu_line()
    phase("15a. the GNN smoke programs, card against CPU")
    t0 = time.perf_counter()
    s = gnn_smoke_15a(device, seed)
    for (arch, shape), e in s["steps"].items():
        print(f"15a {arch}:{shape} one step, card against CPU: loss {e['loss']:.3g}, grad_norm "
              f"{e['grad_norm']:.3g} relative, parameters {e['params_lr']:.3g} lr apart (loss "
              f"{e['loss_value']:.5g}; tol {GNN_SMOKE_TOL_OF.get(arch, GNN_SMOKE_TOL)}, 2.02 lr)",
              flush=True)
    print(f"15a rotation of the positions on the card, largest output change relative: "
          f"{ {k: float(f'{v:.3g}') for k, v in s['rotation'].items()} } (tol {GNN_ROT_TOL}); "
          f"equiformer-v2 {GNN_CHUNKS} edge chunks against one on the card: loss "
          f"{s['chunks']['loss']:.3g}, gradient leaves past the floor {s['chunks']['grad']:.3g} "
          f"relative L2, the largest leaf difference {s['chunks']['whole']:.3g} of the whole "
          f"gradient's norm (tol {GNN_CHUNK_TOL})", flush=True)
    print(f"15a done in {time.perf_counter() - t0:.1f}s", flush=True)

    phase("15b. the GNN family at full width on one card, every arch x shape")
    t0 = time.perf_counter()
    rows, graph = gnn_full_15b(device, seed, card)
    print(f"15b done in {time.perf_counter() - t0:.1f}s", flush=True)

    phase("15c. the GNN programs on meshes of the card")
    t0 = time.perf_counter()
    gnn_mesh_15c(device, seed, rows, graph, card)
    del graph  # ~1.5 GB on the host
    print(f"15c done in {time.perf_counter() - t0:.1f}s", flush=True)
    launched = {k: v - before[k] for k, v in ops.LAUNCHES.items() if v != before[k]}
    if launched:
        fail(f"phase 15 launched kernels of the k²-triples path: {launched}")
    print(f"15 done in {time.perf_counter() - t_all:.1f}s; none of the nine kernels launched",
          flush=True)
    return {k: ops.LAUNCHES[k] - before[k] for k in before}


def _errs(e: dict) -> str:
    return f"({e['loss']:.3g}, {e['grad_norm']:.3g}, {e['state']:.3g}, {e['params']:.3g})"


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--triples", type=int, default=GEONAMES_TRIPLES,
                    help="geonames-like corpus size (default: the paper's full size)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write phase 5c's traced broker run as Chrome trace JSON")
    ap.add_argument("--string-triples", type=int, default=STRING_TRIPLES,
                    help="phase 8c's string corpus size")
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
    stats, answers, wall, _ = serve.serve_trace(
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
    print(f"join host/device split (ms): {json.dumps(join_split(engine, work, device))}",
          flush=True)

    phase("5c. the SELECT/BGP path over the geonames store")
    s_work = select_work(ds, oracle, args.seed + 4)
    rec_s = Recorder()
    t0 = time.perf_counter()
    with rec_s:
        run_work(engine, s_work)
    torch.cuda.synchronize()
    for name in QUERY_KERNELS:
        err[name] = max(err[name], rec_s.err[name])
    print(f"kernel checks on the SELECT inputs: "
          f"{ {k: len(v) for k, v in rec_s.calls.items()} } calls, max_abs_err {rec_s.err} "
          f"({time.perf_counter() - t0:.1f}s)", flush=True)
    if any(err[k] for k in QUERY_KERNELS):
        fail(f"kernels disagree with their plain versions: {err}")
    ops.reset_launches()
    t0 = time.perf_counter()
    s_results = run_work(engine, s_work)
    torch.cuda.synchronize()
    s_launches = dict(ops.LAUNCHES)
    s_wall = time.perf_counter() - t0
    s_lat, s_nonempty = check_select_work(s_work, s_results, oracle)
    print(f"SELECT/BGP path: {len(s_work)} plan calls in {s_wall:.3f}s; launches {s_launches}; "
          f"every answer equals the numpy evaluation", flush=True)
    for label in SELECT_SHAPES:
        secs = s_lat[label]
        print(f"latency {label}: {len(secs)} queries, median {1e3 * np.median(secs):.3f} ms, "
              f"max {1e3 * max(secs):.3f} ms per query, {s_nonempty[label]} non-empty", flush=True)
        if not s_nonempty[label]:
            fail(f"every {label} answer is empty: the workload exercises nothing")
    if not all(s_launches[k] > 0 for k in ("k2_scan", "k2_check", "k2_range")):
        fail(f"a kernel of the SELECT path never launched: {s_launches}")
    print(f"SELECT host split, one query a shape (ms): {json.dumps(select_split(engine, s_work))}",
          flush=True)
    serve_obs_phase(engine, ds, oracle, n_queries, n_tenants, cap, max_batch, args.seed + 1,
                    wall, args.trace_out)

    phase("6. kernel times at the main-path shapes")
    rows = []
    for name in QUERY_KERNELS:
        best, shapes, seen = None, {}, set()
        for cargs, kw, out in main_path_shapes(name, rec, rec_q, rec_s):
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
            launches=launches[name] + q_launches[name] + s_launches[name],
            launches_by_path={"serve": launches[name], "patterns_joins": q_launches[name],
                              "select": s_launches[name]},
            max_abs_err=err[name], ms=times["ms"], plain_ms=times["plain_ms"],
            bound_ms=times["bound_ms"], bound_by=times["bound_by"], library_ms=None,
            shapes=shapes, path_ms=path_ms(name, rec, rec_q, rec_s),
        ))
        print(f"{name}: device ms summed over each path's recorded calls {rows[-1]['path_ms']}",
              flush=True)
    print(f"launch floor: {json.dumps(launch_floor(build, device))}", flush=True)

    phase("7. kernel entry points at store scale")
    rows += entry_point_phase(store, ds, rec_q.intersects, device, args.seed, err)

    dyn_launches = dynamic_phase(store, ds, oracle, device, n_tenants, args)
    for row in rows:
        name = row["name"]
        row["launches_by_path"] = dict(row.get("launches_by_path", {}),
                                       dynamic=dyn_launches["launches"][name])
        row["launches"] += dyn_launches["launches"][name]
        row["max_abs_err"] = max(row["max_abs_err"], dyn_launches["err"].get(name, 0))

    shard = sharded_phase(engine, ds, oracle, trace, work, device, n_tenants, cap, max_batch,
                          args.seed + 9)
    for row in rows:
        name = row["name"]
        row["launches_by_path"].update(sharded=shard["sharded"][name],
                                       functional=shard["functional"][name])
        row["launches"] += shard["sharded"][name] + shard["functional"][name]
        row["max_abs_err"] = max(row["max_abs_err"], shard["err"].get(name, 0))

    reg = registry_phase(device, args.seed + 10)
    for row in rows:
        name = row["name"]
        row["launches_by_path"].update(tree=reg["tree"][name], registry=reg["registry"][name])
        row["launches"] += reg["tree"][name] + reg["registry"][name]
        row["max_abs_err"] = max(row["max_abs_err"], reg["err"].get(name, 0))
    for label, (name, times) in reg["times"].items():
        next(row for row in rows if row["name"] == name)["shapes"][label] = times
    lm_phase(device, args.seed + 11)
    train = train_phase(device, args.seed + 12)
    lm_mesh = mesh_phase(device, args.seed + 13)
    mesh_train = train_mesh_phase(device, args.seed + 14, train["dense"])
    # phase 15 sizes its cuts by the free memory: let the geonames store, its plans and the
    # recorded kernel calls go (~8 GB of the card), as phases 11-14 ran beside them
    del engine, plan, store, f, pm, rec, rec_q, rec_s, results, s_results
    gc.collect()
    torch.cuda.empty_cache()
    gnn = gnn_phase(device, args.seed + 15)
    phase("16. the dry run of the measured cells on the card's host")
    t0 = time.perf_counter()
    dryrun_phase(gpu_line())
    print(f"16 done in {time.perf_counter() - t0:.1f}s", flush=True)
    phase("17. the examples on the card")
    examples_phase(gpu_line())
    for row in rows:
        name = row["name"]
        row["launches_by_path"].update(train=train["launches"][name], lm_mesh=lm_mesh[name],
                                       train_mesh=mesh_train["train_mesh"][name],
                                       recsys=mesh_train["recsys"][name], gnn=gnn[name])
        row["launches"] += (train["launches"][name] + lm_mesh[name]
                            + mesh_train["train_mesh"][name] + mesh_train["recsys"][name]
                            + gnn[name])
    print(json.dumps({"kernels": rows}), flush=True)
    print(gpu_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
