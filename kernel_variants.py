#!/usr/bin/env python3
"""Time design variants of ``sorted_intersect_mask`` and the fixed-layout
``pred_gather`` side by side on one NVIDIA card.

    python3 kernel_variants.py --parent-csrc DIR [--triples 9415253] [--seed 0] [--out FILE]

Each variant is a CUDA source built with ``build.nvcc()`` and
``build.NVCC_FLAGS`` (all in parallel) into ``build/variants/`` and called
through ctypes:

- the kernels of ``src/repro_torch/kernels/csrc``, launched as
  ``kernels.ops`` launches them, and copies of them with one constant set
  otherwise (``sorted_intersect.cu``: splitters a round, sample ids a
  thread, copy loads in flight; ``pred_gather.cu``: threads a block) and,
  for ``sorted_intersect_mask``, with other launch plans (kernel, tile
  lanes, window);
- the earlier design of each from ``--parent-csrc`` (the ``csrc`` directory
  of a checkout from before the kernels took a launch plan): one thread a
  lane, one thread a slot;
- ``pred_gather`` at one warp a row and at one thread a row, the two
  designs measured against the kept one (``WARP_A_ROW`` and ``THREAD_A_ROW``
  below; the product builds neither).

The inputs are ``chip_smoke.py``'s: for ``sorted_intersect_mask`` its phase
7 bench, store and fallback cases and a join-sized 1024 in 1024; for
``pred_gather`` the geonames fixed-layout index at Q=256 and Q=1, cap its
largest degree.  Every variant's output must equal the plain version's.
Each is timed with ``chip_smoke.time_ms`` twice, in the order first..last,
then last..first; both times are printed and written to ``--out``
(``build/variants/kernel_variants.json`` by default).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

import chip_smoke  # puts src/ on sys.path

import numpy as np
import torch

from repro_torch.core import predindex
from repro_torch.data import rdf
from repro_torch.kernels import build, ops, ref

OUT_DIR = build.BUILD_DIR.parent / "variants"

# pred_gather, one thread a row: the row's entries in a loop (the C
# interface of the earlier one-thread-a-slot kernel)
THREAD_A_ROW = r"""
#include "k2_common.cuh"
__global__ void pred_gather_row_kernel(
    const int* __restrict__ rows, int Q, const int* __restrict__ offsets, int n_offsets,
    const unsigned* __restrict__ words, int n_words, int bpp, int cap,
    int* __restrict__ ids, bool* __restrict__ valid, int* __restrict__ count,
    bool* __restrict__ overflow) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const int row = clampi(rows[q], 0, n_offsets - 2);
  const int start = offsets[row];
  const int deg = wsub(offsets[row + 1], start);
  const int n = deg < cap ? deg : cap;
  const unsigned mask = bpp == 4 ? 0xFFFFFFFFu : (1u << (8 * bpp)) - 1u;
  for (int j = 0; j < cap; ++j) {
    const bool live = j < n;
    const int bidx = wmul(live ? wadd(start, j) : 0, bpp);
    const unsigned w = live ? words[clampi(bidx >> 2, 0, n_words - 1)] : 0u;
    ids[(size_t)q * cap + j] = live ? (int)((w >> (unsigned)((bidx & 3) * 8)) & mask) : 0;
    valid[(size_t)q * cap + j] = live;
  }
  count[q] = n;
  overflow[q] = deg > cap;
}
extern "C" int pred_gather_launch(
    const void* rows, int Q, const void* offsets, int n_offsets, const void* words,
    int n_words, int bpp, int cap, void* ids, void* valid, void* count, void* overflow,
    void* stream, int device) {
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  pred_gather_row_kernel<<<(Q + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
      (const int*)rows, Q, (const int*)offsets, n_offsets, (const unsigned*)words, n_words,
      bpp, cap, (int*)ids, (bool*)valid, (int*)count, (bool*)overflow);
  return (int)cudaGetLastError();
}
"""

# pred_gather, one warp a row: threads 0 and 1 load
# the two offsets, a warp's threads a chunk's words, slots take theirs by a
# shuffle; 1-32 warps a block, the grid from the caller
WARP_A_ROW = r"""
#include "k2_common.cuh"

#define PG_FULL 0xffffffffu
#define PG_MAX_THREADS 1024

__global__ void __launch_bounds__(PG_MAX_THREADS) pred_gather_warp_kernel(
    const int* __restrict__ rows, int Q, const int* __restrict__ offsets,
    int n_offsets, const unsigned* __restrict__ words, int n_words, int bpp,
    int cap, int* __restrict__ ids, bool* __restrict__ valid,
    int* __restrict__ count, bool* __restrict__ overflow) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= Q) return;  // warp-uniform
  const int row = clampi(rows[q], 0, n_offsets - 2);
  const int off = lane < 2 ? offsets[row + lane] : 0;
  const int start = __shfl_sync(PG_FULL, off, 0);
  const int deg = wsub(__shfl_sync(PG_FULL, off, 1), start);
  const int n = deg < cap ? deg : cap;
  const unsigned mask = bpp == 4 ? 0xFFFFFFFFu : (1u << (8 * bpp)) - 1u;

  int* out_ids = ids + (size_t)q * cap;
  bool* out_valid = valid + (size_t)q * cap;
  for (int j0 = 0; j0 < cap; j0 += 32) {
    const int j = j0 + lane;
    const bool live = j < n;
    int pred = 0;
    if (j0 < n) {  // warp-uniform; slot j0 is live
      const int bidx = wmul(live ? wadd(start, j) : 0, bpp);
      const int widx = clampi(bidx >> 2, 0, n_words - 1);
      // the words of the chunk's first and last live slot
      const int first = clampi(wmul(wadd(start, j0), bpp) >> 2, 0, n_words - 1);
      const int last = wadd(start, j0 + min(n - j0, 32) - 1);
      const int span = clampi(wmul(last, bpp) >> 2, 0, n_words - 1) - first;
      unsigned w = 0;
      if (span >= 0 && span < 32) {  // warp-uniform
        const unsigned held = lane <= span ? words[first + lane] : 0u;
        const int src = widx - first;
        w = __shfl_sync(PG_FULL, held, src & 31);
        if (live && (src < 0 || src > span)) w = words[widx];
      } else if (live) {
        w = words[widx];
      }
      pred = live ? (int)((w >> (unsigned)((bidx & 3) * 8)) & mask) : 0;
    }
    if (j < cap) {
      out_ids[j] = pred;
      out_valid[j] = live;
    }
  }
  if (lane == 0) {
    count[q] = n;
    overflow[q] = deg > cap;
  }
}

extern "C" int pred_gather_launch(
    const void* rows, int Q, const void* offsets, int n_offsets,
    const void* words, int n_words, int bytes_per_pred, int cap, int blocks,
    int threads, void* ids, void* valid, void* count, void* overflow,
    void* stream, int device) {
  if (cap < 1 || Q < 1 || n_offsets < 2 || n_words < 1 || blocks < 1 ||
      threads < 32 || threads > PG_MAX_THREADS || threads % 32 ||
      (long long)blocks * (threads / 32) < Q ||
      !(bytes_per_pred == 1 || bytes_per_pred == 2 || bytes_per_pred == 4))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  pred_gather_warp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)rows, Q, (const int*)offsets, n_offsets,
      (const unsigned*)words, n_words, bytes_per_pred, cap, (int*)ids,
      (bool*)valid, (int*)count, (bool*)overflow);
  return (int)cudaGetLastError();
}
"""

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C interfaces without a launch plan (earlier kernels, one thread a row)
# and of the warp-a-row pred_gather (a grid from the caller)
_SI_NO_PLAN = [_P, _I, _P, _I, _P, _P, _I]
_PG_NO_PLAN = [_P, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I]
_PG_GRID = [_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I]


def _source(name: str, text: str) -> Path:
    """``text`` as ``build/variants/<name>.cu``."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"{name}.cu"
    path.write_text(text)
    return path


def _with(src: Path, pattern: str, repl: str) -> str:
    """The text of ``src`` with the one match of ``pattern`` replaced."""
    text, n = re.subn(pattern, repl, src.read_text())
    if n != 1:
        raise SystemExit(f"{src.name}: {pattern!r} matched {n} times, not once")
    return text


def _compile(sources: dict) -> dict:
    """``{key: source path}`` -> ``{key: CDLL}``, one nvcc each, all at once."""
    procs = {}
    for key, src in sources.items():
        lib = OUT_DIR / f"{src.stem}-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
        cmd = [build.nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", "-o", str(lib), str(src)]
        procs[key] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        regs = [ln.split("info    : ")[-1] for ln in log.splitlines() if "registers" in ln]
        print(f"ptxas {key}: {'; '.join(regs)}", flush=True)
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def _fn(lib, symbol: str, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def _caller(fn, args, dev):
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        err = fn(*args, stream, dev.index)
        if err:
            raise RuntimeError(f"variant launch failed: CUDA error {err}")

    return call


def _lanes(ca: int, cb: int) -> tuple:
    """The launch plan of a thread a lane (kernel 1)."""
    return 1, 256, -(-ca // 256), 0


def _tiles(ca: int, cb: int, threads: int = 256, window: int = ops.INTERSECT_WINDOW) -> tuple:
    """The launch plan of tiles of 4 * ``threads`` lanes (kernel 0)."""
    return 0, threads, -(-ca // (4 * threads)), min(cb, window)


INTERSECT_PLANS = {
    "a thread a lane": _lanes,
    "tiles": _tiles,
    "tiles of 512 lanes": lambda ca, cb: _tiles(ca, cb, threads=128),
    "tiles, window 2048": lambda ca, cb: _tiles(ca, cb, window=2048),
    "tiles, window 8192": lambda ca, cb: _tiles(ca, cb, window=8192),
}
# copies of csrc/sorted_intersect.cu with one constant set otherwise
INTERSECT_CONSTANTS = {
    "lane sample 2 a thread": ("SI_LANE_SAMPLE_PER_THREAD", 2),
    "lane sample 4 a thread": ("SI_LANE_SAMPLE_PER_THREAD", 4),
    "tile splitters 63": ("SI_SPLIT_LOG", 6),
    "tile sample 2 a thread": ("SI_SAMPLE_PER_THREAD", 2),
    "tile sample 4 a thread": ("SI_SAMPLE_PER_THREAD", 4),
    "tile copy batch 2": ("SI_COPY_BATCH", 2),
    "tile copy batch 4": ("SI_COPY_BATCH", 4),
}
GATHER_THREADS = (128, 512, 1024)  # csrc/pred_gather.cu's block, set otherwise


def intersect_cases(ds, seed: int, dev) -> dict:
    """``chip_smoke.py`` phase 7's bench, store and fallback inputs (the same
    draws), and a join-sized 1024 in 1024 (300 and 500 ids, 100 shared)."""
    rng = np.random.default_rng(seed)
    cases = {}
    a = np.sort(rng.choice(10**7, 2**16, replace=False)).astype(np.int32)
    b = np.sort(rng.choice(10**7, 2**18, replace=False)).astype(np.int32)
    cases["bench 2^16 in 2^18"] = (a, b)
    p1, p2 = np.argsort(-np.bincount(ds.ids[:, 1]), kind="stable")[:2]
    a, b = (np.unique(ds.ids[ds.ids[:, 1] == p, 0]) - 1 for p in (p1, p2))
    cases[f"store {a.size} in {b.size}"] = (a, b)
    b = np.sort(rng.choice(10**8, 2**20, replace=False)).astype(np.int32)
    a = np.sort(np.concatenate([rng.choice(b, 1024, replace=False),
                                rng.integers(0, 10**8, 1024)])).astype(np.int32)
    cases["fallback 2048 over 2^20"] = (a, b)
    ids = rng.choice(ds.n_subjects, 700, replace=False)
    cases["join-sized 1024 in 1024"] = (np.sort(ids[:300]), np.sort(ids[200:]))
    return {k: tuple(chip_smoke.padded_ids(x, dev, 1024 if k.startswith("join") else 2048)
                     for x in (a, b)) for k, (a, b) in cases.items()}


def _time_all(calls: dict) -> dict:
    """``{variant: call}`` -> ``{variant: [ms, ms]}``, in order and reversed."""
    out = {k: [] for k in calls}
    for key in list(calls) + list(reversed(calls)):
        fn = calls[key]
        out[key].append(chip_smoke.time_ms(fn, chip_smoke.iters_for(fn, 300.0, 50)))
    return out


def _check_all(calls: dict, outs: dict, want: tuple, what: str) -> None:
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(outs[name], want)):
            raise SystemExit(f"{what}: {name} disagrees with the plain version")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-csrc", type=Path, required=True)
    ap.add_argument("--triples", type=int, default=9_415_253)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=OUT_DIR / "kernel_variants.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants needs an NVIDIA card")
    dev = chip_smoke.cuda_device()
    sms = ops._sm_count(dev)
    si_kept, pg_kept = build.CSRC / "sorted_intersect.cu", build.CSRC / "pred_gather.cu"
    sources = {"si kept": si_kept, "si parent": args.parent_csrc / "sorted_intersect.cu",
               "pg kept": pg_kept, "pg parent": args.parent_csrc / "pred_gather.cu",
               "pg warp a row": _source("pred_gather_warp_row", WARP_A_ROW),
               "pg thread a row": _source("pred_gather_thread_row", THREAD_A_ROW)}
    for name, (const, value) in INTERSECT_CONSTANTS.items():
        sources[f"si {name}"] = _source(
            f"sorted_intersect_{const}_{value}",
            _with(si_kept, rf"#define {const} \d+", f"#define {const} {value}"))
    for t in GATHER_THREADS:
        sources[f"pg {t} threads"] = _source(
            f"pred_gather_{t}_threads",
            _with(pg_kept, r"const int threads = 256;", f"const int threads = {t};"))
    libs = _compile(sources)
    card = chip_smoke.gpu_line()
    print(f"card: {card}", flush=True)
    result = {"card": card, "launch_floor": chip_smoke.launch_floor(build, dev),
              "sorted_intersect_mask": {}, "pred_gather": {}}
    print(f"launch floor: {result['launch_floor']}", flush=True)

    ds = rdf.generate_like("geonames", args.triples, seed=args.seed)
    kept_si = ops._SIGNATURES["sorted_intersect_mask"][1]
    for case, (a, b) in intersect_cases(ds, args.seed, dev).items():
        want = ref.sorted_intersect_mask_ref(a, b)
        ca, cb = a.numel(), b.numel()
        variants = {"parent: a thread a lane": (libs["si parent"], _SI_NO_PLAN, ()),
                    "kept": (libs["si kept"], kept_si, ops._intersect_plan(ca, cb, sms))}
        variants.update({name: (libs[f"si {name}"], kept_si, ops._intersect_plan(ca, cb, sms))
                         for name in INTERSECT_CONSTANTS})
        variants.update({name: (libs["si kept"], kept_si, plan(ca, cb))
                         for name, plan in INTERSECT_PLANS.items()})
        calls, outs = {}, {}
        for name, (lib, sig, plan) in variants.items():
            outs[name] = (torch.empty_like(want),)
            calls[name] = _caller(_fn(lib, "sorted_intersect_launch", sig),
                                  (a.data_ptr(), ca, b.data_ptr(), cb, outs[name][0].data_ptr(),
                                   *plan), dev)
        _check_all(calls, outs, (want,), f"sorted_intersect_mask {case}")
        times = _time_all(calls)
        result["sorted_intersect_mask"][case] = times
        for name, t in times.items():
            print(f"sorted_intersect_mask {case}: {name}: {t[0]:.5f} / {t[1]:.5f} ms", flush=True)

    index, pm = predindex.build(ds.ids, n_subjects=ds.n_subjects, n_objects=ds.n_objects,
                                n_preds=ds.n_preds, device=dev).select("fixed")
    rng = np.random.default_rng(args.seed + 3)
    subjects = ds.ids[rng.integers(0, ds.n_triples, 256), 0] - 1
    cap = pm.max_degree
    for q in (256, 1):
        rows = torch.from_numpy(subjects[:q].astype(np.int32)).to(dev)
        want = ref.pred_gather_ref(rows, index.offsets, index.words,
                                   bytes_per_pred=pm.bytes_per_pred, cap=cap)
        head = (rows.data_ptr(), q, index.offsets.data_ptr(), index.offsets.shape[0],
                index.words.data_ptr(), index.words.shape[0], pm.bytes_per_pred, cap)
        variants = {
            "parent: a thread a slot": (libs["pg parent"], _PG_NO_PLAN, ()),
            "kept: a thread a slot, 256 a block": (libs["pg kept"], _PG_NO_PLAN, ()),
            **{f"a thread a slot, {t} a block": (libs[f"pg {t} threads"], _PG_NO_PLAN, ())
               for t in GATHER_THREADS},
            "a thread a row": (libs["pg thread a row"], _PG_NO_PLAN, ()),
            "a warp a row": (libs["pg warp a row"], _PG_GRID, ops._warp_lane_grid(q, sms)),
        }
        for w in (4, 8, 16):
            variants[f"a warp a row, {w} warps a block"] = (
                libs["pg warp a row"], _PG_GRID, (-(-q // w), 32 * w))
        calls, outs = {}, {}
        for name, (lib, sig, grid) in variants.items():
            outs[name] = tuple(torch.empty_like(t) for t in want)
            calls[name] = _caller(_fn(lib, "pred_gather_launch", sig),
                                  (*head, *grid, *(t.data_ptr() for t in outs[name])), dev)
        _check_all(calls, outs, want, f"pred_gather Q={q}")
        times = _time_all(calls)
        result["pred_gather"][f"Q={q}, cap {cap}"] = times
        for name, t in times.items():
            print(f"pred_gather Q={q}, cap {cap}: {name}: {t[0]:.5f} / {t[1]:.5f} ms", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    print(f"card: {chip_smoke.gpu_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
