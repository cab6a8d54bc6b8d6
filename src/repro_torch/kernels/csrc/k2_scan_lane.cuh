// One k2_scan lane as a __device__ function, and the batched k2_scan kernel
// built from it.  Shared by k2_scan.cu (the kernel alone) and
// k2_scan_rebind.cu (the kernel as phase 1, the lane function per Y lane in
// phase 2), so both compute the scan with the same code.
//
// Lane semantics (the Pallas `_traverse`, src/repro/kernels/k2_scan.py:80):
// tree `pred` (wrapped once, then clipped), row scan when is_row (columns of
// row `key`) else column scan (rows of column `key`).  Writes out_ids[cap]
// ascending, out_valid[cap], *out_count = min(#results, cap) and
// *out_overflow when any level's frontier held more than cap 1-nodes.
//
// The whole block runs one lane: the level-synchronous frontier BFS with
// the frontier (pos, base) double-buffered in global scratch (cur_*, nxt_*:
// cap ints each).  Per level the block enumerates the n·k child candidates
// in tiles of blockDim threads; each thread recomputes its parent's rank
// (word + rank gather, __popc) and tests its child bit.  Compaction is a
// block-wide exclusive prefix sum of the child-valid flags, so survivors
// keep lane order: the first cap valid children in (parent, child) order,
// exactly the reference's stable compaction.  The level loop stops when the
// frontier empties.
#pragma once

#include "k2_common.cuh"

struct K2Forest {
  const unsigned* t_words;
  const int* t_rank;
  const unsigned* l_words;
  const int* ones_before;
  const int* level_start;
  int P, Wt, Wl, Hob;
};

// fdig: K2_MAX_LEVELS ints and scan_scratch: 32 ints of shared memory.
// Every thread of the block calls it with the same arguments.
__device__ __forceinline__ void k2_scan_lane(
    int pred, int key, bool is_row, const K2Forest& f, const K2Geom& g,
    int cap, int* cur_pos, int* cur_base, int* nxt_pos, int* nxt_base,
    int* out_ids, bool* out_valid, int* out_count, bool* out_overflow,
    int* fdig, int* scan_scratch) {
  const int tid = threadIdx.x;
  const int H = g.H;
  const int p = pred_row(pred, f.P);
  const unsigned* trow = f.t_words + (size_t)p * f.Wt;
  const unsigned* lrow = f.l_words + (size_t)p * f.Wl;
  const int* rrow = f.t_rank + (size_t)p * f.Wt;

  if (tid == 0) {
    int rem = key;
    for (int l = 0; l < H; ++l) {
      fdig[l] = floordiv_pos(rem, g.subsides[l]);
      rem = floormod_pos(rem, g.subsides[l]);
    }
  }
  __syncthreads();

  // level 0: the k0 root children along the free axis, bit-tested, then
  // compacted (order-preserving, so the children order below is unchanged)
  const int k0 = g.ks[0];
  const int init_n = k0 < cap ? k0 : cap;
  bool ovf = k0 > cap;
  int n = 0;
  for (int t0 = 0; t0 < init_n; t0 += blockDim.x) {
    const int t = t0 + tid;
    int cpos = 0, flag = 0;
    if (t < init_n) {
      cpos = is_row ? wadd(wmul(fdig[0], k0), t) : wadd(wmul(t, k0), fdig[0]);
      const unsigned w = H == 1 ? word_at(lrow, f.Wl, cpos) : word_at(trow, f.Wt, cpos);
      flag = bit_of(w, cpos);
    }
    int tile_total;
    const int slot = n + block_exclusive_scan(flag, scan_scratch, &tile_total);
    if (flag) {
      cur_pos[slot] = cpos;
      cur_base[slot] = t * g.subsides[0];
    }
    n += tile_total;
  }
  __syncthreads();

  for (int lvl = 0; lvl + 1 < H && n > 0; ++lvl) {
    const int k = g.ks[lvl + 1];
    const int r = k * k;
    const int sub = g.subsides[lvl + 1];
    const int d = fdig[lvl + 1];
    const bool last_child = lvl + 2 == H;
    const int ob = f.ones_before[(size_t)p * f.Hob + lvl];
    const int ls = f.level_start[(size_t)p * H + lvl + 1];
    const int m = n * k;
    int total = 0;
    for (int t0 = 0; t0 < m; t0 += blockDim.x) {
      const int t = t0 + tid;
      int cpos = 0, cbase = 0, flag = 0;
      if (t < m) {
        const int i = t / k;
        const int c = t - i * k;
        const int ppos = cur_pos[i];
        const unsigned pw = word_at(trow, f.Wt, ppos);
        const int rank = rrow[clampi(ppos >> 5, 0, f.Wt - 1)] + popc_below(pw, ppos);
        const int cb0 = wadd(ls, wmul(rank - ob, r));
        cpos = wadd(cb0, is_row ? wadd(wmul(d, k), c) : wadd(wmul(c, k), d));
        cbase = cur_base[i] + c * sub;
        const unsigned w = last_child ? word_at(lrow, f.Wl, cpos) : word_at(trow, f.Wt, cpos);
        flag = bit_of(w, cpos);
      }
      int tile_total;
      const int slot = total + block_exclusive_scan(flag, scan_scratch, &tile_total);
      if (flag && slot < cap) {
        nxt_pos[slot] = cpos;
        nxt_base[slot] = cbase;
      }
      total += tile_total;
    }
    ovf = ovf || total > cap;
    n = total < cap ? total : cap;
    int* tp = cur_pos; cur_pos = nxt_pos; nxt_pos = tp;
    int* tb = cur_base; cur_base = nxt_base; nxt_base = tb;
    __syncthreads();
  }

  for (int i = tid; i < cap; i += blockDim.x) {
    const bool v = i < n;
    out_ids[i] = v ? cur_base[i] : 0;
    out_valid[i] = v;
  }
  if (tid == 0) {
    *out_count = n;
    *out_overflow = ovf;
  }
}

// Batched mixed scan: block q scans lane q.  Scratch layout:
// [buffer 0/1][pos/base][Q][cap] (4·Q·cap ints).
__global__ void k2_scan_kernel(
    const int* __restrict__ preds, const int* __restrict__ keys,
    const int* __restrict__ axes, int Q, K2Forest f, K2Geom g, int cap,
    int* __restrict__ scratch, int* __restrict__ ids, bool* __restrict__ valid,
    int* __restrict__ count, bool* __restrict__ overflow) {
  __shared__ int fdig[K2_MAX_LEVELS];
  __shared__ int scan_scratch[32];
  const int q = blockIdx.x;
  const size_t plane = (size_t)Q * cap;
  int* lane = scratch + (size_t)q * cap;
  k2_scan_lane(preds[q], keys[q], axes[q] == 0, f, g, cap, lane,
               lane + plane, lane + 2 * plane, lane + 3 * plane,
               ids + (size_t)q * cap, valid + (size_t)q * cap, count + q,
               overflow + q, fdig, scan_scratch);
}

static inline K2Forest k2_make_forest(
    const void* t_words, const void* t_rank, const void* l_words,
    const void* ones_before, const void* level_start, int P, int Wt, int Wl,
    int Hob) {
  K2Forest f;
  f.t_words = (const unsigned*)t_words;
  f.t_rank = (const int*)t_rank;
  f.l_words = (const unsigned*)l_words;
  f.ones_before = (const int*)ones_before;
  f.level_start = (const int*)level_start;
  f.P = P;
  f.Wt = Wt;
  f.Wl = Wl;
  f.Hob = Hob;
  return f;
}
