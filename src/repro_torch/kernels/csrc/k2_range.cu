// k2_range: batched (?S, P, ?O) pair enumeration over the k²-forest.
//
// Replaces the Pallas kernel `k2_range` (src/repro/kernels/k2_range.py:128,
// body `_traverse_range` :51).  Lane q enumerates every cell of tree
// preds[q] (wrapped once, then clipped) in Morton order: rows[cap],
// cols[cap], valid[cap], count = min(#pairs, cap), overflow set when any
// level's frontier held more than cap 1-nodes.
//
// Design: one thread block per lane runs a level-synchronous BFS whose
// frontier is (pos, rbase, cbase): the node's bit position and the origin
// of its submatrix.  Level 0 bit-tests all r0 = k0² root children before it
// compacts, so overflow latches only when more than cap root children are
// set (the fixed semantics).  Each further level expands every frontier
// node by the full radix k² (not by k, as a row scan does): the block walks
// the n·k² candidates in tiles of blockDim threads, each thread recomputes
// its parent's rank (word + rank gather, __popc) and tests its child bit,
// and a block-wide exclusive prefix sum compacts the survivors stably (the
// first cap in (parent, child) order).  The frontier is double-buffered in
// wrapper-allocated global scratch, 6·cap ints per lane.
//
// Bound on the card: a lane's candidates are walked by one block, tile by
// tile, with a dependent parent read -> rank gather -> child-bit gather per
// tile, so a large tree (millions of candidates per deep level) is bound by
// that serial chain on one SM, not by the arena bytes; the pair output
// (9 B per slot) is the largest write.
#include "k2_common.cuh"

#define K2_RANGE_THREADS 1024

__global__ void __launch_bounds__(K2_RANGE_THREADS) k2_range_kernel(
    const int* __restrict__ preds, int Q, const unsigned* __restrict__ t_words,
    const int* __restrict__ t_rank, const unsigned* __restrict__ l_words,
    const int* __restrict__ ones_before, const int* __restrict__ level_start,
    int P, int Wt, int Wl, int Hob, K2Geom g, int cap,
    int* __restrict__ scratch, int* __restrict__ rows, int* __restrict__ cols,
    bool* __restrict__ valid, int* __restrict__ count,
    bool* __restrict__ overflow) {
  __shared__ int scan_scratch[32];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int H = g.H;
  const int p = pred_row(preds[q], P);
  const unsigned* trow = t_words + (size_t)p * Wt;
  const unsigned* lrow = l_words + (size_t)p * Wl;
  const int* rrow = t_rank + (size_t)p * Wt;

  // scratch layout: [buffer 0/1][pos/rbase/cbase][Q][cap]
  const size_t plane = (size_t)Q * cap;
  int* cur_pos = scratch + 0 * plane + (size_t)q * cap;
  int* cur_rb = scratch + 1 * plane + (size_t)q * cap;
  int* cur_cb = scratch + 2 * plane + (size_t)q * cap;
  int* nxt_pos = scratch + 3 * plane + (size_t)q * cap;
  int* nxt_rb = scratch + 4 * plane + (size_t)q * cap;
  int* nxt_cb = scratch + 5 * plane + (size_t)q * cap;

  // level 0: every root child is bit-tested, then the set ones compacted
  const int k0 = g.ks[0];
  const int r0 = k0 * k0;
  const int sub0 = g.subsides[0];
  long long total = 0;
  for (int t0 = 0; t0 < r0; t0 += blockDim.x) {
    const int t = t0 + tid;
    int flag = 0;
    if (t < r0) {
      const unsigned w = H == 1 ? word_at(lrow, Wl, t) : word_at(trow, Wt, t);
      flag = bit_of(w, t);
    }
    int tile_total;
    const long long slot = total + block_exclusive_scan(flag, scan_scratch, &tile_total);
    if (flag && slot < cap) {
      cur_pos[slot] = t;
      cur_rb[slot] = (t / k0) * sub0;
      cur_cb[slot] = (t % k0) * sub0;
    }
    total += tile_total;
  }
  bool ovf = total > cap;
  int n = total < cap ? (int)total : cap;
  __syncthreads();

  for (int lvl = 0; lvl + 1 < H && n > 0; ++lvl) {
    const int k = g.ks[lvl + 1];
    const int r = k * k;
    const int sub = g.subsides[lvl + 1];
    const bool last_child = lvl + 2 == H;
    const int ob = ones_before[(size_t)p * Hob + lvl];
    const int ls = level_start[(size_t)p * H + lvl + 1];
    const long long m = (long long)n * r;
    total = 0;
    for (long long t0 = 0; t0 < m; t0 += blockDim.x) {
      const long long t = t0 + tid;
      int cpos = 0, crb = 0, ccb = 0, flag = 0;
      if (t < m) {
        const int i = (int)(t / r);
        const int d = (int)(t - (long long)i * r);
        const int ppos = cur_pos[i];
        const unsigned pw = word_at(trow, Wt, ppos);
        const int rank = rrow[clampi(ppos >> 5, 0, Wt - 1)] + popc_below(pw, ppos);
        cpos = wadd(wadd(ls, wmul(rank - ob, r)), d);
        crb = cur_rb[i] + (d / k) * sub;
        ccb = cur_cb[i] + (d % k) * sub;
        const unsigned w = last_child ? word_at(lrow, Wl, cpos) : word_at(trow, Wt, cpos);
        flag = bit_of(w, cpos);
      }
      int tile_total;
      const long long slot = total + block_exclusive_scan(flag, scan_scratch, &tile_total);
      if (flag && slot < cap) {
        nxt_pos[slot] = cpos;
        nxt_rb[slot] = crb;
        nxt_cb[slot] = ccb;
      }
      total += tile_total;
    }
    ovf = ovf || total > cap;
    n = total < cap ? (int)total : cap;
    int* tp = cur_pos; cur_pos = nxt_pos; nxt_pos = tp;
    int* tr = cur_rb; cur_rb = nxt_rb; nxt_rb = tr;
    int* tc = cur_cb; cur_cb = nxt_cb; nxt_cb = tc;
    __syncthreads();
  }

  int* out_rows = rows + (size_t)q * cap;
  int* out_cols = cols + (size_t)q * cap;
  bool* out_valid = valid + (size_t)q * cap;
  for (int i = tid; i < cap; i += blockDim.x) {
    const bool v = i < n;
    out_rows[i] = v ? cur_rb[i] : 0;
    out_cols[i] = v ? cur_cb[i] : 0;
    out_valid[i] = v;
  }
  if (tid == 0) {
    count[q] = n;
    overflow[q] = ovf;
  }
}

extern "C" int k2_range_launch(
    const void* preds, int Q, const void* t_words, const void* t_rank,
    const void* l_words, const void* ones_before, const void* level_start,
    int P, int Wt, int Wl, int Hob, const int* ks, const int* subsides, int H,
    int cap, void* scratch, void* rows, void* cols, void* valid, void* count,
    void* overflow, void* stream, int device) {
  K2Geom g;
  int err = k2_make_geom(ks, subsides, H, &g);
  if (err) return err;
  if (cap < 1 || Q < 1) return (int)cudaErrorInvalidValue;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  k2_range_kernel<<<Q, K2_RANGE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)preds, Q, (const unsigned*)t_words, (const int*)t_rank,
      (const unsigned*)l_words, (const int*)ones_before,
      (const int*)level_start, P, Wt, Wl, Hob, g, cap, (int*)scratch,
      (int*)rows, (int*)cols, (bool*)valid, (int*)count, (bool*)overflow);
  return (int)cudaGetLastError();
}
