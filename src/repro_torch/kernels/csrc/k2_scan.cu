// k2_scan: batched mixed row/column scan over the k²-forest.
//
// Replaces the Pallas kernel `k2_scan` (src/repro/kernels/k2_scan.py:169,
// body `_traverse` :80 and `_compact_rows` :62).  Lane q scans tree
// preds[q]: axes[q] == 0 lists the columns of row keys[q] ((S,P,?O)),
// axes[q] == 1 the rows of column keys[q] ((?S,P,O)).  Output per lane:
// ids[cap] ascending, valid[cap], count = min(#results, cap), overflow set
// when any level's frontier held more than cap 1-nodes.
//
// Design: one thread block per lane runs the level-synchronous frontier
// BFS.  The frontier (pos, base) lives in a wrapper-allocated global
// scratch, double-buffered per level (4·cap ints per lane).  Per level the
// block enumerates the n·k child candidates in tiles of blockDim threads;
// each thread recomputes its parent's rank (word + rank gather, __popc) and
// tests its child bit.  Compaction is a block-wide exclusive prefix sum of
// the child-valid flags, so survivors keep lane order: the first cap valid
// children in (parent, child) order, exactly as the reference's stable
// compaction (no atomics, which would reorder survivors).  The level loop
// runs over H at runtime and stops when the frontier empties.
//
// Bound on the card: dependent gathers into arenas larger than L2 (one
// level's reads need the previous level's compaction) and the
// cap-wide output write; a lane's work is data-dependent (frontier size),
// and small frontiers leave most of a block idle.
#include "k2_common.cuh"

__global__ void k2_scan_kernel(
    const int* __restrict__ preds, const int* __restrict__ keys,
    const int* __restrict__ axes, int Q,
    const unsigned* __restrict__ t_words, const int* __restrict__ t_rank,
    const unsigned* __restrict__ l_words, const int* __restrict__ ones_before,
    const int* __restrict__ level_start, int P, int Wt, int Wl, int Hob,
    K2Geom g, int cap, int* __restrict__ scratch, int* __restrict__ ids,
    bool* __restrict__ valid, int* __restrict__ count,
    bool* __restrict__ overflow) {
  __shared__ int fdig[K2_MAX_LEVELS];
  __shared__ int scan_scratch[32];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int H = g.H;
  const int p = pred_row(preds[q], P);
  const bool is_row = axes[q] == 0;
  const unsigned* trow = t_words + (size_t)p * Wt;
  const unsigned* lrow = l_words + (size_t)p * Wl;
  const int* rrow = t_rank + (size_t)p * Wt;

  if (tid == 0) {
    int rem = keys[q];
    for (int l = 0; l < H; ++l) {
      fdig[l] = floordiv_pos(rem, g.subsides[l]);
      rem = floormod_pos(rem, g.subsides[l]);
    }
  }
  __syncthreads();

  // scratch layout: [buffer 0/1][pos/base][Q][cap]
  const size_t plane = (size_t)Q * cap;
  int* cur_pos = scratch + 0 * plane + (size_t)q * cap;
  int* cur_base = scratch + 1 * plane + (size_t)q * cap;
  int* nxt_pos = scratch + 2 * plane + (size_t)q * cap;
  int* nxt_base = scratch + 3 * plane + (size_t)q * cap;

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
      const unsigned w = H == 1 ? word_at(lrow, Wl, cpos) : word_at(trow, Wt, cpos);
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
    const int ob = ones_before[(size_t)p * Hob + lvl];
    const int ls = level_start[(size_t)p * H + lvl + 1];
    const int m = n * k;
    int total = 0;
    for (int t0 = 0; t0 < m; t0 += blockDim.x) {
      const int t = t0 + tid;
      int cpos = 0, cbase = 0, flag = 0;
      if (t < m) {
        const int i = t / k;
        const int c = t - i * k;
        const int ppos = cur_pos[i];
        const unsigned pw = word_at(trow, Wt, ppos);
        const int rank = rrow[clampi(ppos >> 5, 0, Wt - 1)] + popc_below(pw, ppos);
        const int cb0 = wadd(ls, wmul(rank - ob, r));
        cpos = wadd(cb0, is_row ? wadd(wmul(d, k), c) : wadd(wmul(c, k), d));
        cbase = cur_base[i] + c * sub;
        const unsigned w = last_child ? word_at(lrow, Wl, cpos) : word_at(trow, Wt, cpos);
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

  int* out_ids = ids + (size_t)q * cap;
  bool* out_valid = valid + (size_t)q * cap;
  for (int i = tid; i < cap; i += blockDim.x) {
    const bool v = i < n;
    out_ids[i] = v ? cur_base[i] : 0;
    out_valid[i] = v;
  }
  if (tid == 0) {
    count[q] = n;
    overflow[q] = ovf;
  }
}

extern "C" int k2_scan_launch(
    const void* preds, const void* keys, const void* axes, int Q,
    const void* t_words, const void* t_rank, const void* l_words,
    const void* ones_before, const void* level_start, int P, int Wt, int Wl,
    int Hob, const int* ks, const int* subsides, int H, int cap, void* scratch,
    void* ids, void* valid, void* count, void* overflow, void* stream,
    int device) {
  K2Geom g;
  int err = k2_make_geom(ks, subsides, H, &g);
  if (err) return err;
  if (cap < 1 || Q < 1) return (int)cudaErrorInvalidValue;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  k2_scan_kernel<<<Q, 256, 0, (cudaStream_t)stream>>>(
      (const int*)preds, (const int*)keys, (const int*)axes, Q,
      (const unsigned*)t_words, (const int*)t_rank, (const unsigned*)l_words,
      (const int*)ones_before, (const int*)level_start, P, Wt, Wl, Hob, g, cap,
      (int*)scratch, (int*)ids, (bool*)valid, (int*)count, (bool*)overflow);
  return (int)cudaGetLastError();
}
