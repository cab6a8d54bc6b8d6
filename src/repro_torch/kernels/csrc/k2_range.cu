// k2_range: batched (?S, P, ?O) pair enumeration over the k²-forest.
//
// Replaces the Pallas kernel `k2_range` (src/repro/kernels/k2_range.py:128,
// body `_traverse_range` :51).  Lane q enumerates every cell of tree
// preds[q] (wrapped once, then clipped) in Morton order: rows[cap],
// cols[cap], valid[cap], count = min(#pairs, cap), overflow set when any
// level's frontier held more than cap 1-nodes.
//
// Design: a level-synchronous BFS whose frontier is (pos, rbase, cbase):
// the node's bit position and the origin of its submatrix.  Level 0 (one
// block a lane) bit-tests all r0 = k0² root children before it compacts,
// so overflow latches only when more than cap root children are set.
// Every further level is a grid-wide, stable, per-lane compaction in three
// launches, each spread over (parent tiles) x (lanes) blocks:
//   count   — a block takes RANGE_TILE parents of one lane, each thread
//             recomputes its parents' rank and counts their set child bits
//             (the full radix k², in child order); the tile's sum is stored;
//   scan    — one block a lane turns the tile sums into exclusive offsets
//             (clipped at cap), sets the lane's next frontier size to
//             min(total, cap) and latches overflow when total > cap;
//   scatter — the tiles again: a block-wide exclusive scan of each round's
//             per-thread counts places every survivor at its tile offset
//             plus its rank within the tile, dropped at slot >= cap, so the
//             survivors are the first cap in (parent, child) order.
// Frontier sizes stay on the device: every level launches the grid for its
// upper bound (cap parents a lane), blocks past a lane's live frontier exit
// at once, and the host never waits between levels.  Scratch: the frontier
// double-buffered in 6·cap ints a lane, plus 3 + ceil(cap / RANGE_TILE)
// counter ints a lane (two frontier sizes, the overflow flag, tile sums).
//
// Bound on the card: bytes — the frontier read twice and written once a
// level (12 B a node), the child-bit words and rank entries it touches, and
// the 9 B a slot of output; each block's dependent chain is one tile deep.
#include "k2_common.cuh"

#define ROOT_THREADS 1024
#define SCAN_THREADS 1024
#define RANGE_THREADS 256
#define RANGE_ROUNDS 4
#define RANGE_TILE (RANGE_THREADS * RANGE_ROUNDS)  // parents a tile
#define EMIT_THREADS 256
#define MAX_GRID_Y 65535

struct RangeArgs {
  const int* preds;
  int Q;
  const unsigned* t_words;
  const int* t_rank;
  const unsigned* l_words;
  const int* ones_before;
  const int* level_start;
  int P, Wt, Wl, Hob;
  K2Geom g;
  int cap;
  int tiles;            // ceil(cap / RANGE_TILE): tile sums a lane
  int* frontier;        // [buffer 0/1][pos/rbase/cbase][Q][cap]
  int* n;               // [2][Q] frontier sizes, by level parity
  int* ovf;             // [Q]
  int* tile_sum;        // [Q][tiles] counts, then exclusive offsets
};

__device__ __forceinline__ int* plane(const RangeArgs& A, int buf, int field, int q) {
  return A.frontier + ((size_t)(buf * 3 + field) * A.Q + q) * A.cap;
}

// Level 0: every root child is bit-tested, then the set ones compacted.
__global__ void __launch_bounds__(ROOT_THREADS) k2_range_root(RangeArgs A) {
  __shared__ int scan_scratch[32];
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const int H = A.g.H;
  const int p = pred_row(A.preds[q], A.P);
  const unsigned* trow = A.t_words + (size_t)p * A.Wt;
  const unsigned* lrow = A.l_words + (size_t)p * A.Wl;
  int* pos = plane(A, 0, 0, q);
  int* rb = plane(A, 0, 1, q);
  int* cb = plane(A, 0, 2, q);
  const int k0 = A.g.ks[0];
  const int r0 = k0 * k0;
  const int sub0 = A.g.subsides[0];
  long long total = 0;
  for (int t0 = 0; t0 < r0; t0 += blockDim.x) {
    const int t = t0 + tid;
    int flag = 0;
    if (t < r0) {
      const unsigned w = H == 1 ? word_at(lrow, A.Wl, t) : word_at(trow, A.Wt, t);
      flag = bit_of(w, t);
    }
    int tile_total;
    const long long slot = total + block_exclusive_scan(flag, scan_scratch, &tile_total);
    if (flag && slot < A.cap) {
      pos[slot] = t;
      rb[slot] = (t / k0) * sub0;
      cb[slot] = (t % k0) * sub0;
    }
    total += tile_total;
  }
  if (tid == 0) {
    A.n[q] = total < A.cap ? (int)total : A.cap;
    A.ovf[q] = total > A.cap;
  }
}

// One parent's expansion at level `lvl` -> `lvl + 1`: the position of its
// first child (children d = 0..r-1 sit at wadd(base, d)).
struct Expand {
  const unsigned* trow;
  const unsigned* crow;  // the words holding the children's bits
  int Wc;
  const int* rrow;
  int Wt, k, r, sub, ob, ls;

  __device__ __forceinline__ int child_base(int ppos) const {
    const unsigned pw = word_at(trow, Wt, ppos);
    const int rank = rrow[clampi(ppos >> 5, 0, Wt - 1)] + popc_below(pw, ppos);
    return wadd(ls, wmul(rank - ob, r));
  }
  __device__ __forceinline__ int child_bit(int base, int d) const {
    const int cpos = wadd(base, d);
    return bit_of(word_at(crow, Wc, cpos), cpos);
  }
  __device__ __forceinline__ int children(int base) const {
    int c = 0;
    for (int d = 0; d < r; ++d) c += child_bit(base, d);
    return c;
  }
};

// k and sub are ks[lvl + 1] and subsides[lvl + 1], passed by the host so
// that no kernel indexes the geometry with a runtime level.
__device__ __forceinline__ Expand make_expand(const RangeArgs& A, int p, int lvl, int k,
                                              int sub) {
  Expand e;
  const int H = A.g.H;
  e.trow = A.t_words + (size_t)p * A.Wt;
  const bool last_child = lvl + 2 == H;
  e.crow = last_child ? A.l_words + (size_t)p * A.Wl : e.trow;
  e.Wc = last_child ? A.Wl : A.Wt;
  e.rrow = A.t_rank + (size_t)p * A.Wt;
  e.Wt = A.Wt;
  e.k = k;
  e.r = k * k;
  e.sub = sub;
  e.ob = A.ones_before[(size_t)p * A.Hob + lvl];
  e.ls = A.level_start[(size_t)p * H + lvl + 1];
  return e;
}

// Pass 1: the set child bits of each tile of RANGE_TILE parents.
__global__ void __launch_bounds__(RANGE_THREADS) k2_range_count(RangeArgs A, int lvl, int k,
                                                                 int sub) {
  __shared__ int scan_scratch[32];
  const int t = blockIdx.x;
  const int cur = lvl & 1;
  const long long first = (long long)t * RANGE_TILE;
  for (int q = blockIdx.y; q < A.Q; q += gridDim.y) {
    const int n = A.n[cur * A.Q + q];
    if (first >= n) continue;  // past the lane's live frontier
    const int p = pred_row(A.preds[q], A.P);
    const Expand e = make_expand(A, p, lvl, k, sub);
    const int* pos = plane(A, cur, 0, q);
    int c = 0;
#pragma unroll
    for (int u = 0; u < RANGE_ROUNDS; ++u) {
      const long long i = first + u * RANGE_THREADS + threadIdx.x;
      if (i < n) c += e.children(e.child_base(pos[i]));
    }
    int sum;
    block_exclusive_scan(c, scan_scratch, &sum);
    if (threadIdx.x == 0) A.tile_sum[(size_t)q * A.tiles + t] = sum;
  }
}

// Pass 2: per lane, tile sums -> exclusive offsets clipped at cap; the next
// frontier size and the overflow latch.
__global__ void __launch_bounds__(SCAN_THREADS) k2_range_scan(RangeArgs A, int lvl) {
  __shared__ int scan_scratch[32];
  const int cur = lvl & 1;
  for (int q = blockIdx.x; q < A.Q; q += gridDim.x) {
    const int n = A.n[cur * A.Q + q];
    const int ntiles = (int)((n + (long long)RANGE_TILE - 1) / RANGE_TILE);
    int* sums = A.tile_sum + (size_t)q * A.tiles;
    long long total = 0;
    for (int t0 = 0; t0 < ntiles; t0 += blockDim.x) {
      const int t = t0 + threadIdx.x;
      const int v = t < ntiles ? sums[t] : 0;
      int chunk;
      const long long off = total + block_exclusive_scan(v, scan_scratch, &chunk);
      if (t < ntiles) sums[t] = off < A.cap ? (int)off : A.cap;
      total += chunk;
    }
    if (threadIdx.x == 0) {
      A.n[(cur ^ 1) * A.Q + q] = total < A.cap ? (int)total : A.cap;
      if (total > A.cap) A.ovf[q] = 1;
    }
  }
}

// Pass 3: every survivor to its slot, tile offset + rank within the tile.
__global__ void __launch_bounds__(RANGE_THREADS) k2_range_scatter(RangeArgs A, int lvl, int k,
                                                                   int sub) {
  __shared__ int scan_scratch[32];
  const int t = blockIdx.x;
  const int cur = lvl & 1, nxt = cur ^ 1;
  const long long first = (long long)t * RANGE_TILE;
  for (int q = blockIdx.y; q < A.Q; q += gridDim.y) {
    const int n = A.n[cur * A.Q + q];
    if (first >= n) continue;
    int off = A.tile_sum[(size_t)q * A.tiles + t];
    if (off >= A.cap) continue;  // every survivor of the tile is clipped
    const int p = pred_row(A.preds[q], A.P);
    const Expand e = make_expand(A, p, lvl, k, sub);
    const int* pos = plane(A, cur, 0, q);
    const int* rb = plane(A, cur, 1, q);
    const int* cb = plane(A, cur, 2, q);
    int* npos = plane(A, nxt, 0, q);
    int* nrb = plane(A, nxt, 1, q);
    int* ncb = plane(A, nxt, 2, q);
    for (int u = 0; u < RANGE_ROUNDS && off < A.cap; ++u) {
      const long long i = first + u * RANGE_THREADS + threadIdx.x;
      int base = 0, c = 0;
      if (i < n) {
        base = e.child_base(pos[i]);
        c = e.children(base);
      }
      int round;
      int slot = off + block_exclusive_scan(c, scan_scratch, &round);
      if (c) {
        const int prb = rb[i], pcb = cb[i];
        for (int d = 0; d < e.r && slot < A.cap; ++d) {
          if (!e.child_bit(base, d)) continue;
          npos[slot] = wadd(base, d);
          nrb[slot] = prb + (d / e.k) * e.sub;
          ncb[slot] = pcb + (d % e.k) * e.sub;
          ++slot;
        }
      }
      off += round;  // block-uniform
    }
  }
}

// The final frontier's submatrix origins are the pairs; zero past count.
__global__ void __launch_bounds__(EMIT_THREADS) k2_range_emit(
    RangeArgs A, int buf, int* __restrict__ rows, int* __restrict__ cols,
    bool* __restrict__ valid, int* __restrict__ count, bool* __restrict__ overflow) {
  const long long i = (long long)blockIdx.x * EMIT_THREADS + threadIdx.x;
  for (int q = blockIdx.y; q < A.Q; q += gridDim.y) {
    const int n = A.n[buf * A.Q + q];
    if (i < A.cap) {
      const size_t o = (size_t)q * A.cap + i;
      const bool v = i < n;
      rows[o] = v ? plane(A, buf, 1, q)[i] : 0;
      cols[o] = v ? plane(A, buf, 2, q)[i] : 0;
      valid[o] = v;
    }
    if (i == 0) {
      count[q] = n;
      overflow[q] = A.ovf[q] != 0;
    }
  }
}

// Counter ints the launcher needs beside the 6·Q·cap frontier ints.
extern "C" long long k2_range_counter_ints(int Q, int cap) {
  return (long long)Q * (3 + (cap + RANGE_TILE - 1) / RANGE_TILE);
}

extern "C" int k2_range_launch(
    const void* preds, int Q, const void* t_words, const void* t_rank,
    const void* l_words, const void* ones_before, const void* level_start,
    int P, int Wt, int Wl, int Hob, const int* ks, const int* subsides, int H,
    int cap, void* scratch, void* counters, long long counter_ints, void* rows,
    void* cols, void* valid, void* count, void* overflow, void* stream, int device) {
  RangeArgs A;
  int err = k2_make_geom(ks, subsides, H, &A.g);
  if (err) return err;
  if (cap < 1 || Q < 1 || counter_ints < k2_range_counter_ints(Q, cap))
    return (int)cudaErrorInvalidValue;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  A.preds = (const int*)preds;
  A.Q = Q;
  A.t_words = (const unsigned*)t_words;
  A.t_rank = (const int*)t_rank;
  A.l_words = (const unsigned*)l_words;
  A.ones_before = (const int*)ones_before;
  A.level_start = (const int*)level_start;
  A.P = P; A.Wt = Wt; A.Wl = Wl; A.Hob = Hob;
  A.cap = cap;
  A.tiles = (cap + RANGE_TILE - 1) / RANGE_TILE;
  A.frontier = (int*)scratch;
  A.n = (int*)counters;
  A.ovf = A.n + 2 * (size_t)Q;
  A.tile_sum = A.ovf + Q;
  cudaStream_t s = (cudaStream_t)stream;
  const int gy = Q < MAX_GRID_Y ? Q : MAX_GRID_Y;
  k2_range_root<<<Q, ROOT_THREADS, 0, s>>>(A);
  if ((err = (int)cudaGetLastError())) return err;
  for (int lvl = 0; lvl + 1 < H; ++lvl) {
    const int k = A.g.ks[lvl + 1], sub = A.g.subsides[lvl + 1];
    k2_range_count<<<dim3(A.tiles, gy), RANGE_THREADS, 0, s>>>(A, lvl, k, sub);
    k2_range_scan<<<Q, SCAN_THREADS, 0, s>>>(A, lvl);
    k2_range_scatter<<<dim3(A.tiles, gy), RANGE_THREADS, 0, s>>>(A, lvl, k, sub);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const unsigned emit_blocks = (unsigned)((cap + EMIT_THREADS - 1) / EMIT_THREADS);
  k2_range_emit<<<dim3(emit_blocks, gy), EMIT_THREADS, 0, s>>>(
      A, (H - 1) & 1, (int*)rows, (int*)cols, (bool*)valid, (int*)count, (bool*)overflow);
  return (int)cudaGetLastError();
}
