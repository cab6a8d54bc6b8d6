// One k2_scan lane on one warp, and the batched kernel built from it.
// Shared by k2_scan.cu (the kernel over query lanes) and k2_scan_rebind.cu
// (the same kernel over the X and key-0 lanes, then over the X slots' Y
// lanes), so both compute the scan with the same code.
//
// Lane semantics (the Pallas `_traverse`, src/repro/kernels/k2_scan.py:80):
// tree `pred` (wrapped once, then clipped), row scan when is_row (columns of
// row `key`) else column scan (rows of column `key`).  Writes out_ids[cap]
// ascending, out_valid[cap], *out_count = min(#results, cap) and
// *out_overflow when any level's frontier held more than cap 1-nodes.
//
// One warp runs one lane at a time, K2_WARPS lanes a block, and a grid no
// larger than the card holds splits the lanes into one run of consecutive
// lanes a warp.  Nothing on a lane's path waits for another warp: no block
// barrier, no block scan.  A lane equal to the warp's previous one (same
// tree, key, axis and cap: join F's flat scan repeats one key-0 lane per
// dead union slot) re-emits the previous traversal's frontier.
//
// The frontier of a level is a list of 1-nodes (rank, base): the node's
// rank1 in t_words (the count the next level's child position needs) and
// the origin of its submatrix along the free axis.  A level enumerates the
// n·k child candidates in rounds of K2_UNROLL tiles of 32, one candidate a
// thread a tile: each thread reads its parent's entry, loads the child's
// word and, in the same round, the t_rank entry at the same clamped word
// index (the last level reads l_words and no rank); all loads of a round
// are issued before any is used.  A set child's rank is then rank_base +
// popc_below(word, pos), from registers: the only dependent global loads
// of a level are its children's words and rank entries.  Compaction is
// __ballot_sync of a tile's set flags plus __popc of the mask below the
// thread, tile after tile, so survivors keep (parent, child) order: the
// first cap set children, exactly the reference's stable compaction.  A
// level stops after the round in which its total exceeds cap (the overflow
// latch is then known and the first cap survivors are placed); the level
// loop stops when the frontier empties.
//
// The frontier is double-buffered: entries below K2_SLAB live in the
// warp's shared-memory slab, entries from K2_SLAB on in the warp's global
// spill area (4·(cap − K2_SLAB) ints: two buffers of rank and base), read
// and written by the same code.  Spill areas are indexed by warp of the
// grid, so scratch is bounded by the grid, not by the number of lanes.
//
// The trade-off of one warp a lane: a geonames scan lane's frontier is not
// a handful of nodes but every 1-node of the key's band, hundreds at the
// middle levels, so a lane tests thousands of candidates.  One warp runs
// them in ~30 dependent rounds and issues alone the instructions that a
// block would spread over 8 warps: a lone lane is slower than on a block
// (latency), a batch that fills the card is faster (throughput, no idle
// threads).  K2_UNROLL 4, K2_SLAB 256 and 4 warps a block were the
// fastest of the settings tried on both.
#pragma once

#include <stdint.h>

#include "k2_common.cuh"

#define K2_WARPS 4     // lanes resident per block, one a warp
#define K2_SLAB 256    // frontier entries a buffer in shared memory, per warp
#define K2_UNROLL 4    // tiles of 32 candidates a thread loads in one round
#define K2_FULL 0xffffffffu

struct K2Forest {
  const unsigned* t_words;
  const int* t_rank;
  const unsigned* l_words;
  const int* ones_before;
  const int* level_start;
  int P, Wt, Wl, Hob;
};

struct K2Out {
  int* ids;
  bool* valid;
  int* count;
  bool* overflow;
};

// One set of lanes of a launch and where its results go (`out`, rows of
// `cap` slots).  Scan: lane y is (preds[y], keys[y], axes[y]), key 0 when
// keys is null.  Re-bind Y lanes (x_ids set): lane y is X slot y of query
// lane q = y / per_query, the scan (preds[q], x_ids[y], axes[q]) when
// x_valid[y]; a dead slot scans key 0, and `zero` already holds that scan
// for every query lane, so the lane copies row q of it.
struct K2Lanes {
  const int* preds;
  const int* keys;
  const int* axes;
  const int* x_ids;
  const bool* x_valid;
  K2Out zero;
  int per_query;
  int n;
  int cap;
  K2Out out;
};

__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// One warp's double-buffered frontier of (rank, base) entries: entry i of
// buffer b in the shared-memory slab ([buffer][K2_SLAB]) while i <
// K2_SLAB, else in the warp's global spill area ([buffer][spill_n]).
struct K2Frontier {
  int2* slab;
  int2* spill;
  int spill_n;

  __device__ __forceinline__ int2 get(int b, int i) const {
    return i < K2_SLAB ? slab[b * K2_SLAB + i] : spill[(size_t)b * spill_n + (i - K2_SLAB)];
  }
  __device__ __forceinline__ void set(int b, int i, int rank, int base) const {
    if (i < K2_SLAB) {
      slab[b * K2_SLAB + i] = make_int2(rank, base);
    } else {
      spill[(size_t)b * spill_n + (i - K2_SLAB)] = make_int2(rank, base);
    }
  }
};

// 0x01 in each of the first clamp(x, 0, 4) bytes of a word: four valid flags.
__device__ __forceinline__ unsigned valid_bytes(int x) {
  return x <= 0 ? 0u : (x >= 4 ? 0x01010101u : 0x01010101u & ((1u << (8 * x)) - 1u));
}

// A lane's output row copied from another lane's: 16-byte loads and stores
// where both rows are aligned.
__device__ __forceinline__ void k2_copy_lane(const K2Out& src, int q, int cap,
                                             const K2Out& dst, int y) {
  const int lane = threadIdx.x & 31;
  const int* si = src.ids + (size_t)q * cap;
  int* di = dst.ids + (size_t)y * cap;
  const int n4 = (((uintptr_t)si | (uintptr_t)di) & 15) == 0 ? cap >> 2 : 0;
  for (int j = lane; j < n4; j += 32) {
    reinterpret_cast<int4*>(di)[j] = reinterpret_cast<const int4*>(si)[j];
  }
  for (int s = 4 * n4 + lane; s < cap; s += 32) di[s] = si[s];
  const bool* sv = src.valid + (size_t)q * cap;
  bool* dv = dst.valid + (size_t)y * cap;
  const int n16 = (((uintptr_t)sv | (uintptr_t)dv) & 15) == 0 ? cap >> 4 : 0;
  for (int j = lane; j < n16; j += 32) {
    reinterpret_cast<uint4*>(dv)[j] = reinterpret_cast<const uint4*>(sv)[j];
  }
  for (int s = 16 * n16 + lane; s < cap; s += 32) dv[s] = sv[s];
  if (lane == 0) {
    dst.count[y] = src.count[q];
    dst.overflow[y] = src.overflow[q];
  }
}

// A finished traversal: the last level's frontier (n entries of buffer
// cur, n <= cap) and the overflow latch.
struct K2Scan {
  int n;
  bool ovf;
  int cur;
};

// The traversal of one lane over tree p (already wrapped and clipped).
// Every thread of the warp calls it with the same arguments; fr's spill
// area holds max(cap − K2_SLAB, 0) entries a buffer.
__device__ __forceinline__ K2Scan k2_scan_warp_lane(
    int p, int key, bool is_row, const K2Forest& f, const K2Geom& g, int cap,
    const K2Frontier& fr) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int H = g.H;
  const unsigned* trow = f.t_words + (size_t)p * f.Wt;
  const unsigned* lrow = f.l_words + (size_t)p * f.Wl;
  const int* rrow = f.t_rank + (size_t)p * f.Wt;
  // the tree's level table, one level a thread, read beside the root words
  const int my_ls = lane < H ? f.level_start[(size_t)p * H + lane] : 0;
  const int my_ob = lane < f.Hob ? f.ones_before[(size_t)p * f.Hob + lane] : 0;
  // level `lane`'s arity, submatrix side and key digit; the sides nest, so
  // the remainder above level l is floormod(key, subsides[l − 1])
  const int my_k = lane < H ? g.ks[lane] : 1;
  const int my_sub = lane < H ? g.subsides[lane] : 1;
  const int above = __shfl_up_sync(K2_FULL, my_sub, 1);
  const int my_d = floordiv_pos(lane == 0 ? key : floormod_pos(key, above), my_sub);

  // level 0: the first min(k0, cap) root children along the free axis,
  // bit-tested, then compacted (order-preserving)
  const int k0 = __shfl_sync(K2_FULL, my_k, 0);
  const int sub0 = __shfl_sync(K2_FULL, my_sub, 0);
  const int d0 = __shfl_sync(K2_FULL, my_d, 0);
  const int init_n = k0 < cap ? k0 : cap;
  const bool leaf0 = H == 1;
  bool ovf = k0 > cap;
  int n = 0, cur = 0;
  for (int t0 = 0; t0 < init_n; t0 += 32) {
    const int t = t0 + lane;
    const int cpos = is_row ? wadd(wmul(d0, k0), t) : wadd(wmul(t, k0), d0);
    bool flag = false;
    unsigned w = 0;
    int rb = 0;
    if (t < init_n) {
      const int wi = clampi(cpos >> 5, 0, (leaf0 ? f.Wl : f.Wt) - 1);
      w = leaf0 ? lrow[wi] : trow[wi];
      rb = leaf0 ? 0 : rrow[wi];
      flag = bit_of(w, cpos);
    }
    const unsigned mask = __ballot_sync(K2_FULL, flag);
    if (flag) {
      const int slot = n + __popc(mask & below);
      fr.set(cur, slot, wadd(rb, popc_below(w, cpos)), wmul(t, sub0));
    }
    n += __popc(mask);
  }
  __syncwarp();

  for (int lvl = 0; lvl + 1 < H && n > 0; ++lvl) {
    const int k = __shfl_sync(K2_FULL, my_k, lvl + 1);
    const int r = wmul(k, k);
    const int sub = __shfl_sync(K2_FULL, my_sub, lvl + 1);
    const int d = __shfl_sync(K2_FULL, my_d, lvl + 1);
    const bool leaf = lvl + 2 == H;
    const int ob = __shfl_sync(K2_FULL, my_ob, lvl);
    const int ls = __shfl_sync(K2_FULL, my_ls, lvl + 1);
    // child c of a parent sits at ls + (rank − ob)·r + off_d + c·step_c
    const int off_d = is_row ? wmul(d, k) : d;
    const int step_c = is_row ? 1 : k;
    const int k_shift = (k & (k - 1)) == 0 ? __ffs(k) - 1 : -1;  // k a power of two
    const int m = n * k;
    const int nxt = cur ^ 1;
    int total = 0;
    // a round: K2_UNROLL tiles of 32 candidates, all loads issued first
    for (int t0 = 0; t0 < m && total <= cap; t0 += 32 * K2_UNROLL) {
      unsigned w[K2_UNROLL];
      int rb[K2_UNROLL], cpos[K2_UNROLL], cbase[K2_UNROLL];
#pragma unroll
      for (int u = 0; u < K2_UNROLL; ++u) {
        const int t = t0 + 32 * u + lane;
        w[u] = 0;
        rb[u] = cpos[u] = cbase[u] = 0;
        if (t < m) {
          const int i = k_shift >= 0 ? t >> k_shift : t / k;
          const int c = t - i * k;
          const int2 e = fr.get(cur, i);  // the parent's (rank, base)
          cbase[u] = wadd(e.y, wmul(c, sub));
          cpos[u] = wadd(wadd(ls, wmul(wsub(e.x, ob), r)), wadd(off_d, wmul(c, step_c)));
          const int wi = clampi(cpos[u] >> 5, 0, (leaf ? f.Wl : f.Wt) - 1);
          w[u] = leaf ? lrow[wi] : trow[wi];
          rb[u] = leaf ? 0 : rrow[wi];
        }
      }
#pragma unroll
      for (int u = 0; u < K2_UNROLL; ++u) {
        const bool flag = t0 + 32 * u + lane < m && bit_of(w[u], cpos[u]);
        const unsigned mask = __ballot_sync(K2_FULL, flag);
        const int slot = total + __popc(mask & below);
        if (flag && slot < cap) {
          fr.set(nxt, slot, wadd(rb[u], popc_below(w[u], cpos[u])), cbase[u]);
        }
        total += __popc(mask);
      }
    }
    ovf = ovf || total > cap;
    n = total < cap ? total : cap;
    cur = nxt;
    __syncwarp();
  }
  return {n, ovf, cur};
}

// A lane's output row from a finished traversal: ids in 16-byte stores of
// four slots, valid in 16-byte stores of sixteen, where the row is aligned;
// scalar stores for the rest.
__device__ __forceinline__ void k2_emit(const K2Frontier& fr, const K2Scan& sc,
                                        int cap, const K2Out& row) {
  const int lane = threadIdx.x & 31;
  const int n = sc.n, cur = sc.cur;
  int* out_ids = row.ids;
  bool* out_valid = row.valid;
  const int n4 = ((uintptr_t)out_ids & 15) == 0 ? cap >> 2 : 0;
  for (int j = lane; j < n4; j += 32) {
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = 4 * j + e;
      v[e] = s < n ? fr.get(cur, s).y : 0;
    }
    reinterpret_cast<int4*>(out_ids)[j] = make_int4(v[0], v[1], v[2], v[3]);
  }
  for (int s = 4 * n4 + lane; s < cap; s += 32) {
    out_ids[s] = s < n ? fr.get(cur, s).y : 0;
  }
  const int n16 = ((uintptr_t)out_valid & 15) == 0 ? cap >> 4 : 0;
  for (int j = lane; j < n16; j += 32) {
    const int s = 16 * j;
    reinterpret_cast<uint4*>(out_valid)[j] = make_uint4(
        valid_bytes(n - s), valid_bytes(n - s - 4), valid_bytes(n - s - 8),
        valid_bytes(n - s - 12));
  }
  for (int s = 16 * n16 + lane; s < cap; s += 32) out_valid[s] = s < n;
  if (lane == 0) {
    *row.count = n;
    *row.overflow = sc.ovf;
  }
  __syncwarp();  // the warp's next traversal rewrites the frontier buffers
}

// Lane y of lane set `in`: its scan's arguments and output row, or false
// when it is a dead re-bind slot, which copies its query lane's key-0 row.
__device__ __forceinline__ bool k2_lane_args(const K2Lanes& in, int y, int* pred,
                                             int* key, int* axis, int* cap,
                                             K2Out* row) {
  const int q = in.per_query == 1 ? y : y / in.per_query;
  *key = 0;
  if (in.x_ids != nullptr) {
    if (!in.x_valid[y]) {
      k2_copy_lane(in.zero, q, in.cap, in.out, y);
      return false;
    }
    *key = in.x_ids[y];
  } else if (in.keys != nullptr) {
    *key = in.keys[y];
  }
  *pred = in.preds[q];
  *axis = in.axes[q];
  *cap = in.cap;
  *row = {in.out.ids + (size_t)y * in.cap, in.out.valid + (size_t)y * in.cap,
          in.out.count + y, in.out.overflow + y};
  return true;
}

// Batched scan over the lanes of `a`, then of `b` (b.n may be 0): warp w of
// the grid runs the w-th of W equal runs of consecutive lanes (W the grid's
// warps).  A lane with the same tree, key, axis and cap as the warp's
// previous traversal re-emits that traversal's frontier, still in the
// warp's buffers, instead of repeating it: the same inputs give the same
// scan.  spill: 4·spill_n ints a warp of the grid, spill_n = max(cap −
// K2_SLAB, 0) for the larger cap of the two sets.
__global__ void __launch_bounds__(K2_WARPS * 32) k2_scan_warp_kernel(
    K2Lanes a, K2Lanes b, K2Forest f, K2Geom g, int* __restrict__ spill,
    int spill_n) {
  __shared__ int2 slab[K2_WARPS][2 * K2_SLAB];
  const int warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * K2_WARPS + warp;
  const long long n = (long long)a.n + b.n;
  const long long warps = (long long)gridDim.x * K2_WARPS;
  const long long per = (n + warps - 1) / warps;
  const int y0 = (int)min(n, gw * per), y1 = (int)min(n, (gw + 1) * per);
  const K2Frontier fr = {slab[warp], (int2*)spill + (size_t)gw * 2 * spill_n, spill_n};
  int last_p = -1, last_key = 0, last_cap = 0;
  bool last_row = false;
  K2Scan sc = {0, false, 0};
  for (int y = y0; y < y1; ++y) {
    int pred, key, axis, cap;
    K2Out row;
    const bool scan = y < a.n ? k2_lane_args(a, y, &pred, &key, &axis, &cap, &row)
                              : k2_lane_args(b, y - a.n, &pred, &key, &axis, &cap, &row);
    if (!scan) continue;
    const int p = pred_row(pred, f.P);
    const bool is_row = axis == 0;
    if (p != last_p || key != last_key || is_row != last_row || cap != last_cap) {
      sc = k2_scan_warp_lane(p, key, is_row, f, g, cap, fr);
      last_p = p;
      last_key = key;
      last_row = is_row;
      last_cap = cap;
    }
    k2_emit(fr, sc, cap, row);
  }
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

// Blocks of a launch over `lanes` lanes: one warp a lane, at most as many
// blocks as the card holds at once (occupancy of k2_scan_warp_kernel, read
// once a device).  Negative: a CUDA error.
static inline int k2_scan_grid(long long lanes, int device) {
  static int resident[64];
  if (lanes < 1 || device < 0 || device >= 64) return -(int)cudaErrorInvalidValue;
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    int err = (int)cudaSetDevice(device);
    if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (!err) {
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, k2_scan_warp_kernel, K2_WARPS * 32, 0);
    }
    if (err) return -err;
    resident[device] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  const long long need = (lanes + K2_WARPS - 1) / K2_WARPS;
  return (int)(need < resident[device] ? need : resident[device]);
}

// Frontier entries a buffer that spill past the slab at this cap.
static inline int k2_spill_n(int cap) { return cap > K2_SLAB ? cap - K2_SLAB : 0; }

// Spill ints a launch of `blocks` blocks needs at this cap.
static inline long long k2_scan_spill(int blocks, int cap) {
  return (long long)blocks * K2_WARPS * 4 * k2_spill_n(cap);
}

// Queues the kernel over lane sets a and b, with spill sized for the larger
// cap; the launcher has checked the arguments.  Returns cudaGetLastError().
static inline int k2_scan_run(const K2Lanes& a, const K2Lanes& b, const K2Forest& f,
                              const K2Geom& g, int blocks, void* scratch,
                              cudaStream_t stream) {
  const int cap = a.cap > b.cap ? a.cap : b.cap;
  k2_scan_warp_kernel<<<blocks, K2_WARPS * 32, 0, stream>>>(a, b, f, g, (int*)scratch,
                                                             k2_spill_n(cap));
  return (int)cudaGetLastError();
}

// What a launch cannot take: submatrix sides that do not nest (each a
// multiple of the next; every K2Meta's do), and a cap whose frontier of
// cap nodes would expand to more candidates than int range holds.
static inline bool k2_scan_cap_ok(const K2Geom& g, int cap) {
  if (cap < 1) return false;
  int kmax = 1;
  for (int i = 0; i < g.H; ++i) {
    kmax = g.ks[i] > kmax ? g.ks[i] : kmax;
    if (g.subsides[i] < 1 || (i > 0 && g.subsides[i - 1] % g.subsides[i] != 0)) return false;
  }
  return (long long)cap * kmax <= 0x7FFFFFFFLL - 32 * K2_UNROLL;
}
