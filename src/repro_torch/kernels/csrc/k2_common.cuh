// Shared helpers of the k²-tree kernels: tree geometry passed by value,
// JAX-identical index arithmetic (floor digits, clipped gathers, wrapped
// predicate rows) and a block-wide exclusive prefix sum.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define K2_MAX_LEVELS 32

// Per-level arity and submatrix side, copied from the host arrays of
// K2Meta.ks / K2Meta.subsides (H <= K2_MAX_LEVELS).
struct K2Geom {
  int H;
  int ks[K2_MAX_LEVELS];
  int subsides[K2_MAX_LEVELS];
};

static inline int k2_make_geom(const int* ks, const int* subsides, int H, K2Geom* g) {
  if (H < 1 || H > K2_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  g->H = H;
  for (int i = 0; i < K2_MAX_LEVELS; ++i) {
    g->ks[i] = i < H ? ks[i] : 1;
    g->subsides[i] = i < H ? subsides[i] : 1;
  }
  return 0;
}

// Python/JAX floor division and modulo for a positive divisor.
__device__ __forceinline__ int floordiv_pos(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int floormod_pos(int a, int b) {
  int r = a % b;
  return (r < 0) ? r + b : r;
}

// The same by shift and mask when b is a power of two (an arithmetic shift
// is a floor division, and two's complement makes the mask a floor modulo).
__device__ __forceinline__ int floordiv_fast(int a, int b) {
  return (b & (b - 1)) == 0 ? a >> (__ffs(b) - 1) : floordiv_pos(a, b);
}
__device__ __forceinline__ int floormod_fast(int a, int b) {
  return (b & (b - 1)) == 0 ? a & (b - 1) : floormod_pos(a, b);
}

// Whether each submatrix side is a positive multiple of the next (every
// K2Meta's are).  Then the digit of level l along an axis is
// floordiv(floormod(x, subsides[l-1]), subsides[l]), each level on its own.
static inline bool k2_sides_nest(const K2Geom& g) {
  for (int i = 0; i < g.H; ++i) {
    if (g.subsides[i] < 1 || (i > 0 && g.subsides[i - 1] % g.subsides[i] != 0)) return false;
  }
  return true;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// JAX gather rule for a row index: wrap a negative once, then clip.
__device__ __forceinline__ int pred_row(int p, int P) {
  if (p < 0) p += P;
  return clampi(p, 0, P - 1);
}

// int32 arithmetic that wraps like XLA's (no signed-overflow UB).
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}

// Bit `pos` of a row of W words; the word index is clipped to [0, W-1].
__device__ __forceinline__ unsigned word_at(const unsigned* row, int W, int pos) {
  return row[clampi(pos >> 5, 0, W - 1)];
}
__device__ __forceinline__ int bit_of(unsigned word, int pos) {
  return (int)((word >> (unsigned)(pos & 31)) & 1u);
}
__device__ __forceinline__ int popc_below(unsigned word, int pos) {
  return __popc(word & ((1u << (unsigned)(pos & 31)) - 1u));
}

// Exclusive prefix sum of `v` over the block; `*total` gets the block sum.
// Every thread of the block must call it; blockDim.x is a multiple of 32
// and at most 1024.  `scratch` holds 32 ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch, int* total) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int t = lane < nw ? scratch[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += y;
    }
    if (lane < nw) scratch[lane] = t;
  }
  __syncthreads();
  const int before = wid > 0 ? scratch[wid - 1] : 0;
  *total = scratch[nw - 1];
  __syncthreads();  // scratch is reused by the next call
  return before + x - v;
}
