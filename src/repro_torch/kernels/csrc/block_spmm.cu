// block_spmm: Y = A @ X, skipping the tiles of A that a k²-level mask
// certifies empty.
//
// Replaces the Pallas kernel `block_spmm` (src/repro/kernels/block_spmm.py:48,
// body `_kernel` :31): grid (M/BM, D/BD, K/BK) with K innermost, the output
// block accumulated in VMEM across the K sweep, and `@pl.when(mask != 0)`
// around the MXU product.  Here: Y[M, D] f32; A[M, K] and X[K, D] both f32
// or both bf16; mask int32[M/BM, K/BK].  The product of A's tile (mi, ki)
// with X's row band ki is added to Y's row band mi iff mask[mi, ki] != 0
// (negative values turn a tile on).  A masked-off tile is never read, and
// no product with the X rows it would meet reaches Y, so a NaN there never
// does either.
//
// Design: one 256-thread block per 128 x 128 output tile, whatever the
// mask's block sizes (the JAX contract: BM | M, BK | K, BD | D).  The K
// sweep runs over the mask's columns ki; inside one, in chunks of 16
// through shared memory, the sum in f32 registers (8 x 8 per thread).  A
// mask column whose tile is off for all 128 rows is skipped on one vote:
// no load of A or X, no FMA.  The kernel comes in two instantiations of
// the same code, chosen at launch from the shapes: the grid one, for BM a
// multiple of 128, BK of 16, D of 128 and 16-byte aligned A, X and Y,
// where a block's rows share one mask row and loads and stores move 16
// bytes; and the EDGE one for everything else, where each row looks up
// its own tile, A's rows whose tile is off load as 0 and their sums skip
// the chunk, and rows, columns and k past the matrix or the mask tile
// load as 0.  bf16 is widened to f32 as it enters shared memory; the
// products are plain f32 FMAs (never TF32), exact for bf16 inputs.
//
// Bound on the card: operations for these shapes — 2·BM·BK·D flops per ON
// tile at 67 TFLOP/s (f32 FMA) or at the 989 TFLOP/s bf16 tensor-core peak,
// which this FMA kernel cannot reach; bytes are the ON tiles of A, X, Y
// and the mask.  `mma.sync`/`wgmma` and TMA are the way to that bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TM 128
#define TN 128
#define TK 16
#define THREADS 256

// Eight consecutive elements of a 16-byte aligned row, widened to f32.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = reinterpret_cast<const uint4*>(p)[0];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// One chunk of 16 k into the 8 x 8 sums; GUARD skips the rows whose bit
// of `on` is clear (row i of the thread: bit i).
template <bool GUARD>
__device__ __forceinline__ void fma_chunk(float (&acc)[8][8], const float (&As)[TK][TM],
                                          const float (&Xs)[TK][TN], int ty, int tx,
                                          unsigned on) {
#pragma unroll
  for (int kk = 0; kk < TK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Xs[kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Xs[kk][64 + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (GUARD && !((on >> i) & 1u)) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// the block-local row of a thread's i-th sum
__device__ __forceinline__ int sum_row(int ty, int i) {
  return i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
}

template <typename T, bool EDGE>
__global__ void __launch_bounds__(THREADS) block_spmm_kernel(
    const int* __restrict__ mask, const T* __restrict__ a, const T* __restrict__ x,
    float* __restrict__ y, int M, int K, int D, int BM, int BK) {
  __shared__ __align__(16) float As[TK][TM];  // A chunk, transposed
  __shared__ __align__(16) float Xs[TK][TN];
  const int t = threadIdx.x;
  const int tx = t % 16, ty = t / 16;
  // column tiles fastest, so the blocks that share A's row tile run together
  const int ncol = (D + TN - 1) / TN;
  const long long r0 = (long long)(blockIdx.x / ncol) * TM;
  const int c0 = (blockIdx.x % ncol) * TN;
  const int nkb = K / BK;
  // loader roles: A row t/2, k half (t%2)*8; X row t/16, cols (t%16)*8
  const int a_row = t / 2, a_k = (t % 2) * 8;
  const int x_row = t / 16, x_col = (t % 16) * 8;
  const long long ar = r0 + a_row;
  const int* a_mask = mask + (ar < M ? ar / BM : 0) * nkb;  // the mask row of A's loaded row

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int ki = 0; ki < nkb; ++ki) {
    // skip a tile that is off for every row of the block: no load, no FMA
    const bool a_on = ar < M && a_mask[ki] != 0;
    unsigned on = 0xFFu;  // the thread's rows whose tile is on (bit i: row i)
    if (EDGE) {
      if (!__syncthreads_or(a_on)) continue;
      on = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long r = r0 + sum_row(ty, i);
        if (r < M && mask[(int)r / BM * (long long)nkb + ki] != 0) on |= 1u << i;
      }
    } else if (!a_on) {
      continue;  // one mask row for the whole block
    }
    const int k_end = (ki + 1) * BK;
    for (int k0 = ki * BK; k0 < k_end; k0 += TK) {
      const int xk = k0 + x_row;
      float v[8];
      if (EDGE) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + a_k + j;
          v[j] = a_on && k < k_end ? to_f32(a[ar * K + k]) : 0.f;
        }
      } else {
        load8(a + ar * K + k0 + a_k, v);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) As[a_k + j][a_row] = v[j];
      if (EDGE) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = c0 + x_col + j;
          v[j] = xk < k_end && c < D ? to_f32(x[(long long)xk * D + c]) : 0.f;
        }
      } else {
        load8(x + (long long)xk * D + c0 + x_col, v);
      }
      *reinterpret_cast<float4*>(&Xs[x_row][x_col]) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(&Xs[x_row][x_col + 4]) = make_float4(v[4], v[5], v[6], v[7]);
      __syncthreads();
      if (on == 0xFFu)
        fma_chunk<false>(acc, As, Xs, ty, tx, on);
      else if (on)
        fma_chunk<true>(acc, As, Xs, ty, tx, on);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = r0 + sum_row(ty, i);
    float* yr = y + r * D + c0;
    if (!EDGE) {
      *reinterpret_cast<float4*>(yr + tx * 4) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(yr + 64 + tx * 4) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      continue;
    }
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4;
      if (c0 + c < D) yr[c] = acc[i][j];
    }
  }
}

template <typename T>
static void launch(const int* mask, const T* a, const T* x, float* y, int M, int K, int D,
                   int BM, int BK, cudaStream_t stream) {
  const long long blocks = (long long)((M + TM - 1) / TM) * ((D + TN - 1) / TN);
  const bool grid_aligned = BM % TM == 0 && BK % TK == 0 && D % TN == 0 &&
                            (uintptr_t)a % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                            (uintptr_t)y % 16 == 0;
  if (grid_aligned)
    block_spmm_kernel<T, false><<<(unsigned)blocks, THREADS, 0, stream>>>(mask, a, x, y, M, K,
                                                                         D, BM, BK);
  else
    block_spmm_kernel<T, true><<<(unsigned)blocks, THREADS, 0, stream>>>(mask, a, x, y, M, K,
                                                                        D, BM, BK);
}

// dtype: 0 = f32, 1 = bf16 (A and X alike); Y is always f32.
extern "C" int block_spmm_launch(const void* mask, const void* a, const void* x,
                                 int dtype, int M, int K, int D, int BM, int BK,
                                 int BD, void* y, void* stream, int device) {
  if (M < 1 || K < 1 || D < 1 || BM < 1 || BK < 1 || BD < 1 || M % BM || K % BK ||
      D % BD || (dtype != 0 && dtype != 1) ||
      (long long)((M + TM - 1) / TM) * ((D + TN - 1) / TN) > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  if (dtype == 0)
    launch((const int*)mask, (const float*)a, (const float*)x, (float*)y, M, K, D, BM, BK,
           (cudaStream_t)stream);
  else
    launch((const int*)mask, (const __nv_bfloat16*)a, (const __nv_bfloat16*)x, (float*)y, M,
           K, D, BM, BK, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
