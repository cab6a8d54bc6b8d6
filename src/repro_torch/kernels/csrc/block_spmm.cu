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
// Three kernels; the wrapper (`ops._spmm_variant`) picks one and its tile
// and passes the choice in, and the launcher refuses a choice whose shape
// conditions do not hold.  Each output tile lies in one mask row (its row
// count divides BM), so a block walks that row once and touches only the
// ON k-tiles, in ascending order (a fixed reduction order: a rerun gives
// the same bits).
//
// * WGMMA (bf16; BM a multiple of 64, BK of 16, D of the N tile, A and X
//   16-byte aligned).  Warp-specialised: one producer warp walks the mask
//   row and issues TMA loads (`cp.async.bulk.tensor`, 128-byte swizzle for
//   X and for A's 64-wide k chunks, 32-byte for 16-wide ones) of only the
//   ON k chunks of A and the matching X row bands into a 4-stage
//   shared-memory ring guarded by full/empty `mbarrier`s; one or two
//   consumer warpgroups (64 output rows each) run `wgmma.mma_async`
//   m64nNk16 (bf16 in, f32 accumulate in registers).  A is K-major; X is
//   row-major, i.e. MN-major for B, read through the descriptor's
//   transpose-B bit (no transpose pass).  Tiles 128 x 256|128 and
//   64 x 256|128|64.
// * FMA (f32; BM and D multiples of 64, BK of 16, 16-byte aligned).
//   64 x 64 output tiles: 64 threads of 8 x 8 sums where the grid gives
//   every SM four blocks or more, else 256 threads of 4 x 4 (more warps to
//   hide latency on a small grid); a `cp.async` double-buffered K loop in
//   chunks of 32 (16 when BK is not a multiple of 32).  Products are exact
//   f32 FMAs, never TF32.
// * SIMT (everything else: BM below the tile, shapes off the grid,
//   unaligned views).  128 x 128 tiles, each row looks up its own tile,
//   A's rows whose tile is off load as 0 and their sums skip the chunk,
//   rows, columns and k past the matrix or the mask tile load as 0; bf16
//   is widened to f32 in shared memory.
//
// Bound on the card: 2·BM·BK·D flops per ON tile at 989 TFLOP/s (bf16
// tensor cores) or 67 TFLOP/s (f32 FMA), or bytes: the ON tiles of A, X,
// f32 Y and the mask at 3.35 TB/s, whichever is larger.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// ---------------------------------------------------------------------------
// SIMT: any block sizes and alignment
// ---------------------------------------------------------------------------

#define TM 128  // SIMT tile rows, columns, k chunk and threads
#define TN 128
#define TK 16
#define SIMT_THREADS 256

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

template <typename T>
__global__ void __launch_bounds__(SIMT_THREADS) block_spmm_simt(
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
    if (!__syncthreads_or(a_on)) continue;
    unsigned on = 0;  // the thread's rows whose tile is on (bit i: row i)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long r = r0 + sum_row(ty, i);
      if (r < M && mask[(int)r / BM * (long long)nkb + ki] != 0) on |= 1u << i;
    }
    const int k_end = (ki + 1) * BK;
    for (int k0 = ki * BK; k0 < k_end; k0 += TK) {
      const int xk = k0 + x_row;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + a_k + j;
        v[j] = a_on && k < k_end ? to_f32(a[ar * K + k]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) As[a_k + j][a_row] = v[j];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + x_col + j;
        v[j] = xk < k_end && c < D ? to_f32(x[(long long)xk * D + c]) : 0.f;
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
    if (r >= M) continue;
    float* yr = y + r * D + c0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4;
      if (c0 + c < D) yr[c] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// FMA: f32 on the grid, cp.async double buffer
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// First ON k-tile at or after `ki` of a mask row (nkb when none is left).
__device__ __forceinline__ int next_on(const int* __restrict__ mrow, int ki, int nkb) {
  while (ki < nkb && mrow[ki] == 0) ++ki;
  return ki;
}

// 64 x 64 output tile, (64/TT)^2 threads, TT x TT sums each: rows
// ty*4 + (i%4) (+ 32 for i >= 4, when TT = 8), columns likewise, so every
// shared read is a float4.  The k loop runs in chunks of FKC through two
// shared-memory buffers filled by cp.async, the next chunk in flight while
// the current one is multiplied.  The minimum of 2 (TT = 4) or 4 (TT = 8)
// blocks an SM caps a thread at 128 or 255 registers.
#define FT 64
template <int TT, int FKC>
struct FmaCfg {
  static constexpr int THREADS = (FT / TT) * (FT / TT);
  static constexpr int A_STRIDE = FKC + 4;  // floats; + 4 against bank conflicts
  static constexpr int A_FLOATS = FT * A_STRIDE;
  static constexpr int X_FLOATS = FKC * FT;
  static constexpr int SMEM = 2 * (A_FLOATS + X_FLOATS) * 4;
};

template <int TT, int FKC>
__global__ void __launch_bounds__(FmaCfg<TT, FKC>::THREADS, TT == 8 ? 4 : 2) block_spmm_fma(
    const int* __restrict__ mask, const float* __restrict__ a, const float* __restrict__ x,
    float* __restrict__ y, int M, int K, int D, int BM, int BK) {
  using C = FmaCfg<TT, FKC>;
  constexpr int NT = C::THREADS;
  constexpr int H = FT / 2;
  extern __shared__ __align__(16) float fma_smem[];
  float* As = fma_smem;                    // [2][FT][A_STRIDE]
  float* Xs = fma_smem + 2 * C::A_FLOATS;  // [2][FKC][FT]
  const int t = threadIdx.x;
  const int tx = t % (FT / TT), ty = t / (FT / TT);
  const int ncol = D / FT;
  const long long r0 = (long long)(blockIdx.x / ncol) * FT;
  const int c0 = (blockIdx.x % ncol) * FT;
  const int nkb = K / BK;
  const int* mrow = mask + (r0 / BM) * nkb;  // one mask row for the whole tile
  const int chunks = BK / FKC;

  auto load = [&](int buf, int k0) {
#pragma unroll
    for (int j = 0; j < FT * FKC / 4 / NT; ++j) {  // A: FT rows x FKC/4 pieces of 16 B
      const int pi = t + j * NT;
      const int row = pi / (FKC / 4), c4 = (pi % (FKC / 4)) * 4;
      cp_async16(As + buf * C::A_FLOATS + row * C::A_STRIDE + c4, a + (r0 + row) * K + k0 + c4);
    }
#pragma unroll
    for (int j = 0; j < FT * FKC / 4 / NT; ++j) {  // X: FKC rows x FT/4 pieces
      const int pi = t + j * NT;
      const int row = pi / (FT / 4), c = (pi % (FT / 4)) * 4;
      cp_async16(Xs + buf * C::X_FLOATS + row * FT + c, x + (long long)(k0 + row) * D + c0 + c);
    }
    cp_async_commit();
  };
  auto row_of = [&](int i) { return (i / 4) * H + ty * 4 + i % 4; };

  float acc[TT][TT];
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TT; ++j) acc[i][j] = 0.f;

  int ki = next_on(mrow, 0, nkb), kc = 0;
  bool have = ki < nkb;
  if (have) {
    load(0, ki * BK);
    if (++kc == chunks) ki = next_on(mrow, ki + 1, nkb), kc = 0;
  }
  for (int buf = 0; have; buf ^= 1) {
    const bool more = ki < nkb;
    if (more) {
      load(buf ^ 1, ki * BK + kc * FKC);
      if (++kc == chunks) ki = next_on(mrow, ki + 1, nkb), kc = 0;
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Ab = As + buf * C::A_FLOATS;
    const float* Xb = Xs + buf * C::X_FLOATS;
#pragma unroll
    for (int kk = 0; kk < FKC; kk += 4) {
      float4 av[TT];
#pragma unroll
      for (int i = 0; i < TT; ++i)
        av[i] = *reinterpret_cast<const float4*>(Ab + row_of(i) * C::A_STRIDE + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float bv[TT];
#pragma unroll
        for (int h = 0; h < TT / 4; ++h) {
          const float4 b = *reinterpret_cast<const float4*>(Xb + (kk + u) * FT + h * H + tx * 4);
          bv[4 * h] = b.x, bv[4 * h + 1] = b.y, bv[4 * h + 2] = b.z, bv[4 * h + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < TT; ++i) {
          const float ai = u == 0 ? av[i].x : u == 1 ? av[i].y : u == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < TT; ++j) acc[i][j] = fmaf(ai, bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
    have = more;
  }
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    float* yr = y + (r0 + row_of(i)) * D + c0;
#pragma unroll
    for (int h = 0; h < TT / 4; ++h)
      *reinterpret_cast<float4*>(yr + h * H + tx * 4) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
  }
}

template <int TT, int FKC>
static int launch_fma(const int* mask, const float* a, const float* x, float* y, int M, int K,
                      int D, int BM, int BK, cudaStream_t stream) {
  using C = FmaCfg<TT, FKC>;  // at most 34,816 bytes: below the 48 KB default
  const unsigned blocks = (unsigned)((long long)(M / FT) * (D / FT));
  block_spmm_fma<TT, FKC><<<blocks, C::THREADS, C::SMEM, stream>>>(mask, a, x, y, M, K, D, BM,
                                                                    BK);
  return 0;
}

// ---------------------------------------------------------------------------
// WGMMA: bf16 on the grid, TMA ring, warp-specialised
// ---------------------------------------------------------------------------

#define STAGES 4

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait for the phase of parity `parity` to complete; trap (a launch error,
// not a hang) if it has not after ~2^32 cycles.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 32)) __trap();
  } while (!done);
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1 = 128 B, 2 = 64 B, 3 = 32 B).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)swizzle << 62;
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)
#define F32(i) F16(i), F16(i + 16)
#define F64(i) F32(i), F32(i + 32)
#define F128(i) F64(i), F64(i + 64)

// D[64 x N] += A[64 x 16] (K-major) · B[16 x N] (MN-major: transpose-B = 1)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : F32(0)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : F64(0)
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : F128(0)
      : "l"(da), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64) wgmma_n64(d, da, db);
  else if constexpr (N == 128) wgmma_n128(d, da, db);
  else wgmma_n256(d, da, db);
}

// Keep the compiler from touching the accumulators across async wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int WG, int BN, int KS>
struct WgmmaCfg {
  static constexpr int BMT = 64 * WG;                 // output rows a block
  static constexpr int A_BYTES = BMT * KS * 2;         // A chunk, K-major rows of KS
  static constexpr int X_BOX = KS * 128;               // X: KS rows x 64 columns
  static constexpr int STAGE = A_BYTES + (BN / 64) * X_BOX;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;  // + barriers, alignment
  static constexpr int THREADS = 128 * WG + 32;        // consumers + one producer warp
  static constexpr uint32_t A_SWIZZLE = KS == 64 ? 1 : 3;  // 128 B or 32 B rows
};

template <int WG, int BN, int KS>
__global__ void __launch_bounds__(WgmmaCfg<WG, BN, KS>::THREADS, 1) block_spmm_wgmma(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_x,
    const int* __restrict__ mask, float* __restrict__ y, int D, int K, int BM, int BK) {
  using C = WgmmaCfg<WG, BN, KS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * C::STAGE);
  uint64_t* empty = full + STAGES;
  const int ncol = D / BN;
  const int r0 = (blockIdx.x / ncol) * C::BMT;
  const int c0 = (blockIdx.x % ncol) * BN;
  const int nkb = K / BK;
  const int* mrow = mask + (long long)(r0 / BM) * nkb;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WG) {  // producer: TMA loads of the ON chunks only
    if (threadIdx.x % 32 == 0) {
      int c = 0;
      for (int ki = next_on(mrow, 0, nkb); ki < nkb; ki = next_on(mrow, ki + 1, nkb)) {
        for (int k0 = ki * BK; k0 < (ki + 1) * BK; k0 += KS, ++c) {
          const int s = c % STAGES;
          mbar_wait(&empty[s], ((c / STAGES) & 1) ^ 1);
          mbar_expect_tx(&full[s], C::STAGE);
          uint8_t* st = smem + s * C::STAGE;
          tma_load_2d(st, &map_a, k0, r0, &full[s]);
#pragma unroll
          for (int b = 0; b < BN / 64; ++b)
            tma_load_2d(st + C::A_BYTES + b * C::X_BOX, &map_x, c0 + 64 * b, k0, &full[s]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg takes output rows r0 + 64·wg ..
  const int wg = warp / 4;
  int n_chunks = 0;
  for (int ki = 0; ki < nkb; ++ki) n_chunks += mrow[ki] != 0;
  n_chunks *= BK / KS;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % STAGES;
    mbar_wait(&full[s], (c / STAGES) & 1);
    const uint32_t a_base = smem_u32(smem + s * C::STAGE) + wg * 64 * KS * 2;
    const uint32_t x_base = smem_u32(smem + s * C::STAGE + C::A_BYTES);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KS / 16; ++kk) {
      // A: 16 k = 32 B along a swizzled row; 8-row groups KS·2·8 B apart.
      // X: 16 k = 16 rows of 128 B; 8-row groups 1024 B apart, 64-column
      // boxes X_BOX apart.
      const uint64_t da = gmma_desc(a_base + kk * 32, 16, 16 * KS, C::A_SWIZZLE);
      const uint64_t db = gmma_desc(x_base + kk * 2048, C::X_BOX, 1024, 1);
      wgmma<BN>(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    mbar_arrive(&empty[s]);
  }
  // accumulator layout of m64nN: warp w of the group holds rows 16w + lane/4
  // and + 8; n8 chunk j holds columns 8j + 2·(lane%4) + {0, 1}
  const int lane = threadIdx.x % 32, wq = warp % 4;
  const long long row = r0 + wg * 64 + wq * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = c0 + 8 * j + 2 * (lane % 4);
    *reinterpret_cast<float2*>(y + row * D + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(y + (row + 8) * D + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major bf16 matrix (rows x cols) read in boxes of box_rows x box_cols.
static int bf16_map(CUtensorMap* map, const void* base, long long rows, long long cols,
                    int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int WG, int BN, int KS>
static int launch_wgmma(const int* mask, const void* a, const void* x, float* y, int M, int K,
                        int D, int BM, int BK, cudaStream_t stream) {
  using C = WgmmaCfg<WG, BN, KS>;
  CUtensorMap map_a, map_x;
  int err = bf16_map(&map_a, a, M, K, C::BMT, KS,
                     KS == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B);
  if (err) return err;
  err = bf16_map(&map_x, x, K, D, KS, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  auto kernel = block_spmm_wgmma<WG, BN, KS>;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err) return err;
  const long long blocks = (long long)(M / C::BMT) * (D / BN);
  kernel<<<(unsigned)blocks, C::THREADS, C::SMEM, stream>>>(map_a, map_x, mask, y, D, K, BM, BK);
  return 0;
}

// The five tiles `ops._spmm_variant` chooses from, at k chunks of 64 or 16.
template <int KS>
static int launch_wgmma_tile(int tm, int tn, const int* mask, const void* a, const void* x,
                             float* y, int M, int K, int D, int BM, int BK, cudaStream_t s) {
  if (tm == 128 && tn == 256) return launch_wgmma<2, 256, KS>(mask, a, x, y, M, K, D, BM, BK, s);
  if (tm == 128 && tn == 128) return launch_wgmma<2, 128, KS>(mask, a, x, y, M, K, D, BM, BK, s);
  if (tm == 64 && tn == 256) return launch_wgmma<1, 256, KS>(mask, a, x, y, M, K, D, BM, BK, s);
  if (tm == 64 && tn == 128) return launch_wgmma<1, 128, KS>(mask, a, x, y, M, K, D, BM, BK, s);
  if (tm == 64 && tn == 64) return launch_wgmma<1, 64, KS>(mask, a, x, y, M, K, D, BM, BK, s);
  return (int)cudaErrorInvalidValue;
}

static bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// dtype: 0 = f32, 1 = bf16 (A and X alike); Y is always f32.
// variant (tile tm x tn, k chunk ks, threads a block): 0 = SIMT (128 x 128,
// 16, 256); 1 = FMA (64 x 64, 16 or 32, 64 threads of 8 x 8 sums or 256 of
// 4 x 4); 2 = WGMMA (tm x tn 128 x 256|128 or 64 x 256|128|64, ks 16 or 64,
// 2·tm + 32 threads).  A variant whose shape conditions fail is refused, never
// replaced by another.
extern "C" int block_spmm_launch(const void* mask, const void* a, const void* x, int dtype,
                                 int M, int K, int D, int BM, int BK, int BD, int variant,
                                 int tm, int tn, int ks, int threads, void* y, void* stream,
                                 int device) {
  if (M < 1 || K < 1 || D < 1 || BM < 1 || BK < 1 || BD < 1 || M % BM || K % BK || D % BD ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int* m = (const int*)mask;
  float* out = (float*)y;
  cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  if (variant == 0) {
    if (tm != TM || tn != TN || ks != TK || threads != SIMT_THREADS)
      return (int)cudaErrorInvalidValue;
    const long long blocks = (long long)((M + TM - 1) / TM) * ((D + TN - 1) / TN);
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      block_spmm_simt<float><<<(unsigned)blocks, SIMT_THREADS, 0, s>>>(
          m, (const float*)a, (const float*)x, out, M, K, D, BM, BK);
    else
      block_spmm_simt<__nv_bfloat16><<<(unsigned)blocks, SIMT_THREADS, 0, s>>>(
          m, (const __nv_bfloat16*)a, (const __nv_bfloat16*)x, out, M, K, D, BM, BK);
  } else if (variant == 1) {
    if (dtype != 0 || tm != FT || tn != FT || (threads != 64 && threads != 256) ||
        (ks != 16 && ks != 32) || BM % tm || BK % ks || D % tn || !aligned16(a) ||
        !aligned16(x) || !aligned16(y) || (long long)(M / tm) * (D / tn) > 0x7FFFFFFFLL)
      return (int)cudaErrorInvalidValue;
    const float *af = (const float*)a, *xf = (const float*)x;
    if (threads == 64)
      err = ks == 32 ? launch_fma<8, 32>(m, af, xf, out, M, K, D, BM, BK, s)
                     : launch_fma<8, 16>(m, af, xf, out, M, K, D, BM, BK, s);
    else
      err = ks == 32 ? launch_fma<4, 32>(m, af, xf, out, M, K, D, BM, BK, s)
                     : launch_fma<4, 16>(m, af, xf, out, M, K, D, BM, BK, s);
    if (err) return err;
  } else if (variant == 2) {
    if (dtype != 1 || (tm != 64 && tm != 128) || (tn != 64 && tn != 128 && tn != 256) ||
        (ks != 16 && ks != 64) || threads != 2 * tm + 32 || BM % tm || BK % ks || D % tn ||
        !aligned16(a) || !aligned16(x) || !aligned16(y) ||
        (long long)(M / tm) * (D / tn) > 0x7FFFFFFFLL)
      return (int)cudaErrorInvalidValue;
    err = ks == 64 ? launch_wgmma_tile<64>(tm, tn, m, a, x, out, M, K, D, BM, BK, s)
                   : launch_wgmma_tile<16>(tm, tn, m, a, x, out, M, K, D, BM, BK, s);
    if (err) return err;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
