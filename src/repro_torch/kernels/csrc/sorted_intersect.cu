// sorted_intersect_mask: membership of every lane of one id list in a
// sorted other.
//
// Replaces the Pallas kernel `sorted_intersect_mask`
// (src/repro/kernels/sorted_intersect.py:46, body `_make_kernel` :25), a
// vectorised binary search of each A lane in a VMEM-resident B.  For an
// ascending, SENTINEL (2^31-1)-padded int32 B and any int32 A:
// out[i] = b[lo] == a[i] && a[i] != SENTINEL, where lo is the lower bound
// of a[i] in b (the first lane with b[lo] >= a[i]), clipped to cb-1 — as
// `torch.searchsorted` gives it.  Negative ids, ids above max(b) and
// repeated values in b need nothing special.  The search is a full one:
// the Pallas kernel stops after ceil(log2 cb) steps, one short when cb is
// a power of two, and misses b[0] < a == b[1]; this kernel does not.
//
// Bound on the card: latency.  A lane's binary search in global memory is
// a chain of ~log2 cb dependent L2 reads (~20 at a store's 530k ids), where
// the bytes (4 B a lane of A and of B, 1 B out) take a few µs at most.
// What costs is each round of dependent loads and, within a round, loads
// to distinct lines; so rounds are few and spread over a block.
//
// Design (kernel 0, a tile): a block takes 4·blockDim A lanes (thread t
// lanes 4t..4t+3, one 16-byte load) and stages in shared memory the span
// of B that its lanes' lower bounds fall in; each lane searches there.
// - B of at most `window` ids is the span as a whole: copied beside the A
//   load, no search.
// - Else each thread also loads SI_SAMPLE_PER_THREAD ids of B at equal
//   spacing beside its A lanes (the same sample in every block).  The span
//   brackets [lower_bound(b, min), lower_bound(b, max + 1)) over the
//   block's non-SENTINEL lanes (min and max, not the first and last lane,
//   so that A need not be sorted).  Warp 0 brackets both ends in the
//   sample, in shared memory, then by a wide search in global memory: a
//   round reads 2^SI_SPLIT_LOG - 1 equally spaced ids of each end's
//   bracket, all in flight together, and a ballot count picks the
//   sub-interval.  Rounds go on until the brackets together are at most
//   SI_SLACK ids wide (one round at 530k ids) or the span is sure to exceed
//   `window`.  Every lane's lower bound lies between the brackets' outer
//   ends, so that range is the span.
// - A span of at most `window` ids is copied in with 16-byte loads, up to
//   SI_COPY_BATCH a thread in flight.  Each thread searches it in shared
//   memory, branchless and interleaved: if its 4 lanes ascend, the outer
//   two over the span, then the inner two between the outer two's lower
//   bounds (a sorted tile reads about half as many ids), else all four
//   over the span.
// - A larger span (unsorted A, or a stretch of A sparse in B) stays in
//   global memory: each lane brackets its id in the sample and takes the
//   last log2(cb / sample) steps in global memory.
// - A block with no non-SENTINEL lane writes zeros.  A thread writes its 4
//   output bytes as one word.
// Kernel 1, a thread a lane, for short launches (a few lanes an SM), whose
// time is latency, and for shapes whose tiles would span more of B than
// the window (A sparse in B): the block's sample of B (one id a thread,
// loaded beside A) in shared memory stands for the search's top levels,
// then each lane takes its last steps in global memory.
// The host picks the kernel, threads a block (a power of two), blocks and
// `window` from (ca, cb, the SM count): ops._intersect_plan.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define SENTINEL 0x7FFFFFFF
#define SI_FULL 0xffffffffu
#define SI_MAX_THREADS 256
#define SI_SPLIT_LOG 5  // a wide-search round reads 2^SI_SPLIT_LOG - 1 ids an end
#define SI_SLACK 256  // bracket widths, summed, at which the wide search stops
#define SI_SAMPLE_PER_THREAD 1  // ids of B's sample a thread loads (a power of two)
#define SI_LANE_SAMPLE_PER_THREAD 1  // kernel 1's sample ids a thread (a power of two)
#define SI_COPY_BATCH 1  // 16-byte loads of a copy a thread has in flight
#define SI_SPLITTERS ((1 << SI_SPLIT_LOG) - 1)
#define SI_PER_LANE ((SI_SPLITTERS + 31) / 32)

// Lower bounds of v[0..L) in ascending w[0, n), n >= 1: the branchless
// halving, whose step count depends on n alone, L searches interleaved.
template <int L>
__device__ __forceinline__ void lower_bounds(const int* w, int n, const int (&v)[L],
                                             int (&pos)[L]) {
  int base[L];
#pragma unroll
  for (int k = 0; k < L; ++k) base[k] = 0;
  while (n > 1) {
    const int half = n >> 1;
#pragma unroll
    for (int k = 0; k < L; ++k) base[k] = w[base[k] + half] < v[k] ? base[k] + half : base[k];
    n -= half;
  }
#pragma unroll
  for (int k = 0; k < L; ++k) pos[k] = base[k] + (w[base[k]] < v[k]);
}

// Id i (0 <= i < 2^lg - 1) of the 2^lg - 1 equally spaced ids of
// [lo, lo + n): ascending, inside the interval, strictly so if n >= 2^lg.
__device__ __forceinline__ int spaced(int lo, int n, int i, int lg) {
  return lo + (int)(((long long)(i + 1) * n) >> lg);
}

// B's sample of 2^lg - 1 ids into shared memory, `per` a thread.
template <int per>
__device__ __forceinline__ void load_sample(const int* __restrict__ b, int cb, int lg,
                                            int* sample) {
  int y[per];
  const int ns = (1 << lg) - 1;
#pragma unroll
  for (int k = 0; k < per; ++k) {
    const int i = k * blockDim.x + threadIdx.x;
    y[k] = b[spaced(0, cb, min(i, ns - 1), lg)];
  }
#pragma unroll
  for (int k = 0; k < per; ++k) {
    const int i = k * blockDim.x + threadIdx.x;
    if (i < ns) sample[i] = y[k];
  }
}

// Members among v[0..L) by the sample of 2^lg - 1 ids of b (shared
// memory) and then the last steps in global memory.  An id equal to v met
// on the way is the one at v's lower bound.
template <int L>
__device__ __forceinline__ void global_members(const int* __restrict__ b, int cb,
                                               const int* sample, int lg, const int (&v)[L],
                                               bool (&m)[L]) {
  const int ns = (1 << lg) - 1;
  int c[L], lo[L], n[L];
  lower_bounds<L>(sample, ns, v, c);
#pragma unroll
  for (int k = 0; k < L; ++k) {
    m[k] = c[k] < ns && sample[c[k]] == v[k];
    lo[k] = c[k] > 0 ? spaced(0, cb, c[k] - 1, lg) + 1 : 0;
    n[k] = (c[k] < ns ? spaced(0, cb, c[k], lg) : cb) - lo[k];
  }
  for (bool more = true; more;) {
    more = false;
    int y[L];
#pragma unroll
    for (int k = 0; k < L; ++k) y[k] = b[n[k] > 0 ? lo[k] + (n[k] >> 1) : 0];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      if (n[k] > 0) {
        const int half = n[k] >> 1;
        if (y[k] < v[k]) {
          lo[k] += half + 1;
          n[k] -= half + 1;
        } else {
          m[k] = m[k] || y[k] == v[k];
          n[k] = half;
        }
        more = more || n[k] > 0;
      }
    }
  }
}

// One round of the wide search for two lower bounds at once (warp-wide):
// lower_bound(b, x[e]) lies in [lo[e], hi[e]] before and after.
__device__ __forceinline__ void narrow2(const int* __restrict__ b, const int (&x)[2],
                                        int (&lo)[2], int (&hi)[2], int lane) {
  int y[2][SI_PER_LANE];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int n = hi[e] - lo[e];
#pragma unroll
    for (int k = 0; k < SI_PER_LANE; ++k) {
      const int i = k * 32 + lane;
      // an id past a short interval, or past the splitters, reads some id
      // of b and is not counted
      const bool on = i < n && i < SI_SPLITTERS;
      y[e][k] = b[on ? (n <= SI_SPLITTERS ? lo[e] + i : spaced(lo[e], n, i, SI_SPLIT_LOG))
                     : lo[e] - (lo[e] > 0)];
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int n = hi[e] - lo[e];
    if (n == 0) continue;  // warp-uniform
    int c = 0;
#pragma unroll
    for (int k = 0; k < SI_PER_LANE; ++k) {
      const int i = k * 32 + lane;
      c += __popc(__ballot_sync(SI_FULL, i < n && i < SI_SPLITTERS && y[e][k] < x[e]));
    }
    if (n <= SI_SPLITTERS) {
      lo[e] = hi[e] = lo[e] + c;
    } else {
      const int l = c > 0 ? spaced(lo[e], n, c - 1, SI_SPLIT_LOG) + 1 : lo[e];
      hi[e] = c < SI_SPLITTERS ? spaced(lo[e], n, c, SI_SPLIT_LOG) : hi[e];
      lo[e] = l;
    }
  }
}

// b[first, first + len) into win[first & 3 ...]: 16-byte loads of whole
// quads of b where b is 16-byte aligned, SI_COPY_BATCH a thread at once.
__device__ __forceinline__ void copy_span(const int* __restrict__ b, int cb, int first, int len,
                                          int* win, bool b16) {
  const int off = first & 3;
  const int base = first - off;
  const int quads = (off + len + 3) >> 2;
  for (int q0 = 0; q0 < quads; q0 += SI_COPY_BATCH * blockDim.x) {
    int4 r[SI_COPY_BATCH];
#pragma unroll
    for (int k = 0; k < SI_COPY_BATCH; ++k) {
      const int qi = q0 + k * blockDim.x + threadIdx.x;
      const int g = base + 4 * qi;
      if (qi < quads) {
        if (b16 && g <= cb - 4) {
          r[k] = __ldg(reinterpret_cast<const int4*>(b + g));
        } else {  // ids past cb are never read back
          r[k].x = g < cb ? b[g] : 0;
          r[k].y = g + 1 < cb ? b[g + 1] : 0;
          r[k].z = g + 2 < cb ? b[g + 2] : 0;
          r[k].w = g + 3 < cb ? b[g + 3] : 0;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < SI_COPY_BATCH; ++k) {
      const int qi = q0 + k * blockDim.x + threadIdx.x;
      if (qi < quads) reinterpret_cast<int4*>(win)[qi] = r[k];
    }
  }
}

__global__ void __launch_bounds__(SI_MAX_THREADS) sorted_intersect_tile_kernel(
    const int* __restrict__ a, int ca, const int* __restrict__ b, int cb,
    unsigned char* __restrict__ out, int window) {
  extern __shared__ int4 smem4[];
  int* win = reinterpret_cast<int*>(smem4);
  __shared__ int sample[SI_SAMPLE_PER_THREAD * SI_MAX_THREADS];
  __shared__ int s_min[SI_MAX_THREADS / 32], s_max[SI_MAX_THREADS / 32];
  __shared__ int s_span[3];  // first id, ids, mode
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const bool b16 = ((uintptr_t)b & 15) == 0;
  const int lg = __ffs(SI_SAMPLE_PER_THREAD * blockDim.x) - 1;  // the sample's 2^lg - 1 ids

  int v[4];
  if (((uintptr_t)a & 15) == 0 && i0 + 3 < ca) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(a + i0));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i0 + k < ca ? a[i0 + k] : SENTINEL;
  }

  // mode 0: no lane to search; 1: the span in shared memory; 2: global
  int first = 0, len = cb, mode = 1;
  if (cb <= window) {
    copy_span(b, cb, 0, cb, win, b16);
  } else {
    load_sample<SI_SAMPLE_PER_THREAD>(b, cb, lg, sample);
    int mn = INT_MAX, mx = INT_MIN;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (v[k] != SENTINEL) {
        mn = min(mn, v[k]);
        mx = max(mx, v[k]);
      }
    }
    mn = __reduce_min_sync(SI_FULL, mn);
    mx = __reduce_max_sync(SI_FULL, mx);
    if (lane == 0) s_min[warp] = mn, s_max[warp] = mx;
    __syncthreads();
    if (warp == 0) {
      const int nw = blockDim.x >> 5;
      mn = __reduce_min_sync(SI_FULL, lane < nw ? s_min[lane] : INT_MAX);
      mx = __reduce_max_sync(SI_FULL, lane < nw ? s_max[lane] : INT_MIN);
      if (mn > mx) {
        mode = 0;
      } else {
        const int x[2] = {mn, mx + 1};  // mx < SENTINEL: no overflow
        const int ns = (1 << lg) - 1;
        int c[2], lo[2], hi[2];
        lower_bounds<2>(sample, ns, x, c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          lo[e] = c[e] > 0 ? spaced(0, cb, c[e] - 1, lg) + 1 : 0;
          hi[e] = c[e] < ns ? spaced(0, cb, c[e], lg) : cb;
        }
        while ((long long)(hi[0] - lo[0]) + (hi[1] - lo[1]) > SI_SLACK &&
               (long long)lo[1] - hi[0] <= window)
          narrow2(b, x, lo, hi, lane);
        first = lo[0];
        len = max(hi[1] - lo[0], 0);
        mode = len <= window ? 1 : 2;
      }
      if (lane == 0) s_span[0] = first, s_span[1] = len, s_span[2] = mode;
    }
    __syncthreads();
    first = s_span[0], len = s_span[1], mode = s_span[2];
    if (mode == 1) copy_span(b, cb, first, len, win, b16);
  }
  __syncthreads();

  bool m[4] = {false, false, false, false};
  if (mode == 1 && len > 0) {
    const int* w = win + (first & 3);
    int pos[4];
    if (v[0] <= v[1] && v[1] <= v[2] && v[2] <= v[3]) {
      // the outer lanes' lower bounds bracket the inner lanes'
      const int ve[2] = {v[0], v[3]};
      int e[2];
      lower_bounds<2>(w, len, ve, e);
      pos[0] = pos[1] = pos[2] = e[0];
      pos[3] = e[1];
      if (e[1] > e[0]) {
        const int vi[2] = {v[1], v[2]};
        int in[2];
        lower_bounds<2>(w + e[0], e[1] - e[0], vi, in);
        pos[1] += in[0];
        pos[2] += in[1];
      }
    } else {
      lower_bounds<4>(w, len, v, pos);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = pos[k] < len && w[pos[k]] == v[k];
  } else if (mode == 2) {
    global_members<4>(b, cb, sample, lg, v, m);
  }

  unsigned word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) word |= (unsigned)(m[k] && v[k] != SENTINEL) << (8 * k);
  if (i0 + 3 < ca && ((uintptr_t)out & 3) == 0) {
    *reinterpret_cast<unsigned*>(out + i0) = word;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (i0 + k < ca) out[i0 + k] = (unsigned char)((word >> (8 * k)) & 1u);
  }
}

__global__ void __launch_bounds__(SI_MAX_THREADS) sorted_intersect_lane_kernel(
    const int* __restrict__ a, int ca, const int* __restrict__ b, int cb,
    unsigned char* __restrict__ out) {
  __shared__ int sample[SI_LANE_SAMPLE_PER_THREAD * SI_MAX_THREADS];
  const int lg = __ffs(SI_LANE_SAMPLE_PER_THREAD * blockDim.x) - 1;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  load_sample<SI_LANE_SAMPLE_PER_THREAD>(b, cb, lg, sample);
  const int v[1] = {i < ca ? a[i] : SENTINEL};
  __syncthreads();
  bool m[1];
  global_members<1>(b, cb, sample, lg, v, m);
  if (i < ca) out[i] = m[0] && v[0] != SENTINEL;
}

extern "C" int sorted_intersect_launch(const void* a, int ca, const void* b, int cb, void* out,
                                       int kernel, int threads, int blocks, int window,
                                       void* stream, int device) {
  const int lanes = kernel == 0 ? 4 : 1;
  if (ca < 1 || cb < 1 || kernel < 0 || kernel > 1 ||
      (kernel == 0 && (window < 1 || window > (INT_MAX >> 3))) || blocks < 1 ||
      threads < 32 || threads > SI_MAX_THREADS || (threads & (threads - 1)) ||
      (long long)blocks * threads * lanes < ca)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  if (kernel == 1) {
    sorted_intersect_lane_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int*)a, ca, (const int*)b, cb, (unsigned char*)out);
    return (int)cudaGetLastError();
  }
  // the span, rounded out to whole quads at both ends
  const size_t smem = ((size_t)window + 8) * sizeof(int);
  if (smem + SI_SAMPLE_PER_THREAD * SI_MAX_THREADS * sizeof(int) + 256 > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(sorted_intersect_tile_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  sorted_intersect_tile_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int*)a, ca, (const int*)b, cb, (unsigned char*)out, window);
  return (int)cudaGetLastError();
}
