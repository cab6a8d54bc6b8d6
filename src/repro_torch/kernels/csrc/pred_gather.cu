// pred_gather: fixed-layout SP/OP index gather -> candidate predicates.
//
// Replaces the Pallas kernel `pred_gather` (src/repro/kernels/pred_gather.py:85,
// body `_make_kernel` :55).  Lane q reads entity row rows[q] (clipped to
// the index range) of a CSR whose entries are packed at bytes_per_pred ∈
// {1, 2, 4} bytes into uint32 words: ids[q, j] = entry offsets[row] + j for
// j < min(deg, cap) (ascending 0-based predicate ids, as stored), valid a
// prefix mask, dead slots 0, count = min(deg, cap), overflow = deg > cap.
//
// Bound on the card: three dependent rounds a row (its index, its two
// offsets, its entry word) and a cap-wide output row; with cap = u_width
// (14 at geonames size) and a few hundred rows a batch the launch is
// latency-bound: its time is the launch and the three rounds.
//
// Design: one thread per (row, slot), 256 a block.  Each thread
// reads the row's index and two offsets (one transaction for the row's
// cap threads, through L1), computes its entry's byte address
// elem·bytes_per_pred, reads the word (index clipped to the arena as the
// reference's gather) and shifts/masks the entry out.  Thread j == 0 of a
// row writes count and overflow.  No entry straddles a word, since
// bytes_per_pred divides 4.  One warp a row (in blocks of 1–16 warps)
// and one thread a row were measured slower on the H100 (PERF.md,
// `kernel_variants.py`): at this size every instruction on the
// three rounds' path counts, and this design has the fewest.
#include "k2_common.cuh"

__global__ void pred_gather_kernel(
    const int* __restrict__ rows, int Q, const int* __restrict__ offsets,
    int n_offsets, const unsigned* __restrict__ words, int n_words, int bpp,
    int cap, int* __restrict__ ids, bool* __restrict__ valid,
    int* __restrict__ count, bool* __restrict__ overflow) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)Q * cap) return;
  const int q = (int)(t / cap);
  const int j = (int)(t - (long long)q * cap);
  const int row = clampi(rows[q], 0, n_offsets - 2);
  const int start = offsets[row];
  const int deg = offsets[row + 1] - start;
  const int n = deg < cap ? deg : cap;
  const bool v = j < n;
  const int elem = v ? wadd(start, j) : 0;
  const int bidx = wmul(elem, bpp);
  const unsigned w = words[clampi(bidx >> 2, 0, n_words - 1)];
  const unsigned mask = bpp == 4 ? 0xFFFFFFFFu : (1u << (8 * bpp)) - 1u;
  const int pred = (int)((w >> (unsigned)((bidx & 3) * 8)) & mask);
  ids[t] = v ? pred : 0;
  valid[t] = v;
  if (j == 0) {
    count[q] = n;
    overflow[q] = deg > cap;
  }
}

extern "C" int pred_gather_launch(
    const void* rows, int Q, const void* offsets, int n_offsets,
    const void* words, int n_words, int bytes_per_pred, int cap, void* ids,
    void* valid, void* count, void* overflow, void* stream, int device) {
  if (cap < 1 || Q < 1 || n_offsets < 2 || n_words < 1 ||
      !(bytes_per_pred == 1 || bytes_per_pred == 2 || bytes_per_pred == 4))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)Q * cap;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  pred_gather_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)rows, Q, (const int*)offsets, n_offsets,
      (const unsigned*)words, n_words, bytes_per_pred, cap, (int*)ids,
      (bool*)valid, (int*)count, (bool*)overflow);
  return (int)cudaGetLastError();
}
