// pred_gather_dac: DAC(b=8) SP/OP index decode -> candidate predicates.
//
// Replaces the Pallas kernel `pred_gather_dac`
// (src/repro/kernels/pred_gather.py:218, body `_make_dac_kernel` :130).
// Lane q decodes entity row rows[q] (pre-clipped to the index range) into
// ids[q, 0..cap) ascending 0-based predicate ids, valid[q, :] a prefix
// mask, count = min(deg, cap), overflow = deg > cap.
//
// Bound on the card: three dependent rounds a row (its index, its block's
// degree words and anchor, its chunk bytes) plus one a further DAC level,
// and a cap-wide output row; with cap = u_width (14 at geonames size) and a
// few hundred rows a batch the launch is latency-bound.
//
// Design: one warp a row, so that no round is repeated per slot or per row
// of a block.
// - One round loads the row's block: thread i the packed-degree word of
//   row i of the block (rows_per_block <= 32 a pass; threads of one word
//   share its transaction) and thread 0 the block's anchor.  A warp sum of
//   the degrees before the row gives its start; its own degree comes from
//   the same words.
// - The slots are decoded 32 at a time, slot j on thread j: its level-0
//   chunk byte and, for a DAC of more levels, its continuation flag word
//   and flag rank at the same index, loaded together; each further level
//   is one more round for the 32 slots at once, and a level that no slot
//   continues into is skipped.
// - An inclusive warp scan (__shfl_up_sync) of the gaps gives the
//   ascending ids; its total carries into the next 32 slots when cap > 32.
//   The warp writes 32 ids and 32 valid flags a store, coalesced.
// A block holds 1–4 warps (ops._warp_lane_grid), as few as spread a small
// batch over every SM.
#include "k2_common.cuh"

#define DAC_MAX_LEVELS 8

struct DacGeom {
  int levels;
  int level_byte_start[DAC_MAX_LEVELS];
  int flag_word_start[DAC_MAX_LEVELS];
  int deg_width;
  int rows_per_block;
};

__device__ __forceinline__ int byte_at(const unsigned* words, int n_words, int bidx) {
  const unsigned w = words[clampi(bidx >> 2, 0, n_words - 1)];
  return (int)((w >> (unsigned)((bidx & 3) * 8)) & 0xFFu);
}

#define DAC_FULL 0xffffffffu

__global__ void __launch_bounds__(128) pred_gather_dac_warp_kernel(
    const int* __restrict__ rows, int Q, const int* __restrict__ anchors,
    int n_anchors, const unsigned* __restrict__ words, int n_words,
    const unsigned* __restrict__ degs, int n_degs,
    const unsigned* __restrict__ flags, int n_flags,
    const int* __restrict__ frank, DacGeom g, int cap, int* __restrict__ ids,
    bool* __restrict__ valid, int* __restrict__ count,
    bool* __restrict__ overflow) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= Q) return;  // warp-uniform
  const int row = rows[q];
  const int dw = g.deg_width;
  const int per_word = 32 / dw;
  const unsigned dmask = dw < 32 ? (1u << dw) - 1u : 0xFFFFFFFFu;
  const int block = floordiv_pos(row, g.rows_per_block);
  const int within = floormod_pos(row, g.rows_per_block);
  const int w0 = wmul(block, 4);

  // the block's degree words (row idx on thread idx % 32) and its anchor
  const int anchor = lane == 0 ? anchors[clampi(block, 0, n_anchors - 1)] : 0;
  unsigned before = 0, own = 0;
  for (int idx = lane; idx <= within; idx += 32) {
    const unsigned dword = degs[clampi(wadd(w0, idx / per_word), 0, n_degs - 1)];
    const unsigned d = (dword >> (unsigned)((idx % per_word) * dw)) & dmask;
    if (idx < within) {
      before += d;
    } else {
      own = d;
    }
  }
  const int start = (int)((unsigned)__shfl_sync(DAC_FULL, anchor, 0) +
                          __reduce_add_sync(DAC_FULL, before));
  const int deg = (int)__reduce_add_sync(DAC_FULL, own);
  const int n = deg < cap ? deg : cap;

  int* out_ids = ids + (size_t)q * cap;
  bool* out_valid = valid + (size_t)q * cap;
  int carry = 0;  // the gaps of the slots before this chunk
  for (int j0 = 0; j0 < cap; j0 += 32) {
    const int j = j0 + lane;
    const bool live = j < n;
    int gap = 0;
    if (j0 < n) {  // warp-uniform
      int pos = live ? wadd(start, j) : 0;
      gap = byte_at(words, n_words, wadd(g.level_byte_start[0], pos));
      bool alive = live;
      for (int lvl = 0; lvl + 1 < g.levels; ++lvl) {
        const int fidx = clampi(wadd(g.flag_word_start[lvl], pos >> 5), 0, n_flags - 1);
        const unsigned fw = flags[fidx];
        const int fr = frank[fidx];
        alive = alive && bit_of(fw, pos);
        if (!__any_sync(DAC_FULL, alive)) break;
        pos = alive ? wadd(fr, popc_below(fw, pos)) : 0;
        const int chunk = byte_at(words, n_words, wadd(g.level_byte_start[lvl + 1], pos));
        // a shift past the word gives 0, as the reference's does
        if (alive && lvl < 3) gap = wadd(gap, (int)((unsigned)chunk << (8 * (lvl + 1))));
      }
      gap = live ? gap : 0;
    }
    int incl = gap;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(DAC_FULL, incl, d);
      if (lane >= d) incl = wadd(incl, y);
    }
    if (j < cap) {
      out_ids[j] = live ? wsub(wadd(carry, incl), 1) : 0;
      out_valid[j] = live;
    }
    carry = wadd(carry, __shfl_sync(DAC_FULL, incl, 31));
  }
  if (lane == 0) {
    count[q] = n;
    overflow[q] = deg > cap;
  }
}

extern "C" int pred_gather_dac_launch(
    const void* rows, int Q, const void* anchors, int n_anchors,
    const void* words, int n_words, const void* degs, int n_degs,
    const void* flags, int n_flags, const void* frank, int levels,
    const int* level_byte_start, const int* flag_word_start, int deg_width,
    int rows_per_block, int cap, int blocks, int threads, void* ids,
    void* valid, void* count, void* overflow, void* stream, int device) {
  if (levels < 1 || levels > DAC_MAX_LEVELS || cap < 1 || Q < 1 ||
      rows_per_block < 1 || blocks < 1 || threads < 32 || threads > 128 ||
      threads % 32 || (long long)blocks * (threads / 32) < Q ||
      !(deg_width == 4 || deg_width == 8 || deg_width == 16 || deg_width == 32))
    return (int)cudaErrorInvalidValue;
  DacGeom g;
  g.levels = levels;
  for (int i = 0; i < DAC_MAX_LEVELS; ++i) {
    g.level_byte_start[i] = i < levels ? level_byte_start[i] : 0;
    g.flag_word_start[i] = i + 1 < levels ? flag_word_start[i] : 0;
  }
  g.deg_width = deg_width;
  g.rows_per_block = rows_per_block;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  pred_gather_dac_warp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)rows, Q, (const int*)anchors, n_anchors,
      (const unsigned*)words, n_words, (const unsigned*)degs, n_degs,
      (const unsigned*)flags, n_flags, (const int*)frank, g, cap, (int*)ids,
      (bool*)valid, (int*)count, (bool*)overflow);
  return (int)cudaGetLastError();
}
