// pred_gather_dac: DAC(b=8) SP/OP index decode -> candidate predicates.
//
// Replaces the Pallas kernel `pred_gather_dac`
// (src/repro/kernels/pred_gather.py:218, body `_make_dac_kernel` :130).
// Lane q decodes entity row rows[q] (pre-clipped to the index range) into
// ids[q, 0..cap) ascending 0-based predicate ids, valid[q, :] a prefix
// mask, count = min(deg, cap), overflow = deg > cap.
//
// Design: one thread per row.  The row pointer is the block anchor plus
// the deg_width-bit packed degrees before the row (a short SWAR loop over
// at most four words).  The thread then walks its lanes j < min(deg, cap)
// in order: the level-0 chunk byte, then, while the continuation flag is
// set, the flag's in-level rank (frank + __popc) addresses the next level's
// byte, which ors in at bits 8·level.  The running sum of the gaps is the
// prefix sum, so ids come out ascending without a second pass.
//
// Bound on the card: a handful of dependent gathers per row and a cap-wide
// output row per lane; with cap = u_width (14 at geonames size) and a
// few hundred rows per batch the launch is latency-bound.
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

__global__ void pred_gather_dac_kernel(
    const int* __restrict__ rows, int Q, const int* __restrict__ anchors,
    int n_anchors, const unsigned* __restrict__ words, int n_words,
    const unsigned* __restrict__ degs, int n_degs,
    const unsigned* __restrict__ flags, int n_flags,
    const int* __restrict__ frank, DacGeom g, int cap, int* __restrict__ ids,
    bool* __restrict__ valid, int* __restrict__ count,
    bool* __restrict__ overflow) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const int row = rows[q];
  const int dw = g.deg_width;
  const int per_word = 32 / dw;
  const unsigned dmask = dw < 32 ? (1u << dw) - 1u : 0xFFFFFFFFu;
  const int block = floordiv_pos(row, g.rows_per_block);
  const int within = floormod_pos(row, g.rows_per_block);
  const int w0 = block * 4;

  int start = anchors[clampi(block, 0, n_anchors - 1)];
  for (int idx = 0; idx < within; ++idx) {
    const unsigned dword = degs[clampi(w0 + idx / per_word, 0, n_degs - 1)];
    start = wadd(start, (int)((dword >> (unsigned)((idx % per_word) * dw)) & dmask));
  }
  const unsigned dword = degs[clampi(w0 + within / per_word, 0, n_degs - 1)];
  const int deg = (int)((dword >> (unsigned)((within % per_word) * dw)) & dmask);
  const int n = deg < cap ? deg : cap;

  int* out_ids = ids + (size_t)q * cap;
  bool* out_valid = valid + (size_t)q * cap;
  int acc = 0;
  for (int j = 0; j < cap; ++j) {
    if (j >= n) {
      out_ids[j] = 0;
      out_valid[j] = false;
      continue;
    }
    int pos = wadd(start, j);
    int gap = byte_at(words, n_words, g.level_byte_start[0] + pos);
    for (int lvl = 0; lvl + 1 < g.levels; ++lvl) {
      const int fidx = clampi(g.flag_word_start[lvl] + (pos >> 5), 0, n_flags - 1);
      const unsigned fw = flags[fidx];
      if (!bit_of(fw, pos)) break;
      pos = frank[fidx] + popc_below(fw, pos);
      const int chunk = byte_at(words, n_words, g.level_byte_start[lvl + 1] + pos);
      gap = wadd(gap, (int)((unsigned)chunk << (8 * (lvl + 1))));
    }
    acc = wadd(acc, gap);
    out_ids[j] = acc - 1;
    out_valid[j] = true;
  }
  count[q] = n;
  overflow[q] = deg > cap;
}

extern "C" int pred_gather_dac_launch(
    const void* rows, int Q, const void* anchors, int n_anchors,
    const void* words, int n_words, const void* degs, int n_degs,
    const void* flags, int n_flags, const void* frank, int levels,
    const int* level_byte_start, const int* flag_word_start, int deg_width,
    int rows_per_block, int cap, void* ids, void* valid, void* count,
    void* overflow, void* stream, int device) {
  if (levels < 1 || levels > DAC_MAX_LEVELS || cap < 1 || Q < 1 ||
      rows_per_block < 1 ||
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
  const int threads = 128;
  const int blocks = (Q + threads - 1) / threads;
  pred_gather_dac_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)rows, Q, (const int*)anchors, n_anchors,
      (const unsigned*)words, n_words, (const unsigned*)degs, n_degs,
      (const unsigned*)flags, n_flags, (const int*)frank, g, cap, (int*)ids,
      (bool*)valid, (int*)count, (bool*)overflow);
  return (int)cudaGetLastError();
}
