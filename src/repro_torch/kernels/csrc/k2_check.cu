// k2_check: batched (S, P, O) point probe over the k²-forest -> bool[Q].
//
// Replaces the Pallas kernel `k2_check` (src/repro/kernels/k2_check.py:85),
// generalised from one tree to the forest with a predicate per lane: it is
// the function `repro.core.k2forest.check` computes in jnp on the serve path
// (OP_CHECK lanes and the candidate checks of OP_S_ANY_O).  With P = 1 it is
// the single-tree probe.  Predicates wrap once and clip, word indices clip
// to [0, W-1] and positions wrap in int32, exactly as the JAX gathers do,
// so negative or too-large coordinates never read out of bounds.
//
// Bound on the card: a lane is a chain of H dependent loads (17 levels on
// geonames), each level's position needing the previous level's rank, and
// the arenas (2 × 69.5 MB on geonames) exceed the 50 MB L2, so the lower
// levels are device-memory round trips.  The bytes are negligible.
//
// Both designs below make a level one memory round: the word load and the
// t_rank load at the same clipped index go out together (both depend only
// on the position, and the index is always in bounds), and the level's
// level_start and ones_before entries never wait on the walk.  Only then
// is the bit tested and the walk stopped at the first 0.  Level l + 1's
// position is level_start[l+1] + (rank − ones_before[l])·k² + digits, in
// wrapped int32 as the reference computes it.
//
// - k2_check_warp_kernel, one warp a lane, for batches of at most 8 warps
//   an SM (ops._check_grid).  Thread l holds level l's constants, computed
//   at once: its digits (the sides nest, so level l's digit is
//   floordiv(floormod(x, subsides[l-1]), subsides[l])) and the tree's
//   table entries, folded into C_l = level_start[l] + digits_l −
//   ones_before[l-1]·k_l², so a level's position is rank·k_l² + C_l; a
//   level reads them by __shfl_sync while its loads are in flight.  Thread
//   i also loads word i of the tree and its rank entry, in the same round
//   as the table: levels whose word index is below 32 (the top two levels
//   of a geonames tree) read them by __shfl_sync instead of memory.  Every
//   thread walks the same path, so a load is one broadcast transaction.
// - k2_check_thread_kernel, one thread a lane, for larger batches, where a
//   warp a lane runs 32 times the instructions and queues on the SM's
//   schedulers.  Each level loads its two table entries beside its word.
#include "k2_common.cuh"

#define K2C_FULL 0xffffffffu

// The kernels' parameters (the launcher's, less the geometry arrays).
#define K2C_PARAMS                                                            \
  const int *__restrict__ preds, const int *__restrict__ rows,                \
      const int *__restrict__ cols, int Q, const unsigned *__restrict__ t_words, \
      const int *__restrict__ t_rank, const unsigned *__restrict__ l_words,   \
      const int *__restrict__ ones_before,                                    \
      const int *__restrict__ level_start, int P, int Wt, int Wl, int Hob,    \
      K2Geom g, bool *__restrict__ out

__global__ void __launch_bounds__(128) k2_check_warp_kernel(K2C_PARAMS) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (q >= Q) return;  // warp-uniform
  const int H = g.H;
  const int p = pred_row(preds[q], P);
  const int row = rows[q], col = cols[q];
  const unsigned* trow = t_words + (size_t)p * Wt;
  const int* rrow = t_rank + (size_t)p * Wt;
  const unsigned* lrow = l_words + (size_t)p * Wl;
  // one round: the tree's table entries and its first 32 words and ranks
  const bool inner = lane >= 1 && lane < H;
  const int ls = inner ? level_start[(size_t)p * H + lane] : 0;
  const int ob = inner && lane - 1 < Hob ? ones_before[(size_t)p * Hob + lane - 1] : 0;
  const unsigned top_w = trow[min(lane, Wt - 1)];
  const int top_r = rrow[min(lane, Wt - 1)];

  // level `lane`: arity, side, digits
  const int k = lane < H ? g.ks[lane] : 1;
  const int sub = lane < H ? g.subsides[lane] : 1;
  const int above = __shfl_up_sync(K2C_FULL, sub, 1);
  const int rd = floordiv_fast(lane == 0 ? row : floormod_fast(row, above), sub);
  const int cd = floordiv_fast(lane == 0 ? col : floormod_fast(col, above), sub);
  const int r = wmul(k, k);
  const int off = wadd(wmul(rd, k), cd);
  int pos = __shfl_sync(K2C_FULL, off, 0);  // level 0 needs no table entry
  const int c = wsub(wadd(ls, off), wmul(ob, r));

  bool alive = false;
  for (int lvl = 0;; ++lvl) {
    const bool last = lvl == H - 1;
    unsigned w;
    int rb = 0;
    if (last) {
      w = lrow[clampi(pos >> 5, 0, Wl - 1)];
    } else {
      const int wi = clampi(pos >> 5, 0, Wt - 1);
      if (wi < 32) {  // warp-uniform
        w = __shfl_sync(K2C_FULL, top_w, wi);
        rb = __shfl_sync(K2C_FULL, top_r, wi);
      } else {
        w = trow[wi];
        rb = rrow[wi];
      }
    }
    const int r_next = __shfl_sync(K2C_FULL, r, lvl + 1);
    const int c_next = __shfl_sync(K2C_FULL, c, lvl + 1);
    alive = bit_of(w, pos) != 0;
    if (last || !alive) break;
    pos = wadd(wmul(wadd(rb, popc_below(w, pos)), r_next), c_next);
  }
  if (lane == 0) out[q] = alive;
}

__global__ void __launch_bounds__(128) k2_check_thread_kernel(K2C_PARAMS) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const int H = g.H;
  const int p = pred_row(preds[q], P);
  const int row = rows[q], col = cols[q];
  const unsigned* trow = t_words + (size_t)p * Wt;
  const int* rrow = t_rank + (size_t)p * Wt;
  const unsigned* lrow = l_words + (size_t)p * Wl;
  const int* ls_row = level_start + (size_t)p * H;
  const int* ob_row = ones_before + (size_t)p * Hob;
  int k = g.ks[0], sub = g.subsides[0];
  int pos = wadd(wmul(floordiv_fast(row, sub), k), floordiv_fast(col, sub));
  bool alive = false;
  for (int lvl = 0;; ++lvl) {
    const bool last = lvl == H - 1;
    const int nl = last ? lvl : lvl + 1;
    const int ls = ls_row[nl];
    const int ob = ob_row[min(lvl, Hob - 1)];
    unsigned w;
    int rb = 0;
    if (last) {
      w = lrow[clampi(pos >> 5, 0, Wl - 1)];
    } else {
      const int wi = clampi(pos >> 5, 0, Wt - 1);
      w = trow[wi];
      rb = rrow[wi];
    }
    const int above = sub;
    k = g.ks[nl];
    sub = g.subsides[nl];
    const int rd = floordiv_fast(floormod_fast(row, above), sub);
    const int cd = floordiv_fast(floormod_fast(col, above), sub);
    alive = bit_of(w, pos) != 0;
    if (last || !alive) break;
    pos = wadd(wadd(ls, wmul(wsub(wadd(rb, popc_below(w, pos)), ob), wmul(k, k))),
               wadd(wmul(rd, k), cd));
  }
  out[q] = alive;
}

// kernel: 0 the warp-per-lane kernel, 1 the thread-per-lane kernel, with
// `blocks` of `threads` (ops._check_grid).
extern "C" int k2_check_launch(
    const void* preds, const void* rows, const void* cols, int Q,
    const void* t_words, const void* t_rank, const void* l_words,
    const void* ones_before, const void* level_start, int P, int Wt, int Wl,
    int Hob, const int* ks, const int* subsides, int H, int kernel,
    int blocks, int threads, void* out, void* stream, int device) {
  K2Geom g;
  int err = k2_make_geom(ks, subsides, H, &g);
  if (err) return err;
  const long long lanes = (long long)blocks * (kernel == 0 ? threads / 32 : threads);
  if (Q < 1 || (kernel != 0 && kernel != 1) || blocks < 1 || threads < 32 ||
      threads > 128 || threads % 32 || lanes < Q || !k2_sides_nest(g)) {
    return (int)cudaErrorInvalidValue;
  }
  err = (int)cudaSetDevice(device);
  if (err) return err;
  auto kernel_fn = kernel == 0 ? k2_check_warp_kernel : k2_check_thread_kernel;
  kernel_fn<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)preds, (const int*)rows, (const int*)cols, Q,
      (const unsigned*)t_words, (const int*)t_rank, (const unsigned*)l_words,
      (const int*)ones_before, (const int*)level_start, P, Wt, Wl, Hob, g,
      (bool*)out);
  return (int)cudaGetLastError();
}
