// k2_check: batched (S, P, O) point probe over the k²-forest -> bool[Q].
//
// Replaces the Pallas kernel `k2_check` (src/repro/kernels/k2_check.py:85),
// generalised from one tree to the forest with a predicate per lane: it is
// the function `repro.core.k2forest.check` computes in jnp on the serve path
// (OP_CHECK lanes and the candidate checks of OP_S_ANY_O).  With P = 1 it is
// the single-tree probe.
//
// Design: one thread per lane walks the H levels; each level is one word
// gather, one bit test, one rank gather and a __popc.  The walk stops at the
// first 0 bit (the answer is then fixed).  Every word index is clipped to
// [0, W-1] and the predicate wrapped/clipped exactly as the JAX gathers do,
// so negative coordinates of dead lanes never read out of bounds.
//
// Bound on the card: latency of dependent gathers (each level needs the
// previous level's rank).  The arenas (~150 MB at geonames size) exceed L2,
// so a lane pays up to 2·H dependent DRAM reads; throughput comes from many
// lanes in flight, so the launch uses small blocks to spread over all SMs.
#include "k2_common.cuh"

__global__ void k2_check_kernel(
    const int* __restrict__ preds, const int* __restrict__ rows,
    const int* __restrict__ cols, int Q,
    const unsigned* __restrict__ t_words, const int* __restrict__ t_rank,
    const unsigned* __restrict__ l_words, const int* __restrict__ ones_before,
    const int* __restrict__ level_start, int P, int Wt, int Wl, int Hob,
    K2Geom g, bool* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  const int p = pred_row(preds[q], P);
  const int H = g.H;
  const unsigned* trow = t_words + (size_t)p * Wt;
  const unsigned* lrow = l_words + (size_t)p * Wl;
  const int* rrow = t_rank + (size_t)p * Wt;

  int rrem = rows[q], crem = cols[q];
  int sub = g.subsides[0];
  int rd = floordiv_pos(rrem, sub), cd = floordiv_pos(crem, sub);
  rrem = floormod_pos(rrem, sub);
  crem = floormod_pos(crem, sub);
  int pos = wadd(wmul(rd, g.ks[0]), cd);
  bool alive = true;
  for (int lvl = 0; lvl < H; ++lvl) {
    const bool last = lvl == H - 1;
    const unsigned w = last ? word_at(lrow, Wl, pos) : word_at(trow, Wt, pos);
    alive = bit_of(w, pos) != 0;
    if (last || !alive) break;
    const int rank = rrow[clampi(pos >> 5, 0, Wt - 1)] + popc_below(w, pos);
    const int j = rank - ones_before[(size_t)p * Hob + lvl];
    sub = g.subsides[lvl + 1];
    rd = floordiv_pos(rrem, sub);
    cd = floordiv_pos(crem, sub);
    rrem = floormod_pos(rrem, sub);
    crem = floormod_pos(crem, sub);
    const int k = g.ks[lvl + 1];
    pos = wadd(wadd(level_start[(size_t)p * H + lvl + 1], wmul(j, k * k)),
               wadd(wmul(rd, k), cd));
  }
  out[q] = alive;
}

extern "C" int k2_check_launch(
    const void* preds, const void* rows, const void* cols, int Q,
    const void* t_words, const void* t_rank, const void* l_words,
    const void* ones_before, const void* level_start, int P, int Wt, int Wl,
    int Hob, const int* ks, const int* subsides, int H, void* out,
    void* stream, int device) {
  K2Geom g;
  int err = k2_make_geom(ks, subsides, H, &g);
  if (err) return err;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  const int threads = 128;
  const int blocks = (Q + threads - 1) / threads;
  k2_check_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)preds, (const int*)rows, (const int*)cols, Q,
      (const unsigned*)t_words, (const int*)t_rank, (const unsigned*)l_words,
      (const int*)ones_before, (const int*)level_start, P, Wt, Wl, Hob, g,
      (bool*)out);
  return (int)cudaGetLastError();
}
