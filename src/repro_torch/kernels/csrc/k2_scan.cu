// k2_scan: batched mixed row/column scan over the k²-forest.
//
// Replaces the Pallas kernel `k2_scan` (src/repro/kernels/k2_scan.py:169,
// body `_traverse` :80 and `_compact_rows` :62).  Lane q scans tree
// preds[q]: axes[q] == 0 lists the columns of row keys[q] ((S,P,?O)),
// axes[q] == 1 the rows of column keys[q] ((?S,P,O)).  Output per lane:
// ids[cap] ascending, valid[cap], count = min(#results, cap), overflow set
// when any level's frontier held more than cap 1-nodes.
//
// Design: `k2_scan_warp_kernel` (k2_scan_lane.cuh): one warp a lane, four
// lanes a block, a grid no larger than the card holds, one run of
// consecutive lanes a warp (a lane equal to the previous one re-emits its
// frontier); rounds of 128 candidates whose word + rank loads are issued
// together, ballot compaction, the frontier in a per-warp shared-memory
// slab that spills to global scratch past K2_SLAB nodes.
//
// Bound on the card: a lane is a chain of dependent rounds, one or more a
// tree level (17 on geonames), each a global load and the warp's
// instructions over up to 128 candidates; a batch that fills the card is
// bound by the candidates' scattered loads, then by the cap-wide output
// write (5 B a slot).
#include "k2_scan_lane.cuh"

extern "C" int k2_scan_blocks(long long lanes, int device) {
  return k2_scan_grid(lanes, device);
}

extern "C" long long k2_scan_spill_ints(int blocks, int cap) {
  return k2_scan_spill(blocks, cap);
}

extern "C" int k2_scan_launch(
    const void* preds, const void* keys, const void* axes, int Q,
    const void* t_words, const void* t_rank, const void* l_words,
    const void* ones_before, const void* level_start, int P, int Wt, int Wl,
    int Hob, const int* ks, const int* subsides, int H, int cap, int blocks,
    void* scratch, long long scratch_ints, void* ids, void* valid,
    void* count, void* overflow, void* stream, int device) {
  K2Geom g;
  int err = k2_make_geom(ks, subsides, H, &g);
  if (err) return err;
  if (Q < 1 || blocks < 1 || !k2_scan_cap_ok(g, cap) ||
      scratch_ints < k2_scan_spill(blocks, cap)) {
    return (int)cudaErrorInvalidValue;
  }
  err = (int)cudaSetDevice(device);
  if (err) return err;
  const K2Forest f = k2_make_forest(t_words, t_rank, l_words, ones_before,
                                    level_start, P, Wt, Wl, Hob);
  const K2Out out = {(int*)ids, (bool*)valid, (int*)count, (bool*)overflow};
  const K2Lanes in = {(const int*)preds, (const int*)keys, (const int*)axes,
                      nullptr, nullptr, {}, 1, Q, cap, out};
  return k2_scan_run(in, K2Lanes{}, f, g, blocks, scratch, (cudaStream_t)stream);
}
