// k2_scan: batched mixed row/column scan over the k²-forest.
//
// Replaces the Pallas kernel `k2_scan` (src/repro/kernels/k2_scan.py:169,
// body `_traverse` :80 and `_compact_rows` :62).  Lane q scans tree
// preds[q]: axes[q] == 0 lists the columns of row keys[q] ((S,P,?O)),
// axes[q] == 1 the rows of column keys[q] ((?S,P,O)).  Output per lane:
// ids[cap] ascending, valid[cap], count = min(#results, cap), overflow set
// when any level's frontier held more than cap 1-nodes.
//
// Design: one thread block per lane runs the level-synchronous frontier
// BFS of `k2_scan_lane` (k2_scan_lane.cuh): global double-buffered
// frontier (4·cap ints per lane), stable block-scan compaction, early stop
// on an empty frontier.
//
// Bound on the card: dependent gathers into arenas larger than L2 (one
// level's reads need the previous level's compaction) and the
// cap-wide output write; a lane's work is data-dependent (frontier size),
// and small frontiers leave most of a block idle.
#include "k2_scan_lane.cuh"

extern "C" int k2_scan_launch(
    const void* preds, const void* keys, const void* axes, int Q,
    const void* t_words, const void* t_rank, const void* l_words,
    const void* ones_before, const void* level_start, int P, int Wt, int Wl,
    int Hob, const int* ks, const int* subsides, int H, int cap, void* scratch,
    void* ids, void* valid, void* count, void* overflow, void* stream,
    int device) {
  K2Geom g;
  int err = k2_make_geom(ks, subsides, H, &g);
  if (err) return err;
  if (cap < 1 || Q < 1) return (int)cudaErrorInvalidValue;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  const K2Forest f = k2_make_forest(t_words, t_rank, l_words, ones_before,
                                    level_start, P, Wt, Wl, Hob);
  k2_scan_kernel<<<Q, 256, 0, (cudaStream_t)stream>>>(
      (const int*)preds, (const int*)keys, (const int*)axes, Q, f, g, cap,
      (int*)scratch, (int*)ids, (bool*)valid, (int*)count, (bool*)overflow);
  return (int)cudaGetLastError();
}
