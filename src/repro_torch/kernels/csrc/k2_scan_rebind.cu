// k2_scan_rebind: fused X-resolution + re-bind (join categories D and E).
//
// Replaces the Pallas kernel `k2_scan_rebind`
// (src/repro/kernels/k2_scan.py:269, body `_make_scan_rebind_kernel` :220).
// The X side scans (preds1, keys1, axes1) into a cap_x side list of ?X ids
// per query lane: x_ids/x_valid (Q, cap_x), x_count/x_overflow (Q,).  The Y
// side re-binds every X slot (q, i) into pattern 2 as the scan
// (preds2[q], x, axes2[q]) at cap_y: y_ids/y_valid (Q, cap_x, cap_y),
// y_count/y_overflow (Q, cap_x).  A dead X slot scans key 0, and its Y
// results are the real results of that scan (the caller masks them), so
// the 8-tuple equals the reference's bit for bit.
//
// Design: two launches of k2_scan's kernel, `k2_scan_warp_kernel`
// (k2_scan_lane.cuh, one warp a lane), so every scan is computed exactly
// as k2_scan computes it.  The first runs 2·Q lanes: the Q X scans at
// cap_x and, beside them, `zero`: the scan (preds2[q], 0, axes2[q]) of
// every query lane at cap_y.  The second runs the Q·cap_x Y lanes: a live
// X slot scans its key, a dead one copies row q of `zero` instead of
// repeating the same traversal (an X list holds a handful of ids in cap_x
// slots, so nearly every Y lane is dead).  The launcher queues both on one
// stream back to back: the X lists never leave the device and no host
// round trip separates them.  They run one after the other, so they share
// one spill scratch, sized for the larger.
//
// Bound on the card: as k2_scan, one or more dependent rounds a tree level
// per scanned lane, and the cap_x·cap_y output block per query lane, which
// dominates the bytes.
#include "k2_scan_lane.cuh"

extern "C" int k2_scan_rebind_blocks(long long lanes, int device) {
  return k2_scan_grid(lanes, device);
}

extern "C" long long k2_scan_rebind_spill_ints(int blocks, int cap) {
  return k2_scan_spill(blocks, cap);
}

extern "C" int k2_scan_rebind_launch(
    const void* preds1, const void* keys1, const void* axes1,
    const void* preds2, const void* axes2, int Q, const void* t_words,
    const void* t_rank, const void* l_words, const void* ones_before,
    const void* level_start, int P, int Wt, int Wl, int Hob, const int* ks,
    const int* subsides, int H, int cap_x, int cap_y, int blocks_x,
    int blocks_y, void* scratch, long long scratch_ints, void* x_ids,
    void* x_valid, void* x_count, void* x_overflow, void* zero_ids,
    void* zero_valid, void* zero_count, void* zero_overflow, void* y_ids,
    void* y_valid, void* y_count, void* y_overflow, void* stream,
    int device) {
  K2Geom g;
  int err = k2_make_geom(ks, subsides, H, &g);
  if (err) return err;
  const long long n_y = (long long)Q * cap_x;
  const int cap_xz = cap_x > cap_y ? cap_x : cap_y;
  if (Q < 1 || n_y > 0x7FFFFFFFLL || 2LL * Q > 0x7FFFFFFFLL || blocks_x < 1 ||
      blocks_y < 1 || !k2_scan_cap_ok(g, cap_x) || !k2_scan_cap_ok(g, cap_y) ||
      scratch_ints < k2_scan_spill(blocks_x, cap_xz) ||
      scratch_ints < k2_scan_spill(blocks_y, cap_y)) {
    return (int)cudaErrorInvalidValue;
  }
  err = (int)cudaSetDevice(device);
  if (err) return err;
  const K2Forest f = k2_make_forest(t_words, t_rank, l_words, ones_before,
                                    level_start, P, Wt, Wl, Hob);
  cudaStream_t s = (cudaStream_t)stream;
  const K2Out x = {(int*)x_ids, (bool*)x_valid, (int*)x_count, (bool*)x_overflow};
  const K2Out zero = {(int*)zero_ids, (bool*)zero_valid, (int*)zero_count,
                      (bool*)zero_overflow};
  const K2Lanes xs = {(const int*)preds1, (const int*)keys1, (const int*)axes1,
                      nullptr, nullptr, {}, 1, Q, cap_x, x};
  const K2Lanes zs = {(const int*)preds2, nullptr, (const int*)axes2,
                      nullptr, nullptr, {}, 1, Q, cap_y, zero};
  err = k2_scan_run(xs, zs, f, g, blocks_x, scratch, s);
  if (err) return err;
  const K2Out y = {(int*)y_ids, (bool*)y_valid, (int*)y_count, (bool*)y_overflow};
  const K2Lanes ys = {(const int*)preds2, nullptr, (const int*)axes2,
                      (const int*)x_ids, (const bool*)x_valid, zero, cap_x,
                      (int)n_y, cap_y, y};
  return k2_scan_run(ys, K2Lanes{}, f, g, blocks_y, scratch, s);
}
