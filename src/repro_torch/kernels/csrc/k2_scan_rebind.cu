// k2_scan_rebind: fused X-resolution + re-bind (join categories D and E).
//
// Replaces the Pallas kernel `k2_scan_rebind`
// (src/repro/kernels/k2_scan.py:269, body `_make_scan_rebind_kernel` :220).
// Phase 1 scans (preds1, keys1, axes1) into a cap_x side list of ?X ids per
// query lane: x_ids/x_valid (Q, cap_x), x_count/x_overflow (Q,).  Phase 2
// re-binds every X slot (q, i) into pattern 2 as the scan
// (preds2[q], x, axes2[q]) at cap_y: y_ids/y_valid (Q, cap_x, cap_y),
// y_count/y_overflow (Q, cap_x).  A dead X slot scans key 0, and its Y
// results are the real results of that scan (the caller masks them), so
// the 8-tuple equals the reference's bit for bit.
//
// Design: both phases are the lane function of k2_scan (k2_scan_lane.cuh),
// so they compute exactly what k2_scan computes.  Phase 1 is the k2_scan
// kernel itself (one block per query lane); phase 2 is a second kernel with
// one block per Y lane (Q·cap_x blocks) that reads its key from phase 1's
// outputs.  The launcher queues both on one stream back to back: the X
// lists never leave the device and no host round trip separates the
// phases.  Scratch: 4·cap_x ints per query lane, 4·cap_y per Y lane.
//
// Bound on the card: as k2_scan, dependent gathers per level and the
// cap_x·cap_y output block per query lane, which dominates the bytes.
#include "k2_scan_lane.cuh"

__global__ void k2_rebind_kernel(
    const int* __restrict__ preds2, const int* __restrict__ axes2,
    int cap_x, int n_y, K2Forest f, K2Geom g, int cap_y,
    const int* __restrict__ x_ids, const bool* __restrict__ x_valid,
    int* __restrict__ scratch, int* __restrict__ y_ids,
    bool* __restrict__ y_valid, int* __restrict__ y_count,
    bool* __restrict__ y_overflow) {
  __shared__ int fdig[K2_MAX_LEVELS];
  __shared__ int scan_scratch[32];
  const int y = blockIdx.x;  // = q * cap_x + i
  const int q = y / cap_x;
  const int key = x_valid[y] ? x_ids[y] : 0;
  const size_t plane = (size_t)n_y * cap_y;
  int* lane = scratch + (size_t)y * cap_y;
  k2_scan_lane(preds2[q], key, axes2[q] == 0, f, g, cap_y, lane,
               lane + plane, lane + 2 * plane, lane + 3 * plane,
               y_ids + (size_t)y * cap_y, y_valid + (size_t)y * cap_y,
               y_count + y, y_overflow + y, fdig, scan_scratch);
}

extern "C" int k2_scan_rebind_launch(
    const void* preds1, const void* keys1, const void* axes1,
    const void* preds2, const void* axes2, int Q, const void* t_words,
    const void* t_rank, const void* l_words, const void* ones_before,
    const void* level_start, int P, int Wt, int Wl, int Hob, const int* ks,
    const int* subsides, int H, int cap_x, int cap_y, void* scratch_x,
    void* scratch_y, void* x_ids, void* x_valid, void* x_count,
    void* x_overflow, void* y_ids, void* y_valid, void* y_count,
    void* y_overflow, void* stream, int device) {
  K2Geom g;
  int err = k2_make_geom(ks, subsides, H, &g);
  if (err) return err;
  if (cap_x < 1 || cap_y < 1 || Q < 1) return (int)cudaErrorInvalidValue;
  const long long n_y = (long long)Q * cap_x;
  if (n_y > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  err = (int)cudaSetDevice(device);
  if (err) return err;
  const K2Forest f = k2_make_forest(t_words, t_rank, l_words, ones_before,
                                    level_start, P, Wt, Wl, Hob);
  cudaStream_t s = (cudaStream_t)stream;
  k2_scan_kernel<<<Q, 256, 0, s>>>(
      (const int*)preds1, (const int*)keys1, (const int*)axes1, Q, f, g, cap_x,
      (int*)scratch_x, (int*)x_ids, (bool*)x_valid, (int*)x_count,
      (bool*)x_overflow);
  err = (int)cudaGetLastError();
  if (err) return err;
  k2_rebind_kernel<<<(unsigned)n_y, 128, 0, s>>>(
      (const int*)preds2, (const int*)axes2, cap_x, (int)n_y, f, g, cap_y,
      (const int*)x_ids, (const bool*)x_valid, (int*)scratch_y, (int*)y_ids,
      (bool*)y_valid, (int*)y_count, (bool*)y_overflow);
  return (int)cudaGetLastError();
}
