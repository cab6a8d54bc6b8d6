// sorted_intersect_mask: membership of every lane of one sorted id list in
// another.
//
// Replaces the Pallas kernel `sorted_intersect_mask`
// (src/repro/kernels/sorted_intersect.py:46, body `_make_kernel` :25), a
// vectorised binary search of each A lane in a VMEM-resident B.  For
// ascending, SENTINEL (2^31-1)-padded int32 lists: out[i] = b[lo] == a[i]
// && a[i] != SENTINEL, where lo is the lower bound of a[i] in b (the first
// lane with b[lo] >= a[i]), clipped to cb-1 — as `torch.searchsorted`
// gives it.  Negative ids, ids above max(b) and repeated values in b need
// nothing special: the lower bound is signed and the clip covers lo == cb.
//
// The search runs until the interval is empty (at most floor(log2 cb) + 1
// steps).  The Pallas kernel stops after ceil(log2 cb) steps, one short
// when cb is a power of two: there it leaves lo = 0 for a lane with
// b[0] < a == b[1] and misses that member.  This kernel does not.
//
// Design: one thread per A lane, B read from global memory (a capacity list
// of at most a few MB stays in the 50 MB L2), one byte of output a lane.
// Bound on the card: latency, not bytes — each lane is a chain of ~log2 cb
// dependent L2 reads; the byte bound (5 B a lane plus B once) is far lower.
#include <cuda_runtime.h>
#include <stdint.h>

#define SENTINEL 0x7FFFFFFF

__global__ void sorted_intersect_kernel(const int* __restrict__ a, int ca,
                                        const int* __restrict__ b, int cb,
                                        bool* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ca) return;
  const int v = a[i];
  int lo = 0, hi = cb;  // search [lo, hi)
  while (lo < hi) {
    const int mid = (int)(((unsigned)lo + (unsigned)hi) >> 1);
    if (b[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  out[i] = b[lo < cb ? lo : cb - 1] == v && v != SENTINEL;
}

extern "C" int sorted_intersect_launch(const void* a, int ca, const void* b, int cb,
                                       void* out, void* stream, int device) {
  if (ca < 1 || cb < 1) return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const int threads = 256;
  const int blocks = (int)(((long long)ca + threads - 1) / threads);
  sorted_intersect_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)a, ca, (const int*)b, cb, (bool*)out);
  return (int)cudaGetLastError();
}
