// launch_floor: an empty kernel, one block of one warp.
//
// No TPU kernel: a yardstick for the latency-bound kernels.  Timed as they
// are (chip_smoke.py phase 6), its device time is the least a launch
// costs on the card, so a kernel's time above it is its own work.
#include <cuda_runtime.h>

__global__ void launch_floor_kernel() {}

extern "C" int launch_floor_launch(void* stream, int device) {
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
