// popcount: the number of set bits of every 32-bit word of an arena.
//
// Replaces the Pallas kernel `popcount_2d` (src/repro/kernels/popcount.py:40,
// body `_popcount_kernel` :35), a SWAR popcount over (block_m, 128·k) VMEM
// tiles.  out[i] = popc(words[i]) as int32, for every word of a (M, 128·k)
// arena; the shape contract (lanes % 128, rows % 8, the Pallas kernel's at
// its default block) is checked by the wrapper.
//
// Design: an elementwise pass with the hardware `__popc`.  Each thread
// moves 16 bytes in and 16 bytes out (`uint4`/`int4`), grid-stride; the
// wrapper hands it 16-byte aligned arenas of 128 lanes a row, so the count
// is a multiple of 4.  Bound on the card: bytes (read 4 B, write 4 B a word
// at 3.35 TB/s); one `POPC` a word is nothing beside them.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void popcount_kernel(const uint4* __restrict__ words, int4* __restrict__ out,
                                long long n4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const uint4 w = words[i];
    out[i] = make_int4(__popc(w.x), __popc(w.y), __popc(w.z), __popc(w.w));
  }
}

extern "C" int popcount_launch(const void* words, long long n, void* out,
                               void* stream, int device) {
  if (n < 1 || n % 4 || (uintptr_t)words % 16 || (uintptr_t)out % 16)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const int threads = 256;
  long long blocks = (n / 4 + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks an SM
  popcount_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)words, (int4*)out, n / 4);
  return (int)cudaGetLastError();
}
