// The Q divider of qformat.cuh on its own, for checking on the card.
//
// out[i] = q_fast_div_mag(n[i], d[i], shift, round, qmax): the
// reciprocal-estimate divider that every Q kernel inlines
// (teda_q_scan.cu, the teda-q lane of ensemble_scan.cu), one thread per
// pair, so that a caller can hold it bit for bit against the plain
// `kernels/qdiv.py::fast_div_mag` over edge sets and millions of
// random pairs.  Not on any engine path.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "qformat.cuh"

namespace {

__global__ void qdiv_probe_kernel(const int64_t* __restrict__ n,
                                  const int64_t* __restrict__ d,
                                  int32_t* __restrict__ out, int64_t count,
                                  int shift, int round, uint32_t qmax) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  out[i] = (int32_t)q_fast_div_mag((uint32_t)n[i], (uint32_t)d[i], shift,
                                   round, qmax);
}

}  // namespace

// n, d (count,) int64 magnitudes in [0, 2^31]; out (count,) int32 in
// [0, qmax]; shift 0..30; round 1 (half up) or 0 (truncate).  Launches
// on `stream`; returns cudaGetLastError() as an int.
extern "C" int qdiv_probe_u32(const void* n, const void* d, void* out,
                              long long count, int shift, int round,
                              int qmax, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (count <= 0) return 0;
  const unsigned blocks = (unsigned)((count + 255) / 256);
  qdiv_probe_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      (const int64_t*)n, (const int64_t*)d, (int32_t*)out, count, shift,
      round, (uint32_t)qmax);
  return (int)cudaGetLastError();
}
