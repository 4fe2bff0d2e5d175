// Float TEDA scan over C independent channel streams, one thread per
// channel.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/teda_scan.py::teda_scan_kernel.  There the
// sequential grid axis walked time blocks and Hillis-Steele doubling
// scans ran over the sublanes; here each thread walks the T rows of its
// channel in order and carries the running sum and the variance in
// registers.  Adjacent threads read adjacent x[t*C + c], so every row
// load is coalesced.
//
// Per row (eqs (1)-(6), the reference's arithmetic):
//   k = k0 + t + 1; sum += x (valid rows only); mean = sum / k;
//   d2 = (x - mean)^2, zeroed on first (k <= 1) and invalid rows;
//   var = a*var + d2/k with a = (k-1)/k, 0 at k <= 1, 1 past vlen;
//   ecc = 1/k + d2/(k*var) (var > 0 guard);
//   outlier = ecc/2 > (m^2+1)/(2k) && k >= 2 && row < vlen.
// The finals fk = k0 + vlen, fsum, fvar are written once per channel.
// The multiply-adds are written with __fmul_rn/__fadd_rn so that nvcc
// does not contract them into FMAs: the kernel rounds where the plain
// PyTorch version does.
//
// Bound on the card: bytes.  The verdict contract moves 4 B in and
// 5 B out per sample (ecc f32 + flag u8), the full contract 4 B in and
// 13 B out (mean, var, ecc f32 + flag u8); the per-sample arithmetic is
// a few divides.  One thread per channel under-fills the card at small
// C: C = 65,536 gives 512 blocks of 128 threads, about 3.9 blocks per
// SM.  Time-parallel designs are later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;

template <bool Full>
__global__ void teda_scan_kernel(const float* __restrict__ x,
                                 const float* __restrict__ m,
                                 const int32_t* __restrict__ vlen,
                                 const float* __restrict__ k0,
                                 const float* __restrict__ sum0,
                                 const float* __restrict__ var0,
                                 float* __restrict__ mean_out,
                                 float* __restrict__ var_out,
                                 float* __restrict__ ecc_out,
                                 uint8_t* __restrict__ outlier_out,
                                 float* __restrict__ fk,
                                 float* __restrict__ fsum,
                                 float* __restrict__ fvar,
                                 int64_t T, int64_t C) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float kk0 = k0[c];
  const int64_t vl = vlen[c];
  const float mm = m[c];
  const float msq1 = __fadd_rn(__fmul_rn(mm, mm), 1.0f);
  float s = sum0[c];
  float var = var0[c];
  float x_next = T > 0 ? x[c] : 0.0f;
  for (int64_t t = 0; t < T; ++t) {
    const int64_t idx = t * C + c;
    const float xv = x_next;
    if (t + 1 < T) x_next = x[idx + C];  // next row's load in flight
    const bool valid = t < vl;
    const float k = kk0 + (float)t + 1.0f;
    if (valid) s = s + xv;
    const float mean = s / k;
    const float dd = xv - mean;
    const bool first = k <= 1.0f;
    const float d2 = (first || !valid) ? 0.0f : dd * dd;
    float a = first ? 0.0f : (k - 1.0f) / k;
    if (!valid) a = 1.0f;
    var = __fadd_rn(__fmul_rn(a, var), d2 / k);
    const bool safe = var > 0.0f;
    const float ecc = 1.0f / k + (safe ? d2 / (k * var) : 0.0f);
    const bool outl = valid && (ecc * 0.5f > msq1 / (2.0f * k)) &&
                      (k >= 2.0f);
    ecc_out[idx] = ecc;
    outlier_out[idx] = outl ? 1 : 0;
    if (Full) {
      mean_out[idx] = mean;
      var_out[idx] = var;
    }
  }
  fk[c] = kk0 + (float)vl;
  fsum[c] = s;
  fvar[c] = var;
}

}  // namespace

// x (T, C) f32; m, k0, sum0, var0 (C,) f32; vlen (C,) int32 in [0, T].
// Outputs: ecc (T, C) f32, outlier (T, C) u8 0/1, and with `full` also
// mean and var (T, C) f32; fk, fsum, fvar (C,) f32.  Launches on
// `stream`; returns cudaGetLastError() as an int.
extern "C" int teda_scan_f32(const void* x, const void* m, const void* vlen,
                             const void* k0, const void* sum0,
                             const void* var0, void* mean_out,
                             void* var_out, void* ecc_out, void* outlier_out,
                             void* fk, void* fsum, void* fvar, long long T,
                             long long C, int full, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((C + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (full) {
    teda_scan_kernel<true><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)m, (const int32_t*)vlen,
        (const float*)k0, (const float*)sum0, (const float*)var0,
        (float*)mean_out, (float*)var_out, (float*)ecc_out,
        (uint8_t*)outlier_out, (float*)fk, (float*)fsum, (float*)fvar, T,
        C);
  } else {
    teda_scan_kernel<false><<<blocks, kThreads, 0, s>>>(
        (const float*)x, (const float*)m, (const int32_t*)vlen,
        (const float*)k0, (const float*)sum0, (const float*)var0, nullptr,
        nullptr, (float*)ecc_out, (uint8_t*)outlier_out, (float*)fk,
        (float*)fsum, (float*)fvar, T, C);
  }
  return (int)cudaGetLastError();
}
