// Bit-accurate Q-format TEDA scan over C channel streams, one thread
// per channel.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/teda_q_scan.py::teda_q_scan_kernel.  That kernel
// hoisted the seven dividers into whole-block vector passes and kept
// two sequential multiply-add loops (mean, var) over banked rows.  Here
// one thread walks its channel's rows in tiles of kRows rows held in
// registers, and runs the same passes on each tile (`q_teda_tile` in
// qformat.cuh): the counter and sample dividers, the mean chain, d2
// and d2/k, the var chain, then ecc/outlier.  Each row sees the same
// inputs as the reference's per-row step (`_q_step_u`), so the bits
// are the same:
//   k = k0 + t + 1
//   rk = (k-1)/k (Q/Q), inv = 1/k, thr = msq1/(2k), xk = x/k (Q/int)
//   mean_n = sat(rk*mean + xk)         (k = 1 gives rk = 0, x/1 = x)
//   d2 = (x - mean_n)^2, e = d2/k (0 at k = 1)
//   var_n = sat(rk*var + e)
//   ecc = inv + (d2/var_n)/k (var_n > 0 guard)
//   outlier = (ecc >> 1) > thr && k >= 2 && row < vlen
// The carried mean/var advance only on valid rows; the per-row outputs
// are computed from the unfrozen mean_n/var_n, as the reference banks
// them.  The tail tile past T computes on zeros and stores nothing;
// its rows are invalid because vlen <= T (the wrapper clamps it).
//
// Bound on the card: integer operations.  A row costs six dividers
// (each a float64 reciprocal estimate and one exact 32-bit correction
// step; one reciprocal of k serves five of them) and three widening
// multiplies; the bytes are the same 9 B per sample as the float
// verdict contract.  Only the two saturating multiply-add chains carry
// from row to row, so the dividers of a tile issue back to back and
// overlap each other's latency.  One thread per channel under-fills
// the card at small C; time-parallel designs are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "qformat.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // rows per tile, held in registers

template <bool Full>
__global__ void __launch_bounds__(kThreads)
teda_q_scan_kernel(const int32_t* __restrict__ x,
                   const int32_t* __restrict__ msq1,
                   const int32_t* __restrict__ vlen,
                   const int32_t* __restrict__ k0,
                   const int32_t* __restrict__ mean0,
                   const int32_t* __restrict__ var0,
                   int32_t* __restrict__ mean_out,
                   int32_t* __restrict__ var_out,
                   int32_t* __restrict__ ecc_out,
                   uint8_t* __restrict__ outlier_out,
                   int32_t* __restrict__ fk,
                   int32_t* __restrict__ fmean,
                   int32_t* __restrict__ fvar, int64_t T, int64_t C,
                   QFmt f) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int32_t kk0 = k0[c];
  const int32_t vl = vlen[c];
  const int32_t mq = msq1[c];
  int32_t mean = mean0[c];
  int32_t var = var0[c];
  int32_t x_next[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) x_next[r] = r < T ? x[r * C + c] : 0;
  for (int64_t t0 = 0; t0 < T; t0 += kRows) {
    int32_t xv[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      xv[r] = x_next[r];
      const int64_t t = t0 + kRows + r;  // next tile's loads in flight
      x_next[r] = t < T ? x[t * C + c] : 0;
    }
    const int64_t left = (int64_t)vl - t0;
    const int n_valid = left <= 0 ? 0 : (left >= kRows ? kRows : (int)left);
    int32_t mn[kRows], vn[kRows], ecc[kRows];
    bool out[kRows];
    q_teda_tile<kRows>(f, kk0 + (int32_t)t0 + 1, n_valid, xv, mq, mean,
                       var, mn, vn, ecc, out);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (t0 + r < T) {
        const int64_t idx = (t0 + r) * C + c;
        ecc_out[idx] = ecc[r];
        outlier_out[idx] = (r < n_valid && out[r]) ? 1 : 0;
        if (Full) {
          mean_out[idx] = mn[r];
          var_out[idx] = vn[r];
        }
      }
    }
  }
  fk[c] = kk0 + vl;
  fmean[c] = mean;
  fvar[c] = var;
}

}  // namespace

// x (T, C) int32 Q; msq1, vlen, k0, mean0, var0 (C,) int32, vlen in
// [0, T].  Outputs: ecc (T, C) int32, outlier (T, C) u8 0/1, and with
// `full` also mean and var (T, C) int32; fk, fmean, fvar (C,) int32.
// The format is (word_len, frac_len, rounding: 1 = round, 0 = trunc).
// Launches on `stream`; returns cudaGetLastError() as an int.
extern "C" int teda_q_scan_i32(const void* x, const void* msq1,
                               const void* vlen, const void* k0,
                               const void* mean0, const void* var0,
                               void* mean_out, void* var_out, void* ecc_out,
                               void* outlier_out, void* fk, void* fmean,
                               void* fvar, long long T, long long C,
                               int word_len, int frac_len, int rounding,
                               int full, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const QFmt f = make_qfmt(word_len, frac_len, rounding);
  const unsigned blocks = (unsigned)((C + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (full) {
    teda_q_scan_kernel<true><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)x, (const int32_t*)msq1, (const int32_t*)vlen,
        (const int32_t*)k0, (const int32_t*)mean0, (const int32_t*)var0,
        (int32_t*)mean_out, (int32_t*)var_out, (int32_t*)ecc_out,
        (uint8_t*)outlier_out, (int32_t*)fk, (int32_t*)fmean,
        (int32_t*)fvar, T, C, f);
  } else {
    teda_q_scan_kernel<false><<<blocks, kThreads, 0, s>>>(
        (const int32_t*)x, (const int32_t*)msq1, (const int32_t*)vlen,
        (const int32_t*)k0, (const int32_t*)mean0, (const int32_t*)var0,
        nullptr, nullptr, (int32_t*)ecc_out, (uint8_t*)outlier_out,
        (int32_t*)fk, (int32_t*)fmean, (int32_t*)fvar, T, C, f);
  }
  return (int)cudaGetLastError();
}
