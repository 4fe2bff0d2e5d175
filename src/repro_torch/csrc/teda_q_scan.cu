// Bit-accurate Q-format TEDA scan over C channel streams, one thread
// per channel.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/teda_q_scan.py::teda_q_scan_kernel.  That kernel
// hoisted the seven dividers into whole-block vector passes and kept
// two sequential multiply-add loops (mean, var) over banked rows; here
// one thread walks its channel's rows in order and evaluates every
// divider inline (`q_teda_row` in qformat.cuh).  Each row sees the same
// inputs in the same order as the reference's per-row step
// (`_q_step_u`), so the bits are the same:
//   k = k0 + t + 1
//   rk = (k-1)/k (Q/Q), inv = 1/k, thr = msq1/(2k), xk = x/k (Q/int)
//   mean_n = sat(rk*mean + xk)         (k = 1 gives rk = 0, x/1 = x)
//   d2 = (x - mean_n)^2, e = d2/k (0 at k = 1)
//   var_n = sat(rk*var + e)
//   ecc = inv + (d2/var_n)/k (var_n > 0 guard)
//   outlier = (ecc >> 1) > thr && k >= 2 && row < vlen
// The carried mean/var advance only on valid rows; the per-row outputs
// are computed from the unfrozen mean_n/var_n, as the reference banks
// them.
//
// Bound on the card: operations.  A row costs six dividers (each one
// 32-bit integer divide, which the GPU emulates in software, plus FL
// restoring steps for the two Q/Q ones) and three widening multiplies;
// the bytes are the same 9 B per sample as the float verdict contract.
// One thread per channel under-fills the card at small C; time-parallel
// designs are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "qformat.cuh"

namespace {

constexpr int kThreads = 128;

template <bool Full>
__global__ void teda_q_scan_kernel(const int32_t* __restrict__ x,
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
                                   int32_t* __restrict__ fvar, int64_t T,
                                   int64_t C, QFmt f) {
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int32_t kk0 = k0[c];
  const int32_t vl = vlen[c];
  const int32_t mq = msq1[c];
  int32_t mean = mean0[c];
  int32_t var = var0[c];
  int32_t x_next = T > 0 ? x[c] : 0;
  for (int64_t t = 0; t < T; ++t) {
    const int64_t idx = t * C + c;
    const int32_t xv = x_next;
    if (t + 1 < T) x_next = x[idx + C];  // next row's load in flight
    const bool valid = t < vl;
    const int32_t k = kk0 + (int32_t)t + 1;
    const QTedaRow q = q_teda_row(f, k, xv, mean, var, mq);
    if (valid) {
      mean = q.mean;
      var = q.var;
    }
    ecc_out[idx] = q.ecc;
    outlier_out[idx] = (valid && q.outlier) ? 1 : 0;
    if (Full) {
      mean_out[idx] = q.mean;
      var_out[idx] = q.var;
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
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
