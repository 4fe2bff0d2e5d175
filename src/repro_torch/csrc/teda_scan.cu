// Float TEDA scan over C independent channel streams, one thread per
// channel, with the samples staged through shared memory.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/teda_scan.py::teda_scan_kernel.  There the
// sequential grid axis walked time blocks and Hillis-Steele doubling
// scans ran over the sublanes; here each thread walks the T rows of its
// channel in order and carries the running sum and the variance in
// registers.
//
// Per row (eqs (1)-(6), the reference's arithmetic):
//   k = k0 + t + 1; sum += x (valid rows only); mean = sum / k;
//   d2 = (x - mean)^2, zeroed on first (k <= 1) and invalid rows;
//   var = a*var + d2/k with a = (k-1)/k, 0 at k <= 1, 1 past vlen;
//   ecc = 1/k + d2/(k*var) (var > 0 guard);
//   outlier = ecc/2 > (m^2+1)/(2k) && k >= 2 && row < vlen.
// The finals fk = k0 + vlen, fsum, fvar are written once per channel.
// Every operation is an IEEE round-to-nearest intrinsic, so that nvcc
// contracts nothing into an FMA: the kernel rounds where the plain
// PyTorch version does, and rows at or past vlen run the same
// operations as valid ones (ecc = 1/k, carries frozen, no flag).
//
// Bound on the card: bytes, by the count.  The verdict contract moves
// 4 B in and 5 B out per sample (ecc f32 + flag u8), the full contract
// 4 B in and 13 B out (mean, var, ecc f32 + flag u8), against six
// divides and a dozen other operations.  Reaching the byte bound takes
// ~20 KB of loads in flight per SM (Little's law at 3.35 TB/s and
// ~0.6-0.8 us of loaded latency), which the design below provides.
// What holds the verdict contract back at C = 65,536 is the divides:
// each IEEE divide compiles to a reciprocal, five FMAs and an FCHK test
// that branches to a called slow path, so a row's six divides run one
// after another and ~4 warps per scheduler cannot hide the chain.  A
// zero dividend fails FCHK: rows past vlen (d2 = 0) take the slow path
// twice, so ragged vlen runs slower than uniform (PERF.md section 6).
//
// Design: a block of kThreads channels stages x through a ring of
// kStages shared-memory tiles of kRows rows, filled by cp.async.  While
// the threads consume one tile row by row, the next kStages - 1 tiles
// are in flight: 32 KB a block, about 4 blocks an SM at C = 65,536.
// Where every row of x is 16-byte aligned (C % 4 == 0 and an aligned
// base), each warp copies whole 512-byte tile rows in 16-byte pieces
// (cp.async.cg, past L1); otherwise each thread copies its own
// channel's samples in 4-byte pieces (cp.async.ca).  One block barrier
// per tile makes the landed tile visible to every thread and frees the
// tile read before it for refilling.  Threads past C stay in the block:
// they copy and store nothing, compute on whatever their column holds,
// and arrive at every barrier.  The outputs go straight from registers:
// a warp's row is one 128-byte ecc store and one 32-byte flag store.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kRows = 32;      // rows per tile: kernels/teda_scan.py STAGE_ROWS
constexpr int kStages = 3;     // tiles in the ring
constexpr int kPieces = kThreads / 4;  // 16-byte pieces in a tile row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying rows [t0, t0 + n) of the block's channels [c0, c0 +
// kThreads) of x into `tile`.  Channels past C are not copied.
__device__ __forceinline__ void load_tile(float (*tile)[kThreads],
                                          const float* __restrict__ x,
                                          int64_t t0, int n, int64_t C,
                                          int64_t c0, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {
    // thread tid copies piece j of rows tid / kPieces + 4i: channels
    // c0 + 4j .. c0 + 4j + 3, wholly in or out since C % 4 == 0
    const int j = tid % kPieces;
    const int64_t cj = c0 + 4 * j;
    if (cj < C) {
#pragma unroll
      for (int i = 0; i < kRows / 4; ++i) {
        const int r = tid / kPieces + 4 * i;
        if (r < n) cp_async16(&tile[r][4 * j], x + (t0 + r) * C + cj);
      }
    }
  } else {
    const int64_t c = c0 + tid;
    if (c < C) {
#pragma unroll 4
      for (int r = 0; r < n; ++r)
        cp_async4(&tile[r][tid], x + (t0 + r) * C + c);
    }
  }
}

// Rows in tile i of a T-row chunk: kRows but in the last tile.
__device__ __forceinline__ int tile_rows(int64_t T, int64_t i) {
  const int64_t left = T - i * kRows;
  return left < kRows ? (int)left : kRows;
}

template <bool Full>
__global__ void __launch_bounds__(kThreads, 4)
    teda_scan_kernel(const float* __restrict__ x,
                     const float* __restrict__ m,
                     const int32_t* __restrict__ vlen,
                     const float* __restrict__ k0,
                     const float* __restrict__ sum0,
                     const float* __restrict__ var0,
                     float* __restrict__ mean_out,
                     float* __restrict__ var_out,
                     float* __restrict__ ecc_out,
                     uint8_t* __restrict__ outlier_out,
                     float* __restrict__ fk, float* __restrict__ fsum,
                     float* __restrict__ fvar, int64_t T, int64_t C,
                     bool vec) {
  __shared__ __align__(16) float tiles[kStages][kRows][kThreads];  // 48 KB
  const int64_t c0 = (int64_t)blockIdx.x * kThreads;
  const int64_t c = c0 + threadIdx.x;
  const bool live = c < C;
  const float kk0 = live ? k0[c] : 0.0f;
  const int64_t vl = live ? vlen[c] : 0;
  const float mm = live ? m[c] : 0.0f;
  const float msq1 = __fadd_rn(__fmul_rn(mm, mm), 1.0f);
  float s = live ? sum0[c] : 0.0f;
  float var = live ? var0[c] : 0.0f;

  const int64_t n_tiles = (T + kRows - 1) / kRows;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles)
      load_tile(tiles[i], x, (int64_t)i * kRows, tile_rows(T, i), C, c0,
                vec);
    cp_async_commit();  // possibly empty: the group count stays fixed
  }
  for (int64_t i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile i
    __syncthreads();  // everyone's copies landed; tile i - 1 is read
    const int64_t next = i + kStages - 1;
    if (next < n_tiles)
      load_tile(tiles[next % kStages], x, next * kRows, tile_rows(T, next),
                C, c0, vec);
    cp_async_commit();

    const float(*rows)[kThreads] = tiles[i % kStages];
    const int64_t t0 = i * kRows;
    const int n = tile_rows(T, i);
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      const int64_t t = t0 + r;
      const float xv = rows[r][threadIdx.x];
      const bool valid = t < vl;
      const float k = __fadd_rn(__fadd_rn(kk0, (float)t), 1.0f);
      if (valid) s = __fadd_rn(s, xv);
      const float mean = __fdiv_rn(s, k);
      const float dd = __fsub_rn(xv, mean);
      const bool first = k <= 1.0f;
      const float d2 = (first || !valid) ? 0.0f : __fmul_rn(dd, dd);
      float a = first ? 0.0f : __fdiv_rn(__fsub_rn(k, 1.0f), k);
      if (!valid) a = 1.0f;
      var = __fadd_rn(__fmul_rn(a, var), __fdiv_rn(d2, k));
      const bool safe = var > 0.0f;
      const float ecc =
          __fadd_rn(__fdiv_rn(1.0f, k),
                    safe ? __fdiv_rn(d2, __fmul_rn(k, var)) : 0.0f);
      const bool outl =
          valid &&
          (__fmul_rn(ecc, 0.5f) > __fdiv_rn(msq1, __fmul_rn(2.0f, k))) &&
          (k >= 2.0f);
      if (live) {
        const int64_t idx = t * C + c;
        ecc_out[idx] = ecc;
        outlier_out[idx] = outl ? 1 : 0;
        if (Full) {
          mean_out[idx] = mean;
          var_out[idx] = var;
        }
      }
    }
  }
  if (live) {
    fk[c] = __fadd_rn(kk0, (float)vl);
    fsum[c] = s;
    fvar[c] = var;
  }
}

template <bool Full>
cudaError_t launch(unsigned blocks, cudaStream_t s, const void* x,
                   const void* m, const void* vlen, const void* k0,
                   const void* sum0, const void* var0, void* mean_out,
                   void* var_out, void* ecc_out, void* outlier_out, void* fk,
                   void* fsum, void* fvar, int64_t T, int64_t C, bool vec) {
  // four blocks of 48 KB an SM need the largest shared-memory carveout
  static const cudaError_t attr = cudaFuncSetAttribute(
      teda_scan_kernel<Full>, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (attr != cudaSuccess) return attr;
  teda_scan_kernel<Full><<<blocks, kThreads, 0, s>>>(
      (const float*)x, (const float*)m, (const int32_t*)vlen,
      (const float*)k0, (const float*)sum0, (const float*)var0,
      (float*)mean_out, (float*)var_out, (float*)ecc_out,
      (uint8_t*)outlier_out, (float*)fk, (float*)fsum, (float*)fvar, T, C,
      vec);
  return cudaSuccess;
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
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  const unsigned blocks = (unsigned)((C + kThreads - 1) / kThreads);
  const bool vec = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      full ? launch<true>(blocks, s, x, m, vlen, k0, sum0, var0, mean_out,
                          var_out, ecc_out, outlier_out, fk, fsum, fvar, T, C,
                          vec)
           : launch<false>(blocks, s, x, m, vlen, k0, sum0, var0, nullptr,
                           nullptr, ecc_out, outlier_out, fk, fsum, fvar, T,
                           C, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
