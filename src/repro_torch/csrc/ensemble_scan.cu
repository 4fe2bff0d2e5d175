// Fused detector ensemble over C independent channel streams: K members
// (teda, rde, zscore, hst, teda-q) in one pass.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/ensemble_scan.py::ensemble_scan_kernel.  There the
// sequential grid axis walked time blocks over a (rows, block_c) VMEM
// tile of the packed aux state, the moment fabric was a Hillis-Steele
// prefix sum plus an affine variance scan, the zscore tail moved by W
// masked reductions, and hst and teda-q ran per-row loops.  Here a
// block covers nc = 128 channels with two groups of warps, each thread
// walking the T rows of one channel in tiles of kRows rows:
//   float warps (threads [0, nc)): the moment fabric, teda, rde,
//     zscore and hst, the carries S, S2, the TEDA variance and the hst
//     phase in registers, the 8 + 8 hst leaf masses in shared memory,
//     then the bits and the vote of all members;
//   Q warps (threads [nc, 2 nc), only with teda-q): the integer lane,
//     q_teda_tile (qformat.cuh) on a register tile, its score stream
//     and its carries; each tile's per-row flags go to a shared-memory
//     ring of two buffers of kRows x nc bytes.
// The float warps read a tile's Q flags after the named barrier kFull
// + b and release the buffer at kEmpty + b, so the two groups run a
// tile apart, the integer and float pipes busy for different warps.
// Without teda-q the block is the float warps alone, compiled without
// the Q lane and its barriers, with twice the registers per thread.
// The zscore window needs the last W prefix sums; W is a runtime value,
// so that ring lives in dynamic shared memory too, laid out
// [S | S2][slot][channel] (no bank conflicts: a warp reads one slot).
// Threads past C stay for the barriers, their memory predicated off.
//
// Per row, with k = k0 + t + 1 (float32) and valid = t < vlen:
//   moment fabric  S += x, S2 += x^2 on valid rows; mean = S / k
//   teda    the arithmetic of teda_scan.cu, operation for operation
//   rde     varb = S2/k - mean^2; flag (x-mean)^2 > m^2 varb
//   zscore  window sums S - S_{k-W} from the ring; n = min(k, W)
//   hst     leaf = clamp(floor(x + 4), 0, 7) (NaN: no leaf); score =
//           ref[leaf]; window flip when phase reaches W * 8
//   teda-q  q_teda_tile (qformat.cuh) on the quantized samples, msq1 =
//           quantize(m*m + 1) in float32
//   bits    bit d = member d flagged && sel[d] > 0 && valid
//   vote    sum_d flag_d * sel[d] in detector order (float32) >= thr &&
//           sum_d sel[d] > 0 && valid
//   scores  K float streams, zero past vlen, not selection-gated
// Every float operation is written with a _rn intrinsic, so nvcc
// contracts nothing into an FMA: rde's S2/k - mean^2 and zscore's
// winsq/n - muw^2 cancel badly at small k, and the kernel must round
// where its plain PyTorch version does.
//
// Carry discipline of the aux block, as the reference: rows the
// ensemble's members do not own keep their bits.  Without zscore only
// row W-1 of the S tail (and row 2W-1 of S2, with rde) advances; the
// variance row 2W advances only with teda; with no moment member rows
// [0, 2W] stay.  With zscore the tails advance to the valid extent.
// The aux block moves as raw 32-bit words; int32 Q payloads are never
// seen as floats.
//
// Bound on the card: bytes, for K = 5 at the engine's widths: 4 B in
// and 4 (bits) + 1 (vote) + 4K (scores) B out per sample; the teda-q
// lane's six dividers per row and the float lanes' dozen IEEE divides
// make it operation-heavy too, which the Q warps spread over twice the
// warps.  One thread per channel and lane under-fills the card below
// C = 65,536; time-parallel designs are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "device_guard.cuh"
#include "qformat.cuh"

namespace {

constexpr int kChannels = 128;  // channels per block (halved for large W)
constexpr int kRows = 2;        // rows per tile
constexpr int kMaxK = 5;
constexpr int kLeaves = 8;
constexpr float kHstLo = -4.0f;
constexpr float kHstScale = 1.0f;  // kLeaves / (hi - lo) over [-4, 4)
// named barriers (0 is __syncthreads'): ring buffer b is full at
// kFull + b (the Q warps arrive, the float warps wait) and empty again
// at kEmpty + b (the float warps arrive, the Q warps wait)
constexpr int kFull = 1;
constexpr int kEmpty = 3;

// member types, in the reference's canonical order
enum Member { kTeda = 0, kRde = 1, kZscore = 2, kHst = 3, kTedaQ = 4 };

struct Layout {
  int K;             // members in the ensemble
  int type[kMaxK];   // member type at bit position d (d < K)
  int pos[kMaxK];    // bit position of each member type, -1 when absent
  int window;        // W
  int rows;          // aux rows of the StateSpec
  int hst_off;       // first row of hst:ref (-1 without hst)
  int tq_off;        // row of teda-q:mean (-1 without teda-q)
};

// Non-aligned barriers: a warp whose last channels lie past C still
// takes every barrier, its out-of-range threads predicated off.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("barrier.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// The teda-q lane of one channel: its two Q registers, the ROM
// constant quantized from the float32 m, and one tile of rows at a time
// through q_teda_tile (qformat.cuh).  Each tile writes its teda-q
// scores and leaves its per-row flags in the ring slot `flags`
// ([row][channel], stride nc).
struct QLane {
  int32_t mean, var, msq1, k0;
  float x_next[kRows];  // the next tile's samples, loads in flight

  __device__ __forceinline__ void load(const QFmt& f, const Layout& L,
                                       const uint32_t* aux, const float* x,
                                       float kk0, float msq1f, int64_t T,
                                       int64_t C, int64_t c, bool live) {
    mean = live ? (int32_t)aux[L.tq_off * C + c] : 0;
    var = live ? (int32_t)aux[(L.tq_off + 1) * C + c] : 0;
    msq1 = q_quantize_f32(f, msq1f);
    k0 = (int32_t)kk0;  // exact: k < 2^24
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      x_next[r] = (live && r < T) ? x[r * C + c] : 0.0f;
  }

  __device__ __forceinline__ void tile(const QFmt& f, const float* x,
                                       int64_t t0, int64_t T, int32_t vl,
                                       float* score, int64_t C, int64_t c,
                                       bool live, uint8_t* flags, int ch,
                                       int nc) {
    int32_t xq[kRows], mn[kRows], vn[kRows], ecc[kRows];
    bool out[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      xq[r] = q_quantize_f32(f, x_next[r]);
      const int64_t t = t0 + kRows + r;
      x_next[r] = (live && t < T) ? x[t * C + c] : 0.0f;
    }
    const int64_t left = (int64_t)vl - t0;
    const int n_valid = left <= 0 ? 0 : (left >= kRows ? kRows : (int)left);
    q_teda_tile<kRows>(f, k0 + (int32_t)t0 + 1, n_valid, xq, msq1, mean, var,
                       mn, vn, ecc, out);
    // ecc / 2^FL: scaling by a power of two is exact in float32 (no
    // overflow or subnormal for |ecc| < 2^31, FL <= 30), so the product
    // with 2^-FL is the quotient's bits
    const float qinv = __fdiv_rn(1.0f, (float)(1u << f.frac_len));
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (live && t0 + r < T)
        score[(t0 + r) * C + c] =
            r < n_valid ? __fmul_rn(__int2float_rn(ecc[r]), qinv) : 0.0f;
      flags[r * nc + ch] = out[r] ? 1 : 0;
    }
  }
};

// HasQ (teda-q a member): a block of 2 nc threads covers nc channels;
// threads [0, nc) are the float warps, [nc, 2 nc) the Q warps.  Without
// it a block is the nc float threads.  Both keep all 512 blocks of
// C = 65,536 resident at once: 4 blocks of 256 threads (64 registers)
// or of 128 (128 registers) per SM.
template <bool HasQ>
__global__ void __launch_bounds__(HasQ ? 2 * kChannels : kChannels, 4)
ensemble_scan_kernel(const float* __restrict__ x,
                     const int32_t* __restrict__ vlen,
                     const float* __restrict__ k0,
                     const float* __restrict__ m,
                     const float* __restrict__ thr,
                     const float* __restrict__ sel,
                     const uint32_t* __restrict__ aux,
                     int32_t* __restrict__ bits_out,
                     uint8_t* __restrict__ vote_out,
                     float* __restrict__ fk_out,
                     uint32_t* __restrict__ aux_out,
                     float* __restrict__ scores, int64_t T, int64_t C,
                     Layout L, QFmt f, int nc) {
  extern __shared__ float smem[];
  const int W = L.window;
  const bool has_teda = L.pos[kTeda] >= 0;
  const bool has_rde = L.pos[kRde] >= 0;
  const bool has_z = L.pos[kZscore] >= 0;
  const bool has_hst = L.pos[kHst] >= 0;
  const bool moment = has_teda || has_rde || has_z;
  const bool need_s2 = has_rde || has_z;
  const int64_t TC = T * C;
  const int64_t n_tiles = (T + kRows - 1) / kRows;
  const int nb = 2 * nc;  // threads at each named barrier
  // out-of-range threads stay for the barriers, their memory predicated
  const int ch = threadIdx.x % nc;
  const int64_t c = (int64_t)blockIdx.x * nc + ch;
  const bool live = c < C;
  // shared memory, per channel: the zscore ring, the hst leaf masses,
  // the teda-q flag ring
  float* hst_s = smem + (has_z ? 2 * W * nc : 0) + ch;  // [ref|cur][leaf]
  uint8_t* qring = reinterpret_cast<uint8_t*>(
      smem + (has_z ? 2 * W * nc : 0) + (has_hst ? 2 * kLeaves * nc : 0));

  const float kk0 = live ? k0[c] : 0.0f;
  const int32_t vl = live ? vlen[c] : 0;
  const float mm = live ? m[c] : 0.0f;
  const float m2 = __fmul_rn(mm, mm);
  const float msq1 = __fadd_rn(m2, 1.0f);

  if (HasQ && threadIdx.x >= nc) {  // ---- the Q warps
    float* qscore = scores + L.pos[kTedaQ] * TC;
    QLane q;
    q.load(f, L, aux, x, kk0, msq1, T, C, c, live);
    for (int64_t i = 0; i < n_tiles; ++i) {
      const int b = (int)(i & 1);
      if (i >= 2) bar_sync(kEmpty + b, nb);  // the float warps read i - 2
      q.tile(f, x, i * kRows, T, vl, qscore, C, c, live,
             qring + b * kRows * nc, ch, nc);
      bar_arrive(kFull + b, nb);
    }
    if (live) {
      aux_out[L.tq_off * C + c] = (uint32_t)q.mean;
      aux_out[(L.tq_off + 1) * C + c] = (uint32_t)q.var;
    }
    return;
  }

  // ---- the float warps
  const float th = live ? thr[c] : 0.0f;
  float w[kMaxK];
  float totw = 0.0f;
  uint32_t selmask = 0;  // bit d: member d selected (w[d] > 0)
#pragma unroll
  for (int d = 0; d < kMaxK; ++d) {
    w[d] = (d < L.K && live) ? sel[d * C + c] : 0.0f;
    if (d < L.K) totw = __fadd_rn(totw, w[d]);
    if (d < L.K && w[d] > 0.0f) selmask |= 1u << d;
  }

  // every row passes through as raw bits but the teda-q rows, which the
  // Q warps write; the lanes overwrite their own rows after the loop
  if (live) {
    for (int r = 0; r < L.rows; ++r)
      if (!HasQ || (r != L.tq_off && r != L.tq_off + 1))
        aux_out[r * C + c] = aux[r * C + c];
  }

  // ---- moment fabric: S, S2, the TEDA variance, the zscore ring
  float s = 0.0f, s2 = 0.0f, var = 0.0f;
  float* ring_s = smem + ch;
  float* ring_s2 = smem + W * nc + ch;
  if (moment && live) {
    s = __uint_as_float(aux[(W - 1) * C + c]);
    if (need_s2) s2 = __uint_as_float(aux[(2 * W - 1) * C + c]);
    if (has_teda) var = __uint_as_float(aux[2 * W * C + c]);
    if (has_z) {
      for (int j = 0; j < W; ++j) {
        ring_s[j * nc] = __uint_as_float(aux[j * C + c]);
        ring_s2[j * nc] = __uint_as_float(aux[(W + j) * C + c]);
      }
    }
  }

  // ---- hst: reference and filling leaf masses (shared memory, so that
  // a row touches only its own leaf), the reference's mass, the phase.
  // The plain version adds 0 to every other filling leaf on every row:
  // that changes a mass only on the first row (-0 and NaN payloads
  // become +0 and the canonical NaN), so the kernel adds 0 to all of
  // them once, before the first row, and 1 to the row's leaf after.
  float phase = 0.0f, mass = 0.0f;
  const float wn = (float)(W * kLeaves);
  if (has_hst) {
#pragma unroll
    for (int l = 0; l < kLeaves; ++l) {
      const float rf =
          live ? __uint_as_float(aux[(L.hst_off + l) * C + c]) : 0.0f;
      const float cu =
          live ? __uint_as_float(aux[(L.hst_off + kLeaves + l) * C + c])
               : 0.0f;
      hst_s[l * nc] = rf;
      hst_s[(kLeaves + l) * nc] = T > 0 ? __fadd_rn(cu, 0.0f) : cu;
      mass = __fadd_rn(mass, rf);
    }
    if (live)
      phase = __uint_as_float(aux[(L.hst_off + 2 * kLeaves) * C + c]);
  }

  float x_next = (live && T > 0) ? x[c] : 0.0f;
  int slot = 0;  // zscore ring slot of row t: t mod W
  for (int64_t i = 0; i < n_tiles; ++i) {
    const int64_t t0 = i * kRows;
    const int b = (int)(i & 1);
    const uint8_t* qflags = qring + b * kRows * nc;
    if (HasQ) bar_sync(kFull + b, nb);  // this tile's teda-q flags
#pragma unroll 1
    for (int r = 0; r < kRows; ++r) {
      const int64_t t = t0 + r;
      if (t >= T) break;
      const int64_t idx = t * C + c;
      const float xv = x_next;
      if (live && t + 1 < T) x_next = x[idx + C];  // next row in flight
      const bool valid = t < vl;
      const float k = __fadd_rn(__fadd_rn(kk0, (float)t), 1.0f);
      uint32_t fl = 0;  // by bit position

      if (moment) {
        if (valid) s = __fadd_rn(s, xv);
        if (need_s2 && valid) s2 = __fadd_rn(s2, __fmul_rn(xv, xv));
        const float mean = __fdiv_rn(s, k);
        const float dd = __fsub_rn(xv, mean);
        const float dr = __fmul_rn(dd, dd);

        if (has_teda) {  // eqs (1)-(6), as teda_scan.cu
          const bool first = k <= 1.0f;
          const float d2 = (first || !valid) ? 0.0f : dr;
          float a = first ? 0.0f : __fdiv_rn(__fsub_rn(k, 1.0f), k);
          if (!valid) a = 1.0f;
          var = __fadd_rn(__fmul_rn(a, var), __fdiv_rn(d2, k));
          const bool safe = var > 0.0f;
          const float ecc = __fadd_rn(
              __fdiv_rn(1.0f, k),
              safe ? __fdiv_rn(d2, __fmul_rn(k, var)) : 0.f);
          if ((__fmul_rn(ecc, 0.5f) > __fdiv_rn(msq1, __fmul_rn(2.0f, k)))
              && (k >= 2.0f))
            fl |= 1u << L.pos[kTeda];
          if (live) scores[L.pos[kTeda] * TC + idx] = valid ? ecc : 0.0f;
        }
        if (has_rde) {  // biased variance from the running moments
          const float varb =
              __fsub_rn(__fdiv_rn(s2, k), __fmul_rn(mean, mean));
          const bool ok = varb > 0.0f;
          if (ok && (k >= 2.0f) && (dr > __fmul_rn(m2, varb)))
            fl |= 1u << L.pos[kRde];
          const float dens = __fdiv_rn(
              1.0f, __fadd_rn(1.0f, ok ? __fdiv_rn(dr, varb) : 0.0f));
          if (live) scores[L.pos[kRde] * TC + idx] = valid ? dens : 0.0f;
        }
        if (has_z) {  // window sums against the prefix sum W rows back
          const float lag = ring_s[slot * nc];
          const float lag2 = ring_s2[slot * nc];
          const float n = fminf(k, (float)W);
          const float muw = __fdiv_rn(__fsub_rn(s, lag), n);
          const float sigw = __fsub_rn(__fdiv_rn(__fsub_rn(s2, lag2), n),
                                       __fmul_rn(muw, muw));
          const float dz0 = __fsub_rn(xv, muw);
          const float dz = __fmul_rn(dz0, dz0);
          const bool okz = sigw > 0.0f;
          if (okz && (k >= 2.0f) && (dz > __fmul_rn(m2, sigw)))
            fl |= 1u << L.pos[kZscore];
          if (live)
            scores[L.pos[kZscore] * TC + idx] =
                (valid && okz) ? __fdiv_rn(dz, sigw) : 0.0f;
          if (valid) {
            ring_s[slot * nc] = s;
            ring_s2[slot * nc] = s2;
          }
        }
      }

      if (has_hst) {
        int leaf = -1;  // a NaN sample lands in no cell
        if (!isnan(xv)) {
          const float lf =
              floorf(__fmul_rn(__fsub_rn(xv, kHstLo), kHstScale));
          leaf = (int)fminf(fmaxf(lf, 0.0f), (float)(kLeaves - 1));
        }
        const float score = leaf >= 0 ? hst_s[leaf * nc] : 0.0f;
        if (valid && (mass > 0.0f) && (__fmul_rn(score, mm) < (float)W))
          fl |= 1u << L.pos[kHst];
        if (valid && leaf >= 0) {
          float* cl = hst_s + (kLeaves + leaf) * nc;
          *cl = __fadd_rn(*cl, 1.0f);
        }
        phase = __fadd_rn(phase, valid ? 1.0f : 0.0f);
        if (phase == wn) {  // the filling window becomes the reference
          mass = 0.0f;
#pragma unroll
          for (int l = 0; l < kLeaves; ++l) {
            const float cu = hst_s[(kLeaves + l) * nc];
            hst_s[l * nc] = cu;
            hst_s[(kLeaves + l) * nc] = 0.0f;
            mass = __fadd_rn(mass, cu);
          }
          phase = 0.0f;
        }
        if (live) scores[L.pos[kHst] * TC + idx] = valid ? score : 0.0f;
      }
      if (HasQ && qflags[r * nc + ch]) fl |= 1u << L.pos[kTedaQ];

      // selection-gated bitmask and the weighted vote, in detector order
      const int32_t bits = valid ? (int32_t)(fl & selmask) : 0;
      float votew = 0.0f;
#pragma unroll
      for (int d = 0; d < kMaxK; ++d)
        if (d < L.K)
          votew = __fadd_rn(votew, __fmul_rn((bits >> d) & 1 ? 1.0f : 0.0f,
                                             w[d]));
      if (live) {
        bits_out[idx] = bits;
        vote_out[idx] = (votew >= th && totw > 0.0f && valid) ? 1 : 0;
      }
      if (++slot == W) slot = 0;
    }
    if (HasQ && i + 2 < n_tiles) bar_arrive(kEmpty + b, nb);
  }

  // ---- final carries
  if (!live) return;
  fk_out[c] = __fadd_rn(kk0, (float)vl);
  if (moment) {
    if (has_z) {  // tail row j = S_{k-(W-1)+j}: the ring read from vlen on
      for (int j = 0; j < W; ++j) {
        const int qs = (vl + j) % W;
        aux_out[j * C + c] = __float_as_uint(ring_s[qs * nc]);
        aux_out[(W + j) * C + c] = __float_as_uint(ring_s2[qs * nc]);
      }
    } else {
      aux_out[(W - 1) * C + c] = __float_as_uint(s);
      if (need_s2) aux_out[(2 * W - 1) * C + c] = __float_as_uint(s2);
    }
    if (has_teda) aux_out[2 * W * C + c] = __float_as_uint(var);
  }
  if (has_hst) {
#pragma unroll
    for (int l = 0; l < kLeaves; ++l) {
      aux_out[(L.hst_off + l) * C + c] = __float_as_uint(hst_s[l * nc]);
      aux_out[(L.hst_off + kLeaves + l) * C + c] =
          __float_as_uint(hst_s[(kLeaves + l) * nc]);
    }
    aux_out[(L.hst_off + 2 * kLeaves) * C + c] = __float_as_uint(phase);
  }
}

}  // namespace

namespace {

template <bool HasQ>
int launch(const void* x, const void* vlen, const void* k0, const void* m,
           const void* thr, const void* sel, const void* aux, void* bits,
           void* vote, void* fk, void* aux_out, void* scores, long long T,
           long long C, const Layout& L, const QFmt& f, cudaStream_t stream) {
  // shared memory per channel: the zscore ring (2 W floats), the hst
  // leaf masses (16 floats) and the teda-q flag ring (2 buffers of
  // kRows bytes); halve the block until it fits the 227 KB a block may
  // use
  const size_t per_ch =
      (L.pos[kZscore] >= 0 ? 2 * L.window * sizeof(float) : 0) +
      (L.pos[kHst] >= 0 ? 2 * kLeaves * sizeof(float) : 0) +
      (HasQ ? 2 * kRows : 0);
  int nc = kChannels;
  while (per_ch * nc > 227 * 1024 && nc > 32) nc /= 2;
  const size_t smem = per_ch * nc;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ensemble_scan_kernel<HasQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = HasQ ? 2 * nc : nc;
  const unsigned blocks = (unsigned)((C + nc - 1) / nc);
  ensemble_scan_kernel<HasQ><<<blocks, threads, smem, stream>>>(
      (const float*)x, (const int32_t*)vlen, (const float*)k0,
      (const float*)m, (const float*)thr, (const float*)sel,
      (const uint32_t*)aux, (int32_t*)bits, (uint8_t*)vote, (float*)fk,
      (uint32_t*)aux_out, (float*)scores, T, C, L, f, nc);
  return (int)cudaGetLastError();
}

int run(const void* x, const void* vlen, const void* k0,
        const void* m, const void* thr, const void* sel, const void* aux,
        void* bits, void* vote, void* fk, void* aux_out, void* scores,
        long long T, long long C, int K, int window, int rows,
        const int (&types)[kMaxK], int hst_off, int tq_off, int word_len,
        int frac_len, int rounding, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.error() != cudaSuccess) return (int)guard.error();
  if (K < 1 || K > kMaxK || window < 1) return (int)cudaErrorInvalidValue;
  Layout L;
  L.K = K;
  for (int i = 0; i < kMaxK; ++i) L.pos[i] = -1;
  for (int d = 0; d < kMaxK; ++d) {
    L.type[d] = d < K ? types[d] : -1;
    if (d < K) {
      if (types[d] < 0 || types[d] >= kMaxK || L.pos[types[d]] >= 0)
        return (int)cudaErrorInvalidValue;
      L.pos[types[d]] = d;
    }
  }
  L.window = window;
  L.rows = rows;
  L.hst_off = hst_off;
  L.tq_off = tq_off;
  const QFmt f = make_qfmt(word_len, frac_len, rounding);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L.pos[kTedaQ] >= 0)
    return launch<true>(x, vlen, k0, m, thr, sel, aux, bits, vote, fk,
                        aux_out, scores, T, C, L, f, s);
  return launch<false>(x, vlen, k0, m, thr, sel, aux, bits, vote, fk,
                       aux_out, scores, T, C, L, f, s);
}

}  // namespace

// x (T, C) f32; vlen (C,) int32 in [0, T]; k0, m, thr (C,) f32; sel
// (K, C) f32; aux (rows, C) 32-bit words.  Outputs: bits (T, C) int32,
// vote (T, C) u8 0/1, fk (C,) f32, aux_out (rows, C), scores (K, T, C)
// f32.  type0..type4 are the member types at bit positions 0..K-1 (0
// teda, 1 rde, 2 zscore, 3 hst, 4 teda-q); hst_off and tq_off the
// members' first aux rows (-1 when absent); the Q format is (word_len,
// frac_len, rounding: 1 = round, 0 = trunc).  With teda-q the block
// splits into float and Q warps.  Launches on `stream`; returns a CUDA
// error code as an int (cudaErrorInvalidValue for a layout it cannot
// take).
extern "C" int ensemble_scan_f32(const void* x, const void* vlen,
                                 const void* k0, const void* m,
                                 const void* thr, const void* sel,
                                 const void* aux, void* bits, void* vote,
                                 void* fk, void* aux_out, void* scores,
                                 long long T, long long C, int K, int window,
                                 int rows, int type0, int type1, int type2,
                                 int type3, int type4, int hst_off,
                                 int tq_off, int word_len, int frac_len,
                                 int rounding, int device, void* stream) {
  const int types[kMaxK] = {type0, type1, type2, type3, type4};
  return run(x, vlen, k0, m, thr, sel, aux, bits, vote, fk, aux_out,
             scores, T, C, K, window, rows, types, hst_off, tq_off, word_len,
             frac_len, rounding, device, stream);
}
