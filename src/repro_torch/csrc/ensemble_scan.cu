// Fused detector ensemble over C independent channel streams: K members
// (teda, rde, zscore, hst, teda-q) in one pass, one thread per channel.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/ensemble_scan.py::ensemble_scan_kernel.  There the
// sequential grid axis walked time blocks over a (rows, block_c) VMEM
// tile of the packed aux state, the moment fabric was a Hillis-Steele
// prefix sum plus an affine variance scan, the zscore tail moved by W
// masked reductions, and hst and teda-q ran per-row loops.  Here each
// thread walks the T rows of its channel in order with every carry in
// registers: the running sum S and sum of squares S2, the TEDA
// variance, the 8 + 8 hst leaf masses and phase, the Q mean and var.
// The zscore window needs the last W prefix sums; W is a runtime value,
// so that ring lives in dynamic shared memory laid out
// [S | S2][slot][threadIdx] (no bank conflicts: a warp reads one slot).
//
// Per row, with k = k0 + t + 1 (float32) and valid = t < vlen:
//   moment fabric  S += x, S2 += x^2 on valid rows; mean = S / k
//   teda    the arithmetic of teda_scan.cu, operation for operation
//   rde     varb = S2/k - mean^2; flag (x-mean)^2 > m^2 varb
//   zscore  window sums S - S_{k-W} from the ring; n = min(k, W)
//   hst     leaf = clamp(floor(x + 4), 0, 7) (NaN: no leaf); score =
//           ref[leaf]; window flip when phase reaches W * 8
//   teda-q  q_teda_row (qformat.cuh) on the quantized sample, msq1 =
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
// lane's six software integer divides per row make it operation-heavy
// too.  One thread per channel under-fills the card below C = 65,536;
// time-parallel designs are later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "qformat.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxK = 5;
constexpr int kLeaves = 8;
constexpr float kHstLo = -4.0f;
constexpr float kHstScale = 1.0f;  // kLeaves / (hi - lo) over [-4, 4)

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

__global__ void __launch_bounds__(kThreads)
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
                     Layout L, QFmt f) {
  extern __shared__ float ring[];
  const int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;  // no block-wide barrier follows
  const int W = L.window;
  const int bd = blockDim.x;
  const bool has_teda = L.pos[kTeda] >= 0;
  const bool has_rde = L.pos[kRde] >= 0;
  const bool has_z = L.pos[kZscore] >= 0;
  const bool has_hst = L.pos[kHst] >= 0;
  const bool has_q = L.pos[kTedaQ] >= 0;
  const bool moment = has_teda || has_rde || has_z;
  const bool need_s2 = has_rde || has_z;
  const int64_t TC = T * C;

  const float kk0 = k0[c];
  const int32_t vl = vlen[c];
  const float mm = m[c];
  const float m2 = __fmul_rn(mm, mm);
  const float msq1 = __fadd_rn(m2, 1.0f);
  const float th = thr[c];
  float w[kMaxK];
  float totw = 0.0f;
#pragma unroll
  for (int d = 0; d < kMaxK; ++d) {
    w[d] = d < L.K ? sel[d * C + c] : 0.0f;
    if (d < L.K) totw = __fadd_rn(totw, w[d]);
  }

  // every row passes through as raw bits; the lanes overwrite their
  // own rows after the time loop
  for (int r = 0; r < L.rows; ++r) aux_out[r * C + c] = aux[r * C + c];

  // ---- moment fabric: S, S2, the TEDA variance, the zscore ring
  float s = 0.0f, s2 = 0.0f, var = 0.0f;
  float* ring_s = ring + threadIdx.x;
  float* ring_s2 = ring + W * bd + threadIdx.x;
  if (moment) {
    s = __uint_as_float(aux[(W - 1) * C + c]);
    if (need_s2) s2 = __uint_as_float(aux[(2 * W - 1) * C + c]);
    if (has_teda) var = __uint_as_float(aux[2 * W * C + c]);
    if (has_z) {
      for (int j = 0; j < W; ++j) {
        ring_s[j * bd] = __uint_as_float(aux[j * C + c]);
        ring_s2[j * bd] = __uint_as_float(aux[(W + j) * C + c]);
      }
    }
  }

  // ---- hst: reference and filling leaf masses, phase
  float ref[kLeaves], cur[kLeaves], phase = 0.0f;
  const float wn = (float)(W * kLeaves);
#pragma unroll
  for (int l = 0; l < kLeaves; ++l) {
    ref[l] = has_hst ? __uint_as_float(aux[(L.hst_off + l) * C + c]) : 0.f;
    cur[l] = has_hst
                 ? __uint_as_float(aux[(L.hst_off + kLeaves + l) * C + c])
                 : 0.0f;
  }
  if (has_hst) phase = __uint_as_float(aux[(L.hst_off + 2 * kLeaves) * C + c]);

  // ---- teda-q: the int32 Q registers, and the ROM constant quantized
  // from the float32 m
  int32_t qmean = 0, qvar = 0, qmsq1 = 0;
  if (has_q) {
    qmean = (int32_t)aux[L.tq_off * C + c];
    qvar = (int32_t)aux[(L.tq_off + 1) * C + c];
    qmsq1 = q_quantize_f32(f, msq1);
  }
  const int32_t kq0 = (int32_t)kk0;  // exact: k < 2^24
  const float qscale = (float)(1u << f.frac_len);

  float x_next = T > 0 ? x[c] : 0.0f;
  int slot = 0;  // zscore ring slot of row t: t mod W
  for (int64_t t = 0; t < T; ++t) {
    const int64_t idx = t * C + c;
    const float xv = x_next;
    if (t + 1 < T) x_next = x[idx + C];  // next row's load in flight
    const bool valid = t < vl;
    const float k = __fadd_rn(__fadd_rn(kk0, (float)t), 1.0f);
    bool fl_teda = false, fl_rde = false, fl_z = false, fl_hst = false,
         fl_q = false;

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
            __fdiv_rn(1.0f, k), safe ? __fdiv_rn(d2, __fmul_rn(k, var)) : 0.f);
        fl_teda = (__fmul_rn(ecc, 0.5f) > __fdiv_rn(msq1, __fmul_rn(2.0f, k)))
                  && (k >= 2.0f);
        scores[L.pos[kTeda] * TC + idx] = valid ? ecc : 0.0f;
      }
      if (has_rde) {  // biased variance from the running moments
        const float varb = __fsub_rn(__fdiv_rn(s2, k), __fmul_rn(mean, mean));
        const bool ok = varb > 0.0f;
        fl_rde = ok && (k >= 2.0f) && (dr > __fmul_rn(m2, varb));
        const float dens = __fdiv_rn(
            1.0f, __fadd_rn(1.0f, ok ? __fdiv_rn(dr, varb) : 0.0f));
        scores[L.pos[kRde] * TC + idx] = valid ? dens : 0.0f;
      }
      if (has_z) {  // window sums against the prefix sum W rows back
        const float lag = ring_s[slot * bd];
        const float lag2 = ring_s2[slot * bd];
        const float n = fminf(k, (float)W);
        const float muw = __fdiv_rn(__fsub_rn(s, lag), n);
        const float sigw = __fsub_rn(__fdiv_rn(__fsub_rn(s2, lag2), n),
                                     __fmul_rn(muw, muw));
        const float dz0 = __fsub_rn(xv, muw);
        const float dz = __fmul_rn(dz0, dz0);
        const bool okz = sigw > 0.0f;
        fl_z = okz && (k >= 2.0f) && (dz > __fmul_rn(m2, sigw));
        scores[L.pos[kZscore] * TC + idx] =
            (valid && okz) ? __fdiv_rn(dz, sigw) : 0.0f;
        if (valid) {
          ring_s[slot * bd] = s;
          ring_s2[slot * bd] = s2;
        }
      }
    }

    if (has_hst) {
      int leaf = -1;  // a NaN sample lands in no cell
      if (!isnan(xv)) {
        const float lf = floorf(__fmul_rn(__fsub_rn(xv, kHstLo), kHstScale));
        leaf = (int)fminf(fmaxf(lf, 0.0f), (float)(kLeaves - 1));
      }
      float score = 0.0f, mass = 0.0f;
#pragma unroll
      for (int l = 0; l < kLeaves; ++l) {
        if (l == leaf) score = ref[l];
        mass = __fadd_rn(mass, ref[l]);
      }
      fl_hst = valid && (mass > 0.0f) && (__fmul_rn(score, mm) < (float)W);
#pragma unroll
      for (int l = 0; l < kLeaves; ++l)
        cur[l] = __fadd_rn(cur[l], (valid && l == leaf) ? 1.0f : 0.0f);
      phase = __fadd_rn(phase, valid ? 1.0f : 0.0f);
      if (phase == wn) {  // the filling window becomes the reference
#pragma unroll
        for (int l = 0; l < kLeaves; ++l) {
          ref[l] = cur[l];
          cur[l] = 0.0f;
        }
        phase = 0.0f;
      }
      scores[L.pos[kHst] * TC + idx] = valid ? score : 0.0f;
    }

    if (has_q) {
      const int32_t kq = kq0 + (int32_t)t + 1;
      const QTedaRow q =
          q_teda_row(f, kq, q_quantize_f32(f, xv), qmean, qvar, qmsq1);
      if (valid) {
        qmean = q.mean;
        qvar = q.var;
      }
      fl_q = q.outlier;
      scores[L.pos[kTedaQ] * TC + idx] =
          valid ? __fdiv_rn(__int2float_rn(q.ecc), qscale) : 0.0f;
    }

    // selection-gated bitmask and the weighted vote, in detector order
    int32_t bits = 0;
    float votew = 0.0f;
#pragma unroll
    for (int d = 0; d < kMaxK; ++d) {
      if (d < L.K) {
        const int ty = L.type[d];
        bool fd = ty == kTeda ? fl_teda
                : ty == kRde ? fl_rde
                : ty == kZscore ? fl_z
                : ty == kHst ? fl_hst : fl_q;
        fd = fd && (w[d] > 0.0f) && valid;
        bits |= (fd ? 1 : 0) << d;
        votew = __fadd_rn(votew, __fmul_rn(fd ? 1.0f : 0.0f, w[d]));
      }
    }
    bits_out[idx] = bits;
    vote_out[idx] = (votew >= th && totw > 0.0f && valid) ? 1 : 0;
    if (++slot == W) slot = 0;
  }

  // ---- final carries
  fk_out[c] = __fadd_rn(kk0, (float)vl);
  if (moment) {
    if (has_z) {  // tail row j = S_{k-(W-1)+j}: the ring read from vlen on
      for (int j = 0; j < W; ++j) {
        const int q = (vl + j) % W;
        aux_out[j * C + c] = __float_as_uint(ring_s[q * bd]);
        aux_out[(W + j) * C + c] = __float_as_uint(ring_s2[q * bd]);
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
      aux_out[(L.hst_off + l) * C + c] = __float_as_uint(ref[l]);
      aux_out[(L.hst_off + kLeaves + l) * C + c] = __float_as_uint(cur[l]);
    }
    aux_out[(L.hst_off + 2 * kLeaves) * C + c] = __float_as_uint(phase);
  }
  if (has_q) {
    aux_out[L.tq_off * C + c] = (uint32_t)qmean;
    aux_out[(L.tq_off + 1) * C + c] = (uint32_t)qvar;
  }
}

}  // namespace

// x (T, C) f32; vlen (C,) int32 in [0, T]; k0, m, thr (C,) f32; sel
// (K, C) f32; aux (rows, C) 32-bit words.  Outputs: bits (T, C) int32,
// vote (T, C) u8 0/1, fk (C,) f32, aux_out (rows, C), scores (K, T, C)
// f32.  type0..type4 are the member types at bit positions 0..K-1 (0
// teda, 1 rde, 2 zscore, 3 hst, 4 teda-q); hst_off and tq_off the
// members' first aux rows (-1 when absent); the Q format is (word_len,
// frac_len, rounding: 1 = round, 0 = trunc).  Launches on `stream`;
// returns a CUDA error code as an int (cudaErrorInvalidValue for a
// layout it cannot take).
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (K < 1 || K > kMaxK || window < 1) return (int)cudaErrorInvalidValue;
  Layout L;
  L.K = K;
  const int types[kMaxK] = {type0, type1, type2, type3, type4};
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

  // the zscore ring: 2 * W floats per thread; halve the block until it
  // fits the 227 KB a block may use
  int threads = kThreads;
  size_t smem = 0;
  if (L.pos[kZscore] >= 0) {
    smem = (size_t)2 * window * threads * sizeof(float);
    while (smem > 227 * 1024 && threads > 32) {
      threads /= 2;
      smem /= 2;
    }
    if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(ensemble_scan_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
  }
  const unsigned blocks = (unsigned)((C + threads - 1) / threads);
  ensemble_scan_kernel<<<blocks, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      (const float*)x, (const int32_t*)vlen, (const float*)k0,
      (const float*)m, (const float*)thr, (const float*)sel,
      (const uint32_t*)aux, (int32_t*)bits, (uint8_t*)vote, (float*)fk,
      (uint32_t*)aux_out, (float*)scores, T, C, L, f);
  return (int)cudaGetLastError();
}
