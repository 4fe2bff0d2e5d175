// Q-format fixed-point datapath as __device__ helpers.
//
// Bit-exact with the JAX package's fixedpoint/qformat.py (sat_add,
// sat_sub, sat_mul / _mul_wide) and kernels/qdiv.py (fast_div_mag,
// fast_div_qq, fast_div_qi), and with their PyTorch ports in
// repro_torch/fixedpoint/qformat.py and repro_torch/kernels/qdiv.py.
// Shared by every Q kernel: teda_q_scan.cu and the ensemble kernel's
// teda-q lane (ensemble_scan.cu).
#pragma once

#include <cstdint>

struct QFmt {
  int word_len;   // total bits, 2..32
  int frac_len;   // fractional bits, 0..min(word_len - 1, 30)
  int round;      // 1: round half away from zero after mul/div; 0: trunc
  int32_t qmax;   // 2^(word_len-1) - 1; the range is symmetric
};

__host__ __device__ inline QFmt make_qfmt(int word_len, int frac_len,
                                          int round) {
  QFmt f;
  f.word_len = word_len;
  f.frac_len = frac_len;
  f.round = round;
  f.qmax = (int32_t)((1u << (word_len - 1)) - 1u);
  return f;
}

// Clamp an exact sum into [-qmax, qmax].
__device__ __forceinline__ int32_t q_sat64(const QFmt& f, int64_t v) {
  return (int32_t)(v > f.qmax ? f.qmax : (v < -(int64_t)f.qmax
                                              ? -(int64_t)f.qmax : v));
}

// Saturating Q + Q: the exact sum clamped equals the reference's int32
// add with its wrap detection.
__device__ __forceinline__ int32_t q_sat_add(const QFmt& f, int32_t a,
                                             int32_t b) {
  return q_sat64(f, (int64_t)a + (int64_t)b);
}

// Saturating Q - Q; int32 negation wraps at -2^31 in the reference.
__device__ __forceinline__ int32_t q_sat_sub(const QFmt& f, int32_t a,
                                             int32_t b) {
  int32_t nb = (b == INT32_MIN) ? INT32_MIN : -b;
  return q_sat_add(f, a, nb);
}

// |v| as a 32-bit magnitude (2^31 for INT32_MIN, as jnp.abs + uint32).
__device__ __forceinline__ uint32_t q_mag(int32_t v) {
  return v < 0 ? 0u - (uint32_t)v : (uint32_t)v;
}

// Saturating Q * Q: the full product as (hi, lo) 32-bit halves, >> FL
// with the rounding carry, saturation iff P >= 2^(WL-1+FL).
__device__ __forceinline__ int32_t q_sat_mul(const QFmt& f, int32_t a,
                                             int32_t b) {
  const bool neg = (a < 0) != (b < 0);
  const uint64_t p = (uint64_t)q_mag(a) * (uint64_t)q_mag(b);
  uint32_t hi = (uint32_t)(p >> 32);
  uint32_t lo = (uint32_t)p;
  const int fl = f.frac_len;
  if (f.round && fl > 0) {
    const uint32_t lo2 = lo + (1u << (fl - 1));
    hi += (lo2 < lo) ? 1u : 0u;
    lo = lo2;
  }
  const int p_star = f.word_len - 1 + fl;
  bool over;
  if (p_star >= 32) {
    over = hi >= (1u << (p_star - 32));
  } else {
    over = (hi > 0u) || (lo >= (1u << p_star));
  }
  const uint32_t q = (fl == 0) ? lo : ((lo >> fl) | (hi << (32 - fl)));
  const int32_t qi = over ? f.qmax : (int32_t)q;
  return neg ? -qi : qi;
}

// The divider.  The bit-serial restoring divider's bits are, for
// d > 0, min(Q + h, qmax) with Q = floor((n << shift) / d), R the
// remainder and h = round && 2R >= d (its lost-bit flag is set exactly
// when Q >= 2^32, and then Q + h > qmax too); d == 0 gives qmax.  Here
// Q comes from a reciprocal estimate and one exact correction step:
//   rcp = rn(rn(1 / d) * (1 - 2^-40)), qe = rn(rn(N) * rcp) with
//   N = n << shift (<= 2^61): three roundings of at most 2^-53 each
//   and the bias give (N / d)(1 - 2^-39) < qe <= N / d;
//   sat  qe >= qmax + 2: then Q >= qmax + 1 and the result is qmax;
//   else N / d < qmax + 3 <= 2^31 + 2, so N / d - qe < 1 and
//        q = trunc(qe) is Q - 1 or Q; the remainder N - q d lies in
//        [0, 2d), below 2^32, so the low 32 bits of N - q * d are
//        exact, and one step up (r >= d) gives Q and R.
// Only correctly rounded IEEE double operations feed the estimate (no
// fast-math), so a float64 mirror reproduces it bit for bit
// (`repro_torch/kernels/qdiv.py::recip_div_mag`).  The caller passes
// `rcp` = q_recip(d), so that the dividers by one k share it.
__device__ __forceinline__ double q_recip(uint32_t d) {
  return __dmul_rn(__drcp_rn((double)(d == 0u ? 1u : d)),
                   1.0 - 0x1p-40);
}

__device__ __forceinline__ uint32_t q_recip_div_mag(uint32_t n, uint32_t d,
                                                    int shift, int round,
                                                    uint32_t qmax,
                                                    double rcp) {
  const uint64_t N = (uint64_t)n << shift;
  const double qe = __dmul_rn(
      shift == 0 ? __uint2double_rn(n) : __ull2double_rn(N), rcp);
  const bool sat = d == 0u || qe >= (double)qmax + 2.0;
  uint32_t q = __double2uint_rz(qe);  // saturates; only when sat
  uint32_t r = (uint32_t)N - q * d;
  if (r >= d) {
    q += 1u;
    r -= d;
  }
  const uint32_t qh = q + ((round && r >= d - r) ? 1u : 0u);
  return (sat || qh > qmax) ? qmax : qh;
}

// floor((n << shift) / d) on 32-bit magnitudes (n, d <= 2^31, shift
// 0..30), rounded and saturated: the bits of the bit-serial divider.
__device__ __forceinline__ uint32_t q_fast_div_mag(uint32_t n, uint32_t d,
                                                   int shift, int round,
                                                   uint32_t qmax) {
  return q_recip_div_mag(n, d, shift, round, qmax, q_recip(d));
}

// Saturating Q / Q -> Q, bit-equal to the reference's div_qq; `rcp` is
// q_recip(|den|).
__device__ __forceinline__ int32_t q_div_qq_r(const QFmt& f, int32_t num,
                                              int32_t den, double rcp) {
  const bool neg = (num < 0) != (den < 0);
  const int32_t q = (int32_t)q_recip_div_mag(q_mag(num), q_mag(den),
                                             f.frac_len, f.round,
                                             (uint32_t)f.qmax, rcp);
  return neg ? -q : q;
}

// Saturating Q / int -> Q, bit-equal to the reference's div_qi; `rcp`
// is q_recip(|k|).
__device__ __forceinline__ int32_t q_div_qi_r(const QFmt& f, int32_t num,
                                              int32_t k, double rcp) {
  const bool neg = (num < 0) != (k < 0);
  const int32_t q = (int32_t)q_recip_div_mag(q_mag(num), q_mag(k), 0,
                                             f.round, (uint32_t)f.qmax, rcp);
  return neg ? -q : q;
}

__device__ __forceinline__ int32_t q_fast_div_qq(const QFmt& f, int32_t num,
                                                 int32_t den) {
  return q_div_qq_r(f, num, den, q_recip(q_mag(den)));
}

__device__ __forceinline__ int32_t q_fast_div_qi(const QFmt& f, int32_t num,
                                                 int32_t k) {
  return q_div_qi_r(f, num, k, q_recip(q_mag(k)));
}

// The reciprocal of 2k from that of k: q_recip(2x) = q_recip(x) / 2
// exactly (each rounding scales by the power of two, no subnormals),
// unless the int32 2k wrapped.
__device__ __forceinline__ int32_t q_twice(int32_t k) {  // int32 2k, wrapping
  return (int32_t)(2u * (uint32_t)k);
}

__device__ __forceinline__ double q_recip_2k(int32_t k, double rcp_k) {
  const uint32_t d2 = q_mag(q_twice(k));
  double r = __dmul_rn(rcp_k, 0.5);
  if (d2 != 2u * q_mag(k)) r = q_recip(d2);
  return r;
}

// Float -> Q, bit-equal to QFormat.quantize: the float32 product with
// the scale, round half to even, NaN -> 0, then a saturating convert
// (infinities included) into [-qmax, qmax].  v is integral, so the
// truncating convert is exact below 2^31 and saturates above it.
__device__ __forceinline__ int32_t q_quantize_f32(const QFmt& f, float x) {
  const float v = rintf(__fmul_rn(x, (float)(1u << f.frac_len)));
  if (v != v) return 0;
  return min(max(__float2int_rz(v), -f.qmax), f.qmax);
}

// R rows of univariate Q-format TEDA, the reference's `_q_step_u`
// (eqs (1)-(6)) at instants k1 .. k1 + R - 1 from the carried mean and
// var, in the reference kernel's block passes
// (src/repro/kernels/teda_q_scan.py), one shared reciprocal of k per
// row for the dividers by k and 2k:
//   1. rk = (k-1)/k (Q/Q), xk = x/k (Q/int);
//   2. the mean chain mean_n = sat(rk*mean + xk) (k = 1: rk = 0, x/1 = x);
//   3. d2 = (x - mean_n)^2, e = d2/k (0 at k = 1);
//   4. the var chain var_n = sat(rk*var + e);
//   5. inv = 1/k, thr = msq1/(2k), ecc = inv + (d2/var_n)/k (var_n > 0
//      guard), outlier = (ecc >> 1) > thr && k >= 2.
// Only the two chains carry from row to row; the dividers of a tile
// issue back to back around them.  Rows r < n_valid advance mean and
// var; the per-row outputs come from the unfrozen mean_n/var_n, and
// the caller gates the outlier on validity.
template <int R>
__device__ __forceinline__ void q_teda_tile(
    const QFmt& f, int32_t k1, int n_valid, const int32_t (&xv)[R],
    int32_t msq1, int32_t& mean, int32_t& var, int32_t (&mean_n)[R],
    int32_t (&var_n)[R], int32_t (&ecc)[R], bool (&outlier)[R]) {
  int32_t rk[R], xk[R], d2[R];
  double rcp[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {  // 1. the dividers the mean chain needs
    const int32_t k = k1 + r;
    rcp[r] = q_recip(q_mag(k));
    rk[r] = q_div_qq_r(f, k - 1, k, rcp[r]);
    xk[r] = q_div_qi_r(f, xv[r], k, rcp[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {  // 2. MEAN, eq (2)
    mean_n[r] = q_sat_add(f, q_sat_mul(f, rk[r], mean), xk[r]);
    if (r < n_valid) mean = mean_n[r];
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {  // 3. deviation and e = d2/k
    const int32_t d = q_sat_sub(f, xv[r], mean_n[r]);
    d2[r] = q_sat_mul(f, d, d);
    xk[r] = (k1 + r <= 1) ? 0 : q_div_qi_r(f, d2[r], k1 + r, rcp[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {  // 4. VARIANCE, eq (3)
    var_n[r] = q_sat_add(f, q_sat_mul(f, rk[r], var), xk[r]);
    if (r < n_valid) var = var_n[r];
  }
  const int32_t one = (int32_t)(1u << f.frac_len);
#pragma unroll
  for (int r = 0; r < R; ++r) {  // 5. ECCENTRICITY + OUTLIER, (1)(5)(6)
    const int32_t k = k1 + r;
    const int32_t inv = q_div_qi_r(f, one, k, rcp[r]);
    const int32_t thr = q_div_qi_r(f, msq1, q_twice(k), q_recip_2k(k, rcp[r]));
    const bool pos = var_n[r] > 0;
    const int32_t ratio = q_fast_div_qq(f, d2[r], pos ? var_n[r] : 1);
    const int32_t term = pos ? q_div_qi_r(f, ratio, k, rcp[r]) : 0;
    ecc[r] = q_sat_add(f, inv, term);
    outlier[r] = ((ecc[r] >> 1) > thr) && (k >= 2);
  }
}
