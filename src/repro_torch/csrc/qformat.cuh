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

// floor((n << shift) / d) on 32-bit magnitudes, the bits of the
// bit-serial restoring divider: one integer divide for the numerator's
// 31 bits, `shift` explicit restoring steps on the remainder, then
// round-half-up, lost-bit tracking and the d == 0 saturation.  The
// d == 0 guard comes before the divide: integer division by zero does
// not trap on the GPU, it returns garbage.
__device__ __forceinline__ uint32_t q_fast_div_mag(uint32_t n, uint32_t d,
                                                   int shift, int round,
                                                   uint32_t qmax) {
  const bool dz = d == 0u;
  const uint32_t ds = dz ? 1u : d;
  uint32_t q = n / ds;
  uint32_t r = n - q * ds;
  uint32_t lost = 0u;
  for (int i = 0; i < shift; ++i) {
    lost |= q >> 31;
    r <<= 1;  // r < ds <= 2^31: no wrap
    const bool ge = r >= ds;
    q = (q << 1) | (ge ? 1u : 0u);
    if (ge) r -= ds;
  }
  if (round) {
    const bool half_up = r >= (ds >> 1) + (ds & 1u);
    const uint32_t q2 = q + (half_up ? 1u : 0u);
    lost |= (q2 < q) ? 1u : 0u;
    q = q2;
  }
  return (dz || lost != 0u || q > qmax) ? qmax : q;
}

// Saturating Q / Q -> Q, bit-equal to the reference's div_qq.
__device__ __forceinline__ int32_t q_fast_div_qq(const QFmt& f, int32_t num,
                                                 int32_t den) {
  const bool neg = (num < 0) != (den < 0);
  const int32_t q = (int32_t)q_fast_div_mag(q_mag(num), q_mag(den),
                                            f.frac_len, f.round,
                                            (uint32_t)f.qmax);
  return neg ? -q : q;
}

// Saturating Q / int -> Q, bit-equal to the reference's div_qi.
__device__ __forceinline__ int32_t q_fast_div_qi(const QFmt& f, int32_t num,
                                                 int32_t k) {
  const bool neg = (num < 0) != (k < 0);
  const int32_t q = (int32_t)q_fast_div_mag(q_mag(num), q_mag(k), 0,
                                            f.round, (uint32_t)f.qmax);
  return neg ? -q : q;
}

// Float -> Q, bit-equal to QFormat.quantize: the float32 product with
// the scale, round half to even, NaN -> 0, then a saturating convert
// (infinities included) into [-qmax, qmax].
__device__ __forceinline__ int32_t q_quantize_f32(const QFmt& f, float x) {
  const float v = rintf(__fmul_rn(x, (float)(1u << f.frac_len)));
  if (v != v) return 0;
  const double d = (double)v;
  if (d >= (double)f.qmax) return f.qmax;
  if (d <= -(double)f.qmax) return -f.qmax;
  return (int32_t)d;
}

// One row of univariate Q-format TEDA, the reference's `_q_step_u`
// (eqs (1)-(6)) at instant k from the carried mean and var:
//   rk = (k-1)/k (Q/Q), inv = 1/k, thr = msq1/(2k), xk = x/k (Q/int)
//   mean_n = sat(rk*mean + xk)         (k = 1 gives rk = 0, x/1 = x)
//   d2 = (x - mean_n)^2, e = d2/k (0 at k = 1)
//   var_n = sat(rk*var + e)
//   ecc = inv + (d2/var_n)/k (var_n > 0 guard)
//   outlier = (ecc >> 1) > thr && k >= 2
// The caller gates the outlier on validity and freezes its carries.
struct QTedaRow {
  int32_t mean;
  int32_t var;
  int32_t ecc;
  bool outlier;
};

__device__ __forceinline__ QTedaRow q_teda_row(const QFmt& f, int32_t k,
                                               int32_t xv, int32_t mean,
                                               int32_t var, int32_t msq1) {
  const int32_t one = (int32_t)(1u << f.frac_len);
  const int32_t rk = q_fast_div_qq(f, k - 1, k);
  const int32_t inv = q_fast_div_qi(f, one, k);
  const int32_t thr = q_fast_div_qi(f, msq1, 2 * k);
  const int32_t xk = q_fast_div_qi(f, xv, k);
  QTedaRow r;
  // MEAN, eq (2)
  r.mean = q_sat_add(f, q_sat_mul(f, rk, mean), xk);
  // VARIANCE, eq (3)
  const int32_t d = q_sat_sub(f, xv, r.mean);
  const int32_t d2 = q_sat_mul(f, d, d);
  const int32_t e = (k <= 1) ? 0 : q_fast_div_qi(f, d2, k);
  r.var = q_sat_add(f, q_sat_mul(f, rk, var), e);
  // ECCENTRICITY + OUTLIER, eqs (1), (5), (6)
  const int32_t term =
      r.var > 0 ? q_fast_div_qi(f, q_fast_div_qq(f, d2, r.var), k) : 0;
  r.ecc = q_sat_add(f, inv, term);
  r.outlier = ((r.ecc >> 1) > thr) && (k >= 2);
  return r;
}
