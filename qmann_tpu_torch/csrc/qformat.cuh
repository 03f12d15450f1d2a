// Q-format fake quantization and warp reductions shared by the port's
// CUDA kernels (hop_chain.cu, qmatvec.cu, attention_read.cu, hamming.cu).
//
// fq() is float_quant of qmann_tpu/numerics/fixed.py element by element
// (FastQ<Mode> and FastQ31<Mode> are the same for the formats they take,
// with the mode fixed at compile time; AnyQ wraps fq behind the same
// interface):
// saturating float->int32 conversion (+-2^31 clamp), the INT_MIN magnitude
// wrap at iwl+frac == 31, saturation decided on the pre-conversion value,
// and the binary format (iwl+frac == 0) mapping 0 to +1.  Each format's
// bound is computed on the host in the same float32 arithmetic as
// numerics.fixed_max_float and handed to the kernel by value.
#pragma once

#include <cuda_runtime.h>

namespace qmann {

struct QFmt {
  float maxf;       // saturation bound (2^(iwl+frac)-1)/2^frac in float
  float scale;      // 2^frac
  float inv_scale;  // 2^-frac
  int mode;         // 0 floor, 1 ceil, 2 round-half-even, 3 truncate
  int binary;       // iwl+frac == 0: sign with 0 -> +1
  int full31;       // iwl+frac == 31: the INT_MIN magnitude wrap
};

// Fills q from an (iwl, frac, mode) triple; false when the format is out
// of range (the caller returns cudaErrorInvalidValue).
inline bool make_qfmt(int iwl, int frac, int mode, QFmt* q) {
  if (iwl < 0 || frac < 0 || iwl + frac > 31 || mode < 0 || mode > 3)
    return false;
  const int n = iwl + frac;
  // the same float32 arithmetic as numerics.fixed_max_float
  q->maxf = (float)((1u << n) - 1u) / (float)(1u << frac);
  q->scale = (float)(1u << frac);
  q->inv_scale = 1.f / q->scale;  // exact: a power of two
  q->mode = mode;
  q->binary = n == 0;
  q->full31 = n == 31;
  return true;
}

__device__ __forceinline__ float fq(float x, const QFmt& f) {
  if (f.binary) return x >= 0.f ? 1.f : -1.f;
  const float scaled = x * f.scale;
  float q;
  switch (f.mode) {
    case 0: q = floorf(scaled); break;
    case 1: q = ceilf(scaled); break;
    case 2: q = rintf(scaled); break;
    default: q = truncf(scaled); break;
  }
  // saturating float->int32 conversion
  q = q < -2147483648.f ? -2147483648.f : (q > 2147483648.f ? 2147483648.f : q);
  float deq = q * f.inv_scale;
  if (f.full31 && scaled <= -2147483648.f) deq = 0.f;
  // saturation is decided on the pre-conversion value
  return x > f.maxf ? f.maxf : (x < -f.maxf ? -f.maxf : deq);
}

// The same function with the rounding mode fixed at compile time, for a
// non-binary format with iwl+frac <= 30 (fastq_exact below): one multiply,
// one rounding of the fixed kind, one multiply and the saturation as a
// NaN-propagating clamp, with no branch (a select that the compiler turns
// into branches costs a convergence barrier per requant).
//
// Why this equals fq there.  Let n = iwl+frac <= 30, s = 2^frac and maxf
// the float32 bound: maxf*s is the integer N = 2^n-1, or 2^n once 2^n-1
// rounds up in float32 (n >= 25).  The multiplies by s and 1/s are exact
// (powers of two; |x*s| <= 2^30 wherever the result is kept).
//  - |x| <= maxf: |x*s| <= N <= 2^30, and rounding a value in [-N, N] of
//    any kind stays in [-N, N], so fq's +-2^31 clamp never binds, its
//    INT_MIN wrap (n == 31 only) never fires, and deq lies in
//    [-maxf, maxf], where the clamp is the identity;
//  - x > maxf (+inf included): x*s > N, every rounding is monotone and
//    leaves the integer N in place, so deq >= maxf and the clamp gives
//    maxf, as fq's select does; x < -maxf likewise gives -maxf;
//  - NaN: deq is NaN and max.NaN / min.NaN keep it, as fq does.
// tests/test_torch_qmatvec.py checks the formula against float_quant for
// every (iwl, frac) with n <= 30 and every mode on an edge list.
__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(lo));
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(r), "f"(hi));
  return r;
}

// The rounding of fq's mode `Mode`: 0 floor, 1 ceil, 2 half-even, 3 trunc.
template <int Mode>
__device__ __forceinline__ float round_by(float s) {
  if constexpr (Mode == 0) return floorf(s);
  else if constexpr (Mode == 1) return ceilf(s);
  else if constexpr (Mode == 2) return rintf(s);
  else return truncf(s);
}

template <int Mode>
struct FastQ {
  float maxf, scale, inv_scale;
  __device__ __forceinline__ float operator()(float x) const {
    return clamp_nan(round_by<Mode>(x * scale) * inv_scale, -maxf, maxf);
  }
  static __host__ __device__ FastQ from(const QFmt& f) {
    return FastQ{f.maxf, f.scale, f.inv_scale};
  }
};

// fq for a 31-bit format (iwl+frac == 31, iwl in [0, 31]): the full-width
// format of the Hamming score (hamming.cuh), with the mode fixed at
// compile time and no branch:
//   FastQ31(x) = x == -maxf ? 0 : clamp_nan(round(x*s) * (1/s), -maxf, maxf)
//
// Why this equals fq there.  s = 2^frac.  float32 rounds 2^31-1 up to
// 2^31, so maxf = 2^31 / s = 2^iwl exactly, and maxf*s = 2^31.
//  - -maxf < x <= maxf: x*s (exact, a power-of-two scaling) lies in
//    (-2^31, 2^31]; a float32 of magnitude >= 2^23 is an integer and the
//    floats just above -2^31 are -2^31 + 128 and beyond, so the rounding
//    leaves every value of magnitude >= 2^23 in place and keeps the rest
//    within (-2^23, 2^23]: the result stays in (-2^31, 2^31].  fq's +-2^31
//    clamp never binds, its INT_MIN wrap (x*s <= -2^31) never fires, and
//    the dequantized value lies in (-maxf, maxf], where the clamp is the
//    identity;
//  - x == -maxf: x*s == -2^31, where fq's INT_MIN wrap gives 0 and its
//    saturation select (strict: x < -maxf) does not fire: 0, as the select
//    above gives;
//  - x > maxf (+inf included): x*s > 2^31, every rounding leaves it >= 2^31,
//    so the clamp gives maxf, as fq's select does; x < -maxf likewise gives
//    -maxf (fq's select overrides its wrap there);
//  - NaN: x == -maxf is false and max.NaN / min.NaN keep NaN, as fq does.
// tests/test_torch_fastq31.py checks the formula against float_quant for
// every iwl in [0, 31] and every mode on an edge list.
template <int Mode>
struct FastQ31 {
  float maxf, scale, inv_scale;
  __device__ __forceinline__ float operator()(float x) const {
    const float v =
        clamp_nan(round_by<Mode>(x * scale) * inv_scale, -maxf, maxf);
    return x == -maxf ? 0.f : v;
  }
  static __host__ __device__ FastQ31 from(const QFmt& f) {
    return FastQ31{f.maxf, f.scale, f.inv_scale};
  }
};

// The runtime fq behind the same interface, for the formats FastQ does not
// take (binary, iwl+frac == 31) and launches that need them.
struct AnyQ {
  QFmt f;
  __device__ __forceinline__ float operator()(float x) const {
    return fq(x, f);
  }
  static __host__ __device__ AnyQ from(const QFmt& f) { return AnyQ{f}; }
};

// Whether FastQ computes fq exactly for f.
inline bool fastq_exact(const QFmt& f) { return !f.binary && !f.full31; }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace qmann
