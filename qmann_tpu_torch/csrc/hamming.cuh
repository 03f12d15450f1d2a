// The mode-3 (Hamming-similarity) attention term of one (m, u) element
// pair, shared by the port's kernels that compute the mode-3 score:
// hamming.cu (the score alone), attention_read.cu and hop_chain.cu.  The
// counterpart of _hamming_score_block (qmann_tpu/ops/pallas/qkernels.py),
// which the TPU package shares between its three kernels the same way.
//
// Per pair, as the plain version (qmann_tpu_torch/ops/attention.py):
//   1. encode m and u as 32-bit sign-magnitude words at the full-width
//      format (iwl, 31-iwl): magnitude conv(|x| * 2^(31-iwl)) by rounding
//      mode (floor and ceil swap for negatives), |x| > 2^iwl saturating to
//      2^31-1; a magnitude of exactly 2^31 (|x| == 2^iwl) gives 2^31-1 for
//      a positive value and 0 with the sign set for a negative one; -0.0
//      has sign 0;
//   2. the common-mode preprocess, in uint32_t: the sum of two magnitudes
//      may carry into bit 31, and that carry is part of the word (signed
//      overflow would be undefined in C++);
//   3. sum w_i over the bits i in [1, num_bit), counted from the MSB, where
//      the preprocessed words match, in order of i in float32
//      (w_i = 2^(-i-weight_para), or 1 for the unweighted count); negated
//      where the words' sign bits differ (weighted only);
//   4. times 2^const_scale, requantized at (iwl, 31-iwl).
// The caller sums the terms of a memory row and requantizes the sum at the
// same format.
//
// The encode works in float32 with no hi/lo split: |x| <= 2^iwl is a
// float32 times a power of two, so s = |x| * 2^(31-iwl) <= 2^31 is exact,
// and floor/ceil/rint/trunc of a float32 is a float32 integer, so the
// magnitude conv(s) is exact; that is the value the plain version rebuilds
// from its split.  Build without --use_fast_math (denormal inputs must
// not flush to zero).
#pragma once

#include <cstdint>
#include <cmath>

#include "qformat.cuh"

namespace qmann {

struct HamFmt {
  QFmt full;     // (iwl, 31-iwl, mode): the encode bound and scale, and the
                 // requant of each term and of the row sum
  float cscale;  // 2^const_scale
  float w1;      // the weight of bit 1
  float wstep;   // w_(i+1) / w_i: 0.5 weighted, 1 unweighted
  int num_bit;   // bits compared: [1, num_bit)
  int weighted;  // negate on a sign mismatch
};

// Fills h; false when a knob is out of range (the caller returns
// cudaErrorInvalidValue).  The ranges keep every weight a normal float32.
inline bool make_hamfmt(int iwl, int mode, int num_bit, int const_scale,
                        int weight_para, int weighted, HamFmt* h) {
  if (iwl < 0 || iwl > 31 || num_bit < 1 || num_bit > 32 ||
      const_scale < -64 || const_scale > 64 || weight_para < -32 ||
      weight_para > 32)
    return false;
  if (!make_qfmt(iwl, 31 - iwl, mode, &h->full)) return false;
  h->cscale = std::ldexp(1.f, const_scale);
  h->w1 = weighted ? std::ldexp(1.f, -1 - weight_para) : 1.f;
  h->wstep = weighted ? 0.5f : 1.f;
  h->num_bit = num_bit;
  h->weighted = weighted != 0;
  return true;
}

__device__ __forceinline__ uint32_t ham_encode(float x, const HamFmt& h) {
  const float ax = fabsf(x);
  const bool neg = x < 0.f;
  uint32_t mag;
  if (ax > h.full.maxf) {  // strict: |x| == 2^iwl does not saturate
    mag = 0x7fffffffu;
  } else {
    const float s = ax * h.full.scale;
    float c;
    switch (h.full.mode) {
      case 0: c = neg ? ceilf(s) : floorf(s); break;
      case 1: c = neg ? floorf(s) : ceilf(s); break;
      case 2: c = rintf(s); break;
      default: c = truncf(s); break;
    }
    mag = c >= 2147483648.f ? (neg ? 0u : 0x7fffffffu) : (uint32_t)c;
  }
  return neg ? (mag | 0x80000000u) : mag;
}

__device__ __forceinline__ float ham_term(float m, float u, const HamFmt& h) {
  const uint32_t wm = ham_encode(m, h), wu = ham_encode(u, h);
  const uint32_t sm = wm & 0x80000000u, su = wu & 0x80000000u;
  uint32_t mm = wm & 0x7fffffffu, mu = wu & 0x7fffffffu;
  const uint32_t mn = mm < mu ? mm : mu;
  if (sm == su) {
    mm -= mn;
    mu -= mn;
  } else if (mm >= mu) {
    mm += mn;
    mu = 0u;
  } else {
    mu += mn;
    mm = 0u;
  }
  const uint32_t differ = (sm | mm) ^ (su | mu);
  float sim = 0.f, w = h.w1;
  for (int i = 1; i < h.num_bit; ++i) {
    if (!((differ >> (31 - i)) & 1u)) sim += w;
    w *= h.wstep;
  }
  if (h.weighted && (differ & 0x80000000u)) sim = -sim;
  return fq(sim * h.cscale, h.full);
}

}  // namespace qmann
