// The mode-3 (Hamming-similarity) attention term of one (m, u) element
// pair, shared by the port's kernels that compute the mode-3 score:
// hamming.cu (the score alone), attention_read.cu and hop_chain.cu.  The
// counterpart of _hamming_score_block (qmann_tpu/ops/pallas/qkernels.py),
// which the TPU package shares between its three kernels the same way.
// The surrogate backward (hamming_bwd.cu) reuses its encode and
// preprocess.
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
// same format (FastQ31, qformat.cuh).
//
// The rounding mode is a template argument (the kernels instantiate one
// per mode), so the encode and both requants compile without a branch.
// ham_encode and ham_pair are split so that a kernel encodes each query's
// u once and pairs the word with each memory row's; ham_preprocess is
// split out of ham_pair for the surrogate backward (hamming_bwd.cu).
//
// The word form of step 3.  Let match = ~differ & mask, with mask the
// bits 30 .. 32-num_bit (the bits i in [1, num_bit), bit i at position
// 31-i).  Read as an integer, match is sum 2^(31-i) over the matching i,
// so the weighted sum is (float)match * 2^(-31-weight_para) and the
// unweighted count is popc(match).  Both equal the ascending float32 loop
// exactly while the weighted sum has at most 24 significant bits, that is
// for num_bit <= 25: then match converts to float32 exactly, the power of
// two scales it exactly (weight_para in [-32, 32] keeps every value a
// normal float32), and every partial sum of the loop is exact on the same
// grid.  From num_bit 26 on the sum has more bits than float32 holds and
// the loop rounds (once at 26, where it still agrees with the word form;
// twice or more from 27, where they differ); those launches (HamFmt.word
// == 0) keep the loop.  The count is exact at any num_bit
// (tests/test_torch_fastq31.py checks both forms against the loop).
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
  QFmt full;       // (iwl, 31-iwl, mode): the encode bound and scale, and the
                   // requant of each term and of the row sum
  float cscale;    // 2^const_scale
  float wscale;    // 2^(-31-weight_para): the weight of match's bit 0
  uint32_t mask;   // bits 30 .. 32-num_bit: the compared bits
  int num_bit;     // bits compared: [1, num_bit)
  int weighted;    // weights 2^(-i-weight_para), negated on a sign mismatch
  int word;        // the word form is exact: unweighted, or num_bit <= 25
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
  h->wscale = std::ldexp(1.f, -31 - weight_para);
  // bits [32-num_bit, 31) set; none at num_bit 1
  h->mask =
      0x7fffffffu & ~((num_bit >= 32 ? 1u : (1u << (32 - num_bit))) - 1u);
  h->num_bit = num_bit;
  h->weighted = weighted != 0;
  h->word = !weighted || num_bit <= 25;
  return true;
}

template <int Mode>
__device__ __forceinline__ uint32_t ham_encode(float x, const HamFmt& h) {
  const float ax = fabsf(x);
  const bool neg = x < 0.f;
  const float s = ax * h.full.scale;
  float c;
  if constexpr (Mode == 0) c = neg ? ceilf(s) : floorf(s);
  else if constexpr (Mode == 1) c = neg ? floorf(s) : ceilf(s);
  else c = round_by<Mode>(s);
  uint32_t mag = c >= 2147483648.f ? (neg ? 0u : 0x7fffffffu) : (uint32_t)c;
  mag = ax > h.full.maxf ? 0x7fffffffu : mag;  // strict: 2^iwl stays
  return neg ? (mag | 0x80000000u) : mag;
}

// The common-mode preprocess of one pair of encoded words (step 2): the
// preprocessed words, sign bits included, in *pm and *pu.  Shared by the
// score (ham_pair) and the surrogate backward (hamming_bwd.cu).
__device__ __forceinline__ void ham_preprocess(uint32_t wm, uint32_t wu,
                                               uint32_t* pm, uint32_t* pu) {
  const uint32_t sm = wm & 0x80000000u, su = wu & 0x80000000u;
  const uint32_t mm = wm & 0x7fffffffu, mu = wu & 0x7fffffffu;
  const uint32_t mn = mm < mu ? mm : mu;
  const bool same = sm == su, ge = mm >= mu;
  *pm = sm | (same ? mm - mn : (ge ? mm + mn : 0u));
  *pu = su | (same ? mu - mn : (ge ? 0u : mu + mn));
}

// The requanted term of one pair of encoded words.  Word: the word form
// (only where h.word says it is exact); else the float loop.
template <int Mode, bool Word>
__device__ __forceinline__ float ham_pair(uint32_t wm, uint32_t wu,
                                          const HamFmt& h) {
  uint32_t pm, pu;
  ham_preprocess(wm, wu, &pm, &pu);
  const uint32_t differ = pm ^ pu;
  const uint32_t match = ~differ & h.mask;
  float sim;
  if constexpr (Word) {
    sim = h.weighted ? (float)match * h.wscale : (float)__popc(match);
  } else {
    sim = 0.f;
    float w = h.weighted ? h.wscale * 1073741824.f : 1.f;  // w_1
    const float step = h.weighted ? 0.5f : 1.f;
    for (int i = 1; i < h.num_bit; ++i) {
      if ((match >> (31 - i)) & 1u) sim += w;
      w *= step;
    }
  }
  sim = h.weighted && (differ & 0x80000000u) ? -sim : sim;
  return FastQ31<Mode>::from(h.full)(sim * h.cscale);
}

template <int Mode, bool Word>
__device__ __forceinline__ float ham_term(float m, float u, const HamFmt& h) {
  return ham_pair<Mode, Word>(ham_encode<Mode>(m, h), ham_encode<Mode>(u, h),
                              h);
}

}  // namespace qmann
