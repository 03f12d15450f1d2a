// Q-format fake quantization and warp reductions shared by the port's
// CUDA kernels (hop_chain.cu, qmatvec.cu, attention_read.cu, hamming.cu).
//
// fq() is float_quant of qmann_tpu/numerics/fixed.py element by element:
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
