// The mode-3 Hamming score's surrogate backward, one thread per (query,
// d) column:  for the upstream gradient g [B, M] of s = hamming(m, u),
//   dm[b, r, d] = tmp_a(m[b, r, d], u[b, d]) * g[b, r]
//   du[b, d]    = sum_r grad_appx(m[b, r, d], u[b, d]) * g[b, r]
// m [B, M, D], u [B, D], g [B, M] -> dm [B, M, D], du [B, D].
//
// No Pallas counterpart: the JAX package computes the surrogate
// (_hamming_bwd, qmann_tpu/ops/attention.py) as a Python loop over
// num_bit of elementwise jnp ops, which XLA fuses under jit into one or
// two loop fusions per hop.  This kernel is the port of that fusion.  The
// training backward runs it once per hop on the kernel route: from the
// unfused score (ops/attention.py::_HammingScore, use_pallas_hamming) and
// from the fused read (ops/fused.py, use_pallas), at B=32 (a training
// batch; M=10, D=60 for the flagship) or a family's folded R x 32.
//
// Per element pair, as the plain version (ops/attention.py::
// hamming_backward, the reference's _cuda_backprop_grad_out_mat/vec):
//   1. encode m and u at (iwl, 31-iwl) (ham_encode, hamming.cuh); sign_m
//      and sign_u from the ORIGINAL words (word >= 0 -> +1);
//   2. the common-mode preprocess (ham_preprocess, hamming.cuh);
//   3. over the bits i in [0, num_bit) counted from the MSB where the
//      preprocessed words differ, with diff_i = mb_i - ub_i = +-1:
//      tmp_a = diff_0 * sign_m (bit 0) - sign_u * sum_{i >= 1} diff_i;
//      grad_appx, the reference's stale accumulate: a value v_i is
//        assigned at each differing bit (-diff_0 * sign_u at bit 0,
//        diff_i * sign_m above it) and added at every bit, so it counts
//        once for each bit from i up to the next differing bit (or
//        num_bit).
//   The preprocess takes the smaller magnitude off both words (same
//   signs) or moves the sum of the magnitudes into the larger one's word
//   (signs that differ; a carry lands in bit 0's position), so at most
//   one word keeps magnitude bits.  Every differing bit i >= 1 then has
//   the same diff, dir = +1 where pm holds them; and bit 0 differs only
//   where the signs differ, where diff_0 * sign_m = -diff_0 * sign_u = -1.
//   With e = 1 where bit 0 differs, x1 the differing bits 1 .. num_bit-1
//   and c = min(clz(x1), num_bit) (the first of them, the bits bit 0's
//   value is held for), the bit loop has a closed form:
//      tmp_a     = -e - sign_u * dir * popc(x1)
//      grad_appx = -e * c + sign_m * dir * (num_bit - c)
//   (tests/test_torch_hamming_bwd.py holds it against the walk over the
//   bits on every pair of encoded words within 8-bit windows and on
//   random words).  No loop over the bits: one popcount and one
//   leading-zero count per pair, and no lane of a warp waits on another's
//   bits.
//   Both are integers k with |k| <= 32 scaled by 2^const_scale at the
//   end.  Every partial sum of the plain loop is such a multiple, exact in
//   float32, so the scaled integer equals it bit for bit, +0.0 included
//   (a float form such as -sign_u * scale * 0 would give -0.0, and the
//   product with g would differ in the sign of zero).  k * 2^const_scale
//   is formed without a conversion instruction (scaled_int).
//   4. dm = tmp_a * g and the products grad_appx * g: one rounding each,
//      as the plain version's (__fmul_rn: no contraction into an FMA);
//      du sums the products over r in ascending order in one thread, no
//      atomics, so a launch is deterministic (a CUDA graph's replay equals
//      the eager launch bit for bit).  The plain version sums in torch's
//      order: du agrees within float32 rounding of an M-term sum.
//
// What bounds it on an H100 (card_kit.hamming_backward_bound): one call
// moves 4 * (2BMD + 2BD + BM) bytes (m, u and g read once, dm and du
// written once), 9.43 us at the mode-3 family's folded 1280 x 50 x 60 at
// 3.35 TB/s.  Per element pair the closed form needs about 23 integer
// operations after the encode (card_kit.hamming_backward_bound) at 64
// results per clock per SM, and a popcount and a leading-zero count at 16
// (the CUDA C++ Programming Guide's throughput table for compute capability
// 9.0): 6.7 and 1.8 us at 1280 queries, below the bytes.  The compiled
// loop issues about 52 instructions per element, 35 of them integer
// (scripts/sass_loops.py), some 6 us at 1280 queries at one instruction
// per clock per scheduler: the bytes stay the limit, with little room to
// spare.  The design:
//  - one thread per (query, d) column, consecutive threads on consecutive
//    d: loads of m and stores of dm are coalesced; the thread encodes its
//    u once and keeps du's sum in a register, so no shared memory, no
//    barrier and no second pass;
//  - the thread loads kRows rows of m and g into registers before it
//    computes them (g[b, r] is one address for a query's columns: an L1
//    hit), and addresses them by 32-bit offsets;
//  - the rounding mode is a template argument;
//  - blocks of 128 threads, halved down to one warp while the grid would
//    have fewer blocks than the card has SMs (a batch of 32 queries:
//    60 blocks of one warp).
// The wrapper picks the block (ops/cuda/hamming_bwd.py::backward_launch).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc  (qmann_tpu_torch/ops/cuda/_build.py does it).
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "hamming.cuh"

namespace {

using qmann::HamFmt;

constexpr int kMaxMem = 64;
constexpr int kMaxDim = 256;
constexpr int kMaxThreads = 128;
constexpr int kMinBlocks = 5;   // blocks per SM the registers must allow
constexpr int kRows = 8;        // rows of a column loaded before their use

// k * 2^const_scale as a float for |k| < 2^22 without a conversion
// instruction: k added to the bits of 1.5 * 2^23 (where the float32
// spacing is 1), then one FMA with the scale and the scaled bias (bias =
// -1.5 * 2^23 * cscale); exact, and +0.0 at k = 0.
__device__ __forceinline__ float scaled_int(int k, float cscale,
                                            float bias) {
  return __fmaf_rn(__int_as_float(0x4b400000 + k), cscale, bias);
}

// The surrogate's two integers for one pair of encoded words: *ka for
// tmp_a, *kv for grad_appx (both times 2^const_scale).  The preprocess
// leaves magnitude bits in one word only (the other's is 0, or the sign
// bit alone), so every differing bit i >= 1 has the same diff: +1 where
// pm holds them (dir).  Bit 0 differs only where the signs differ, and
// then diff_0 * sign_m = -diff_0 * sign_u = -1.
__device__ __forceinline__ void ham_surrogate(uint32_t wm, uint32_t wu,
                                              int sign_u, const HamFmt& h,
                                              int* ka, int* kv) {
  const int sign_m = (wm & 0x80000000u) ? -1 : 1;
  uint32_t pm, pu;
  qmann::ham_preprocess(wm, wu, &pm, &pu);
  const uint32_t x = pm ^ pu;
  const uint32_t x1 = x & h.mask;  // the differing bits 1 .. num_bit-1
  const int dir = (pm & x1) ? 1 : -1;
  const int e = (int)(x >> 31);              // bit 0 differs
  const int c = min(__clz(x1), h.num_bit);   // the bits bit 0 holds
  *ka = -e - sign_u * dir * __popc(x1);
  *kv = -e * c + sign_m * dir * (h.num_bit - c);
}

// One element m[q, r, d] of a column: writes dm there and returns the
// product grad_appx * g[q, r].
template <int Mode>
__device__ __forceinline__ float surrogate_term(float mv, float gv,
                                                uint32_t wu, int sign_u,
                                                const HamFmt& h, float bias,
                                                float* dm_at) {
  int ka, kv;
  ham_surrogate(qmann::ham_encode<Mode>(mv, h), wu, sign_u, h, &ka, &kv);
  *dm_at = __fmul_rn(scaled_int(ka, h.cscale, bias), gv);
  return __fmul_rn(scaled_int(kv, h.cscale, bias), gv);
}

template <int Mode>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
hamming_bwd_kernel(const float* __restrict__ m,   // [B, M, D]
                   const float* __restrict__ u,   // [B, D]
                   const float* __restrict__ g,   // [B, M]
                   float* __restrict__ dm,        // [B, M, D]
                   float* __restrict__ du,        // [B, D]
                   int B, int M, int D, HamFmt ham) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;  // the column (q, d)
  if (t >= B * D) return;
  const int q = t / D;
  int at = q * M * D + (t - q * D);  // m[q, r, d]
  const float* gr = g + q * M;
  const uint32_t wu = qmann::ham_encode<Mode>(u[t], ham);
  const int sign_u = (wu & 0x80000000u) ? -1 : 1;
  const float bias = -12582912.f * ham.cscale;
  // -0.0 + p is p bit for bit: the sum starts at the r = 0 product and
  // adds the others in ascending r
  float acc = -0.f;
  int r = 0;
  for (; r + kRows <= M; r += kRows, at += kRows * D) {
    float mv[kRows], gv[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      mv[i] = __ldg(m + at + i * D);
      gv[i] = __ldg(gr + r + i);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      acc = __fadd_rn(acc, surrogate_term<Mode>(mv[i], gv[i], wu, sign_u,
                                                ham, bias, dm + at + i * D));
  }
  for (; r < M; ++r, at += D)
    acc = __fadd_rn(acc, surrogate_term<Mode>(__ldg(m + at), __ldg(gr + r),
                                              wu, sign_u, ham, bias,
                                              dm + at));
  du[t] = acc;
}

template <int Mode>
int launch(const float* m, const float* u, const float* g, float* dm,
           float* du, int B, int M, int D, int threads, const HamFmt& ham,
           cudaStream_t stream) {
  const int blocks = (int)(((long long)B * D + threads - 1) / threads);
  hamming_bwd_kernel<Mode>
      <<<blocks, threads, 0, stream>>>(m, u, g, dm, du, B, M, D, ham);
  return (int)cudaGetLastError();
}

}  // namespace

// threads: the block size of the wrapper's backward_launch.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes,
// block sizes or knobs out of range).
extern "C" int qmann_hamming_backward(const float* m, const float* u,
                                      const float* g, float* dm, float* du,
                                      int B, int M, int D, int iwl,
                                      int round_mode, int num_bit,
                                      int const_scale, int threads,
                                      void* stream) {
  if (B < 1 || M < 1 || M > kMaxMem || D < 1 || D > kMaxDim ||
      (long long)B * M * D > INT_MAX || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  HamFmt ham;
  // weight_para and weighted change the forward only
  if (!qmann::make_hamfmt(iwl, round_mode, num_bit, const_scale, 0, 1, &ham))
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  switch (round_mode) {
    case 0:
      return launch<0>(m, u, g, dm, du, B, M, D, threads, ham, st);
    case 1:
      return launch<1>(m, u, g, dm, du, B, M, D, threads, ham, st);
    case 2:
      return launch<2>(m, u, g, dm, du, B, M, D, threads, ham, st);
    default:
      return launch<3>(m, u, g, dm, du, B, M, D, threads, ham, st);
  }
}
