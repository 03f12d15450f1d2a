// The mode-3 Hamming-similarity attention score for one query per thread
// block:  s[b, r] = Q(sum_d ham_term(m[b, r, d], u[b, d]), (iwl, 31-iwl))
// m [B, M, D], u [B, D] -> s [B, M]; ham_term is in hamming.cuh.
//
// Replaces the TPU kernel hamming_score_pallas / _hamming_kernel
// (qmann_tpu/ops/pallas/qkernels.py), which the forward runs once per hop
// when only the score takes the kernel route (use_pallas_hamming, or
// use_pallas under the EN_GRAD_QUANT "backward" placement, where the fused
// read is not used): at B=32 (a training batch) or B=1024 (an evaluation
// chunk), M=10, D=60 for the flagship.
//
// What bounds it on an H100: one call reads m once (32*10*60*4 B = 77 KB
// at B=32, ~0.02 us at 3.35 TB/s) and does ~80 integer and float
// operations per element pair at num_bit 8 (two encodes, the preprocess,
// the bit loop, the requant), ~1.5 M operations at B=32: ~0.05 us at the
// card's int32 rate.  Like the other kernels of the port it is
// latency-bound at these sizes: each block walks a warp reduction per
// memory row.  The design is the score part of attention_read.cu: one
// block per query, one warp per memory row with lanes along D (coalesced
// reads of m), the terms summed by warp_sum, lane 0 requantizing and
// writing the row's score.  u is re-encoded per row rather than staged in
// shared memory (a few instructions a lane at M=10).
//
// Numerics: the terms of a row lie on the 2^(const_scale-weight_para-
// num_bit+1) grid with magnitudes below 2^(const_scale-weight_para), so at
// num_bit <= 19 and D <= 64 their sum stays under 2^24 grid units and is
// exact in any order (the unweighted counts at any num_bit): the kernel is
// bit-identical to its plain version there.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc  (qmann_tpu_torch/ops/cuda/_build.py does it).
#include <cuda_runtime.h>

#include "hamming.cuh"

namespace {

using qmann::HamFmt;
using qmann::fq;
using qmann::ham_term;
using qmann::warp_sum;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
hamming_kernel(const float* __restrict__ m,   // [B, M, D]
               const float* __restrict__ u,   // [B, D]
               float* __restrict__ s_out,     // [B, M]
               int M, int D, HamFmt ham) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* mb = m + (size_t)b * M * D;
  const float* ub = u + (size_t)b * D;
  for (int r = warp; r < M; r += kWarps) {
    const float* mrow = mb + (size_t)r * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += ham_term(mrow[d], ub[d], ham);
    acc = warp_sum(acc);
    if (lane == 0) s_out[(size_t)b * M + r] = fq(acc, ham.full);
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// shapes or knobs out of range).
extern "C" int qmann_hamming_score(const float* m, const float* u,
                                   float* s_out, int B, int M, int D,
                                   int iwl, int round_mode, int num_bit,
                                   int const_scale, int weight_para,
                                   int weighted, void* stream) {
  if (B < 1 || M < 1 || D < 1) return (int)cudaErrorInvalidValue;
  HamFmt ham;
  if (!qmann::make_hamfmt(iwl, round_mode, num_bit, const_scale, weight_para,
                          weighted, &ham))
    return (int)cudaErrorInvalidValue;
  hamming_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(m, u, s_out, M, D,
                                                           ham);
  return (int)cudaGetLastError();
}
