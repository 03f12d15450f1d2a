// The mode-3 Hamming-similarity attention score, several queries per
// thread block:  s[b, r] = Q(sum_d ham_term(m[b, r, d], u[b, d]),
// (iwl, 31-iwl));  m [B, M, D], u [B, D] -> s [B, M]; the term is in
// hamming.cuh.
//
// Replaces the TPU kernel hamming_score_pallas / _hamming_kernel
// (qmann_tpu/ops/pallas/qkernels.py), which the forward runs once per hop
// when only the score takes the kernel route (use_pallas_hamming, or
// use_pallas under the EN_GRAD_QUANT "backward" placement, where the fused
// read is not used): at B=32 (a training batch) or B=1024 (an evaluation
// chunk), M=10, D=60 for the flagship.
//
// What bounds it on an H100: at B=32 one call moves 86 KB (m and u read
// once, s written once), 0.026 us at 3.35 TB/s, and does 0.49 M integer
// operations, the least the score needs as chip_smoke.py counts them (an
// encode of 6 per element of m and of u; per element pair 19 at num_bit
// <= 25: the preprocess of 8, the match word of 3, 4 for the sign, scale
// and sum, 4 for the term's requant; 4 per row sum), 0.015 us at the
// int32 rate of 33.5 TOP/s: 0.026 us, bytes (chip_smoke.hamming_bound).
// At these sizes the time is latency: the launch, one round trip to
// memory and the dependent steps of a block.  The first design (one
// 128-thread block per query, a warp per memory row, M/4 rows walked in
// turn with the loads inside the loop, the rounding mode switched at run
// time in every encode and requant, u re-encoded for every row, a
// 7-step float loop per pair) took 4.0-5.0 us at B=32.  This design:
//  - fixes the rounding mode at compile time (one instance per mode) and
//    requantizes the terms and row sums with the branch-free FastQ31
//    (qformat.cuh);
//  - stages the block's rows of m in shared memory with cp.async in one
//    coalesced pass (16-byte copies where M*D % 4 == 0 and m is aligned),
//    so that no loop waits on a global load;
//  - encodes each query's u once, into shared memory, while m lands;
//  - reads the match word as a fixed-point fraction (or its popcount)
//    instead of the bit loop, where that is exact (hamming.cuh; a kernel
//    argument picks the loop for the weighted similarity at num_bit > 25);
//  - gives each (query, row) G lanes (a power of two that about fills the
//    block) and sums them by shuffle; the wrapper picks queries per block,
//    threads and G (ops/cuda/hamming.py::hamming_geometry, by the rule of
//    ops/cuda/geometry.py).
// Measured on one H100 80GB HBM3 at 700 W (device time,
// scripts/kernel_times.py; PERF.md, section 6), first design -> this one:
// 5.0 -> 2.2 us at B=32, 7.8-7.9 -> 3.9 us at B=1024 and 17.7-18.5 -> 3.1
// us on the wide layout (M=50).
//
// Numerics: the terms of a row lie on the 2^(const_scale-weight_para-
// num_bit+1) grid with magnitudes below 2^(const_scale-weight_para), so at
// num_bit <= 19 and D <= 64 their sum stays under 2^24 grid units and is
// exact in any order (the unweighted counts at any num_bit): the kernel is
// bit-identical to its plain version there.  Above that a row sum may
// round, in another order than the plain version's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc  (qmann_tpu_torch/ops/cuda/_build.py does it).
#include <cstdint>

#include <cuda_runtime.h>

#include "block_ops.cuh"
#include "hamming.cuh"

namespace {

using qmann::FastQ31;
using qmann::HamFmt;

constexpr int kMaxMem = 64;
constexpr int kMaxDim = 256;
constexpr int kMaxThreads = 512;
constexpr int kSmemLimit = 232448;  // 227 KB; no static shared memory

// Floats of dynamic shared memory for qpb queries per block; the same
// formula as ops/cuda/hamming.py::hamming_smem_bytes.
size_t smem_floats(int qpb, int M, int D) {
  return (size_t)qpb * M * D + (size_t)qpb * D;  // m rows, u's words
}

template <int Mode>
__global__ void __launch_bounds__(kMaxThreads)
hamming_kernel(const float* __restrict__ m,   // [B, M, D]
               const float* __restrict__ u,   // [B, D]
               float* __restrict__ s_out,     // [B, M]
               int B, int M, int D, int qpb, int G, int vec16, HamFmt ham) {
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * qpb;
  const int nq = min(qpb, B - b0);
  float* ms = smem;                                             // [qpb][M][D]
  uint32_t* uw = reinterpret_cast<uint32_t*>(ms + (size_t)qpb * M * D);

  qmann::stage_flat(ms, m + (size_t)b0 * M * D, nq * M * D, vec16);
  for (int t = threadIdx.x; t < nq * D; t += blockDim.x)
    uw[t] = qmann::ham_encode<Mode>(u[(size_t)b0 * D + t], ham);
  qmann::cp_async_wait_all();
  __syncthreads();

  const FastQ31<Mode> full = FastQ31<Mode>::from(ham.full);
  const auto fin = [&](float acc) { return full(acc); };
  float* out = s_out + (size_t)b0 * M;
  if (ham.word) {
    qmann::score_rows(ms, nq * M, M, D, G, nullptr, out,
                      [&](float x, int q, int d) {
                        return qmann::ham_pair<Mode, true>(
                            qmann::ham_encode<Mode>(x, ham), uw[q * D + d],
                            ham);
                      },
                      fin);
  } else {
    qmann::score_rows(ms, nq * M, M, D, G, nullptr, out,
                      [&](float x, int q, int d) {
                        return qmann::ham_pair<Mode, false>(
                            qmann::ham_encode<Mode>(x, ham), uw[q * D + d],
                            ham);
                      },
                      fin);
  }
}

template <int Mode>
int launch(const float* m, const float* u, float* s_out, int B, int M, int D,
           int qpb, int threads, int G, const HamFmt& ham,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(qpb, M, D);
  // raised once per instance and device (the attribute is per device)
  static bool opted_in[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (bytes > 48 * 1024 && !(dev < 64 && opted_in[dev])) {
    const cudaError_t rc = cudaFuncSetAttribute(
        hamming_kernel<Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (rc != cudaSuccess) return (int)rc;
    if (dev < 64) opted_in[dev] = true;
  }
  const int vec16 = (M * D) % 4 == 0 && ((uintptr_t)m & 15u) == 0;
  hamming_kernel<Mode><<<(B + qpb - 1) / qpb, threads, bytes, stream>>>(
      m, u, s_out, B, M, D, qpb, G, vec16, ham);
  return (int)cudaGetLastError();
}

}  // namespace

// geometry: host array of the queries per block, threads and lanes per
// row (G) from the wrapper's hamming_geometry.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for shapes, geometry or knobs
// out of range).
extern "C" int qmann_hamming_score(const float* m, const float* u,
                                   float* s_out, int B, int M, int D,
                                   int iwl, int round_mode, int num_bit,
                                   int const_scale, int weight_para,
                                   int weighted, const int* geometry,
                                   void* stream) {
  const int qpb = geometry[0], threads = geometry[1], G = geometry[2];
  if (B < 1 || M < 1 || M > kMaxMem || D < 1 || D > kMaxDim || qpb < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || G < 1 ||
      G > 32 || (G & (G - 1)) != 0 ||
      sizeof(float) * smem_floats(qpb, M, D) > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  HamFmt ham;
  if (!qmann::make_hamfmt(iwl, round_mode, num_bit, const_scale, weight_para,
                          weighted, &ham))
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  switch (round_mode) {
    case 0: return launch<0>(m, u, s_out, B, M, D, qpb, threads, G, ham, st);
    case 1: return launch<1>(m, u, s_out, B, M, D, qpb, threads, G, ham, st);
    case 2: return launch<2>(m, u, s_out, B, M, D, qpb, threads, G, ham, st);
    default: return launch<3>(m, u, s_out, B, M, D, qpb, threads, G, ham, st);
  }
}
