// The mode-3 Hamming score's surrogate backward, several queries per
// thread block:  for the upstream gradient g [B, M] of s = hamming(m, u),
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
//      tmp_a = diff_0 * sign_m (bit 0) - sign_u * sum_{i >= 1} diff_i,
//        the sum a signed popcount: popc(pm & ~pu & mask) -
//        popc(~pm & pu & mask) over the bits 1 .. num_bit-1;
//      grad_appx, the reference's stale accumulate: a value v_i is
//        assigned at each differing bit (-diff_0 * sign_u at bit 0,
//        diff_i * sign_m above it) and added at every bit, so it counts
//        once for each bit from i up to the next differing bit (or
//        num_bit): the kernel walks the differing bits with clz.
//   Both are integers k with |k| <= 32 scaled by 2^const_scale at the
//   end.  Every partial sum of the plain loop is such a multiple, exact in
//   float32, so the scaled integer equals it bit for bit, +0.0 included
//   (a float form such as -sign_u * scale * 0 would give -0.0, and the
//   product with g would differ in the sign of zero).
//   4. dm = tmp_a * g and the products grad_appx * g: one rounding each,
//      as the plain version's (__fmul_rn: no contraction into an FMA);
//      du sums the products over r in ascending order, inside one block,
//      no atomics, so a launch is deterministic (a CUDA graph's replay
//      equals the eager launch bit for bit).  The plain version sums in
//      torch's order: du agrees within float32 rounding of an M-term sum.
//
// What bounds it on an H100: at B=32 one call moves 170 KB (m, u and g
// read once, dm and du written once: 4 * (2BMD + 2BD + BM) bytes), 0.051
// us at 3.35 TB/s, and does about 0.9 M integer operations at num_bit 8
// (chip_smoke.ham_backward_ops: an encode of 6 per element of m and of
// u; per element pair the preprocess of 8, tmp_a's popcounts of 8,
// grad_appx's 3 per compared bit; the scales and products as float
// operations), 0.03 us at the int32 rate of 33.5 TOP/s: bytes.  At these
// sizes the time is the launch and one round trip to memory; at the
// mode-3 family's folded 5120 x 50 x 60 the bytes bound is 37.7 us.
// This first design is right and simple, not fast:
//  - the rounding mode is a template argument (one instance per mode),
//    as in the other kernels;
//  - the block stages its queries' rows of m in shared memory with
//    cp.async in one coalesced pass, encodes each query's u once and
//    stages each query's g while m lands;
//  - every thread takes elements (q, r, d) in turn, consecutive threads
//    on consecutive d: it writes dm coalesced along d and leaves the
//    product grad_appx * g in the element's shared-memory slot;
//  - after a barrier, one thread per (q, d) sums its column of products
//    in ascending r and writes du.
// The wrapper picks the queries per block and the threads by the rule of
// ops/cuda/geometry.py (ops/cuda/hamming_bwd.py::backward_geometry).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc  (qmann_tpu_torch/ops/cuda/_build.py does it).
#include <cstdint>

#include <cuda_runtime.h>

#include "block_ops.cuh"
#include "hamming.cuh"

namespace {

using qmann::HamFmt;

constexpr int kMaxMem = 64;
constexpr int kMaxDim = 256;
constexpr int kMaxThreads = 512;
constexpr int kSmemLimit = 232448;  // 227 KB; no static shared memory

// Floats of dynamic shared memory for qpb queries per block; the same
// formula as ops/cuda/hamming_bwd.py::backward_smem_bytes.
size_t smem_floats(int qpb, int M, int D) {
  // m rows (then the products), u's words, g's rows
  return (size_t)qpb * M * D + (size_t)qpb * D + (size_t)qpb * M;
}

// The surrogate's two integers for one pair of encoded words: *ka for
// tmp_a, *kv for grad_appx (both times 2^const_scale).
__device__ __forceinline__ void ham_surrogate(uint32_t wm, uint32_t wu,
                                              const HamFmt& h, int* ka,
                                              int* kv) {
  const int sign_m = (wm & 0x80000000u) ? -1 : 1;
  const int sign_u = (wu & 0x80000000u) ? -1 : 1;
  uint32_t pm, pu;
  qmann::ham_preprocess(wm, wu, &pm, &pu);
  // bit 0 (the sign position) and the bits 1 .. num_bit-1 (h.mask)
  const uint32_t differ = (pm ^ pu) & (h.mask | 0x80000000u);
  const int d0 = (differ & 0x80000000u) ? ((pm & 0x80000000u) ? 1 : -1) : 0;
  *ka = d0 * sign_m - sign_u * (__popc(pm & ~pu & h.mask) -
                                __popc(~pm & pu & h.mask));
  int acc = 0, held = 0, from = 0;
  for (uint32_t rest = differ; rest != 0u;) {
    const int i = __clz(rest);  // the next differing bit, from the MSB
    acc += held * (i - from);
    const int diff = ((pm >> (31 - i)) & 1u) ? 1 : -1;
    held = i == 0 ? -diff * sign_u : diff * sign_m;
    from = i;
    rest &= ~(0x80000000u >> i);
  }
  *kv = acc + held * (h.num_bit - from);
}

template <int Mode>
__global__ void __launch_bounds__(kMaxThreads)
hamming_bwd_kernel(const float* __restrict__ m,   // [B, M, D]
                   const float* __restrict__ u,   // [B, D]
                   const float* __restrict__ g,   // [B, M]
                   float* __restrict__ dm,        // [B, M, D]
                   float* __restrict__ du,        // [B, D]
                   int B, int M, int D, int qpb, int vec16, HamFmt ham) {
  extern __shared__ __align__(16) float smem[];
  const int b0 = blockIdx.x * qpb;
  const int nq = min(qpb, B - b0);
  const int MD = M * D;
  float* ms = smem;                                           // [qpb][M][D]
  uint32_t* uw = reinterpret_cast<uint32_t*>(ms + (size_t)qpb * MD);
  float* gs = reinterpret_cast<float*>(uw + (size_t)qpb * D);  // [qpb][M]

  qmann::stage_flat(ms, m + (size_t)b0 * MD, nq * MD, vec16);
  for (int t = threadIdx.x; t < nq * D; t += blockDim.x)
    uw[t] = qmann::ham_encode<Mode>(u[(size_t)b0 * D + t], ham);
  for (int t = threadIdx.x; t < nq * M; t += blockDim.x)
    gs[t] = g[(size_t)b0 * M + t];
  qmann::cp_async_wait_all();
  __syncthreads();

  // each element (q, r, d): dm, and the product grad_appx * g in its slot;
  // a thread steps through a query's [M, D] elements blockDim.x apart,
  // its (r, d) advanced without a division
  const int step_r = blockDim.x / D, step_d = blockDim.x % D;
  for (int q = 0; q < nq; ++q) {
    float* mq = ms + (size_t)q * MD;
    float* dmq = dm + (size_t)(b0 + q) * MD;
    const uint32_t* uq = uw + q * D;
    const float* gq = gs + q * M;
    int r = threadIdx.x / D, d = threadIdx.x % D;
    while (r < M) {
      const int e = r * D + d;
      int ka, kv;
      ham_surrogate(qmann::ham_encode<Mode>(mq[e], ham), uq[d], ham, &ka,
                    &kv);
      dmq[e] = __fmul_rn((float)ka * ham.cscale, gq[r]);
      mq[e] = __fmul_rn((float)kv * ham.cscale, gq[r]);
      r += step_r;
      d += step_d;
      if (d >= D) {
        d -= D;
        ++r;
      }
    }
  }
  __syncthreads();

  // du: each (q, d) sums its products in ascending r
  for (int t = threadIdx.x; t < nq * D; t += blockDim.x) {
    const int q = t / D, d = t % D;
    const float* col = ms + (size_t)q * MD + d;
    float acc = col[0];
    for (int r = 1; r < M; ++r) acc = __fadd_rn(acc, col[r * D]);
    du[(size_t)b0 * D + t] = acc;
  }
}

template <int Mode>
int launch(const float* m, const float* u, const float* g, float* dm,
           float* du, int B, int M, int D, int qpb, int threads,
           const HamFmt& ham, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(qpb, M, D);
  // raised once per instance and device (the attribute is per device)
  static bool opted_in[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (bytes > 48 * 1024 && !(dev < 64 && opted_in[dev])) {
    const cudaError_t rc = cudaFuncSetAttribute(
        hamming_bwd_kernel<Mode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (rc != cudaSuccess) return (int)rc;
    if (dev < 64) opted_in[dev] = true;
  }
  const int vec16 = (M * D) % 4 == 0 && ((uintptr_t)m & 15u) == 0;
  hamming_bwd_kernel<Mode><<<(B + qpb - 1) / qpb, threads, bytes, stream>>>(
      m, u, g, dm, du, B, M, D, qpb, vec16, ham);
  return (int)cudaGetLastError();
}

}  // namespace

// geometry: host array of the queries per block and threads from the
// wrapper's backward_geometry.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for shapes, geometry or knobs out of
// range).
extern "C" int qmann_hamming_backward(const float* m, const float* u,
                                      const float* g, float* dm, float* du,
                                      int B, int M, int D, int iwl,
                                      int round_mode, int num_bit,
                                      int const_scale, const int* geometry,
                                      void* stream) {
  const int qpb = geometry[0], threads = geometry[1];
  if (B < 1 || M < 1 || M > kMaxMem || D < 1 || D > kMaxDim || qpb < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      sizeof(float) * smem_floats(qpb, M, D) > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  HamFmt ham;
  // weight_para and weighted change the forward only
  if (!qmann::make_hamfmt(iwl, round_mode, num_bit, const_scale, 0, 1, &ham))
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  switch (round_mode) {
    case 0: return launch<0>(m, u, g, dm, du, B, M, D, qpb, threads, ham, st);
    case 1: return launch<1>(m, u, g, dm, du, B, M, D, qpb, threads, ham, st);
    case 2: return launch<2>(m, u, g, dm, du, B, M, D, qpb, threads, ham, st);
    default: return launch<3>(m, u, g, dm, du, B, M, D, qpb, threads, ham, st);
  }
}
