// The weighted sum's quantized backward, one memory row per warp: for the
// upstream gradient g [B, D] of o = Q(sum_r Q(Q(p[b, r]) * Q(c[b, r, d])))
// with padded rows masked,
//   dc[b, r, d] = Q_fo(Q(Q(p[b, r]) * Q(g[b, d]))) * mask[b, r]
//   dp[b, r]    = Q_fo(sum_d Q(Q(c[b, r, d]) * Q(g[b, d]))) * mask[b, r]
// c [B, M, D], p [B, M], mask [B, M], g [B, D] -> dc [B, M, D], dp [B, M];
// Q is the layer format fmt, Q_fo its gradient-output format (1,
// iwl+frac-1, mode) (ops/qlinear.py::_grad_out_fmt; the binary format's
// is binary too).
//
// No Pallas counterpart: the JAX package computes this branch
// (_qweighted_sum_bwd with grad_quantized, qmann_tpu/ops/qlinear.py:602)
// as plain jnp, which XLA fuses under jit.  This kernel is the port of
// that fusion.  Fixed-point attention mode 3 always takes it
// (QmannConfig.wsum_grad_quantized, after the reference's
// lib/layer.c:588-599), and EN_GRAD_QUANT's backward placement in the
// other modes.  The training backward runs it once per hop on the kernel
// route: from the fused read (ops/fused.py, use_pallas), from the unfused
// weighted sum (ops/qlinear.py::_QWeightedSum, use_pallas_hamming and
// EN_GRAD_QUANT's unfused chain) and the mesh's shard-local partial sum,
// at B=32 (a training batch; M=10, D=60 for the flagship) or a family's
// folded R x 32.
//
// Exactness.  dc is elementwise: each value is the same chain of
// roundings as the plain version's (products by __fmul_rn, never
// contracted into an FMA; the mask a multiply, not a select, so that a
// negative value on a padded row gives -0.0 as the plain version's
// product does).  dp sums D products on the 2^-frac grid of magnitude at
// most 2^(wl-1)-1 grid units each: at bw_wl <= 16 and D <= 256 every
// partial sum is below 2^24 units, an exact float32 in any order, so dp
// equals the plain version bit for bit.  At wider words the sums may
// round, and dp agrees within the rounding of a D-term float32 sum before
// the Q_fo requant (chip_smoke.check_wsum_backward counts the requants
// that flip).  Every sum starts from +0.0, as torch's does, so a row of
// -0.0 products sums to +0.0 on both.
//
// What bounds it on an H100: at B=32, M=10, D=60 one call moves 165 KB (c
// read and dc written once: 8BMD bytes; p, mask and dp: 12BM; g: 4BD),
// 0.049 us at 3.35 TB/s, and does about 0.4 M float operations
// (chip_smoke.wsum_backward_ops: per element two products, four requants
// of Q_OPS operations, the mask multiply and the add; per query the
// requants of g and p; per row the Q_fo requant and the mask), 0.006 us
// at 67 TFLOP/s: bytes.  At these sizes the time is the launch and one
// round trip to memory; at the mode-3 family's folded 1280 x 50 x 60 the
// bytes bound is 9.5 us.  This first design is right and simple, not
// fast:
//  - the quantizer is a template argument (FastQ<Mode> for formats of at
//    most 30 bits, FastQ31<Mode> for the 31-bit words, AnyQ for the binary
//    format): fmt and its Q_fo have the same word length, so one type
//    serves both;
//  - one query per block: the block stages Q(g)'s row, Q(p)'s row and
//    the mask's row in shared memory once, so no thread requantizes g
//    per memory row;
//  - one warp per memory row (q, r), lanes on consecutive d: c is read
//    and dc written coalesced along d; each lane sums its products in
//    ascending d, then the warp adds the 32 partial sums by a fixed
//    butterfly of shuffles: one order for every launch, no atomics, so a
//    CUDA graph's replay equals the eager launch bit for bit.
// The wrapper picks the threads (ops/cuda/qweighted_sum_bwd.py::
// backward_threads).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc  (qmann_tpu_torch/ops/cuda/_build.py does it).
#include <cstdint>

#include <cuda_runtime.h>

#include "qformat.cuh"

namespace {

using qmann::AnyQ;
using qmann::FastQ;
using qmann::FastQ31;
using qmann::QFmt;

constexpr int kMaxMem = 64;
constexpr int kMaxDim = 256;
constexpr int kMaxThreads = 512;

template <class Q>
__global__ void __launch_bounds__(kMaxThreads)
qwsum_bwd_kernel(const float* __restrict__ c,     // [B, M, D]
                 const float* __restrict__ p,     // [B, M]
                 const float* __restrict__ mask,  // [B, M]
                 const float* __restrict__ g,     // [B, D]
                 float* __restrict__ dc,          // [B, M, D]
                 float* __restrict__ dp,          // [B, M]
                 int M, int D, Q q, Q qo) {
  __shared__ float gq[kMaxDim];
  __shared__ float pq[kMaxMem];
  __shared__ float mk[kMaxMem];
  const size_t b = blockIdx.x;
  for (int d = threadIdx.x; d < D; d += blockDim.x) gq[d] = q(g[b * D + d]);
  for (int r = threadIdx.x; r < M; r += blockDim.x) {
    pq[r] = q(p[b * M + r]);
    mk[r] = mask[b * M + r];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < M; r += warps) {
    const size_t row = (b * M + r) * D;
    const float pr = pq[r], mr = mk[r];
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float gd = gq[d];
      dc[row + d] = __fmul_rn(qo(q(__fmul_rn(pr, gd))), mr);
      acc = __fadd_rn(acc, q(__fmul_rn(q(c[row + d]), gd)));
    }
    // every lane ends with the same sum: a + b == b + a
    for (int o = 16; o > 0; o >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    if (lane == 0) dp[b * M + r] = __fmul_rn(qo(acc), mr);
  }
}

template <class Q>
int launch(const float* c, const float* p, const float* mask, const float* g,
           float* dc, float* dp, int B, int M, int D, int threads,
           const QFmt& f, const QFmt& fo, cudaStream_t stream) {
  qwsum_bwd_kernel<Q><<<B, threads, 0, stream>>>(
      c, p, mask, g, dc, dp, M, D, Q::from(f), Q::from(fo));
  return (int)cudaGetLastError();
}

template <int Mode>
int launch_mode(const float* c, const float* p, const float* mask,
                const float* g, float* dc, float* dp, int B, int M, int D,
                int threads, const QFmt& f, const QFmt& fo,
                cudaStream_t st) {
  if (f.full31)
    return launch<FastQ31<Mode>>(c, p, mask, g, dc, dp, B, M, D, threads, f,
                                 fo, st);
  return launch<FastQ<Mode>>(c, p, mask, g, dc, dp, B, M, D, threads, f, fo,
                             st);
}

}  // namespace

// fmt: the layer format (iwl, frac, mode); its gradient-output format is
// derived here.  threads: the block size from the wrapper's
// backward_threads (a multiple of 32).  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for shapes, threads or a format out of
// range).
extern "C" int qmann_qweighted_sum_backward(const float* c, const float* p,
                                            const float* mask, const float* g,
                                            float* dc, float* dp, int B, int M,
                                            int D, int iwl, int frac,
                                            int mode, int threads,
                                            void* stream) {
  if (B < 1 || M < 1 || M > kMaxMem || D < 1 || D > kMaxDim ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  QFmt f, fo;
  if (!qmann::make_qfmt(iwl, frac, mode, &f)) return (int)cudaErrorInvalidValue;
  // (1, iwl+frac-1): the same word length; the binary format's is binary
  if (f.binary) {
    fo = f;
  } else if (!qmann::make_qfmt(1, iwl + frac - 1, mode, &fo)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = (cudaStream_t)stream;
  if (f.binary)
    return launch<AnyQ>(c, p, mask, g, dc, dp, B, M, D, threads, f, fo, st);
  switch (mode) {
    case 0: return launch_mode<0>(c, p, mask, g, dc, dp, B, M, D, threads, f, fo, st);
    case 1: return launch_mode<1>(c, p, mask, g, dc, dp, B, M, D, threads, f, fo, st);
    case 2: return launch_mode<2>(c, p, mask, g, dc, dp, B, M, D, threads, f, fo, st);
    default: return launch_mode<3>(c, p, mask, g, dc, dp, B, M, D, threads, f, fo, st);
  }
}
