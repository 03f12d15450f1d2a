// The quantized mat-vec lattice:
//   out[b, o] = Q(sum_i Q(Q(w[o,i], fmt_w) * Q(x[b,i], fmt_x), fmt_w), fmt_w)
// w [O, I], x [B, I] -> out [B, O], float32, row-major and contiguous.
//
// Replaces the TPU kernel qmatvec_pallas / _qmatvec_kernel
// (qmann_tpu/ops/pallas/qkernels.py).  The XNOR-net scale of a binary
// weight format stays with the caller, as there (ops/qlinear.py).  On the
// training path it runs 10 times per forward: the query embedding
// (B=32 rows, O=60, I=29), the 2K=6 memory embeddings (B*M = 320 rows) and
// the 3 linear maps (O=I=60).
//
// What bounds it on an H100: at the embedding shape it does 320*60*29 =
// 0.56 M requantized products on 121 KB of operands, which the card could
// read in ~0.04 us and compute in ~0.1 us; each call is far below the
// time it takes to launch one kernel, so it is latency-bound.  Every
// product is requantized before the sum, so the contraction is no GEMM
// and the tensor cores do not apply.  The design: one block quantizes the
// whole of w into shared memory once (O*I floats, 7 KB at the flagship
// shape) together with a few rows of x, then gives each thread one output
// (b, o) of its rows with a loop over I.  Rows per block are chosen so
// that a block's outputs about fill its threads (4 rows at O=60), which
// spreads even the 32-row query call over 8 blocks.  Loads of x and stores
// of out are contiguous across threads.
//
// Numerics: quantized products lie on the 2^-frac grid and the partial
// sums stay under 2^24 grid units, so the float32 sum is exact in any
// order and the kernel equals the plain version bit for bit.  The ragged
// edges are masked by index and nothing is padded: a binary format
// quantizes 0 to +1, so a zero pad would add products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc  (qmann_tpu_torch/ops/cuda/_build.py does it).
#include <cuda_runtime.h>

#include "qformat.cuh"

namespace {

using qmann::QFmt;
using qmann::fq;

constexpr int kThreads = 256;
constexpr int kMaxRows = 32;
constexpr int kSmemFloats = 12288;  // 48 KB: no opt-in attribute needed

__global__ void __launch_bounds__(kThreads)
qmatvec_kernel(const float* __restrict__ w,   // [O, I] raw
               const float* __restrict__ x,   // [B, I] raw
               float* __restrict__ out,       // [B, O]
               int B, int O, int I, int rows, QFmt fw, QFmt fx) {
  extern __shared__ float smem[];
  float* wq = smem;            // [O, I]    Q(w, fmt_w)
  float* xq = smem + O * I;    // [rows, I] Q(x, fmt_x)
  const int b0 = blockIdx.x * rows;
  const int nr = min(rows, B - b0);
  const float* xb = x + (size_t)b0 * I;

  for (int k = threadIdx.x; k < O * I; k += kThreads) wq[k] = fq(w[k], fw);
  for (int k = threadIdx.x; k < nr * I; k += kThreads) xq[k] = fq(xb[k], fx);
  __syncthreads();

  for (int k = threadIdx.x; k < nr * O; k += kThreads) {
    const int r = k / O;
    const int o = k - r * O;
    const float* wr = wq + o * I;
    const float* xr = xq + r * I;
    float acc = 0.f;
    for (int i = 0; i < I; ++i) acc += fq(wr[i] * xr[i], fw);
    out[(size_t)(b0 + r) * O + o] = fq(acc, fw);
  }
}

}  // namespace

// fmts: host array of the (iwl, frac, mode) triples of fmt_w and fmt_x.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// shapes or formats out of range).
extern "C" int qmann_qmatvec(const float* w, const float* x, float* out,
                             int B, int O, int I, const int* fmts,
                             void* stream) {
  if (B < 1 || O < 1 || I < 1 || O > kSmemFloats || I > kSmemFloats ||
      O * I + I > kSmemFloats)
    return (int)cudaErrorInvalidValue;
  QFmt fw, fx;
  if (!qmann::make_qfmt(fmts[0], fmts[1], fmts[2], &fw) ||
      !qmann::make_qfmt(fmts[3], fmts[4], fmts[5], &fx))
    return (int)cudaErrorInvalidValue;
  int rows = kThreads / O;
  rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  const int fit = (kSmemFloats - O * I) / I;
  rows = rows > fit ? fit : rows;
  const int blocks = (B + rows - 1) / rows;
  const size_t smem = sizeof(float) * (size_t)(O * I + rows * I);
  qmatvec_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      w, x, out, B, O, I, rows, fw, fx);
  return (int)cudaGetLastError();
}
