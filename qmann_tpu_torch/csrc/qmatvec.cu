// The quantized mat-vec lattice:
//   out[b, o] = Q(sum_i Q(Q(w[o,i], fmt_w) * Q(x[b,i], fmt_x), fmt_w), fmt_w)
// w [O, I], x [B, I] -> out [B, O], float32, row-major and contiguous.
//
// Replaces the TPU kernel qmatvec_pallas / _qmatvec_kernel
// (qmann_tpu/ops/pallas/qkernels.py).  The XNOR-net scale of a binary
// weight format stays with the caller, as there (ops/qlinear.py).  On the
// training path it runs 10 times per forward: the query embedding
// (B=32 rows, O=60, I=29), the 2K=6 memory embeddings (B*M = 320 rows;
// 10240 rows in a 1024-query evaluation chunk) and the 3 linear maps
// (O=I=60).  A training epoch of 1000 stories launches it 128 times at
// 32 rows and 192 times at 320 rows, and an evaluation chunk of up to
// 1024 queries 10 times (6 of them at up to 10240 rows), so the small
// calls carry the epoch.
//
// What bounds it on an H100: every product is requantized before the sum,
// so the contraction is no GEMM and the tensor cores do not apply; it is
// bound by float operations.  At the 10240-row evaluation chunk it does
// 10240*60*29 = 17.8 M requantized products (~110 M operations, ~1.65 us
// at 67 TFLOP/s) on 1.2 MB of x; at the 320-row training shape ~0.05 us,
// far below the time it takes to launch a kernel.  The design: one block
// quantizes the whole of w into shared memory (O*I floats, 7 KB at the
// flagship shape) together with its tile of rows of x, then gives each
// thread one output (b, o) at a time with a loop over I.  Loads of w and x
// and stores of out are contiguous across threads.  The rounding mode is
// fixed at compile time and saturation is a branch-free clamp (FastQ<Mode>,
// qformat.cuh; AnyQ, the runtime fq, only where a format is binary or 31
// bits wide).  The wrapper picks the rows per block
// (ops/cuda/qmatvec.py::qmatvec_geometry): as many as one round of the 256
// threads covers (4 at O=60), which spreads even the 32-row query call
// over 8 blocks; doubled while the grid holds more blocks than the card
// runs at once, up to 16 at O=60, so that w's requant is paid 640 times at
// 10240 rows, not 2560.  A transposed [I][O] staging with 4 rows per
// thread (each Q(w) read feeding 4 products) and a 4x4 register tile were
// measured and dropped: both slower at 320 and 1600 rows.
// Measured on one H100 80GB HBM3 at 700 W (device time,
// scripts/kernel_times.py; PERF.md, section 6): 2.8-3.0 us at 320 rows,
// 9.8 us at 1600 (I=114) and 11.2 us at 10240, from 5.8, 26.8 and 30.7 us
// for the first design.
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

using qmann::AnyQ;
using qmann::FastQ;
using qmann::QFmt;

constexpr int kThreads = 256;
constexpr int kSmemFloats = 12288;  // 48 KB: no opt-in attribute needed

template <class Q>
__global__ void __launch_bounds__(kThreads)
qmatvec_kernel(const float* __restrict__ w,   // [O, I] raw
               const float* __restrict__ x,   // [B, I] raw
               float* __restrict__ out,       // [B, O]
               int B, int O, int I, int rows, QFmt fmt_w, QFmt fmt_x) {
  const Q fw = Q::from(fmt_w), fx = Q::from(fmt_x);
  extern __shared__ float smem[];
  float* wq = smem;            // [O, I]    Q(w, fmt_w)
  float* xq = smem + O * I;    // [rows, I] Q(x, fmt_x)
  const int b0 = blockIdx.x * rows;
  const int nr = min(rows, B - b0);
  const float* xb = x + (size_t)b0 * I;

  for (int k = threadIdx.x; k < O * I; k += kThreads) wq[k] = fw(__ldg(w + k));
  for (int k = threadIdx.x; k < nr * I; k += kThreads)
    xq[k] = fx(__ldg(xb + k));
  __syncthreads();

  for (int k = threadIdx.x; k < nr * O; k += kThreads) {
    const int r = k / O;
    const int o = k - r * O;
    const float* wr = wq + o * I;
    const float* xr = xq + r * I;
    float acc = 0.f;
    for (int i = 0; i < I; ++i) acc += fw(wr[i] * xr[i]);
    out[(size_t)(b0 + r) * O + o] = fw(acc);
  }
}

}  // namespace

// fmts: host array of the (iwl, frac, mode) triples of fmt_w and fmt_x.
// rows: the rows of x per block, from the wrapper's geometry; the launch
// takes ceil(B / rows) blocks of 256 threads.  It runs FastQ<mode> when
// both formats are non-binary, at most 30 bits wide and of one rounding
// mode, else AnyQ.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes, rows or formats out of range).
extern "C" int qmann_qmatvec(const float* w, const float* x, float* out,
                             int B, int O, int I, const int* fmts, int rows,
                             void* stream) {
  if (B < 1 || O < 1 || I < 1 || O > kSmemFloats || I > kSmemFloats ||
      O * I + I > kSmemFloats || rows < 1 || rows > (kSmemFloats - O * I) / I)
    return (int)cudaErrorInvalidValue;
  QFmt fw, fx;
  if (!qmann::make_qfmt(fmts[0], fmts[1], fmts[2], &fw) ||
      !qmann::make_qfmt(fmts[3], fmts[4], fmts[5], &fx))
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + rows - 1) / rows;
  const size_t smem = sizeof(float) * (size_t)(O * I + rows * I);
  const auto st = (cudaStream_t)stream;
#define QMV_LAUNCH(QT)                                              \
  qmatvec_kernel<QT><<<blocks, kThreads, smem, st>>>(w, x, out, B, O, I, \
                                                     rows, fw, fx)
  if (!qmann::fastq_exact(fw) || !qmann::fastq_exact(fx) ||
      fw.mode != fx.mode)
    QMV_LAUNCH(AnyQ);
  else if (fw.mode == 0)
    QMV_LAUNCH(FastQ<0>);
  else if (fw.mode == 1)
    QMV_LAUNCH(FastQ<1>);
  else if (fw.mode == 2)
    QMV_LAUNCH(FastQ<2>);
  else
    QMV_LAUNCH(FastQ<3>);
#undef QMV_LAUNCH
  return (int)cudaGetLastError();
}
