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
// Wide inputs (O*I + I > 12288 floats: Q(w) and one row of x would not
// fit in 48 KB) take a second kernel, tiled over I and O, so the kernel
// takes any O, I >= 1 that the TPU kernel takes.  EN_JOINT's memory rows
// reach it: dim_input = 192 + 64 = 256 at dim_emb 60 is 15616 floats.  A
// block owns `rows` rows of x and an O-tile of up to 256 outputs (grid
// ceil(B / rows) x ceil(O / o_tile)); it walks I in tiles of i_tile,
// staging Q(w)[O-tile, I-tile] and Q(x)[rows, I-tile] in shared memory (an
// odd row stride, so the 32 lanes of a warp reading 32 rows of Q(w) hit 32
// banks), and each thread keeps the raw sums of its outputs (at most
// kMaxOutputs, strided by the block's threads) in registers across the
// I-tiles.  Q(., fmt_w) is applied once, after the last I-tile, as the TPU
// kernel's _finish does.  The sum runs over i in the same order as the
// whole-row kernel's, and is exact in any order (above).  The rows per
// block follow the whole-row rule (a base tile of 256 / o_tile rows,
// doubled up to 4x while the grid exceeds the resident blocks); i_tile is
// the wrapper's (ops/cuda/qmatvec.py::qmatvec_geometry, at most
// MAX_I_TILE = 64 so that 8 blocks of 256 threads stay resident per SM).
// Bounds: O, I >= 1 (O tiled by 256, I by i_tile); rows * o_tile <=
// kMaxOutputs * 256; (o_tile + rows) * (i_tile | 1) <= 12288 floats.
// Measured on one H100 80GB HBM3 at 700 W (scripts/kernel_times.py;
// PERF.md, section 6): 33 us at 2048 rows and 540 us at 65536 rows (I=256),
// 140 us at 2048 rows (I=1024), 8-17% of the operation bound.  Per product
// the inner loop issues one rounding instruction (truncf/floorf/rintf) and
// two shared-memory loads; at 16 roundings and 32 shared-memory lanes per
// clock per SM each alone would take ~240 us at 65536 rows (an estimate
// from those rates, not a profile), about half the measured time.  At
// I=114 the tiled kernel is 69% slower than the whole-row one: a tile of I
// per thread leaves each output's requant chain as long as before.
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

constexpr int kMaxOutputs = 4;   // outputs per thread in the tiled kernel

template <class Q>
__global__ void __launch_bounds__(kThreads)
qmatvec_tiled_kernel(const float* __restrict__ w,   // [O, I] raw
                     const float* __restrict__ x,   // [B, I] raw
                     float* __restrict__ out,       // [B, O]
                     int B, int O, int I, int rows, int o_tile, int i_tile,
                     QFmt fmt_w, QFmt fmt_x) {
  const Q fw = Q::from(fmt_w), fx = Q::from(fmt_x);
  extern __shared__ float smem[];
  const int ld = i_tile | 1;          // odd stride: conflict-free over o
  float* wq = smem;                   // [o_tile, ld]  Q(w) of the I-tile
  float* xq = smem + o_tile * ld;     // [rows, ld]    Q(x) of the I-tile
  const int b0 = blockIdx.x * rows, o0 = blockIdx.y * o_tile;
  const int nr = min(rows, B - b0), no = min(o_tile, O - o0);
  const int n_out = nr * no;
  float acc[kMaxOutputs];
#pragma unroll
  for (int j = 0; j < kMaxOutputs; ++j) acc[j] = 0.f;

  for (int i0 = 0; i0 < I; i0 += i_tile) {
    const int ni = min(i_tile, I - i0);
    __syncthreads();   // every thread is done with the previous I-tile
    for (int k = threadIdx.x; k < no * ni; k += kThreads) {
      const int o = k / ni, i = k - o * ni;
      wq[o * ld + i] = fw(__ldg(w + (size_t)(o0 + o) * I + i0 + i));
    }
    for (int k = threadIdx.x; k < nr * ni; k += kThreads) {
      const int r = k / ni, i = k - r * ni;
      xq[r * ld + i] = fx(__ldg(x + (size_t)(b0 + r) * I + i0 + i));
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxOutputs; ++j) {
      const int k = threadIdx.x + j * kThreads;
      if (k < n_out) {
        const int r = k / no, o = k - r * no;
        const float* wr = wq + o * ld;
        const float* xr = xq + r * ld;
        float a = acc[j];
        for (int i = 0; i < ni; ++i) a += fw(wr[i] * xr[i]);
        acc[j] = a;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxOutputs; ++j) {
    const int k = threadIdx.x + j * kThreads;
    if (k < n_out) {
      const int r = k / no, o = k - r * no;
      out[(size_t)(b0 + r) * O + o0 + o] = fw(acc[j]);
    }
  }
}

}  // namespace

// fmts: host array of the (iwl, frac, mode) triples of fmt_w and fmt_x.
// rows: the rows of x per block; o_tile, i_tile: the tiles of O and I,
// all from the wrapper's geometry.  o_tile == O and i_tile == I launch the
// whole-row kernel (O*I + rows*I <= 12288 floats), grid ceil(B / rows);
// anything else the tiled kernel, grid ceil(B / rows) x ceil(O / o_tile),
// 256 threads per block either way.  It runs FastQ<mode> when both formats
// are non-binary, at most 30 bits wide and of one rounding mode, else
// AnyQ.  Returns cudaGetLastError() after the launch (cudaErrorInvalidValue
// for shapes, tiles or formats out of range).
extern "C" int qmann_qmatvec(const float* w, const float* x, float* out,
                             int B, int O, int I, const int* fmts, int rows,
                             int o_tile, int i_tile, void* stream) {
  if (B < 1 || O < 1 || I < 1 || rows < 1 || o_tile < 1 || o_tile > O ||
      i_tile < 1 || i_tile > I)
    return (int)cudaErrorInvalidValue;
  const bool whole = o_tile == O && i_tile == I;
  size_t smem_floats;
  if (whole) {
    if ((long long)O * I + I > kSmemFloats ||
        rows > (kSmemFloats - O * I) / I)
      return (int)cudaErrorInvalidValue;
    smem_floats = (size_t)O * I + (size_t)rows * I;
  } else {
    if (o_tile > kThreads || rows > kThreads ||
        rows * o_tile > kMaxOutputs * kThreads ||
        (o_tile + rows) * (i_tile | 1) > kSmemFloats)
      return (int)cudaErrorInvalidValue;
    smem_floats = (size_t)(o_tile + rows) * (i_tile | 1);
  }
  QFmt fw, fx;
  if (!qmann::make_qfmt(fmts[0], fmts[1], fmts[2], &fw) ||
      !qmann::make_qfmt(fmts[3], fmts[4], fmts[5], &fx))
    return (int)cudaErrorInvalidValue;
  const int row_blocks = (B + rows - 1) / rows;
  const size_t smem = sizeof(float) * smem_floats;
  const auto st = (cudaStream_t)stream;
#define QMV_LAUNCH(QT)                                                     \
  if (whole)                                                               \
    qmatvec_kernel<QT><<<row_blocks, kThreads, smem, st>>>(                \
        w, x, out, B, O, I, rows, fw, fx);                                 \
  else                                                                     \
    qmatvec_tiled_kernel<QT>                                               \
        <<<dim3(row_blocks, (O + o_tile - 1) / o_tile), kThreads, smem, st>>>( \
            w, x, out, B, O, I, rows, o_tile, i_tile, fw, fx)
  if (!qmann::fastq_exact(fw) || !qmann::fastq_exact(fx) ||
      fw.mode != fx.mode) {
    QMV_LAUNCH(AnyQ);
  } else if (fw.mode == 0) {
    QMV_LAUNCH(FastQ<0>);
  } else if (fw.mode == 1) {
    QMV_LAUNCH(FastQ<1>);
  } else if (fw.mode == 2) {
    QMV_LAUNCH(FastQ<2>);
  } else {
    QMV_LAUNCH(FastQ<3>);
  }
#undef QMV_LAUNCH
  return (int)cudaGetLastError();
}
