// The quantized mat-vec lattice:
//   out[b, o] = Q(sum_i Q(Q(w[o,i], fmt_w) * Q(x[b,i], fmt_x), fmt_w), fmt_w)
// w [O, I], x [B, I] -> out [B, O], float32, row-major and contiguous (or
// per run of a family: w [R, O, I], x [R, B, I] -> out [R, B, O]).
//
// Replaces the TPU kernel qmatvec_pallas / _qmatvec_kernel
// (qmann_tpu/ops/pallas/qkernels.py).  The XNOR-net scale of a binary
// weight format stays with the caller, as there (ops/qlinear.py).  On the
// training path it runs 10 times per forward: the query embedding
// (B=32 rows, O=60, I=29), the 2K=6 memory embeddings (B*M = 320 rows;
// 10240 rows in a 1024-query evaluation chunk) and the 3 linear maps
// (O=I=60).  The run.sh family (train/multi.py, R = 200 runs) gives each
// memory embedding 200 x 1600 rows of I = 114 in one launch.
//
// The embeddings' x are bag-of-words rows: a few word counts and a time
// bit out of I entries, and the rows of a story's unused slots all zero
// (~3.9 nonzeros a row of 114 in the family).  Every other product is
// Q(Q(w) * 0) = 0, so the whole-row kernel forms only the products whose
// Q(x) entry is nonzero: one algorithm for every caller, its loop as long
// as the row's nonzero entries (a linear map's dense rows take them all).
//
// Why skipping is exact.  For every format FastQ takes (non-binary, at
// most 30 bits), Q(+-0) = +-0, and Q(Q(w) * +-0) = +-0 unless Q(w) is NaN
// (NaN * 0 = NaN).  A row's sum starts at +0 and runs in order of i; it
// never becomes -0 (+0 + -0 = +0 under round to nearest), so adding +-0
// leaves it as it is, NaN and infinities included.  So leaving out every
// entry with Q(x[b, i]) == +-0 whose column i of Q(w) holds no NaN gives,
// bit for bit, the in-order sum over all entries, for any format and
// whether or not the float32 sum is exact.  A NaN in x is no zero and is
// taken.  AnyQ's formats keep every entry: the binary format quantizes 0
// to +1, and 31-bit formats take the dense loop too.  The plain version
// sums in another order; the products lie on the 2^-frac grid and, for
// the models' words, the partial sums stay under 2^24 grid units, so the
// float32 sum is exact in any order and the kernel equals the plain
// version bit for bit.
//
// The design, for the H100.  A block stages its run's Q(w) once,
// transposed, wq [I][ld] (ld = O, odd where that fits, so the staging's
// transposed stores hit 32 banks), and a bit per column of Q(w) that
// holds a NaN (found only where a __syncthreads_or says a NaN was staged),
// then walks many rows: one warp a row.  The lanes load the row's first
// kChunks * 32 entries coalesced (the next row's load in flight while this
// one is walked), quantize them, and a ballot a piece of 32 marks the
// entries to take; the warp lists them in its shared list in order of i
// (offset of column i in wq, Q(x)[i]) and walks the list four entries at a
// time, lane l summing outputs l and l + 32 (a lane past O repeats output
// O - 1, so that the walk has no branch, and stores nothing).  An all-zero
// row lists nothing and stores Q(+0) = 0.  Rows of at most 128 entries and
// 64 outputs (every embedding and linear map of the configurations) take
// the instance whose loops over pieces and passes run once, unrolled.  For
// FastQ the kernel keeps every value scaled by s = 2^frac of fmt_w: the
// staged weight is Q(w) s, a product clamp(round(Q(w) s * v), -n, n) with
// n = maxf s, the sum's requant clamp(round(acc), -n, n) / s.  Scaling by
// a power of two commutes with float32 rounding wherever nothing
// overflows or turns subnormal (a nonzero |Q(w) v| lies in [2^-60, 2^61],
// the scaled partial sums are integers below 2^44), and the clamp with a
// positive scaling, so each scaled value is its unscaled FastQ value
// times s bit for bit: one multiply a product fewer.  The wrapper picks
// the rows per block (ops/cuda/qmatvec.py::qmatvec_geometry): one row a
// warp while every run's blocks fit one wave of the card, else as many
// blocks a run as one wave holds, but for about MAX_ROWS = 160 rows a
// block, the fastest of 96 to 640 at the family's shapes (PERF.md).
//
// What bounds it on an H100: the float32 bytes of x and of the output,
// not operations.  At the family's memory embedding (200 x 1600 rows,
// I = 114, O = 60) x is 146 MB and the output 77 MB: 67 us at 3.35 TB/s.
// The products the inputs need are 320,000 rows x 3.9 entries x 60
// outputs, ~75 M requants (the dense lattice forms 2.19 G), beside ~37 M
// requants of Q(x) and ~14 M of the blocks' Q(w); no operation pipe comes
// near the bytes.  Measured on one H100 80GB HBM3 at 700 W (device time,
// scripts/kernel_times.py and chip_smoke.py phase 16; PERF.md, section 6):
// 114-132 us at 200 x 1600 rows (52-60% of the bytes' bound; 944-954 us
// for the dense design), 415 us at 200 x 6400 (3,744-3,785 us); 2.9 us at
// 320 rows and 2.8 us at 32 (launch bound, as before), 4.7 us at 1600 and
// 6.9 us at 10240 (10.4, 11.3); the 32-row linear map (dense, 60 entries)
// 5.05 us against 4.05: its staging and walk are latency chains of one
// warp.
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
// The family axis.  The family trainer (train/multi.py) stacks R runs'
// weights, w [R, O, I] against x [R, B, I] -> out [R, B, O], as JAX's vmap
// of the TPU kernel gives it a leading grid axis.  Both kernels take the
// run from blockIdx.z and offset w, x and out by it: each block stages its
// own run's Q(w), so a block's work and numerics are those of the 2-D call
// (R = 1, unchanged in grid and results).  At the run.sh family a memory
// embedding's 200 x 1600 rows take 2000 blocks of 160 rows (the wrapper's
// rows rule counts the blocks of all runs).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc  (qmann_tpu_torch/ops/cuda/_build.py does it).
#include <cuda_runtime.h>

#include <type_traits>

#include "qformat.cuh"

namespace {

using qmann::AnyQ;
using qmann::FastQ;
using qmann::QFmt;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemFloats = 12288;  // 48 KB: no opt-in attribute needed
constexpr int kChunks = 4;  // 32-entry pieces of a row of x loaded at once
constexpr int kOuts = 2;    // outputs a lane sums per pass over the row

// The whole-row kernel's shared memory, in floats: Q(w) of one run,
// transposed, wq [I][ld] with ld = O padded to odd where that fits (the
// staging's transposed stores then hit 32 banks); a bit per column that
// holds a NaN, ceil(I / 32) words; then, 8-byte aligned, each warp's list
// of the entries it takes from a piece of kChunks * 32 of a row.
__host__ __device__ inline int wq_stride(int O, int I) {
  const long long odd = (long long)I * (O | 1) + (I + 31) / 32;
  return odd <= kSmemFloats ? (O | 1) : O;
}
__host__ __device__ inline int list_offset(int O, int I) {
  return (I * wq_stride(O, I) + (I + 31) / 32 + 1) & ~1;
}
constexpr int kListFloats = kWarps * 32 * kChunks * 2;

// The whole-row kernel's three requants: of a staged weight, of a product
// with an entry v of Q(x), and of the sum.  AnyQ as the formula reads.
template <class Q>
struct Lattice {
  Q q;
  static __device__ Lattice from(const QFmt& f) { return {Q::from(f)}; }
  __device__ float stage(float w) const { return q(w); }
  __device__ float product(float wq, float v) const { return q(wq * v); }
  __device__ float finish(float acc) const { return q(acc); }
};

// FastQ keeps every value scaled by s = 2^frac of fmt_w (the header): a
// staged weight is Q(w) s, a product clamp(round(Q(w) s * v), -n, n) with
// n = maxf s, the sum's requant clamp(round(acc), -n, n) / s.
template <int Mode>
struct Lattice<FastQ<Mode>> {
  float scale, inv_scale, n;
  static __device__ Lattice from(const QFmt& f) {
    return {f.scale, f.inv_scale, f.maxf * f.scale};
  }
  __device__ float stage(float w) const {
    return qmann::clamp_nan(qmann::round_by<Mode>(w * scale), -n, n);
  }
  __device__ float product(float wq, float v) const {
    return qmann::clamp_nan(qmann::round_by<Mode>(wq * v), -n, n);
  }
  __device__ float finish(float acc) const {
    return qmann::clamp_nan(qmann::round_by<Mode>(acc), -n, n) * inv_scale;
  }
};

// kOnePiece: a row is one piece and one pass (I <= 32 * kChunks, O <= 32 *
// kOuts), so that the loops over pieces and passes run once, unrolled.
template <class Q, bool kOnePiece>
__global__ void __launch_bounds__(kThreads)
qmatvec_kernel(const float* __restrict__ w,   // [R, O, I] raw
               const float* __restrict__ x,   // [R, B, I] raw
               float* __restrict__ out,       // [R, B, O]
               int B, int O, int I, int rows, QFmt fmt_w, QFmt fmt_x) {
  // FastQ maps 0 to +-0, and Q(Q(w) * +-0) is +-0 unless Q(w) is NaN: a
  // zero entry of Q(x) whose column of Q(w) holds no NaN adds nothing.
  // AnyQ's formats (binary: 0 -> +1; 31 bits wide) take every entry.
  constexpr bool kSkip = !std::is_same<Q, AnyQ>::value;
  const auto lat = Lattice<Q>::from(fmt_w);
  const Q fx = Q::from(fmt_x);
  extern __shared__ float smem[];
  // the run of the family axis: its own w, rows of x and outputs
  w += (size_t)blockIdx.z * O * I;
  x += (size_t)blockIdx.z * B * I;
  out += (size_t)blockIdx.z * B * O;
  const int ld = wq_stride(O, I);
  float* wq = smem;                                              // [I][ld]
  unsigned* nan_cols = reinterpret_cast<unsigned*>(smem + I * ld);

  // stage Q(w)^T, k = o * I + i stepped without a division
  bool nan_seen = false;
  {
    const int step_o = kThreads / I, step_i = kThreads % I;
    int o = threadIdx.x / I, i = threadIdx.x % I;
    for (int k = threadIdx.x; k < O * I; k += kThreads) {
      const float q = lat.stage(__ldg(w + k));
      wq[i * ld + o] = q;
      nan_seen |= q != q;
      o += step_o;
      i += step_i;
      if (i >= I) {
        i -= I;
        ++o;
      }
    }
  }
  bool any_nan = false;
  if (kSkip) {
    any_nan = __syncthreads_or(nan_seen);
  } else {
    __syncthreads();
  }
  if (any_nan) {   // the columns of Q(w) that hold a NaN (weights gone bad)
    for (int k = threadIdx.x; k < (I + 31) / 32; k += kThreads) nan_cols[k] = 0u;
    __syncthreads();
    for (int i = threadIdx.x; i < I; i += kThreads) {
      bool nan = false;
      for (int o = 0; o < O; ++o) nan |= wq[i * ld + o] != wq[i * ld + o];
      if (nan) atomicOr(nan_cols + i / 32, 1u << (i % 32));
    }
    __syncthreads();
  }

  // one warp a row: the lanes load and quantize kChunks pieces of 32
  // entries, a ballot a piece marks those to take, and the warp lists them
  // in order of i (the offset of column i in wq, Q(x)[i]), then walks the
  // list, lane l summing outputs o0 + l + 32 j (a lane past O repeats
  // output O - 1, so that the walk has no branch, and stores nothing).
  // The next row's first piece loads meanwhile.
  const int lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  float2* list = reinterpret_cast<float2*>(smem + list_offset(O, I)) +
                 threadIdx.x / 32 * 32 * kChunks;
  const int b_end = min(B, (blockIdx.x + 1) * rows);
  int b = blockIdx.x * rows + threadIdx.x / 32;
  float next[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    next[c] = b < b_end && 32 * c + lane < I
                  ? __ldg(x + (size_t)b * I + 32 * c + lane) : 0.f;
  for (; b < b_end; b += kWarps) {
    const float* xr = x + (size_t)b * I + lane;
    float* orow = out + (size_t)b * O + lane;
    for (int o0 = 0; o0 < (kOnePiece ? 1 : O); o0 += 32 * kOuts) {
      int oj[kOuts];
      float acc[kOuts];
#pragma unroll
      for (int j = 0; j < kOuts; ++j) {
        oj[j] = min(o0 + 32 * j + lane, O - 1);
        acc[j] = 0.f;
      }
      for (int g = 0; g < (kOnePiece ? 1 : I); g += 32 * kChunks) {
        float xq[kChunks];
        if (g == 0 && o0 == 0) {
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            xq[c] = next[c];
            next[c] = b + kWarps < b_end && 32 * c + lane < I
                          ? __ldg(xr + (size_t)kWarps * I + 32 * c) : 0.f;
          }
        } else {
#pragma unroll
          for (int c = 0; c < kChunks; ++c)
            xq[c] = g + 32 * c + lane < I ? __ldg(xr + g + 32 * c) : 0.f;
        }
        int n = 0;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int i = g + 32 * c + lane;
          xq[c] = fx(xq[c]);
          unsigned take = __ballot_sync(0xffffffffu,
                                        i < I && (!kSkip || xq[c] != 0.f));
          if (any_nan && g + 32 * c < I) take |= nan_cols[g / 32 + c];
          if (take >> lane & 1u)
            list[n + __popc(take & below)] =
                make_float2(__int_as_float(i * ld), xq[c]);
          n += __popc(take);
        }
        __syncwarp();
#pragma unroll 4   // the walk: four entries' requants in flight
        for (int k = 0; k < n; ++k) {
          const float2 e = list[k];
          const float* wc = wq + __float_as_int(e.x);
#pragma unroll
          for (int j = 0; j < kOuts; ++j)
            acc[j] += lat.product(wc[oj[j]], e.y);
        }
        __syncwarp();   // the list is written again next
      }
#pragma unroll
      for (int j = 0; j < kOuts; ++j)
        if (o0 + 32 * j + lane < O) orow[o0 + 32 * j] = lat.finish(acc[j]);
    }
  }
}

constexpr int kMaxOutputs = 4;   // outputs per thread in the tiled kernel
constexpr int kMaxRuns = 65535;  // the grid's z extent: runs of the family

template <class Q>
__global__ void __launch_bounds__(kThreads)
qmatvec_tiled_kernel(const float* __restrict__ w,   // [R, O, I] raw
                     const float* __restrict__ x,   // [R, B, I] raw
                     float* __restrict__ out,       // [R, B, O]
                     int B, int O, int I, int rows, int o_tile, int i_tile,
                     QFmt fmt_w, QFmt fmt_x) {
  const Q fw = Q::from(fmt_w), fx = Q::from(fmt_x);
  extern __shared__ float smem[];
  w += (size_t)blockIdx.z * O * I;
  x += (size_t)blockIdx.z * B * I;
  out += (size_t)blockIdx.z * B * O;
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

// The whole-row kernel's launch: the one-piece instance where a row fits
// one piece and one pass; shared memory past 48 KB (wide O*I) asked for
// first.
template <class Q>
void launch_whole(dim3 grid, size_t smem, cudaStream_t st, const float* w,
                  const float* x, float* out, int B, int O, int I, int rows,
                  QFmt fw, QFmt fx) {
  const auto kernel = I <= 32 * kChunks && O <= 32 * kOuts
                          ? qmatvec_kernel<Q, true>
                          : qmatvec_kernel<Q, false>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  kernel<<<grid, kThreads, smem, st>>>(w, x, out, B, O, I, rows, fw, fx);
}

}  // namespace

// R: the runs of the family axis (1 for one w [O, I]); w [R, O, I],
// x [R, B, I] and out [R, B, O], each run's slices contiguous.
// fmts: host array of the (iwl, frac, mode) triples of fmt_w and fmt_x.
// rows: the rows of x per block; o_tile, i_tile: the tiles of O and I,
// all from the wrapper's geometry.  o_tile == O and i_tile == I launch the
// whole-row kernel (O*I + I <= 12288 floats), grid ceil(B / rows) x 1 x R;
// anything else the tiled kernel, grid ceil(B / rows) x ceil(O / o_tile)
// x R, 256 threads per block either way.  It runs FastQ<mode>, and the
// whole-row kernel skips the zero entries of Q(x), when both formats are
// non-binary, at most 30 bits wide and of one rounding mode
// (ops/cuda/qmatvec.py::skips_zeros), else AnyQ.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes,
// tiles or formats out of range).
extern "C" int qmann_qmatvec(const float* w, const float* x, float* out,
                             int R, int B, int O, int I, const int* fmts,
                             int rows, int o_tile, int i_tile, void* stream) {
  if (R < 1 || R > kMaxRuns || B < 1 || O < 1 || I < 1 || rows < 1 ||
      o_tile < 1 || o_tile > O || i_tile < 1 || i_tile > I)
    return (int)cudaErrorInvalidValue;
  const bool whole = o_tile == O && i_tile == I;
  size_t smem_floats;
  if (whole) {
    if ((long long)O * I + I > kSmemFloats) return (int)cudaErrorInvalidValue;
    smem_floats = (size_t)list_offset(O, I) + kListFloats;
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
    launch_whole<QT>(dim3(row_blocks, 1, R), smem, st, w, x, out, B, O, I, \
                     rows, fw, fx);                                        \
  else                                                                     \
    qmatvec_tiled_kernel<QT><<<dim3(row_blocks, (O + o_tile - 1) / o_tile, \
                                    R), kThreads, smem, st>>>(             \
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
