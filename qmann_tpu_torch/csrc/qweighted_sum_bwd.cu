// The weighted sum's backward, a query's rows split over a few warps (8
// lanes a row at D=60, 3 warps a query from 132 queries on, up to 8 below,
// two queries a block at 3), with two epilogues: for
// the upstream gradient g [B, D] of o = sum_r Q(Q(p[b, r]) * Q(c[b, r, d]))
// with padded rows masked (Q the layer format fmt, Q_fo its gradient-output
// format (1, iwl+frac-1, mode), ops/qlinear.py::_grad_out_fmt; the binary
// format's is binary too),
//   quantized instance:
//     dc[b, r, d] = Q_fo(Q(Q(p[b, r]) * Q(g[b, d]))) * mask[b, r]
//     dp[b, r]    = Q_fo(sum_d Q(Q(c[b, r, d]) * Q(g[b, d]))) * mask[b, r]
//   float instance (no quantizer):
//     dc[b, r, d] = (p[b, r] * mask[b, r]) * g[b, d]
//     dp[b, r]    = (sum_d c[b, r, d] * g[b, d]) * mask[b, r]
// and then either
//   the dp epilogue: writes dp [B, M], or
//   the ds epilogue (the softmax backward of the fused read):
//     dp <- dp + dp_in                  (when the cotangent of p is given)
//     S   = sum_r p[b, r] * dp[b, r]
//     ds  = p * (dp - S)                 (padded rows have p == 0)
//     ds <- ds + ds_in                   (when the scores' cotangent is given)
//   and writes ds [B, M].
// c [B, M, D], p [B, M], mask [B, M], g [B, D] -> dc [B, M, D] and dp or ds.
//
// No Pallas counterpart: the JAX package computes these as plain jnp, which
// XLA fuses under jit: the quantized and float branches of
// _qweighted_sum_bwd (qmann_tpu/ops/qlinear.py:602-621) and, in the fused
// read's backward, _fused_bwd (qmann_tpu/ops/fused.py:88-104), which runs
// the weighted-sum backward and the softmax backward in one body.  This
// kernel is the port of those fusions.  The fused read's backward
// (ops/fused.py, use_pallas) launches the ds epilogue once per hop in every
// attention mode: the quantized instance in fixed-point mode 3
// (QmannConfig.wsum_grad_quantized, after the reference's
// lib/layer.c:588-599), the float one in modes 1 and 2.  The unfused
// weighted sum (ops/qlinear.py::_QWeightedSum: use_pallas_hamming,
// EN_GRAD_QUANT's unfused chain, the mesh's shard-local partial sum)
// launches the dp epilogue of the quantized instance.  Shapes: B=32 (a
// training batch; M=10, D=60 for the flagship) or a family's folded R x 32.
//
// Exactness.
//  - dc is elementwise: each value is the same chain of roundings as the
//    plain version's (products by __fmul_rn, never contracted into an FMA;
//    the mask a multiply, not a select, so that a negative value on a
//    padded row gives -0.0 as the plain version's product does), in both
//    instances: bit for bit.
//  - quantized dp sums D products on the 2^-frac grid of magnitude at most
//    2^(wl-1)-1 grid units each: at word lengths up to 16 bits and D <= 256
//    every partial sum is below 2^24 units, an exact float32 in any order,
//    so dp equals the plain version bit for bit (sums_exact); at wider words
//    it lies in dp_interval, the values a float32 sum in any order gives
//    after the Q_fo requant.  Every sum starts from +0.0, as torch's does,
//    so a row of -0.0 products sums to +0.0 on both.
//  - float dp sums with FMAs in another order than the plain einsum: within
//    2*D*2^-24*sum_d|c*g| of it.
//  - ds: S is an M-term float32 sum in another order than torch's, within
//    2*M*2^-24*sum_r|p*dp| of it (plus sum_r |p| times dp's own bound in
//    the float instance), carried through p*(dp - S) and the adds
//    (ops/cuda/qweighted_sum_bwd.py::ds_bound).
//  Every sum is taken in one fixed order per shape (no atomics, no order
//  that depends on timing), so a CUDA graph's replay equals the eager
//  launch bit for bit.
//
// What bounds it on an H100: the bytes.  At the mode-3 family's folded
// 1280 x 50 x 60 one call moves 31.8 MB (c read and dc written once: 8BMD
// bytes; p, mask and the output: 12BM, plus 4BM for each given cotangent;
// g: 4BD), 9.5 us at 3.35 TB/s; its operations (per element two products,
// four requants of 4 float operations, the mask multiply and the add; one
// rounding per requant on the conversion pipe, 16 per clock per SM) take
// 3.7 us on the conversion pipe and less on the float32 pipe
// (chip_smoke.wsum_backward_ops).  At B=32, M=10 the call moves 165 KB,
// 0.049 us: the launch and one round trip to memory set its time.  The
// design keeps memory busy from the first cycle:
//  - no staging before the first load of c: each lane holds its columns of
//    Q(g) in registers, and its rows' Q(p) (or p*mask) and mask, which the
//    row loop takes by shuffles;
//  - lanes own fixed column groups of 4 along d: c is read and dc written
//    as 128-bit accesses where D % 4 == 0 and the pointers are 16-byte
//    aligned (a scalar instance of the same kernel takes the rest), L lanes
//    a row (the fewest that leave a lane at most 2 groups), 32/L rows a
//    warp step: at D=60 8 lanes a row, 4 rows a step;
//  - a query's steps split over W warps (3 from 132 queries on, up to 8
//    below, never more than its steps), two queries a block at W = 3: one
//    warp a query would run 13 dependent steps at M=50, with too few warps
//    on the card to cover the memory latency (18 us at 1280 queries);
//  - every lane holds 2 column groups (a group past D is neither loaded
//    nor stored), and each warp runs unpredicated passes of 2 steps, the
//    loads of a pass issued before its arithmetic (4 loads of 16 bytes in
//    flight a lane), then single steps for the rest;
//  - dp's partial sums are reduced within the row's lanes by a fixed
//    butterfly of shuffles; the row's dp goes to the query's scratch in
//    shared memory; after one barrier at the end (a __syncwarp at W = 1)
//    the query's first warp takes its M rows at once: the dp epilogue
//    writes them coalesced, the ds epilogue forms S by one more butterfly
//    over the warp, in a fixed order;
//  - 32-bit offsets within a query (M*D <= 16384), one 64-bit base each.
// The wrapper picks the geometry (ops/cuda/qweighted_sum_bwd.py::
// backward_geometry, chosen by a sweep on the H100: PERF.md section 6).
// The quantizer is a template argument (FastQ<Mode> for formats of at most
// 30 bits, FastQ31<Mode> for the 31-bit words, BinQ for the binary format,
// NoQ for the float instance): fmt and its Q_fo have the same word length,
// so one type serves both.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc  (qmann_tpu_torch/ops/cuda/_build.py does it).
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "qformat.cuh"

namespace {

using qmann::FastQ;
using qmann::FastQ31;
using qmann::QFmt;

constexpr int kMaxMem = 64;
constexpr int kMaxDim = 256;
constexpr int kMaxWarps = 8;   // warps a block
constexpr int kMaxGroups = 2;  // column groups of 4 a lane
constexpr unsigned kFull = 0xffffffffu;

// the float instance: no quantizer
struct NoQ {
  __device__ __forceinline__ float operator()(float x) const { return x; }
  static NoQ from(const QFmt&) { return NoQ{}; }
};

// fq for the binary format (iwl+frac == 0, whose Q_fo is binary too): the
// sign with 0 -> +1 and NaN -> -1, as fq's first line, as a select.  (AnyQ's
// runtime switch over the modes, unrolled at every requant of the row
// loop, takes nvcc minutes to compile.)
struct BinQ {
  __device__ __forceinline__ float operator()(float x) const {
    return x >= 0.f ? 1.f : -1.f;
  }
  static BinQ from(const QFmt&) { return BinQ{}; }
};

// n of the 4 columns at a exist (n <= 0: none); kVec: n is 4 or <= 0 and a
// is 16-byte aligned
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ a, int n) {
  if constexpr (kVec) {
    return *reinterpret_cast<const float4*>(a);
  } else {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n > 0) v.x = a[0];
    if (n > 1) v.y = a[1];
    if (n > 2) v.z = a[2];
    if (n > 3) v.w = a[3];
    return v;
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* __restrict__ a, float4 v,
                                       int n) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(a) = v;
  } else {
    if (n > 0) a[0] = v.x;
    if (n > 1) a[1] = v.y;
    if (n > 2) a[2] = v.z;
    if (n > 3) a[3] = v.w;
  }
}

__device__ __forceinline__ float& at(float4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// kMaxGroups column groups of 4 a lane; a query's rows split over `warps`
// warps, `queries` queries a block
template <class Q, bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
wsum_bwd_kernel(const float* __restrict__ c,      // [B, M, D]
                const float* __restrict__ p,      // [B, M]
                const float* __restrict__ mask,   // [B, M]
                const float* __restrict__ g,      // [B, D]
                const float* __restrict__ dp_in,  // [B, M] or null
                const float* __restrict__ ds_in,  // [B, M] or null
                float* __restrict__ dc,           // [B, M, D]
                float* __restrict__ out,          // [B, M]: dp or ds
                int B, int M, int D, int lanes_log2, int warps, int queries,
                int softmax, Q q, Q qo) {
  constexpr bool kFloat = std::is_same<Q, NoQ>::value;
  // a column past D reads 0 and Q(0) * 0 adds +0.0 to dp, but for the
  // binary format, whose Q(0) is 1: there only live columns are summed
  constexpr bool kGuard = std::is_same<Q, BinQ>::value;
  constexpr int kG = kMaxGroups;
  constexpr int kUnroll = 4 / kG;   // steps a pass: 4 loads of 16 bytes
  __shared__ float row_dp[kMaxWarps][kMaxMem];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qb = warp / warps, w = warp - qb * warps;
  const int b = blockIdx.x * queries + qb;
  const int lanes = 1 << lanes_log2, rows_step = 32 >> lanes_log2;
  const int sub = lane >> lanes_log2, cl = lane & (lanes - 1);
  if (b < B) {
    const size_t qrow = (size_t)b * M;
    const float* __restrict__ cq = c + qrow * D;
    float* __restrict__ dcq = dc + qrow * D;
    // this lane's column groups: d = col[k] .. col[k] + 3, n[k] of them
    int col[kG], n[kG];
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      col[k] = 4 * (cl + k * lanes);
      n[k] = D - col[k] < 4 ? D - col[k] : 4;
    }
    // the query's rows: lane j holds rows j and j + 32 (0 past M)
    const float pa = lane < M ? p[qrow + lane] : 0.f;
    const float pb = lane + 32 < M ? p[qrow + lane + 32] : 0.f;
    const float ma = lane < M ? mask[qrow + lane] : 0.f;
    const float mb = lane + 32 < M ? mask[qrow + lane + 32] : 0.f;
    // each row's factor of dc: p * mask (float) or Q(p) (quantized)
    const float fa = kFloat ? __fmul_rn(pa, ma) : q(pa);
    const float fb = kFloat ? __fmul_rn(pb, mb) : q(pb);
    float4 gq[kG];
#pragma unroll
    for (int k = 0; k < kG; ++k) {
      gq[k] = n[k] > 0 ? load4<kVec>(g + (size_t)b * D + col[k], n[k])
                       : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (!kFloat) {
#pragma unroll
        for (int j = 0; j < 4; ++j) at(gq[k], j) = q(at(gq[k], j));
      }
    }

    // one row: dc's columns of this lane, dp's sum over the row's lanes
    auto row = [&](int r, bool live, float4 (&cv)[kG]) {
      const int src = r & 31;
      const float f0 = __shfl_sync(kFull, fa, src);
      const float f1 = __shfl_sync(kFull, fb, src);
      const float m0 = __shfl_sync(kFull, ma, src);
      const float m1 = __shfl_sync(kFull, mb, src);
      const float fr = r < 32 ? f0 : f1, mr = r < 32 ? m0 : m1;
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < kG; ++k) {
        float4 o;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float gd = at(gq[k], j);
          if constexpr (kFloat) {
            at(o, j) = __fmul_rn(fr, gd);
            acc = __fmaf_rn(at(cv[k], j), gd, acc);
          } else {
            at(o, j) = __fmul_rn(qo(q(__fmul_rn(fr, gd))), mr);
            const float t = q(__fmul_rn(q(at(cv[k], j)), gd));
            if (!kGuard || n[k] > j) acc = __fadd_rn(acc, t);
          }
        }
        if (live && n[k] > 0) store4<kVec>(dcq + r * D + col[k], o, n[k]);
      }
      // every lane of the row ends with the same sum: a + b == b + a
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        if (o < lanes) acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, o));
      if (live && cl == 0)
        row_dp[qb][r] = __fmul_rn(kFloat ? acc : qo(acc), mr);
    };

    // this warp's steps: w, w + warps, ...; passes of kUnroll steps whose
    // rows all exist, then single steps, the last one maybe partial
    const int full = M >> (5 - lanes_log2);
    int s = w;
    for (; s + warps * (kUnroll - 1) < full; s += warps * kUnroll) {
      float4 cv[kUnroll][kG];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = (s + u * warps) * rows_step + sub;
#pragma unroll
        for (int k = 0; k < kG; ++k)
          cv[u][k] = n[k] > 0 ? load4<kVec>(cq + r * D + col[k], n[k])
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        row((s + u * warps) * rows_step + sub, true, cv[u]);
    }
    for (; s * rows_step < M; s += warps) {
      const int r = s * rows_step + sub;
      const bool live = r < M;
      float4 cv[kG];
#pragma unroll
      for (int k = 0; k < kG; ++k)
        cv[k] = live && n[k] > 0 ? load4<kVec>(cq + r * D + col[k], n[k])
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      row(r, live, cv);
    }
  }
  // the query's rows are in row_dp: its first warp takes them at once
  if (warps > 1) {
    __syncthreads();
  } else {
    __syncwarp();
  }
  if (b >= B || w != 0) return;
  const size_t qrow = (size_t)b * M;
  float da = lane < M ? row_dp[qb][lane] : 0.f;
  float db = lane + 32 < M ? row_dp[qb][lane + 32] : 0.f;
  if (!softmax) {
    if (lane < M) out[qrow + lane] = da;
    if (lane + 32 < M) out[qrow + lane + 32] = db;
    return;
  }
  const float pa = lane < M ? p[qrow + lane] : 0.f;
  const float pb = lane + 32 < M ? p[qrow + lane + 32] : 0.f;
  if (dp_in != nullptr) {
    if (lane < M) da = __fadd_rn(da, dp_in[qrow + lane]);
    if (lane + 32 < M) db = __fadd_rn(db, dp_in[qrow + lane + 32]);
  }
  float t = __fadd_rn(__fmul_rn(pa, da), __fmul_rn(pb, db));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    t = __fadd_rn(t, __shfl_xor_sync(kFull, t, o));
  float sa = __fmul_rn(pa, __fsub_rn(da, t));
  float sb = __fmul_rn(pb, __fsub_rn(db, t));
  if (ds_in != nullptr) {
    if (lane < M) sa = __fadd_rn(sa, ds_in[qrow + lane]);
    if (lane + 32 < M) sb = __fadd_rn(sb, ds_in[qrow + lane + 32]);
  }
  if (lane < M) out[qrow + lane] = sa;
  if (lane + 32 < M) out[qrow + lane + 32] = sb;
}

struct Launch {
  const float *c, *p, *mask, *g, *dp_in, *ds_in;
  float *dc, *out;
  int B, M, D, lanes_log2, warps, queries, softmax;
  cudaStream_t stream;
};

template <class Q, bool kVec>
int launch_geometry(const Launch& a, const Q& q, const Q& qo) {
  wsum_bwd_kernel<Q, kVec>
      <<<(a.B + a.queries - 1) / a.queries, 32 * a.warps * a.queries, 0,
         a.stream>>>(a.c, a.p, a.mask, a.g, a.dp_in, a.ds_in, a.dc, a.out,
                     a.B, a.M, a.D, a.lanes_log2, a.warps, a.queries,
                     a.softmax, q, qo);
  return (int)cudaGetLastError();
}

template <class Q>
int launch(const Launch& a, const QFmt& f, const QFmt& fo) {
  const Q q = Q::from(f), qo = Q::from(fo);
  // column groups of 4 a lane: at most kMaxGroups (a lane's group past D
  // has n <= 0, is neither loaded nor stored, and adds +0.0 to dp)
  const int per_lane = ((a.D + 3) / 4 + (1 << a.lanes_log2) - 1) >>
                       a.lanes_log2;
  const bool vec =
      a.D % 4 == 0 &&
      ((uintptr_t)a.c | (uintptr_t)a.dc | (uintptr_t)a.g) % 16 == 0;
  if (per_lane > kMaxGroups) return (int)cudaErrorInvalidValue;
  return vec ? launch_geometry<Q, true>(a, q, qo)
             : launch_geometry<Q, false>(a, q, qo);
}

template <int Mode>
int launch_mode(const Launch& a, const QFmt& f, const QFmt& fo) {
  if (f.full31) return launch<FastQ31<Mode>>(a, f, fo);
  return launch<FastQ<Mode>>(a, f, fo);
}

}  // namespace

// quantized: 1 for the quantized instance at the layer format (iwl, frac,
// mode), whose gradient-output format is derived here; 0 for the float
// instance (the format is not read).  softmax: 0 writes dp to out, 1 the
// ds epilogue's ds (dp_in and ds_in may be null; they must be null when
// softmax is 0).  The geometry (the wrapper's backward_geometry):
// 2^lanes_log2 lanes a memory row (at most 2 column groups of 4 a lane),
// `warps` warps a query and `queries` queries a block, warps * queries <= 8.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes, a
// geometry or a format out of range).
extern "C" int qmann_weighted_sum_backward(
    const float* c, const float* p, const float* mask, const float* g,
    const float* dp_in, const float* ds_in, float* dc, float* out, int B,
    int M, int D, int iwl, int frac, int mode, int quantized, int softmax,
    int lanes_log2, int warps, int queries, void* stream) {
  if (B < 1 || M < 1 || M > kMaxMem || D < 1 || D > kMaxDim ||
      lanes_log2 < 0 || lanes_log2 > 5 || warps < 1 || queries < 1 ||
      warps * queries > kMaxWarps || (softmax != 0 && softmax != 1) ||
      (!softmax && (dp_in != nullptr || ds_in != nullptr)))
    return (int)cudaErrorInvalidValue;
  const Launch a{c, p, mask, g, dp_in, ds_in, dc, out, B, M, D, lanes_log2,
                 warps, queries, softmax, (cudaStream_t)stream};
  QFmt f{}, fo{};
  if (!quantized) return launch<NoQ>(a, f, fo);
  if (!qmann::make_qfmt(iwl, frac, mode, &f)) return (int)cudaErrorInvalidValue;
  // (1, iwl+frac-1): the same word length; the binary format's is binary
  if (f.binary) {
    fo = f;
  } else if (!qmann::make_qfmt(1, iwl + frac - 1, mode, &fo)) {
    return (int)cudaErrorInvalidValue;
  }
  if (f.binary) return launch<BinQ>(a, f, fo);
  switch (mode) {
    case 0: return launch_mode<0>(a, f, fo);
    case 1: return launch_mode<1>(a, f, fo);
    case 2: return launch_mode<2>(a, f, fo);
    default: return launch_mode<3>(a, f, fo);
  }
}
