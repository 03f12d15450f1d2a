// One hop's attention read for one query per thread block:
//   score = Q(sum_d Q(Q(m,att)*Q(u,bin), att), att)   (mode 2, quantized)
//         | sum_d m*u                                  (mode 1, float)
//         | Q(sum_d ham_term(m, u), (iwl_att, 31-iwl_att))  (mode 3, Hamming
//           on the raw m and u; ham_term is in hamming.cuh)
//   p     = masked softmax(score)                      (-1e30 fill)
//   o     = Q(sum_m mask*Q(Q(p,act)*Q(c,act), act), act)  (quantized sum)
//         | sum_m c*(p*mask)                           (float sum)
// m, c [B, M, D], u [B, D], mask [B, M] float (0 padded) -> o [B, D],
// p [B, M], s [B, M] (the raw scores, before the mask).
//
// Replaces the TPU kernel fused_attention_read_pallas / _fused_read_kernel
// (qmann_tpu/ops/pallas/qkernels.py), attention modes 1, 2 and 3.  On the
// training path it runs once per hop (ops/fused.py), at B=32, M=10, D=60
// for the flagship (mode 2 at iwl 5, mode 3 at iwl 1).
//
// What bounds it on an H100: one call reads m and c once (2*32*10*60*4 B =
// 154 KB at the flagship training shape, ~0.05 us at 3.35 TB/s) and does
// ~0.4 M operations; like the chain kernel it is latency-bound: each block
// walks dependent steps (a warp reduction per row, the softmax, the
// weighted sum) with barriers between them.  The design follows
// hop_chain.cu: one block per query, warps over memory rows for the
// score (lanes along D, coalesced), one warp for the softmax (two rows per
// lane, M <= 64), threads over D for the weighted sum (each thread walks
// one column of c; the threads of a warp read neighbouring addresses).
// Only the scores, the probabilities and the live flags are staged in
// shared memory; every element of m and c is read once.
//
// Numerics: the lattice sums are exact in float32, so the warp reductions
// may sum in any order.  The softmax is order-sensitive: it uses expf and
// IEEE division (build without --use_fast_math), the -1e30 masked fill and
// total==0 -> 1, so a query with no live row (a padded sample of the last
// partial batch) gets p = 0 and o = Q(0), never NaN.  Padded rows are
// skipped after the per-product requant (the binary format maps 0 to +1).
// The float (mode 1) sums are order-sensitive; they differ from the plain
// version's by float32 rounding only.  The mode-3 terms sum exactly as in
// hamming.cu (num_bit <= 19, D <= 64).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc  (qmann_tpu_torch/ops/cuda/_build.py does it).
#include <cuda_runtime.h>

#include "hamming.cuh"
#include "qformat.cuh"

namespace {

using qmann::HamFmt;
using qmann::QFmt;
using qmann::fq;
using qmann::ham_term;
using qmann::warp_max;
using qmann::warp_sum;

constexpr int kMaxMem = 64;    // the softmax keeps two rows per lane
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// how a row's score is computed
enum ScoreKind { kFloatDot = 1, kLattice = 2, kHamming = 3 };

__global__ void __launch_bounds__(kThreads)
attention_read_kernel(const float* __restrict__ m,      // [B, M, D]
                      const float* __restrict__ c,      // [B, M, D]
                      const float* __restrict__ u,      // [B, D]
                      const float* __restrict__ mask,   // [B, M] 0 padded
                      float* __restrict__ o_out,        // [B, D]
                      float* __restrict__ p_out,        // [B, M]
                      float* __restrict__ s_out,        // [B, M]
                      int M, int D, QFmt fatt, QFmt fbin, QFmt fact,
                      int score_kind, int sum_quantized, HamFmt ham) {
  __shared__ float s[kMaxMem], pw[kMaxMem];
  __shared__ int live[kMaxMem];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* mb = m + (size_t)b * M * D;
  const float* cb = c + (size_t)b * M * D;
  const float* ub = u + (size_t)b * D;

  for (int r = tid; r < M; r += kThreads) live[r] = mask[(size_t)b * M + r] != 0.f;

  // score: one warp per memory row, lanes along D
  for (int r = warp; r < M; r += kWarps) {
    const float* mrow = mb + (size_t)r * D;
    float acc = 0.f;
    if (score_kind == kHamming) {
      for (int d = lane; d < D; d += 32) acc += ham_term(mrow[d], ub[d], ham);
    } else if (score_kind == kLattice) {
      for (int d = lane; d < D; d += 32)
        acc += fq(fq(mrow[d], fatt) * fq(ub[d], fbin), fatt);
    } else {
      for (int d = lane; d < D; d += 32) acc += mrow[d] * ub[d];
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      const float sc = score_kind == kHamming  ? fq(acc, ham.full)
                       : score_kind == kLattice ? fq(acc, fatt)
                                                : acc;
      s[r] = sc;
      s_out[(size_t)b * M + r] = sc;
    }
  }
  __syncthreads();

  // masked softmax: warp 0, rows lane and lane+32; pw holds the weight of
  // each row in the sum (Q(p, act) when quantized)
  if (warp == 0) {
    const int r0 = lane, r1 = lane + 32;
    const bool l0 = r0 < M && live[r0], l1 = r1 < M && live[r1];
    const float x0 = l0 ? s[r0] : -1e30f;
    const float x1 = l1 ? s[r1] : -1e30f;
    const float mx = warp_max(fmaxf(x0, x1));
    const float e0 = l0 ? expf(x0 - mx) : 0.f;
    const float e1 = l1 ? expf(x1 - mx) : 0.f;
    float total = warp_sum(e0 + e1);
    if (total == 0.f) total = 1.f;
    if (r0 < M) {
      const float p = e0 / total;
      p_out[(size_t)b * M + r0] = p;
      pw[r0] = sum_quantized ? fq(p, fact) : p;
    }
    if (r1 < M) {
      const float p = e1 / total;
      p_out[(size_t)b * M + r1] = p;
      pw[r1] = sum_quantized ? fq(p, fact) : p;
    }
  }
  __syncthreads();

  // weighted sum: one thread per column of c, padded rows skipped
  for (int d = tid; d < D; d += kThreads) {
    const float* ccol = cb + d;
    float acc = 0.f;
    if (sum_quantized) {
      for (int r = 0; r < M; ++r)
        if (live[r]) acc += fq(pw[r] * fq(ccol[(size_t)r * D], fact), fact);
      acc = fq(acc, fact);
    } else {
      for (int r = 0; r < M; ++r)
        if (live[r]) acc += ccol[(size_t)r * D] * pw[r];
    }
    o_out[(size_t)b * D + d] = acc;
  }
}

}  // namespace

// fmts: host array of the (iwl, frac, mode) triples of fmt_att, fmt_bin
// and fmt_act.  ham: num_bit, const_scale, weight_para and weighted of the
// mode-3 score, which takes its iwl and rounding mode from fmt_att.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// shapes, formats or knobs out of range).
extern "C" int qmann_attention_read(const float* m, const float* c,
                                    const float* u, const float* mask,
                                    float* o_out, float* p_out, float* s_out,
                                    int B, int M, int D, const int* fmts,
                                    int score_quantized, int sum_quantized,
                                    int attention_mode, const int* ham_knobs,
                                    void* stream) {
  if (B < 1 || M < 1 || M > kMaxMem || D < 1) return (int)cudaErrorInvalidValue;
  QFmt fatt, fbin, fact;
  if (!qmann::make_qfmt(fmts[0], fmts[1], fmts[2], &fatt) ||
      !qmann::make_qfmt(fmts[3], fmts[4], fmts[5], &fbin) ||
      !qmann::make_qfmt(fmts[6], fmts[7], fmts[8], &fact))
    return (int)cudaErrorInvalidValue;
  HamFmt ham = {};
  int score_kind = score_quantized ? kLattice : kFloatDot;
  if (attention_mode == 3) {
    if (!qmann::make_hamfmt(fmts[0], fmts[2], ham_knobs[0], ham_knobs[1],
                            ham_knobs[2], ham_knobs[3], &ham))
      return (int)cudaErrorInvalidValue;
    score_kind = kHamming;
  }
  attention_read_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      m, c, u, mask, o_out, p_out, s_out, M, D, fatt, fbin, fact,
      score_kind, sum_quantized, ham);
  return (int)cudaGetLastError();
}
