// One hop's attention read, several queries per thread block:
//   score = Q(sum_d Q(Q(m,att)*Q(u,bin), att), att)   (mode 2, quantized)
//         | sum_d m*u                                  (mode 1, float)
//         | Q(sum_d ham_term(m, u), (iwl_att, 31-iwl_att))  (mode 3, Hamming
//           on the raw m and u; the term is in hamming.cuh)
//   p     = masked softmax(score)                      (-1e30 fill)
//   o     = Q(sum_m mask*Q(Q(p,act)*Q(c,act), act), act)  (quantized sum)
//         | sum_m c*(p*mask)                           (float sum)
// m, c [B, M, D], u [B, D], mask [B, M] float (0 padded) -> o [B, D],
// p [B, M], s [B, M] (the raw scores, before the mask).
//
// Replaces the TPU kernel fused_attention_read_pallas / _fused_read_kernel
// (qmann_tpu/ops/pallas/qkernels.py), attention modes 1, 2 and 3.  On the
// training path it runs once per hop (ops/fused.py), at B=32 (a training
// step) and B=1024 (an evaluation chunk), M=10, D=60 for the flagship
// (mode 2 at iwl 5, mode 3 at iwl 1).
//
// What bounds it on an H100: at the flagship training shape one call reads
// m, c, u and the mask once and writes o, p and s once (173 KB, 0.052 us
// at 3.35 TB/s) and does 0.40 M float operations in mode 2 (0.006 us at
// 67 TFLOP/s): 0.052 us, bytes (chip_smoke.attention_read_bound; 1.65 us
// at the B=1024 eval chunk, 0.24 us at the wide layout, M=50).  At
// these sizes the time is latency: the launch, one round trip to memory
// and the dependent steps of a block (score, softmax, weighted sum).  The
// first design (one 128-thread block per query, a warp per memory row with
// the loads inside the row loop, a thread per column walking M dependent
// requants with a load of c in each, the rounding mode switched at run
// time in every requant, u re-encoded for every mode-3 pair) took 10.5-10.8
// us at B=32 in mode 2.  This design follows the chain's hop body
// (hop_chain.cu) without the lin map:
//  - fixes the rounding mode at compile time (FastQ<Mode> for fmt_att and
//    fmt_act when both are non-binary formats of at most 30 bits with one
//    mode, AnyQ otherwise; the Hamming mode is the mode of fmt_att, with
//    its 31-bit requants in FastQ31); fmt_bin, which may be binary, is
//    applied to u once per query with the runtime fq;
//  - stages the block's rows of m and of c in shared memory with cp.async
//    in two coalesced passes (16-byte copies where M*D % 4 == 0 and the
//    pointers are aligned): the score waits for m only, and c lands
//    during the score and the softmax, so no loop waits on a global load;
//  - prepares u once per query while m lands: Q(u, bin) (mode 2), or its
//    sign-magnitude word (mode 3, paired by the word form of hamming.cuh
//    where that is exact);
//  - gives each (query, row) G lanes for the score, a power of two that
//    about fills the block, summed by shuffle (block_ops.cuh);
//  - keeps the softmax as it was: one warp per query, two rows per lane,
//    M <= 64;
//  - spreads the weighted sum's (column, row group) pairs over the block's
//    threads (R row groups, each thread walking M/R rows), the partial
//    sums combined in shared memory;
//  - takes its geometry (queries per block, threads, G, R) from the
//    wrapper (ops/cuda/attention_read.py::read_geometry), with dynamic
//    shared memory opted in above 48 KB.
// Measured on one H100 80GB HBM3 at 700 W (device time,
// scripts/kernel_times.py; PERF.md, section 6), first design -> this one:
// mode 2 10.5-10.8 -> 3.9 us at B=32, 12.0 -> 6.0-6.1 us at B=1024 and
// 38.5-38.8 -> 5.1 us on the wide layout (M=50); mode 3 (iwl 1) 9.4-9.5 ->
// 4.3, 12.7 -> 7.1 and 36.7-37.0 -> 6.0 us; mode 1 4.5 -> 3.5-3.6 and
// 13.2 -> 4.6 us, but 5.2 -> 5.4 us at B=1024, where the float read was
// already at the launch and memory floor and the staging adds a step.
//
// Numerics: the lattice sums are exact in float32, so the score's and the
// weighted sum's partial sums may combine in any order.  The softmax is
// order-sensitive: it uses expf and IEEE division (build without
// --use_fast_math), the -1e30 masked fill and total==0 -> 1, so a query
// with no live row (a padded sample of the last partial batch) gets p = 0
// and o = Q(0), never NaN.  Padded rows are skipped after the per-product
// requant (the binary format maps 0 to +1).  The float (mode 1) sums are
// order-sensitive; they differ from the plain version's by float32
// rounding only.  The mode-3 terms sum exactly as in hamming.cu
// (num_bit <= 19, D <= 64).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc  (qmann_tpu_torch/ops/cuda/_build.py does it).
#include <cstdint>

#include <cuda_runtime.h>

#include "block_ops.cuh"
#include "hamming.cuh"
#include "qformat.cuh"

namespace {

using qmann::AnyQ;
using qmann::FastQ;
using qmann::FastQ31;
using qmann::HamFmt;
using qmann::QFmt;
using qmann::fq;
using qmann::warp_max;
using qmann::warp_sum;

constexpr int kMaxMem = 64;     // the softmax keeps two rows per lane
constexpr int kMaxDim = 256;
constexpr int kMaxThreads = 512;
constexpr int kSmemLimit = 232448;  // 227 KB; no static shared memory

// how a row's score is computed
enum ScoreKind { kFloatDot = 1, kLattice = 2, kHamming = 3 };

// Floats of dynamic shared memory for qpb queries per block and `threads`
// threads; the same formula as ops/cuda/attention_read.py::read_smem_bytes.
size_t smem_floats(int qpb, int M, int D, int threads) {
  return (size_t)2 * qpb * M * D   // the rows of m and of c
         + (size_t)qpb * D         // u prepared
         + (size_t)3 * qpb * M     // scores, the weights Q(p, act), live
         + threads;                // the weighted sum's partial sums
}

template <class Q, int HamMode>
__global__ void __launch_bounds__(kMaxThreads)
attention_read_kernel(const float* __restrict__ m,      // [B, M, D]
                      const float* __restrict__ c,      // [B, M, D]
                      const float* __restrict__ u,      // [B, D]
                      const float* __restrict__ mask,   // [B, M] 0 padded
                      float* __restrict__ o_out,        // [B, D]
                      float* __restrict__ p_out,        // [B, M]
                      float* __restrict__ s_out,        // [B, M]
                      int B, int M, int D, int qpb, int G, int R, int vec16,
                      QFmt fatt_, QFmt fbin, QFmt fact_, int score_kind,
                      int sum_quantized, HamFmt ham) {
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * qpb;
  const int nq = min(qpb, B - b0);
  const int rows = nq * M;
  float* ms = smem;                                  // [qpb][M][D]
  float* cs = ms + (size_t)qpb * M * D;              // [qpb][M][D]
  float* us = cs + (size_t)qpb * M * D;              // [qpb][D]
  uint32_t* uw = reinterpret_cast<uint32_t*>(us);    // mode 3: u's words
  float* s = us + qpb * D;                           // [qpb][M]
  float* pw = s + qpb * M;                           // [qpb][M]
  float* live = pw + qpb * M;                        // [qpb][M]
  float* part = live + qpb * M;                      // [R][nq*D], R > 1

  // m and c in two commit groups: the score waits for the first only
  const size_t off = (size_t)b0 * M * D;
  qmann::stage_flat(ms, m + off, rows * D, vec16);
  qmann::stage_flat(cs, c + off, rows * D, vec16);
  for (int t = tid; t < nq * D; t += T) {
    const float v = u[(size_t)b0 * D + t];
    if (score_kind == kHamming) uw[t] = qmann::ham_encode<HamMode>(v, ham);
    else us[t] = score_kind == kLattice ? fq(v, fbin) : v;
  }
  for (int t = tid; t < rows; t += T)
    live[t] = mask[(size_t)b0 * M + t] != 0.f ? 1.f : 0.f;
  qmann::cp_async_wait<1>();
  __syncthreads();

  // score: G lanes per (query, memory row)
  const Q fa = Q::from(fatt_), fc = Q::from(fact_);
  float* s_blk = s_out + (size_t)b0 * M;
  if (score_kind == kHamming) {
    const FastQ31<HamMode> full = FastQ31<HamMode>::from(ham.full);
    const auto fin = [&](float acc) { return full(acc); };
    if (ham.word)
      qmann::score_rows(ms, rows, M, D, G, s, s_blk,
                        [&](float x, int q, int d) {
                          return qmann::ham_pair<HamMode, true>(
                              qmann::ham_encode<HamMode>(x, ham),
                              uw[q * D + d], ham);
                        },
                        fin);
    else
      qmann::score_rows(ms, rows, M, D, G, s, s_blk,
                        [&](float x, int q, int d) {
                          return qmann::ham_pair<HamMode, false>(
                              qmann::ham_encode<HamMode>(x, ham),
                              uw[q * D + d], ham);
                        },
                        fin);
  } else if (score_kind == kLattice) {
    qmann::score_rows(
        ms, rows, M, D, G, s, s_blk,
        [&](float x, int q, int d) { return fa(fa(x) * us[q * D + d]); },
        [&](float acc) { return fa(acc); });
  } else {
    qmann::score_rows(
        ms, rows, M, D, G, s, s_blk,
        [&](float x, int q, int d) { return x * us[q * D + d]; },
        [](float acc) { return acc; });
  }
  __syncthreads();

  // masked softmax: one warp per query, rows lane and lane+32; pw holds
  // the weight of each row in the sum (Q(p, act) when quantized)
  for (int q = warp; q < nq; q += T >> 5) {
    const int r0 = lane, r1 = lane + 32;
    const float* sq = s + q * M;
    const float* lq = live + q * M;
    const bool l0 = r0 < M && lq[r0] != 0.f, l1 = r1 < M && lq[r1] != 0.f;
    const float x0 = l0 ? sq[r0] : -1e30f;
    const float x1 = l1 ? sq[r1] : -1e30f;
    const float mx = warp_max(fmaxf(x0, x1));
    const float e0 = l0 ? expf(x0 - mx) : 0.f;
    const float e1 = l1 ? expf(x1 - mx) : 0.f;
    float total = warp_sum(e0 + e1);
    if (total == 0.f) total = 1.f;
    float* pq = p_out + (size_t)(b0 + q) * M;
    if (r0 < M) {
      const float p = e0 / total;
      pq[r0] = p;
      pw[q * M + r0] = sum_quantized ? fc(p) : p;
    }
    if (r1 < M) {
      const float p = e1 / total;
      pq[r1] = p;
      pw[q * M + r1] = sum_quantized ? fc(p) : p;
    }
  }
  qmann::cp_async_wait<0>();
  __syncthreads();

  // weighted sum: thread (rg, col) walks rows rg, rg+R, ... of column col;
  // padded rows skipped
  const int ncol = nq * D;
  float* o_blk = o_out + (size_t)b0 * D;
  for (int t = tid; t < ncol * R; t += T) {
    const int rg = t / ncol, col = t - rg * ncol;
    const int q = col / D;
    const float* cq = cs + (size_t)q * M * D + (col - q * D);
    const float* lq = live + q * M;
    const float* wq = pw + q * M;
    float acc = 0.f;
    if (sum_quantized) {
      for (int r = rg; r < M; r += R)
        acc += lq[r] != 0.f ? fc(wq[r] * fc(cq[(size_t)r * D])) : 0.f;
    } else {
      for (int r = rg; r < M; r += R)
        acc += lq[r] != 0.f ? cq[(size_t)r * D] * wq[r] : 0.f;
    }
    if (R == 1) o_blk[col] = sum_quantized ? fc(acc) : acc;
    else part[t] = acc;
  }
  if (R > 1) {
    __syncthreads();
    for (int col = tid; col < ncol; col += T) {
      float acc = part[col];
      for (int rg = 1; rg < R; ++rg) acc += part[rg * ncol + col];
      o_blk[col] = sum_quantized ? fc(acc) : acc;
    }
  }
}

template <class Q, int HamMode>
int launch(const float* m, const float* c, const float* u, const float* mask,
           float* o_out, float* p_out, float* s_out, int B, int M, int D,
           int qpb, int threads, int G, int R, const QFmt& fatt,
           const QFmt& fbin, const QFmt& fact, int score_kind,
           int sum_quantized, const HamFmt& ham, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(qpb, M, D, threads);
  // raised once per instance and device (the attribute is per device)
  static bool opted_in[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (bytes > 48 * 1024 && !(dev < 64 && opted_in[dev])) {
    const cudaError_t rc = cudaFuncSetAttribute(
        attention_read_kernel<Q, HamMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (rc != cudaSuccess) return (int)rc;
    if (dev < 64) opted_in[dev] = true;
  }
  const int vec16 = (M * D) % 4 == 0 && ((uintptr_t)m & 15u) == 0 &&
                    ((uintptr_t)c & 15u) == 0;
  attention_read_kernel<Q, HamMode>
      <<<(B + qpb - 1) / qpb, threads, bytes, stream>>>(
          m, c, u, mask, o_out, p_out, s_out, B, M, D, qpb, G, R, vec16,
          fatt, fbin, fact, score_kind, sum_quantized, ham);
  return (int)cudaGetLastError();
}

}  // namespace

// fmts: host array of the (iwl, frac, mode) triples of fmt_att, fmt_bin
// and fmt_act.  ham: num_bit, const_scale, weight_para and weighted of the
// mode-3 score, which takes its iwl and rounding mode from fmt_att.
// geometry: host array of the queries per block, threads, lanes per row
// (G) and row groups (R) from the wrapper's read_geometry.  The launch
// runs FastQ<mode> when fmt_att and fmt_act are non-binary formats of at
// most 30 bits with one mode, else AnyQ; the Hamming instance takes
// fmt_att's mode.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for shapes, geometry, formats or knobs out of
// range).
extern "C" int qmann_attention_read(const float* m, const float* c,
                                    const float* u, const float* mask,
                                    float* o_out, float* p_out, float* s_out,
                                    int B, int M, int D, const int* fmts,
                                    int score_quantized, int sum_quantized,
                                    int attention_mode, const int* ham_knobs,
                                    const int* geometry, void* stream) {
  const int qpb = geometry[0], threads = geometry[1], G = geometry[2],
            R = geometry[3];
  if (B < 1 || M < 1 || M > kMaxMem || D < 1 || D > kMaxDim || qpb < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || G < 1 ||
      G > 32 || (G & (G - 1)) != 0 || R < 1 || R > M ||
      (R > 1 && R * qpb * D > threads) ||
      sizeof(float) * smem_floats(qpb, M, D, threads) > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
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
  const bool fast = qmann::fastq_exact(fatt) && qmann::fastq_exact(fact) &&
                    fatt.mode == fact.mode;
  const auto st = (cudaStream_t)stream;
#define QMANN_READ_LAUNCH(QT, HM)                                           \
  launch<QT, HM>(m, c, u, mask, o_out, p_out, s_out, B, M, D, qpb, threads, \
                 G, R, fatt, fbin, fact, score_kind, sum_quantized, ham, st)
  switch (fatt.mode) {
    case 0:
      return fast ? QMANN_READ_LAUNCH(FastQ<0>, 0)
                  : QMANN_READ_LAUNCH(AnyQ, 0);
    case 1:
      return fast ? QMANN_READ_LAUNCH(FastQ<1>, 1)
                  : QMANN_READ_LAUNCH(AnyQ, 1);
    case 2:
      return fast ? QMANN_READ_LAUNCH(FastQ<2>, 2)
                  : QMANN_READ_LAUNCH(AnyQ, 2);
    default:
      return fast ? QMANN_READ_LAUNCH(FastQ<3>, 3)
                  : QMANN_READ_LAUNCH(AnyQ, 3);
  }
#undef QMANN_READ_LAUNCH
}
