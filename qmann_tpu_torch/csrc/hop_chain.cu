// The whole K-hop MemN2N controller chain, several queries per thread
// block.
//
// Replaces the TPU kernel fused_hop_chain_pallas / _fused_chain_kernel
// (qmann_tpu/ops/pallas/qkernels.py), attention modes 2 and 3.  Per hop h:
//   m, c   = Q(slice of flat, fmt_w[h])                 (A and C embeddings)
//   score  = Q(sum_d Q(Q(m,att)*Q(u,bin), att), att)   (mode 2)
//          | Q(sum_d ham_term(m, u), (iwl_att, 31-iwl_att))  (mode 3: the
//            Hamming similarity of the requanted m and the raw current u,
//            ham_term in hamming.cuh)
//   p      = masked softmax(score)                      (-1e30 fill)
//   o      = Q(sum_m mask*Q(Q(p,act)*Q(c,act), act), act)
//   u_map  = Q(sum_i Q(Q(H,w)*Q(u,bin), w), w)          (when linear mapping)
//   u      = Q(Q(u_map,act)+Q(o,act), act), then Q(relu(u), act) if enabled
//
// What bounds it on an H100: at the flagship shape (B=1000, M=10, K=3,
// D=60) the chain reads flat once, 1000*10*360*4 B = 14.4 MB per batch
// (~4.5 us at 3.35 TB/s), and does ~6000 requantized products per query
// and hop (~0.15 G float operations a batch, ~2 us at 67 TFLOP/s).  The
// steps of a hop depend on each other, so what the first design (one
// 128-thread block per query) lost was per-block latency: a global
// load inside each row loop, Q(H) recomputed for every product of every
// query, the rounding mode switched at run time in every requant, and a
// shuffle reduction per lin-map row.  This design:
//  - fixes the rounding mode at compile time and saturates without a
//    branch (FastQ<Mode>, qformat.cuh; the C entry picks one of four
//    instances by the launch's one mode, and the runtime AnyQ instance
//    only for binary or 31-bit formats; the mode-3 term takes the same
//    mode, hamming.cuh).  This step alone halved the
//    first design's time and more: its runtime switch and saturation select
//    compiled to branches and convergence barriers around every requant;
//  - stages each hop's A and C slices of the block's queries in shared
//    memory with cp.async, double-buffered: hop h+1's slices are in flight
//    while hop h computes.  They are requantized once as they land
//    (Q(Q(m,w),att) in mode 2, Q(m,w) in mode 3, Q(Q(c,w),act)), so the
//    score, softmax, weighted sum and residual touch only shared memory
//    and registers;
//  - stages H[h] with cp.async too (into a row stride of D+1), issued as
//    soon as hop h-1's lin map is done with the buffer, shared by the
//    block's queries.  The serving path hands it over quantized once
//    (prepare_inference caches Q(H)); raw H is quantized in place once per
//    block and hop (10% slower at the flagship shape);
//  - gives each (query, lin-map output row) one thread that walks its row
//    of Q(H) (neighbouring threads, rows an odd stride apart: no bank
//    conflicts) with four partial sums, no reduction;
//  - keeps every loop free of a load whose latency the next iteration
//    waits on: no global load sits inside a loop;
//  - takes its geometry (queries per block, threads) from the wrapper
//    (ops/cuda/hop_chain.py::chain_geometry), with dynamic shared memory
//    opted in above 48 KB.
// Measured on one H100 80GB HBM3 at 700 W (device time, B=1000, flagship;
// PERF.md, section 6): 0.028 ms in mode 2 and 0.032 ms in mode 3 on the
// cached Q(H), from 0.108 and 0.118 ms for the first design (mode 3 took
// 0.045 ms before its Hamming term got the compile-time rounding mode and
// the word form of hamming.cuh).
//
// Numerics: every lattice sum is exact in float32 (quantized products lie
// on the 2^-frac grid, partial sums stay under 2^24 units), so the sums
// may run in any order.  The softmax is order-sensitive: it uses expf and
// IEEE division (build without --use_fast_math), the -1e30 masked fill,
// and total==0 -> 1 for fully masked rows.  The mode-3 terms sum exactly
// as in hamming.cu (num_bit <= 19, D <= 64).
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
using qmann::cp_async16;
using qmann::cp_async4;
using qmann::cp_async_commit;
using qmann::cp_async_wait_all;
using qmann::ham_term;
using qmann::warp_max;
using qmann::warp_sum;

constexpr int kMaxHops = 8;
constexpr int kMaxMem = 64;     // the softmax keeps two rows per lane
constexpr int kMaxDim = 128;
constexpr int kMaxThreads = 512;
constexpr int kSlots = 3 * kMaxHops + 1;  // w[K], att[K], act[K], bin
// dynamic shared memory a block may take: 227 KB less the static formats
constexpr int kSmemLimit = 232448 - 1024;

struct ChainFormats {
  QFmt f[kSlots];
  HamFmt ham[kMaxHops];  // mode 3: each hop's Hamming format
};

// Floats of dynamic shared memory for qpb queries per block; the same
// formula as ops/cuda/hop_chain.py::chain_smem_bytes.
size_t smem_floats(int qpb, int M, int D) {
  return (size_t)4 * qpb * M * D       // two stages of [qpb, M, 2D]
         + (size_t)D * (D + 1)         // Q(H[h]), row stride D+1
         + (size_t)3 * qpb * D         // u, Q(u, bin), u_map
         + (size_t)3 * qpb * M;        // scores, Q(p, act), live
}

// Issue the copies of hop h's A and C slices of the block's nq queries
// into stage [nq*M rows][2D]: A at columns [0, D), C at [D, 2D).
__device__ __forceinline__ void stage_hop(float* stage, const float* fb,
                                          int rows, int D, int K, int h,
                                          bool vec16) {
  const size_t row = (size_t)2 * K * D;
  if (vec16) {
    const int n4 = D >> 2;
    for (int e = threadIdx.x; e < rows * 2 * n4; e += blockDim.x) {
      const int seg = e / n4, k = (e - seg * n4) << 2;
      const int r = seg >> 1, part = seg & 1;
      cp_async16(stage + (size_t)r * 2 * D + part * D + k,
                 fb + r * row + (size_t)(part ? K + h : h) * D + k);
    }
  } else {
    for (int e = threadIdx.x; e < rows * 2 * D; e += blockDim.x) {
      const int seg = e / D, k = e - seg * D;
      const int r = seg >> 1, part = seg & 1;
      cp_async4(stage + (size_t)r * 2 * D + part * D + k,
                fb + r * row + (size_t)(part ? K + h : h) * D + k);
    }
  }
  cp_async_commit();
}

// Issue the copies of H[h] into hq [D][D+1] (with an odd row stride the
// lin map's threads, walking neighbouring rows in step, hit no bank twice).
__device__ __forceinline__ void stage_h(float* hq, const float* hmats, int D,
                                        int h) {
  const float* hm = hmats + (size_t)h * D * D;
  int i = threadIdx.x / D, j = threadIdx.x % D;
  const int di = blockDim.x / D, dj = blockDim.x % D;
  for (int e = threadIdx.x; e < D * D; e += blockDim.x) {
    cp_async4(hq + i * (D + 1) + j, hm + e);
    i += di;
    j += dj;
    if (j >= D) {
      j -= D;
      ++i;
    }
  }
  cp_async_commit();
}

template <class Q, int HamMode>
__global__ void __launch_bounds__(kMaxThreads)
hop_chain_kernel(const float* __restrict__ flat,    // [B, M, 2K*D] raw GEMM
                 const float* __restrict__ u_in,    // [B, D] Q(., fmt_w[0])
                 const float* __restrict__ hmats,   // [K, D, D] raw, or
                                                    // Q(H) if h_quantized
                 const int* __restrict__ mask,      // [B, M] 0 padded
                 float* __restrict__ u_out,         // [B, D]
                 float* __restrict__ p_out,         // [K, B, M]
                 float* __restrict__ s_out,         // [K, B, M]
                 int B, int M, int D, int K, int qpb, int linear_mapping,
                 int h_quantized, int non_linearity, int hamming, int vec16,
                 ChainFormats formats) {
  __shared__ QFmt fmt[kSlots];
  __shared__ HamFmt ham[kMaxHops];
  extern __shared__ __align__(16) float smem[];
  float* stages = smem;                              // [2][qpb*M][2D]
  float* hq = stages + (size_t)4 * qpb * M * D;       // [D][D+1] Q(H[h])
  float* u = hq + (size_t)D * (D + 1);                 // [qpb][D]
  float* ubin = u + qpb * D;                           // [qpb][D]
  float* umap = ubin + qpb * D;                        // [qpb][D]
  float* s = umap + qpb * D;                           // [qpb][M]
  float* pq = s + qpb * M;                             // [qpb][M]
  float* live = pq + qpb * M;                          // [qpb][M]

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b0 = blockIdx.x * qpb;
  const int nq = min(qpb, B - b0);
  const int rows = nq * M;
  const int D2 = 2 * D;
  const float* fb = flat + (size_t)b0 * M * 2 * K * D;
  // lanes per score row: a power of two that about fills the block
  int G = 1;
  while (G < 32 && 2 * G * qpb * M <= T) G <<= 1;

  stage_hop(stages, fb, rows, D, K, 0, vec16);
  if (linear_mapping) stage_h(hq, hmats, D, 0);
  for (int i = tid; i < 3 * K + 1; i += T) fmt[i] = formats.f[i];
  for (int i = tid; i < K; i += T) ham[i] = formats.ham[i];
  __syncthreads();
  const Q fbin = Q::from(fmt[3 * K]);
  for (int t = tid; t < nq * D; t += T) {
    const float v = u_in[(size_t)b0 * D + t];
    u[t] = v;
    ubin[t] = fbin(v);
  }
  for (int t = tid; t < rows; t += T)
    live[t] = mask[(size_t)b0 * M + t] != 0 ? 1.f : 0.f;

  for (int h = 0; h < K; ++h) {
    const Q fw = Q::from(fmt[h]);
    const Q fa = Q::from(fmt[K + h]);
    const Q fc = Q::from(fmt[2 * K + h]);
    float* st = stages + (size_t)(h & 1) * 2 * qpb * M * D;
    const size_t out_off = ((size_t)h * B + b0) * M;

    // hop h's slices and H[h] have landed; hop h-1 is done with the other
    // stage
    cp_async_wait_all();
    __syncthreads();
    if (h + 1 < K)
      stage_hop(stages + (size_t)((h + 1) & 1) * 2 * qpb * M * D, fb, rows,
                D, K, h + 1, vec16);

    // requantize the slices and H[h] in place
    {
      int col = tid % D2;
      const int step = T % D2;
#pragma unroll 4
      for (int e = tid; e < rows * D2; e += T) {
        const float x = fw(st[e]);
        st[e] = col < D ? (hamming ? x : fa(x)) : fc(x);
        col += step;
        if (col >= D2) col -= D2;
      }
    }
    if (linear_mapping && !h_quantized) {
      int i = tid / D, j = tid % D;
      const int di = T / D, dj = T % D;
#pragma unroll 4
      for (int e = tid; e < D * D; e += T) {
        float* v = hq + i * (D + 1) + j;
        *v = fw(*v);
        i += di;
        j += dj;
        if (j >= D) {
          j -= D;
          ++i;
        }
      }
    }
    __syncthreads();

    // score: G lanes per (query, memory row), a shuffle sum over the G
    // lanes (every lane of the block takes each round, so the shuffles
    // see full warps)
    {
      const HamFmt hf = ham[h];
      for (int base = 0; base < rows * G; base += T) {
        const int t = base + tid;
        const int task = t / G, g = t & (G - 1);
        const bool on = task < rows;
        const int q = on ? task / M : 0;
        const float* mrow = st + (size_t)(on ? task : 0) * D2;
        float acc = 0.f;
        if (on) {
          if (hamming && hf.word) {
#pragma unroll 2
            for (int d = g; d < D; d += G)
              acc += ham_term<HamMode, true>(mrow[d], u[q * D + d], hf);
          } else if (hamming) {
            for (int d = g; d < D; d += G)
              acc += ham_term<HamMode, false>(mrow[d], u[q * D + d], hf);
          } else {
#pragma unroll 4
            for (int d = g; d < D; d += G) acc += fa(mrow[d] * ubin[q * D + d]);
          }
        }
        for (int o = G >> 1; o > 0; o >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (on && g == 0) {
          const float sc =
              hamming ? FastQ31<HamMode>::from(hf.full)(acc) : fa(acc);
          s[task] = sc;
          s_out[out_off + task] = sc;
        }
      }
    }
    // lin map: one thread per (query, output row) walks its row of Q(H)
    // (neighbouring threads: neighbouring rows, an odd stride apart)
    if (linear_mapping) {
      for (int t = tid; t < nq * D; t += T) {
        const int q = t / D, i = t - q * D;
        const float* ub = ubin + q * D;
        const float* hr = hq + i * (D + 1);
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int j = 0;
        for (; j + 3 < D; j += 4) {
          a0 += fw(hr[j] * ub[j]);
          a1 += fw(hr[j + 1] * ub[j + 1]);
          a2 += fw(hr[j + 2] * ub[j + 2]);
          a3 += fw(hr[j + 3] * ub[j + 3]);
        }
        for (; j < D; ++j) a0 += fw(hr[j] * ub[j]);
        umap[t] = fw((a0 + a1) + (a2 + a3));
      }
    }
    __syncthreads();
    // Q(H[h]) is spent: H[h+1] lands during the softmax and weighted sum
    if (linear_mapping && h + 1 < K) stage_h(hq, hmats, D, h + 1);

    // masked softmax: one warp per query, rows lane and lane+32
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
      if (r0 < M) {
        const float p = e0 / total;
        p_out[out_off + q * M + r0] = p;
        pq[q * M + r0] = fc(p);
      }
      if (r1 < M) {
        const float p = e1 / total;
        p_out[out_off + q * M + r1] = p;
        pq[q * M + r1] = fc(p);
      }
    }
    __syncthreads();

    // weighted sum and residual (+ ReLU requant): one thread per
    // (query, column)
    for (int t = tid; t < nq * D; t += T) {
      const int q = t / D, d = t - q * D;
      const float* cq = st + (size_t)q * M * D2 + D + d;
      const float* lq = live + q * M;
      const float* pr = pq + q * M;
      float a0 = 0.f, a1 = 0.f;
      int r = 0;
      for (; r + 1 < M; r += 2) {
        if (lq[r] != 0.f) a0 += fc(pr[r] * cq[(size_t)r * D2]);
        if (lq[r + 1] != 0.f) a1 += fc(pr[r + 1] * cq[(size_t)(r + 1) * D2]);
      }
      if (r < M && lq[r] != 0.f) a0 += fc(pr[r] * cq[(size_t)r * D2]);
      const float o = fc(a0 + a1);
      const float um = linear_mapping ? umap[t] : u[t];
      float un = fc(fc(um) + fc(o));
      if (non_linearity) un = fc(fmaxf(un, 0.f));
      u[t] = un;
      ubin[t] = fbin(un);
    }
  }
  __syncthreads();
  for (int t = tid; t < nq * D; t += T) u_out[(size_t)b0 * D + t] = u[t];
}

template <class Q, int HamMode>
int launch(const float* flat, const float* u, const float* hmats,
           const int* mask, float* u_out, float* p_out, float* s_out, int B,
           int M, int D, int K, int qpb, int threads, int linear_mapping,
           int h_quantized, int non_linearity, int hamming,
           const ChainFormats& formats, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(qpb, M, D);
  // raised once per instance and device (the attribute is per device)
  static bool opted_in[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (bytes > 48 * 1024 && !(dev < 64 && opted_in[dev])) {
    const cudaError_t rc = cudaFuncSetAttribute(
        hop_chain_kernel<Q, HamMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (rc != cudaSuccess) return (int)rc;
    if (dev < 64) opted_in[dev] = true;
  }
  const int vec16 = D % 4 == 0 && ((uintptr_t)flat & 15u) == 0;
  const int blocks = (B + qpb - 1) / qpb;
  hop_chain_kernel<Q, HamMode><<<blocks, threads, bytes, stream>>>(
      flat, u, hmats, mask, u_out, p_out, s_out, B, M, D, K, qpb,
      linear_mapping, h_quantized, non_linearity, hamming, vec16, formats);
  return (int)cudaGetLastError();
}

}  // namespace

// fmts: host array of (iwl, frac, mode) triples for the 3K+1 slots
// w[0..K), att[0..K), act[0..K), bin.  attention_mode 2 or 3; ham_knobs:
// num_bit, const_scale, weight_para and weighted of the mode-3 score,
// which takes each hop's iwl and rounding mode from its att slot.
// hmats_quantized: hmats holds Q(H[h], w[h]) already (prepare_inference
// caches it where float_quant is idempotent), so the requant is skipped.  qpb
// (queries per block) and threads come from the wrapper's geometry.  The
// launch runs FastQ<mode> when every slot is a non-binary format of at
// most 30 bits and all share one rounding mode, else AnyQ.  Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for shapes,
// geometry, formats, modes or knobs out of range).
extern "C" int qmann_hop_chain(const float* flat, const float* u,
                               const float* hmats, const int* mask,
                               float* u_out, float* p_out, float* s_out,
                               int B, int M, int D, int K, const int* fmts,
                               int linear_mapping, int hmats_quantized,
                               int non_linearity, int attention_mode,
                               const int* ham_knobs, int qpb, int threads,
                               void* stream) {
  if (B < 1 || M < 1 || M > kMaxMem || D < 1 || D > kMaxDim || K < 1 ||
      K > kMaxHops || qpb < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 ||
      sizeof(float) * smem_floats(qpb, M, D) > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  ChainFormats formats = {};
  bool fast = true;
  for (int i = 0; i < 3 * K + 1; ++i) {
    if (!qmann::make_qfmt(fmts[3 * i], fmts[3 * i + 1], fmts[3 * i + 2],
                          &formats.f[i]))
      return (int)cudaErrorInvalidValue;
    fast = fast && qmann::fastq_exact(formats.f[i]) &&
           formats.f[i].mode == formats.f[0].mode;
  }
  if (attention_mode != 2 && attention_mode != 3)
    return (int)cudaErrorInvalidValue;
  const int hamming = attention_mode == 3;
  // the Hamming term's rounding mode is fixed at compile time too: the
  // hops' att formats share one mode (the launch's, when FastQ runs)
  const int ham_mode = hamming ? formats.f[K].mode : formats.f[0].mode;
  for (int h = 0; hamming && h < K; ++h)
    if (!qmann::make_hamfmt(fmts[3 * (K + h)], fmts[3 * (K + h) + 2],
                            ham_knobs[0], ham_knobs[1], ham_knobs[2],
                            ham_knobs[3], &formats.ham[h]) ||
        formats.ham[h].full.mode != ham_mode)
      return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
#define QMANN_CHAIN_LAUNCH(QT, HM)                                          \
  launch<QT, HM>(flat, u, hmats, mask, u_out, p_out, s_out, B, M, D, K,     \
                 qpb, threads, linear_mapping, hmats_quantized,             \
                 non_linearity, hamming, formats, st)
  switch (ham_mode) {
    case 0:
      return fast ? QMANN_CHAIN_LAUNCH(FastQ<0>, 0)
                  : QMANN_CHAIN_LAUNCH(AnyQ, 0);
    case 1:
      return fast ? QMANN_CHAIN_LAUNCH(FastQ<1>, 1)
                  : QMANN_CHAIN_LAUNCH(AnyQ, 1);
    case 2:
      return fast ? QMANN_CHAIN_LAUNCH(FastQ<2>, 2)
                  : QMANN_CHAIN_LAUNCH(AnyQ, 2);
    default:
      return fast ? QMANN_CHAIN_LAUNCH(FastQ<3>, 3)
                  : QMANN_CHAIN_LAUNCH(AnyQ, 3);
  }
#undef QMANN_CHAIN_LAUNCH
}
