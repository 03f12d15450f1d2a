// The whole K-hop MemN2N controller chain for one query per thread block.
//
// Replaces the TPU kernel fused_hop_chain_pallas / _fused_chain_kernel
// (qmann_tpu/ops/pallas/qkernels.py), attention mode 2 only.  Per hop h:
//   m, c   = Q(slice of flat, fmt_w[h])                 (A and C embeddings)
//   score  = Q(sum_d Q(Q(m,att)*Q(u,bin), att), att)
//   p      = masked softmax(score)                      (-1e30 fill)
//   o      = Q(sum_m mask*Q(Q(p,act)*Q(c,act), act), act)
//   u_map  = Q(sum_i Q(Q(H,w)*Q(u,bin), w), w)          (when linear mapping)
//   u      = Q(Q(u_map,act)+Q(o,act), act), then Q(relu(u), act) if enabled
//
// What bounds it on an H100: at the flagship shape (B=1000, M=10, K=3,
// D=60) the chain reads flat once, 1000*10*360*4 B = 14.4 MB per batch
// (~4 us at 3.35 TB/s), and does ~14k quantized lattice products per query
// with data dependences between hops and between the steps of a hop.  It
// is neither FLOP- nor bandwidth-bound: each block walks dependent steps
// (per-row warp reductions, barriers between score, softmax, read and
// residual), so its time is per-block latency.  Measured on an H100 SXM at
// 700 W: ~0.11 ms of device time per 1000-query batch.  The design keeps
// one query per block (all 1000 blocks are resident at once), reads every
// element of flat exactly once straight from global memory (coalesced
// along D; the score reads each m row once and the weighted sum each c
// column once, so staging them in shared memory would buy nothing), keeps
// u, the scores and the probabilities in shared memory, and reads the
// lin-map weights through the read-only cache.
//
// Numerics: every lattice sum is exact in float32 (quantized products lie
// on the 2^-frac grid, partial sums stay under 2^24 units), so the warp
// reductions may sum in any order.  The softmax is order-sensitive: it
// uses expf and IEEE division (build without --use_fast_math), the -1e30
// masked fill, and total==0 -> 1 for fully masked rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC  (qmann_tpu_torch/ops/cuda/hop_chain.py does it).
#include <cuda_runtime.h>

namespace {

constexpr int kMaxHops = 8;
constexpr int kMaxMem = 64;    // the softmax keeps two rows per lane
constexpr int kMaxDim = 128;
constexpr int kThreads = 128;  // one thread per embedding column at D<=128
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 3 * kMaxHops + 1;  // w[K], att[K], act[K], bin

struct QFmt {
  float maxf;       // saturation bound (2^(iwl+frac)-1)/2^frac in float
  float scale;      // 2^frac
  float inv_scale;  // 2^-frac
  int mode;         // 0 floor, 1 ceil, 2 round-half-even, 3 truncate
  int binary;       // iwl+frac == 0: sign with 0 -> +1
  int full31;       // iwl+frac == 31: the INT_MIN magnitude wrap
};

struct ChainFormats {
  QFmt f[kSlots];
};

// float_quant of qmann_tpu/numerics/fixed.py, element by element.
__device__ __forceinline__ float fq(float x, const QFmt& f) {
  if (f.binary) return x >= 0.f ? 1.f : -1.f;
  const float scaled = x * f.scale;
  float q;
  switch (f.mode) {
    case 0: q = floorf(scaled); break;
    case 1: q = ceilf(scaled); break;
    case 2: q = rintf(scaled); break;
    default: q = truncf(scaled); break;
  }
  // saturating float->int32 conversion
  q = q < -2147483648.f ? -2147483648.f : (q > 2147483648.f ? 2147483648.f : q);
  float deq = q * f.inv_scale;
  if (f.full31 && scaled <= -2147483648.f) deq = 0.f;
  // saturation is decided on the pre-conversion value
  return x > f.maxf ? f.maxf : (x < -f.maxf ? -f.maxf : deq);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads)
hop_chain_kernel(const float* __restrict__ flat,    // [B, M, 2K*D] raw GEMM
                 const float* __restrict__ u_in,    // [B, D] Q(., fmt_w[0])
                 const float* __restrict__ hmats,   // [K, D, D] raw
                 const int* __restrict__ mask,      // [B, M] 0 padded
                 float* __restrict__ u_out,         // [B, D]
                 float* __restrict__ p_out,         // [K, B, M]
                 float* __restrict__ s_out,         // [K, B, M]
                 int B, int M, int D, int K, int linear_mapping,
                 int non_linearity, ChainFormats formats) {
  __shared__ QFmt fmt[kSlots];
  __shared__ float u[kMaxDim], ubin[kMaxDim], umap[kMaxDim], o[kMaxDim];
  __shared__ float s[kMaxMem], pq[kMaxMem];
  __shared__ int live[kMaxMem];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = (size_t)2 * K * D;
  const float* fb = flat + (size_t)b * M * row;

  for (int i = tid; i < 3 * K + 1; i += kThreads) fmt[i] = formats.f[i];
  __syncthreads();
  const QFmt& fbin = fmt[3 * K];
  for (int d = tid; d < D; d += kThreads) {
    u[d] = u_in[(size_t)b * D + d];
    ubin[d] = fq(u[d], fbin);
  }
  for (int r = tid; r < M; r += kThreads) live[r] = mask[(size_t)b * M + r] != 0;
  __syncthreads();

  for (int h = 0; h < K; ++h) {
    const QFmt& fw = fmt[h];
    const QFmt& fa = fmt[K + h];
    const QFmt& fc = fmt[2 * K + h];
    const size_t out_off = ((size_t)h * B + b) * M;

    // score: one warp per memory row, lanes along D
    for (int r = warp; r < M; r += kWarps) {
      const float* mrow = fb + (size_t)r * row + (size_t)h * D;
      float acc = 0.f;
      for (int d = lane; d < D; d += 32)
        acc += fq(fq(fq(mrow[d], fw), fa) * ubin[d], fa);
      acc = warp_sum(acc);
      if (lane == 0) {
        const float sc = fq(acc, fa);
        s[r] = sc;
        s_out[out_off + r] = sc;
      }
    }
    __syncthreads();

    // masked softmax: warp 0, rows lane and lane+32
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
        p_out[out_off + r0] = p;
        pq[r0] = fq(p, fc);
      }
      if (r1 < M) {
        const float p = e1 / total;
        p_out[out_off + r1] = p;
        pq[r1] = fq(p, fc);
      }
    }
    __syncthreads();

    // weighted sum: one thread per column of C
    for (int d = tid; d < D; d += kThreads) {
      const float* ccol = fb + (size_t)(K + h) * D + d;
      float acc = 0.f;
      for (int r = 0; r < M; ++r)
        if (live[r]) acc += fq(pq[r] * fq(fq(ccol[(size_t)r * row], fw), fc), fc);
      o[d] = fq(acc, fc);
    }
    // lin map: one warp per output row, lanes along the row of H
    if (linear_mapping) {
      const float* hm = hmats + (size_t)h * D * D;
      for (int i = warp; i < D; i += kWarps) {
        float acc = 0.f;
        for (int j = lane; j < D; j += 32)
          acc += fq(fq(__ldg(hm + (size_t)i * D + j), fw) * ubin[j], fw);
        acc = warp_sum(acc);
        if (lane == 0) umap[i] = fq(acc, fw);
      }
    }
    __syncthreads();

    // residual (+ ReLU requant)
    for (int d = tid; d < D; d += kThreads) {
      const float um = linear_mapping ? umap[d] : u[d];
      float un = fq(fq(um, fc) + fq(o[d], fc), fc);
      if (non_linearity) un = fq(fmaxf(un, 0.f), fc);
      u[d] = un;
      ubin[d] = fq(un, fbin);
    }
    __syncthreads();
  }
  for (int d = tid; d < D; d += kThreads) u_out[(size_t)b * D + d] = u[d];
}

}  // namespace

// fmts: host array of (iwl, frac, mode) triples for the 3K+1 slots
// w[0..K), att[0..K), act[0..K), bin.  Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for shapes or formats out of range).
extern "C" int qmann_hop_chain(const float* flat, const float* u,
                               const float* hmats, const int* mask,
                               float* u_out, float* p_out, float* s_out,
                               int B, int M, int D, int K, const int* fmts,
                               int linear_mapping, int non_linearity,
                               void* stream) {
  if (B < 1 || M < 1 || M > kMaxMem || D < 1 || D > kMaxDim || K < 1 ||
      K > kMaxHops)
    return (int)cudaErrorInvalidValue;
  ChainFormats formats = {};
  for (int i = 0; i < 3 * K + 1; ++i) {
    const int iwl = fmts[3 * i], frac = fmts[3 * i + 1], mode = fmts[3 * i + 2];
    if (iwl < 0 || frac < 0 || iwl + frac > 31 || mode < 0 || mode > 3)
      return (int)cudaErrorInvalidValue;
    const int n = iwl + frac;
    QFmt& q = formats.f[i];
    // the same float32 arithmetic as numerics.fixed_max_float
    q.maxf = (float)((1u << n) - 1u) / (float)(1u << frac);
    q.scale = (float)(1u << frac);
    q.inv_scale = 1.f / q.scale;  // exact: a power of two
    q.mode = mode;
    q.binary = n == 0;
    q.full31 = n == 31;
  }
  hop_chain_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      flat, u, hmats, mask, u_out, p_out, s_out, B, M, D, K, linear_mapping,
      non_linearity, formats);
  return (int)cudaGetLastError();
}
