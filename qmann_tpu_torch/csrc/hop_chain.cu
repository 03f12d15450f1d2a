// The whole K-hop MemN2N controller chain, several queries per thread
// block, with the hops' memory embeddings built inside it.
//
// Replaces the TPU kernel fused_hop_chain_pallas / _fused_chain_kernel
// (qmann_tpu/ops/pallas/qkernels.py), attention modes 2 and 3, and on the
// serving path the stacked embedding GEMM before it (_mxu_matmul of the
// memory by Q(A|C), models/memn2n.py::forward_prepared).  Per hop h:
//   m, c   = Q(A and C slices of x @ Q(A|C), fmt_w[h])  (the embeddings)
//   score  = Q(sum_d Q(Q(m,att)*Q(u,bin), att), att)   (mode 2)
//          | Q(sum_d ham_term(m, u), (iwl_att, 31-iwl_att))  (mode 3: the
//            Hamming similarity of the requanted m and the raw current u,
//            ham_term in hamming.cuh)
//   p      = masked softmax(score)                      (-1e30 fill)
//   o      = Q(sum_m mask*Q(Q(p,act)*Q(c,act), act), act)
//   u_map  = Q(sum_i Q(Q(H,w)*Q(u,bin), w), w)          (when linear mapping)
//   u      = Q(Q(u_map,act)+Q(o,act), act), then Q(relu(u), act) if enabled
// The kernel takes the bag-of-words memory x [B, M, I] and Q(A|C) [I,
// 2K*D] and forms each hop's slices itself
// (ops/cuda/hop_chain.py::fused_hop_chain_from_memory), so the product
// flat = x @ Q(A|C) [B, M, 2K*D] is never written or read.
//
// What bounds it on an H100.  At the serve cell's shape (B=1000, M=50,
// I=114, K=3, D=60) the GEMM route wrote flat, 72 MB a batch, and the
// chain read it back.  Embedding in the kernel, what the work needs is:
// x's rows read once (22.8 MB dense, ~11-23 MB of live rows; as (index,
// count) pairs ~0.36 MB), Q(A|C) (164 KB) from L2, and ~25,500 live rows
// x ~7 nonzero entries x 360 columns = 64 M multiply-adds a batch (~2 us
// on the f32 pipe), the rest of the chain (~6,000 requantized products a
// query and hop at M=10, ~30,000 at M=50) as before, and the same
// latency chain of dependent steps per hop.  No operation pipe and no
// byte stream comes near the time: each hop's steps depend on each
// other, so per-block latency bounds it.  This design:
//  - fixes the rounding mode at compile time and saturates without a
//    branch (FastQ<Mode>, qformat.cuh; the C entry picks one of four
//    instances by the launch's one mode, and the runtime AnyQ instance
//    only for binary or 31-bit formats; the mode-3 term takes the same
//    mode, hamming.cuh);
//  - lists each row's nonzero entries of x once, before the first hop
//    (list_rows: one warp a row, a ballot a piece of 32), as (offset,
//    value) pairs in shared memory: kList = 8 slots a row, the unused ones
//    (0, +0).  A block whose rows all fit (the serve cell's: 6 words and
//    the time bit) keeps that layout; a block with a longer row lists
//    again with the room of the weight slices added, 58 slots a row at
//    the serve shape, and reads the weights through the cache instead
//    (a row longer still is walked in x itself at every hop);
//  - at each hop gives one thread a column d of both parts and a group of
//    rows: it sums the row's pairs against its two weight columns (kList
//    slots with no branch where the weights are staged, else to the
//    row's own count), requantizes as the
//    score and weighted sum take them (Q(Q(m,w),att) in mode 2, Q(m,w) in
//    mode 3, Q(Q(c,w),act)) and stores them in the stage.  Hop h's weight
//    slices [I][2D] are staged in shared memory with cp.async (in the
//    buffer of Q(H[h]): W[h] lands during hop h-1's softmax and weighted
//    sum, H[h] during hop h's score) wherever they fit beside one query's
//    block, else read through the cache.  Every row gets its slices from
//    its own x, live or not (s holds a score for every row);
//  - stages H[h] with cp.async (row stride D+1), shared by the block's
//    queries; the serving path hands it over quantized once
//    (prepare_inference caches Q(H)); raw H is quantized in place once per
//    block and hop;
//  - gives each (query, lin-map output row) one thread that walks its row
//    of Q(H) (neighbouring threads, rows an odd stride apart: no bank
//    conflicts) with four partial sums, no reduction;
//  - takes its geometry (queries per block, threads, whether the weights
//    are staged) from the wrapper (ops/cuda/hop_chain.py::chain_geometry),
//    with dynamic shared memory opted in above 48 KB, and at most 64
//    registers a thread, so that two 512-thread blocks share an SM.
// Measured on one H100 80GB HBM3 at 700 W (PERF.md, section 6), device
// time a call, B=1000, mode 2: at the serve cell's shape 0.118 ms where
// the exact GEMM and the chain from its output took 0.228; at the
// flagship (M=10, I=29) 0.037 against 0.044; at the serve shape with rows
// of 10 to 12 nonzero entries 0.163-0.193 against 0.227-0.234 (0.46 when
// each such row was walked in x).  In that kernel the walk takes ~24 us,
// the softmax and weighted sum ~25, the lin map ~9 and the score ~8.5
// (phases left out one at a time).
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
constexpr int kPieces = 4;  // entries of x a lane holds: a chunk of 128
constexpr int kList = 8;    // listed nonzero entries a row of x
constexpr int kMaxThreads = 512;
constexpr int kSlots = 3 * kMaxHops + 1;  // w[K], att[K], act[K], bin
// dynamic shared memory a block may take: 227 KB less the static formats
constexpr int kSmemLimit = 232448 - 1024;

struct ChainFormats {
  QFmt f[kSlots];
  HamFmt ham[kMaxHops];  // mode 3: each hop's Hamming format
};

// Floats of dynamic shared memory for qpb queries per block: the buffer
// of Q(H[h]), which holds hop h's weight slices too when they are staged
// (wstaged), the rows' lists of x and their counts, one stage of the
// hop's slices and the per-query vectors.  The same formula as
// ops/cuda/hop_chain.py::chain_smem_bytes.
__host__ __device__ inline size_t round4(size_t n) {  // 16-byte multiple
  return (n + 3) & ~(size_t)3;
}

__host__ __device__ inline size_t hbuf_floats(int D, int I, bool wstaged) {
  const size_t h = (size_t)D * (D + 1), w = (size_t)I * 2 * D;
  return round4(wstaged && w > h ? w : h);
}

size_t smem_floats(int qpb, int M, int D, int I, bool wstaged) {
  return hbuf_floats(D, I, wstaged)                  // Q(H[h]) | weights
         + (size_t)qpb * M * (2 * kList + 1 + 2 * D)  // lists, counts, stage
         + (size_t)3 * qpb * D                        // u, Q(u, bin), u_map
         + (size_t)3 * qpb * M;  // scores, Q(p, act), live
}

// Issue the copies of hop h's A and C slices of wt [rows][2K*D] into
// stage [rows][2D]: A at columns [0, D), C at [D, 2D).
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

// List the nonzero entries of the block's rows of x [rows][I]: row r's
// first L entries, in order of i, as (i * ld, x[r, i]) pairs (ld: the row
// stride of the weights the embedding reads) in list[r*L ...], and its
// count of nonzero entries in cnt[r] (a row with more than L is walked in
// x itself at every hop).  At L = kList the slots past a row's entries
// hold (0, +0) (embed_hop's walk of all kList slots); at a longer L, the
// slot after an odd count does (its walk of the count in pairs).  One warp
// a row, the row's entries loaded in chunks of 128 (four per lane), a
// ballot a piece of 32.  Returns whether a row of this thread's warp has
// more than L entries.
__device__ __forceinline__ bool list_rows(int2* list, int L, int* cnt,
                                          const float* __restrict__ xb,
                                          int rows, int I, int ld) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  bool longer = false;
  for (int r = threadIdx.x >> 5; r < rows; r += blockDim.x >> 5) {
    const float* xr = xb + (size_t)r * I;
    int2* lr = list + (size_t)r * L;
    int n = 0;
    for (int p0 = 0; p0 < I; p0 += 32 * kPieces) {
      float v[kPieces];
#pragma unroll
      for (int k = 0; k < kPieces; ++k) {
        const int i = p0 + 32 * k + lane;
        v[k] = i < I ? __ldg(xr + i) : 0.f;
      }
#pragma unroll
      for (int k = 0; k < kPieces; ++k) {
        const bool nz = v[k] != 0.f;
        const unsigned m = __ballot_sync(0xffffffffu, nz);
        const int slot = n + __popc(m & below);
        if (nz && slot < L)
          lr[slot] = make_int2((p0 + 32 * k + lane) * ld, __float_as_int(v[k]));
        n += __popc(m);
      }
    }
    if (L == kList) {
      if (lane >= n && lane < kList) lr[lane] = make_int2(0, 0);
    } else if (lane == 0 && (n & 1) && n < L) {
      lr[n] = make_int2(0, 0);
    }
    if (lane == 0) cnt[r] = n;
    longer |= n > L;
  }
  return longer;
}

// Hop h's slices of the block's rows, requantized, into st [rows][2D]:
// output (r, c) is Q(sum over the nonzero entries i of x[r, i] * w[i,
// col]) (the stacked GEMM's output for that row and column), in fw, then
// fa (A, mode 2) or fc (C).  One thread a column d of both parts and a
// group of rows (r = g, g + R, ...): the thread's two weight columns are
// fixed, it reads each list entry once for both, and a warp's lanes read
// one row's list at once.  w [., ld]: hop h's slices staged in shared
// memory (Staged), whose lists hold kList slots and are summed with no
// branch (the unused slots (0, +0) add +0); else wt itself, read through
// the cache, whose lists hold L slots and are summed to the row's count.
// A row longer than its list walks its row of x itself; a row with no
// nonzero entry is Q(+0).  The parts' columns start at col_a and col_c.
template <bool Staged, class Q>
__device__ __forceinline__ void embed_hop(float* st, const int2* list, int L,
                                          const int* cnt,
                                          const float* __restrict__ xb,
                                          const float* w, int ld, int col_a,
                                          int col_c, int rows, int I, int D,
                                          const Q& fw, const Q& fa,
                                          const Q& fc, int hamming) {
  const int T = blockDim.x;
  const int R = T >= D ? T / D : 1;
  const int g = T >= D ? threadIdx.x / D : 0;
  auto ld_w = [&](const float* p) { return Staged ? *p : __ldg(p); };
  for (int d = T >= D ? threadIdx.x % D : threadIdx.x; d < D && g < R;
       d += T) {
    const float* wa = w + col_a + d;
    const float* wc = w + col_c + d;
    const int stride = Staged ? kList : L;
#pragma unroll 1
    for (int r = g; r < rows; r += R) {
      const int n = cnt[r];
      float a = 0.f, c = 0.f;
      if (n != 0) {
        const int4* lr =
            reinterpret_cast<const int4*>(list + (size_t)r * stride);
        auto walk = [&](const int4 e) {
          a = fmaf(__int_as_float(e.y), ld_w(wa + e.x), a);
          c = fmaf(__int_as_float(e.y), ld_w(wc + e.x), c);
          a = fmaf(__int_as_float(e.w), ld_w(wa + e.z), a);
          c = fmaf(__int_as_float(e.w), ld_w(wc + e.z), c);
        };
        if constexpr (Staged) {
#pragma unroll
          for (int k = 0; k < kList / 2; ++k) walk(lr[k]);
        } else if (n <= L) {
#pragma unroll 2
          for (int k = 0; k < (n + 1) >> 1; ++k) walk(lr[k]);
        }
        if (n > stride) {  // longer than its list: x's row itself
          const float* xr = xb + (size_t)r * I;
          a = c = 0.f;
          for (int i = 0; i < I; ++i) {
            const float v = __ldg(xr + i);
            if (v != 0.f) {
              a = fmaf(v, ld_w(wa + (size_t)i * ld), a);
              c = fmaf(v, ld_w(wc + (size_t)i * ld), c);
            }
          }
        }
      }
      const float xa = fw(a);
      st[r * 2 * D + d] = hamming ? xa : fa(xa);
      st[r * 2 * D + D + d] = fc(fw(c));
    }
  }
}

// Q(H[h]) in place: the lin map's weights staged raw
template <class Q>
__device__ __forceinline__ void requant_h(float* hq, int D, const Q& fw) {
  const int T = blockDim.x;
  int i = threadIdx.x / D, j = threadIdx.x % D;
  const int di = T / D, dj = T % D;
#pragma unroll 4
  for (int e = threadIdx.x; e < D * D; e += T) {
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

template <class Q, int HamMode>
__global__ void __launch_bounds__(kMaxThreads, 2)
hop_chain_kernel(const float* __restrict__ x,       // [B, M, I]
                 const float* __restrict__ wt,      // [I, 2K*D] Q(A|C)
                 int I,
                 const float* __restrict__ u_in,    // [B, D] Q(., fmt_w[0])
                 const float* __restrict__ hmats,   // [K, D, D] raw, or
                                                    // Q(H) if h_quantized
                 const int* __restrict__ mask,      // [B, M] 0 padded
                 float* __restrict__ u_out,         // [B, D]
                 float* __restrict__ p_out,         // [K, B, M]
                 float* __restrict__ s_out,         // [K, B, M]
                 int B, int M, int D, int K, int qpb, int linear_mapping,
                 int h_quantized, int non_linearity, int hamming, int vec16,
                 int wstaged, ChainFormats formats) {
  __shared__ QFmt fmt[kSlots];
  __shared__ HamFmt ham[kMaxHops];
  extern __shared__ __align__(16) float smem[];
  // hq (Q(H[h]), and hop h's weight slices [I][2D] when they are staged; a
  // 16-byte multiple), the rows' lists of x [qpb*M][kList] and counts
  // [qpb*M], the stage [qpb*M][2D], then the vectors.  A block with a row
  // longer than kList lists from the end of Q(H[h]) to the counts instead.
  const size_t hbuf = hbuf_floats(D, I, wstaged);
  float* hq = smem;
  int2* list = reinterpret_cast<int2*>(smem + hbuf);
  int* cnt = reinterpret_cast<int*>(list + (size_t)qpb * M * kList);
  float* st = reinterpret_cast<float*>(cnt + qpb * M);
  float* u = st + (size_t)2 * qpb * M * D;             // [qpb][D]
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
  const float* xb = x + (size_t)b0 * M * I;
  // lanes per score row: a power of two that about fills the block
  int G = 1;
  while (G < 32 && 2 * G * qpb * M <= T) G <<= 1;

  // staged weights share hq with H[h]: W[h] is staged for the embedding,
  // H[h] after it (and W[h+1] after the lin map)
  if (wstaged) stage_hop(hq, wt, I, D, K, 0, vec16);
  if (linear_mapping && !wstaged) stage_h(hq, hmats, D, 0);
  const bool longer =
      list_rows(list, kList, cnt, xb, rows, I, wstaged ? D2 : 2 * K * D);
  for (int i = tid; i < 3 * K + 1; i += T) fmt[i] = formats.f[i];
  for (int i = tid; i < K; i += T) ham[i] = formats.ham[i];
  // a row longer than kList where the weight slices are staged: list
  // again from the end of Q(H[h]), in the weights' room too, and read the
  // weights through the cache (W[0] is in flight into that room)
  bool w_in_hq = wstaged;
  int L = kList;
  const size_t h0 = round4((size_t)D * (D + 1));
  if (__syncthreads_or(longer) && hbuf > h0) {
    cp_async_wait_all();
    __syncthreads();
    w_in_hq = false;
    if (linear_mapping) stage_h(hq, hmats, D, 0);
    list = reinterpret_cast<int2*>(smem + h0);
    L = (int)(((hbuf - h0) / 2 + (size_t)qpb * M * kList) / rows) & ~1;
    list_rows(list, L, cnt, xb, rows, I, 2 * K * D);
  }
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
    const size_t out_off = ((size_t)h * B + b0) * M;

    // H[h] (or hop h's staged weights) have landed; hop h-1 is done with
    // the stage
    cp_async_wait_all();
    __syncthreads();

    // the slices, requantized: embedded from the rows' lists and hop h's
    // weights (staged in hq, else wt's columns)
    if (w_in_hq)
      embed_hop<true>(st, list, L, cnt, xb, hq, D2, 0, D, rows, I, D, fw, fa,
                      fc, hamming);
    else
      embed_hop<false>(st, list, L, cnt, xb, wt, 2 * K * D, h * D,
                       (K + h) * D, rows, I, D, fw, fa, fc, hamming);
    if (linear_mapping && !h_quantized && !w_in_hq) requant_h(hq, D, fw);
    __syncthreads();
    // staged weights: hq is spent; H[h] lands during the score
    if (w_in_hq && linear_mapping) stage_h(hq, hmats, D, h);
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
    if (w_in_hq && linear_mapping) {
      cp_async_wait_all();
      __syncthreads();
      if (!h_quantized) {
        requant_h(hq, D, fw);
        __syncthreads();
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
    // Q(H[h]) is spent: H[h+1], or W[h+1] when staged, lands during the
    // softmax and weighted sum
    if (w_in_hq && h + 1 < K)
      stage_hop(hq, wt, I, D, K, h + 1, vec16);
    else if (linear_mapping && h + 1 < K)
      stage_h(hq, hmats, D, h + 1);

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
int launch(const float* x, const float* wt, int I, const float* u,
           const float* hmats, const int* mask, float* u_out, float* p_out,
           float* s_out, int B, int M, int D, int K, int qpb, int threads,
           int linear_mapping, int h_quantized, int non_linearity,
           int hamming, int wstaged, const ChainFormats& formats,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(qpb, M, D, I, wstaged);
  // raised once per instance and device (the attribute is per device)
  static bool opted_in[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (bytes > 48 * 1024 && !(dev < 64 && opted_in[dev])) {
    const cudaError_t rc = cudaFuncSetAttribute(
        hop_chain_kernel<Q, HamMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (rc != cudaSuccess) return (int)rc;
    if (dev < 64) opted_in[dev] = true;
  }
  // 16-byte copies of the staged weight slices
  const int vec16 = D % 4 == 0 && ((uintptr_t)wt & 15u) == 0;
  const int blocks = (B + qpb - 1) / qpb;
  hop_chain_kernel<Q, HamMode><<<blocks, threads, bytes, stream>>>(
      x, wt, I, u, hmats, mask, u_out, p_out, s_out, B, M, D, K, qpb,
      linear_mapping, h_quantized, non_linearity, hamming, vec16, wstaged,
      formats);
  return (int)cudaGetLastError();
}

}  // namespace

// x: the bag-of-words memory [B, M, I] (I >= 1), which the kernel embeds
// with wt = Q(A|C) [I, 2K*D], row-major and contiguous, hop h's weight
// slices staged in shared memory when wstaged, else read from wt.
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
extern "C" int qmann_hop_chain(const float* x, const float* wt, int I,
                               const float* u, const float* hmats,
                               const int* mask, float* u_out, float* p_out,
                               float* s_out, int B, int M, int D, int K,
                               const int* fmts, int linear_mapping,
                               int hmats_quantized, int non_linearity,
                               int attention_mode, const int* ham_knobs,
                               int qpb, int threads, int wstaged,
                               void* stream) {
  if (B < 1 || M < 1 || M > kMaxMem || D < 1 || D > kMaxDim || K < 1 ||
      K > kMaxHops || I < 1 || qpb < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      sizeof(float) * smem_floats(qpb, M, D, I, wstaged) > (size_t)kSmemLimit)
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
#define QMANN_CHAIN_LAUNCH(QT, HM)                                        \
  launch<QT, HM>(x, wt, I, u, hmats, mask, u_out, p_out, s_out, B, M, D, K, \
                 qpb, threads, linear_mapping, hmats_quantized,            \
                 non_linearity, hamming, wstaged != 0, formats, st)
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
