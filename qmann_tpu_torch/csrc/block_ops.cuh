// Block-level building blocks shared by the port's kernels: cp.async
// staging of global memory into shared memory (hop_chain.cu,
// attention_read.cu, hamming.cu) and the score pass over memory rows with
// G lanes per row (attention_read.cu, hamming.cu).
#pragma once

#include <cuda_runtime.h>

namespace qmann {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// Start the copies of n contiguous floats src[0, n) into dst[0, n) as one
// commit group, spread over the block's threads (neighbouring threads on
// neighbouring addresses).  vec16: 16-byte copies; dst and src 16-byte
// aligned and n a multiple of 4.
__device__ __forceinline__ void stage_flat(float* dst, const float* src,
                                           int n, bool vec16) {
  if (vec16) {
    for (int e = 4 * threadIdx.x; e < n; e += 4 * blockDim.x)
      cp_async16(dst + e, src + e);
  } else {
    for (int e = threadIdx.x; e < n; e += blockDim.x)
      cp_async4(dst + e, src + e);
  }
  cp_async_commit();
}

// The score pass: rows memory rows of D values in shared memory (row t of
// query t / M at rows_sm + t*D), G lanes per row (a power of two <= 32),
// lane g summing term(x, t / M, d) over d = g, g+G, ..., then a shuffle sum
// over the G lanes; lane 0 of each row writes fin(sum) to s[t] and out[t].
// Every thread of the block takes each round, so the shuffles see whole
// warps (G lanes of a row sit in one warp: blockDim.x is a multiple of 32).
template <class Term, class Fin>
__device__ __forceinline__ void score_rows(const float* rows_sm, int rows,
                                           int M, int D, int G, float* s,
                                           float* out, Term term, Fin fin) {
  for (int base = 0; base < rows * G; base += blockDim.x) {
    const int t = base + threadIdx.x;
    const int task = t / G, g = t & (G - 1);
    const bool on = task < rows;
    const int q = on ? task / M : 0;
    const float* row = rows_sm + (size_t)(on ? task : 0) * D;
    float acc = 0.f;
    if (on) {
#pragma unroll 2
      for (int d = g; d < D; d += G) acc += term(row[d], q, d);
    }
    for (int o = G >> 1; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (on && g == 0) {
      const float sc = fin(acc);
      if (s) s[task] = sc;
      out[task] = sc;
    }
  }
}

}  // namespace qmann
