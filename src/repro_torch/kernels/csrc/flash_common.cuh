// What the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) share: the masks, so that both mask the same
// (query, key) pairs, the exponential of their bfloat16 bodies and the
// cp.async row loader of their bfloat16 tiles.
// Positions are absolute, 0..Sq-1 and 0..Skv-1: causal k <= q; a sliding
// window (q - k) < window, and also (k - q) < window when not causal (the
// model's attention_bias); a chunk q / chunk == k / chunk.
#pragma once

#include <cuda_bf16.h>
#include <stddef.h>

#include "mma_bf16.cuh"

namespace attn {

constexpr float NEG_INF = -1e30f;  // the finite mask value of the reference
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ bool visible(int q, int k, int causal, int window,
                                        int chunk) {
  bool ok = true;
  if (causal) ok = ok && k <= q;
  if (window > 0) {
    ok = ok && (q - k) < window;
    if (!causal) ok = ok && (k - q) < window;
  }
  if (chunk > 0) ok = ok && (q / chunk) == (k / chunk);
  return ok;
}

// True when every (query, key) pair of the two position ranges is masked.
__device__ __forceinline__ bool tile_masked(int q_lo, int q_hi, int k_lo,
                                            int k_hi, int causal, int window,
                                            int chunk) {
  if (causal && k_lo > q_hi) return true;
  if (window > 0 && q_lo - k_hi >= window) return true;
  if (window > 0 && !causal && k_lo - q_hi >= window) return true;
  if (chunk > 0 && (k_hi / chunk < q_lo / chunk || k_lo / chunk > q_hi / chunk))
    return true;
  return false;
}

// True when every (query, key) pair of the two ranges is visible.
__device__ __forceinline__ bool tile_visible(int q_lo, int q_hi, int k_lo,
                                             int k_hi, int causal, int window,
                                             int chunk) {
  if (causal && k_hi > q_lo) return false;
  if (window > 0 && q_hi - k_lo >= window) return false;
  if (window > 0 && !causal && k_hi - q_lo >= window) return false;
  if (chunk > 0 && !(q_lo / chunk == k_lo / chunk && q_hi / chunk == k_lo / chunk &&
                     k_hi / chunk == k_lo / chunk))
    return false;
  return true;
}

// 2^x by the special-function unit (ex2.approx.ftz: relative error ~2^-22,
// results below 2^-126 flushed to 0), without exp2f's rescaling of such
// results: P is rounded to bf16 (2^-9) before it is used.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cp.async of `rows` rows of HD bf16 (row `row0` on, `stride` elements
// apart in global memory) into a tile of row stride LD; rows at or past
// `n_valid` are zero-filled.
template <int HD, int LD, int NTHREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int row0, int rows,
                                          int n_valid, int tid) {
  constexpr int CH = HD / 8;  // 16-byte chunks a row
  for (int i = tid; i < rows * CH; i += NTHREADS) {
    const int r = i / CH;
    const int c = (i % CH) * 8;
    const bool in = row0 + r < n_valid;
    const __nv_bfloat16* g = in ? src + (size_t)(row0 + r) * stride + c : src;
    mma::cp_async16(dst + r * LD + c, g, in);
  }
}

}  // namespace attn
