// What the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) share on Hopper's warpgroup path: tiles of one
// head brought by the Tensor Memory Accelerator (TMA) into 128-byte-swizzled
// shared memory, the mbarriers their copies complete, the wgmma descriptors
// that read them, and the host's tensor-map encoder.  Built for sm_90a.
// cuda.h is included for the TMA map's types only: the encoder is looked up
// through the runtime, so no link to the driver.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace hopper {

// ---- TMA and mbarriers ----------------------------------------------------
// A tile of ROWS positions x HD head dims of one head comes by the Tensor
// Memory Accelerator: boxes of 64 positions x 64 head dims (128-byte rows,
// the copy writing them 128-byte-swizzled, as the descriptors below read
// them), column blocks ROWS * 128 bytes apart; positions past the tensor's
// end read as zeros.  One thread issues the copies; their bytes complete a
// phase of an mbarrier in shared memory, on which the readers wait.

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` more of the copies it tracks.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One plain arrival (a reader that is done with the tile the barrier guards).
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the phase of parity `parity` to complete.  A copy that never
// lands would leave the block waiting for good: after ~2^24 polls (seconds)
// the kernel traps, and the launch fails, instead.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned a = smem_u32(bar);
  for (int i = 0;; ++i) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (i > (1 << 24)) __trap();
  }
}

template <int HD, int ROWS>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map, int head,
                                         int row0, int b, uint64_t* bar) {
  const unsigned long long m = reinterpret_cast<unsigned long long>(map);
#pragma unroll
  for (int c = 0; c < HD / 64; ++c)
#pragma unroll
    for (int r = 0; r < ROWS / 64; ++r)
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
          " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst + c * (ROWS * 128) +
                                                              r * 64 * 128)),
          "l"(m), "r"(c * 64), "r"(head), "r"(row0 + r * 64), "r"(b), "r"(smem_u32(bar))
          : "memory");
}

// Descriptors of such a tile.  A descriptor holds its start address in
// 16-byte units in its low 14 bits, so the descriptor of a byte offset
// within the (< 256 KB of) shared memory is the tile's plus offset / 16:
// kmajor(kk) and mnmajor(kc) are the offsets of a k-step, added to a base
// descriptor made once.
// K-major (a row is one m or n, its head dims the k): k-step kk is 16 head
// dims, 32 bytes along the rows, the next column block past 64; atoms 8
// rows apart 1024 bytes, the leading offset unused.
__device__ __forceinline__ uint64_t desc_kmajor(const unsigned char* tile) {
  return mma::wgmma_desc(tile, 16, 1024);
}
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor(uint64_t desc, int kk) {
  return desc + (uint64_t)(((kk >> 2) * (ROWS * 128) + (kk & 3) * 32) >> 4);
}
// MN-major (a row is one k, its head dims the n): k-step kc is rows 16 kc..,
// two atoms on; atoms 8 rows apart 1024 bytes, column blocks (64 n) ROWS *
// 128 bytes apart.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mnmajor(const unsigned char* tile) {
  return mma::wgmma_desc(tile, ROWS * 128, 1024);
}
__device__ __forceinline__ uint64_t mnmajor(uint64_t desc, int kc) {
  return desc + (uint64_t)(kc * 2048 >> 4);
}

// Pins every register of an accumulator here: the compiler neither moves
// a read of it above the wgmma_wait before nor a write below the wgmma
// after (CUTLASS's warpgroup_fence_operand).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d (64 x HD) += a (16 k, registers) * B (16 x HD, MN-major at desc).
template <int HD>
__device__ __forceinline__ void wgmma_rs(float (&d)[HD / 8][4], const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (HD == 64)
    mma::wgmma_m64n64k16(d, a, desc);
  else
    mma::wgmma_m64n128k16_rs(d, a, desc);
}

// The 1024-byte-aligned start of the dynamic shared memory (swizzle atoms).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const unsigned misalign = static_cast<unsigned>(__cvta_generic_to_shared(raw)) & 1023;
  return raw + ((1024 - misalign) & 1023);
}

// ---- Host: the tensor maps ------------------------------------------------

// cuTensorMapEncodeTiled, a driver function, reached through the runtime
// (so the library needs no link to the driver), looked up once.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA map of a (B, S, heads, HD) bf16 tensor: boxes of 64 head dims x
// one head x 64 positions, 128-byte swizzled; positions past S read as
// zeros.  Returns a CUDA error code (0 on success).
inline int tensor_map(CUtensorMap* map, const void* base, int B, int S, int heads, int hd) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hopper
