// Fused 3x3 SAME convolution + bias + ReLU (+ 2x2/2 max-pool) for Hopper
// (sm_90a), NHWC input, HWIO weights, float32 accumulation, on the tensor
// cores.
//
// Replaces: src/repro/kernels/fused_conv.py::fused_conv3x3, the Pallas TPU
// kernel (`_kernel`, launched by `pl.pallas_call`).  That kernel holds a
// WHOLE frame per grid step in VMEM (vmem_bytes(224, 224, 64, 64) is about
// 31 MiB); a Hopper block has at most 232,448 bytes of shared memory, so
// the designs below tile space instead.  What they keep from the TPU kernel
// is the fusion group's guarantee: the pre-pool frame never reaches device
// memory -- bias, ReLU and the 2x2 max are applied in registers and only
// the stored frame (pooled or not) is written.
//
// The product is an implicit GEMM: M = the pre-pool pixels of a spatial
// tile, N = output channels, K = 9 taps x Cin.  A block is one (image, TILE
// x TILE pixel tile, BLOCK_C = 64 output channels); it loops over the input
// channels a chunk at a time.  The A operand of tap (dy, dx) is the staged
// halo tile read at a shifted offset (no im2col is built).
//
// float32 (fused_conv3x3_f32_kernel): 3xTF32 on Hopper's warpgroup tensor
// cores, wgmma m64n64k8 with both operands in shared memory.
//  - Why three products: single-pass TF32 rounds each operand to 11
//    significant bits, up to 2^-11 = 4.9e-4 relative error a product, which
//    misses the float32 tolerance of 2e-4 (tests/test_torch_kernels.py
//    shows it).  Each operand is split, big = tf32(v) and small = tf32(v -
//    big), rounded to nearest with ties away as cvt.rna rounds
//    (mma::tf32_rna), which leaves |v - big - small| <= 2^-22 |v|; three
//    products, small*big + big*small + big*big (small terms first), are
//    summed.  The dropped small*small term and the splits bound a product's
//    error by about 3 * 2^-22 = 7e-7 of |x w|; the tf32 products themselves
//    are exact in float32.
//  - The sums: the tensor cores add to the accumulator with truncation,
//    toward zero, so an error of up to 2^-23 of the running sum enters at
//    every product.  Summed straight into one accumulator over VGG's 3 x 576
//    products that bias moved the batch-8 logits past their tolerance
//    (PERF.md).  So each chunk's 27 products (9 taps x 3, one k8 step
//    each) go to a partial that the chunk's first wgmma zeroes (scale-d 0),
//    and a float32 add on the CUDA cores (rounding to nearest) folds the
//    partial into the sum: the truncation is relative to a chunk's partial
//    and no longer builds up over K.  tests/test_torch_kernels.py emulates
//    this summation in numpy and holds it to the Pallas kernel.
//  - Weights: wgmma reads 32-bit operands K-major only, and HWIO is
//    Cout-contiguous, so fused_conv3x3_prep_weights_kernel (launched by the
//    same call, before the conv) writes the weights once per call as two
//    K-major tf32 planes, big and small, in the order a block reads them:
//    for each (64-channel block, 8-channel chunk) one contiguous 36,864-byte
//    piece [plane][tap][k half][64 channels][4] (fused_conv.py::
//    prep_weights_ref is the same map in PyTorch).  Nothing is kept across
//    calls.  An input the TMA map cannot take (Cin not a multiple of 8, as
//    VGG's Cin = 3, or a pointer off 16 bytes) is first copied with its
//    channels padded to 8 by fused_conv3x3_stage_input_kernel, in the same
//    call.
//  - A block is one producer warp and TILE / 8 consumer warpgroups, each
//    owning 8 tile rows, i.e. TILE / 8 m64 tiles of 8 x 8 pixels (row m of
//    an m64 tile is pixel (m / 8, m % 8)).  The producer's one thread
//    brings each chunk into a ring of stages: the haloed (TILE + 2)^2 x 8
//    channel input tile by TMA (a 4-D tensor map over NHWC; coordinates
//    outside the frame read as zeros, which is exactly SAME padding) and
//    the chunk's weight piece by one bulk copy, both completing the stage's
//    `full` mbarrier; it refills a stage when every consumer warp has
//    arrived on its `empty` mbarrier.
//  - A consumer warpgroup splits the 10 halo rows it reads into its own
//    big and small planes once per chunk (not once per tap), into the
//    no-swizzle K-major layout: [4-channel half][row][column][4], 16 bytes a
//    pixel.  An 8 x 8-pixel m64 tile is then eight core matrices of eight
//    pixels, one halo row apart, and the tap (dy, dx) is only the start
//    address of its descriptor: + (dy * (TILE + 2) + dx) * 16 bytes.  The
//    next chunk is split while this chunk's 27 x (TILE / 8) products run.
//  - Registers: the sum and the partial, 2 x 32 a thread per m64 tile (128
//    at TILE 16), no fragments.  The pool in registers: thread (warp w, lane
//    4 g + t) of a warpgroup holds rows 16 w + g and 16 w + g + 8 of each
//    m64 tile, the vertical pair of pixels (2 w, g), (2 w + 1, g); the lane
//    4 (g ^ 1) + t holds the horizontal neighbours, so the 2x2 max is one
//    fmax and one shuffle (fused_conv.py::gemm_row_pixel is the same map,
//    checked on the CPU).
//  - Tiles: 16 (two consumer warpgroups, one block an SM) or 8 (one, two
//    blocks an SM).  fused_conv.py::choose_tile takes, of the tiles whose
//    grid fills the 132 SMs, the one that pads the frame least: 224^2 and
//    112^2 take 16, 56^2 takes 8 (16 would compute 64^2).  The descriptor
//    trick needs m64 tiles of 8 x 8 pixels, so 28^2 (tile 16) and 14^2
//    (tile 8) frames are padded to 32^2 / 16^2, 1.31x the work.
//  - Every register a product writes is written only by products: the
//    partial is read after the chunk's wgmma_wait, so ptxas keeps the
//    products asynchronous.
//
// bfloat16 (fused_conv3x3_bf16_kernel): mma.sync m16n8k16 through ldmatrix
// on a STAGES-deep cp.async ring, one product a step straight into the sum
// (its tolerance, 2e-1, has room for the truncation).  Its warps each own 64
// pixels x 32 channels in sub-pixel-major order (m16 tile mt = the 2x2
// window's sub-pixel (mt / 2, mt % 2), row r = the warp's window r), so a
// lane holds whole windows.  A staged pixel is a 48-byte row (the 32-byte
// chunk + 16 bytes of pad), even and odd columns apart; weight rows are
// padded by 8 elements.  Rows or pointers that are not whole 16-byte pieces
// are staged element by element (`vec` = 0).
//
// What bounds it: 2 x 9 x Cin x Cout FLOPs per output pixel against Cin +
// Cout words of traffic, hundreds of FLOPs a byte, so operations.  3xTF32
// does three tf32 products per multiply-add, so its least time is 3 x
// FLOPs at the tensor cores' dense TF32 rate (494.7 TFLOP/s on an H100 SXM
// at 700 W), 2.5x less than the CUDA cores' FLOPs / 67 TFLOP/s.  Beside the
// products: shared-memory reads (an m64n64k8 wgmma reads 2 KB of A and 2 KB
// of B in 32 tensor-core clocks, the SM's full shared-memory rate), the
// partial's fold and the 1.31x padding of the small frames.
//
// Build (see fused_conv.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -O3 -shared -Xcompiler -fPIC -DBLOCK_C=.. -DCHUNK_BYTES=.. -DSTAGES=..
//   -DF32_STAGES_BIG=.. -DF32_STAGES_SMALL=.. -DTILE_BIG=.. -DTILE_SMALL=..;
// fused_conv.py computes the grid and the shared-memory size it passes in.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "tma_wgmma.cuh"

#if !defined(BLOCK_C) || !defined(CHUNK_BYTES) || !defined(STAGES) || \
    !defined(F32_STAGES_BIG) || !defined(F32_STAGES_SMALL) || !defined(TILE_BIG) || \
    !defined(TILE_SMALL)
#error "build with -DBLOCK_C, -DCHUNK_BYTES, -DSTAGES, -DF32_STAGES_BIG, -DF32_STAGES_SMALL, -DTILE_BIG and -DTILE_SMALL (see fused_conv.py)"
#endif

namespace {

using hopper::aligned_smem;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_expect;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_u32;

__device__ __forceinline__ void store2(float* p, float v0, float v1, bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (second) p[1] = v1;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1, bool pair,
                                       bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
    if (second) p[1] = __float2bfloat16(v1);
  }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on wgmma
// ---------------------------------------------------------------------------

constexpr int F32_KC = 8;  // input channels a chunk: one k8 step of wgmma tf32
constexpr int B_PLANE = 9 * F32_KC * BLOCK_C * 4;  // one tf32 plane of a chunk's weights
constexpr int B_BYTES = 2 * B_PLANE;               // big and small
static_assert(BLOCK_C == 64, "the float32 body's wgmma is m64n64k8");

template <int TILE>
struct F32Geo {
  static constexpr int HALO = TILE + 2;
  static constexpr int NWG = TILE / 8;  // consumer warpgroups, 8 tile rows each
  static constexpr int MT = TILE / 8;   // m64 tiles (8 x 8 pixels) a warpgroup
  static constexpr int THREADS = NWG * 128 + 32;  // and the producer warp
  static constexpr int RING = TILE == TILE_BIG ? F32_STAGES_BIG : F32_STAGES_SMALL;
  static constexpr int X_BYTES = HALO * HALO * F32_KC * 4;  // the raw haloed chunk (TMA)
  static constexpr int STAGE_BYTES = X_BYTES + B_BYTES;
  static constexpr int ROWS = 10;                   // halo rows a warpgroup reads
  static constexpr int A_PLANE = ROWS * HALO * 16;  // 4 channels of them, 16 bytes a pixel
  static constexpr int A_BYTES = 2 * A_PLANE;       // the chunk's 8 channels, one tf32 part
  static constexpr int WG_BYTES = 2 * 2 * A_BYTES;  // two chunks (ping-pong) x big, small
  static constexpr int BAR_BYTES = 64;              // full[RING], empty[RING]
  // the ring, the warpgroups' planes, the mbarriers, 1024 to align the start
  static constexpr int SMEM_BYTES = RING * STAGE_BYTES + NWG * WG_BYTES + BAR_BYTES + 1024;
  static_assert(TILE % 8 == 0, "m64 tiles of 8 x 8 pixels");
  static_assert(X_BYTES % 128 == 0 && B_BYTES % 128 == 0 && A_BYTES % 128 == 0,
                "copy destinations stay 128-byte aligned");
  static_assert(RING >= 2 && 2 * RING * 8 <= BAR_BYTES, "the ring and its mbarriers");
  static_assert(SMEM_BYTES <= 232448, "one block's shared memory");
};

// The descriptor of a K-major operand in the no-swizzle layout: core
// matrices of 8 rows x 16 bytes (4 tf32), rows 16 bytes apart; `k_stride`
// bytes between the two 4-element k halves of a k8 step (the leading byte
// offset), `row_stride` bytes between 8-row groups (the stride byte offset).
__device__ __forceinline__ uint64_t desc_plain(const void* p, int k_stride, int row_stride) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t((k_stride >> 4) & 0x3FFF) << 16) |
         (uint64_t((row_stride >> 4) & 0x3FFF) << 32);
}

// d (64 x 64 float32, mma.sync's C layout by warp) = or += A (64 x 8 tf32 at
// `da`) * B (8 x 64 tf32, stored as the 64 rows of B^T, at `db`), both
// K-major in shared memory; scale_d 0 starts from zero, 1 adds.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8][4], uint64_t da, uint64_t db,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// The box of the input's tensor map at (channel c, column w, row h, image
// n), completing `bar` with its bytes (out-of-frame elements read as 0).
__device__ __forceinline__ void tma_x(void* dst, const CUtensorMap* map, int c, int w, int h,
                                      int n, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(c), "r"(w), "r"(h), "r"(n),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes global -> shared, completing `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The threads of consumer warpgroup `wg` wait for each other (named barrier
// 1 + wg; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// The 3xTF32 split of four values: big = tf32(v), small = tf32(v - big).
__device__ __forceinline__ void split4(const float4& v, float4& big, float4& small) {
  big.x = __uint_as_float(mma::tf32_rna(v.x));
  big.y = __uint_as_float(mma::tf32_rna(v.y));
  big.z = __uint_as_float(mma::tf32_rna(v.z));
  big.w = __uint_as_float(mma::tf32_rna(v.w));
  small.x = __uint_as_float(mma::tf32_rna(v.x - big.x));
  small.y = __uint_as_float(mma::tf32_rna(v.y - big.y));
  small.z = __uint_as_float(mma::tf32_rna(v.z - big.z));
  small.w = __uint_as_float(mma::tf32_rna(v.w - big.w));
}

// One warpgroup's split of a chunk: its 10 halo rows of the raw tile
// ([row][column][8 channels]) into the big and small planes ([4-channel
// half][row][column][4]); `wt` is the thread's index in the warpgroup.
template <int TILE>
__device__ __forceinline__ void split_chunk(const unsigned char* raw, unsigned char* big,
                                            unsigned char* small, int wt) {
  using G = F32Geo<TILE>;
  constexpr int PIX = G::ROWS * G::HALO;
#pragma unroll
  for (int k = 0; k < (2 * PIX + 127) / 128; ++k) {
    const int i = wt + 128 * k;
    if (i >= 2 * PIX) break;
    const int half = i >= PIX;
    const int p = i - half * PIX;
    const float4 v = *reinterpret_cast<const float4*>(raw + p * 32 + half * 16);
    float4 hi, lo;
    split4(v, hi, lo);
    *reinterpret_cast<float4*>(big + half * G::A_PLANE + p * 16) = hi;
    *reinterpret_cast<float4*>(small + half * G::A_PLANE + p * 16) = lo;
  }
}

// The weights as the float32 body reads them: for each (64-channel block
// nb, 8-channel chunk) a contiguous piece [plane: big, small][tap][k half
// kh][channel nn][4 k], element (ci = 8 chunk + 4 kh + e, co = 64 nb + nn),
// zero past Cin and Cout.  One thread an (nb, chunk, tap, kh, nn).
__global__ void __launch_bounds__(256)
fused_conv3x3_prep_weights_kernel(const float* __restrict__ w, float* __restrict__ wp, int Cin,
                                  int Cout, int n_chunks, int total) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const int nn = i % BLOCK_C;
  int r = i / BLOCK_C;
  const int kh = r % 2;
  r /= 2;
  const int tap = r % 9;
  r /= 9;
  const int chunk = r % n_chunks;
  const int nb = r / n_chunks;
  const int co = nb * BLOCK_C + nn;
  const int ci0 = chunk * F32_KC + kh * 4;
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int ci = ci0 + e;
    v[e] = co < Cout && ci < Cin ? w[((size_t)tap * Cin + ci) * Cout + co] : 0.f;
  }
  float4 hi, lo;
  split4(make_float4(v[0], v[1], v[2], v[3]), hi, lo);
  float* dst = wp + (size_t)(nb * n_chunks + chunk) * (B_BYTES / 4) +
               ((tap * 2 + kh) * BLOCK_C + nn) * 4;
  *reinterpret_cast<float4*>(dst) = hi;
  *reinterpret_cast<float4*>(dst + B_PLANE / 4) = lo;
}

// An input the TMA map cannot take as it is (Cin not a multiple of 8, as
// VGG's Cin = 3, or a pointer off 16 bytes) copied into the call's scratch:
// xs (pixels, Cx) with Cx = Cin rounded up to 8, the channels past Cin zero
// (fused_conv.py::staged_input is its plain version).  One thread an
// element of xs.
__global__ void __launch_bounds__(256)
fused_conv3x3_stage_input_kernel(const float* __restrict__ x, float* __restrict__ xs,
                                 long long total, int Cin, int Cx) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const long long p = i / Cx;
  const int c = (int)(i - p * Cx);
  xs[i] = c < Cin ? x[p * Cin + c] : 0.f;
}

// grid (tiles_h * tiles_w, ceil(Cout / BLOCK_C), batch), F32Geo<TILE>::THREADS
// threads, F32Geo<TILE>::SMEM_BYTES of dynamic shared memory; `tx` maps the
// input (C, W, H, N) with boxes (8, TILE + 2, TILE + 2, 1), `wp` holds the
// prepared weights.
template <int TILE>
__global__ void __launch_bounds__(F32Geo<TILE>::THREADS, TILE == TILE_BIG ? 1 : 2)
fused_conv3x3_f32_kernel(const __grid_constant__ CUtensorMap tx, const float* __restrict__ wp,
                         const float* __restrict__ b, float* __restrict__ y, int H, int W,
                         int Cout, int tiles_w, int n_chunks, int pool) {
  using G = F32Geo<TILE>;
  constexpr int MT = G::MT;
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  unsigned char* ring = aligned_smem(smem_dyn);  // stage s: raw x tile, then the weights
  unsigned char* planes = ring + G::RING * G::STAGE_BYTES;  // a warpgroup's A planes
  // full[s]: stage s has landed; empty[s]: every consumer warp is done with it
  uint64_t* full = reinterpret_cast<uint64_t*>(planes + G::NWG * G::WG_BYTES);
  uint64_t* empty = full + G::RING;

  const int tid = threadIdx.x;
  const int h0 = (blockIdx.x / tiles_w) * TILE;
  const int w0 = (blockIdx.x % tiles_w) * TILE;
  const int nb = blockIdx.y;
  const int n = blockIdx.z;

  if (tid == 0) {
    for (int s = 0; s < G::RING; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, G::NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are set up; no block-wide barrier after this

  if (tid >= G::NWG * 128) {  // the producer warp: one thread issues every copy
    if (tid == G::NWG * 128) {
      const float* wblock = wp + (size_t)nb * n_chunks * (B_BYTES / 4);
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % G::RING;
        if (c >= G::RING) mbar_wait(empty + s, (c / G::RING - 1) & 1);
        unsigned char* st = ring + s * G::STAGE_BYTES;
        mbar_expect(full + s, G::STAGE_BYTES);
        tma_x(st, &tx, c * F32_KC, w0 - 1, h0 - 1, n, full + s);
        bulk_copy(st + G::X_BYTES, wblock + (size_t)c * (B_BYTES / 4), B_BYTES, full + s);
      }
    }
    return;
  }

  // A consumer warpgroup: tile rows 8 wg .. 8 wg + 7, halo rows 8 wg .. + 9.
  const int wg = tid >> 7;
  const int wt = tid & 127;
  const int lane = tid & 31;
  unsigned char* mine = planes + wg * G::WG_BYTES;  // [chunk parity][big, small]
  const int raw_off = 8 * wg * G::HALO * F32_KC * 4;

  float acc[MT][8][4], part[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = part[mt][j][e] = 0.f;

  mbar_wait(full, 0);
  split_chunk<TILE>(ring + raw_off, mine, mine + G::A_BYTES, wt);
  mma::fence_async_shared();
  warpgroup_sync(wg);

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % G::RING;
    const unsigned char* st = ring + s * G::STAGE_BYTES;
    const unsigned char* a = mine + (c & 1) * 2 * G::A_BYTES;
    const uint64_t da_big = desc_plain(a, G::A_PLANE, G::HALO * 16);
    const uint64_t da_small = desc_plain(a + G::A_BYTES, G::A_PLANE, G::HALO * 16);
    const uint64_t db_big = desc_plain(st + G::X_BYTES, BLOCK_C * 16, 128);
    const uint64_t db_small = desc_plain(st + G::X_BYTES + B_PLANE, BLOCK_C * 16, 128);
    mma::wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const uint64_t bo = (uint64_t)(tap * 2 * BLOCK_C);  // tap * 2 * BLOCK_C * 16 bytes
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint64_t ao = (uint64_t)(dy * G::HALO + 8 * mt + dx);  // pixels of 16 bytes
        wgmma_tf32(part[mt], da_small + ao, db_big + bo, tap > 0);
        wgmma_tf32(part[mt], da_big + ao, db_small + bo, 1);
        wgmma_tf32(part[mt], da_big + ao, db_big + bo, 1);
      }
    }
    mma::wgmma_commit();
    if (c + 1 < n_chunks) {  // split the next chunk while the products run
      const int s1 = (c + 1) % G::RING;
      mbar_wait(full + s1, ((c + 1) / G::RING) & 1);
      unsigned char* nxt = mine + ((c + 1) & 1) * 2 * G::A_BYTES;
      split_chunk<TILE>(ring + s1 * G::STAGE_BYTES + raw_off, nxt, nxt + G::A_BYTES, wt);
      mma::fence_async_shared();
    }
    mma::wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_regs(part[mt]);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
    if (lane == 0) mbar_arrive(empty + s);  // this warp is done with stage s
    // the next chunk's planes are written; every warp's products of this
    // chunk are done, so the planes they read may be overwritten next
    warpgroup_sync(wg);
  }

  // Epilogue in registers: this thread holds pixels (row, col) and (row + 1,
  // col) of each m64 tile, channels 8 j + 2 t, + 1; lane 4 (g ^ 1) + t holds
  // the columns beside them.
  const int g = lane >> 2, t = lane & 3;
  const int row = h0 + 8 * wg + 2 * ((tid >> 5) & 3);
  const int Ho = H / 2, Wo = W / 2;
  const bool even = (Cout & 1) == 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cc = nb * BLOCK_C + 8 * j + 2 * t;
    const bool first = cc < Cout, second = cc + 1 < Cout;
    const bool pair = second && even;
    const float b0 = first ? b[cc] : 0.f;
    const float b1 = second ? b[cc + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int col = w0 + 8 * mt + g;
      if (pool) {  // uniform: every lane shuffles
        float v0 = fmaxf(acc[mt][j][0], acc[mt][j][2]);
        float v1 = fmaxf(acc[mt][j][1], acc[mt][j][3]);
        v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));
        v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
        const int ph = row >> 1, pw = col >> 1;
        if (first && (g & 1) == 0 && ph < Ho && pw < Wo)
          store2(y + (((size_t)n * Ho + ph) * Wo + pw) * Cout + cc, fmaxf(v0 + b0, 0.f),
                 fmaxf(v1 + b1, 0.f), pair, second);
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int hh = row + e;
          if (first && hh < H && col < W)
            store2(y + (((size_t)n * H + hh) * W + col) * Cout + cc,
                   fmaxf(acc[mt][j][2 * e] + b0, 0.f), fmaxf(acc[mt][j][2 * e + 1] + b1, 0.f),
                   pair, second);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int WARP_C = 32;                  // output channels a warp
constexpr int WARPS_N = BLOCK_C / WARP_C;   // warps across the channels
constexpr int N_TILES = WARP_C / 8;         // n8 tiles a warp
constexpr int PIX_BYTES = CHUNK_BYTES + 16; // a staged pixel: the chunk + pad
constexpr int W_ROW = BLOCK_C + 8;          // elements of a staged weight row
constexpr int W_BYTES = 9 * CHUNK_BYTES * W_ROW;  // 9 taps x chunk x W_ROW
constexpr int BF_KC = CHUNK_BYTES / 2;      // bf16 channels a chunk

static_assert(BLOCK_C % WARP_C == 0, "BLOCK_C must be a multiple of 32");
static_assert(CHUNK_BYTES == 32, "one chunk is one mma k-step: 16 bf16");
static_assert(STAGES >= 2, "the ring needs two stages at least");
static_assert((PIX_BYTES / 16) % 2 == 1, "pixel rows must fall in distinct bank groups");

template <int TILE>
struct Geo {
  static constexpr int HALO = TILE + 2;
  static constexpr int HW2 = HALO / 2;       // pixels of one column parity a row
  static constexpr int WIN = TILE / 2;       // 2x2 windows a tile row
  static constexpr int WARPS_M = WIN * WIN / 16;
  static constexpr int THREADS = WARPS_M * WARPS_N * 32;
  static constexpr int X_BYTES = HALO * HALO * PIX_BYTES;
  static constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
  static_assert(TILE % 4 == 0 && WIN * WIN % 16 == 0, "a warp owns 16 whole windows");
  static_assert(X_BYTES % 16 == 0, "the weight slice must stay 16-byte aligned");
};

// Slot of halo pixel (r, q): even and odd columns apart.
template <int TILE>
__device__ __forceinline__ int x_slot(int r, int q) {
  return (r * 2 + (q & 1)) * Geo<TILE>::HW2 + (q >> 1);
}

// Stage input channels ci0 .. ci0 + BF_KC - 1 of the haloed tile at (h0,
// w0) and the matching weight slice of channels c0 .. c0 + BLOCK_C - 1.
template <int TILE>
__device__ __forceinline__ void stage_chunk(char* sx, const __nv_bfloat16* __restrict__ xn,
                                            const __nv_bfloat16* __restrict__ w, int H, int W,
                                            int Cin, int Cout, int h0, int w0, int c0,
                                            int ci0, bool vec) {
  using G = Geo<TILE>;
  char* sw = sx + G::X_BYTES;
  if (vec) {  // 16-byte pieces; Cin and Cout are multiples of 8
    constexpr int EPP = 8;
    constexpr int XP = CHUNK_BYTES / 16;
    for (int i = threadIdx.x; i < G::HALO * G::HALO * XP; i += G::THREADS) {
      const int piece = i % XP;
      const int p = i / XP;
      const int r = p / G::HALO, q = p % G::HALO;
      const int hh = h0 - 1 + r, ww = w0 - 1 + q, ci = ci0 + piece * EPP;
      const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W && ci < Cin;
      const __nv_bfloat16* src = ok ? xn + ((size_t)hh * W + ww) * Cin + ci : xn;
      mma::cp_async16(sx + x_slot<TILE>(r, q) * PIX_BYTES + piece * 16, src, ok);
    }
    constexpr int WP = BLOCK_C / EPP;
    for (int i = threadIdx.x; i < 9 * BF_KC * WP; i += G::THREADS) {
      const int piece = i % WP;
      const int row = i / WP;  // tap * BF_KC + k
      const int ci = ci0 + row % BF_KC, co = c0 + piece * EPP;
      const bool ok = ci < Cin && co < Cout;
      const __nv_bfloat16* src = ok ? w + ((size_t)(row / BF_KC) * Cin + ci) * Cout + co : w;
      mma::cp_async16(sw + (row * W_ROW + piece * EPP) * 2, src, ok);
    }
  } else {  // element by element
    for (int i = threadIdx.x; i < G::HALO * G::HALO * BF_KC; i += G::THREADS) {
      const int c = i % BF_KC;
      const int p = i / BF_KC;
      const int r = p / G::HALO, q = p % G::HALO;
      const int hh = h0 - 1 + r, ww = w0 - 1 + q, ci = ci0 + c;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && ci < Cin)
        v = xn[((size_t)hh * W + ww) * Cin + ci];
      *reinterpret_cast<__nv_bfloat16*>(sx + x_slot<TILE>(r, q) * PIX_BYTES + c * 2) = v;
    }
    for (int i = threadIdx.x; i < 9 * BF_KC * BLOCK_C; i += G::THREADS) {
      const int co = i % BLOCK_C;
      const int row = i / BLOCK_C;
      const int ci = ci0 + row % BF_KC, cc = c0 + co;
      __nv_bfloat16 v = __float2bfloat16(0.f);
      if (ci < Cin && cc < Cout) v = w[((size_t)(row / BF_KC) * Cin + ci) * Cout + cc];
      *reinterpret_cast<__nv_bfloat16*>(sw + (row * W_ROW + co) * 2) = v;
    }
  }
}

// Byte offset, from the lane's own A row, of sub-pixel mt's row under tap
// (dy, dx): compile-time constants once the loops are unrolled.
template <int TILE>
__device__ __forceinline__ int a_shift(int mt, int dy, int dx) {
  const int e = (mt & 1) + dx;  // column offset from the window's left pixel
  return ((((mt >> 1) + dy) * 2 + (e & 1)) * Geo<TILE>::HW2 + (e >> 1)) * PIX_BYTES;
}

// One staged chunk's products, one m16n8k16 product a step.
template <int TILE>
__device__ __forceinline__ void chunk_products(float (&acc)[4][N_TILES][4], const char* xa,
                                               const char* wb) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    uint32_t bf[N_TILES][2];
#pragma unroll
    for (int p = 0; p < N_TILES / 2; ++p) {
      uint32_t r[4];
      mma::ldmatrix_x4_trans(r, wb + (tap * 16 * W_ROW + 16 * p) * 2);
      bf[2 * p][0] = r[0];
      bf[2 * p][1] = r[1];
      bf[2 * p + 1][0] = r[2];
      bf[2 * p + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t a[4];
      mma::ldmatrix_x4(a, xa + a_shift<TILE>(mt, dy, dx));
#pragma unroll
      for (int j = 0; j < N_TILES; ++j) mma::mma_bf16(acc[mt][j], a, bf[j][0], bf[j][1]);
    }
  }
}

// grid (tiles_h * tiles_w, ceil(Cout / BLOCK_C), batch), Geo<TILE>::THREADS
// threads, Geo<TILE>::SMEM_BYTES of dynamic shared memory.
template <int TILE>
__global__ void __launch_bounds__(Geo<TILE>::THREADS, 1)
fused_conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ y,
                          int H, int W, int Cin, int Cout, int tiles_w, int pool, int vec) {
  using G = Geo<TILE>;
  extern __shared__ __align__(128) char smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp % G::WARPS_M;
  const int warp_n = warp / G::WARPS_M;
  const int h0 = (blockIdx.x / tiles_w) * TILE;
  const int w0 = (blockIdx.x % tiles_w) * TILE;
  const int c0 = blockIdx.y * BLOCK_C;
  const int n = blockIdx.z;
  const __nv_bfloat16* xn = x + (size_t)n * H * W * Cin;

  // This lane's ldmatrix row: window warp_m * 16 + lane % 16 (its top-left
  // pixel), the k half lane / 16; its ldmatrix.trans rows of B.
  const int wa = warp_m * 16 + (lane & 15);
  const int a_off = x_slot<TILE>(2 * (wa / G::WIN), 2 * (wa % G::WIN)) * PIX_BYTES +
                    (lane >> 4) * 16;
  const int b_off = (mma::bkn_row(lane) * W_ROW + warp_n * WARP_C + mma::bkn_col(lane)) * 2;

  float acc[4][N_TILES][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < N_TILES; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;

  const int n_chunks = (Cin + BF_KC - 1) / BF_KC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks)
      stage_chunk<TILE>(smem + s * G::STAGE_BYTES, xn, w, H, W, Cin, Cout, h0, w0, c0,
                        s * BF_KC, vec);
    mma::cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
    const int next = c + STAGES - 1;
    if (next < n_chunks)
      stage_chunk<TILE>(smem + (next % STAGES) * G::STAGE_BYTES, xn, w, H, W, Cin, Cout, h0,
                        w0, c0, next * BF_KC, vec);
    mma::cp_async_commit();
    const char* sx = smem + (c % STAGES) * G::STAGE_BYTES;
    chunk_products<TILE>(acc, sx + a_off, sx + G::X_BYTES + b_off);
  }

  // Epilogue in registers: lane (g, t) holds windows g and g + 8 of its
  // warp, all four sub-pixels (mt), channels 2t, 2t + 1 of each n8 tile.
  const int g = lane >> 2, t = lane & 3;
  const int Ho = H / 2, Wo = W / 2;
  const bool even = (Cout & 1) == 0;
#pragma unroll
  for (int j = 0; j < N_TILES; ++j) {
    const int cc = c0 + warp_n * WARP_C + 8 * j + 2 * t;
    if (cc >= Cout) continue;
    const bool second = cc + 1 < Cout;
    const bool pair = second && even;
    const float b0 = __bfloat162float(b[cc]);
    const float b1 = second ? __bfloat162float(b[cc + 1]) : 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int win = warp_m * 16 + g + 8 * half;
      const int oh = h0 + 2 * (win / G::WIN);
      const int ow = w0 + 2 * (win % G::WIN);
      float v0[4], v1[4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        v0[mt] = fmaxf(acc[mt][j][2 * half] + b0, 0.f);
        v1[mt] = fmaxf(acc[mt][j][2 * half + 1] + b1, 0.f);
      }
      if (pool) {
        const int ph = oh / 2, pw = ow / 2;
        if (ph < Ho && pw < Wo)
          store2(y + (((size_t)n * Ho + ph) * Wo + pw) * Cout + cc,
                 fmaxf(fmaxf(v0[0], v0[1]), fmaxf(v0[2], v0[3])),
                 fmaxf(fmaxf(v1[0], v1[1]), fmaxf(v1[2], v1[3])), pair, second);
      } else {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int hh = oh + (mt >> 1), ww = ow + (mt & 1);
          if (hh < H && ww < W)
            store2(y + (((size_t)n * H + hh) * W + ww) * Cout + cc, v0[mt], v1[mt], pair,
                   second);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

struct Args {
  const void* x;
  const void* w;
  const void* b;
  void* y;
  void* scratch;  // float32: the prepared weights, then the staged input
  int B, H, W, Cin, Cout, pool, tiles_w, vec, stage;
  dim3 grid;
  cudaStream_t stream;
};

int prep_weights(const float* w, float* wp, int Cin, int Cout, int n_chunks,
                 cudaStream_t stream) {
  const int total = (Cout + BLOCK_C - 1) / BLOCK_C * n_chunks * 9 * 2 * BLOCK_C;
  fused_conv3x3_prep_weights_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      w, wp, Cin, Cout, n_chunks, total);
  return (int)cudaGetLastError();
}

// The TMA map of the (B, H, W, C) float32 input: boxes of 8 channels x
// (tile + 2) columns x (tile + 2) rows of one image, no swizzle; coordinates
// outside the tensor read as zeros.  Returns a CUDA error code.
int input_map(CUtensorMap* map, const void* x, int B, int H, int W, int C, int tile) {
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 4, (cuuint64_t)W * C * 4,
                                 (cuuint64_t)H * W * C * 4};
  const cuuint32_t box[4] = {(cuuint32_t)F32_KC, (cuuint32_t)tile + 2, (cuuint32_t)tile + 2, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(x), dims,
                        strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Floats of the prepared weights (fused_conv.py::prep_floats).
size_t prep_floats(int Cin, int Cout) {
  return (size_t)((Cout + BLOCK_C - 1) / BLOCK_C) * ((Cin + F32_KC - 1) / F32_KC) *
         (B_BYTES / 4);
}

// The weight prep, the input's staging when `a.stage`, and the conv, in
// stream order.
template <int TILE>
int launch_f32(const Args& a) {
  using G = F32Geo<TILE>;
  static bool smem_set[64];
  auto kern = fused_conv3x3_f32_kernel<TILE>;
  const cudaError_t e = mma::set_smem_once(kern, G::SMEM_BYTES, smem_set);
  if (e != cudaSuccess) return (int)e;
  const int n_chunks = (a.Cin + F32_KC - 1) / F32_KC;
  float* wp = static_cast<float*>(a.scratch);
  int err = prep_weights(static_cast<const float*>(a.w), wp, a.Cin, a.Cout, n_chunks, a.stream);
  if (err != 0) return err;
  const void* x = a.x;
  if (a.stage) {
    float* xs = wp + prep_floats(a.Cin, a.Cout);
    const long long total = (long long)a.B * a.H * a.W * n_chunks * F32_KC;
    fused_conv3x3_stage_input_kernel<<<(unsigned)((total + 255) / 256), 256, 0, a.stream>>>(
        static_cast<const float*>(a.x), xs, total, a.Cin, n_chunks * F32_KC);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
    x = xs;
  }
  CUtensorMap tx;
  err = input_map(&tx, x, a.B, a.H, a.W, n_chunks * F32_KC, TILE);
  if (err != 0) return err;
  kern<<<a.grid, G::THREADS, G::SMEM_BYTES, a.stream>>>(
      tx, wp, static_cast<const float*>(a.b), static_cast<float*>(a.y), a.H, a.W, a.Cout,
      a.tiles_w, n_chunks, a.pool);
  return (int)cudaGetLastError();
}

template <int TILE>
int launch_bf16(const Args& a) {
  using G = Geo<TILE>;
  static bool smem_set[64];
  auto kern = fused_conv3x3_bf16_kernel<TILE>;
  const cudaError_t err = mma::set_smem_once(kern, G::SMEM_BYTES, smem_set);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.grid, G::THREADS, G::SMEM_BYTES, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const __nv_bfloat16*>(a.w),
      static_cast<const __nv_bfloat16*>(a.b), static_cast<__nv_bfloat16*>(a.y), a.H, a.W,
      a.Cin, a.Cout, a.tiles_w, a.pool, a.vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Threads and dynamic shared memory (bytes) of a block at `tile` for dtype
// 0 (float32) or 1 (bfloat16), or -1 for one this library was not built for.
extern "C" int fused_conv3x3_threads(int tile, int dtype) {
  if (dtype == 0 && tile == TILE_BIG) return F32Geo<TILE_BIG>::THREADS;
  if (dtype == 0 && tile == TILE_SMALL) return F32Geo<TILE_SMALL>::THREADS;
  if (dtype == 1 && tile == TILE_BIG) return Geo<TILE_BIG>::THREADS;
  if (dtype == 1 && tile == TILE_SMALL) return Geo<TILE_SMALL>::THREADS;
  return -1;
}

extern "C" int fused_conv3x3_smem_bytes(int tile, int dtype) {
  if (dtype == 0 && tile == TILE_BIG) return F32Geo<TILE_BIG>::SMEM_BYTES;
  if (dtype == 0 && tile == TILE_SMALL) return F32Geo<TILE_SMALL>::SMEM_BYTES;
  if (dtype == 1 && tile == TILE_BIG) return Geo<TILE_BIG>::SMEM_BYTES;
  if (dtype == 1 && tile == TILE_SMALL) return Geo<TILE_SMALL>::SMEM_BYTES;
  return -1;
}

// The float32 body's weight preparation alone (fused_conv.py::prep_weights):
// w (3, 3, Cin, Cout) float32 into wp, ceil(Cout / 64) x ceil(Cin / 8) x
// 9,216 floats.  Returns the CUDA error code of the launch.
extern "C" int fused_conv3x3_prep_weights(const void* w, void* wp, int Cin, int Cout,
                                          void* stream) {
  return prep_weights(static_cast<const float*>(w), static_cast<float*>(wp), Cin, Cout,
                      (Cin + F32_KC - 1) / F32_KC, static_cast<cudaStream_t>(stream));
}

// C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16 (x, w,
// b and y share it).  The caller passes the tile, the grid and the
// shared-memory size it computed (a size that disagrees with this build's
// is refused).  float32: `scratch` holds prep_floats(Cin, Cout) floats for
// the prepared weights and, with `stage` 1, B x H x W x (Cin rounded up to
// 8) more for the staged input; with `stage` 0, x must be 16-byte aligned
// and Cin a multiple of 8 (fused_conv.py::tma_ready).  bfloat16: `scratch`
// and `stage` unused, `vec` 1 when x and w are 16-byte aligned and their
// Cin and Cout rows whole 16-byte pieces.  Returns the CUDA error code of
// the launch (0 on success).
extern "C" int fused_conv3x3_launch(const void* x, const void* w, const void* b, void* y,
                                    void* scratch, int H, int W, int Cin, int Cout, int pool,
                                    int dtype, int tile, int grid_x, int grid_y, int grid_z,
                                    int tiles_w, int smem_bytes, int vec, int stage,
                                    void* stream) {
  if (smem_bytes != fused_conv3x3_smem_bytes(tile, dtype)) return (int)cudaErrorInvalidValue;
  const Args a{x,       w,    b,     y,   scratch, grid_z, H, W, Cin, Cout, pool,
               tiles_w, vec,  stage, dim3(grid_x, grid_y, grid_z),
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    if (scratch == nullptr ||
        (!stage && (Cin % F32_KC != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
      return (int)cudaErrorInvalidValue;
    if (tile == TILE_BIG) return launch_f32<TILE_BIG>(a);
    if (tile == TILE_SMALL) return launch_f32<TILE_SMALL>(a);
  }
  if (dtype == 1) {
    if (tile == TILE_BIG) return launch_bf16<TILE_BIG>(a);
    if (tile == TILE_SMALL) return launch_bf16<TILE_SMALL>(a);
  }
  return (int)cudaErrorInvalidValue;
}
