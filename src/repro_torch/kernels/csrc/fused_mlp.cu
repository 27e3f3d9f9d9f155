// Fused MLP for Hopper (sm_90a): act(x @ w1) [* (x @ w3)] @ w2 in one
// kernel, x (T, d), w1/w3 (d, ff), w2 (ff, d), bfloat16 on the tensor
// cores or float32 on the CUDA cores, for act = swiglu, geglu, gelu (tanh
// form) and relu.
//
// Replaces: src/repro/kernels/fused_mlp.py::fused_mlp, the Pallas TPU
// kernel (`_kernel`, launched by `pl.pallas_call`).  What it keeps is the
// fusion group's guarantee: the (T, ff) hidden frame never reaches device
// memory, it exists only as one (BLOCK_M, BLOCK_F) tile on chip.  What it
// cannot keep is the TPU layout: the Pallas kernel holds a (block_m, d)
// float32 accumulator across its sequential d_ff loop, and at block_m 128,
// d 1024 that is 512 KB, more than the 227 KB a Hopper block has, and
// Hopper blocks do not run in sequence anyway.
//
// Layout, both bodies: split d_ff across blocks.  Block (im, jf) computes
// the hidden tile h = act(x[im] @ w1[:, jf]) [* (x[im] @ w3[:, jf])] for
// its BLOCK_M rows and BLOCK_F hidden units (the first products stream d),
// multiplies it by the (BLOCK_F, d) slice of w2 (streamed by columns), and
// adds the partial (BLOCK_M, d) product into a float32 (T, d) buffer with
// atomics.  The buffer is zeroed before and, for bfloat16, rounded into the
// output after (both inside fused_mlp_launch, one call).
//   FLOPs: exactly the function's, 2 T d ff (x2 when gated) + 2 T ff d; no
//   product is recomputed (tiling the output columns instead would redo
//   the first products d / BN times).
//   Bytes: x is read once per hidden tile (ff / BLOCK_F times, from L2
//   mostly), the weights once per row block (T / BLOCK_M times), and
//   T d (ff / BLOCK_F) float32 sums go to L2 as atomics; the (T, d)
//   float32 buffer is the only extra device memory, 4 T d bytes, below the
//   2 T ff bytes of a bfloat16 hidden frame whenever ff > 2 d (qwen3:
//   16.8 MB vs 25.2 MB at T = 4096).
//   Order: the ff / BLOCK_F partial sums arrive in whatever order the
//   blocks finish, so float32 results can differ between runs in their
//   last bits, and a bfloat16 output by one unit in the last place; the
//   tolerances (tests/test_kernels.py's 10x: 2e-4 and 2e-1) cover it.
//
// What bounds it: at prefill (T = 4096, d 1024, ff 3072) hundreds of flops
// per byte, so the tensor cores; at decode (T = 8) it reads 3 d ff weights
// for 6 T d ff flops, so the memory.
//
// bfloat16 bodies (fused_mlp_mma_prefill_kernel, fused_mlp_mma_decode_kernel):
// bf16 products summed in float32 on the tensor cores.
//  - Prefill tiles (BLOCK_M 64 or 128, BLOCK_F 128 or 256): wgmma.  One
//    warpgroup (4 warps) a 64 rows.  The first products run in passes of
//    128 hidden units (x is streamed once a pass; BLOCK_F 256 halves the
//    partial sums of the cross-block sum): wgmma m64n128k16 with A (x) and
//    B (w1, w3) read by the tensor cores from shared memory, staged by
//    cp.async in 128-byte-swizzled canonical layouts (x K-major, the
//    weights MN-major, transposed in the instruction), 64 d-rows a stage,
//    one stage's products left running while the next stage is set up.
//    The activation runs on the float32 accumulators, and h is rounded to
//    bf16 and packed into A fragments in registers (mma_bf16.cuh pack_a):
//    the hidden tile never goes to shared memory.  The second product is
//    wgmma m64n64k16 with A = h from registers and B = a 64-column w2
//    slice, then that slice's atomics.
//  - The activation of the bf16 bodies uses the fast intrinsics (__expf,
//    __fdividef), resolved once per tile, not per element: h is rounded to
//    bf16 right after, and their ~1e-6 relative error is far below that
//    rounding's 2^-9.
//  - Decode tiles (BLOCK_M 16, KS = 8): mma.sync m16n8k16.  A warp owns 16
//    rows and the whole hidden tile; the 8 warps split d in the first
//    products and sum their float32 partials through shared memory (a few
//    KB), then each holds the whole h in registers (rounded and packed into
//    A fragments) and takes its own columns of the second product.
//    BLOCK_F 16 or 32 gives 192 or 96 blocks at qwen3's d_ff to stream the
//    weights; the 8 rows are padded to the mma's 16 (zero-filled, never
//    stored).  Tiles arrive by 16-byte cp.async through one ring of STAGES
//    buffers that runs on from the first products into the second; rows
//    are padded by 16 bytes so that ldmatrix has no bank conflicts, and w1,
//    w3 and w2, (k, n) row-major, are read with ldmatrix.trans.
//  - The cross-block sum: lanes 2i and 2i+1 swap halves of their C
//    fragments with one shuffle, so each holds four neighbouring columns of
//    one row, added with one float4 atomicAdd (a vector red on sm_90):
//    a quarter of the L2 atomic operations of scalar adds.
//  - Numerics: the products are exact in float32 and summed in float32, as
//    the TPU kernel's are; h is rounded to bf16 (relative error <= 2^-9
//    per element) before the second product, as the cuBLAS yardstick's bf16
//    (T, ff) frame is.  An output moves by at most 2^-9 sum_f |h_f w2[f, n]|:
//    at qwen3's shapes with unit-scale inputs (w ~ N(0, 1 / fan_in)) that
//    sum is about 18, so at most 0.035 and in expectation ~1e-3, inside
//    the bf16 tolerance 2e-1 (atol and rtol); tests/test_torch_attention_mlp.py
//    holds an emulation of this rounding to the TPU kernel.
//  - bf16 rows must be 16-byte aligned: d and ff multiples of 8 (the
//    wrapper checks).
//
// float32 body (fused_mlp_f32_kernel): float32 FMAs on the CUDA cores,
// since TF32 would miss the 2e-4 float32 tolerance.  256 threads = 16 row
// groups (ty) x 16 column groups (tx); thread (ty, tx) owns rows ty + 16 i
// and hidden units tx + 16 j of the hidden tile, kept in shared memory,
// then rows ty + 16 i and output columns tx + 16 e of each BN pass; scalar
// atomicAdd.
//
// Build (see fused_mlp.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -O3 -shared -Xcompiler -fPIC.  The (BLOCK_M, BLOCK_F) tiles built are
// listed in FOR_EACH_TILE below and in fused_mlp.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

enum Act { SWIGLU = 0, GEGLU = 1, GELU = 2, RELU = 3 };

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu's default (approximate=True) form
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float activate(float a, float g, int act) {
  if (act == SWIGLU) return silu(a) * g;
  if (act == GEGLU) return gelu_tanh(a) * g;
  if (act == GELU) return gelu_tanh(a);
  return fmaxf(a, 0.f);
}

// The activation of the bf16 bodies, with the fast intrinsics: h is rounded
// to bf16 (relative error 2^-9) right after, far above their ~1e-6.
template <int ACT>
__device__ __forceinline__ float activate_fast(float a, float g) {
  if (ACT == RELU) return fmaxf(a, 0.f);
  if (ACT == SWIGLU) return __fdividef(a, 1.f + __expf(-a)) * g;
  const float u = 0.7978845608028654f * (a + 0.044715f * a * a * a);
  const float gl = 0.5f * a * (2.f - __fdividef(2.f, 1.f + __expf(2.f * u)));  // a (1 + tanh u) / 2
  return ACT == GEGLU ? gl * g : gl;
}

// h1 = act(h1, h3) over a fragment array, the act resolved once.
template <int N>
__device__ __forceinline__ void activate_all(float (&h1)[N][4], const float (&h3)[N][4],
                                             int act) {
#define ACTIVATE(ACT_)                                                \
  for (int j = 0; j < N; ++j)                                         \
    for (int e = 0; e < 4; ++e) h1[j][e] = activate_fast<ACT_>(h1[j][e], h3[j][e]);
  if (act == SWIGLU) {
#pragma unroll
    ACTIVATE(SWIGLU)
  } else if (act == GEGLU) {
#pragma unroll
    ACTIVATE(GEGLU)
  } else if (act == GELU) {
#pragma unroll
    ACTIVATE(GELU)
  } else {
#pragma unroll
    ACTIVATE(RELU)
  }
#undef ACTIVATE
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

// Decode tiles (BLOCK_M 16): every warp holds the 16 rows and the whole
// hidden tile; the KS warps split d in the first products and the output
// columns in the second.
template <int BM, int BF>
struct DecodeTiles {
  static constexpr bool WGMMA = false;
  static constexpr int KS = 8;  // warps
  static constexpr int NTHREADS = KS * 32;
  static constexpr int KTW = 16;       // d rows a warp takes per stage
  static constexpr int KT = KTW * KS;  // d rows per stage
  static constexpr int NCW = 32;       // output columns a warp takes per stage
  static constexpr int NC = NCW * KS;  // output columns per stage
  static constexpr int HB = BF;        // hidden units a pass of the first products
  static constexpr int PASSES = 1;
  static constexpr int XLD = KT + 8;   // row strides (bf16), padded 16 bytes
  static constexpr int WLD = BF + 8;
  static constexpr int W2LD = NC + 8;
  static constexpr int P1_ELEMS = BM * XLD + 2 * KT * WLD;  // x, w1, w3 slices
  static constexpr int P2_ELEMS = BF * W2LD;                // w2 slice
  static constexpr int STAGE_BYTES = 2 * (P1_ELEMS > P2_ELEMS ? P1_ELEMS : P2_ELEMS);
  static constexpr int EXTRA_BYTES = KS * BF * 32 * 4;  // split-d partials
  static constexpr int STAGES = 4 * STAGE_BYTES + EXTRA_BYTES <= 200 * 1024 ? 4 : 3;
  static constexpr int AHEAD = STAGES - 1;  // tiles the ring loads ahead
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + EXTRA_BYTES;
  static_assert(BM == 16 && BF % 16 == 0, "decode tiles");
  static_assert(STAGE_BYTES % 16 == 0, "stages stay 16-byte aligned");
};

// Prefill tiles (BLOCK_M 64 or 128, BLOCK_F 128 or 256): one warpgroup
// (4 warps) a 64 rows; wgmma products with A = x from shared memory, then
// A = h from registers, and B = w1, w3, then w2 from shared memory.  The
// first products run in passes of HB = 128 hidden units (x is streamed
// once a pass), the second in NC-column slices.
template <int BM, int BF>
struct PrefillTiles {
  static constexpr bool WGMMA = true;
  static constexpr int HB = 128;      // hidden units a pass of the first products
  static constexpr int PASSES = BF / HB;
  static constexpr int WARPS = BM / 16;
  static constexpr int NTHREADS = WARPS * 32;
  static constexpr int KT = 64;  // d rows per stage: one 128-byte swizzle atom of x
  static constexpr int NC = 64;  // output columns per stage (wgmma N)
  // 128-byte-swizzled canonical layouts: x K-major, w1 / w3 and w2 MN-major
  // (k = d, then the hidden unit); atoms 8 rows apart 1024 bytes, w1 / w3's
  // two 64-column halves W_LBO apart.
  static constexpr int W_LBO = KT / 8 * 1024;
  static constexpr int X_BYTES = BM * KT * 2;
  static constexpr int W_BYTES = KT * HB * 2;
  static constexpr int P1_BYTES = X_BYTES + 2 * W_BYTES;
  static constexpr int P2_BYTES = BF * NC * 2;
  static constexpr int STAGE_BYTES = P1_BYTES > P2_BYTES ? P1_BYTES : P2_BYTES;
  static constexpr int STAGES = 4;  // two tiles loading, one being multiplied, one in wgmma
  static constexpr int AHEAD = STAGES - 2;  // tiles the ring loads ahead
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + the 1024-byte alignment
  static_assert(BM % 64 == 0 && BF % HB == 0 && WARPS <= 8, "prefill tiles");
  static_assert(SMEM_BYTES <= 227 * 1024, "one block's shared memory");
  static_assert(X_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0, "atom-aligned tiles");
};

template <int BM, int BF>
using MmaTiles = std::conditional_t<(BM == 16), DecodeTiles<BM, BF>, PrefillTiles<BM, BF>>;

// cp.async of ROWS x (COLCH 16-byte chunks) of a row-major matrix (row
// stride `ld` elements, rows from `row0`, columns from `col0`, `nrows` and
// `ncols` valid; the rest zero-filled) into a 128-byte-swizzled canonical
// tile at the 1024-byte-aligned `dst`: row r is a 128-byte row of atom
// r / 8, 64 columns a block, blocks `blk` bytes apart.  A warp's 32 copies
// cover four 128-byte rows, in global and in shared memory, so neither
// side conflicts.
template <int ROWS, int COLCH, int NTHREADS>
__device__ __forceinline__ void load_sw128(unsigned char* dst, const __nv_bfloat16* src,
                                           size_t ld, int row0, int col0, int nrows,
                                           int ncols, int blk, int tid) {
  for (int c = tid; c < ROWS * COLCH; c += NTHREADS) {
    const int r = c / COLCH, cb = c % COLCH;
    const bool in = row0 + r < nrows && col0 + cb * 8 < ncols;
    const int lin = (r >> 3) * 1024 + (r & 7) * 128 + (cb & 7) * 16 + (cb >> 3) * blk;
    mma::cp_async16(dst + mma::swizzle128(lin),
                    in ? src + (size_t)(row0 + r) * ld + col0 + cb * 8 : src, in);
  }
}

// cp.async of tile i of a block's sequence into the stage at `base`: tiles
// 0..PASSES * n1 - 1 are the (x, w1, w3) slices of KT d-rows of the first
// products (n1 a pass, the pass's HB hidden units), the rest the (BF, NC)
// w2 slices of the second; whatever lies past T, d or ff is zero-filled.
// The decode body reads x and the weights with ldmatrix from row-major
// tiles with padded rows; the prefill body's wgmma reads them from the
// 128-byte-swizzled canonical layouts.
template <typename TL, int BM, int BF>
__device__ __forceinline__ void load_tile(
    __nv_bfloat16* base, int i, int n1, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w1, const __nv_bfloat16* __restrict__ w3,
    const __nv_bfloat16* __restrict__ w2, int m0, int f0, int n_rows, int d,
    int ff, bool gated, int tid) {
  if (i < TL::PASSES * n1) {
    const int d0 = (i % n1) * TL::KT;
    const int fp = f0 + (i / n1) * TL::HB;  // the pass's hidden units
    if constexpr (TL::WGMMA) {
      unsigned char* sx = reinterpret_cast<unsigned char*>(base);
      unsigned char* s1 = sx + TL::X_BYTES;
      load_sw128<BM, TL::KT / 8, TL::NTHREADS>(sx, x, d, m0, d0, n_rows, d, 0, tid);
      load_sw128<TL::KT, TL::HB / 8, TL::NTHREADS>(s1, w1, ff, d0, fp, d, ff, TL::W_LBO, tid);
      if (gated)
        load_sw128<TL::KT, TL::HB / 8, TL::NTHREADS>(s1 + TL::W_BYTES, w3, ff, d0, fp, d, ff,
                                                     TL::W_LBO, tid);
    } else {
      constexpr int XCH = TL::KT / 8;
      for (int c = tid; c < BM * XCH; c += TL::NTHREADS) {
        const int r = c / XCH, col = (c % XCH) * 8;
        const bool in = m0 + r < n_rows && d0 + col < d;
        mma::cp_async16(base + r * TL::XLD + col,
                        in ? x + (size_t)(m0 + r) * d + d0 + col : x, in);
      }
      constexpr int WCH = TL::HB / 8;
      __nv_bfloat16* s1 = base + BM * TL::XLD;
      __nv_bfloat16* s3 = s1 + TL::KT * TL::WLD;
      for (int c = tid; c < TL::KT * WCH; c += TL::NTHREADS) {
        const int r = c / WCH, col = (c % WCH) * 8;
        const bool in = d0 + r < d && fp + col < ff;
        const size_t off = (size_t)(d0 + r) * ff + fp + col;
        mma::cp_async16(s1 + r * TL::WLD + col, in ? w1 + off : w1, in);
        if (gated) mma::cp_async16(s3 + r * TL::WLD + col, in ? w3 + off : w3, in);
      }
    }
  } else {
    const int n0 = (i - TL::PASSES * n1) * TL::NC;
    if constexpr (TL::WGMMA) {
      load_sw128<BF, TL::NC / 8, TL::NTHREADS>(reinterpret_cast<unsigned char*>(base), w2, d,
                                               f0, n0, ff, d, 0, tid);
    } else {
      constexpr int CH = TL::NC / 8;
      for (int c = tid; c < BF * CH; c += TL::NTHREADS) {
        const int r = c / CH, col = (c % CH) * 8;
        const bool in = f0 + r < ff && n0 + col < d;
        mma::cp_async16(base + r * TL::W2LD + col,
                        in ? w2 + (size_t)(f0 + r) * d + n0 + col : w2, in);
      }
    }
  }
}

// The ring over a block's tile sequence, one step: wait for tile i, then
// refill with tile i + AHEAD the stage that tile i + AHEAD - STAGES used.
// AHEAD is STAGES - 1 when a step's products are done at its end (mma.sync:
// that stage is tile i - 1's, freed by the barrier), STAGES - 2 when one
// step's wgmma may still run during the next (tile i - 2's stage, whose
// products the previous step waited for).  Returns tile i's stage.
template <typename TL, int BM, int BF>
__device__ __forceinline__ const __nv_bfloat16* ring_step(
    unsigned char* smem, int i, int n1, int n_tiles,
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
    const __nv_bfloat16* __restrict__ w3, const __nv_bfloat16* __restrict__ w2,
    int m0, int f0, int n_rows, int d, int ff, bool gated, int tid) {
  mma::cp_async_wait<TL::AHEAD - 1>();  // tile i has landed (this thread's part)
  if constexpr (TL::WGMMA) mma::fence_async_shared();  // visible to wgmma's reads
  __syncthreads();                        // ... and every thread's
  const int nxt = i + TL::AHEAD;
  if (nxt < n_tiles)
    load_tile<TL, BM, BF>(
        reinterpret_cast<__nv_bfloat16*>(smem + (nxt % TL::STAGES) * TL::STAGE_BYTES),
        nxt, n1, x, w1, w3, w2, m0, f0, n_rows, d, ff, gated, tid);
  mma::cp_async_commit();
  return reinterpret_cast<const __nv_bfloat16*>(smem + (i % TL::STAGES) * TL::STAGE_BYTES);
}

// Add the C fragments of one 16 x 8 tile (rows row0 and row0 + 8, columns
// col0 + 2t, +1) into the float32 (T, d) buffer: lanes t and t ^ 1 swap
// halves with one shuffle, so the even one holds row0, columns col0 + 2t ..
// +3 and the odd one row0 + 8, columns col0 + 2t - 2 .. + 1: one float4
// atomicAdd each, a vector reduction on sm_90.
__device__ __forceinline__ void add_fragment(float* __restrict__ out, const float (&c)[4],
                                             int row0, int col0, int t, int n_rows, int d) {
  const bool odd = t & 1;
  const float s0 = odd ? c[0] : c[2];
  const float s1 = odd ? c[1] : c[3];
  const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
  const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  const float4 val = odd ? make_float4(r0, r1, c[2], c[3]) : make_float4(c[0], c[1], r0, r1);
  const int row = odd ? row0 + 8 : row0;
  const int col = col0 + 2 * t - (odd ? 2 : 0);
  // d % 8 == 0 and col % 4 == 0: the four columns are all in or all out
  if (row < n_rows && col < d)
    atomicAdd(reinterpret_cast<float4*>(out + (size_t)row * d + col), val);
}

template <int BM, int BF, bool GATED>
__global__ void __launch_bounds__(DecodeTiles<BM, BF>::NTHREADS)
fused_mlp_mma_decode_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w1,
                            const __nv_bfloat16* __restrict__ w3,
                            const __nv_bfloat16* __restrict__ w2,
                            float* __restrict__ out, int n_rows, int d, int ff, int act) {
  using TL = DecodeTiles<BM, BF>;
  constexpr int NT_H = BF / 8;    // n-tiles of the hidden tile
  constexpr int KC_H = BF / 16;   // k-chunks of the second product
  constexpr int NT_O = TL::NCW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw + TL::STAGES * TL::STAGE_BYTES);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ks = warp;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * BF;
  constexpr bool gated = GATED;  // a template parameter: no branch in the loops
  const int n1 = (d + TL::KT - 1) / TL::KT;  // tiles of the first products
  const int n_tiles = n1 + (d + TL::NC - 1) / TL::NC;

#pragma unroll
  for (int i = 0; i < TL::AHEAD; ++i) {
    if (i < n_tiles)
      load_tile<TL, BM, BF>(reinterpret_cast<__nv_bfloat16*>(smem_raw + i * TL::STAGE_BYTES),
                            i, n1, x, w1, w3, w2, m0, f0, n_rows, d, ff, gated, tid);
    mma::cp_async_commit();
  }

  // The first products, this warp's d rows of each slice: h1 (and h3) +=
  // x[:, slice] @ w1[slice, :] (w3).
  float h1[NT_H][4], h3[NT_H][4];
#pragma unroll
  for (int j = 0; j < NT_H; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h1[j][e] = 0.f;
      h3[j][e] = 0.f;
    }
  for (int i = 0; i < n1; ++i) {
    const __nv_bfloat16* sx = ring_step<TL, BM, BF>(smem_raw, i, n1, n_tiles, x, w1, w3, w2,
                                                    m0, f0, n_rows, d, ff, gated, tid);
    const __nv_bfloat16* s1 = sx + BM * TL::XLD;
    const __nv_bfloat16* s3 = s1 + TL::KT * TL::WLD;
    const int kr = ks * TL::KTW;
    uint32_t xa[4];
    mma::ldmatrix_x4(xa, sx + mma::a_row(lane) * TL::XLD + kr + mma::a_col(lane));
#pragma unroll
    for (int np = 0; np < NT_H / 2; ++np) {
      const int off = (kr + mma::bkn_row(lane)) * TL::WLD + np * 16 + mma::bkn_col(lane);
      uint32_t b[4];
      mma::ldmatrix_x4_trans(b, s1 + off);
      mma::mma_bf16(h1[2 * np], xa, b[0], b[1]);
      mma::mma_bf16(h1[2 * np + 1], xa, b[2], b[3]);
      if (gated) {
        mma::ldmatrix_x4_trans(b, s3 + off);
        mma::mma_bf16(h3[2 * np], xa, b[0], b[1]);
        mma::mma_bf16(h3[2 * np + 1], xa, b[2], b[3]);
      }
    }
  }

  // Sum the KS warps' partials of each row group through shared memory;
  // every warp then holds the whole hidden tile of its rows, activates it
  // and rounds it into the A fragments of the second product.
  float* mine = red + (size_t)warp * BF * 32 + lane;
#pragma unroll
  for (int j = 0; j < NT_H; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mine[(j * 4 + e) * 32] = h1[j][e];
      mine[(BF / 2 + j * 4 + e) * 32] = h3[j][e];
    }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NT_H; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a = 0.f, c = 0.f;
#pragma unroll
      for (int w = 0; w < TL::KS; ++w) {
        const float* part = red + (size_t)w * BF * 32 + lane;
        a += part[(j * 4 + e) * 32];
        c += part[(BF / 2 + j * 4 + e) * 32];
      }
      h1[j][e] = a;
      h3[j][e] = c;
    }
  activate_all(h1, h3, act);
  uint32_t hf[KC_H][4];
#pragma unroll
  for (int kc = 0; kc < KC_H; ++kc) mma::pack_a(hf[kc], h1[2 * kc], h1[2 * kc + 1]);

  // The second product: this warp's columns of each w2 slice.
  for (int i = n1; i < n_tiles; ++i) {
    const __nv_bfloat16* sw2 = ring_step<TL, BM, BF>(smem_raw, i, n1, n_tiles, x, w1, w3, w2,
                                                     m0, f0, n_rows, d, ff, gated, tid);
    const int n0 = (i - n1) * TL::NC + ks * TL::NCW;
    float o[NT_O][4];
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC_H; ++kc)
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        uint32_t b[4];
        mma::ldmatrix_x4_trans(b, sw2 + (kc * 16 + mma::bkn_row(lane)) * TL::W2LD +
                                      ks * TL::NCW + np * 16 + mma::bkn_col(lane));
        mma::mma_bf16(o[2 * np], hf[kc], b[0], b[1]);
        mma::mma_bf16(o[2 * np + 1], hf[kc], b[2], b[3]);
      }
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
      add_fragment(out, o[j], m0 + g, n0 + j * 8, t, n_rows, d);
  }
  mma::cp_async_wait<0>();
}

template <int BM, int BF, bool GATED>
__global__ void __launch_bounds__(PrefillTiles<BM, BF>::NTHREADS)
fused_mlp_mma_prefill_kernel(const __nv_bfloat16* __restrict__ x,
                             const __nv_bfloat16* __restrict__ w1,
                             const __nv_bfloat16* __restrict__ w3,
                             const __nv_bfloat16* __restrict__ w2,
                             float* __restrict__ out, int n_rows, int d, int ff, int act) {
  using TL = PrefillTiles<BM, BF>;
  constexpr int NT_H = TL::HB / 8;  // n-tiles of a pass (wgmma N = 128)
  constexpr int KC_P = TL::HB / 16;  // k-chunks of the second product a pass gives
  constexpr int NT_O = TL::NC / 8;   // n-tiles of a w2 slice (wgmma N = 64)
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  // the swizzle atoms need 1024-byte alignment
  const unsigned misalign = static_cast<unsigned>(__cvta_generic_to_shared(smem_dyn)) & 1023;
  unsigned char* smem_raw = smem_dyn + ((1024 - misalign) & 1023);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // warpgroup warp / 4; the warp's 16 rows: warp * 16 ..
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * BF;
  constexpr bool gated = GATED;  // a template parameter: no branch in the loops
  const int n1 = (d + TL::KT - 1) / TL::KT;  // tiles of a pass of the first products
  const int n_tiles = TL::PASSES * n1 + (d + TL::NC - 1) / TL::NC;

#pragma unroll
  for (int i = 0; i < TL::AHEAD; ++i) {
    if (i < n_tiles)
      load_tile<TL, BM, BF>(reinterpret_cast<__nv_bfloat16*>(smem_raw + i * TL::STAGE_BYTES),
                            i, n1, x, w1, w3, w2, m0, f0, n_rows, d, ff, gated, tid);
    mma::cp_async_commit();
  }

  // The first products, a pass at a time: the warpgroup's 64 rows x 128
  // hidden units of h1 (and h3), then h = act(h1, h3) rounded to bf16 into
  // A fragments (this warp's 16 rows), kept in registers.
  uint32_t hf[TL::PASSES][KC_P][4];
#pragma unroll
  for (int pass = 0; pass < TL::PASSES; ++pass) {
    float h1[NT_H][4], h3[NT_H][4];
#pragma unroll
    for (int j = 0; j < NT_H; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h1[j][e] = 0.f;
        h3[j][e] = 0.f;
      }
    for (int i = pass * n1; i < (pass + 1) * n1; ++i) {
      const unsigned char* sx = reinterpret_cast<const unsigned char*>(ring_step<TL, BM, BF>(
          smem_raw, i, n1, n_tiles, x, w1, w3, w2, m0, f0, n_rows, d, ff, gated, tid));
      const unsigned char* sa = sx + (warp / 4) * 8 * 1024;  // the warpgroup's 64 rows
      const unsigned char* s1 = sx + TL::X_BYTES;
      mma::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TL::KT / 16; ++kk) {  // 16 k: 32 bytes along x's rows, 2 atoms of w
        const uint64_t da = mma::wgmma_desc(sa + kk * 32, 16, 1024);
        mma::wgmma_m64n128k16_ss(h1, da, mma::wgmma_desc(s1 + kk * 2048, TL::W_LBO, 1024));
        if (gated)
          mma::wgmma_m64n128k16_ss(
              h3, da, mma::wgmma_desc(s1 + TL::W_BYTES + kk * 2048, TL::W_LBO, 1024));
      }
      mma::wgmma_commit();
      mma::wgmma_wait<1>();  // the previous step's products are done: its stage can refill
    }
    mma::wgmma_wait<0>();
    activate_all(h1, h3, act);
#pragma unroll
    for (int kc = 0; kc < KC_P; ++kc) mma::pack_a(hf[pass][kc], h1[2 * kc], h1[2 * kc + 1]);
  }

  // The second product: the warpgroup's 64 rows x NC columns of each w2
  // slice, k over the block's BF hidden units, added into the (T, d) buffer.
  // (Overlapping one slice's atomics with the next slice's products through
  // two accumulator sets made ptxas serialize every wgmma of the kernel: it
  // cannot see that the accumulators read are complete.)
  for (int i = TL::PASSES * n1; i < n_tiles; ++i) {
    const unsigned char* sw2 = reinterpret_cast<const unsigned char*>(ring_step<TL, BM, BF>(
        smem_raw, i, n1, n_tiles, x, w1, w3, w2, m0, f0, n_rows, d, ff, gated, tid));
    const int n0 = (i - TL::PASSES * n1) * TL::NC;
    float o[NT_O][4];
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    mma::wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < TL::PASSES; ++pass)
#pragma unroll
      for (int kc = 0; kc < KC_P; ++kc)
        mma::wgmma_m64n64k16(o, hf[pass][kc],  // 16 hidden units: 2 atoms on
                             mma::wgmma_desc(sw2 + (pass * KC_P + kc) * 2048, 1024, 1024));
    mma::wgmma_commit();
    mma::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NT_O; ++j)
      add_fragment(out, o[j], m0 + warp * 16 + g, n0 + j * 8, t, n_rows, d);
  }
  mma::cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;
constexpr int DK = 32;   // d slice staged per step of the first products
constexpr int FK = 32;   // hidden units staged per step of the second
constexpr int BN = 128;  // output columns per pass of the second product
constexpr int NE = BN / 16;

template <int BM, int BF>
struct F32Tiles {
  static constexpr int RM = BM / 16;  // rows per thread
  static constexpr int CF = BF / 16;  // hidden units per thread
  static constexpr int HLD = BF + 1;  // row stride of the hidden tile
  static constexpr int FKB = BF < FK ? BF : FK;  // hidden units per w2 step
  static constexpr int A_FLOATS = BM * DK + 2 * DK * BF;  // x, w1, w3 slices
  static constexpr int B_FLOATS = FK * BN;                // w2 slice
  static constexpr int STAGE = A_FLOATS > B_FLOATS ? A_FLOATS : B_FLOATS;
  static constexpr int SMEM_BYTES = (STAGE + BM * HLD) * 4;
  static_assert(BM % 16 == 0 && BF % 16 == 0 && BF % FKB == 0, "tiles of 16");
};

template <int BM, int BF>
__global__ void __launch_bounds__(F32_THREADS)
fused_mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ w3, const float* __restrict__ w2,
                     float* __restrict__ out, int n_rows, int d, int ff, int act) {
  using TL = F32Tiles<BM, BF>;
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  float* sx = stage;              // [BM][DK]
  float* sw1 = sx + BM * DK;      // [DK][BF]
  float* sw3 = sw1 + DK * BF;     // [DK][BF]
  float* sw2 = stage;             // [FK][BN], once the first products are done
  float* sh = stage + TL::STAGE;  // [BM][HLD]: the hidden tile

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int m0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * BF;
  const bool gated = act == SWIGLU || act == GEGLU;

  float ha[TL::RM][TL::CF], ga[TL::RM][TL::CF];
#pragma unroll
  for (int i = 0; i < TL::RM; ++i)
#pragma unroll
    for (int j = 0; j < TL::CF; ++j) {
      ha[i][j] = 0.f;
      ga[i][j] = 0.f;
    }

  for (int d0 = 0; d0 < d; d0 += DK) {
    __syncthreads();  // the previous slice's reads are done
    for (int i = tid; i < BM * DK; i += F32_THREADS) {
      const int r = m0 + i / DK;
      const int c = d0 + i % DK;
      sx[i] = (r < n_rows && c < d) ? x[(size_t)r * d + c] : 0.f;
    }
    for (int i = tid; i < DK * BF; i += F32_THREADS) {
      const int r = d0 + i / BF;
      const int c = f0 + i % BF;
      const bool in = r < d && c < ff;
      const size_t g = (size_t)r * ff + c;
      sw1[i] = in ? w1[g] : 0.f;
      if (gated) sw3[i] = in ? w3[g] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < DK; ++kk) {
      float xv[TL::RM];
#pragma unroll
      for (int i = 0; i < TL::RM; ++i) xv[i] = sx[(ty + 16 * i) * DK + kk];
#pragma unroll
      for (int j = 0; j < TL::CF; ++j) {
        const float a = sw1[kk * BF + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TL::RM; ++i) ha[i][j] = fmaf(xv[i], a, ha[i][j]);
      }
      if (gated) {
#pragma unroll
        for (int j = 0; j < TL::CF; ++j) {
          const float g = sw3[kk * BF + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < TL::RM; ++i) ga[i][j] = fmaf(xv[i], g, ga[i][j]);
        }
      }
    }
  }

  // The activation in registers; the hidden tile goes to shared memory only.
#pragma unroll
  for (int i = 0; i < TL::RM; ++i)
#pragma unroll
    for (int j = 0; j < TL::CF; ++j)
      sh[(ty + 16 * i) * TL::HLD + tx + 16 * j] = activate(ha[i][j], ga[i][j], act);

  for (int n0 = 0; n0 < d; n0 += BN) {
    float oa[TL::RM][NE];
#pragma unroll
    for (int i = 0; i < TL::RM; ++i)
#pragma unroll
      for (int e = 0; e < NE; ++e) oa[i][e] = 0.f;
    for (int fs = 0; fs < BF; fs += TL::FKB) {
      __syncthreads();  // the hidden tile is written; earlier reads are done
      for (int i = tid; i < TL::FKB * BN; i += F32_THREADS) {
        const int r = f0 + fs + i / BN;
        const int c = n0 + i % BN;
        sw2[i] = (r < ff && c < d) ? w2[(size_t)r * d + c] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < TL::FKB; ++kk) {
        float hv[TL::RM];
#pragma unroll
        for (int i = 0; i < TL::RM; ++i) hv[i] = sh[(ty + 16 * i) * TL::HLD + fs + kk];
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const float w = sw2[kk * BN + tx + 16 * e];
#pragma unroll
          for (int i = 0; i < TL::RM; ++i) oa[i][e] = fmaf(hv[i], w, oa[i][e]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TL::RM; ++i) {
      const int r = m0 + ty + 16 * i;
      if (r >= n_rows) continue;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int c = n0 + tx + 16 * e;
        if (c < d) atomicAdd(out + (size_t)r * d + c, oa[i][e]);
      }
    }
  }
}

__global__ void round_to_bf16(const float* __restrict__ src,
                              __nv_bfloat16* __restrict__ dst, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void* x;
  const void* w1;
  const void* w3;
  const void* w2;
  void* y;
  float* acc;
  int n_rows, d, ff, act;
  cudaStream_t stream;
};

template <int BM, int BF>
int launch_f32(const Args& a) {
  using TL = F32Tiles<BM, BF>;
  static bool smem_set[64];
  auto kern = fused_mlp_f32_kernel<BM, BF>;
  cudaError_t err = mma::set_smem_once(kern, TL::SMEM_BYTES, smem_set);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(a.acc, 0, (size_t)a.n_rows * a.d * sizeof(float), a.stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n_rows + BM - 1) / BM, (a.ff + BF - 1) / BF);
  kern<<<grid, F32_THREADS, TL::SMEM_BYTES, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w1),
      static_cast<const float*>(a.w3), static_cast<const float*>(a.w2), a.acc,
      a.n_rows, a.d, a.ff, a.act);
  return (int)cudaGetLastError();
}

// The bf16 kernel of a tile: the decode body for 16-row tiles.
template <int BM, int BF, bool GATED>
auto mma_kernel() {
  if constexpr (BM == 16)
    return fused_mlp_mma_decode_kernel<BM, BF, GATED>;
  else
    return fused_mlp_mma_prefill_kernel<BM, BF, GATED>;
}

template <int BM, int BF>
int launch_bf16(const Args& a) {
  using TL = MmaTiles<BM, BF>;
  static bool smem_set[2][64];
  const bool gated = a.act == SWIGLU || a.act == GEGLU;
  auto kern = gated ? mma_kernel<BM, BF, true>() : mma_kernel<BM, BF, false>();
  cudaError_t err = mma::set_smem_once(kern, TL::SMEM_BYTES, smem_set[gated]);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)a.n_rows * a.d;
  err = cudaMemsetAsync(a.acc, 0, n * sizeof(float), a.stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n_rows + BM - 1) / BM, (a.ff + BF - 1) / BF);
  kern<<<grid, TL::NTHREADS, TL::SMEM_BYTES, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.x), static_cast<const __nv_bfloat16*>(a.w1),
      static_cast<const __nv_bfloat16*>(a.w3), static_cast<const __nv_bfloat16*>(a.w2),
      a.acc, a.n_rows, a.d, a.ff, a.act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  round_to_bf16<<<(unsigned)blocks, 256, 0, a.stream>>>(
      a.acc, static_cast<__nv_bfloat16*>(a.y), n);
  return (int)cudaGetLastError();
}

#define FOR_EACH_TILE(X) X(16, 16) X(16, 32) X(64, 128) X(128, 256)

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = float32 on the CUDA cores
// (the sums go straight into y, acc must be y), 1 = bfloat16 on the tensor
// cores (acc is a float32 (T, d) scratch buffer the caller allocated; d
// and ff multiples of 8, pointers 16-byte aligned).  act: 0 swiglu, 1
// geglu, 2 gelu, 3 relu; w3 is read only for the gated acts.  Returns the
// CUDA error code (0 on success); a tile this library was not built for
// is refused with cudaErrorInvalidValue.
extern "C" int fused_mlp_launch(const void* x, const void* w1, const void* w3,
                                const void* w2, void* y, void* acc, int n_rows,
                                int d, int ff, int act, int block_m,
                                int block_f, int dtype, void* stream) {
  if (act < SWIGLU || act > RELU) return (int)cudaErrorInvalidValue;
  if ((dtype == 0) != (acc == y)) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (d % 8 || ff % 8)) return (int)cudaErrorInvalidValue;
  const Args a{x, w1, w3, w2, y, static_cast<float*>(acc), n_rows, d, ff,
               act, static_cast<cudaStream_t>(stream)};
#define DISPATCH(BM_, BF_)                                  \
  if (block_m == BM_ && block_f == BF_) {                   \
    if (dtype == 0) return launch_f32<BM_, BF_>(a);         \
    if (dtype == 1) return launch_bf16<BM_, BF_>(a);        \
    return (int)cudaErrorInvalidValue;                      \
  }
  FOR_EACH_TILE(DISPATCH)
#undef DISPATCH
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one block at a built tile and dtype (bytes), or -1.
extern "C" int fused_mlp_smem_bytes(int block_m, int block_f, int dtype) {
#define SMEM(BM_, BF_)                                            \
  if (block_m == BM_ && block_f == BF_) {                         \
    if (dtype == 0) return F32Tiles<BM_, BF_>::SMEM_BYTES;        \
    if (dtype == 1) return MmaTiles<BM_, BF_>::SMEM_BYTES;        \
  }
  FOR_EACH_TILE(SMEM)
#undef SMEM
  return -1;
}
