// Flash attention forward for Hopper (sm_90a): QK^T -> mask -> online
// softmax -> PV in one kernel, q/k/v/o in the reference's (B, S, heads,
// head_dim) layout; bfloat16 on the tensor cores (Hopper's warpgroup
// products at head dims 64 and 128, warp-level products at 32 and 96) or
// float32 on the CUDA cores.
//
// Replaces: src/repro/kernels/fused_attention.py::flash_attention, the
// Pallas TPU kernel (`_kernel`, launched by `pl.pallas_call`).  What every
// body keeps from that kernel is the fusion group's guarantee and its
// arithmetic: the (Sq, Skv) score frame exists only one tile at a time on
// chip, never in device memory; the running max m, sum l and accumulator
// acc are float32 and live in registers; the scale 1/sqrt(head_dim) is
// applied after the dot; masked scores are the finite NEG_INF = -1e30
// (not -inf), so a row whose first tiles are fully masked takes exp(0) = 1
// garbage into l and acc that the first visible tile wipes with
// corr = exp(-1e30 - m) = 0, exactly as the TPU kernel does (a -inf mask
// would give exp(-inf + inf) = NaN there); the output is acc / max(l,
// 1e-30).  GQA is in the index arithmetic: query head h reads KV head
// h / (H / KV); no repeated K/V is built.  Keys past Skv (the ragged last
// tile) are -inf, i.e. excluded outright, and queries past Sq are not
// stored, so any Sq and Skv are taken.
//
// Masks, from absolute positions 0..Sq-1 and 0..Skv-1: causal k <= q;
// window (q - k) < window, and also (k - q) < window when not causal (the
// model's attention_bias and the plain version; the TPU kernel masks one
// side only, a case its tests never reach); chunk q / chunk == k / chunk.
// The predicates live in flash_common.cuh, shared with the backward kernel
// (flash_attention_bwd.cu), so that both mask the same pairs.
//
// With a non-null `lse` (the training forward) each row's logsumexp of its
// masked, scaled scores, m + log l in natural log, is written to a float32
// (B, H, Sq) array for the backward; the serving launch passes null and
// writes only the output.
// With `skip` set (the wrapper sets it when Sq <= Skv, so that every row
// sees at least its own key) a KV tile that is masked for every row of the
// block (in the wgmma body: of a warpgroup) is not visited: it would add
// exp(-1e30 - m) = 0 to rows that have seen a visible key and garbage that
// is wiped later to rows that have not, so the output is the same.
//
// What bounds it: a block does 4 * BLOCK_Q * BLOCK_K * head_dim flops per
// KV tile against 2 * BLOCK_K * head_dim * 2 bytes of K/V, so the whole
// call is bound by the tensor cores' operations (989 TFLOP/s bf16: 0.278 ms
// at qwen3's training shape (4, 4096, 16/8, 128) causal) and, at short
// sequences, by reading q, k, v and writing o once.  Next to the products,
// the softmax's exponentials (one a score, on a special-function unit with
// 1/256 of the tensor cores' rate: at head dim 128 half the products' time)
// and streaming every K/V tile from L2 once per query tile.
//
// bfloat16 at head dims 64 and 128 (flash_attention_wgmma_kernel):
// Hopper's warpgroup products, wgmma m64nNk16, on operands in
// 128-byte-swizzled shared memory (mma_bf16.cuh, tma_wgmma.cuh).
//  - A block owns BLOCK_Q = 64 or 128 queries of one (batch, head): one or
//    two consumer warpgroups of 64 rows, and one producer warp.  The
//    producer's one thread issues every copy by TMA (the Tensor Memory
//    Accelerator): the Q tile once, then each visited KV tile's K and V
//    into a ring of STAGES stages (3 with two warpgroups, which have the SM
//    to themselves; 2 with one, whose SM holds a second block), each copy
//    completing a phase of the stage's `full` mbarrier.  It refills a stage
//    when every consumer warp has arrived on the stage's `empty` mbarrier,
//    so the loads run as far ahead as the ring allows and no block-wide
//    barrier couples the warpgroups.
//  - S = Q K^T is wgmma m64n{BLOCK_K}k16 with both operands read from
//    shared memory, K-major (the rows of Q and K are hd-contiguous); the
//    scores stay in the float32 accumulator registers, whose layout is
//    mma.sync's C layout by warp (rows g and g + 8 of each warp's 16, two
//    neighbouring keys a lane), so the online softmax is that of the warp-
//    level body: row max and row sum over the 4 lanes of a quad.
//  - O += P V is wgmma m64n{head_dim}k16 with A = P in registers: the S
//    accumulators rounded to bf16 and packed straight into A fragments
//    (pack_a), never in shared memory; B = V read MN-major (the transposed
//    B of the instruction).  acc accumulates in its float32 registers over
//    every tile.
//  - A warpgroup takes each tile by one of two straight-line bodies, chosen
//    by a warpgroup-uniform test: a tile that the masks and Skv leave whole
//    for all its rows skips the mask; the others set every score by
//    selects.  No register a product reads is written under a branch
//    inside the body: ptxas serializes every wgmma of a kernel that does
//    (its C7520 note).  Each body waits for its own products.
//  - exp2 by ex2.approx.ftz (flash_common.cuh): results below 2^-126, which
//    P's rounding to bf16 drops anyway, are flushed to 0.
//  - q-tiles are launched heaviest first (the last q-tile sees the most
//    keys under the causal mask), which shortens the tail of the grid.
//  - Registers a consumer thread at head dim 128, BLOCK_K 128: acc 64, S
//    64, P 32 packed words.  Nine warps a block leave 168 a thread (three
//    of them share a quarter of the register file), which the body fits
//    without a spill; a deeper overlap (S of the next tile issued before
//    this tile's P V is done, the two warpgroups taking turns on the tensor
//    cores) needs ~230 and, with the producer warp, spills.
//  - Still slow against the card's rate: each warpgroup runs S, the
//    softmax and P V one after the other, so the tensor cores wait during
//    its exponentials unless the other warpgroup's products fill them.
// bfloat16 at head dims 32 and 96 (flash_attention_mma_kernel), in the
// style of FlashAttention-2:
//  - one warp owns 16 query rows; a block of BLOCK_Q / 16 warps.  Q is
//    staged once in shared memory and held in registers as mma A
//    fragments (ldmatrix);
//  - K and V tiles arrive by 16-byte cp.async in a two-stage ring: the next
//    visited tile loads while this one is computed.  Rows are padded by 16
//    bytes, so the eight rows an ldmatrix reads fall in distinct banks;
//  - S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products summed in
//    float32; S stays in registers, the online softmax runs on its C
//    fragments, and P is rounded to bf16 and packed straight into A
//    fragments.  V is read with ldmatrix.trans.
// Numerics of both bfloat16 bodies: the products are exact and summed in
// float32 as the TPU kernel's are; what differs is that P is rounded to
// bf16 (relative error <= 2^-9 per weight) before PV, while l sums the
// float32 P.  Each output is then sum_k p_k (1 + e_k) v_k / l with |e_k| <=
// 2^-9, off the float32 result by at most 2^-9 x sum_k (p_k / l) |v_k| <=
// 2^-9 max |v| = 2e-3 max |v|, inside the bf16 tolerance 2e-2 (atol and
// rtol) of tests/test_kernels.py; tests/test_torch_attention_mlp.py holds
// an emulation of this rounding to the TPU kernel.
//
// float32 body (flash_attention_f32_kernel): float32 FMAs on the CUDA
// cores, since TF32 would miss the 2e-5 float32 tolerance.  256 threads =
// 16 row groups (ty) x 16 column groups (tx); thread (ty, tx) owns the
// scores of rows ty + 16 i and keys tx + 16 j and the output dims tx + 16 e
// of its rows; the 16 threads of a row are one half-warp, so row max and
// row sum are four xor-shuffles.  Shared memory holds the Q tile, one
// K-or-V tile and the P tile, all float32.
//
// Shared memory of each body in flash_attention_smem_bytes (and
// fused_attention.py::smem_bytes).  Build (see fused_attention.py): nvcc
// -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC.  The
// (head_dim, BLOCK_Q, BLOCK_K) shapes built are listed in FOR_EACH_SHAPE
// below and in fused_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_bf16.cuh"
#include "tma_wgmma.cuh"

namespace {

using attn::exp2_approx;
using attn::LN2;
using attn::load_rows;
using attn::LOG2E;
using attn::NEG_INF;
using attn::tile_masked;
using attn::tile_visible;
using attn::visible;
using hopper::aligned_smem;
using hopper::desc_kmajor;
using hopper::desc_mnmajor;
using hopper::fence_regs;
using hopper::kmajor;
using hopper::mbar_arrive;
using hopper::mbar_expect;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::mnmajor;
using hopper::tensor_map;
using hopper::tma_tile;
using hopper::wgmma_rs;

// ---------------------------------------------------------------------------
// bfloat16 at head dims 32 and 96: warp-level tensor-core products (mma.sync)
// ---------------------------------------------------------------------------

template <int HD, int BQ, int BK>
struct MmaTiles {
  static constexpr int WARPS = BQ / 16;
  static constexpr int NTHREADS = WARPS * 32;
  static constexpr int LD = HD + 8;  // row stride (bf16) of the Q, K and V tiles
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int KV_ELEMS = BK * LD;  // one K or one V tile
  static constexpr int STAGES = 2;          // (K, V) pairs in flight
  static constexpr int SMEM_BYTES = (Q_ELEMS + STAGES * 2 * KV_ELEMS) * 2;
  static_assert(HD % 16 == 0 && BQ % 16 == 0 && BK % 16 == 0, "tiles of 16");
};

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(BQ / 16 * 32)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int Sq, int Skv,
                           int H, int KV, int causal, int window, int chunk,
                           int skip, float scale) {
  using TL = MmaTiles<HD, BQ, BK>;
  constexpr int LD = TL::LD;
  constexpr int NT_S = BK / 8;   // n-tiles of S (keys)
  constexpr int NT_O = HD / 8;   // n-tiles of O (head dims)
  constexpr int KC_Q = HD / 16;  // k-chunks of Q K^T
  constexpr int KC_P = BK / 16;  // k-chunks of P V
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* skv = sq + TL::Q_ELEMS;  // stage s: K at 2s, V at 2s + 1 tiles

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest q-tile first
  const size_t q_stride = (size_t)H * HD;  // elements between positions
  const size_t kv_stride = (size_t)KV * HD;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * q_stride + (size_t)h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  __nv_bfloat16* ob = o + (size_t)b * Sq * q_stride + (size_t)h * HD;

  const int q_hi = min(q0 + BQ, Sq) - 1;
  const int n_kb = (Skv + BK - 1) / BK;
  const float scale_log2 = scale * LOG2E;
  // The next KV tile at or after kt that the block visits.
  auto next_tile = [&](int kt) {
    while (kt < n_kb && skip &&
           tile_masked(q0, q_hi, kt * BK, min(kt * BK + BK, Skv) - 1, causal,
                       window, chunk))
      ++kt;
    return kt;
  };
  auto load_kv = [&](int kt, int stage) {
    __nv_bfloat16* sk = skv + stage * 2 * TL::KV_ELEMS;
    load_rows<HD, LD, TL::NTHREADS>(sk, kb, kv_stride, kt * BK, BK, Skv, tid);
    load_rows<HD, LD, TL::NTHREADS>(sk + TL::KV_ELEMS, vb, kv_stride, kt * BK,
                                    BK, Skv, tid);
  };

  int kt = next_tile(0);
  load_rows<HD, LD, TL::NTHREADS>(sq, qb, q_stride, q0, BQ, Sq, tid);
  if (kt < n_kb) load_kv(kt, 0);
  mma::cp_async_commit();

  // This warp's rows, and its part of the state: rows g and g + 8.
  const int wq0 = q0 + warp * 16;
  const int qr0 = wq0 + g;
  const int qr1 = qr0 + 8;
  uint32_t qf[KC_Q][4];
  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  bool first = true;
  int stage = 0;
  while (kt < n_kb) {
    const int nk = next_tile(kt + 1);
    if (nk < n_kb) load_kv(nk, stage ^ 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // Q and this tile have landed (this thread's part)
    __syncthreads();          // ... and every thread's
    if (first) {
#pragma unroll
      for (int kc = 0; kc < KC_Q; ++kc)
        mma::ldmatrix_x4(qf[kc], sq + (warp * 16 + mma::a_row(lane)) * LD +
                                     kc * 16 + mma::a_col(lane));
      first = false;
    }
    const __nv_bfloat16* sk = skv + stage * 2 * TL::KV_ELEMS;
    const __nv_bfloat16* sv = sk + TL::KV_ELEMS;
    const int k0 = kt * BK;

    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC_Q; ++kc)
#pragma unroll
      for (int np = 0; np < NT_S / 2; ++np) {
        uint32_t bf[4];
        mma::ldmatrix_x4(bf, sk + (np * 16 + mma::bnk_row(lane)) * LD + kc * 16 +
                                 mma::bnk_col(lane));
        mma::mma_bf16(s[2 * np], qf[kc], bf[0], bf[1]);
        mma::mma_bf16(s[2 * np + 1], qf[kc], bf[2], bf[3]);
      }

    // Scale (by scale * log2 e: the softmax runs in base 2), mask (only
    // where this warp's rows meet a masked or ragged key), and the
    // online-softmax update on the fragments.
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    if (!(k0 + BK <= Skv &&
          tile_visible(wq0, wq0 + 15, k0, k0 + BK - 1, causal, window, chunk))) {
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + j * 8 + 2 * t + (e & 1);
          const int qi = e < 2 ? qr0 : qr1;
          if (kj >= Skv)
            s[j][e] = -INFINITY;  // past the ragged edge: no key at all
          else if (!visible(qi, kj, causal, window, chunk))
            s[j][e] = NEG_INF;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // key k0 < Skv is in this tile, so the row max is >= NEG_INF: finite
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0);
    const float c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;  // this lane's part of the row sums
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + rs0;
    l1 = l1 * c1 + rs1;
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }

    // O += P V, P from registers.
#pragma unroll
    for (int kc = 0; kc < KC_P; ++kc) {
      uint32_t pa[4];
      mma::pack_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        uint32_t bf[4];
        mma::ldmatrix_x4_trans(bf, sv + (kc * 16 + mma::bkn_row(lane)) * LD +
                                       np * 16 + mma::bkn_col(lane));
        mma::mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
        mma::mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
    stage ^= 1;
    kt = nk;
  }
  mma::cp_async_wait<0>();

  // The row sums over the quad, then the output.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  if (lse != nullptr && t == 0) {  // m is in base-2 units of the scaled scores
    float* lb = lse + (size_t)(b * H + h) * Sq;
    if (qr0 < Sq) lb[qr0] = m0 * LN2 + logf(fmaxf(l0, 1e-30f));
    if (qr1 < Sq) lb[qr1] = m1 * LN2 + logf(fmaxf(l1, 1e-30f));
  }
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int d = j * 8 + 2 * t;
    if (qr0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qr0 * q_stride + d) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    if (qr1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qr1 * q_stride + d) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at head dims 64 and 128: warpgroup tensor cores (wgmma) and TMA
// ---------------------------------------------------------------------------

template <int HD, int BQ, int BK>
struct WgTiles {
  static constexpr int NWG = BQ / 64;              // consumer warpgroups, 64 queries each
  static constexpr int NTHREADS = NWG * 128 + 32;  // and the producer warp
  static constexpr int ROW = HD * 2;               // bytes of a row
  static constexpr int Q_BYTES = BQ * ROW;
  static constexpr int KV_BYTES = BK * ROW;  // one K or one V tile
  // (K, V) tiles in the ring: two warpgroups hold the SM alone and keep
  // two tiles in flight; one warpgroup's SM holds a second block.
  static constexpr int STAGES = NWG == 2 ? 3 : 2;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_BYTES = 64;  // full[STAGES], empty[STAGES], Q's
  // the Q tile, the ring, the mbarriers, and 1024 to align the swizzle atoms
  static constexpr int SMEM_BYTES = Q_BYTES + STAGES * STAGE_BYTES + BAR_BYTES + 1024;
  static_assert(HD == 64 || HD == 128, "wgmma body at head dims 64 and 128");
  static_assert(BQ == 64 || BQ == 128, "one or two 64-row warpgroups");
  static_assert(BK == 64 || BK == 128, "S's wgmma N");
  static_assert((2 * STAGES + 1) * 8 <= BAR_BYTES, "the mbarriers");
  static_assert(SMEM_BYTES <= 232448, "one block's shared memory");
};

// d (64 x BK) = A (64 x 16, K-major) * B^T (BK rows, K-major), or += with
// scale_d 1.
template <int BK>
__device__ __forceinline__ void wgmma_ss_kk(float (&d)[BK / 8][4], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  if constexpr (BK == 64)
    mma::wgmma_m64n64k16_ss_kk(d, desc_a, desc_b, scale_d);
  else
    mma::wgmma_m64n128k16_ss_kk(d, desc_a, desc_b, scale_d);
}

// One KV tile for one warpgroup: S = Q K^T, the online softmax on its
// accumulators, O += P V; the products waited for before it returns.  Row
// state: this thread's rows qr0 (m0, l0) and qr1 (m1, l1); element (j, e)
// of S is row e < 2 ? qr0 : qr1, key k0 + 8 j + 2 t + (e & 1).  MASK: the
// tile holds masked or ragged pairs for some of the warpgroup's rows, and
// every score is set by a select; without it no mask is applied.  Either
// way the registers the products read are written in straight-line code.
template <int HD, int BQ, int BK, bool MASK>
__device__ __forceinline__ void wg_tile(float (&acc)[HD / 8][4], float& m0, float& m1,
                                        float& l0, float& l1, uint64_t dsq,
                                        const unsigned char* sk, const unsigned char* sv,
                                        int k0, int qr0, int qr1, int t, int Skv, int causal,
                                        int window, int chunk, float scale_log2) {
  constexpr int NT_S = BK / 8;  // n-tiles of S (keys)
  constexpr int NT_O = HD / 8;  // n-tiles of O (head dims)
  float s[NT_S][4];
  const uint64_t dsk = desc_kmajor(sk);
  mma::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_kk<BK>(s, kmajor<BQ>(dsq, kk), kmajor<BK>(dsk, kk), kk > 0);
  mma::wgmma_commit();
  mma::wgmma_wait<0>();
  fence_regs(s);

  // Scale (by scale * log2 e: the softmax runs in base 2) and mask, the row
  // maxima over the quad.
  float mx0 = -INFINITY, mx1 = -INFINITY;
  if constexpr (MASK) {
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + j * 8 + 2 * t + (e & 1);
        const float x = s[j][e] * scale_log2;
        const bool seen = visible(e < 2 ? qr0 : qr1, kj, causal, window, chunk);
        // past the ragged edge: no key at all
        s[j][e] = kj >= Skv ? -INFINITY : (seen ? x : NEG_INF);
      }
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 *= scale_log2;  // the scale is positive: the max of the scaled scores
    mx1 *= scale_log2;
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // key k0 < Skv is in this tile, so the row max is >= NEG_INF: finite
  const float mn0 = fmaxf(m0, mx0);
  const float mn1 = fmaxf(m1, mx1);
  const float c0 = exp2_approx(m0 - mn0);
  const float c1 = exp2_approx(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;  // this lane's part of the row sums
#pragma unroll
  for (int j = 0; j < NT_S; ++j) {
    if constexpr (MASK) {
      s[j][0] = exp2_approx(s[j][0] - mn0);
      s[j][1] = exp2_approx(s[j][1] - mn0);
      s[j][2] = exp2_approx(s[j][2] - mn1);
      s[j][3] = exp2_approx(s[j][3] - mn1);
    } else {
      s[j][0] = exp2_approx(fmaf(s[j][0], scale_log2, -mn0));
      s[j][1] = exp2_approx(fmaf(s[j][1], scale_log2, -mn0));
      s[j][2] = exp2_approx(fmaf(s[j][2], scale_log2, -mn1));
      s[j][3] = exp2_approx(fmaf(s[j][3], scale_log2, -mn1));
    }
    rs0 += s[j][0] + s[j][1];
    rs1 += s[j][2] + s[j][3];
  }
  l0 = l0 * c0 + rs0;
  l1 = l1 * c1 + rs1;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    acc[j][0] *= c0;
    acc[j][1] *= c0;
    acc[j][2] *= c1;
    acc[j][3] *= c1;
  }

  // O += P V: P rounded to bf16 into A fragments over 16 keys each, V read
  // MN-major.
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) mma::pack_a(pa[kc], s[2 * kc], s[2 * kc + 1]);
  const uint64_t dsv = desc_mnmajor<BK>(sv);
  mma::wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) wgmma_rs<HD>(acc, pa[kc], mnmajor(dsv, kc));
  mma::wgmma_commit();
  mma::wgmma_wait<0>();
  fence_regs(acc);
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(BQ / 64 * 128 + 32, 1)  // WgTiles::NTHREADS
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                             int Sq, int Skv, int H, int KV, int causal, int window,
                             int chunk, int skip, float scale) {
  using TL = WgTiles<HD, BQ, BK>;
  static_assert(TL::NTHREADS == BQ / 64 * 128 + 32, "the launch bounds");
  constexpr int NT_O = HD / 8;  // n-tiles of O (head dims)
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  unsigned char* sq = aligned_smem(smem_dyn);  // BQ swizzled rows
  unsigned char* ring = sq + TL::Q_BYTES;      // stage s: K, then V
  // mbarriers: full[s], stage s's K and V have landed; empty[s], every
  // consumer warp is done with stage s; q_bar, the Q tile has landed
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + TL::STAGES * TL::STAGE_BYTES);
  uint64_t* empty = full + TL::STAGES;
  uint64_t* q_bar = empty + TL::STAGES;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest q-tile first
  const int q_hi = min(q0 + BQ, Sq) - 1;
  const int n_kb = (Skv + BK - 1) / BK;
  // The next KV tile at or after kt that the block visits (the producer and
  // the consumers walk the same tiles).
  auto next_tile = [&](int kt) {
    while (kt < n_kb && skip &&
           tile_masked(q0, q_hi, kt * BK, min(kt * BK + BK, Skv) - 1, causal, window, chunk))
      ++kt;
    return kt;
  };

  if (tid == 0) {
    for (int s = 0; s < TL::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, TL::NWG * 4);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are set up; no block-wide barrier after this

  if (tid >= TL::NWG * 128) {  // the producer warp: one thread issues every copy
    if (tid == TL::NWG * 128) {
      mbar_expect(q_bar, TL::Q_BYTES);
      tma_tile<HD, BQ>(sq, &tq, h, q0, b, q_bar);
      int slot = 0;
      for (int c = 0, kt = next_tile(0); kt < n_kb; kt = next_tile(kt + 1), ++c) {
        if (c >= TL::STAGES) mbar_wait(empty + slot, (c / TL::STAGES - 1) & 1);
        unsigned char* st = ring + slot * TL::STAGE_BYTES;
        mbar_expect(full + slot, TL::STAGE_BYTES);
        tma_tile<HD, BK>(st, &tk, kvh, kt * BK, b, full + slot);
        tma_tile<HD, BK>(st + TL::KV_BYTES, &tv, kvh, kt * BK, b, full + slot);
        slot = slot + 1 == TL::STAGES ? 0 : slot + 1;
      }
    }
    return;
  }

  // A consumer warpgroup: queries wq0..wq_hi (none if wq_hi < wq0); this
  // thread's rows qr0 and qr1 (g and g + 8 of its warp's 16).
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wq0 = q0 + wg * 64;
  const int wq_hi = min(wq0 + 64, Sq) - 1;
  const int qr0 = wq0 + ((tid >> 5) & 3) * 16 + g;
  const int qr1 = qr0 + 8;
  const float scale_log2 = scale * LOG2E;
  const uint64_t dsq = desc_kmajor(sq + wg * 64 * 128);  // this warpgroup's Q rows
  float acc[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_bar, 0);
  int slot = 0;
  for (int c = 0, kt = next_tile(0); kt < n_kb; kt = next_tile(kt + 1), ++c) {
    mbar_wait(full + slot, (c / TL::STAGES) & 1);  // this stage's K and V
    const int k0 = kt * BK;
    const int k_hi = min(k0 + BK, Skv) - 1;
    const unsigned char* sk = ring + slot * TL::STAGE_BYTES;
    const unsigned char* sv = sk + TL::KV_BYTES;
    // warpgroup-uniform: skip a tile masked for all its rows, take the
    // unmasked body where the masks and Skv leave the tile whole
    if (wq0 <= wq_hi && !(skip && tile_masked(wq0, wq_hi, k0, k_hi, causal, window, chunk))) {
      if (k_hi == k0 + BK - 1 && tile_visible(wq0, wq_hi, k0, k_hi, causal, window, chunk))
        wg_tile<HD, BQ, BK, false>(acc, m0, m1, l0, l1, dsq, sk, sv, k0, qr0, qr1, t, Skv,
                                   causal, window, chunk, scale_log2);
      else
        wg_tile<HD, BQ, BK, true>(acc, m0, m1, l0, l1, dsq, sk, sv, k0, qr0, qr1, t, Skv,
                                  causal, window, chunk, scale_log2);
    }
    if (lane == 0) mbar_arrive(empty + slot);  // this warp is done with the stage
    slot = slot + 1 == TL::STAGES ? 0 : slot + 1;
  }

  // The row sums over the quad, then the output.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const size_t q_stride = (size_t)H * HD;  // elements between positions
  if (lse != nullptr && t == 0) {  // m is in base-2 units of the scaled scores
    float* lb = lse + (size_t)(b * H + h) * Sq;
    if (qr0 < Sq) lb[qr0] = m0 * LN2 + logf(fmaxf(l0, 1e-30f));
    if (qr1 < Sq) lb[qr1] = m1 * LN2 + logf(fmaxf(l1, 1e-30f));
  }
  __nv_bfloat16* ob = o + (size_t)b * Sq * q_stride + (size_t)h * HD;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int d = j * 8 + 2 * t;
    if (qr0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qr0 * q_stride + d) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    if (qr1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qr1 * q_stride + d) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;

template <int HD, int BQ, int BK>
struct F32Tiles {
  static constexpr int RQ = BQ / 16;   // query rows per thread
  static constexpr int CK = BK / 16;   // keys per thread
  static constexpr int DPT = HD / 16;  // output dims per thread
  static constexpr int QLD = HD + 4;   // row stride (floats) of the Q and K tiles
  static constexpr int PLD = BK + 4;   // row stride of the P tile
  static constexpr int Q_FLOATS = BQ * QLD;
  static constexpr int KV_FLOATS = BK * QLD;  // K tile; the V tile (stride HD) reuses it
  static constexpr int SMEM_BYTES = (Q_FLOATS + KV_FLOATS + BQ * PLD) * 4;
  static_assert(HD % 16 == 0 && BQ % 16 == 0 && BK % 16 == 0, "tiles of 16");
  static_assert(QLD % 4 == 0, "Q and K rows are read as float4");
};

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(F32_THREADS)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           float* __restrict__ lse, int Sq, int Skv, int H, int KV,
                           int causal, int window, int chunk, int skip, float scale) {
  using TL = F32Tiles<HD, BQ, BK>;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [BQ][QLD]
  float* skv = sq + TL::Q_FLOATS;               // [BK][QLD] K, or [BK][HD] V
  float* sp = skv + TL::KV_FLOATS;              // [BQ][PLD]

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const size_t q_stride = (size_t)H * HD;  // elements between positions
  const size_t kv_stride = (size_t)KV * HD;
  const float* qb = q + (size_t)b * Sq * q_stride + (size_t)h * HD;
  const float* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  const float* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  float* ob = o + (size_t)b * Sq * q_stride + (size_t)h * HD;

  for (int i = tid; i < BQ * HD; i += F32_THREADS) {
    const int r = i / HD;
    const int d = i % HD;
    const int s = q0 + r;
    sq[r * TL::QLD + d] = s < Sq ? qb[(size_t)s * q_stride + d] : 0.f;
  }

  float m[TL::RQ], l[TL::RQ], acc[TL::RQ][TL::DPT];
#pragma unroll
  for (int i = 0; i < TL::RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < TL::DPT; ++e) acc[i][e] = 0.f;
  }

  const int q_hi = min(q0 + BQ, Sq) - 1;
  const int n_kb = (Skv + BK - 1) / BK;
  for (int kt = 0; kt < n_kb; ++kt) {
    const int k0 = kt * BK;
    const int k_hi = min(k0 + BK, Skv) - 1;
    // Uniform across the block: every thread skips or none does.
    if (skip && tile_masked(q0, q_hi, k0, k_hi, causal, window, chunk)) continue;

    __syncthreads();  // the previous tile's V and P reads are done
    for (int i = tid; i < BK * HD; i += F32_THREADS) {
      const int r = i / HD;
      const int d = i % HD;
      const int s = k0 + r;
      skv[r * TL::QLD + d] = s < Skv ? kb[(size_t)s * kv_stride + d] : 0.f;
    }
    __syncthreads();

    float s[TL::RQ][TL::CK];
#pragma unroll
    for (int i = 0; i < TL::RQ; ++i)
#pragma unroll
      for (int j = 0; j < TL::CK; ++j) s[i][j] = 0.f;
#pragma unroll 1
    for (int d = 0; d < HD; d += 4) {
      float4 kv4[TL::CK];
#pragma unroll
      for (int j = 0; j < TL::CK; ++j)
        kv4[j] = *reinterpret_cast<const float4*>(skv + (tx + 16 * j) * TL::QLD + d);
#pragma unroll
      for (int i = 0; i < TL::RQ; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sq + (ty + 16 * i) * TL::QLD + d);
#pragma unroll
        for (int j = 0; j < TL::CK; ++j) {
          float a = s[i][j];
          a = fmaf(qv.x, kv4[j].x, a);
          a = fmaf(qv.y, kv4[j].y, a);
          a = fmaf(qv.z, kv4[j].z, a);
          a = fmaf(qv.w, kv4[j].w, a);
          s[i][j] = a;
        }
      }
    }

    // Scale, mask, and the online-softmax update, row by row.
#pragma unroll
    for (int i = 0; i < TL::RQ; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < TL::CK; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kj >= Skv)
          x = -INFINITY;  // past the ragged edge: no key at all
        else if (!visible(qi, kj, causal, window, chunk))
          x = NEG_INF;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      mt = half_warp_max(mt);
      // key k0 < Skv is in this tile, so mt >= NEG_INF and m_new is finite
      const float m_new = fmaxf(m[i], mt);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < TL::CK; ++j) {
        const float p = expf(s[i][j] - m_new);
        s[i][j] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < TL::DPT; ++e) acc[i][e] *= corr;
    }

    __syncthreads();  // every thread is done reading the K tile
#pragma unroll
    for (int i = 0; i < TL::RQ; ++i)
#pragma unroll
      for (int j = 0; j < TL::CK; ++j)
        sp[(ty + 16 * i) * TL::PLD + tx + 16 * j] = s[i][j];
    for (int i = tid; i < BK * HD; i += F32_THREADS) {
      const int r = i / HD;
      const int d = i % HD;
      const int s2 = k0 + r;
      skv[r * HD + d] = s2 < Skv ? vb[(size_t)s2 * kv_stride + d] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[TL::RQ];
#pragma unroll
      for (int i = 0; i < TL::RQ; ++i) pv[i] = sp[(ty + 16 * i) * TL::PLD + kk];
#pragma unroll
      for (int e = 0; e < TL::DPT; ++e) {
        const float vv = skv[kk * HD + tx + 16 * e];
#pragma unroll
        for (int i = 0; i < TL::RQ; ++i) acc[i][e] = fmaf(pv[i], vv, acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TL::RQ; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < TL::DPT; ++e)
      ob[(size_t)qi * q_stride + tx + 16 * e] = acc[i][e] / denom;
    if (lse != nullptr && tx == 0) lse[(size_t)(b * H + h) * Sq + qi] = m[i] + logf(denom);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, Sq, Skv, H, KV, causal, window, chunk, skip;
  float scale;
  cudaStream_t stream;
};

// The mma.sync body (head dims 32 and 96).
template <int HD, int BQ, int BK>
int launch_bf16_mma(const Args& a) {
  using TL = MmaTiles<HD, BQ, BK>;
  static bool smem_set[64];
  auto kern = flash_attention_mma_kernel<HD, BQ, BK>;
  const cudaError_t err = mma::set_smem_once(kern, TL::SMEM_BYTES, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  kern<<<grid, TL::NTHREADS, TL::SMEM_BYTES, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o),
      a.lse, a.Sq, a.Skv, a.H, a.KV, a.causal, a.window, a.chunk, a.skip, a.scale);
  return (int)cudaGetLastError();
}

// The wgmma body (head dims 64 and 128): the TMA maps of q, k and v are
// made per launch.
template <int HD, int BQ, int BK>
int launch_bf16_wgmma(const Args& a) {
  using TL = WgTiles<HD, BQ, BK>;
  static bool smem_set[64];
  auto kern = flash_attention_wgmma_kernel<HD, BQ, BK>;
  const cudaError_t e = mma::set_smem_once(kern, TL::SMEM_BYTES, smem_set);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, a.q, a.B, a.Sq, a.H, HD);
  if (err == 0) err = tensor_map(&tk, a.k, a.B, a.Skv, a.KV, HD);
  if (err == 0) err = tensor_map(&tv, a.v, a.B, a.Skv, a.KV, HD);
  if (err != 0) return err;
  const dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  kern<<<grid, TL::NTHREADS, TL::SMEM_BYTES, a.stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.o), a.lse, a.Sq, a.Skv, a.H, a.KV, a.causal,
      a.window, a.chunk, a.skip, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
constexpr bool on_wgmma() {
  return HD == 64 || HD == 128;
}

template <int HD, int BQ, int BK>
int launch_bf16(const Args& a) {
  if constexpr (on_wgmma<HD>())
    return launch_bf16_wgmma<HD, BQ, BK>(a);
  else
    return launch_bf16_mma<HD, BQ, BK>(a);
}

// Shared memory of one bfloat16 block (bytes).
template <int HD, int BQ, int BK>
constexpr int bf16_smem_bytes() {
  if constexpr (on_wgmma<HD>())
    return WgTiles<HD, BQ, BK>::SMEM_BYTES;
  else
    return MmaTiles<HD, BQ, BK>::SMEM_BYTES;
}

template <int HD, int BQ, int BK>
int launch_f32(const Args& a) {
  using TL = F32Tiles<HD, BQ, BK>;
  static bool smem_set[64];
  auto kern = flash_attention_f32_kernel<HD, BQ, BK>;
  const cudaError_t err = mma::set_smem_once(kern, TL::SMEM_BYTES, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  kern<<<grid, F32_THREADS, TL::SMEM_BYTES, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.Sq, a.Skv, a.H,
      a.KV, a.causal, a.window, a.chunk, a.skip, a.scale);
  return (int)cudaGetLastError();
}

// The shapes this library is built for: (head_dim, BLOCK_Q, BLOCK_K);
// fused_attention.py lists the same (HEAD_DIMS x TILES).
#define FOR_EACH_SHAPE(X)                                              \
  X(32, 64, 64) X(32, 64, 128) X(32, 128, 64) X(32, 128, 128)          \
  X(64, 64, 64) X(64, 64, 128) X(64, 128, 64) X(64, 128, 128)          \
  X(96, 64, 64) X(96, 64, 128) X(96, 128, 64) X(96, 128, 128)          \
  X(128, 64, 64) X(128, 64, 128) X(128, 128, 64) X(128, 128, 128)

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = float32 (CUDA cores), 1 =
// bfloat16 (tensor cores: wgmma at head dims 64 and 128, mma.sync at 32
// and 96); q, k, v and o share it.  lse: null, or a float32
// (B, H, Sq) array that receives each row's logsumexp m + log l of its
// masked, scaled scores (natural log; the training forward, which the
// backward kernel reads).  Returns the CUDA error code of the launch (0 on
// success); a shape this library was not built for is refused with
// cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int Sq,
                                      int Skv, int H, int KV, int hd,
                                      int block_q, int block_k, int causal,
                                      int window, int chunk, int skip,
                                      float scale, int dtype, void* stream) {
  const Args a{q, k, v, o, lse, B, Sq, Skv, H, KV, causal, window, chunk, skip,
               scale, static_cast<cudaStream_t>(stream)};
#define DISPATCH(HD_, BQ_, BK_)                            \
  if (hd == HD_ && block_q == BQ_ && block_k == BK_) {     \
    if (dtype == 0) return launch_f32<HD_, BQ_, BK_>(a);   \
    if (dtype == 1) return launch_bf16<HD_, BQ_, BK_>(a);  \
    return (int)cudaErrorInvalidValue;                     \
  }
  FOR_EACH_SHAPE(DISPATCH)
#undef DISPATCH
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one block at a built shape and dtype (bytes), or -1:
// the wrapper checks its own sizing function against it.
extern "C" int flash_attention_smem_bytes(int hd, int block_q, int block_k,
                                          int dtype) {
#define SMEM(HD_, BQ_, BK_)                                       \
  if (hd == HD_ && block_q == BQ_ && block_k == BK_) {            \
    if (dtype == 0) return F32Tiles<HD_, BQ_, BK_>::SMEM_BYTES;   \
    if (dtype == 1) return bf16_smem_bytes<HD_, BQ_, BK_>();      \
  }
  FOR_EACH_SHAPE(SMEM)
#undef SMEM
  return -1;
}
