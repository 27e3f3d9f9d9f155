// Flash attention backward for Hopper (sm_90a): dQ, dK and dV of the
// attention flash_attention.cu computes, from (q, k, v, out, lse) and the
// output's gradient dO, in the reference's (B, S, heads, head_dim) layout;
// bfloat16 on the tensor cores or float32 on the CUDA cores.
//
// Replaces: the backward of the JAX package's custom-VJP flash attention,
// src/repro/models/flash.py::make_flash's `bwd` (the training path's
// attention; the TPU kernel src/repro/kernels/fused_attention.py::
// flash_attention has no backward).  What it keeps from there is the
// arithmetic: the probabilities are recomputed from the forward's saved
// logsumexp, P = exp(S / sqrt(hd) - lse), never stored; D = rowsum(dO * O),
// which is rowsum(P * dP); dV = P^T dO, dP = dO V^T, dS = P (dP - D) /
// sqrt(hd), dQ = dS K,
// dK = dS^T Q; the H / KV query heads of each KV head are summed into its
// dK and dV.  The masks are the forward's (flash_common.cuh): a masked or
// ragged pair has P = 0, so a query that sees no key (non-causal masks with
// Sq > Skv make such rows) gets dQ = 0 and adds nothing to dK and dV.
//
// Three launches, deterministic (no atomics, every sum in a fixed order, so
// two runs on the same inputs are bit-equal):
//  1. D (B, H, Sq) float32.  bfloat16: the dQ kernel's D pass (its DELTA
//     instantiation), D = rowsum(P * dP) from the P and dP that the dS
//     products then use, so that every row of dS adds to 0 up to float32
//     sums.  rowsum(dO * O) of the stored bfloat16 output is off by about
//     2^-9 |D|, a row of dS then adds to that instead of 0, and dQ = dS K
//     and dK = dS^T Q pass it on times whatever the keys (queries) have in
//     common: with 1024 nearly equal encoder frames (seamless's cross
//     attention at random initialisation) that moved the wq and wk
//     gradients by 0.14 relative L2 on an H100.  float32:
//     flash_bwd_delta_kernel,
//     rowsum(dO * O) of the float32 output, one warp a row;
//  2. the dK/dV kernel: one block per (batch, KV head, key tile); it walks
//     the G query heads of its KV head and every query tile that the masks
//     leave any pair of (a tile masked for the whole block is skipped),
//     accumulating its keys' dK and dV in registers; key tile 0 first, the
//     heaviest under the causal mask;
//  3. the dQ kernel: one block per (batch, head, query tile), over the key
//     tiles, heaviest query tile first (the causal mask's last tiles see
//     the most keys).
// Each output element is written by one thread, once.  The price is that
// the dQ kernel recomputes S and dP, and in bfloat16 the D pass once more:
// nine products of 2 * hd flops per visible (query, key) pair and head
// (seven in float32) instead of the five the arithmetic needs (dQ summed
// across key tiles by atomics would need five, but float atomics add in
// whatever order the blocks finish).
//
// What bounds it: those products against reading q, k, v, dO and writing
// dq, dk, dv once; at training shapes (S = 4096, hd 128) hundreds of flops
// a byte, so the tensor cores (989 TFLOP/s bf16: 1.25 ms for the nine
// products at qwen3's (4, 4096, 16/8, 128) causal, 0.70 ms for five), and
// next to them the shared memory's bandwidth, which feeds the tensor cores
// their operands.
//
// bfloat16 at head dims 64 and 128 (the *_wgmma_kernel bodies): Hopper's
// warpgroup products, wgmma m64nNk16, on operands in 128-byte-swizzled
// shared memory (mma_bf16.cuh), two consumer warpgroups a block (256
// threads, one block an SM).
//  - dK/dV: a block owns 128 keys, 64 a warpgroup; K and V stay in shared
//    memory for the whole block.  Per 64-query tile of Q and dO (with its
//    lse and D rows), each warpgroup computes S^T = K Q^T and dP^T = V dO^T
//    as m64n64k16 with both operands read from shared memory, K-major (Q
//    and dO rows are hd-contiguous, so B needs no transpose); P^T and dS^T
//    are computed on the float32 accumulators, rounded to bf16 and packed
//    into A fragments in registers; then dV += P^T dO and dK += dS^T Q as
//    m64n{hd}k16 with A from registers and B (the same Q and dO tiles)
//    read MN-major, transposed in the instruction.  Registers a thread at
//    hd 128: dK and dV 64 + 64, S^T and dP^T 32 + 32.
//  - dQ: a block owns 128 queries, 64 a warpgroup; Q and dO stay in shared
//    memory.  Per 64-key tile of K and V: S = Q K^T and dP = dO V^T (both
//    operands K-major in shared memory), dS into A fragments, dQ += dS K
//    with K read MN-major.
//  - Q, dO, K and V tiles arrive by TMA (the Tensor Memory Accelerator:
//    one thread issues a 64 x 64 box copy, which lands already swizzled and
//    zero-fills rows past the tensor's end; the host makes the four maps
//    per launch through cuTensorMapEncodeTiled), completing a phase of an
//    mbarrier; lse and D by 4-byte cp.async.  The streamed tiles run in a
//    ring of three stages, loaded two tiles ahead; one block barrier a tile
//    frees the stage refilled next.  (Issued by every thread as 16-byte
//    cp.async, the loads held each thread for a large part of a tile;
//    without the block barrier, or with the two warpgroups taking turns on
//    the tensor cores, a step took no less time.)
//  - A tile's P, dP and dS are computed branch-free on the accumulators; a
//    tile that the masks cut first sets a 32-bit word of visible pairs
//    under a branch.  The registers the next products read are never
//    written in a divergent path: ptxas serializes every wgmma of a kernel
//    that does (its C7520 note).
//  - dK, dV and dQ accumulate in their float32 registers over every tile.
//    The tensor cores truncate the sums they take, but K2's and K3's
//    bfloat16 sums did not grow their error with K (tests/
//    test_torch_on_card.py *_do_not_grow_their_error_*), and the backward's
//    own test at Sq 512-4096 holds it to that.
//  - Still slow: with both operands in shared memory the S and dP products
//    run well below the tensor cores' rate (their operand reads fill the
//    shared memory's bandwidth), and the two warpgroups compute their
//    exponentials at the same time, when the tensor cores wait.
// bfloat16 at head dims 32 and 96 (the *_mma_kernel bodies): mma.sync
// m16n8k16 bf16 products with float32 sums.  A warp owns 16 keys (dK/dV)
// or 16 queries (dQ) and walks the other side 16 at a time; S and dP (16 x
// 16) stay in registers, P and dS are packed straight into A fragments, the
// other operands come from shared memory by ldmatrix (.trans for the (k, n)
// row-major ones).  Each tile's 16-term product goes into a zeroed partial
// and is then added in float32.  The other side's tiles arrive by 16-byte
// cp.async in a two-stage ring.
// Numerics of both: P and dS are rounded to bf16 (relative 2^-9) before
// their products, as the reference's bf16_tiles option rounds them; D is
// summed from the unrounded float32 P and dP (step 1).
//
// float32 bodies: CUDA-core FMAs, 16 x 16 score tiles, one score a thread,
// then each thread accumulates 16 of its key's (or query's) head dims:
// simple and exact in float32; the training path's float32 runs are short.
//
// Build (see flash_attention_bwd.py): nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC.  Head dims 32,
// 64, 96 and 128.  The TMA, mbarrier and descriptor helpers and the host's
// tensor-map encoder are tma_wgmma.cuh's, shared with the forward.

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
using attn::load_rows;
using attn::LOG2E;
using attn::tile_masked;
using attn::tile_visible;
using attn::visible;
using hopper::aligned_smem;
using hopper::desc_kmajor;
using hopper::desc_mnmajor;
using hopper::fence_regs;
using hopper::kmajor;
using hopper::mbar_expect;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::mnmajor;
using hopper::tensor_map;
using hopper::tma_tile;
using hopper::wgmma_rs;
typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// float32: D = rowsum(dO * O), (B, H, Sq): one warp per (b, q, h) row, the
// rows taken in memory order.
// ---------------------------------------------------------------------------

constexpr int DELTA_ROWS = 8;  // rows (warps) a block

__global__ void __launch_bounds__(DELTA_ROWS * 32)
flash_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                       float* __restrict__ delta, int B, int Sq, int H, int hd) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * DELTA_ROWS + (threadIdx.x >> 5);
  if (row >= (long long)B * Sq * H) return;  // the whole warp
  const float* orow = o + row * hd;
  const float* drow = dout + row * hd;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s += orow[d] * drow[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int h = (int)(row % H);
    const long long bq = row / H;
    const int q = (int)(bq % Sq);
    const int b = (int)(bq / Sq);
    delta[((size_t)b * H + h) * Sq + q] = s;
  }
}

// bfloat16: the end of the dQ kernels' D pass.  The four threads of a quad
// (t = 0..3) hold partial sums of the same two query rows qr0 and qr1 over
// different keys; they are added in a fixed order and thread t = 0 writes
// them into the row's D (drow = delta at the head's row 0).
__device__ __forceinline__ void write_delta(float* drow, int qr0, int qr1, int Sq,
                                            float d0, float d1, int t) {
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
  if (t == 0) {
    if (qr0 < Sq) drow[qr0] = d0;
    if (qr1 < Sq) drow[qr1] = d1;
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at head dims 32 and 96: warp-level tensor-core products (mma.sync)
// ---------------------------------------------------------------------------

constexpr int BWD_BK = 64;  // keys a dK/dV block (4 warps of 16); keys a dQ stage
constexpr int BWD_BQ = 64;  // queries a dK/dV stage; queries a dQ block (4 warps)

template <int HD>
struct BwdTiles {
  static constexpr int NTHREADS = 4 * 32;
  static constexpr int LD = HD + 8;  // row stride (bf16): ldmatrix rows in distinct banks
  static constexpr int TILE = 64 * LD;  // elements of a 64-row tile
  // dK/dV: K and V, then two stages of (Q, dO) and two of (lse, D) floats.
  static constexpr int DKV_SMEM = (2 * TILE + 2 * 2 * TILE) * 2 + 2 * 2 * BWD_BQ * 4;
  // dQ: Q and dO, then two stages of (K, V).
  static constexpr int DQ_SMEM = (2 * TILE + 2 * 2 * TILE) * 2;
  static_assert(HD % 16 == 0, "head dims in chunks of 16");
  static_assert(BWD_BK == 64 && BWD_BQ == 64, "the 64-row tiles above");
};

template <int HD>
__global__ void __launch_bounds__(BwdTiles<HD>::NTHREADS)
flash_bwd_dkdv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int Sq, int Skv, int H, int KV,
                          int causal, int window, int chunk, float scale) {
  using TL = BwdTiles<HD>;
  constexpr int LD = TL::LD;
  constexpr int NT_O = HD / 8;  // n-tiles over head dims
  constexpr int KC = HD / 16;   // k-chunks over head dims
  constexpr int BQ = BWD_BQ;
  constexpr int BK = BWD_BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD]
  bf16* sv = sk + TL::TILE;                      // [BK][LD]
  bf16* sqd = sv + TL::TILE;  // stage s: Q tile at 2s, dO tile at 2s + 1
  float* sst = reinterpret_cast<float*>(sqd + 4 * TL::TILE);  // stage s: lse log2 e, D

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int k0 = blockIdx.y * BK;
  const int k_hi = min(k0 + BK, Skv) - 1;
  const size_t q_stride = (size_t)H * HD;  // elements between positions
  const size_t kv_stride = (size_t)KV * HD;
  const size_t kv_off = (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int n_it = G * n_qt;  // (query head, query tile) pairs, head-major
  const float scale_log2 = scale * LOG2E;

  // The next (head, query tile) at or after `it` whose tile meets a key of
  // this block's.
  auto next_it = [&](int it) {
    while (it < n_it) {
      const int q0 = (it % n_qt) * BQ;
      if (!tile_masked(q0, min(q0 + BQ, Sq) - 1, k0, k_hi, causal, window, chunk))
        break;
      ++it;
    }
    return it;
  };
  auto load_stage = [&](int it, int stage) {
    const int h = kvh * G + it / n_qt;
    const int q0 = (it % n_qt) * BQ;
    const size_t off = (size_t)b * Sq * q_stride + (size_t)h * HD;
    bf16* dst = sqd + stage * 2 * TL::TILE;
    load_rows<HD, LD, TL::NTHREADS>(dst, q + off, q_stride, q0, BQ, Sq, tid);
    load_rows<HD, LD, TL::NTHREADS>(dst + TL::TILE, dout + off, q_stride, q0, BQ,
                                    Sq, tid);
    float* st = sst + stage * 2 * BQ;
    const size_t row = ((size_t)b * H + h) * Sq;
    for (int i = tid; i < BQ; i += TL::NTHREADS) {
      const bool in = q0 + i < Sq;
      st[i] = in ? lse[row + q0 + i] * LOG2E : 0.f;
      st[BQ + i] = in ? delta[row + q0 + i] : 0.f;
    }
  };

  load_rows<HD, LD, TL::NTHREADS>(sk, k + kv_off, kv_stride, k0, BK, Skv, tid);
  load_rows<HD, LD, TL::NTHREADS>(sv, v + kv_off, kv_stride, k0, BK, Skv, tid);
  int it = next_it(0);
  if (it < n_it) load_stage(it, 0);
  mma::cp_async_commit();

  float dka[NT_O][4], dva[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
  const int wk0 = k0 + warp * 16;  // this warp's keys: rows g and g + 8 of its C fragments
  const int kr0 = wk0 + g;
  const int kr1 = kr0 + 8;

  int stage = 0;
  while (it < n_it) {
    const int nit = next_it(it + 1);
    if (nit < n_it) load_stage(nit, stage ^ 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();  // K, V and this stage have landed (this thread's part)
    __syncthreads();          // ... and every thread's
    const int q0 = (it % n_qt) * BQ;
    const bf16* sq = sqd + stage * 2 * TL::TILE;
    const bf16* sdo = sq + TL::TILE;
    const float* slse = sst + stage * 2 * BQ;
    const float* sD = slse + BQ;
#pragma unroll 1
    for (int qs = 0; qs < BQ; qs += 16) {  // 16 queries at a time; no barrier inside
      const int qa = q0 + qs;
      if (qa >= Sq) break;
      if (tile_masked(qa, qa + 15, wk0, wk0 + 15, causal, window, chunk)) continue;
      // S^T = K Q^T and dP^T = V dO^T, (16 keys x 16 queries) each.
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t af[4], bf[4];
        mma::ldmatrix_x4(af, sk + (warp * 16 + mma::a_row(lane)) * LD + kc * 16 +
                                 mma::a_col(lane));
        mma::ldmatrix_x4(bf, sq + (qs + mma::bnk_row(lane)) * LD + kc * 16 +
                                 mma::bnk_col(lane));
        mma::mma_bf16(s[0], af, bf[0], bf[1]);
        mma::mma_bf16(s[1], af, bf[2], bf[3]);
        mma::ldmatrix_x4(af, sv + (warp * 16 + mma::a_row(lane)) * LD + kc * 16 +
                                 mma::a_col(lane));
        mma::ldmatrix_x4(bf, sdo + (qs + mma::bnk_row(lane)) * LD + kc * 16 +
                                 mma::bnk_col(lane));
        mma::mma_bf16(dp[0], af, bf[0], bf[1]);
        mma::mma_bf16(dp[1], af, bf[2], bf[3]);
      }
      // P^T and dS^T on the fragments: element (j, e) is key row e < 2 ? g :
      // g + 8, query column j * 8 + 2 t + (e & 1).
      const bool all = wk0 + 15 < Skv && qa + 15 < Sq &&
                       tile_visible(qa, qa + 15, wk0, wk0 + 15, causal, window, chunk);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = qs + j * 8 + 2 * t + (e & 1);
          const int qi = q0 + qc;
          const int kj = e < 2 ? kr0 : kr1;
          const bool ok =
              all || (kj < Skv && qi < Sq && visible(qi, kj, causal, window, chunk));
          const float p = ok ? exp2f(s[j][e] * scale_log2 - slse[qc]) : 0.f;
          dp[j][e] = p * (dp[j][e] - sD[qc]) * scale;
          s[j][e] = p;
        }
      uint32_t pa[4], da[4];
      mma::pack_a(pa, s[0], s[1]);
      mma::pack_a(da, dp[0], dp[1]);
      // dV += P^T dO and dK += dS^T Q, each 16-query product into a zeroed
      // partial first.
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        uint32_t bf[4];
        float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
        mma::ldmatrix_x4_trans(bf, sdo + (qs + mma::bkn_row(lane)) * LD + np * 16 +
                                       mma::bkn_col(lane));
        mma::mma_bf16(p0, pa, bf[0], bf[1]);
        mma::mma_bf16(p1, pa, bf[2], bf[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dva[2 * np][e] += p0[e];
          dva[2 * np + 1][e] += p1[e];
          p0[e] = p1[e] = 0.f;
        }
        mma::ldmatrix_x4_trans(bf, sq + (qs + mma::bkn_row(lane)) * LD + np * 16 +
                                       mma::bkn_col(lane));
        mma::mma_bf16(p0, da, bf[0], bf[1]);
        mma::mma_bf16(p1, da, bf[2], bf[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dka[2 * np][e] += p0[e];
          dka[2 * np + 1][e] += p1[e];
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
    stage ^= 1;
    it = nit;
  }
  mma::cp_async_wait<0>();

  bf16* dkb = dk + kv_off;
  bf16* dvb = dv + kv_off;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int d = j * 8 + 2 * t;
    if (kr0 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)kr0 * kv_stride + d) =
          __floats2bfloat162_rn(dka[j][0], dka[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)kr0 * kv_stride + d) =
          __floats2bfloat162_rn(dva[j][0], dva[j][1]);
    }
    if (kr1 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)kr1 * kv_stride + d) =
          __floats2bfloat162_rn(dka[j][2], dka[j][3]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)kr1 * kv_stride + d) =
          __floats2bfloat162_rn(dva[j][2], dva[j][3]);
    }
  }
}

// With DELTA, the D pass: the same walk over the key tiles computes S and
// dP, and writes each query row's D = rowsum(P * dP) instead of dQ.
template <int HD, bool DELTA>
__global__ void __launch_bounds__(BwdTiles<HD>::NTHREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, float* __restrict__ delta,
                        bf16* __restrict__ dq, int Sq, int Skv, int H, int KV,
                        int causal, int window, int chunk, float scale) {
  using TL = BwdTiles<HD>;
  constexpr int LD = TL::LD;
  constexpr int NT_O = HD / 8;
  constexpr int KC = HD / 16;
  constexpr int BQ = BWD_BQ;
  constexpr int BK = BWD_BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sdo = sq + TL::TILE;                     // [BQ][LD]
  bf16* skv = sdo + TL::TILE;  // stage s: K tile at 2s, V tile at 2s + 1

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest q-tile first
  const int q_hi = min(q0 + BQ, Sq) - 1;
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KV * HD;
  const size_t q_off = (size_t)b * Sq * q_stride + (size_t)h * HD;
  const bf16* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  const bf16* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  const int n_kb = (Skv + BK - 1) / BK;
  const float scale_log2 = scale * LOG2E;

  auto next_tile = [&](int kt) {
    while (kt < n_kb &&
           tile_masked(q0, q_hi, kt * BK, min(kt * BK + BK, Skv) - 1, causal, window,
                       chunk))
      ++kt;
    return kt;
  };
  auto load_kv = [&](int kt, int stage) {
    bf16* dst = skv + stage * 2 * TL::TILE;
    load_rows<HD, LD, TL::NTHREADS>(dst, kb, kv_stride, kt * BK, BK, Skv, tid);
    load_rows<HD, LD, TL::NTHREADS>(dst + TL::TILE, vb, kv_stride, kt * BK, BK, Skv,
                                    tid);
  };

  int kt = next_tile(0);
  load_rows<HD, LD, TL::NTHREADS>(sq, q + q_off, q_stride, q0, BQ, Sq, tid);
  load_rows<HD, LD, TL::NTHREADS>(sdo, dout + q_off, q_stride, q0, BQ, Sq, tid);
  if (kt < n_kb) load_kv(kt, 0);
  mma::cp_async_commit();

  // This warp's queries: rows g and g + 8 of its fragments.
  const int wq0 = q0 + warp * 16;
  const int qr0 = wq0 + g;
  const int qr1 = qr0 + 8;
  const size_t srow = ((size_t)b * H + h) * Sq;
  const float lse0 = qr0 < Sq ? lse[srow + qr0] * LOG2E : 0.f;
  const float lse1 = qr1 < Sq ? lse[srow + qr1] * LOG2E : 0.f;
  const float D0 = !DELTA && qr0 < Sq ? delta[srow + qr0] : 0.f;
  const float D1 = !DELTA && qr1 < Sq ? delta[srow + qr1] : 0.f;
  float dsum0 = 0.f, dsum1 = 0.f;  // the D pass's rows qr0 and qr1, this thread's keys
  uint32_t qf[KC][4], of[KC][4];
  float dqa[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  bool first = true;
  int stage = 0;
  while (kt < n_kb) {
    const int nk = next_tile(kt + 1);
    if (nk < n_kb) load_kv(nk, stage ^ 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();
    if (first) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        mma::ldmatrix_x4(qf[kc], sq + (warp * 16 + mma::a_row(lane)) * LD + kc * 16 +
                                     mma::a_col(lane));
        mma::ldmatrix_x4(of[kc], sdo + (warp * 16 + mma::a_row(lane)) * LD + kc * 16 +
                                     mma::a_col(lane));
      }
      first = false;
    }
    const bf16* sk = skv + stage * 2 * TL::TILE;
    const bf16* sv = sk + TL::TILE;
    const int k0 = kt * BK;
#pragma unroll 1
    for (int ks = 0; ks < BK; ks += 16) {  // 16 keys at a time; no barrier inside
      const int ka = k0 + ks;
      if (ka >= Skv) break;
      if (tile_masked(wq0, wq0 + 15, ka, ka + 15, causal, window, chunk)) continue;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t bf[4];
        mma::ldmatrix_x4(bf, sk + (ks + mma::bnk_row(lane)) * LD + kc * 16 +
                                 mma::bnk_col(lane));
        mma::mma_bf16(s[0], qf[kc], bf[0], bf[1]);
        mma::mma_bf16(s[1], qf[kc], bf[2], bf[3]);
        mma::ldmatrix_x4(bf, sv + (ks + mma::bnk_row(lane)) * LD + kc * 16 +
                                 mma::bnk_col(lane));
        mma::mma_bf16(dp[0], of[kc], bf[0], bf[1]);
        mma::mma_bf16(dp[1], of[kc], bf[2], bf[3]);
      }
      // dS on the fragments: element (j, e) is query row e < 2 ? g : g + 8,
      // key column j * 8 + 2 t + (e & 1).
      const bool all = ka + 15 < Skv && wq0 + 15 < Sq &&
                       tile_visible(wq0, wq0 + 15, ka, ka + 15, causal, window, chunk);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = ka + j * 8 + 2 * t + (e & 1);
          const int qi = e < 2 ? qr0 : qr1;
          const bool ok =
              all || (kj < Skv && qi < Sq && visible(qi, kj, causal, window, chunk));
          const float p = ok ? exp2f(s[j][e] * scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
          if constexpr (DELTA)
            (e < 2 ? dsum0 : dsum1) += p * dp[j][e];
          else
            dp[j][e] = p * (dp[j][e] - (e < 2 ? D0 : D1)) * scale;
        }
      if constexpr (DELTA) continue;
      uint32_t da[4];
      mma::pack_a(da, dp[0], dp[1]);
      // dQ += dS K, each 16-key product into a zeroed partial first.
#pragma unroll
      for (int np = 0; np < NT_O / 2; ++np) {
        uint32_t bf[4];
        float p0[4] = {0.f, 0.f, 0.f, 0.f}, p1[4] = {0.f, 0.f, 0.f, 0.f};
        mma::ldmatrix_x4_trans(bf, sk + (ks + mma::bkn_row(lane)) * LD + np * 16 +
                                       mma::bkn_col(lane));
        mma::mma_bf16(p0, da, bf[0], bf[1]);
        mma::mma_bf16(p1, da, bf[2], bf[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dqa[2 * np][e] += p0[e];
          dqa[2 * np + 1][e] += p1[e];
        }
      }
    }
    __syncthreads();
    stage ^= 1;
    kt = nk;
  }
  mma::cp_async_wait<0>();
  if constexpr (DELTA) {
    write_delta(delta + srow, qr0, qr1, Sq, dsum0, dsum1, t);
    return;
  }

  bf16* dqb = dq + q_off;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int d = j * 8 + 2 * t;
    if (qr0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)qr0 * q_stride + d) =
          __floats2bfloat162_rn(dqa[j][0], dqa[j][1]);
    if (qr1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)qr1 * q_stride + d) =
          __floats2bfloat162_rn(dqa[j][2], dqa[j][3]);
  }
}

// ---------------------------------------------------------------------------
// bfloat16 at head dims 64 and 128: warpgroup tensor cores (wgmma)
// ---------------------------------------------------------------------------

// 4 bytes (one float) global -> shared; with `full` false zero-filled and
// nothing read.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(n)
               : "memory");
}

template <int HD>
struct WgTiles {
  static constexpr int NWG = 2;  // consumer warpgroups a block, 64 rows each
  static constexpr int NTHREADS = NWG * 128;
  static constexpr int ROW = HD * 2;  // bytes of a row
  // Rings of the streamed tiles, loaded two tiles ahead: the refilled stage
  // is the previous tile's, whose products every warpgroup waited for
  // before the barrier.
  static constexpr int STAGES = 3;
  // dK/dV: K and V resident, 64 keys a warpgroup; Q, dO, lse, D streamed.
  static constexpr int DKV_KEYS = NWG * 64;
  static constexpr int DKV_QUERIES = 64;  // a stage
  static constexpr int KV_BYTES = DKV_KEYS * ROW;
  static constexpr int QT_BYTES = DKV_QUERIES * ROW;
  // Q and dO, then lse and D (2 x 64 floats) padded to a 1024-byte atom
  static constexpr int DKV_STAGE = 2 * QT_BYTES + 1024;
  static constexpr int BAR_BYTES = 64;  // the mbarriers
  static constexpr int DKV_SMEM = 2 * KV_BYTES + STAGES * DKV_STAGE + BAR_BYTES + 1024;
  // dQ: Q and dO resident, 64 queries a warpgroup; K and V streamed.
  static constexpr int DQ_QUERIES = NWG * 64;
  static constexpr int DQ_KEYS = 64;  // a stage
  static constexpr int QB_BYTES = DQ_QUERIES * ROW;
  static constexpr int KT_BYTES = DQ_KEYS * ROW;
  static constexpr int DQ_STAGE = 2 * KT_BYTES;
  static constexpr int DQ_SMEM = 2 * QB_BYTES + STAGES * DQ_STAGE + BAR_BYTES + 1024;
  static_assert(HD == 64 || HD == 128, "wgmma bodies at head dims 64 and 128");
  static_assert(DKV_SMEM <= 232448 && DQ_SMEM <= 232448, "one block's shared memory");
};

template <int HD>
__global__ void __launch_bounds__(WgTiles<HD>::NTHREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, int Sq, int Skv, int H, int KV,
                            int causal, int window, int chunk, float scale) {
  using TL = WgTiles<HD>;
  constexpr int BQ = TL::DKV_QUERIES;
  constexpr int BKV = TL::DKV_KEYS;
  constexpr int KC = HD / 16;   // k-steps of S^T and dP^T
  constexpr int NT_O = HD / 8;  // n-tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  unsigned char* sk = aligned_smem(smem_dyn);  // BKV swizzled rows
  unsigned char* sv = sk + TL::KV_BYTES;
  unsigned char* ring = sv + TL::KV_BYTES;  // stage s: Q, dO, lse, D
  // mbarriers: full[s], stage s's Q and dO have landed; kv_bar, K and V
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + TL::STAGES * TL::DKV_STAGE);
  uint64_t* kv_bar = full + TL::STAGES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int k0 = blockIdx.y * BKV;
  const int k_hi = min(k0 + BKV, Skv) - 1;
  const int wk0 = k0 + wg * 64;  // this warpgroup's keys, wk0..wk_hi (none if wk_hi < wk0)
  const int wk_hi = min(wk0 + 64, Skv) - 1;
  const int kr0 = wk0 + ((tid >> 5) & 3) * 16 + g;  // this thread's: rows g, g + 8 of its warp
  const int kr1 = kr0 + 8;
  const size_t kv_stride = (size_t)KV * HD;  // elements between positions
  const size_t kv_off = (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int n_it = G * n_qt;  // (query head, query tile) pairs, head-major
  const float scale_log2 = scale * LOG2E;

  // The next (head, query tile) at or after `it` whose tile meets a key of
  // this block's.
  auto next_it = [&](int it) {
    while (it < n_it) {
      const int q0 = (it % n_qt) * BQ;
      if (!tile_masked(q0, min(q0 + BQ, Sq) - 1, k0, k_hi, causal, window, chunk)) break;
      ++it;
    }
    return it;
  };
  // Q and dO by TMA (one thread), lse and D by cp.async (128 threads).
  auto load_stage = [&](int it, int slot) {
    const int h = kvh * G + it / n_qt;
    const int q0 = (it % n_qt) * BQ;
    unsigned char* st = ring + slot * TL::DKV_STAGE;
    if (tid == 0) {
      mbar_expect(full + slot, 2 * TL::QT_BYTES);
      tma_tile<HD, BQ>(st, &tq, h, q0, b, full + slot);
      tma_tile<HD, BQ>(st + TL::QT_BYTES, &tdo, h, q0, b, full + slot);
    }
    if (tid < 2 * BQ) {  // lse (threads 0..63) and D (64..127) of the tile's rows
      const int i = tid % BQ;
      const bool in = q0 + i < Sq;
      const float* src = tid < BQ ? lse : delta;
      cp_async4(reinterpret_cast<float*>(st + 2 * TL::QT_BYTES) + tid,
                in ? src + ((size_t)b * H + h) * Sq + q0 + i : src, in);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < TL::STAGES; ++s) mbar_init(full + s, 1);
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(kv_bar, 2 * TL::KV_BYTES);
    tma_tile<HD, BKV>(sk, &tk, kvh, k0, b, kv_bar);
    tma_tile<HD, BKV>(sv, &tv, kvh, k0, b, kv_bar);
  }
  __syncthreads();  // the barriers are set up
  int it = next_it(0);
  if (it < n_it) load_stage(it, 0);
  mma::cp_async_commit();
  int nxt = it < n_it ? next_it(it + 1) : n_it;
  if (nxt < n_it) load_stage(nxt, 1);
  mma::cp_async_commit();

  const uint64_t dsk = desc_kmajor(sk + wg * 64 * 128);  // this warpgroup's K and V rows
  const uint64_t dsv = desc_kmajor(sv + wg * 64 * 128);
  float dka[NT_O][4], dva[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  mbar_wait(kv_bar, 0);
  int slot = 0;
  for (int c = 0; it < n_it; ++c) {
    mbar_wait(full + slot, (c / TL::STAGES) & 1);  // this stage's Q and dO
    mma::cp_async_wait<1>();  // its lse and D (this thread's part)
    __syncthreads();          // every thread's part; every warpgroup done with slot - 1
    const int after = nxt < n_it ? next_it(nxt + 1) : n_it;
    if (after < n_it) load_stage(after, (slot + 2) % TL::STAGES);
    mma::cp_async_commit();
    const int q0 = (it % n_qt) * BQ;
    const int q_hi = min(q0 + BQ, Sq) - 1;
    if (wk0 <= wk_hi && !tile_masked(q0, q_hi, wk0, wk_hi, causal, window, chunk)) {
      const unsigned char* sq = ring + slot * TL::DKV_STAGE;
      const unsigned char* sdo = sq + TL::QT_BYTES;
      const float* slse = reinterpret_cast<const float*>(sdo + TL::QT_BYTES);
      const float* sD = slse + BQ;
      // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 queries, k over head
      // dims: two groups, so that P^T is computed while dP^T runs on.
      const uint64_t dsq = desc_kmajor(sq), dsdo = desc_kmajor(sdo);
      float s[8][4], dp[8][4];
      mma::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        mma::wgmma_m64n64k16_ss_kk(s, kmajor<BKV>(dsk, kk), kmajor<BQ>(dsq, kk), kk > 0);
      mma::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        mma::wgmma_m64n64k16_ss_kk(dp, kmajor<BKV>(dsv, kk), kmajor<BQ>(dsdo, kk), kk > 0);
      mma::wgmma_commit();
      // P^T and dS^T on the accumulators: element (j, e) is key kr0 (e < 2)
      // or kr1, query q0 + j * 8 + 2 t + (e & 1); bit 4 j + e of `seen` says
      // whether the pair is visible.  Only `seen` is set under a branch: the
      // registers the next products read are written in straight-line code
      // (ptxas serializes every wgmma of a kernel that writes them in a
      // divergent path).
      uint32_t seen = 0xffffffffu;
      if (!(wk_hi == wk0 + 63 && q_hi == q0 + BQ - 1 &&
            tile_visible(q0, q_hi, wk0, wk_hi, causal, window, chunk))) {
        seen = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + j * 8 + 2 * t + (e & 1);
            const int kj = e < 2 ? kr0 : kr1;
            if (kj < Skv && qi < Sq && visible(qi, kj, causal, window, chunk))
              seen |= 1u << (4 * j + e);
          }
      }
      mma::wgmma_wait<1>();  // S^T is done
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(slse + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse2 = (e & 1 ? l.y : l.x) * LOG2E;
          s[j][e] = (seen >> (4 * j + e)) & 1 ? exp2_approx(fmaf(s[j][e], scale_log2, -lse2))
                                              : 0.f;
        }
      }
      mma::wgmma_wait<0>();  // dP^T is done
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(sD + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - (e & 1 ? d.y : d.x)) * scale;
      }
      uint32_t pa[4][4], da[4][4];  // A fragments over 16 queries each
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        mma::pack_a(pa[kc], s[2 * kc], s[2 * kc + 1]);
        mma::pack_a(da[kc], dp[2 * kc], dp[2 * kc + 1]);
      }
      // dV += P^T dO and dK += dS^T Q: k over the 64 queries, B read MN-major.
      mma::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<HD>(dva, pa[kc], mnmajor(desc_mnmajor<BQ>(sdo), kc));
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        wgmma_rs<HD>(dka, da[kc], mnmajor(desc_mnmajor<BQ>(sq), kc));
      mma::wgmma_commit();
      mma::wgmma_wait<0>();
    }
    slot = (slot + 1) % TL::STAGES;
    it = nxt;
    nxt = after;
  }
  mma::cp_async_wait<0>();

  bf16* dkb = dk + kv_off;
  bf16* dvb = dv + kv_off;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int d = j * 8 + 2 * t;
    if (kr0 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)kr0 * kv_stride + d) =
          __floats2bfloat162_rn(dka[j][0], dka[j][1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)kr0 * kv_stride + d) =
          __floats2bfloat162_rn(dva[j][0], dva[j][1]);
    }
    if (kr1 < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)kr1 * kv_stride + d) =
          __floats2bfloat162_rn(dka[j][2], dka[j][3]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)kr1 * kv_stride + d) =
          __floats2bfloat162_rn(dva[j][2], dva[j][3]);
    }
  }
}

// With DELTA, the D pass: the same walk computes S and dP and writes each
// query row's D = rowsum(P * dP) instead of dQ.
template <int HD, bool DELTA>
__global__ void __launch_bounds__(WgTiles<HD>::NTHREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse, float* __restrict__ delta,
                          bf16* __restrict__ dq, int Sq, int Skv, int H, int KV,
                          int causal, int window, int chunk, float scale) {
  using TL = WgTiles<HD>;
  constexpr int BQB = TL::DQ_QUERIES;
  constexpr int BK = TL::DQ_KEYS;
  constexpr int KC = HD / 16;   // k-steps of S and dP
  constexpr int NT_O = HD / 8;  // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_dyn[];
  unsigned char* sq = aligned_smem(smem_dyn);  // BQB swizzled rows
  unsigned char* sdo = sq + TL::QB_BYTES;
  unsigned char* ring = sdo + TL::QB_BYTES;  // stage s: K, V
  // mbarriers: full[s], stage s's K and V have landed; q_bar, Q and dO
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + TL::STAGES * TL::DQ_STAGE);
  uint64_t* q_bar = full + TL::STAGES;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQB;  // heaviest query tile first
  const int q_hi = min(q0 + BQB, Sq) - 1;
  const int wq0 = q0 + wg * 64;  // this warpgroup's queries, wq0..wq_hi (none if wq_hi < wq0)
  const int wq_hi = min(wq0 + 64, Sq) - 1;
  const int qr0 = wq0 + ((tid >> 5) & 3) * 16 + g;  // this thread's: rows g, g + 8 of its warp
  const int qr1 = qr0 + 8;
  const size_t q_stride = (size_t)H * HD;  // elements between positions
  const size_t q_off = (size_t)b * Sq * q_stride + (size_t)h * HD;
  const int n_kb = (Skv + BK - 1) / BK;
  const float scale_log2 = scale * LOG2E;

  auto next_tile = [&](int kt) {
    while (kt < n_kb &&
           tile_masked(q0, q_hi, kt * BK, min(kt * BK + BK, Skv) - 1, causal, window, chunk))
      ++kt;
    return kt;
  };
  auto load_kv = [&](int kt, int slot) {  // by TMA, one thread
    if (tid != 0) return;
    unsigned char* st = ring + slot * TL::DQ_STAGE;
    mbar_expect(full + slot, 2 * TL::KT_BYTES);
    tma_tile<HD, BK>(st, &tk, kvh, kt * BK, b, full + slot);
    tma_tile<HD, BK>(st + TL::KT_BYTES, &tv, kvh, kt * BK, b, full + slot);
  };

  if (tid == 0) {
    for (int s = 0; s < TL::STAGES; ++s) mbar_init(full + s, 1);
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(q_bar, 2 * TL::QB_BYTES);
    tma_tile<HD, BQB>(sq, &tq, h, q0, b, q_bar);
    tma_tile<HD, BQB>(sdo, &tdo, h, q0, b, q_bar);
  }
  __syncthreads();  // the barriers are set up
  int kt = next_tile(0);
  if (kt < n_kb) load_kv(kt, 0);
  int nk = kt < n_kb ? next_tile(kt + 1) : n_kb;
  if (nk < n_kb) load_kv(nk, 1);

  const size_t srow = ((size_t)b * H + h) * Sq;
  const float lse0 = qr0 < Sq ? lse[srow + qr0] * LOG2E : 0.f;
  const float lse1 = qr1 < Sq ? lse[srow + qr1] * LOG2E : 0.f;
  const float D0 = !DELTA && qr0 < Sq ? delta[srow + qr0] : 0.f;
  const float D1 = !DELTA && qr1 < Sq ? delta[srow + qr1] : 0.f;
  float dsum0 = 0.f, dsum1 = 0.f;  // the D pass's rows qr0 and qr1, this thread's keys
  const uint64_t dsq = desc_kmajor(sq + wg * 64 * 128);  // this warpgroup's Q and dO rows
  const uint64_t dsdo = desc_kmajor(sdo + wg * 64 * 128);
  float dqa[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

  mbar_wait(q_bar, 0);
  int slot = 0;
  for (int c = 0; kt < n_kb; ++c) {
    mbar_wait(full + slot, (c / TL::STAGES) & 1);  // this stage's K and V
    __syncthreads();  // every warpgroup done with slot - 1
    const int after = nk < n_kb ? next_tile(nk + 1) : n_kb;
    if (after < n_kb) load_kv(after, (slot + 2) % TL::STAGES);
    const int k0 = kt * BK;
    const int kh = min(k0 + BK, Skv) - 1;
    if (wq0 <= wq_hi && !tile_masked(wq0, wq_hi, k0, kh, causal, window, chunk)) {
      const unsigned char* sk = ring + slot * TL::DQ_STAGE;
      const unsigned char* sv = sk + TL::KT_BYTES;
      // S = Q K^T and dP = dO V^T, 64 queries x 64 keys, k over head dims:
      // two groups, so that P is computed while dP runs on.
      const uint64_t dsk = desc_kmajor(sk), dsv = desc_kmajor(sv);
      float s[8][4], dp[8][4];
      mma::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        mma::wgmma_m64n64k16_ss_kk(s, kmajor<BQB>(dsq, kk), kmajor<BK>(dsk, kk), kk > 0);
      mma::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        mma::wgmma_m64n64k16_ss_kk(dp, kmajor<BQB>(dsdo, kk), kmajor<BK>(dsv, kk), kk > 0);
      mma::wgmma_commit();
      // dS on the accumulators: element (j, e) is query qr0 (e < 2) or qr1,
      // key k0 + j * 8 + 2 t + (e & 1); bit 4 j + e of `seen` says whether
      // the pair is visible (set under a branch, as in the dK/dV kernel).
      uint32_t seen = 0xffffffffu;
      if (!(kh == k0 + BK - 1 && wq_hi == wq0 + 63 &&
            tile_visible(wq0, wq_hi, k0, kh, causal, window, chunk))) {
        seen = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            const int qi = e < 2 ? qr0 : qr1;
            if (kj < Skv && qi < Sq && visible(qi, kj, causal, window, chunk))
              seen |= 1u << (4 * j + e);
          }
      }
      mma::wgmma_wait<1>();  // S is done
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = (seen >> (4 * j + e)) & 1
                        ? exp2_approx(fmaf(s[j][e], scale_log2, -(e < 2 ? lse0 : lse1)))
                        : 0.f;
      mma::wgmma_wait<0>();  // dP is done
      fence_regs(dp);
      if constexpr (DELTA) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) (e < 2 ? dsum0 : dsum1) += s[j][e] * dp[j][e];
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[j][e] = s[j][e] * (dp[j][e] - (e < 2 ? D0 : D1)) * scale;
        uint32_t da[4][4];  // A fragments over 16 keys each
#pragma unroll
        for (int kc = 0; kc < 4; ++kc) mma::pack_a(da[kc], dp[2 * kc], dp[2 * kc + 1]);
        // dQ += dS K: k over the 64 keys, K read MN-major.
        mma::wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 4; ++kc)
          wgmma_rs<HD>(dqa, da[kc], mnmajor(desc_mnmajor<BK>(sk), kc));
        mma::wgmma_commit();
        mma::wgmma_wait<0>();
      }
    }
    slot = (slot + 1) % TL::STAGES;
    kt = nk;
    nk = after;
  }
  if constexpr (DELTA) {
    write_delta(delta + srow, qr0, qr1, Sq, dsum0, dsum1, t);
    return;
  }
  bf16* dqb = dq + q_off;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int d = j * 8 + 2 * t;
    if (qr0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)qr0 * q_stride + d) =
          __floats2bfloat162_rn(dqa[j][0], dqa[j][1]);
    if (qr1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)qr1 * q_stride + d) =
          __floats2bfloat162_rn(dqa[j][2], dqa[j][3]);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int FT = 16;           // queries and keys of a float32 score tile
constexpr int F32_THREADS = 256;  // one score of the tile a thread

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, float* __restrict__ dk,
                          float* __restrict__ dv, int Sq, int Skv, int H, int KV,
                          int causal, int window, int chunk, float scale) {
  constexpr int LDF = HD + 1;
  constexpr int EPT = HD / 16;  // head dims a thread accumulates
  __shared__ float sk[FT][LDF], sv[FT][LDF], sq[FT][LDF], sdo[FT][LDF];
  __shared__ float sp[FT][FT + 1], sds[FT][FT + 1], slse[FT], sD[FT];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / KV;
  const int kvh = blockIdx.x % KV;
  const int G = H / KV;
  const int k0 = blockIdx.y * FT;
  const int k_hi = min(k0 + FT, Skv) - 1;
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KV * HD;
  const size_t kv_off = (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  for (int i = tid; i < FT * HD; i += F32_THREADS) {
    const int r = i / HD, d = i % HD;
    const bool in = k0 + r < Skv;
    sk[r][d] = in ? k[kv_off + (size_t)(k0 + r) * kv_stride + d] : 0.f;
    sv[r][d] = in ? v[kv_off + (size_t)(k0 + r) * kv_stride + d] : 0.f;
  }
  const int si = tid / FT, sj = tid % FT;  // this thread's score: query si, key sj
  const int kk = tid / FT, d0 = tid % FT;  // its accumulators: key kk, dims d0 + 16 e
  float dka[EPT], dva[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) dka[e] = dva[e] = 0.f;
  const int n_qt = (Sq + FT - 1) / FT;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const size_t q_off = (size_t)b * Sq * q_stride + (size_t)h * HD;
    const size_t srow = ((size_t)b * H + h) * Sq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * FT;
      if (tile_masked(q0, min(q0 + FT, Sq) - 1, k0, k_hi, causal, window, chunk)) continue;
      __syncthreads();  // the previous tile's reads are done
      for (int i = tid; i < FT * HD; i += F32_THREADS) {
        const int r = i / HD, d = i % HD;
        const bool in = q0 + r < Sq;
        sq[r][d] = in ? q[q_off + (size_t)(q0 + r) * q_stride + d] : 0.f;
        sdo[r][d] = in ? dout[q_off + (size_t)(q0 + r) * q_stride + d] : 0.f;
      }
      if (tid < FT) {
        const bool in = q0 + tid < Sq;
        slse[tid] = in ? lse[srow + q0 + tid] : 0.f;
        sD[tid] = in ? delta[srow + q0 + tid] : 0.f;
      }
      __syncthreads();
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        s = fmaf(sq[si][d], sk[sj][d], s);
        dp = fmaf(sdo[si][d], sv[sj][d], dp);
      }
      const int qi = q0 + si, kj = k0 + sj;
      const bool ok = qi < Sq && kj < Skv && visible(qi, kj, causal, window, chunk);
      const float p = ok ? expf(s * scale - slse[si]) : 0.f;
      sp[si][sj] = p;
      sds[si][sj] = p * (dp - sD[si]) * scale;
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < FT; ++r) {
        const float pr = sp[r][kk], dr = sds[r][kk];
#pragma unroll
        for (int e = 0; e < EPT; ++e) {
          dva[e] = fmaf(pr, sdo[r][d0 + 16 * e], dva[e]);
          dka[e] = fmaf(dr, sq[r][d0 + 16 * e], dka[e]);
        }
      }
    }
  }
  const int kj = k0 + kk;
  if (kj < Skv) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      dk[kv_off + (size_t)kj * kv_stride + d0 + 16 * e] = dka[e];
      dv[kv_off + (size_t)kj * kv_stride + d0 + 16 * e] = dva[e];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(F32_THREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int Sq, int Skv, int H, int KV,
                        int causal, int window, int chunk, float scale) {
  constexpr int LDF = HD + 1;
  constexpr int EPT = HD / 16;
  __shared__ float sk[FT][LDF], sv[FT][LDF], sq[FT][LDF], sdo[FT][LDF];
  __shared__ float sds[FT][FT + 1], slse[FT], sD[FT];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * FT;
  const int q_hi = min(q0 + FT, Sq) - 1;
  const size_t q_stride = (size_t)H * HD;
  const size_t kv_stride = (size_t)KV * HD;
  const size_t q_off = (size_t)b * Sq * q_stride + (size_t)h * HD;
  const size_t kv_off = (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  const size_t srow = ((size_t)b * H + h) * Sq;
  for (int i = tid; i < FT * HD; i += F32_THREADS) {
    const int r = i / HD, d = i % HD;
    const bool in = q0 + r < Sq;
    sq[r][d] = in ? q[q_off + (size_t)(q0 + r) * q_stride + d] : 0.f;
    sdo[r][d] = in ? dout[q_off + (size_t)(q0 + r) * q_stride + d] : 0.f;
  }
  if (tid < FT) {
    const bool in = q0 + tid < Sq;
    slse[tid] = in ? lse[srow + q0 + tid] : 0.f;
    sD[tid] = in ? delta[srow + q0 + tid] : 0.f;
  }
  const int si = tid / FT, sj = tid % FT;  // this thread's score: query si, key sj
  const int qq = tid / FT, d0 = tid % FT;  // its accumulators: query qq, dims d0 + 16 e
  float dqa[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) dqa[e] = 0.f;
  const int n_kt = (Skv + FT - 1) / FT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * FT;
    if (tile_masked(q0, q_hi, k0, min(k0 + FT, Skv) - 1, causal, window, chunk)) continue;
    __syncthreads();  // the previous tile's reads (and the first loads) are done
    for (int i = tid; i < FT * HD; i += F32_THREADS) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < Skv;
      sk[r][d] = in ? k[kv_off + (size_t)(k0 + r) * kv_stride + d] : 0.f;
      sv[r][d] = in ? v[kv_off + (size_t)(k0 + r) * kv_stride + d] : 0.f;
    }
    __syncthreads();
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      s = fmaf(sq[si][d], sk[sj][d], s);
      dp = fmaf(sdo[si][d], sv[sj][d], dp);
    }
    const int qi = q0 + si, kj = k0 + sj;
    const bool ok = qi < Sq && kj < Skv && visible(qi, kj, causal, window, chunk);
    const float p = ok ? expf(s * scale - slse[si]) : 0.f;
    sds[si][sj] = p * (dp - sD[si]) * scale;
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < FT; ++c) {
      const float dc = sds[qq][c];
#pragma unroll
      for (int e = 0; e < EPT; ++e) dqa[e] = fmaf(dc, sk[c][d0 + 16 * e], dqa[e]);
    }
  }
  const int qi = q0 + qq;
  if (qi < Sq) {
#pragma unroll
    for (int e = 0; e < EPT; ++e) dq[q_off + (size_t)qi * q_stride + d0 + 16 * e] = dqa[e];
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, H, KV, hd, causal, window, chunk;
  float scale;
  cudaStream_t stream;
};

int launch_delta_f32(const BwdArgs& a) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  const unsigned blocks = (unsigned)((rows + DELTA_ROWS - 1) / DELTA_ROWS);
  flash_bwd_delta_kernel<<<blocks, DELTA_ROWS * 32, 0, a.stream>>>(
      static_cast<const float*>(a.o), static_cast<const float*>(a.dout), a.delta, a.B,
      a.Sq, a.H, a.hd);
  return (int)cudaGetLastError();
}

// The mma.sync bodies (head dims 32 and 96): the D pass, dK/dV, dQ.
template <int HD>
int launch_bf16_mma(const BwdArgs& a) {
  using TL = BwdTiles<HD>;
  static bool dkv_set[64], dq_set[64], dd_set[64];
  auto dkv = flash_bwd_dkdv_mma_kernel<HD>;
  auto dqk = flash_bwd_dq_mma_kernel<HD, false>;
  auto ddk = flash_bwd_dq_mma_kernel<HD, true>;
  cudaError_t e = mma::set_smem_once(dkv, TL::DKV_SMEM, dkv_set);
  if (e != cudaSuccess) return (int)e;
  e = mma::set_smem_once(dqk, TL::DQ_SMEM, dq_set);
  if (e != cudaSuccess) return (int)e;
  e = mma::set_smem_once(ddk, TL::DQ_SMEM, dd_set);
  if (e != cudaSuccess) return (int)e;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const dim3 dq_grid(a.B * a.H, (a.Sq + BWD_BQ - 1) / BWD_BQ);
  ddk<<<dq_grid, TL::NTHREADS, TL::DQ_SMEM, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, nullptr, a.Sq, a.Skv, a.H, a.KV, a.causal, a.window,
      a.chunk, a.scale);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  dkv<<<dim3(a.B * a.KV, (a.Skv + BWD_BK - 1) / BWD_BK), TL::NTHREADS, TL::DKV_SMEM,
        a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk),
                    static_cast<bf16*>(a.dv), a.Sq, a.Skv, a.H, a.KV, a.causal,
                    a.window, a.chunk, a.scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dqk<<<dq_grid, TL::NTHREADS, TL::DQ_SMEM, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dq), a.Sq, a.Skv, a.H, a.KV,
      a.causal, a.window, a.chunk, a.scale);
  return (int)cudaGetLastError();
}

// The wgmma bodies (head dims 64 and 128): the D pass, dK/dV, dQ.
template <int HD>
int launch_bf16_wgmma(const BwdArgs& a) {
  using TL = WgTiles<HD>;
  static bool dkv_set[64], dq_set[64], dd_set[64];
  auto dkv = flash_bwd_dkdv_wgmma_kernel<HD>;
  auto dqk = flash_bwd_dq_wgmma_kernel<HD, false>;
  auto ddk = flash_bwd_dq_wgmma_kernel<HD, true>;
  cudaError_t e = mma::set_smem_once(dkv, TL::DKV_SMEM, dkv_set);
  if (e != cudaSuccess) return (int)e;
  e = mma::set_smem_once(dqk, TL::DQ_SMEM, dq_set);
  if (e != cudaSuccess) return (int)e;
  e = mma::set_smem_once(ddk, TL::DQ_SMEM, dd_set);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv, tdo;
  int err = tensor_map(&tq, a.q, a.B, a.Sq, a.H, HD);
  if (err == 0) err = tensor_map(&tdo, a.dout, a.B, a.Sq, a.H, HD);
  if (err == 0) err = tensor_map(&tk, a.k, a.B, a.Skv, a.KV, HD);
  if (err == 0) err = tensor_map(&tv, a.v, a.B, a.Skv, a.KV, HD);
  if (err != 0) return err;
  const dim3 dq_grid(a.B * a.H, (a.Sq + TL::DQ_QUERIES - 1) / TL::DQ_QUERIES);
  ddk<<<dq_grid, TL::NTHREADS, TL::DQ_SMEM, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, nullptr, a.Sq, a.Skv, a.H, a.KV, a.causal, a.window,
      a.chunk, a.scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dkv<<<dim3(a.B * a.KV, (a.Skv + TL::DKV_KEYS - 1) / TL::DKV_KEYS), TL::NTHREADS,
        TL::DKV_SMEM, a.stream>>>(tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk),
                                  static_cast<bf16*>(a.dv), a.Sq, a.Skv, a.H, a.KV,
                                  a.causal, a.window, a.chunk, a.scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dqk<<<dq_grid, TL::NTHREADS, TL::DQ_SMEM, a.stream>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dq), a.Sq, a.Skv, a.H, a.KV,
      a.causal, a.window, a.chunk, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
constexpr bool on_wgmma() {
  return HD == 64 || HD == 128;
}

template <int HD>
int launch_bf16(const BwdArgs& a) {
  if constexpr (on_wgmma<HD>())
    return launch_bf16_wgmma<HD>(a);
  else
    return launch_bf16_mma<HD>(a);
}

// Shared memory of one block (bytes), the larger of the dK/dV and dQ
// kernels': dynamic for bfloat16 (WgTiles, BwdTiles), the static arrays of
// the float32 kernels (the dK/dV kernel's are the larger).
template <int HD>
constexpr int smem_bytes(int dtype) {
  if (dtype == 0) return 4 * (4 * FT * (HD + 1) + 2 * FT * (FT + 1) + 2 * FT);
  if constexpr (on_wgmma<HD>())
    return WgTiles<HD>::DKV_SMEM > WgTiles<HD>::DQ_SMEM ? WgTiles<HD>::DKV_SMEM
                                                        : WgTiles<HD>::DQ_SMEM;
  else
    return BwdTiles<HD>::DKV_SMEM > BwdTiles<HD>::DQ_SMEM ? BwdTiles<HD>::DKV_SMEM
                                                          : BwdTiles<HD>::DQ_SMEM;
}

template <int HD>
int launch_f32(const BwdArgs& a) {
  int err = launch_delta_f32(a);
  if (err != 0) return err;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  flash_bwd_dkdv_f32_kernel<HD><<<dim3(a.B * a.KV, (a.Skv + FT - 1) / FT), F32_THREADS, 0,
                                  a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.Sq, a.Skv, a.H, a.KV, a.causal, a.window, a.chunk, a.scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  flash_bwd_dq_f32_kernel<HD><<<dim3(a.B * a.H, (a.Sq + FT - 1) / FT), F32_THREADS, 0,
                                a.stream>>>(
      q, k, v, dout, a.lse, a.delta, static_cast<float*>(a.dq), a.Sq, a.Skv, a.H, a.KV,
      a.causal, a.window, a.chunk, a.scale);
  return (int)cudaGetLastError();
}

#define FOR_EACH_HEAD_DIM(X) X(32) X(64) X(96) X(128)

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = float32 (CUDA cores), 1 =
// bfloat16 (tensor cores); q, k, v, o, dout, dq, dk and dv share it.  lse:
// the forward's float32 (B, H, Sq) logsumexp; delta: float32 (B, H, Sq)
// scratch that receives D.  Returns the CUDA error code of the launches (0
// on success); a head dim this library was not built for is refused with
// cudaErrorInvalidValue.
extern "C" int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout,
                                          const float* lse, float* delta, void* dq,
                                          void* dk, void* dv, int B, int Sq, int Skv,
                                          int H, int KV, int hd, int causal, int window,
                                          int chunk, float scale, int dtype,
                                          void* stream) {
  const BwdArgs a{q,  k,  v,   o,  dout, lse, delta,  dq,    dk,    dv, B,
                  Sq, Skv, H, KV, hd, causal, window, chunk, scale,
                  static_cast<cudaStream_t>(stream)};
#define DISPATCH(HD_)                            \
  if (hd == HD_) {                               \
    if (dtype == 0) return launch_f32<HD_>(a);   \
    if (dtype == 1) return launch_bf16<HD_>(a);  \
    return (int)cudaErrorInvalidValue;           \
  }
  FOR_EACH_HEAD_DIM(DISPATCH)
#undef DISPATCH
  return (int)cudaErrorInvalidValue;
}

// Shared memory one block of this library takes at a head dim and dtype
// (bytes; see smem_bytes above), or -1: the wrapper checks its own sizing
// function against it.
extern "C" int flash_attention_bwd_smem(int hd, int dtype) {
#define SMEM(HD_) \
  if (hd == HD_ && (dtype == 0 || dtype == 1)) return smem_bytes<HD_>(dtype);
  FOR_EACH_HEAD_DIM(SMEM)
#undef SMEM
  return -1;
}
