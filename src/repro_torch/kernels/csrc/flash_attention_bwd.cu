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
// logsumexp, P = exp(S / sqrt(hd) - lse), never stored; D = rowsum(dO * O);
// dV = P^T dO, dP = dO V^T, dS = P (dP - D) / sqrt(hd), dQ = dS K,
// dK = dS^T Q; the H / KV query heads of each KV head are summed into its
// dK and dV.  The masks are the forward's (flash_common.cuh): a masked or
// ragged pair has P = 0, so a query that sees no key (non-causal masks with
// Sq > Skv make such rows) gets dQ = 0 and adds nothing to dK and dV.
//
// Three launches, deterministic (no atomics, every sum in a fixed order):
//  1. flash_bwd_delta_kernel: D (B, H, Sq) float32, one warp a row;
//  2. the dK/dV kernel: one block per (batch, KV head, key tile); it walks
//     the G query heads of its KV head and every query tile that the masks
//     leave any pair of (a tile masked for the whole block is skipped),
//     accumulating its keys' dK and dV in registers;
//  3. the dQ kernel: one block per (batch, head, query tile), over the key
//     tiles, heaviest query tile first (the causal mask's last tiles see
//     the most keys).
//
// What bounds it: five products of 2 * hd flops per visible (query, key)
// pair and head against reading q, k, v, dO and writing dq, dk, dv once, so
// at training shapes (S = 4096, hd 128) it is compute-bound.
//
// bfloat16 bodies: mma.sync m16n8k16 bf16 products with float32 sums.  A
// warp owns 16 keys (dK/dV) or 16 queries (dQ) and walks the other side 16
// at a time; S and dP (16 x 16) stay in registers, P and dS are rounded to
// bf16 and packed straight into A fragments (as the forward packs P), the
// other operands come from shared memory by ldmatrix (.trans for the
// (k, n) row-major ones).  The dK / dV (and dQ) accumulators sum over many
// tiles: each tile's 16-term product goes into a zeroed partial and is then
// added in float32, since the tensor cores truncate the sums they take
// (the lesson of fused_conv3x3.cu's float32 body).  The other side's tiles
// (Q and dO, or K and V) arrive by 16-byte cp.async in a two-stage ring.
// Numerics: P and dS are rounded to bf16 (relative 2^-9) before their
// products, as the reference's bf16_tiles option rounds them.
//
// float32 bodies: CUDA-core FMAs, 16 x 16 score tiles, one score a thread,
// then each thread accumulates 16 of its key's (or query's) head dims:
// simple and exact in float32; the training path's float32 runs are short.
//
// Build (see flash_attention_bwd.py): nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC.  Head dims 32,
// 64, 96 and 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "mma_bf16.cuh"

namespace {

using attn::load_rows;
using attn::LOG2E;
using attn::tile_masked;
using attn::tile_visible;
using attn::visible;
typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------
// D = rowsum(dO * O), float32 (B, H, Sq): one warp per (b, q, h) row, the
// rows taken in memory order.
// ---------------------------------------------------------------------------

constexpr int DELTA_ROWS = 8;  // rows (warps) a block

template <typename T>
__global__ void __launch_bounds__(DELTA_ROWS * 32)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int B, int Sq, int H, int hd) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * DELTA_ROWS + (threadIdx.x >> 5);
  if (row >= (long long)B * Sq * H) return;  // the whole warp
  const T* orow = o + row * hd;
  const T* drow = dout + row * hd;
  float s = 0.f;
  for (int d = lane; d < hd; d += 32) s += to_f(orow[d]) * to_f(drow[d]);
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

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
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

template <int HD>
__global__ void __launch_bounds__(BwdTiles<HD>::NTHREADS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
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
  const float D0 = qr0 < Sq ? delta[srow + qr0] : 0.f;
  const float D1 = qr1 < Sq ? delta[srow + qr1] : 0.f;
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
          dp[j][e] = p * (dp[j][e] - (e < 2 ? D0 : D1)) * scale;
        }
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

template <typename T>
int launch_delta(const BwdArgs& a) {
  const long long rows = (long long)a.B * a.Sq * a.H;
  const unsigned blocks = (unsigned)((rows + DELTA_ROWS - 1) / DELTA_ROWS);
  flash_bwd_delta_kernel<T><<<blocks, DELTA_ROWS * 32, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta, a.B, a.Sq,
      a.H, a.hd);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const BwdArgs& a) {
  using TL = BwdTiles<HD>;
  int err = launch_delta<bf16>(a);
  if (err != 0) return err;
  static bool dkv_set[64], dq_set[64];
  auto dkv = flash_bwd_dkdv_mma_kernel<HD>;
  auto dqk = flash_bwd_dq_mma_kernel<HD>;
  cudaError_t e = mma::set_smem_once(dkv, TL::DKV_SMEM, dkv_set);
  if (e != cudaSuccess) return (int)e;
  e = mma::set_smem_once(dqk, TL::DQ_SMEM, dq_set);
  if (e != cudaSuccess) return (int)e;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  dkv<<<dim3(a.B * a.KV, (a.Skv + BWD_BK - 1) / BWD_BK), TL::NTHREADS, TL::DKV_SMEM,
        a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dk),
                    static_cast<bf16*>(a.dv), a.Sq, a.Skv, a.H, a.KV, a.causal,
                    a.window, a.chunk, a.scale);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  dqk<<<dim3(a.B * a.H, (a.Sq + BWD_BQ - 1) / BWD_BQ), TL::NTHREADS, TL::DQ_SMEM,
        a.stream>>>(q, k, v, dout, a.lse, a.delta, static_cast<bf16*>(a.dq), a.Sq,
                    a.Skv, a.H, a.KV, a.causal, a.window, a.chunk, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_f32(const BwdArgs& a) {
  int err = launch_delta<float>(a);
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
