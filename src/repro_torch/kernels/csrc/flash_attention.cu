// Flash attention forward for Hopper (sm_90a): QK^T -> mask -> online
// softmax -> PV in one kernel, float32 arithmetic, q/k/v/o in the
// reference's (B, S, heads, head_dim) layout, float32 or bfloat16.
//
// Replaces: src/repro/kernels/fused_attention.py::flash_attention, the
// Pallas TPU kernel (`_kernel`, launched by `pl.pallas_call`).  What it
// keeps from that kernel is the fusion group's guarantee and its
// arithmetic: the (Sq, Skv) score frame exists only as one
// (BLOCK_Q, BLOCK_K) tile in shared memory, never in device memory; the
// running max m, sum l and accumulator acc are float32 and live in
// registers; the scale 1/sqrt(head_dim) is applied after the dot; masked
// scores are the finite NEG_INF = -1e30 (not -inf), so a row whose first
// tiles are fully masked takes exp(0) = 1 garbage into l and acc that the
// first visible tile wipes with corr = exp(-1e30 - m) = 0, exactly as the
// TPU kernel does (a -inf mask would give exp(-inf + inf) = NaN there);
// the output is acc / max(l, 1e-30).  GQA is in the index arithmetic:
// query head h reads KV head h / (H / KV); no repeated K/V is built.
// Keys past Skv (the ragged last tile) are -inf, i.e. excluded outright,
// and queries past Sq are not stored, so any Sq and Skv are taken.
//
// Masks, from absolute positions 0..Sq-1 and 0..Skv-1: causal k <= q;
// window (q - k) < window, and also (k - q) < window when not causal (the
// model's attention_bias and the plain version; the TPU kernel masks one
// side only, a case its tests never reach); chunk q / chunk == k / chunk.
// With `skip` set (the wrapper sets it when Sq <= Skv, so that every row
// sees at least its own key) a KV tile that is masked for every row of the
// block is not visited: it would add exp(-1e30 - m) = 0 to rows that have
// seen a visible key and garbage that is wiped later to rows that have
// not, so the output is the same.
//
// What bounds it: at the serving shapes (S = 512, head_dim 128) the block
// does 4 * BLOCK_Q * BLOCK_K * head_dim flops per KV tile against
// 2 * BLOCK_K * head_dim * 2 bytes of K/V, so it is compute-bound; this
// version runs its products as float32 FMAs on the CUDA cores (bf16 inputs
// are widened on load), so its bound is the float32 CUDA-core peak, not
// the tensor cores.  No wgmma, TMA or double buffering yet: this is the
// simple, right version.
//
// Tile design: 256 threads = 16 row groups (ty) x 16 column groups (tx).
// Thread (ty, tx) owns the scores of rows ty + 16 i and keys tx + 16 j
// (i < BLOCK_Q / 16, j < BLOCK_K / 16) and the output dims tx + 16 e
// (e < HD / 16) of its rows.  The 16 threads of a row are one half-warp,
// so row max and row sum are four xor-shuffles.  Shared memory holds the
// Q tile, one K-or-V tile (K for the scores, then V for PV) and the P
// tile, all float32; sizes in fused_attention.py::smem_bytes.
//
// Build (see fused_attention.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -O3 -shared -Xcompiler -fPIC.  The (head_dim, BLOCK_Q, BLOCK_K) shapes
// built are listed in INSTANTIATE below and in fused_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NTHREADS = 256;
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as the plain version
}

template <int HD, int BQ, int BK>
struct Tiles {
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

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq,
                       int Skv, int H, int KV, int causal, int window,
                       int chunk, int skip, float scale) {
  using TL = Tiles<HD, BQ, BK>;
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
  const T* qb = q + (size_t)b * Sq * q_stride + (size_t)h * HD;
  const T* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * HD;
  T* ob = o + (size_t)b * Sq * q_stride + (size_t)h * HD;

  for (int i = tid; i < BQ * HD; i += NTHREADS) {
    const int r = i / HD;
    const int d = i % HD;
    const int s = q0 + r;
    sq[r * TL::QLD + d] = s < Sq ? to_f32(qb[(size_t)s * q_stride + d]) : 0.f;
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
    for (int i = tid; i < BK * HD; i += NTHREADS) {
      const int r = i / HD;
      const int d = i % HD;
      const int s = k0 + r;
      skv[r * TL::QLD + d] = s < Skv ? to_f32(kb[(size_t)s * kv_stride + d]) : 0.f;
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
    for (int i = tid; i < BK * HD; i += NTHREADS) {
      const int r = i / HD;
      const int d = i % HD;
      const int s2 = k0 + r;
      skv[r * HD + d] = s2 < Skv ? to_f32(vb[(size_t)s2 * kv_stride + d]) : 0.f;
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
      ob[(size_t)qi * q_stride + tx + 16 * e] = from_f32<T>(acc[i][e] / denom);
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, H, KV, causal, window, chunk, skip;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD, int BQ, int BK>
int launch(const Args& a) {
  using TL = Tiles<HD, BQ, BK>;
  auto kern = flash_attention_kernel<T, HD, BQ, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  kern<<<grid, NTHREADS, TL::SMEM_BYTES, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.Sq, a.Skv, a.H,
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

// C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16 (q, k,
// v and o share it).  Returns the CUDA error code of the launch (0 on
// success); a shape this library was not built for is refused with
// cudaErrorInvalidValue.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KV, int hd,
                                      int block_q, int block_k, int causal,
                                      int window, int chunk, int skip,
                                      float scale, int dtype, void* stream) {
  const Args a{q, k, v, o, B, Sq, Skv, H, KV, causal, window, chunk, skip,
               scale, static_cast<cudaStream_t>(stream)};
#define DISPATCH(HD_, BQ_, BK_)                                     \
  if (hd == HD_ && block_q == BQ_ && block_k == BK_) {              \
    if (dtype == 0) return launch<float, HD_, BQ_, BK_>(a);         \
    if (dtype == 1) return launch<__nv_bfloat16, HD_, BQ_, BK_>(a); \
    return (int)cudaErrorInvalidValue;                              \
  }
  FOR_EACH_SHAPE(DISPATCH)
#undef DISPATCH
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one block at a built shape (bytes), or -1: the
// wrapper checks its own sizing function against it.
extern "C" int flash_attention_smem_bytes(int hd, int block_q, int block_k) {
#define SMEM(HD_, BQ_, BK_) \
  if (hd == HD_ && block_q == BQ_ && block_k == BK_) return Tiles<HD_, BQ_, BK_>::SMEM_BYTES;
  FOR_EACH_SHAPE(SMEM)
#undef SMEM
  return -1;
}
