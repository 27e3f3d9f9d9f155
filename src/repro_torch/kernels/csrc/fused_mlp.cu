// Fused MLP for Hopper (sm_90a): act(x @ w1) [* (x @ w3)] @ w2 in one
// kernel, float32 arithmetic, x (T, d), w1/w3 (d, ff), w2 (ff, d), float32
// or bfloat16, for act = swiglu, geglu, gelu (tanh form) and relu.
//
// Replaces: src/repro/kernels/fused_mlp.py::fused_mlp, the Pallas TPU
// kernel (`_kernel`, launched by `pl.pallas_call`).  What it keeps is the
// fusion group's guarantee: the (T, ff) hidden frame never reaches device
// memory, it exists only as one (BLOCK_M, BLOCK_F) float32 tile in shared
// memory.  What it cannot keep is the TPU layout: the Pallas kernel holds
// a (block_m, d) float32 accumulator across its sequential d_ff loop, and
// at block_m 128, d 1024 that is 512 KB, more than the 227 KB a Hopper
// block has, and Hopper blocks do not run in sequence anyway.
//
// Layout chosen: split d_ff across blocks.  Block (im, jf) computes the
// hidden tile h = act(x[im] @ w1[:, jf]) [* (x[im] @ w3[:, jf])] for its
// BLOCK_M rows and BLOCK_F hidden units (the first products stream d in
// DK-wide slices), keeps it in shared memory, multiplies it by the
// (BLOCK_F, d) slice of w2 in BN-column passes, and adds the partial
// (BLOCK_M, d) product into a float32 (T, d) buffer with atomicAdd.  The
// buffer is zeroed before and, for bfloat16, rounded into the output after
// (both inside fused_mlp_launch, one call).
//   FLOPs: exactly the function's, 2 T d ff (x2 when gated) + 2 T ff d; no
//   product is recomputed (tiling the output columns instead would redo
//   the first products d / BN times).
//   Bytes: x is read once per hidden tile (ff / BLOCK_F times, from L2
//   mostly), the weights once per row block (T / BLOCK_M times), and
//   T d (ff / BLOCK_F) float32 atomic adds go to L2; the (T, d) float32
//   buffer is the only extra device memory, 4 T d bytes, below the
//   2 T ff bytes of a bfloat16 hidden frame whenever ff > 2 d (qwen3:
//   16.8 MB vs 25.2 MB at T = 4096).
//   Order: the ff / BLOCK_F partial sums arrive in whatever order the
//   blocks finish, so float32 results can differ between runs in their
//   last bits, and a bfloat16 output by one unit in the last place; the
//   tolerances (tests/test_kernels.py's 10x: 2e-4 and 2e-1) cover it.
//
// What bounds it: at prefill (T = 4096, d 1024, ff 3072) hundreds of flops
// per byte, so compute; this version runs float32 FMAs on the CUDA cores
// (bfloat16 inputs are widened on load), so its bound is the float32
// CUDA-core peak.  At decode (T = 8) it reads 3 d ff weights for 6 T d ff
// flops: memory-bound, and BLOCK_M = 16 tiles keep the wasted rows down.
// No wgmma, TMA or double buffering yet: this is the simple, right version.
//
// Threads: 256 = 16 row groups (ty) x 16 column groups (tx); thread
// (ty, tx) owns rows ty + 16 i and hidden units tx + 16 j of the hidden
// tile, then rows ty + 16 i and output columns tx + 16 e of each BN pass.
//
// Build (see fused_mlp.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -O3 -shared -Xcompiler -fPIC.  The (BLOCK_M, BLOCK_F) tiles built are
// listed in FOR_EACH_TILE below and in fused_mlp.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int DK = 32;   // d slice staged per step of the first products
constexpr int FK = 32;   // hidden units staged per step of the second
constexpr int BN = 128;  // output columns per pass of the second product
constexpr int NE = BN / 16;

enum Act { SWIGLU = 0, GEGLU = 1, GELU = 2, RELU = 3 };

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int BM, int BF>
struct Tiles {
  static constexpr int RM = BM / 16;  // rows per thread
  static constexpr int CF = BF / 16;  // hidden units per thread
  static constexpr int HLD = BF + 1;  // row stride of the hidden tile
  static constexpr int A_FLOATS = BM * DK + 2 * DK * BF;  // x, w1, w3 slices
  static constexpr int B_FLOATS = FK * BN;                // w2 slice
  static constexpr int STAGE = A_FLOATS > B_FLOATS ? A_FLOATS : B_FLOATS;
  static constexpr int SMEM_BYTES = (STAGE + BM * HLD) * 4;
  static_assert(BM % 16 == 0 && BF % 16 == 0, "tiles of 16");
};

__device__ __forceinline__ float gelu_tanh(float x) {
  // jax.nn.gelu's default (approximate=True) form
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

template <typename T, int BM, int BF>
__global__ void __launch_bounds__(NTHREADS)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                 const T* __restrict__ w3, const T* __restrict__ w2,
                 float* __restrict__ out, int n_rows, int d, int ff, int act) {
  using TL = Tiles<BM, BF>;
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
    for (int i = tid; i < BM * DK; i += NTHREADS) {
      const int r = m0 + i / DK;
      const int c = d0 + i % DK;
      sx[i] = (r < n_rows && c < d) ? to_f32(x[(size_t)r * d + c]) : 0.f;
    }
    for (int i = tid; i < DK * BF; i += NTHREADS) {
      const int r = d0 + i / BF;
      const int c = f0 + i % BF;
      const bool in = r < d && c < ff;
      const size_t g = (size_t)r * ff + c;
      sw1[i] = in ? to_f32(w1[g]) : 0.f;
      if (gated) sw3[i] = in ? to_f32(w3[g]) : 0.f;
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
    for (int j = 0; j < TL::CF; ++j) {
      const float hv = ha[i][j];
      float y;
      if (act == SWIGLU)
        y = silu(hv) * ga[i][j];
      else if (act == GEGLU)
        y = gelu_tanh(hv) * ga[i][j];
      else if (act == GELU)
        y = gelu_tanh(hv);
      else
        y = fmaxf(hv, 0.f);
      sh[(ty + 16 * i) * TL::HLD + tx + 16 * j] = y;
    }

  for (int n0 = 0; n0 < d; n0 += BN) {
    float oa[TL::RM][NE];
#pragma unroll
    for (int i = 0; i < TL::RM; ++i)
#pragma unroll
      for (int e = 0; e < NE; ++e) oa[i][e] = 0.f;
    for (int fs = 0; fs < BF; fs += FK) {
      __syncthreads();  // the hidden tile is written; earlier reads are done
      for (int i = tid; i < FK * BN; i += NTHREADS) {
        const int r = f0 + fs + i / BN;
        const int c = n0 + i % BN;
        sw2[i] = (r < ff && c < d) ? to_f32(w2[(size_t)r * d + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < FK; ++kk) {
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

template <typename T, int BM, int BF>
int launch(const Args& a) {
  using TL = Tiles<BM, BF>;
  auto kern = fused_mlp_kernel<T, BM, BF>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)a.n_rows * a.d;
  err = cudaMemsetAsync(a.acc, 0, n * sizeof(float), a.stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.n_rows + BM - 1) / BM, (a.ff + BF - 1) / BF);
  kern<<<grid, NTHREADS, TL::SMEM_BYTES, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w1),
      static_cast<const T*>(a.w3), static_cast<const T*>(a.w2), a.acc,
      a.n_rows, a.d, a.ff, a.act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (static_cast<void*>(a.acc) != a.y) {  // bfloat16: round the sums
    const size_t blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
    round_to_bf16<<<(unsigned)blocks, 256, 0, a.stream>>>(
        a.acc, static_cast<__nv_bfloat16*>(a.y), n);
    err = cudaGetLastError();
  }
  return (int)err;
}

#define FOR_EACH_TILE(X) X(16, 64) X(16, 128) X(64, 64) X(64, 128)

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = float32 (the sums go
// straight into y, acc must be y), 1 = bfloat16 (acc is a float32 (T, d)
// scratch buffer the caller allocated).  act: 0 swiglu, 1 geglu, 2 gelu,
// 3 relu; w3 is read only for the gated acts.  Returns the CUDA error code
// (0 on success); a tile this library was not built for is refused with
// cudaErrorInvalidValue.
extern "C" int fused_mlp_launch(const void* x, const void* w1, const void* w3,
                                const void* w2, void* y, void* acc, int n_rows,
                                int d, int ff, int act, int block_m,
                                int block_f, int dtype, void* stream) {
  if (act < SWIGLU || act > RELU) return (int)cudaErrorInvalidValue;
  if ((dtype == 0) != (acc == y)) return (int)cudaErrorInvalidValue;
  const Args a{x, w1, w3, w2, y, static_cast<float*>(acc), n_rows, d, ff,
               act, static_cast<cudaStream_t>(stream)};
#define DISPATCH(BM_, BF_)                                      \
  if (block_m == BM_ && block_f == BF_) {                       \
    if (dtype == 0) return launch<float, BM_, BF_>(a);          \
    if (dtype == 1) return launch<__nv_bfloat16, BM_, BF_>(a);  \
    return (int)cudaErrorInvalidValue;                          \
  }
  FOR_EACH_TILE(DISPATCH)
#undef DISPATCH
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one block at a built tile (bytes), or -1.
extern "C" int fused_mlp_smem_bytes(int block_m, int block_f) {
#define SMEM(BM_, BF_) \
  if (block_m == BM_ && block_f == BF_) return Tiles<BM_, BF_>::SMEM_BYTES;
  FOR_EACH_TILE(SMEM)
#undef SMEM
  return -1;
}
