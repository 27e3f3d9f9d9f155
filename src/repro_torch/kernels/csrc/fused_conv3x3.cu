// Fused 3x3 SAME convolution + bias + ReLU (+ 2x2/2 max-pool) for Hopper
// (sm_90a), NHWC input, HWIO weights, float32 accumulation.
//
// Replaces: src/repro/kernels/fused_conv.py::fused_conv3x3, the Pallas TPU
// kernel (`_kernel`, launched by `pl.pallas_call`).  That kernel holds a
// WHOLE frame per grid step in VMEM (vmem_bytes(224, 224, 64, 64) is about
// 31 MiB); a Hopper block has at most 232,448 bytes of shared memory, so
// the design below tiles space instead.  What it keeps from the TPU kernel
// is the fusion group's guarantee: the pre-pool frame never reaches device
// memory — bias, ReLU and the 2x2 max are applied in registers and only the
// pooled tile is stored.
//
// What bounds it: at VGG-16 sizes the layer does 9*Cin*Cout multiply-adds
// per output pixel against Cin + Cout words of traffic per pixel, hundreds
// of operations per byte, so it is compute-bound.  With TF32 off (the
// float32 result must match the plain float32 version) the bound is the
// card's float32 CUDA-core peak (67 TFLOP/s dense on an H100 SXM at 700 W),
// not the tensor cores.
//
// What the tile design does about it: every thread owns one 2x2 output
// window (the pool window) x CPT output channels, i.e. 4*CPT float32
// accumulators in registers.  Per input channel it reads a 4x4 input patch
// (16 loads) and 9 taps x CPT weights, and retires 9*4*CPT = 576 FMAs, so
// shared-memory traffic stays well below the FMA rate; the weights are
// read as float4 broadcasts (a warp shares one channel group).  A block is
// one (image, TILE_H x TILE_W spatial tile, BLOCK_C output channels); it
// stages a haloed input tile and a CIN_CHUNK x 9 x BLOCK_C weight slice in
// shared memory per step of its loop over input channels (the ragged last
// chunk, e.g. Cin = 3, is zero-filled).  Tiles have even height and width,
// so no pool window straddles two blocks.  No tensor cores (wgmma), TMA or
// double buffering yet: this is the simple, right version.
//
// Build (see fused_conv.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -O3 -shared -Xcompiler -fPIC -DTILE_H=.. -DTILE_W=.. -DCIN_CHUNK=..
//   -DBLOCK_C=.. -DCPT=..   — the tile constants (CPT: output channels per
// thread) come from fused_conv.py, which also computes the launch grid and
// the shared-memory size it passes in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#if !defined(TILE_H) || !defined(TILE_W) || !defined(CIN_CHUNK) || \
    !defined(BLOCK_C) || !defined(CPT)
#error "build with -DTILE_H, -DTILE_W, -DCIN_CHUNK, -DBLOCK_C and -DCPT (see fused_conv.py)"
#endif

namespace {

constexpr int WIN_H = TILE_H / 2;              // 2x2 windows per tile row
constexpr int WIN_W = TILE_W / 2;
constexpr int N_WIN = WIN_H * WIN_W;           // windows per tile
constexpr int N_CG = BLOCK_C / CPT;            // channel groups per block
constexpr int NTHREADS = N_WIN * N_CG;
constexpr int HALO_H = TILE_H + 2;
constexpr int HALO_W = TILE_W + 2;
constexpr int SMEM_X = CIN_CHUNK * HALO_H * HALO_W;  // floats: input tile
constexpr int SMEM_W = CIN_CHUNK * 9 * BLOCK_C;      // floats: weight slice
constexpr int SMEM_BYTES = (SMEM_X + SMEM_W) * (int)sizeof(float);

static_assert(TILE_H % 2 == 0 && TILE_W % 2 == 0,
              "even tiles: no pool window may straddle two blocks");
static_assert(CPT % 4 == 0, "weights are read as float4");
static_assert(BLOCK_C % CPT == 0, "BLOCK_C must be a multiple of CPT");
static_assert(N_WIN % 32 == 0,
              "a warp must share one channel group (broadcast weight loads)");
static_assert(NTHREADS <= 1024, "too many threads per block");
static_assert(SMEM_X % 4 == 0, "weight slice must stay 16-byte aligned");

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

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
fused_conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ b, T* __restrict__ y, int H, int W,
                     int Cin, int Cout, int tiles_w, int pool) {
  extern __shared__ float4 smem4[];
  float* sx = reinterpret_cast<float*>(smem4);  // [CIN_CHUNK][HALO_H][HALO_W]
  float* sw = sx + SMEM_X;                      // [CIN_CHUNK][9][BLOCK_C]

  const int tid = threadIdx.x;
  const int h0 = (blockIdx.x / tiles_w) * TILE_H;
  const int w0 = (blockIdx.x % tiles_w) * TILE_W;
  const int c0 = blockIdx.y * BLOCK_C;
  const int n = blockIdx.z;

  const int cg = tid / N_WIN;  // channel group, uniform across a warp
  const int win = tid % N_WIN;
  const int wy = win / WIN_W;
  const int wx = win % WIN_W;

  float acc[4][CPT];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int k = 0; k < CPT; ++k) acc[p][k] = 0.f;

  const T* xn = x + (size_t)n * H * W * Cin;

  for (int ci0 = 0; ci0 < Cin; ci0 += CIN_CHUNK) {
    __syncthreads();  // the previous chunk's reads are done
    // Haloed input tile, channel fastest so neighbouring threads read
    // neighbouring addresses; out-of-frame pixels and channels are 0.
    for (int i = tid; i < HALO_H * HALO_W * CIN_CHUNK; i += NTHREADS) {
      const int c = i % CIN_CHUNK;
      const int pix = i / CIN_CHUNK;
      const int r = pix / HALO_W;
      const int q = pix % HALO_W;
      const int hh = h0 - 1 + r;
      const int ww = w0 - 1 + q;
      const int ci = ci0 + c;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && ci < Cin)
        v = to_f32(xn[((size_t)hh * W + ww) * Cin + ci]);
      sx[(c * HALO_H + r) * HALO_W + q] = v;
    }
    // Weight slice [ci][tap][co], output channel fastest.
    for (int i = tid; i < CIN_CHUNK * 9 * BLOCK_C; i += NTHREADS) {
      const int co = i % BLOCK_C;
      const int tap = (i / BLOCK_C) % 9;
      const int c = i / (BLOCK_C * 9);
      const int ci = ci0 + c;
      const int cc = c0 + co;
      float v = 0.f;
      if (ci < Cin && cc < Cout) v = to_f32(w[((size_t)tap * Cin + ci) * Cout + cc]);
      sw[(c * 9 + tap) * BLOCK_C + co] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int c = 0; c < CIN_CHUNK; ++c) {
      // The 4x4 input patch under this thread's 2x2 window and its halo.
      float xin[4][4];
      const float* sxc = sx + (c * HALO_H + 2 * wy) * HALO_W + 2 * wx;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) xin[r][q] = sxc[r * HALO_W + q];
      const float* swc = sw + c * 9 * BLOCK_C + cg * CPT;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3;
        const int dx = tap % 3;
        float wv[CPT];
        const float4* w4 = reinterpret_cast<const float4*>(swc + tap * BLOCK_C);
#pragma unroll
        for (int k = 0; k < CPT / 4; ++k) {
          const float4 v = w4[k];
          wv[4 * k + 0] = v.x;
          wv[4 * k + 1] = v.y;
          wv[4 * k + 2] = v.z;
          wv[4 * k + 3] = v.w;
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float xv = xin[(p >> 1) + dy][(p & 1) + dx];
#pragma unroll
          for (int k = 0; k < CPT; ++k) acc[p][k] = fmaf(xv, wv[k], acc[p][k]);
        }
      }
    }
  }

  // Epilogue in registers: bias, ReLU and (when pooling) the 2x2 max; only
  // the stored frame — pooled or not — is written.
  const int oh = h0 + 2 * wy;  // top-left pre-pool pixel of the window
  const int ow = w0 + 2 * wx;
  const int Ho = H / 2;
  const int Wo = W / 2;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int cc = c0 + cg * CPT + k;
    if (cc >= Cout) continue;
    const float bias = to_f32(b[cc]);
    float v[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) v[p] = fmaxf(acc[p][k] + bias, 0.f);
    if (pool) {
      const int ph = oh / 2;
      const int pw = ow / 2;
      if (ph < Ho && pw < Wo) {
        const float m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
        y[(((size_t)n * Ho + ph) * Wo + pw) * Cout + cc] = from_f32<T>(m);
      }
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int hh = oh + (p >> 1);
        const int ww = ow + (p & 1);
        if (hh < H && ww < W)
          y[(((size_t)n * H + hh) * W + ww) * Cout + cc] = from_f32<T>(v[p]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int H, int W,
           int Cin, int Cout, int pool, int grid_x, int grid_y, int grid_z,
           int tiles_w, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_conv3x3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  fused_conv3x3_kernel<T><<<dim3(grid_x, grid_y, grid_z), NTHREADS, SMEM_BYTES,
                            stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), H, W, Cin, Cout, tiles_w,
      pool);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16 (x, w,
// b and y share it).  The caller passes the grid and the shared-memory size
// it computed; a size that disagrees with this build's tiles is refused.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fused_conv3x3_launch(const void* x, const void* w, const void* b,
                                    void* y, int H, int W, int Cin, int Cout,
                                    int pool, int dtype, int grid_x, int grid_y,
                                    int grid_z, int tiles_w, int smem_bytes,
                                    void* stream) {
  if (smem_bytes != SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, w, b, y, H, W, Cin, Cout, pool, grid_x, grid_y,
                         grid_z, tiles_w, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, b, y, H, W, Cin, Cout, pool, grid_x,
                                 grid_y, grid_z, tiles_w, s);
  return (int)cudaErrorInvalidValue;
}

// Threads per block of this build, for the wrapper's geometry check.
extern "C" int fused_conv3x3_threads(void) { return NTHREADS; }
