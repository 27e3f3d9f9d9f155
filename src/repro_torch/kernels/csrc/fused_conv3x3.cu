// Fused 3x3 SAME convolution + bias + ReLU (+ 2x2/2 max-pool) for Hopper
// (sm_90a), NHWC input, HWIO weights, float32 accumulation, on the tensor
// cores.
//
// Replaces: src/repro/kernels/fused_conv.py::fused_conv3x3, the Pallas TPU
// kernel (`_kernel`, launched by `pl.pallas_call`).  That kernel holds a
// WHOLE frame per grid step in VMEM (vmem_bytes(224, 224, 64, 64) is about
// 31 MiB); a Hopper block has at most 232,448 bytes of shared memory, so
// the design below tiles space instead.  What it keeps from the TPU kernel
// is the fusion group's guarantee: the pre-pool frame never reaches device
// memory -- bias, ReLU and the 2x2 max are applied in registers and only
// the stored frame (pooled or not) is written.
//
// The product: an implicit GEMM.  M = the pre-pool pixels of a spatial
// tile, N = output channels, K = 9 taps x Cin.  A block is one (image,
// TILE x TILE pixel tile, BLOCK_C output channels); its warps each own 64
// pixels x 32 channels.  Per step of its loop over input channels it
// stages, through a STAGES-deep cp.async ring, the haloed input tile for
// CHUNK_BYTES of channels (8 float32 or 16 bfloat16: one mma k-step) and
// the 9 x chunk x BLOCK_C weight slice.  The A operand of tap (dy, dx) is
// the staged tile read at a shifted offset (no im2col is built): each lane
// gives ldmatrix the address of its own row's pixel.  Out-of-frame halo
// pixels and the channels past Cin are zero-filled by cp.async's src-size
// 0; Cin = 3 (VGG's first layer) pads each tap's K to the k-step.  Rows or
// pointers that are not whole 16-byte pieces (Cin = 3) are staged element
// by element instead (`vec` = 0).
//
// float32: 3xTF32.  Single-pass TF32 rounds each operand to 11 significant
// bits, up to 2^-11 = 4.9e-4 relative error a product, which misses the
// float32 tolerance of 2e-4 (tests/test_torch_kernels.py shows it).  So
// each operand is split in registers, big = tf32(v) and small = tf32(v -
// big), rounded to nearest with ties away as cvt.rna rounds
// (mma::tf32_rna: two integer instructions where the cvt takes five),
// which leaves |v - big - small| <= 2^-22 |v|; three m16n8k8 tf32
// products, small*big + big*small + big*big (small terms first), are
// summed.  The dropped small*small term and the two splits bound a
// product's error by about 3 * 2^-22 = 7e-7 of |x w|; the tf32 products
// themselves are exact in float32.  Over VGG-16's K = 9 x 512 = 4,608
// terms that is at most 7e-7 x sum |x w|, about 4e-5 at VGG's widths with
// He-scaled weights.
//   The sums need care too: the tensor cores add products to the
// accumulator with truncation, not rounding, so an error of up to 2^-23 of
// the running sum, always toward zero, enters at every product.  Summed
// straight into one accumulator over VGG's 3 x 576 products that bias
// moved the batch-8 logits by 7.2e-4 against an allowance of 6.7e-4
// (PERF.md).  So each chunk's 27 products go to a zeroed partial, and the
// partials are added in float32 on the CUDA cores (rounding to nearest):
// the truncation is then relative to a chunk's partial and no longer
// builds up over K.  bfloat16: one m16n8k16 product a step straight into
// acc (its tolerance, 2e-1, has room for the bias), as the reference
// accumulates in float32.
//
// The pool in registers: a warp's 64 GEMM rows are in sub-pixel-major
// order.  m16 tile mt = 0..3 is the 2x2 window's sub-pixel (dy, dx) = (mt
// / 2, mt % 2) and row r of every tile is the warp's window r (row-major in
// the tile).  In the m16n8 C fragment lane l holds rows l/4 and l/4 + 8, so
// it holds all four pixels of windows l/4 and l/4 + 8 and applies bias,
// ReLU and the 2x2 max without a shuffle or shared memory
// (fused_conv.py::gemm_row_pixel is the same map, checked on the CPU).
//
// Shared-memory layout.  A staged pixel is a 48-byte row (the 32-byte
// chunk + 16 bytes of pad); the halo tile keeps even and odd columns apart
// ([row][column parity][column / 2]), so the eight windows ldmatrix reads
// together sit in eight different 16-byte bank groups.  Weight rows (one
// k, BLOCK_C channels) are padded by 8 elements for the same reason.
//
// What bounds it: 2 x 9 x Cin x Cout FLOPs per output pixel against Cin +
// Cout words of traffic, hundreds of FLOPs a byte, so operations.  3xTF32
// does three tf32 products per multiply-add, so its least time is 3 x
// FLOPs at the tensor cores' dense TF32 rate (494.7 TFLOP/s on an H100 SXM
// at 700 W), 2.5x less than the CUDA cores' FLOPs / 67 TFLOP/s.
//
// Tiles: TILE_BIG (16: 8 warps, 256 threads) or TILE_SMALL (8: 2 warps),
// chosen per launch by fused_conv.py so that a VGG-16 layer at batch 8 has
// at least one block per SM (14x14 frames take the small tile).  About 180
// (bfloat16) to 255 (float32: acc and the partial hold 128) registers a
// thread, one TILE_BIG block an SM; capping them at 128 for two blocks an
// SM spilled and ran slower (PERF.md).
//
// Build (see fused_conv.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -O3 -shared -Xcompiler -fPIC -DBLOCK_C=.. -DCHUNK_BYTES=.. -DSTAGES=..
//   -DTILE_BIG=.. -DTILE_SMALL=..; fused_conv.py computes the grid and the
// shared-memory size it passes in.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_bf16.cuh"

#if !defined(BLOCK_C) || !defined(CHUNK_BYTES) || !defined(STAGES) || \
    !defined(TILE_BIG) || !defined(TILE_SMALL)
#error "build with -DBLOCK_C, -DCHUNK_BYTES, -DSTAGES, -DTILE_BIG and -DTILE_SMALL (see fused_conv.py)"
#endif

namespace {

constexpr int WARP_C = 32;                  // output channels a warp
constexpr int WARPS_N = BLOCK_C / WARP_C;   // warps across the channels
constexpr int N_TILES = WARP_C / 8;         // n8 tiles a warp
constexpr int PIX_BYTES = CHUNK_BYTES + 16; // a staged pixel: the chunk + pad
constexpr int W_ROW = BLOCK_C + 8;          // elements of a staged weight row
constexpr int W_BYTES = 9 * CHUNK_BYTES * W_ROW;  // 9 taps x chunk x W_ROW

static_assert(BLOCK_C % WARP_C == 0, "BLOCK_C must be a multiple of 32");
static_assert(CHUNK_BYTES == 32, "one chunk is one mma k-step: 8 tf32 or 16 bf16");
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

template <typename T> struct Elem;
template <> struct Elem<float> {
  static __device__ __forceinline__ float f32(float v) { return v; }
  static __device__ __forceinline__ float from(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float f32(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 from(float v) {
    return __float2bfloat16(v);  // round to nearest even, as the plain version
  }
};

// Slot of halo pixel (r, q): even and odd columns apart.
template <int TILE>
__device__ __forceinline__ int x_slot(int r, int q) {
  return (r * 2 + (q & 1)) * Geo<TILE>::HW2 + (q >> 1);
}

// Stage input channels ci0 .. ci0 + KC - 1 of the haloed tile at (h0, w0)
// and the matching weight slice of channels c0 .. c0 + BLOCK_C - 1.
template <typename T, int TILE>
__device__ __forceinline__ void stage_chunk(char* sx, const T* __restrict__ xn,
                                            const T* __restrict__ w, int H, int W,
                                            int Cin, int Cout, int h0, int w0, int c0,
                                            int ci0, bool vec) {
  using G = Geo<TILE>;
  constexpr int KC = CHUNK_BYTES / (int)sizeof(T);  // channels a chunk
  char* sw = sx + G::X_BYTES;
  if (vec) {  // 16-byte pieces; Cin and Cout are multiples of 16 / sizeof(T)
    constexpr int EPP = 16 / (int)sizeof(T);
    constexpr int XP = CHUNK_BYTES / 16;
    for (int i = threadIdx.x; i < G::HALO * G::HALO * XP; i += G::THREADS) {
      const int piece = i % XP;
      const int p = i / XP;
      const int r = p / G::HALO, q = p % G::HALO;
      const int hh = h0 - 1 + r, ww = w0 - 1 + q, ci = ci0 + piece * EPP;
      const bool ok = hh >= 0 && hh < H && ww >= 0 && ww < W && ci < Cin;
      const T* src = ok ? xn + ((size_t)hh * W + ww) * Cin + ci : xn;
      mma::cp_async16(sx + x_slot<TILE>(r, q) * PIX_BYTES + piece * 16, src, ok);
    }
    constexpr int WP = BLOCK_C / EPP;
    for (int i = threadIdx.x; i < 9 * KC * WP; i += G::THREADS) {
      const int piece = i % WP;
      const int row = i / WP;  // tap * KC + k
      const int ci = ci0 + row % KC, co = c0 + piece * EPP;
      const bool ok = ci < Cin && co < Cout;
      const T* src = ok ? w + ((size_t)(row / KC) * Cin + ci) * Cout + co : w;
      mma::cp_async16(sw + (row * W_ROW + piece * EPP) * (int)sizeof(T), src, ok);
    }
  } else {  // element by element
    for (int i = threadIdx.x; i < G::HALO * G::HALO * KC; i += G::THREADS) {
      const int c = i % KC;
      const int p = i / KC;
      const int r = p / G::HALO, q = p % G::HALO;
      const int hh = h0 - 1 + r, ww = w0 - 1 + q, ci = ci0 + c;
      T v = Elem<T>::from(0.f);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && ci < Cin)
        v = xn[((size_t)hh * W + ww) * Cin + ci];
      *reinterpret_cast<T*>(sx + x_slot<TILE>(r, q) * PIX_BYTES + c * (int)sizeof(T)) = v;
    }
    for (int i = threadIdx.x; i < 9 * KC * BLOCK_C; i += G::THREADS) {
      const int co = i % BLOCK_C;
      const int row = i / BLOCK_C;
      const int ci = ci0 + row % KC, cc = c0 + co;
      T v = Elem<T>::from(0.f);
      if (ci < Cin && cc < Cout) v = w[((size_t)(row / KC) * Cin + ci) * Cout + cc];
      *reinterpret_cast<T*>(sw + (row * W_ROW + co) * (int)sizeof(T)) = v;
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

// One staged chunk's products: float32 by 3xTF32.  The chunk's 27 products
// of each output are summed into a zeroed partial, which a float32 FADD
// then adds to acc (see the head comment: the tensor cores' own sums
// truncate).  One row of taps (dy) at a time: with all nine unrolled,
// ptxas hoists so many fragments beside the 128 registers of acc and part
// that it spills.
template <int TILE>
__device__ __forceinline__ void chunk_products(float (&acc)[4][N_TILES][4],
                                               const char* xa, const char* wb, float) {
  float part[4][N_TILES][4] = {};
#pragma unroll 1
  for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int tap = dy * 3 + dx;
      uint32_t bb[N_TILES][2], bs[N_TILES][2];
#pragma unroll
      for (int j = 0; j < N_TILES; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mma::tf32_split(*reinterpret_cast<const float*>(
                              wb + ((tap * 8 + 4 * h) * W_ROW + 8 * j) * 4),
                          bb[j][h], bs[j][h]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t a[4], ab[4], as[4];
        mma::ldmatrix_x4(a, xa + a_shift<TILE>(mt, dy, dx));
#pragma unroll
        for (int i = 0; i < 4; ++i) mma::tf32_split(__uint_as_float(a[i]), ab[i], as[i]);
#pragma unroll
        for (int j = 0; j < N_TILES; ++j) {
          mma::mma_tf32(part[mt][j], as, bb[j][0], bb[j][1]);
          mma::mma_tf32(part[mt][j], ab, bs[j][0], bs[j][1]);
          mma::mma_tf32(part[mt][j], ab, bb[j][0], bb[j][1]);
        }
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < N_TILES; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] += part[mt][j][i];
}

// One staged chunk's products: bfloat16, one m16n8k16 product a step.
template <int TILE>
__device__ __forceinline__ void chunk_products(float (&acc)[4][N_TILES][4],
                                               const char* xa, const char* wb,
                                               __nv_bfloat16) {
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    uint32_t b[N_TILES][2];
#pragma unroll
    for (int p = 0; p < N_TILES / 2; ++p) {
      uint32_t r[4];
      mma::ldmatrix_x4_trans(r, wb + (tap * 16 * W_ROW + 16 * p) * 2);
      b[2 * p][0] = r[0];
      b[2 * p][1] = r[1];
      b[2 * p + 1][0] = r[2];
      b[2 * p + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      uint32_t a[4];
      mma::ldmatrix_x4(a, xa + a_shift<TILE>(mt, dy, dx));
#pragma unroll
      for (int j = 0; j < N_TILES; ++j) mma::mma_bf16(acc[mt][j], a, b[j][0], b[j][1]);
    }
  }
}

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

// grid (tiles_h * tiles_w, ceil(Cout / BLOCK_C), batch), Geo<TILE>::THREADS
// threads, Geo<TILE>::SMEM_BYTES of dynamic shared memory.
template <typename T, int TILE>
__global__ void __launch_bounds__(Geo<TILE>::THREADS, 1)
fused_conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ b, T* __restrict__ y, int H, int W,
                     int Cin, int Cout, int tiles_w, int pool, int vec) {
  using G = Geo<TILE>;
  constexpr int KC = CHUNK_BYTES / (int)sizeof(T);
  extern __shared__ __align__(128) char smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_m = warp % G::WARPS_M;
  const int warp_n = warp / G::WARPS_M;
  const int h0 = (blockIdx.x / tiles_w) * TILE;
  const int w0 = (blockIdx.x % tiles_w) * TILE;
  const int c0 = blockIdx.y * BLOCK_C;
  const int n = blockIdx.z;
  const T* xn = x + (size_t)n * H * W * Cin;

  // This lane's ldmatrix row: window warp_m * 16 + lane % 16 (its top-left
  // pixel), the k half lane / 16.
  const int wa = warp_m * 16 + (lane & 15);
  const int a_off = x_slot<TILE>(2 * (wa / G::WIN), 2 * (wa % G::WIN)) * PIX_BYTES +
                    (lane >> 4) * 16;
  // This lane's B element: (k t, n g) for tf32; ldmatrix.trans rows for bf16.
  const int b_off = sizeof(T) == 4
                        ? ((lane & 3) * W_ROW + warp_n * WARP_C + (lane >> 2)) * 4
                        : (mma::bkn_row(lane) * W_ROW + warp_n * WARP_C + mma::bkn_col(lane)) * 2;

  float acc[4][N_TILES][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int j = 0; j < N_TILES; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;

  const int n_chunks = (Cin + KC - 1) / KC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks)
      stage_chunk<T, TILE>(smem + s * G::STAGE_BYTES, xn, w, H, W, Cin, Cout, h0, w0, c0,
                           s * KC, vec);
    mma::cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1
    const int next = c + STAGES - 1;
    if (next < n_chunks)
      stage_chunk<T, TILE>(smem + (next % STAGES) * G::STAGE_BYTES, xn, w, H, W, Cin, Cout,
                           h0, w0, c0, next * KC, vec);
    mma::cp_async_commit();
    const char* sx = smem + (c % STAGES) * G::STAGE_BYTES;
    chunk_products<TILE>(acc, sx + a_off, sx + G::X_BYTES + b_off, T());
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
    const float b0 = Elem<T>::f32(b[cc]);
    const float b1 = second ? Elem<T>::f32(b[cc + 1]) : 0.f;
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

struct Args {
  const void* x;
  const void* w;
  const void* b;
  void* y;
  int H, W, Cin, Cout, pool, tiles_w, vec;
  dim3 grid;
  cudaStream_t stream;
};

template <typename T, int TILE>
int launch(const Args& a) {
  using G = Geo<TILE>;
  static bool smem_set[64];
  auto kern = fused_conv3x3_kernel<T, TILE>;
  const cudaError_t err = mma::set_smem_once(kern, G::SMEM_BYTES, smem_set);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.grid, G::THREADS, G::SMEM_BYTES, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w), static_cast<const T*>(a.b),
      static_cast<T*>(a.y), a.H, a.W, a.Cin, a.Cout, a.tiles_w, a.pool, a.vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile(const Args& a, int tile) {
  if (tile == TILE_BIG) return launch<T, TILE_BIG>(a);
  if (tile == TILE_SMALL) return launch<T, TILE_SMALL>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Threads and dynamic shared memory (bytes) of a block at `tile`, or -1
// for a tile this library was not built for.
extern "C" int fused_conv3x3_threads(int tile) {
  if (tile == TILE_BIG) return Geo<TILE_BIG>::THREADS;
  if (tile == TILE_SMALL) return Geo<TILE_SMALL>::THREADS;
  return -1;
}

extern "C" int fused_conv3x3_smem_bytes(int tile) {
  if (tile == TILE_BIG) return Geo<TILE_BIG>::SMEM_BYTES;
  if (tile == TILE_SMALL) return Geo<TILE_SMALL>::SMEM_BYTES;
  return -1;
}

// C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16 (x, w,
// b and y share it).  The caller passes the tile, the grid and the
// shared-memory size it computed (a size that disagrees with this build's
// is refused) and `vec`: 1 when x and w are 16-byte aligned and Cin and
// Cout rows are whole 16-byte pieces.  Returns the CUDA error code of the
// launch (0 on success).
extern "C" int fused_conv3x3_launch(const void* x, const void* w, const void* b, void* y,
                                    int H, int W, int Cin, int Cout, int pool, int dtype,
                                    int tile, int grid_x, int grid_y, int grid_z,
                                    int tiles_w, int smem_bytes, int vec, void* stream) {
  if (smem_bytes != fused_conv3x3_smem_bytes(tile)) return (int)cudaErrorInvalidValue;
  const Args a{x, w, b, y, H, W, Cin, Cout, pool, tiles_w, vec,
               dim3(grid_x, grid_y, grid_z), static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_tile<float>(a, tile);
  if (dtype == 1) return launch_tile<__nv_bfloat16>(a, tile);
  return (int)cudaErrorInvalidValue;
}
