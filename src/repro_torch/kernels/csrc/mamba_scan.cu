// Selective scan for Hopper (sm_90a): the Mamba-1 recurrence
//   h_t = dA_t * h + dBx_t,   y_t[d] = sum_s h_t[d, s] * C_t[s]
// over dA, dBx (B, S, di, ds) float32, C (B, S, ds) float32, with an
// optional state h0 (B, di, ds) before the first step (zeros without it)
// and, when asked for, the state after the last step written to h_out
// (B, di, ds).  y is (B, S, di) float32.  Any S >= 1, any di, ds <= 16.
//
// Replaces: src/repro/kernels/mamba_scan.py::selective_scan, the Pallas TPU
// kernel (`_kernel`, launched by `pl.pallas_call`).  Without h0 and h_out
// it computes exactly that kernel's function.  What it keeps is the fusion
// group's guarantee: the (di, ds) state never reaches device memory
// between steps, so the (S, di, ds) state sequence is never materialised.
// What it cannot keep is the TPU layout: the Pallas kernel stages
// (chunk 64, block_d 512, ds 16) float32 tiles of dA and dBx, 2 MiB each,
// in VMEM, and a Hopper block has 227 KB of shared memory.
//
// Layout chosen: one block per (sequence b, block_d channels), one thread
// per channel; the thread keeps its channel's ds state values in registers
// for the whole sequence and loops over S itself (the TPU grid's
// sequential axis).  Each step it reads its channel's ds contiguous dA and
// dBx values (float4 loads when ds % 4 == 0), so the 32 lanes of a warp
// read one contiguous 32 * ds * 4-byte span; the next step's values are
// loaded before the current step is computed, so one step's loads are in
// flight while the previous one's FMAs run.  C, shared by every channel,
// is staged in shared memory a chunk of steps at a time (chunk * ds * 4
// bytes) and read as a broadcast.  The readout y_t sums the thread's own
// registers, so it needs no shuffle and no shared memory.
//   Bytes: dA and dBx are read once (2 * 4 B S di ds per sequence, the
//   bulk), C once per channel block (from L2 after the first), y written
//   once, h0 and h_out once each when given.
//   FLOPs: 4 per (step, channel, state): one FMA for h, one for y.
//
// What bounds it: 4 FLOPs per 8 bytes read, far below the card's
// 20 FLOP/byte float32 ridge (67 TFLOP/s over 3.35 TB/s), so device
// memory.  No TMA or async copies: the prefill body reaches 88 % of that
// bound at falcon-mamba's (8, 512, 8192, 16).
//
// A decode step (S == 1) takes a body of its own: a thread a channel in
// blocks of STEP_BLOCK (128) channels, so that falcon-mamba's (8, 1, 8192,
// 16) launches 512 blocks; no shared memory and no barrier (C, one row of
// ds values a sequence, is read by every lane at the same address, a
// broadcast); h0, dA and dBx loads issued together, then y and the state
// stored.  Its sums are the prefill body's at S = 1, FMA for FMA.
//
// Build (see mamba_scan.py): nvcc -gencode arch=compute_90a,code=sm_90a
//   -O3 -shared -Xcompiler -fPIC.  One instantiation per ds in 1..16.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MAX_BLOCK_D = 512;  // threads (channels) a block, at most
constexpr int MAX_DS = 16;        // state width, at most

// v[0..DS) = p[0..DS); p is aligned to 4 * DS bytes (16 when DS % 4 == 0).
template <int DS>
__device__ __forceinline__ void load_row(const float* __restrict__ p, float (&v)[DS]) {
  if constexpr (DS % 4 == 0) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int k = 0; k < DS / 4; ++k) {
      const float4 f = __ldg(q + k);
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    }
  } else if constexpr (DS % 2 == 0) {
    const float2* q = reinterpret_cast<const float2*>(p);
#pragma unroll
    for (int k = 0; k < DS / 2; ++k) {
      const float2 f = __ldg(q + k);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < DS; ++k) v[k] = __ldg(p + k);
  }
}

template <int DS>
__device__ __forceinline__ void store_row(float* __restrict__ p, const float (&v)[DS]) {
  if constexpr (DS % 4 == 0) {
    float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
    for (int k = 0; k < DS / 4; ++k)
      q[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < DS; ++k) p[k] = v[k];
  }
}

// grid (ceil(di / blockDim.x), B), blockDim.x = block_d; dynamic shared
// memory chunk * DS floats.
template <int DS>
__global__ void __launch_bounds__(MAX_BLOCK_D)
selective_scan_kernel(const float* __restrict__ dA, const float* __restrict__ dBx,
                      const float* __restrict__ C, const float* __restrict__ h0,
                      float* __restrict__ y, float* __restrict__ h_out, int S,
                      int di, int chunk) {
  extern __shared__ float sc[];  // [chunk][DS]: C of the current chunk
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = c < di;
  // Past the ragged edge a thread reads a valid channel and stores nothing;
  // it stays to help stage C and to meet the barriers.
  const int cl = active ? c : di - 1;
  const size_t step = (size_t)di * DS;  // floats of one step of one sequence
  const float* pa = dA + (size_t)b * S * step + (size_t)cl * DS;
  const float* pb = dBx + (size_t)b * S * step + (size_t)cl * DS;
  const float* pc = C + (size_t)b * S * DS;
  float* py = y + (size_t)b * S * di + c;

  float h[DS];
  if (h0 != nullptr) {
    load_row<DS>(h0 + ((size_t)b * di + cl) * DS, h);
  } else {
#pragma unroll
    for (int s = 0; s < DS; ++s) h[s] = 0.f;
  }
  float a[DS], bx[DS];
  load_row<DS>(pa, a);
  load_row<DS>(pb, bx);

  for (int t0 = 0; t0 < S; t0 += chunk) {
    const int n = min(chunk, S - t0);
    __syncthreads();  // every thread is done with the previous chunk's C
    for (int i = threadIdx.x; i < n * DS; i += blockDim.x)
      sc[i] = pc[(size_t)t0 * DS + i];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const int t = t0 + j;
      // The next step's transitions (the last step reloads itself, from
      // cache), in flight while this step computes.
      const size_t tn = (size_t)(t + 1 < S ? t + 1 : t) * step;
      float an[DS], bn[DS];
      load_row<DS>(pa + tn, an);
      load_row<DS>(pb + tn, bn);
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        h[s] = fmaf(a[s], h[s], bx[s]);
        acc = fmaf(h[s], sc[j * DS + s], acc);
      }
      if (active) py[(size_t)t * di] = acc;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        a[s] = an[s];
        bx[s] = bn[s];
      }
    }
  }
  if (active && h_out != nullptr) store_row<DS>(h_out + ((size_t)b * di + c) * DS, h);
}

constexpr int STEP_BLOCK = 128;  // channels (threads) a block of the S == 1 body

// The S == 1 body: grid (ceil(di / STEP_BLOCK), B), STEP_BLOCK threads.
template <int DS>
__global__ void __launch_bounds__(STEP_BLOCK)
selective_scan_step_kernel(const float* __restrict__ dA, const float* __restrict__ dBx,
                           const float* __restrict__ C, const float* __restrict__ h0,
                           float* __restrict__ y, float* __restrict__ h_out, int di) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * STEP_BLOCK + threadIdx.x;
  if (c >= di) return;
  const size_t row = ((size_t)b * di + c) * DS;  // (b, 0, c, :) of dA, dBx; (b, c, :) of h
  float a[DS], bx[DS], h[DS], cv[DS];
  load_row<DS>(dA + row, a);
  load_row<DS>(dBx + row, bx);
  if (h0 != nullptr) {
    load_row<DS>(h0 + row, h);
  } else {
#pragma unroll
    for (int s = 0; s < DS; ++s) h[s] = 0.f;
  }
  load_row<DS>(C + (size_t)b * DS, cv);
  float acc = 0.f;
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    h[s] = fmaf(a[s], h[s], bx[s]);
    acc = fmaf(h[s], cv[s], acc);
  }
  y[(size_t)b * di + c] = acc;
  if (h_out != nullptr) store_row<DS>(h_out + row, h);
}

struct Args {
  const float* dA;
  const float* dBx;
  const float* C;
  const float* h0;
  float* y;
  float* h_out;
  int batch, S, di, chunk, block_d;
  cudaStream_t stream;
};

template <int DS>
int launch(const Args& a) {
  if (a.S == 1) {
    const dim3 grid((a.di + STEP_BLOCK - 1) / STEP_BLOCK, a.batch);
    selective_scan_step_kernel<DS><<<grid, STEP_BLOCK, 0, a.stream>>>(
        a.dA, a.dBx, a.C, a.h0, a.y, a.h_out, a.di);
    return (int)cudaGetLastError();
  }
  auto kern = selective_scan_kernel<DS>;
  const int smem = a.chunk * DS * (int)sizeof(float);
  if (smem > 48 * 1024) {  // above the default, opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.di + a.block_d - 1) / a.block_d, a.batch);
  kern<<<grid, a.block_d, smem, a.stream>>>(a.dA, a.dBx, a.C, a.h0, a.y, a.h_out,
                                             a.S, a.di, a.chunk);
  return (int)cudaGetLastError();
}

#define FOR_EACH_DS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

}  // namespace

// C interface, loaded with ctypes.  h0 and h_out may be null (zero initial
// state; no final state written).  Every pointer is 16-byte aligned and
// every array contiguous (the wrapper checks both).  Returns the CUDA error
// code (0 on success); shapes outside the kernel's range are refused with
// cudaErrorInvalidValue.  S == 1 runs the decode body, which ignores the
// tile.
extern "C" int selective_scan_launch(const void* dA, const void* dBx, const void* C,
                                     const void* h0, void* y, void* h_out, int batch,
                                     int S, int di, int ds, int chunk, int block_d,
                                     void* stream) {
  if (batch < 1 || batch > 65535 || S < 1 || di < 1 || chunk < 1 || block_d < 1 ||
      block_d > MAX_BLOCK_D)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(dA), static_cast<const float*>(dBx),
               static_cast<const float*>(C),  static_cast<const float*>(h0),
               static_cast<float*>(y),        static_cast<float*>(h_out),
               batch, S, di, chunk, block_d, static_cast<cudaStream_t>(stream)};
#define DISPATCH(DS_) \
  if (ds == DS_) return launch<DS_>(a);
  FOR_EACH_DS(DISPATCH)
#undef DISPATCH
  return (int)cudaErrorInvalidValue;
}

// Shared memory of one block (bytes): C staged for `chunk` steps, or -1
// for a state width the library was not built for.
extern "C" int selective_scan_smem_bytes(int chunk, int ds) {
  if (ds < 1 || ds > MAX_DS) return -1;
  return chunk * ds * (int)sizeof(float);
}

// The largest block_d (threads a block) and ds the library takes.
extern "C" int selective_scan_max_block_d(void) { return MAX_BLOCK_D; }
extern "C" int selective_scan_max_ds(void) { return MAX_DS; }
