// Device helpers that K3 (mega_step.cu) and K4 (mega_verify.cu) share:
// bf16 and int8 unpacking, warp and block reductions, the grid barrier of
// a cooperative launch, the bf16 residual add and tanh GELU. Each
// including source gets its own copy (an unnamed namespace), so the two
// link into one library.

#pragma once

#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDh = 64;
constexpr float kScale = 0.125f;  // 64 ** -0.5, exact
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_lo(unsigned int u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }
// Signed byte i of w as a float.
__device__ __forceinline__ float s8(unsigned int w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}
// A value another block wrote in this launch: from L2, never a stale L1 line.
__device__ __forceinline__ float load_shared_bf16(const bf16* p) {
  return __uint_as_float(static_cast<unsigned int>(__ldcg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Sum (or max) over the block, returned to every thread. `red` holds kWarps floats.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  return t;
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t = fmaxf(t, red[w]);
  return t;
}

// Every block of the grid arrives before any leaves; writes made before
// the barrier are visible after it. bar[0] counts arrivals, bar[1] is the
// generation; the last block to arrive resets the count and bumps it.
__device__ void grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// x[r] += bf16(y), rounded to bf16 (the residual add of the plain version).
__device__ __forceinline__ void residual(bf16* x, int r, float y) {
  x[r] = __float2bfloat16(load_shared_bf16(x + r) + round_bf16(y));
}

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.0f + tanhf(0.7978845608028654f * fmaf(0.044715f * v, v * v, v)));
}

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }

}  // namespace
