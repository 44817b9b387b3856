// P1: the "no-exp" control of the encoder flash attention.
//
// Replaces tools/attention_probe.py:112, `control` (body control_kernel,
// :82-107): the TPU probe's timing control, flash attention with the
// exponential taken out. The math is wrong on purpose; the kernel measures
// the floor of the two products and the online bookkeeping. For each
// (batch x head, query row), over the 512-key tiles in order:
//   s = q . k in f32, with no 1/sqrt(dh) scale and no valid-length mask;
//   m_new = max(m, rowmax(s)), m starting at -1e9;
//   p = s - m_new: no exp, and acc is not rescaled by the old m;
//   l += sum(p) in f32, from p before it is rounded;
//   acc += p rounded to v's type @ v, summed in f32;
// and the output is acc / max(l, 1) in q's type. The answer depends on the
// 512-key tiling (m moves between tiles and earlier tiles are never
// corrected), so the kernel keeps those tile boundaries: all 512 scores of
// a tile are made before any of them is used.
//
// Bound on the H100: operations. 4 S^2 dh per (batch, head) against 4 S dh
// elements moved: 386.5 GFLOP at B = 32, H = 20, S = 1536, 0.39 ms at the
// 989 TFLOP/s bf16 tensor-core rate. This first version runs both products
// on the CUDA cores in f32 (67 TFLOP/s, 5.8 ms at that size), as K2 does;
// mma.sync / wgmma tiles come with K2's redesign.
//
// Design: one block per (batch x head, 64 query rows), 256 threads, four a
// query row; q's row stays in registers. A tile's 64 x 512 f32 scores live
// in shared memory (129 KB). First pass: 64-key chunks of K staged as f32;
// thread (row, c) makes the scores of keys c, c + 4, ... of each chunk, and
// the four threads of a row combine their maxima by shuffles. Second pass:
// 64-key chunks of V staged as f32; thread (row, c) owns the float4 chunks
// c, c + 4, c + 8, c + 12 of the output row and sums p[row, key] v[key] over
// the tile's keys in order. Row strides are padded by four floats so that
// neither pass has bank conflicts.

#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDh = 64;
constexpr int kRows = 64;              // query rows a block
constexpr int kTile = 512;             // keys a tile (the probe's block_k)
constexpr int kChunk = 64;             // keys staged at a time
constexpr int kThreads = 4 * kRows;
constexpr int kStride = kDh + 4;       // floats a staged K/V row
constexpr int kScoreStride = kTile + 4;  // floats a score row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// p as the value product takes it: rounded to v's type.
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// dst (kChunk, kStride) f32 = the kChunk contiguous (64)-rows at src.
template <typename T>
__device__ void stage(const T* __restrict__ src, float* dst) {
  for (int i = threadIdx.x; i < kChunk * kDh; i += kThreads)
    dst[(i / kDh) * kStride + i % kDh] = to_f32(src[i]);
}

size_t smem_bytes() { return sizeof(float) * (kRows * kScoreStride + kChunk * kStride); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_control_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, int S) {
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;                           // (kRows, kScoreStride)
  float* kv = smem + kRows * kScoreStride;    // (kChunk, kStride)
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const size_t head = static_cast<size_t>(blockIdx.y) * S * kDh;
  const size_t row = head + static_cast<size_t>(blockIdx.x * kRows + r) * kDh;
  float* my_scores = sc + r * kScoreStride;

  float qr[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) qr[d] = to_f32(q[row + d]);
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  float m = -1e9f, l = 0.0f;

  for (int t0 = 0; t0 < S; t0 += kTile) {
    // Pass 1: the tile's scores and its row maximum.
    float tile_max = -INFINITY;
    for (int k0 = 0; k0 < kTile; k0 += kChunk) {
      __syncthreads();  // the staged chunk is consumed
      stage(k + head + static_cast<size_t>(t0 + k0) * kDh, kv);
      __syncthreads();
      for (int j = 0; j < kChunk / 4; ++j) {
        const int key = c + 4 * j;
        const float4* kr = reinterpret_cast<const float4*>(kv + key * kStride);
        float s = 0.0f;
#pragma unroll
        for (int d4 = 0; d4 < kDh / 4; ++d4) {
          const float4 w = kr[d4];
          s = fmaf(qr[4 * d4 + 0], w.x, s);
          s = fmaf(qr[4 * d4 + 1], w.y, s);
          s = fmaf(qr[4 * d4 + 2], w.z, s);
          s = fmaf(qr[4 * d4 + 3], w.w, s);
        }
        my_scores[k0 + key] = s;
        tile_max = fmaxf(tile_max, s);
      }
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);

    // Pass 2: p = s - m_new, its row sum and the value product.
    for (int k0 = 0; k0 < kTile; k0 += kChunk) {
      __syncthreads();  // the staged chunk is consumed; the scores are written
      stage(v + head + static_cast<size_t>(t0 + k0) * kDh, kv);
      __syncthreads();
      for (int key = 0; key < kChunk; ++key) {
        const float p = my_scores[k0 + key] - m_new;
        l += p;
        const float pr = round_to(p, v);
        const float* vr = kv + key * kStride;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 w = *reinterpret_cast<const float4*>(vr + 4 * (c + 4 * i));
          acc[4 * i + 0] = fmaf(pr, w.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(pr, w.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(pr, w.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(pr, w.w, acc[4 * i + 3]);
        }
      }
    }
    m = m_new;
  }

  const float denom = fmaxf(l, 1.0f);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) store(out + row + 4 * (c + 4 * i) + e, acc[4 * i + e] / denom);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int S,
           cudaStream_t stream) {
  const size_t smem = smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(attention_control_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attention_control_kernel<T><<<dim3(S / kRows, BH), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, out: contiguous (BH, S, 64) device tensors of one type (dtype 0 =
// f32, 1 = bf16); S a multiple of 512. Returns cudaGetLastError()
// (cudaErrorInvalidValue for shapes it does not take).
extern "C" int twt_attention_control(const void* q, const void* k, const void* v, void* out,
                                     int dtype, int BH, int S, int dh, int device, void* stream) {
  if (dh != kDh || BH < 1 || BH > 65535 || S < kTile || S % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(q, k, v, out, BH, S, st)
                    : launch<float>(q, k, v, out, BH, S, st);
}
