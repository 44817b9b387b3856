// Encoder self-attention (K2): non-causal softmax(q k^T / sqrt(dh)) v.
//
// Replaces the TPU flash attention of the encoder: the library kernel
// jax.experimental.pallas.ops.tpu.flash_attention that
// thewhisper_tpu/models/whisper.py::_flash_attention calls, and the repo's
// own thewhisper_tpu/ops/attention_pallas.py::encoder_flash_attention
// (same math, kept there as a negative result).
//
// Interface: q, k, v are (B, S, H, 64) with any batch/sequence/head strides
// and a unit stride on the head dimension (the layout the projections
// produce, so no transpose or pad copy is made). Keys at or past valid_len
// are masked; S needs no tile multiple (1500 and 500 run as they are, the
// ragged tile is masked here instead of padded to 512 as on the TPU).
// Inputs are f32 or bf16; scores, softmax and the output sum are f32, and
// the output is written in the input type, (B, S, H, 64) contiguous.
//
// Bound on the H100: arithmetic. 4 S^2 dh FLOPs per (batch, head) against
// 3 S dh elements in, so the work is the two products. This first version
// runs them on the CUDA cores in f32 (mma.sync / wgmma come later), so the
// 67 TFLOP/s f32 rate is its ceiling, not the tensor cores; one 16-byte
// shared-memory load per 4 FMAs and 162 registers a thread (8 warps an SM)
// keep it below that ceiling.
// Design: flash attention with an online softmax. One block per
// (batch x head, tile of 128 queries); 256 threads, two per query, each
// owning half of the 64 dims in interleaved float4 chunks so the pair's
// shared-memory reads never collide. The block walks 32-key tiles of K and V
// staged in shared memory as f32; a thread's q, its 32 scores and its output
// accumulator stay in registers, and the pair combines its partial dot
// products with one shuffle. Scores are kept in the log2 domain for exp2f.

#include <math.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kDh = 64;
constexpr int kBlockQ = 128;
constexpr int kBlockK = 32;
constexpr int kThreads = 2 * kBlockQ;
constexpr int kHalf = kDh / 2;        // dims per thread
constexpr int kChunks = kHalf / 4;    // float4 chunks per thread
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
encoder_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, int S, int H,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         int valid_len, float scale) {
  __shared__ __align__(16) float ks[kBlockK][kDh];
  __shared__ __align__(16) float vs[kBlockK][kDh];

  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int half = threadIdx.x & 1;
  const int qi = blockIdx.x * kBlockQ + (threadIdx.x >> 1);
  const bool active = qi < S;
  // This thread's dims: float4 chunk 2 * c + half for c < kChunks.
  auto dim = [&](int c, int e) { return 4 * (2 * c + half) + e; };

  float qr[kHalf], acc[kHalf];
  const T* qp = q + b * q_sb + static_cast<long long>(qi) * q_ss + h * q_sh;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      qr[4 * c + e] = active ? to_f32(qp[dim(c, e)]) * scale : 0.0f;
      acc[4 * c + e] = 0.0f;
    }

  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const int limit = min(valid_len, S);
  float m = -INFINITY;  // running max, log2 domain
  float l = 0.0f;       // running sum of exp2(score - m)

  for (int t0 = 0; t0 < limit; t0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBlockK * kDh; idx += kThreads) {
      const int r = idx / kDh;
      const int c = idx - r * kDh;
      const int key = t0 + r;
      float kv = 0.0f, vv = 0.0f;
      if (key < limit) {
        kv = to_f32(kb[static_cast<long long>(key) * k_ss + c]);
        vv = to_f32(vb[static_cast<long long>(key) * v_ss + c]);
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(&ks[j][dim(c, 0)]);
        part = fmaf(qr[4 * c + 0], kk.x, part);
        part = fmaf(qr[4 * c + 1], kk.y, part);
        part = fmaf(qr[4 * c + 2], kk.z, part);
        part = fmaf(qr[4 * c + 3], kk.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      s[j] = (t0 + j < limit) ? part * kLog2e : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    // Every tile holds at least one valid key, so m_new is finite.
    const float m_new = fmaxf(m, tile_max);
    const float corr = exp2f(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < kHalf; ++i) acc[i] *= corr;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j][dim(c, 0)]);
        acc[4 * c + 0] = fmaf(p, vv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
      }
    }
    m = m_new;
  }

  if (!active) return;
  const float inv = 1.0f / l;
  T* op = out + ((static_cast<long long>(b) * S + qi) * H + h) * kDh;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) store(op + dim(c, e), acc[4 * c + e] * inv);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Strides are in elements. 1 <= valid_len <= S.
// Returns cudaGetLastError() (cudaErrorInvalidValue for dh != 64).
extern "C" int twt_encoder_attention(const void* q, const void* k, const void* v, void* out,
                                     int dtype, int B, int S, int H, int dh,
                                     long long q_sb, long long q_ss, long long q_sh,
                                     long long k_sb, long long k_ss, long long k_sh,
                                     long long v_sb, long long v_ss, long long v_sh,
                                     int valid_len, int device, void* stream) {
  if (dh != kDh || valid_len < 1 || valid_len > S) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  const float scale = 0.125f;  // 64 ** -0.5, exact
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    encoder_attention_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, H,
        q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, valid_len, scale);
  } else {
    encoder_attention_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), S, H,
        q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, valid_len, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
