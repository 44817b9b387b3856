// Encoder self-attention backward (K2-dkv and K2-dq): the gradients of
// O = softmax(q k^T / sqrt(dh)) v with respect to q, k and v, from dO and
// the forward's residuals.
//
// Replaces the two backward kernels of the TPU flash attention that
// thewhisper_tpu/models/whisper.py::_flash_attention reaches under
// jax.value_and_grad (jax.experimental.pallas.ops.tpu.flash_attention,
// a custom_vjp): _flash_attention_bwd_dkv (dK, dV) and
// _flash_attention_bwd_dq (dQ; the library's ds, the gradient of an
// additive bias, has no use here: Whisper has no bias). The library's
// split is kept: one kernel per key block walks every query and holds dK
// and dV in registers, one kernel per query block walks every key and
// holds dQ, so neither needs atomics or an S x S scratch.
//
// Inputs: q, k, v and dO as (B, S, H, 64) views (any batch, sequence and
// head strides, unit stride on the head dim), f32 or bf16; lse, f32
// (B, H, S), the natural-log log-sum-exp of each row's scaled scores that
// K2 writes with its output (csrc/encoder_attention.cu); di = rowsum(O *
// dO), f32 (B, H, S), one torch reduction in the wrapper as in the
// library (plain JAX there). Both kernels recompute
// P = exp(s / sqrt(dh) - lse) = exp2(s scale log2 e - lse log2 e) and
// dS = P (dO v^T - di). Keys >= valid_len are masked: their P is 0, and
// their dK and dV rows are written as zeros. Every query row < S takes
// part. Gradients are written contiguous (B, S, H, 64) in the operand
// type; sums are f32. In bf16, P and dS are rounded to bf16 before their
// products (dV = P^T dO, dK = dS^T q, dQ = dS k), the rule the forward
// keeps for P and the library keeps for both.
//
// Bound on the H100: arithmetic, 14 S^2 dh FLOPs per (batch, head) (the
// dK/dV kernel 8: the scores, dO v^T, P^T dO and dS^T q; the dQ kernel 6:
// the scores, dO v^T and dS k) against 5 S dh elements in. This first
// design runs every product on the CUDA cores, f32 and bf16 alike (bf16
// operands are widened to f32 when staged), so the f32 rate (67 TFLOP/s)
// is its ceiling; the tensor-core design is later work.
//
// Layout, as in K2's f32 route: two threads per row (a key in dK/dV, a
// query in dQ), each owning 32 of the 64 dims in interleaved float4
// chunks, combining its half dot products with one shuffle. The block
// stages 32 rows of the other side (q and dO, or k and v) in shared memory
// as f32 and walks them; the row's operands and its two (or one)
// gradient accumulators stay in registers.

#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDh = 64;
constexpr int kHalf = kDh / 2;       // dims a thread
constexpr int kChunks = kHalf / 4;   // float4 chunks a thread
constexpr int kBlockRows = 64;       // keys (dK/dV) or queries (dQ) a block
constexpr int kThreads = 2 * kBlockRows;
constexpr int kTile = 32;            // rows of the other side staged a pass
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// x rounded to the operand type (the identity in f32).
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// Element e of this thread's float4 chunk c: dim 4 (2 c + half) + e.
__device__ __forceinline__ int dim(int c, int e, int half) { return 4 * (2 * c + half) + e; }

// This thread's half of a row, widened to f32.
template <typename T>
__device__ __forceinline__ void load_half(float (&r)[kHalf], const T* row, bool live, int half) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) r[4 * c + e] = live ? to_f32(row[dim(c, e, half)]) : 0.0f;
}

// The pair's dot product of a register half-row with a staged row.
__device__ __forceinline__ float dot(const float (&r)[kHalf], const float* staged, int half) {
  float part = 0.0f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(staged + dim(c, 0, half));
    part = fmaf(r[4 * c + 0], x.x, part);
    part = fmaf(r[4 * c + 1], x.y, part);
    part = fmaf(r[4 * c + 2], x.z, part);
    part = fmaf(r[4 * c + 3], x.w, part);
  }
  return part + __shfl_xor_sync(0xffffffffu, part, 1);
}

// acc += a * staged (this thread's half).
__device__ __forceinline__ void axpy(float (&acc)[kHalf], float a, const float* staged, int half) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(staged + dim(c, 0, half));
    acc[4 * c + 0] = fmaf(a, x.x, acc[4 * c + 0]);
    acc[4 * c + 1] = fmaf(a, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(a, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(a, x.w, acc[4 * c + 3]);
  }
}

template <typename T>
__device__ __forceinline__ void store_half(T* row, const float (&r)[kHalf], float scale,
                                          int half) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) store(row + dim(c, e, half), r[4 * c + e] * scale);
}

struct Strides {
  long long b, s, h;
};

// dK and dV of 64 keys of one (batch, head). For each query j (all S):
// p = exp2(s_j scale log2 e - lse_j log2 e), dV += round(p) dO_j,
// dp = v . dO_j, dS = p (dp - di_j), dK += round(dS) q_j; dK is scaled
// by 1 / sqrt(dh) at the end.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         T* __restrict__ dk, T* __restrict__ dv, int S, int H, Strides qs,
                         Strides ks, Strides vs, Strides ds, int valid_len, float scale) {
  __shared__ __align__(16) float q_t[kTile][kDh];
  __shared__ __align__(16) float do_t[kTile][kDh];
  __shared__ float lse_t[kTile];  // lse log2 e
  __shared__ float di_t[kTile];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int half = threadIdx.x & 1;
  const int key = blockIdx.x * kBlockRows + (threadIdx.x >> 1);
  const bool live = key < valid_len;
  const float scale_log2 = scale * kLog2e;

  float kr[kHalf], vr[kHalf], dkr[kHalf], dvr[kHalf];
  load_half(kr, k + b * ks.b + static_cast<long long>(key) * ks.s + h * ks.h, live, half);
  load_half(vr, v + b * vs.b + static_cast<long long>(key) * vs.s + h * vs.h, live, half);
#pragma unroll
  for (int i = 0; i < kHalf; ++i) dkr[i] = dvr[i] = 0.0f;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* db = dout + b * ds.b + h * ds.h;
  const float* lse_b = lse + static_cast<long long>(bh) * S;
  const float* di_b = di + static_cast<long long>(bh) * S;
  // A block whose keys are all masked only writes zeros.
  const int q_end = blockIdx.x * kBlockRows < valid_len ? S : 0;
  for (int t0 = 0; t0 < q_end; t0 += kTile) {
    const int rows = min(kTile, S - t0);
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < rows * kDh; idx += kThreads) {
      const int r = idx / kDh;
      const int c = idx - r * kDh;
      const long long row = t0 + r;
      q_t[r][c] = to_f32(qb[row * qs.s + c]);
      do_t[r][c] = to_f32(db[row * ds.s + c]);
    }
    if (threadIdx.x < rows) {
      lse_t[threadIdx.x] = lse_b[t0 + threadIdx.x] * kLog2e;
      di_t[threadIdx.x] = di_b[t0 + threadIdx.x];
    }
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      const float s = dot(kr, q_t[j], half);
      const float p = live ? exp2f(fmaf(s, scale_log2, -lse_t[j])) : 0.0f;
      const float p_r = round_as(p, q);
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(&do_t[j][dim(c, 0, half)]);
        part = fmaf(vr[4 * c + 0], x.x, part);
        part = fmaf(vr[4 * c + 1], x.y, part);
        part = fmaf(vr[4 * c + 2], x.z, part);
        part = fmaf(vr[4 * c + 3], x.w, part);
        dvr[4 * c + 0] = fmaf(p_r, x.x, dvr[4 * c + 0]);
        dvr[4 * c + 1] = fmaf(p_r, x.y, dvr[4 * c + 1]);
        dvr[4 * c + 2] = fmaf(p_r, x.z, dvr[4 * c + 2]);
        dvr[4 * c + 3] = fmaf(p_r, x.w, dvr[4 * c + 3]);
      }
      const float dp = part + __shfl_xor_sync(0xffffffffu, part, 1);
      axpy(dkr, round_as(p * (dp - di_t[j]), q), q_t[j], half);
    }
  }

  if (key >= S) return;
  const long long out = (static_cast<long long>(b) * S + key) * H * kDh +
                        static_cast<long long>(h) * kDh;
  store_half(dk + out, dkr, scale, half);
  store_half(dv + out, dvr, 1.0f, half);
}

// dQ of 64 queries of one (batch, head). For each key j < valid_len:
// p = exp2(s_j scale log2 e - lse log2 e), dp = dO . v_j,
// dQ += round(p (dp - di)) k_j; scaled by 1 / sqrt(dh) at the end.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        T* __restrict__ dq, int S, int H, Strides qs, Strides ks, Strides vs,
                        Strides ds, int valid_len, float scale) {
  __shared__ __align__(16) float k_t[kTile][kDh];
  __shared__ __align__(16) float v_t[kTile][kDh];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int half = threadIdx.x & 1;
  const int qi = blockIdx.x * kBlockRows + (threadIdx.x >> 1);
  const bool active = qi < S;
  const float scale_log2 = scale * kLog2e;

  float qr[kHalf], dor[kHalf], dqr[kHalf];
  load_half(qr, q + b * qs.b + static_cast<long long>(qi) * qs.s + h * qs.h, active, half);
  load_half(dor, dout + b * ds.b + static_cast<long long>(qi) * ds.s + h * ds.h, active, half);
#pragma unroll
  for (int i = 0; i < kHalf; ++i) dqr[i] = 0.0f;
  const long long row = static_cast<long long>(bh) * S + qi;
  const float lse2 = active ? lse[row] * kLog2e : 0.0f;
  const float di_q = active ? di[row] : 0.0f;

  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  for (int t0 = 0; t0 < valid_len; t0 += kTile) {
    const int keys = min(kTile, valid_len - t0);
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < keys * kDh; idx += kThreads) {
      const int r = idx / kDh;
      const int c = idx - r * kDh;
      const long long key = t0 + r;
      k_t[r][c] = to_f32(kb[key * ks.s + c]);
      v_t[r][c] = to_f32(vb[key * vs.s + c]);
    }
    __syncthreads();
    for (int j = 0; j < keys; ++j) {
      float sp = 0.0f, dpp = 0.0f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 x = *reinterpret_cast<const float4*>(&k_t[j][dim(c, 0, half)]);
        const float4 y = *reinterpret_cast<const float4*>(&v_t[j][dim(c, 0, half)]);
        sp = fmaf(qr[4 * c + 0], x.x, sp);
        sp = fmaf(qr[4 * c + 1], x.y, sp);
        sp = fmaf(qr[4 * c + 2], x.z, sp);
        sp = fmaf(qr[4 * c + 3], x.w, sp);
        dpp = fmaf(dor[4 * c + 0], y.x, dpp);
        dpp = fmaf(dor[4 * c + 1], y.y, dpp);
        dpp = fmaf(dor[4 * c + 2], y.z, dpp);
        dpp = fmaf(dor[4 * c + 3], y.w, dpp);
      }
      const float s = sp + __shfl_xor_sync(0xffffffffu, sp, 1);
      const float dp = dpp + __shfl_xor_sync(0xffffffffu, dpp, 1);
      const float p = exp2f(fmaf(s, scale_log2, -lse2));
      axpy(dqr, round_as(p * (dp - di_q), q), k_t[j], half);
    }
  }

  if (!active) return;
  store_half(dq + (static_cast<long long>(b) * S + qi) * H * kDh + static_cast<long long>(h) * kDh,
             dqr, scale, half);
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* di, void* dk, void* dv, int B, int S, int H, Strides qs, Strides ks,
               Strides vs, Strides ds, int valid_len, cudaStream_t st) {
  const dim3 grid((S + kBlockRows - 1) / kBlockRows, B * H);
  attention_bwd_dkv_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dk), static_cast<T*>(dv), S, H, qs,
      ks, vs, ds, valid_len, 0.125f);  // 64 ** -0.5, exact
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* lse,
              const float* di, void* dq, int B, int S, int H, Strides qs, Strides ks,
              Strides vs, Strides ds, int valid_len, cudaStream_t st) {
  const dim3 grid((S + kBlockRows - 1) / kBlockRows, B * H);
  attention_bwd_dq_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, di, static_cast<T*>(dq), S, H, qs, ks, vs, ds,
      valid_len, 0.125f);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int dtype, int B, int S, int H, int dh, int valid_len) {
  return dh != kDh || (dtype != 0 && dtype != 1) || B < 1 || S < 1 || H < 1 ||
         B * H > 65535 || valid_len < 1 || valid_len > S;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Strides are in elements; dk, dv (and dq) are
// contiguous (B, S, H, 64) of the operand type, lse and di f32 (B, H, S).
// 1 <= valid_len <= S. Returns cudaGetLastError() (cudaErrorInvalidValue
// for dh != 64 or an argument out of range).
extern "C" int twt_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* di,
                                     void* dk, void* dv, int dtype, int B, int S, int H, int dh,
                                     long long q_sb, long long q_ss, long long q_sh,
                                     long long k_sb, long long k_ss, long long k_sh,
                                     long long v_sb, long long v_ss, long long v_sh,
                                     long long do_sb, long long do_ss, long long do_sh,
                                     int valid_len, int device, void* stream) {
  if (bad_args(dtype, B, S, H, dh, valid_len)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      ds{do_sb, do_ss, do_sh};
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_dkv<__nv_bfloat16>(q, k, v, dout, l, d, dk, dv, B, S, H, qs, ks, vs,
                                                ds, valid_len, st)
                    : launch_dkv<float>(q, k, v, dout, l, d, dk, dv, B, S, H, qs, ks, vs, ds,
                                        valid_len, st);
}

extern "C" int twt_attention_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* di, void* dq,
                                    int dtype, int B, int S, int H, int dh,
                                    long long q_sb, long long q_ss, long long q_sh,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh,
                                    long long do_sb, long long do_ss, long long do_sh,
                                    int valid_len, int device, void* stream) {
  if (bad_args(dtype, B, S, H, dh, valid_len)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh},
      ds{do_sb, do_ss, do_sh};
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_dq<__nv_bfloat16>(q, k, v, dout, l, d, dq, B, S, H, qs, ks, vs, ds,
                                               valid_len, st)
                    : launch_dq<float>(q, k, v, dout, l, d, dq, B, S, H, qs, ks, vs, ds,
                                       valid_len, st);
}
