// P2 and P3: the batch-1 int8 MLP chain of a decoder stack.
//
// Replaces tools/gemv_chain_probe.py:150 (build_mlp_chain_kernel, P2: the
// L-layer chain as one Pallas program) and tools/gemv_chain_probe.py:259
// (build_mlp_layer_kernel, P3: one pallas_call a layer, the layer index a
// scalar prefetch). For each layer l of [l0, l1):
//   q_in = bf16(LayerNorm(x) * ln_s[l] + ln_b[l]), f32 statistics, eps 1e-5;
//   h = bf16(gelu_tanh(bf16((q_in @ W1[l]) * s1[l] + b1[l])));
//   y = (h @ W2[l]) * s2[l] + b2[l];
//   x = bf16(x + bf16(y));
// every product over int8 weights widened to the activation's values, summed
// in f32. P2 is one launch over [0, L); P3 one launch over [l, l + 1).
//
// Bound on the H100: device memory. A layer reads 2 D F int8 weight bytes:
// 13.1 MB at D 1280, F 5120, and 419.4 MB over 32 layers, 0.125 ms at
// 3.35 TB/s. Its 4 D F operations are two a byte, far below every compute
// rate. The second bound is the chain of dependent phases: four grid-wide
// barriers a layer.
//
// Design (simple first): one cooperative launch of one 512-thread block on
// every SM, with K3's hand-written grid barrier (mega_common.cuh). The
// weights are read as the probe stores them, (L, in, out) int8: a warp
// covers 128 output columns, lane j the four bytes 4j .. 4j + 3 of a row,
// so neighbouring lanes read neighbouring bytes and a warp reads 128 bytes
// a row. A block item is (128 columns, 128 rows of the contraction); each of
// its 16 warps sums 8 rows, the block adds the warps' sums in warp order in
// shared memory and writes one partial a column. After a barrier, one thread
// a column adds that column's partials in row order and applies the scale,
// the bias and GELU or the residual. No float atomics: a run is
// deterministic, and a layer gives the same bits inside the chain and
// alone. Every block recomputes the LayerNorm of x rather than paying a
// barrier for it.

#include "mega_common.cuh"

namespace {

constexpr int kCols = 128;                       // output columns an item, 4 a lane
constexpr int kRowsPerWarp = 8;
constexpr int kChunkRows = kWarps * kRowsPerWarp;  // contraction rows an item

struct Args {
  bf16* x;                      // (D) residual stream, updated in place
  const float *ln_s, *ln_b;     // (L, D)
  const float *s1, *b1;         // (L, F)
  const float *s2, *b2;         // (L, D)
  const int8_t *w1, *w2;        // (L, D, F), (L, F, D)
  bf16* h;                      // (F) scratch: the GELU output
  float* part;                  // (D F / kChunkRows) scratch: partial sums
  unsigned int* bar;            // (2) grid barrier
  int D, F, l0, l1;
};

// act = bf16(LayerNorm(x) * g + b): K3's LayerNorm, x read from L2.
__device__ void layer_norm(const bf16* x, const float* g, const float* b, int D, bf16* act,
                           float* xf, float* red) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = load_shared_bf16(x + i);
    xf[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / D;
  float s2 = 0.0f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float d = xf[i] - mean;
    s2 = fmaf(d, d, s2);
  }
  const float rstd = rsqrtf(block_sum(s2, red) / D + 1e-5f);
  for (int i = threadIdx.x; i < D; i += kThreads)
    act[i] = __float2bfloat16((xf[i] - mean) * rstd * g[i] + b[i]);
  __syncthreads();
}

// part[chunk * N + n] = sum over the chunk's kChunkRows rows k of act[k] W[k, n],
// for the (K, N) int8 row-major W; items go round robin over the blocks.
__device__ void partials(const int8_t* W, int K, int N, const bf16* act, float* red,
                         float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = N / kCols, items = groups * (K / kChunkRows);
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int g = item % groups, chunk = item / groups;
    const int k0 = chunk * kChunkRows + warp * kRowsPerWarp;
    const unsigned int* w =
        reinterpret_cast<const unsigned int*>(W + static_cast<size_t>(k0) * N + g * kCols) + lane;
    unsigned int wr[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) wr[i] = __ldcs(w + static_cast<size_t>(i) * (N / 4));
    float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float x = __bfloat162float(act[k0 + i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = fmaf(s8(wr[i], j), x, a[j]);
    }
    reinterpret_cast<float4*>(red)[warp * (kCols / 4) + lane] = make_float4(a[0], a[1], a[2], a[3]);
    __syncthreads();
    if (threadIdx.x < kCols) {
      float s = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) s += red[wi * kCols + threadIdx.x];
      part[static_cast<size_t>(chunk) * N + g * kCols + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

// The column n's partials of the last product, added in row-chunk order.
__device__ __forceinline__ float column_sum(const float* part, int chunks, int N, int n) {
  float s = 0.0f;
#pragma unroll 8
  for (int c = 0; c < chunks; ++c) s += __ldcg(part + static_cast<size_t>(c) * N + n);
  return s;
}

// Shared memory: act (bf16, max(D, F)) | red (kWarps x kCols) | xf (D) | rs (kWarps).
__host__ __device__ inline size_t smem_bytes(int D, int F) {
  return 2 * static_cast<size_t>(D > F ? D : F) + 4 * static_cast<size_t>(kWarps * kCols + D + kWarps);
}

__global__ void __launch_bounds__(kThreads, 1) mlp_chain_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.D, F = p.F;
  bf16* act = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + 2 * static_cast<size_t>(D > F ? D : F));
  float* xf = red + kWarps * kCols;
  float* rs = xf + D;
  const int tid = blockIdx.x * kThreads + threadIdx.x, nthreads = gridDim.x * kThreads;

  for (int l = p.l0; l < p.l1; ++l) {
    const size_t df = static_cast<size_t>(D) * F;
    const float *s1 = p.s1 + static_cast<size_t>(l) * F, *b1 = p.b1 + static_cast<size_t>(l) * F;
    const float *s2 = p.s2 + static_cast<size_t>(l) * D, *b2 = p.b2 + static_cast<size_t>(l) * D;
    // fc1 over LN(x).
    layer_norm(p.x, p.ln_s + static_cast<size_t>(l) * D, p.ln_b + static_cast<size_t>(l) * D, D,
               act, xf, rs);
    partials(p.w1 + l * df, D, F, act, red, p.part);
    grid_sync(p.bar);
    for (int n = tid; n < F; n += nthreads)
      p.h[n] = __float2bfloat16(
          gelu_tanh(round_bf16(fmaf(column_sum(p.part, D / kChunkRows, F, n), s1[n], b1[n]))));
    grid_sync(p.bar);
    // fc2 over h, into the residual.
    const uint4* hv = reinterpret_cast<const uint4*>(p.h);
    for (int i = threadIdx.x; i < F / 8; i += kThreads) reinterpret_cast<uint4*>(act)[i] = __ldcg(hv + i);
    __syncthreads();
    partials(p.w2 + l * df, F, D, act, red, p.part);
    grid_sync(p.bar);
    for (int n = tid; n < D; n += nthreads)
      residual(p.x, n, fmaf(column_sum(p.part, F / kChunkRows, D, n), s2[n], b2[n]));
    if (l + 1 < p.l1) grid_sync(p.bar);
  }
}

}  // namespace

// Device pointers of contiguous tensors (shapes in Args); x (D) bf16 is
// updated in place; h holds F bf16, part D F / 128 floats. Needs D and F
// multiples of 128 and 0 <= l0 < l1 <= L. Returns the CUDA error of the
// launch (cudaErrorInvalidValue for shapes it does not take,
// cudaErrorCooperativeLaunchTooLarge if not one block fits an SM).
extern "C" int twt_mlp_chain(void* x, const void* ln_s, const void* ln_b, const void* s1,
                             const void* b1, const void* s2, const void* b2, const void* w1,
                             const void* w2, void* h, void* part, void* barrier, int L, int D,
                             int F, int l0, int l1, int device, void* stream) {
  if (D < kCols || F < kCols || D % kCols || F % kCols || l0 < 0 || l0 >= l1 || l1 > L)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);

  Args p;
  p.x = static_cast<bf16*>(x);
  p.ln_s = static_cast<const float*>(ln_s);
  p.ln_b = static_cast<const float*>(ln_b);
  p.s1 = static_cast<const float*>(s1);
  p.b1 = static_cast<const float*>(b1);
  p.s2 = static_cast<const float*>(s2);
  p.b2 = static_cast<const float*>(b2);
  p.w1 = static_cast<const int8_t*>(w1);
  p.w2 = static_cast<const int8_t*>(w2);
  p.h = static_cast<bf16*>(h);
  p.part = static_cast<float*>(part);
  p.bar = static_cast<unsigned int*>(barrier);
  p.D = D; p.F = F; p.l0 = l0; p.l1 = l1;

  const size_t smem = smem_bytes(D, F);
  err = cudaFuncSetAttribute(mlp_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mlp_chain_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // A fresh barrier for every launch, as K3's.
  err = cudaMemsetAsync(barrier, 0, 2 * sizeof(unsigned int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(mlp_chain_kernel), dim3(sms),
                                    dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
