// K3: the batch-1 decoder step of an int8 "S" engine in one launch.
//
// Replaces thewhisper_tpu/ops/mega_step.py:602, `run` in _build_mega_fn:
// the Pallas TPU megakernel that the JAX package's greedy loop calls for
// every token of a bs=1 bf16 engine with int8 weights and int8 cross K/V.
// For each of L layers: LN1, the fused int8 qkv GEMV (k and v also go to
// self-cache slot `pos`), self-attention over slots below `pos` plus the
// fresh token as one extra logit, the int8 out-projection, LN, the int8
// cross-query GEMV, cross-attention over the int8 K/V with its scales
// folded (the K scale into the query, the V scale into the output) and
// the alignment heads' probabilities summed into `align`, the int8 cross
// out-projection, LN2, int8 fc1, tanh GELU, int8 fc2. Then the final LN
// and the int8 tied-table logits, (x . q[v]) * s[v] in f32.
//
// Numerics: LayerNorm in f32; every int8 product accumulates in f32 and
// takes its scale and bias after the sum; projections round to bf16;
// attention scores and softmax in f32; the residual stream in bf16.
// ops/mega_step.py::mega_step_plain is the same function in plain torch.
//
// Bound on the H100: device memory. At large-v3 (L 32, D 1280, F 5120,
// V 51866, T 1500) a step reads 14 D^2 = 22.9 MB of int8 weights a layer
// (734 MB), the 66.4 MB int8 table, 2 T D = 3.84 MB of int8 cross K/V a
// layer (123 MB) and 0.16 MB of bf16 self K/V a slot: about 0.93 GB, which
// is 0.28 ms at 3.35 TB/s. The arithmetic (two operations a byte) is far
// below the tensor cores' line, so they are not used. The second bound is
// the chain of dependent phases: eight a layer, each ending in a grid-wide
// barrier, 256 at L = 32.
//
// Design (simple first): one cooperative launch of one 512-thread block on
// every SM, persistent over all phases, with a hand-written grid barrier (a
// global arrival counter and a generation word; the cooperative launch
// guarantees every block is resident). GEMV phases give each warp of the
// grid whole output rows of an (out, in) int8 matrix, read as stored, 8
// bytes a lane per load, against the bf16 activation row that each block
// keeps in shared memory (LayerNorm is recomputed by every block rather
// than paying a barrier for it). Attention phases give each block a head:
// the self-attention walks the bf16 cache (L, H, S, 64) one warp per slot,
// the cross-attention walks the int8 (L, H, T, 64) K one thread per row and
// V one half-warp per row. Values shared between blocks go through L2
// (ld.global.cg). Weights are streamed (ld.global.cs): nothing of them is
// reused within a step. Left for later: splitting the attention phases over
// more than H blocks, prefetching the next phase's weights into L2 during
// the barriers and attention, and fewer barriers.

#include "mega_common.cuh"

namespace {

struct Args {
  const int8_t *qkv_w, *o_w, *cq_w, *co_w, *fc1_w, *fc2_w;  // (L, out, in)
  const float* smalls;                                      // (L, 20 D + 2 F)
  const float* lnp;                                         // (2, D)
  const int8_t* emb_q;                                      // (V, D)
  const float* emb_s;                                       // (V)
  bf16 *self_k, *self_v;                                    // (L, H, S, 64)
  const int8_t *cross_k, *cross_v;                          // (L, H, T, 64)
  const float *cross_ks, *cross_vs;                         // (L, D)
  const int* heads;                                         // (A, 2)
  bf16* x;                                                  // (D) residual
  bf16 *qkv, *att, *hid;                                    // scratch
  float* cq;                                                // (D) scratch
  float* logits;                                            // (V)
  float* align;                                             // (max(A, 1), T)
  unsigned int* bar;                                        // (2)
  int L, D, F, H, V, S, T, A, pos, capture;
};

// act = bf16(LayerNorm(x) * g + b), the row every block multiplies next.
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

// act = the n-element bf16 vector another phase wrote (n % 8 == 0).
__device__ void load_act(const bf16* src, int n, bf16* act) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(act);
  for (int i = threadIdx.x; i < n / 8; i += kThreads) d[i] = __ldcg(s + i);
  __syncthreads();
}

// 8 int8 weights against 8 bf16 activations, in f32.
__device__ __forceinline__ float dot8(uint2 w, uint4 a) {
  float s = s8(w.x, 0) * bf16_lo(a.x);
  s = fmaf(s8(w.x, 1), bf16_hi(a.x), s);
  s = fmaf(s8(w.x, 2), bf16_lo(a.y), s);
  s = fmaf(s8(w.x, 3), bf16_hi(a.y), s);
  s = fmaf(s8(w.y, 0), bf16_lo(a.z), s);
  s = fmaf(s8(w.y, 1), bf16_hi(a.z), s);
  s = fmaf(s8(w.y, 2), bf16_lo(a.w), s);
  return fmaf(s8(w.y, 3), bf16_hi(a.w), s);
}

// For every row r of the (R, K) int8 matrix W, epi(r, sum_k act[k] W[r, k])
// on lane 0 of the warp that owns the row. Rows go round robin over every
// warp of the grid; K % 8 == 0.
template <typename Epi>
__device__ void gemv(const int8_t* W, int R, int K, const bf16* act, Epi epi) {
  const int lane = threadIdx.x & 31;
  const int chunks = K / 8;
  const uint4* a = reinterpret_cast<const uint4*>(act);
  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < R; r += gridDim.x * kWarps) {
    const uint2* row = reinterpret_cast<const uint2*>(W + static_cast<size_t>(r) * K);
    float acc = 0.0f;
#pragma unroll 4
    for (int c = lane; c < chunks; c += 32) acc += dot8(__ldcs(row + c), a[c]);
    acc = warp_sum(acc);
    if (lane == 0) epi(r, acc);
  }
}

// Self-attention of layer l: one block per head. Scores of slots < pos come
// from the cache; slot pos is the fresh token, read from the qkv scratch.
__device__ void self_attention(const Args& p, int l, float* lg, float* qs, float* part,
                               float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos = p.pos;
  for (int h = blockIdx.x; h < p.H; h += gridDim.x) {
    const unsigned int* kc = reinterpret_cast<const unsigned int*>(p.qkv + p.D + h * kDh);
    const unsigned int* vc = reinterpret_cast<const unsigned int*>(p.qkv + 2 * p.D + h * kDh);
    if (threadIdx.x < kDh) qs[threadIdx.x] = load_shared_bf16(p.qkv + h * kDh + threadIdx.x) * kScale;
    __syncthreads();
    const size_t base = (static_cast<size_t>(l) * p.H + h) * p.S * kDh;
    const unsigned int* K = reinterpret_cast<const unsigned int*>(p.self_k + base);
    const unsigned int* V = reinterpret_cast<const unsigned int*>(p.self_v + base);
    const float q0 = qs[2 * lane], q1 = qs[2 * lane + 1];
    for (int s = warp; s <= pos; s += kWarps) {
      const unsigned int u = s < pos ? K[s * (kDh / 2) + lane] : __ldcg(kc + lane);
      const float d = warp_sum(fmaf(q0, bf16_lo(u), q1 * bf16_hi(u)));
      if (lane == 0) lg[s] = d;
    }
    __syncthreads();
    float m = -INFINITY;
    for (int s = threadIdx.x; s <= pos; s += kThreads) m = fmaxf(m, lg[s]);
    m = block_max(m, red);
    float z = 0.0f;
    for (int s = threadIdx.x; s <= pos; s += kThreads) {
      const float e = expf(lg[s] - m);
      lg[s] = e;
      z += e;
    }
    const float inv = 1.0f / block_sum(z, red);
    float a0 = 0.0f, a1 = 0.0f;
    for (int s = warp; s <= pos; s += kWarps) {
      const unsigned int u = s < pos ? V[s * (kDh / 2) + lane] : __ldcg(vc + lane);
      a0 = fmaf(lg[s], bf16_lo(u), a0);
      a1 = fmaf(lg[s], bf16_hi(u), a1);
    }
    part[warp * kDh + 2 * lane] = a0;
    part[warp * kDh + 2 * lane + 1] = a1;
    __syncthreads();
    if (threadIdx.x < kDh) {
      float o = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += part[w * kDh + threadIdx.x];
      p.att[h * kDh + threadIdx.x] = __float2bfloat16(o * inv);
    }
    __syncthreads();
  }
}

// Cross-attention of layer l over the int8 K/V: one block per head. The
// query in the cq scratch already carries the K scale and 1/sqrt(64).
__device__ void cross_attention(const Args& p, int l, float* lg, float* qs, float* part,
                                float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = p.T;
  for (int h = blockIdx.x; h < p.H; h += gridDim.x) {
    if (threadIdx.x < kDh) qs[threadIdx.x] = __ldcg(p.cq + h * kDh + threadIdx.x);
    __syncthreads();
    const size_t base = (static_cast<size_t>(l) * p.H + h) * T * kDh;
    const int4* K = reinterpret_cast<const int4*>(p.cross_k + base);
    const unsigned int* V = reinterpret_cast<const unsigned int*>(p.cross_v + base);
    float m = -INFINITY;
    for (int t = threadIdx.x; t < T; t += kThreads) {
      float d = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int4 w = __ldcs(K + t * 4 + c);
        const unsigned int ws[4] = {static_cast<unsigned int>(w.x), static_cast<unsigned int>(w.y),
                                    static_cast<unsigned int>(w.z), static_cast<unsigned int>(w.w)};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) d = fmaf(s8(ws[j], i), qs[16 * c + 4 * j + i], d);
      }
      lg[t] = d;
      m = fmaxf(m, d);
    }
    m = block_max(m, red);
    float z = 0.0f;
    for (int t = threadIdx.x; t < T; t += kThreads) {
      const float e = expf(lg[t] - m);
      lg[t] = e;
      z += e;
    }
    const float inv = 1.0f / block_sum(z, red);
    for (int t = threadIdx.x; t < T; t += kThreads) {
      const float pr = lg[t] * inv;
      lg[t] = pr;
      if (p.capture)
        for (int a = 0; a < p.A; ++a)
          if (p.heads[2 * a] == l && p.heads[2 * a + 1] == h) {
            float* dst = p.align + static_cast<size_t>(a) * T + t;
            *dst = __ldcg(dst) + pr;
          }
    }
    __syncthreads();
    // Two rows a warp, four dims a lane.
    const int half = lane >> 4, c4 = (lane & 15) * 4;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int t = 2 * warp + half; t < T; t += 2 * kWarps) {
      const unsigned int u = __ldcs(V + t * (kDh / 4) + (lane & 15));
      const float pr = lg[t];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(pr, s8(u, i), acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], 16);
    if (half == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[warp * kDh + c4 + i] = acc[i];
    __syncthreads();
    if (threadIdx.x < kDh) {
      float o = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += part[w * kDh + threadIdx.x];
      const int r = h * kDh + threadIdx.x;
      p.att[r] = __float2bfloat16(o * p.cross_vs[static_cast<size_t>(l) * p.D + r]);
    }
    __syncthreads();
  }
}

// Shared memory: act (bf16, max(D, F)) | xf (D) | lg (max(T, S + 1)) |
// part (kWarps x 64) | qs (64) | red (kWarps), floats after act.
__host__ __device__ inline size_t smem_bytes(int D, int F, int T, int S) {
  const int lg = round_up(T > S + 1 ? T : S + 1, 4);
  return 2 * static_cast<size_t>(round_up(D > F ? D : F, 8)) +
         4 * static_cast<size_t>(D + lg + kWarps * kDh + kDh + kWarps);
}

__global__ void __launch_bounds__(kThreads, 1) mega_step_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.D, F = p.F;
  bf16* act = reinterpret_cast<bf16*>(smem);
  float* xf = reinterpret_cast<float*>(smem + 2 * static_cast<size_t>(round_up(D > F ? D : F, 8)));
  float* lg = xf + D;
  float* part = lg + round_up(p.T > p.S + 1 ? p.T : p.S + 1, 4);
  float* qs = part + kWarps * kDh;
  float* red = qs + kDh;

  const int n_align = (p.A > 0 ? p.A : 1) * p.T;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n_align; i += gridDim.x * kThreads)
    p.align[i] = 0.0f;

  for (int l = 0; l < p.L; ++l) {
    const float* sm = p.smalls + static_cast<size_t>(l) * (20 * D + 2 * F);
    const float *ln1_g = sm, *ln1_b = sm + D, *qkv_s = sm + 2 * D, *qkv_b = sm + 5 * D;
    const float *o_s = sm + 8 * D, *o_b = sm + 9 * D, *lnc_g = sm + 10 * D, *lnc_b = sm + 11 * D;
    const float *cq_s = sm + 12 * D, *cq_b = sm + 13 * D, *co_s = sm + 14 * D, *co_b = sm + 15 * D;
    const float *ln2_g = sm + 16 * D, *ln2_b = sm + 17 * D, *fc1_s = sm + 18 * D;
    const float *fc1_b = fc1_s + F, *fc2_s = fc1_s + 2 * F, *fc2_b = fc2_s + D;
    const size_t dd = static_cast<size_t>(D) * D, df = static_cast<size_t>(D) * F;

    // 1. LN1 and the fused qkv; k and v also land in cache slot pos.
    layer_norm(p.x, ln1_g, ln1_b, D, act, xf, red);
    gemv(p.qkv_w + 3 * l * dd, 3 * D, D, act, [&](int r, float acc) {
      const bf16 y = __float2bfloat16(fmaf(acc, qkv_s[r], qkv_b[r]));
      p.qkv[r] = y;
      if (r >= D) {
        const int c = r >= 2 * D ? r - 2 * D : r - D;
        bf16* cache = r >= 2 * D ? p.self_v : p.self_k;
        cache[((static_cast<size_t>(l) * p.H + c / kDh) * p.S + p.pos) * kDh + c % kDh] = y;
      }
    });
    grid_sync(p.bar);
    // 2. Self-attention.
    self_attention(p, l, lg, qs, part, red);
    grid_sync(p.bar);
    // 3. Out-projection and residual.
    load_act(p.att, D, act);
    gemv(p.o_w + l * dd, D, D, act,
         [&](int r, float acc) { residual(p.x, r, fmaf(acc, o_s[r], o_b[r])); });
    grid_sync(p.bar);
    // 4. LN and the cross query, scaled for the int8 K.
    layer_norm(p.x, lnc_g, lnc_b, D, act, xf, red);
    gemv(p.cq_w + l * dd, D, D, act, [&](int r, float acc) {
      p.cq[r] = round_bf16(fmaf(acc, cq_s[r], cq_b[r])) * p.cross_ks[static_cast<size_t>(l) * D + r] *
                kScale;
    });
    grid_sync(p.bar);
    // 5. Cross-attention.
    cross_attention(p, l, lg, qs, part, red);
    grid_sync(p.bar);
    // 6. Cross out-projection and residual.
    load_act(p.att, D, act);
    gemv(p.co_w + l * dd, D, D, act,
         [&](int r, float acc) { residual(p.x, r, fmaf(acc, co_s[r], co_b[r])); });
    grid_sync(p.bar);
    // 7. LN2, fc1 and GELU.
    layer_norm(p.x, ln2_g, ln2_b, D, act, xf, red);
    gemv(p.fc1_w + l * df, F, D, act, [&](int r, float acc) {
      p.hid[r] = __float2bfloat16(gelu_tanh(round_bf16(fmaf(acc, fc1_s[r], fc1_b[r]))));
    });
    grid_sync(p.bar);
    // 8. fc2 and residual.
    load_act(p.hid, F, act);
    gemv(p.fc2_w + l * df, D, F, act,
         [&](int r, float acc) { residual(p.x, r, fmaf(acc, fc2_s[r], fc2_b[r])); });
    grid_sync(p.bar);
  }
  // Final LN and the tied-table logits.
  layer_norm(p.x, p.lnp, p.lnp + D, D, act, xf, red);
  gemv(p.emb_q, p.V, D, act, [&](int r, float acc) { p.logits[r] = acc * p.emb_s[r]; });
}

}  // namespace

// Pointers are device pointers of contiguous tensors (shapes in Args);
// `work` is bf16 scratch of 4 D + F elements followed by D floats. Needs
// D == 64 H, D and F multiples of 128, 0 <= pos < S. Returns the CUDA error
// of the launch (cudaErrorInvalidValue for shapes it does not take,
// cudaErrorCooperativeLaunchTooLarge if not one block fits an SM).
extern "C" int twt_mega_step(const void* qkv_w, const void* o_w, const void* cq_w,
                             const void* co_w, const void* fc1_w, const void* fc2_w,
                             const void* smalls, const void* lnp, const void* emb_q,
                             const void* emb_s, void* self_k, void* self_v, const void* cross_k,
                             const void* cross_v, const void* cross_ks, const void* cross_vs,
                             const void* heads, void* x, void* work, void* logits, void* align,
                             void* barrier, int L, int D, int F, int H, int V, int S, int T, int A,
                             int pos, int capture, int device, void* stream) {
  if (L < 1 || D != H * kDh || D % 128 || F % 128 || V < 1 || T < 1 || A < 0 || pos < 0 ||
      pos >= S)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);

  Args p;
  p.qkv_w = static_cast<const int8_t*>(qkv_w);
  p.o_w = static_cast<const int8_t*>(o_w);
  p.cq_w = static_cast<const int8_t*>(cq_w);
  p.co_w = static_cast<const int8_t*>(co_w);
  p.fc1_w = static_cast<const int8_t*>(fc1_w);
  p.fc2_w = static_cast<const int8_t*>(fc2_w);
  p.smalls = static_cast<const float*>(smalls);
  p.lnp = static_cast<const float*>(lnp);
  p.emb_q = static_cast<const int8_t*>(emb_q);
  p.emb_s = static_cast<const float*>(emb_s);
  p.self_k = static_cast<bf16*>(self_k);
  p.self_v = static_cast<bf16*>(self_v);
  p.cross_k = static_cast<const int8_t*>(cross_k);
  p.cross_v = static_cast<const int8_t*>(cross_v);
  p.cross_ks = static_cast<const float*>(cross_ks);
  p.cross_vs = static_cast<const float*>(cross_vs);
  p.heads = static_cast<const int*>(heads);
  p.x = static_cast<bf16*>(x);
  bf16* w = static_cast<bf16*>(work);
  p.qkv = w;
  p.att = w + 3 * D;
  p.hid = w + 4 * D;
  p.cq = reinterpret_cast<float*>(w + 4 * D + F);
  p.logits = static_cast<float*>(logits);
  p.align = static_cast<float*>(align);
  p.bar = static_cast<unsigned int*>(barrier);
  p.L = L; p.D = D; p.F = F; p.H = H; p.V = V; p.S = S; p.T = T; p.A = A;
  p.pos = pos; p.capture = capture;

  const size_t smem = smem_bytes(D, F, T, S);
  err = cudaFuncSetAttribute(mega_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mega_step_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // A fresh barrier for every launch, so that one launch that ended early
  // leaves no arrival count behind for the next.
  err = cudaMemsetAsync(barrier, 0, 2 * sizeof(unsigned int), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(mega_step_kernel), dim3(sms),
                                    dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
