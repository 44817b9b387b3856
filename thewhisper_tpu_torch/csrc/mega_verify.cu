// K4: the speculative-verify window of an int8 "S" engine in one launch.
//
// Replaces thewhisper_tpu/ops/mega_step.py:1061, the pallas_call in `run`
// of _build_mega_verify_fn: the TPU megakernel that the JAX package's
// speculative loop calls for every verify round of a bs=1 bf16 engine with
// int8 weights and int8 cross K/V. It is K3 (mega_step.cu) over a window
// of W <= 16 tokens at cache slots pos .. pos + W - 1: for each of L
// layers, LN1 and the fused int8 qkv of every row (k and v also go to the
// cache slots), self-attention of row r over slots [0, pos + r] (the cache
// below the window plus the window's rows up to r), the int8
// out-projection, LN, the int8 cross query, cross-attention over the int8
// K/V with its scales folded, the int8 cross out-projection, LN2, int8
// fc1, tanh GELU and int8 fc2; then the final LN and the int8 tied-table
// logits of every row. No alignment is kept (decodes that need it take the
// plain verify).
//
// Numerics: K3's, row by row, at the same rounding points and in the same
// order of sums (LayerNorm in f32, int8 products summed in f32 then scaled
// and biased, projections and residual in bf16, f32 scores and softmax,
// tanh GELU, f32 logits), so that row r of a window equals K3's step at
// slot pos + r. ops/mega_step.py::mega_verify_plain is the same function
// in plain torch.
//
// Bound on the H100: at large-v3 (L 32, D 1280, F 5120, V 51866, T 1500)
// a round reads what a K3 step reads, about 0.93 GB (0.28 ms at 3.35 TB/s),
// and multiplies every int8 weight by W rows: 800 M weights, 2 W operations
// each, 1.6 W GFLOP (8 GFLOP at W = 5, 26 at W = 16) on the f32 CUDA cores,
// where each product also unpacks a bf16 activation. At W of a few the
// bytes bound it, at W = 16 the arithmetic; chip_smoke.py times both ends.
// Tensor cores (mma.sync or wgmma on int8 x bf16 tiles) are later work.
//
// Design (simple first): K3's launch (one cooperative 512-thread block on
// every SM, the grid barrier between phases). GEMV phases give each warp
// whole (out, in) rows; a warp reads its row once, 8 bytes a lane per
// load, converts the 8 weights once and applies them to all W activation
// rows, kept in W register accumulators. Those per-row loops are unrolled
// to a compile-time bound: the kernel is built for windows of up to 1, 2,
// 4, 8 and 16 rows and the launch takes the smallest that holds W (a build
// for 16 rows run at W = 1 spent 0.7 of its 3.2 ms on the empty row
// slots; H100 80GB HBM3, 700 W). The W activation rows sit in
// shared memory; fc2's input (W, F) does not fit beside the rest at
// W = 16 (160 KB), so its `in` axis is staged in column chunks of a
// multiple of 256, which keeps each lane's share and order of the sum.
// LayerNorm runs in every block over all W rows at once. Attention phases
// go over (head, row) pairs: H W items (100 at H 20, W 5) where K3 had H.
// The window's k/v land in the cache in the qkv phase; after the barrier
// row r reads slots [0, pos + r] from the cache, the window's slots from
// L2. Weights are streamed (ld.global.cs); the cross K/V of a head is read
// once for each row and stays in L2. Left for later: tensor cores, one
// pass over a head's cross K/V for all rows, L2 prefetch of the next
// phase's weights, fewer barriers.

#include "mega_common.cuh"

namespace {

constexpr int kMaxW = 16;
// Shared memory for the W activation rows; wider inputs are staged in
// column chunks that fit.
constexpr int kActBytes = 128 * 1024;

struct Args {
  const int8_t *qkv_w, *o_w, *cq_w, *co_w, *fc1_w, *fc2_w;  // (L, out, in)
  const float* smalls;                                      // (L, 20 D + 2 F)
  const float* lnp;                                         // (2, D)
  const int8_t* emb_q;                                      // (V, D)
  const float* emb_s;                                       // (V)
  bf16 *self_k, *self_v;                                    // (L, H, S, 64)
  const int8_t *cross_k, *cross_v;                          // (L, H, T, 64)
  const float *cross_ks, *cross_vs;                         // (L, D)
  bf16* x;                                                  // (W, D) residual
  bf16 *qkv, *att, *hid;                                    // (W, 3D | D | F)
  float* cq;                                                // (W, D)
  float* logits;                                            // (W, V)
  unsigned int* bar;                                        // (2)
  int L, D, F, H, V, S, T, W, pos, kc;
};

// act[w][i] = bf16(LayerNorm(x[w]) * g + b) for the n rows of x (n, D):
// every row summed as K3's layer_norm sums its one row (each thread's
// elements in order, then the warps', then the block's warps in order).
// `red` holds kMaxW x kWarps floats, `stats` 2 kMaxW.
__device__ void layer_norm_rows(const bf16* x, const float* g, const float* b, int D, int n,
                                bf16* act, float* red, float* stats) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Pass 0 sums x, pass 1 the squared deviations from the mean.
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
    for (int w = 0; w < n; ++w) {
      const bf16* row = x + static_cast<size_t>(w) * D;
      const float mean = pass ? stats[w] : 0.0f;
      float s = 0.0f;
      for (int i = threadIdx.x; i < D; i += kThreads) {
        const float v = load_shared_bf16(row + i);
        if (pass) {
          const float d = v - mean;
          s = fmaf(d, d, s);
        } else {
          s += v;
        }
      }
      s = warp_sum(s);
      if (lane == 0) red[w * kWarps + warp] = s;
    }
    __syncthreads();
    if (threadIdx.x < n) {
      float t = 0.0f;
#pragma unroll
      for (int j = 0; j < kWarps; ++j) t += red[threadIdx.x * kWarps + j];
      if (pass)
        stats[kMaxW + threadIdx.x] = rsqrtf(t / D + 1e-5f);
      else
        stats[threadIdx.x] = t / D;
    }
  }
  __syncthreads();
  for (int w = 0; w < n; ++w) {
    const bf16* row = x + static_cast<size_t>(w) * D;
    const float mean = stats[w], rstd = stats[kMaxW + w];
    for (int i = threadIdx.x; i < D; i += kThreads)
      act[static_cast<size_t>(w) * D + i] =
          __float2bfloat16((load_shared_bf16(row + i) - mean) * rstd * g[i] + b[i]);
  }
  __syncthreads();
}

// act[w][0 : k1 - k0] = src[w][k0 : k1] for the n rows of src (n, K),
// `width` apart in act (all of k0, k1, K, width multiples of 8).
__device__ void stage_rows(const bf16* src, int K, int k0, int k1, int n, bf16* act, int width) {
  const int per_row = (k1 - k0) / 8;
  __syncthreads();
  for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
    const int w = i / per_row, c = i % per_row;
    reinterpret_cast<uint4*>(act + static_cast<size_t>(w) * width)[c] =
        __ldcg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(w) * K + k0) + c);
  }
  __syncthreads();
}

// For every row r of the (R, K) int8 matrix Wt and every window row w < n,
// epi(r, w, sum_k act[w][k] Wt[r, k]) on lane 0 of the warp that owns r.
// Rows go round robin over every warp of the grid, the block's warps in
// step (a block-uniform loop, so that staging may synchronize). With src
// null, act already holds the n rows whole, K apart; else they are staged
// from src (n, K) in chunks of kc columns (kc % 256 == 0, so that a lane
// sums the same columns in the same order as without chunks). K % 8 == 0.
// NW >= n bounds the rows at compile time: the per-row loops are unrolled
// NW times, and each slot past n still costs its test.
template <int NW, typename Epi>
__device__ void gemm_rows(const int8_t* Wt, int R, int K, int n, bf16* act, const bf16* src,
                          int kc, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!src) kc = K;
  const int n_chunks = (K + kc - 1) / kc;
  bool staged = false;
  for (int base = blockIdx.x * kWarps; base < R; base += gridDim.x * kWarps) {
    const int r = base + warp;
    float acc[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) acc[w] = 0.0f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int k0 = ch * kc, k1 = min(K, k0 + kc);
      if (src && (n_chunks > 1 || !staged)) {
        stage_rows(src, K, k0, k1, n, act, kc);
        staged = true;
      }
      if (r >= R) continue;
      const uint2* row = reinterpret_cast<const uint2*>(Wt + static_cast<size_t>(r) * K + k0);
      for (int c = lane; c < (k1 - k0) / 8; c += 32) {
        const uint2 q = __ldcs(row + c);
        float wf[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          wf[i] = s8(q.x, i);
          wf[4 + i] = s8(q.y, i);
        }
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          if (w < n) {
            const uint4 a = reinterpret_cast<const uint4*>(act + static_cast<size_t>(w) * kc)[c];
            // The order of K3's dot8.
            float s = wf[0] * bf16_lo(a.x);
            s = fmaf(wf[1], bf16_hi(a.x), s);
            s = fmaf(wf[2], bf16_lo(a.y), s);
            s = fmaf(wf[3], bf16_hi(a.y), s);
            s = fmaf(wf[4], bf16_lo(a.z), s);
            s = fmaf(wf[5], bf16_hi(a.z), s);
            s = fmaf(wf[6], bf16_lo(a.w), s);
            acc[w] += fmaf(wf[7], bf16_hi(a.w), s);
          }
        }
      }
    }
    if (r < R) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (w < n) {
          const float sum = warp_sum(acc[w]);
          if (lane == 0) epi(r, w, sum);
        }
      }
    }
  }
}

// Self-attention of layer l over (head, row) items: row r attends slots
// [0, pos + r]. Slots below pos were written by earlier launches; the
// window's slots by this launch's qkv phase, so they are read from L2.
__device__ void self_attention(const Args& p, int l, float* lg, float* qs, float* part,
                               float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos = p.pos;
  for (int it = blockIdx.x; it < p.H * p.W; it += gridDim.x) {
    const int h = it % p.H, r = it / p.H, n = pos + r + 1;
    if (threadIdx.x < kDh)
      qs[threadIdx.x] = load_shared_bf16(p.qkv + static_cast<size_t>(r) * 3 * p.D + h * kDh +
                                         threadIdx.x) * kScale;
    __syncthreads();
    const size_t base = (static_cast<size_t>(l) * p.H + h) * p.S * kDh;
    const unsigned int* K = reinterpret_cast<const unsigned int*>(p.self_k + base);
    const unsigned int* V = reinterpret_cast<const unsigned int*>(p.self_v + base);
    const float q0 = qs[2 * lane], q1 = qs[2 * lane + 1];
    for (int s = warp; s < n; s += kWarps) {
      const int j = s * (kDh / 2) + lane;
      const unsigned int u = s < pos ? K[j] : __ldcg(K + j);
      const float d = warp_sum(fmaf(q0, bf16_lo(u), q1 * bf16_hi(u)));
      if (lane == 0) lg[s] = d;
    }
    __syncthreads();
    float m = -INFINITY;
    for (int s = threadIdx.x; s < n; s += kThreads) m = fmaxf(m, lg[s]);
    m = block_max(m, red);
    float z = 0.0f;
    for (int s = threadIdx.x; s < n; s += kThreads) {
      const float e = expf(lg[s] - m);
      lg[s] = e;
      z += e;
    }
    const float inv = 1.0f / block_sum(z, red);
    float a0 = 0.0f, a1 = 0.0f;
    for (int s = warp; s < n; s += kWarps) {
      const int j = s * (kDh / 2) + lane;
      const unsigned int u = s < pos ? V[j] : __ldcg(V + j);
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
      p.att[static_cast<size_t>(r) * p.D + h * kDh + threadIdx.x] = __float2bfloat16(o * inv);
    }
    __syncthreads();
  }
}

// Cross-attention of layer l over the int8 K/V, over (head, row) items. Row
// r's query in the cq scratch already carries the K scale and 1/sqrt(64).
__device__ void cross_attention(const Args& p, int l, float* lg, float* qs, float* part,
                                float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = p.T;
  for (int it = blockIdx.x; it < p.H * p.W; it += gridDim.x) {
    const int h = it % p.H, r = it / p.H;
    if (threadIdx.x < kDh)
      qs[threadIdx.x] = __ldcg(p.cq + static_cast<size_t>(r) * p.D + h * kDh + threadIdx.x);
    __syncthreads();
    const size_t base = (static_cast<size_t>(l) * p.H + h) * T * kDh;
    const int4* K = reinterpret_cast<const int4*>(p.cross_k + base);
    const unsigned int* V = reinterpret_cast<const unsigned int*>(p.cross_v + base);
    float m = -INFINITY;
    for (int t = threadIdx.x; t < T; t += kThreads) {
      float d = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int4 w = __ldg(K + t * 4 + c);
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
    for (int t = threadIdx.x; t < T; t += kThreads) lg[t] *= inv;
    __syncthreads();
    // Two rows a warp, four dims a lane.
    const int half = lane >> 4, c4 = (lane & 15) * 4;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int t = 2 * warp + half; t < T; t += 2 * kWarps) {
      const unsigned int u = __ldg(V + t * (kDh / 4) + (lane & 15));
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
      const int c = h * kDh + threadIdx.x;
      p.att[static_cast<size_t>(r) * p.D + c] =
          __float2bfloat16(o * p.cross_vs[static_cast<size_t>(l) * p.D + c]);
    }
    __syncthreads();
  }
}

// Shared memory: act (bf16, W x max(D, kc)) | lg (max(T, S)) | part
// (kWarps x 64) | qs (64) | red (kMaxW x kWarps) | stats (2 kMaxW), floats
// after act.
__host__ __device__ inline size_t act_bytes(int D, int W, int kc) {
  return 2 * static_cast<size_t>(W) * round_up(D > kc ? D : kc, 8);
}

__host__ __device__ inline size_t smem_bytes(int D, int W, int kc, int T, int S) {
  const int lg = round_up(T > S ? T : S, 4);
  return act_bytes(D, W, kc) +
         4 * static_cast<size_t>(lg + kWarps * kDh + kDh + kMaxW * kWarps + 2 * kMaxW);
}

template <int NW>
__global__ void __launch_bounds__(kThreads, 1) mega_verify_kernel(Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.D, F = p.F, W = p.W;
  bf16* act = reinterpret_cast<bf16*>(smem);
  float* lg = reinterpret_cast<float*>(smem + act_bytes(D, W, p.kc));
  float* part = lg + round_up(p.T > p.S ? p.T : p.S, 4);
  float* qs = part + kWarps * kDh;
  float* red = qs + kDh;
  float* stats = red + kMaxW * kWarps;

  for (int l = 0; l < p.L; ++l) {
    const float* sm = p.smalls + static_cast<size_t>(l) * (20 * D + 2 * F);
    const float *ln1_g = sm, *ln1_b = sm + D, *qkv_s = sm + 2 * D, *qkv_b = sm + 5 * D;
    const float *o_s = sm + 8 * D, *o_b = sm + 9 * D, *lnc_g = sm + 10 * D, *lnc_b = sm + 11 * D;
    const float *cq_s = sm + 12 * D, *cq_b = sm + 13 * D, *co_s = sm + 14 * D, *co_b = sm + 15 * D;
    const float *ln2_g = sm + 16 * D, *ln2_b = sm + 17 * D, *fc1_s = sm + 18 * D;
    const float *fc1_b = fc1_s + F, *fc2_s = fc1_s + 2 * F, *fc2_b = fc2_s + D;
    const size_t dd = static_cast<size_t>(D) * D, df = static_cast<size_t>(D) * F;

    // 1. LN1 and the fused qkv of every row; row w's k and v also land in
    //    cache slot pos + w.
    layer_norm_rows(p.x, ln1_g, ln1_b, D, W, act, red, stats);
    gemm_rows<NW>(p.qkv_w + 3 * l * dd, 3 * D, D, W, act, nullptr, 0, [&](int r, int w, float acc) {
      const bf16 y = __float2bfloat16(fmaf(acc, qkv_s[r], qkv_b[r]));
      p.qkv[static_cast<size_t>(w) * 3 * D + r] = y;
      if (r >= D) {
        const int c = r >= 2 * D ? r - 2 * D : r - D;
        bf16* cache = r >= 2 * D ? p.self_v : p.self_k;
        cache[((static_cast<size_t>(l) * p.H + c / kDh) * p.S + p.pos + w) * kDh + c % kDh] = y;
      }
    });
    grid_sync(p.bar);
    // 2. Self-attention.
    self_attention(p, l, lg, qs, part, red);
    grid_sync(p.bar);
    // 3. Out-projection and residual.
    gemm_rows<NW>(p.o_w + l * dd, D, D, W, act, p.att, D, [&](int r, int w, float acc) {
      residual(p.x + static_cast<size_t>(w) * D, r, fmaf(acc, o_s[r], o_b[r]));
    });
    grid_sync(p.bar);
    // 4. LN and the cross query, scaled for the int8 K.
    layer_norm_rows(p.x, lnc_g, lnc_b, D, W, act, red, stats);
    gemm_rows<NW>(p.cq_w + l * dd, D, D, W, act, nullptr, 0, [&](int r, int w, float acc) {
      p.cq[static_cast<size_t>(w) * D + r] = round_bf16(fmaf(acc, cq_s[r], cq_b[r])) *
                                             p.cross_ks[static_cast<size_t>(l) * D + r] * kScale;
    });
    grid_sync(p.bar);
    // 5. Cross-attention.
    cross_attention(p, l, lg, qs, part, red);
    grid_sync(p.bar);
    // 6. Cross out-projection and residual.
    gemm_rows<NW>(p.co_w + l * dd, D, D, W, act, p.att, D, [&](int r, int w, float acc) {
      residual(p.x + static_cast<size_t>(w) * D, r, fmaf(acc, co_s[r], co_b[r]));
    });
    grid_sync(p.bar);
    // 7. LN2, fc1 and GELU.
    layer_norm_rows(p.x, ln2_g, ln2_b, D, W, act, red, stats);
    gemm_rows<NW>(p.fc1_w + l * df, F, D, W, act, nullptr, 0, [&](int r, int w, float acc) {
      p.hid[static_cast<size_t>(w) * F + r] =
          __float2bfloat16(gelu_tanh(round_bf16(fmaf(acc, fc1_s[r], fc1_b[r]))));
    });
    grid_sync(p.bar);
    // 8. fc2 (its (W, F) input staged in column chunks) and residual.
    gemm_rows<NW>(p.fc2_w + l * df, D, F, W, act, p.hid, p.kc, [&](int r, int w, float acc) {
      residual(p.x + static_cast<size_t>(w) * D, r, fmaf(acc, fc2_s[r], fc2_b[r]));
    });
    grid_sync(p.bar);
  }
  // Final LN and the tied-table logits of every row.
  layer_norm_rows(p.x, p.lnp, p.lnp + D, D, W, act, red, stats);
  gemm_rows<NW>(p.emb_q, p.V, D, W, act, nullptr, 0, [&](int r, int w, float acc) {
    p.logits[static_cast<size_t>(w) * p.V + r] = acc * p.emb_s[r];
  });
}

// One cooperative launch of the kernel built for windows of up to NW rows:
// one block on every SM, with a fresh barrier (K3's, on the same stream).
template <int NW>
int launch(Args p, size_t smem, int device, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(mega_verify_kernel<NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mega_verify_kernel<NW>, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  err = cudaMemsetAsync(p.bar, 0, 2 * sizeof(unsigned int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(mega_verify_kernel<NW>),
                                    dim3(sms), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Pointers are device pointers of contiguous tensors (shapes in Args); `x`
// is the embedded window (W, D) bf16, updated in place; `work` is bf16
// scratch of W (4 D + F) elements followed by W D floats. Needs D == 64 H,
// D and F multiples of 128, 1 <= W <= 16, 0 <= pos, pos + W <= S. Returns
// the CUDA error of the launch (cudaErrorInvalidValue for shapes it does
// not take, cudaErrorCooperativeLaunchTooLarge if not one block fits an SM).
extern "C" int twt_mega_verify(const void* qkv_w, const void* o_w, const void* cq_w,
                               const void* co_w, const void* fc1_w, const void* fc2_w,
                               const void* smalls, const void* lnp, const void* emb_q,
                               const void* emb_s, void* self_k, void* self_v, const void* cross_k,
                               const void* cross_v, const void* cross_ks, const void* cross_vs,
                               void* x, void* work, void* logits, void* barrier, int L, int D,
                               int F, int H, int V, int S, int T, int W, int pos, int device,
                               void* stream) {
  if (L < 1 || D != H * kDh || D % 128 || F % 128 || V < 1 || T < 1 || W < 1 || W > kMaxW ||
      pos < 0 || pos + W > S)
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
  p.x = static_cast<bf16*>(x);
  bf16* w = static_cast<bf16*>(work);
  p.qkv = w;
  p.att = w + static_cast<size_t>(W) * 3 * D;
  p.hid = w + static_cast<size_t>(W) * 4 * D;
  p.cq = reinterpret_cast<float*>(w + static_cast<size_t>(W) * (4 * D + F));
  p.logits = static_cast<float*>(logits);
  p.bar = static_cast<unsigned int*>(barrier);
  p.L = L; p.D = D; p.F = F; p.H = H; p.V = V; p.S = S; p.T = T; p.W = W; p.pos = pos;
  // fc2's input columns a chunk: all of F if W rows of it fit kActBytes,
  // else the most that fit, a multiple of 256.
  p.kc = static_cast<size_t>(W) * F * 2 <= kActBytes ? F : kActBytes / (2 * W) / 256 * 256;

  // The smallest compiled window bound that holds W.
  const size_t smem = smem_bytes(D, W, p.kc, T, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (W <= 1) return launch<1>(p, smem, device, st);
  if (W <= 2) return launch<2>(p, smem, device, st);
  if (W <= 4) return launch<4>(p, smem, device, st);
  if (W <= 8) return launch<8>(p, smem, device, st);
  return launch<16>(p, smem, device, st);
}
