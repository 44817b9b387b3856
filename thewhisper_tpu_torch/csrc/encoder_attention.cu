// Encoder self-attention (K2): non-causal softmax(q k^T / sqrt(dh)) v.
//
// Replaces the TPU flash attention of the encoder: the library kernel
// jax.experimental.pallas.ops.tpu.flash_attention that
// thewhisper_tpu/models/whisper.py::_flash_attention calls, and the repo's
// own thewhisper_tpu/ops/attention_pallas.py::encoder_flash_attention
// (same math, kept there as a negative result).
//
// Interface: q is (B, S_q, H, 64), k and v (B, S_k, H, 64), with any
// batch/sequence/head strides and a unit stride on the head dimension (the
// layout the projections produce, so no transpose or pad copy is made);
// both routes load them by TMA, which needs 16-byte-aligned base pointers
// and strides. The encoder's own attention has S_q = S_k = S; the
// sequence-parallel encoder gives a rank's S_q queries over the S_k keys
// gathered from every rank. Keys at or past valid_len are masked; S needs
// no tile multiple (1500 and 500 run as they are, the ragged tile is masked
// here instead of padded to 512 as on the TPU). The output is written in
// the input type, (B, S_q, H, 64) contiguous. Inside the kernels `S` is
// S_q: it bounds the query rows stored; the key loop reads only valid_len.
//
// Bound on the H100: arithmetic. 4 S^2 dh FLOPs per (batch, head) against
// 3 S dh elements in, so the work is the two products.
//
// bf16 (the encoder's type): the products run on the tensor cores, so the
// exponentials (one MUFU.EX2 a score, 16 a clock on an SM) cost about as
// much as the products; the design keeps both busy at once.
// One block per (batch x head, tile of 192 queries): a producer warpgroup
// and three consumer warpgroups of 64 query rows (setmaxnreg moves the
// producer's registers to the consumers). One producer thread loads the Q
// tile once and 128-key tiles of K and V into a three-stage ring by TMA
// (4-D tensor maps over the strided views, 128-byte swizzle), completed on
// mbarriers; rows past S arrive as zeros. A consumer computes S = Q K^T
// with wgmma m64n128k16 (both operands in shared memory, K-major) and
// O += P V with wgmma m64n64k16, P (rounded to bf16 in registers, the rule
// of the TPU kernel and of the plain version) as the register A operand and
// V from shared memory with the transpose bit (MN-major). It issues
// S(t + 1) and P V(t) together, runs the online softmax of tile t + 1
// (f32 on the accumulator fragments: row max over the quad by shuffles,
// scale and log2 e folded into one FFMA before ex2, keys >= valid_len set to
// -inf on the last tile only) while P V(t) runs, then rescales O. The three
// consumers issue their products in turn (named barriers), so one's
// softmax overlaps another's products. The epilogue divides by the row sum
// and stores bf16, rows >= S skipped.
//
// Residuals for the backward (csrc/encoder_attention_bwd.cu), the TPU
// library's save_residuals forward (_flash_attention_fwd, which keeps the
// row sum l and row max m): with a non-null `lse`, both routes also write
// the natural-log log-sum-exp of each row's scaled scores,
// lse = ln(sum_j exp(q . k_j / sqrt(dh))) over keys < valid_len, as f32
// (B, H, S), rows >= S skipped. The kernels keep scores in the log2
// domain, so the epilogue writes (m log2 + log2 l) ln 2 from the running
// max and sum it already holds; the backward multiplies by log2 e again.
// A null `lse` writes nothing else (the inference launch).
//
// f32 (the "XL32" size, f32 training and the f32 references, which need
// f32 results): TMA + mma.sync in 3xTF32 (tf32_common.cuh: each operand
// split into a TF32 high part and rest, three TF32 products summed in f32),
// so its ceiling is the TF32 tensor rate over three, not the CUDA cores'
// 67 TFLOP/s. One block per (batch x head, tile of 128 queries): eight MMA
// warps of 16 query rows and a producer warp, two blocks an SM. One
// producer thread loads the Q tile once and 64-key K and V tiles into a
// two-stage ring by TMA (f32 boxes of 32 floats, two a 64-float row,
// 128-byte swizzle), completed on mbarriers; rows past S arrive as zeros.
// A warp computes S = Q K^T (16 x 64, the Q fragments read from the
// resident tile each tile) and O += P V with P in f32, split like any
// other operand (no bf16 rounding: the f32 route's rule and the plain
// version's); the online softmax runs on the accumulator fragments in the
// log2 domain (row max over the quad by shuffles, keys >= valid_len at
// -inf on the last tile only, exp2f), as the bf16 route's does. The
// epilogue divides by the row sum and stores f32, rows >= S skipped.

#include <math.h>

#include "tc_common.cuh"
#include "tf32_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// f32: TMA + mma.sync, 3xTF32.

constexpr int kF32Warps = 8;                       // MMA warps of 16 query rows
constexpr int kF32BlockQ = 16 * kF32Warps;         // queries a block
constexpr int kF32Tile = 64;                       // keys a tile
constexpr int kF32Stages = 2;                      // K/V ring depth
constexpr int kF32Threads = 32 * (kF32Warps + 1);  // the MMA warps, the producer warp
constexpr int kF32QBytes = kF32BlockQ * kDh * 4;
constexpr int kF32TileBytes = kF32Tile * kDh * 4;  // one K or V tile
constexpr int kF32Smem = kF32QBytes + 2 * kF32Stages * kF32TileBytes + 1024 + 64;

__global__ void __launch_bounds__(kF32Threads, 2)
encoder_attention_f32_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map, int q_perm, int k_perm,
                             int v_perm, float* __restrict__ out, float* __restrict__ lse, int S,
                             int H, int valid_len, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: tiles start on that.
  // Offsetting smem_raw itself (not an integer address) keeps the tiles'
  // loads shared-memory loads with 32-bit addresses.
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_tile = base;
  uint8_t* k_tiles = base + kF32QBytes;
  uint8_t* v_tiles = k_tiles + kF32Stages * kF32TileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_tiles + kF32Stages * kF32TileBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kF32Stages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kF32BlockQ;
  const int n_tiles = (valid_len + kF32Tile - 1) / kF32Tile;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 32 * kF32Warps);  // every MMA thread releases it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kF32Warps) {
    // The producer warp: one thread issues every TMA load.
    if (lane == 0) {
      mbar_expect_tx(q_full, kF32QBytes);
      load_rows_f32<kF32BlockQ>(q_tile, &q_map, q_perm, q0, h, b, q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kF32Stages;
        if (t >= kF32Stages) mbar_wait(&empty[st], ((t / kF32Stages) - 1) & 1);
        mbar_expect_tx(&full[st], 2 * kF32TileBytes);
        load_rows_f32<kF32Tile>(k_tiles + st * kF32TileBytes, &k_map, k_perm, t * kF32Tile, h,
                                b, &full[st]);
        load_rows_f32<kF32Tile>(v_tiles + st * kF32TileBytes, &v_map, v_perm, t * kF32Tile, h,
                                b, &full[st]);
      }
    }
    return;
  }

  // MMA warp `warp` owns query rows q0 + 16 warp .. + 15; a thread holds
  // rows r0 and r0 + 8 of the block and, in n8 block j of an accumulator,
  // columns 8 j + 2 (lane % 4) and the one after.
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  float o[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
  float l[2] = {0.0f, 0.0f};            // this thread's part of the row sum

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kF32Stages;
    mbar_wait(&full[st], (t / kF32Stages) & 1);
    const uint8_t* k_st = k_tiles + st * kF32TileBytes;
    const uint8_t* v_st = v_tiles + st * kF32TileBytes;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      Frag qa = dims_frag<kF32BlockQ>(q_tile, r0, kk, lane % 4);
      mma_dims<kF32Tile>(s, qa, k_st, kk, lane);
    }

    // The online softmax: keys >= valid_len (only in the last tile) at
    // -inf, the row max over the quad, s replaced by exp2((s - m) scale
    // log2 e), the row sums and O rescaled by corr.
    const int key0 = t * kF32Tile;
    if (key0 + kF32Tile > valid_len) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * j + cq + (e & 1) >= valid_len) s[j][e] = -INFINITY;
    }
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tmax[e >> 1] = fmaxf(tmax[e >> 1], s[j][e]);
    float corr[2], m_log2[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
      tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
      // Every tile holds at least one valid key, so the new max is finite.
      const float m_new = fmaxf(m[i], tmax[i]);
      corr[i] = exp2f((m[i] - m_new) * scale_log2);
      m[i] = m_new;
      m_log2[i] = m_new * scale_log2;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], scale_log2, -m_log2[e >> 1]));
        l[e >> 1] += s[j][e];
        o[j][e] *= corr[e >> 1];
      }

#pragma unroll
    for (int j = 0; j < 8; ++j) mma_rows<kF32Tile>(o, acc_frag(s[j]), v_st, j, lane);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= S) continue;
    const float inv = 1.0f / l[i];
    // m holds raw scores: m scale log2 e is the row max in the log2 domain.
    if (lse != nullptr && cq == 0)
      lse[static_cast<long long>(bh) * S + row] = (log2f(l[i]) + m[i] * scale_log2) * kLn2;
    float* op = out + ((static_cast<long long>(b) * S + row) * H + h) * kDh;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(op + 8 * j + cq) =
          make_float2(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma.

constexpr int kConsumers = 3;                      // warpgroups of 64 query rows
constexpr int kTcBlockQ = 64 * kConsumers;
constexpr int kTcBlockK = kKeyTile;                // keys a tile
constexpr int kStages = 3;                         // K/V ring depth
constexpr int kTcThreads = 128 * (kConsumers + 1);  // producer, consumers
// Registers a thread after setmaxnreg: the producer gives its share to the
// consumers, which hold two score tiles, P and O (65,536 a block in all).
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;
static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536, "registers");
constexpr int kRowBytes = kDh * 2;                // one 128-byte row
constexpr int kTileBytes = kTcBlockK * kRowBytes;  // one K or V tile
constexpr int kQBytes = kTcBlockQ * kRowBytes;
constexpr int kTcSmem = kQBytes + 2 * kStages * kTileBytes + 1024 + 64;

// 2**x (ex2.approx: 2 ulp, 0 for -inf, 1 for 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one 64 x 128 score tile in place: keys >= valid_len
// (only in the last tile) set to -inf, the row max over the quad, s
// replaced by exp2((s - m) scale log2 e), the row sums rescaled by corr and
// increased. A thread holds rows r0 (accumulator index bit 1 clear) and
// r0 + 8; column 8 (j / 4) + cq + (j & 1) of the tile for index j.
__device__ __forceinline__ void online_softmax(float (&s)[64], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], int key0, int valid_len,
                                               int cq, float scale_log2) {
  if (key0 + kTcBlockK > valid_len) {
#pragma unroll
    for (int j = 0; j < 64; ++j)
      if (key0 + 8 * (j / 4) + cq + (j & 1) >= valid_len) s[j] = -INFINITY;
  }
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 64; ++j) tmax[(j >> 1) & 1] = fmaxf(tmax[(j >> 1) & 1], s[j]);
  float m_log2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
    tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
    // Every tile holds at least one valid key, so the new max is finite.
    const float m_new = fmaxf(m[i], tmax[i]);
    corr[i] = ex2((m[i] - m_new) * scale_log2);
    m[i] = m_new;
    m_log2[i] = m_new * scale_log2;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    // exp2(s scale log2 e - m scale log2 e): one FFMA and one MUFU.EX2.
    s[j] = ex2(fmaf(s[j], scale_log2, -m_log2[(j >> 1) & 1]));
    l[(j >> 1) & 1] += s[j];
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
encoder_attention_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map, int q_perm, int k_perm,
                            int v_perm, __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int S, int H, int valid_len,
                            float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: tiles start on that.
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_tile = base;
  uint8_t* k_tiles = base + kQBytes;
  uint8_t* v_tiles = k_tiles + kStages * kTileBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(v_tiles + kStages * kTileBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.x * kTcBlockQ;
  const int n_tiles = (valid_len + kTcBlockK - 1) / kTcBlockK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);  // every consumer thread releases it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // Producer warpgroup: one thread issues every TMA load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 0 && lane == 0) {
      mbar_expect_tx(q_full, kQBytes);
      load_rows(q_tile, &q_map, q_perm, q0, h, b, q_full);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&empty[st], ((t / kStages) - 1) & 1);
        mbar_expect_tx(&full[st], 2 * kTileBytes);
        load_rows(k_tiles + st * kTileBytes, &k_map, k_perm, t * kTcBlockK, h, b, &full[st]);
        load_rows(v_tiles + st * kTileBytes, &v_map, v_perm, t * kTcBlockK, h, b, &full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    // Consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63. In the
    // accumulator fragments a thread holds rows r0 and r0 + 8 and, for each
    // n8 column block c, columns 8 c + 2 (lane % 4) and the one after.
    const int wg = warp / 4 - 1;
    const int r0 = (warp % 4) * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const uint64_t q_desc = sw128_desc(q_tile + wg * 64 * 128);

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of the raw scores
    float l[2] = {0.0f, 0.0f};            // this thread's part of the row sum

    // Tile t + 1's softmax runs while tile t's P V is on the tensor cores:
    // S = Q K^T(t + 1) and O += P V(t) are issued back to back, the softmax
    // waits for the first, and O is rescaled and P replaced after the second.
    float s[64];
    uint32_t p[8][4];
    float corr[2];
    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    issue_qk(s, q_desc, sw128_desc(k_tiles));
    wgmma_wait_all();
    fence_regs(s);
    online_softmax(s, m, l, corr, 0, valid_len, cq, scale_log2);
    to_bf16(s, p);
    if (wg == kConsumers - 1) named_arrive(1);  // warpgroup 0 goes first
    for (int t = 0; t + 1 < n_tiles; ++t) {
      const int st = t % kStages;
      const int sn = (t + 1) % kStages;
      mbar_wait(&full[sn], ((t + 1) / kStages) & 1);
      named_sync(1 + wg);  // this warpgroup's turn on the tensor cores
      issue_qk(s, q_desc, sw128_desc(k_tiles + sn * kTileBytes));
      issue_pv(o, p, sw128_desc(v_tiles + st * kTileBytes));
      named_arrive(1 + (wg + 1) % kConsumers);
      wgmma_wait_one();  // S of tile t + 1 (groups complete in order)
      fence_regs(s);
      online_softmax(s, m, l, corr, (t + 1) * kTcBlockK, valid_len, cq, scale_log2);
      wgmma_wait_all();  // P V of tile t
      fence_regs(o);
      mbar_arrive(&empty[st]);
#pragma unroll
      for (int j = 0; j < 32; ++j) o[j] *= corr[(j >> 1) & 1];
      to_bf16(s, p);
    }
    if (wg == 0) named_sync(1);  // the last warpgroup's final arrive
    const int last = (n_tiles - 1) % kStages;
    issue_pv(o, p, sw128_desc(v_tiles + last * kTileBytes));
    wgmma_wait_all();
    fence_regs(o);

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wg * 64 + r0 + 8 * i;
      if (row >= S) continue;
      const float inv = 1.0f / l[i];
      // m holds raw scores: m scale log2 e is the row max in the log2 domain.
      if (lse != nullptr && (lane & 3) == 0)
        lse[static_cast<long long>(bh) * S + row] = (m[i] * scale_log2 + log2f(l[i])) * kLn2;
      __nv_bfloat16* op = out + (static_cast<long long>(b) * S + row) * H * kDh +
                          static_cast<long long>(h) * kDh;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(o[4 * c + 2 * i] * inv, o[4 * c + 2 * i + 1] * inv);
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * c + cq) = v;
      }
    }
  }
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Strides are in elements. q is (B, S_q, H, 64),
// k and v (B, S_k, H, 64): S_q query rows over S_k keys, 1 <= valid_len <= S_k
// (the encoder's own attention has S_q = S_k; the sequence-parallel encoder
// runs a rank's block of queries over the keys gathered from every rank,
// its pad rows past valid_len masked as any other key). The key loop and
// the K/V tensor maps take S_k, the grid, the Q map, the output and lse
// S_q. lse: null, or f32 (B, H, S_q) for the rows' log-sum-exp (see above).
// Both types need 16-byte-aligned base pointers and strides (TMA).
// Returns cudaGetLastError() (cudaErrorInvalidValue for dh != 64, a
// misaligned operand or a tensor map the driver refuses).
extern "C" int twt_encoder_attention(const void* q, const void* k, const void* v, void* out,
                                     void* lse, int dtype, int B, int S_q, int S_k, int H,
                                     int dh, long long q_sb, long long q_ss, long long q_sh,
                                     long long k_sb, long long k_ss, long long k_sh,
                                     long long v_sb, long long v_ss, long long v_sh,
                                     int valid_len, int device, void* stream) {
  if (dh != kDh || S_q < 1 || valid_len < 1 || valid_len > S_k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!aligned16(q, q_sb, q_ss, q_sh) || !aligned16(k, k_sb, k_ss, k_sh) ||
        !aligned16(v, v_sb, v_ss, v_sh))
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap maps[3];
    int perms[3];
    if (!make_map(&maps[0], &perms[0], q, B, S_q, H, q_sb, q_ss, q_sh, kTcBlockQ) ||
        !make_map(&maps[1], &perms[1], k, B, S_k, H, k_sb, k_ss, k_sh, kTcBlockK) ||
        !make_map(&maps[2], &perms[2], v, B, S_k, H, v_sb, v_ss, v_sh, kTcBlockK))
      return static_cast<int>(cudaErrorInvalidValue);
    // The shared-memory opt-in is per device; set it on every call (a
    // host-side attribute write, no device work).
    err = cudaFuncSetAttribute(encoder_attention_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S_q + kTcBlockQ - 1) / kTcBlockQ, B * H);
    // 64 ** -0.5 (exact) times log2(e): scores go straight to ex2.
    encoder_attention_tc_kernel<<<grid, kTcThreads, kTcSmem, st>>>(
        maps[0], maps[1], maps[2], perms[0], perms[1], perms[2],
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), S_q, H, valid_len,
        0.125f * kLog2e);
  } else {
    if (!aligned16(q, q_sb, q_ss, q_sh, 4) || !aligned16(k, k_sb, k_ss, k_sh, 4) ||
        !aligned16(v, v_sb, v_ss, v_sh, 4))
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap maps[3];
    int perms[3];
    if (!make_map(&maps[0], &perms[0], q, B, S_q, H, q_sb, q_ss, q_sh, kF32BlockQ, true) ||
        !make_map(&maps[1], &perms[1], k, B, S_k, H, k_sb, k_ss, k_sh, kF32Tile, true) ||
        !make_map(&maps[2], &perms[2], v, B, S_k, H, v_sb, v_ss, v_sh, kF32Tile, true))
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(encoder_attention_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S_q + kF32BlockQ - 1) / kF32BlockQ, B * H);
    encoder_attention_f32_kernel<<<grid, kF32Threads, kF32Smem, st>>>(
        maps[0], maps[1], maps[2], perms[0], perms[1], perms[2], static_cast<float*>(out),
        static_cast<float*>(lse), S_q, H, valid_len, 0.125f * kLog2e);
  }
  return static_cast<int>(cudaGetLastError());
}
