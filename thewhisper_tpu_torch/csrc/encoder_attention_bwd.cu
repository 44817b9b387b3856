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
// holds dQ, so neither needs atomics or an S_q x S_k scratch.
//
// Inputs: q and dO as (B, S_q, H, 64) views, k and v as (B, S_k, H, 64)
// views (any batch, sequence and head strides, unit stride on the head
// dim), f32 or bf16; lse, f32 (B, H, S_q), the natural-log log-sum-exp of
// each row's scaled scores that K2 writes with its output
// (csrc/encoder_attention.cu); di = rowsum(O * dO), f32 (B, H, S_q), one
// torch reduction in the wrapper as in the library (plain JAX there). The
// encoder's own attention has S_q = S_k; the sequence-parallel encoder's
// backward gives a rank's S_q queries over the S_k keys gathered from
// every rank. Both kernels recompute
// P = exp(s / sqrt(dh) - lse) = exp2(s scale log2 e - lse log2 e) and
// dS = P (dO v^T - di). Keys >= valid_len (<= S_k) are masked: their P is
// 0, and their dK and dV rows are written as zeros. Every query row < S_q
// takes part. Gradients are written contiguous in the operand type, dK and
// dV (B, S_k, H, 64), dQ (B, S_q, H, 64); sums are f32. In bf16, P and dS are rounded to bf16 before their
// products (dV = P^T dO, dK = dS^T q, dQ = dS k), the rule the forward
// keeps for P and the library keeps for both; dS is computed from the
// f32 P.
//
// Bound on the H100: arithmetic, 14 S_q S_k dh FLOPs per (batch, head)
// (the dK/dV kernel 8: the scores, dO v^T, P^T dO and dS^T q; the dQ
// kernel 6: the scores, dO v^T and dS k) against 2 (S_q + S_k) dh elements
// in.
//
// bf16 (the encoder's training type): TMA + wgmma, every product on the
// tensor cores. One kernel template serves both sides: a block holds 128
// rows of one side resident (keys with their v rows for dK/dV, queries
// with their dO rows for dQ) and streams 64-row tiles of the other side
// (q and dO, or k and v) through a four-stage ring. A producer warpgroup
// (one thread issues the TMA loads: 4-D tensor maps over the strided views,
// 128-byte swizzle, rows past each side's count read as zeros) and two consumer warpgroups
// of 64 resident rows, setmaxnreg moving the producer's registers to them.
// For each streamed tile a consumer computes, with 64 x 64 tiles on both
// sides so that its four f32 accumulators take 128 registers:
//   dK/dV: S^T = K Q^T and dP^T = V dO^T (m64n64k16, both operands in
//          shared memory, K-major), P^T = exp2(S^T scale log2 e - lse
//          log2 e) on the accumulator fragments, dV += bf16(P^T) dO, then
//          dS^T = P^T (dP^T - di) and dK += bf16(dS^T) Q (m64n64k16 with
//          the fragment as the register A operand and the same Q or dO
//          tile read MN-major through the transpose bit);
//   dQ:    S = Q K^T and dP = dO V^T, P, dS = P (dP - di), dQ += bf16(dS) K.
// Products are issued together where they do not depend on each other
// (S and dP; dV and the dS math), and each consumer waits for its own.
// For dK/dV the producer warp's lanes also write each tile's 64 columns of
// lse log2 e and di into its stage (plain loads from the (B, H, S_q) rows: a
// bulk copy would need S_q * 4 % 16 == 0) and arrive on the stage's barrier,
// in place of 32 global loads a consumer thread a tile, which held the
// kernel back more than any of its products. Masks: queries >= S_q in the last query tile of
// dK/dV arrive as zero rows of q and dO but have no lse or di, so their lse
// is taken as +inf (P = 0) and their di as 0, and nothing past S_q is
// read; keys >= valid_len get P = 0 (dK/dV: by row; dQ: the columns of its
// last key tile, whose rows hold real data); a dK/dV block whose keys are
// all >= valid_len only writes zeros; resident rows past their side's
// count (S_k for dK/dV, S_q for dQ) are not written. dK and
// dQ are scaled by 1 / sqrt(dh) at the end.
//
// f32: TMA + mma.sync in 3xTF32 (tf32_common.cuh: each operand split into a
// TF32 high part and rest, three TF32 products summed in f32, so its
// ceiling is the TF32 tensor rate over three), the bf16 route's plan with
// mma.sync in place of wgmma (whose TF32 form takes shared-memory operands
// K-major only, where dV's dO, dK's q and dQ's k are read MN-major). One
// kernel template serves both kernels, as in bf16: a block holds 128
// resident rows in eight MMA warps of 16 (k and v rows for dK/dV, q and dO
// rows for dQ, loaded once) and a producer warp streams 64-row tiles of the
// other side (q and dO, or k and v) through a three-stage ring by TMA (f32
// boxes of 32 floats, 128-byte swizzle, rows past each side's count as
// zeros). For dK/dV it
// also writes each tile's lse log2 e and di into its stage, as the bf16
// route's does; a dQ thread loads its two queries' once. For each tile a
// warp computes
//   dK/dV: S^T = K Q^T and dP^T = V dO^T (16 x 64 each), P^T = exp2(S^T
//          scale log2 e - lse log2 e) in f32, dV += P^T dO, dS^T = P^T
//          (dP^T - di) and dK += dS^T Q;
//   dQ:    S = Q K^T and dP = dO V^T, P, dS = P (dP - di) and dQ += dS K,
//          against the same K tile read by rows;
// P and dS split like any other operand. The bf16 route's masks: keys >=
// valid_len get P = 0 (dK/dV by row, a block of them only writing zeros;
// dQ by column in its last key tile), queries past S_q take lse = +inf
// and di = 0, and nothing past S_q is read.

#include <math.h>

#include "tc_common.cuh"
#include "tf32_common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// f32: TMA + mma.sync, 3xTF32.

constexpr int kF32Warps = 8;                        // MMA warps of 16 resident rows
constexpr int kF32Rows = 16 * kF32Warps;            // resident rows a block
constexpr int kF32Tile = 64;                        // rows a streamed tile
constexpr int kF32Stages = 3;                       // ring depth (streamed tile pairs)
constexpr int kF32Threads = 32 * (kF32Warps + 1);   // the MMA warps, the producer warp
constexpr int kF32ResBytes = kF32Rows * kDh * 4;    // one resident operand
constexpr int kF32TileBytes = kF32Tile * kDh * 4;   // one streamed tile
constexpr int kF32ColBytes = 2 * kF32Tile * 4;      // a dK/dV tile's lse log2 e and di
constexpr int kF32Smem =
    2 * kF32ResBytes + kF32Stages * (2 * kF32TileBytes + kF32ColBytes) + 1024 + 128;

// kKeys: the dK/dV kernel (resident K and V, streamed Q and dO tiles, out0 =
// dK, out1 = dV); else the dQ kernel (resident Q and dO, streamed K and V
// tiles, out0 = dQ). out0 is scaled by out0_scale (1 / sqrt(dh)) at the end.
template <bool kKeys>
__global__ void __launch_bounds__(kF32Threads, 1)
attention_bwd_f32_kernel(const __grid_constant__ CUtensorMap res0_map,
                         const __grid_constant__ CUtensorMap res1_map,
                         const __grid_constant__ CUtensorMap str0_map,
                         const __grid_constant__ CUtensorMap str1_map, int res0_perm,
                         int res1_perm, int str0_perm, int str1_perm,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         float* __restrict__ out0, float* __restrict__ out1, int Sq, int Sk,
                         int H, int valid_len, float scale_log2, float out0_scale) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: tiles start on that.
  // Offsetting smem_raw itself (not an integer address) keeps the tiles'
  // loads shared-memory loads with 32-bit addresses.
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* res0 = base;                               // K (dK/dV) or Q (dQ), 128 rows
  uint8_t* res1 = res0 + kF32ResBytes;                // V or dO
  uint8_t* str0 = res1 + kF32ResBytes;                // Q or K tiles, one a stage
  uint8_t* str1 = str0 + kF32Stages * kF32TileBytes;  // dO or V tiles
  // dK/dV: each stage's 64 query columns, lse log2 e then di.
  float* cols = reinterpret_cast<float*>(str1 + kF32Stages * kF32TileBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(cols + kF32Stages * 2 * kF32Tile);
  uint64_t* res_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kF32Stages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = blockIdx.x * kF32Rows;  // first resident row (key or query)
  const int S = kKeys ? Sk : Sq;            // resident rows of the side
  const float* lse_bh = lse + static_cast<long long>(bh) * Sq;
  const float* di_bh = di + static_cast<long long>(bh) * Sq;

  if (kKeys && row0 >= valid_len) {
    // Every key of the block is masked: dK and dV rows of zeros.
    const int rows = min(kF32Rows, Sk - row0);
    for (int idx = threadIdx.x; idx < rows * (kDh / 4); idx += kF32Threads) {
      const long long off =
          ((static_cast<long long>(b) * Sk + row0 + idx / 16) * H + h) * kDh + 4 * (idx % 16);
      *reinterpret_cast<float4*>(out0 + off) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(out1 + off) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    return;
  }
  // Streamed tiles: every query for dK/dV, keys < valid_len for dQ.
  const int n_tiles = ((kKeys ? Sq : valid_len) + kF32Tile - 1) / kF32Tile;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(&full[s], kKeys ? 33 : 1);     // the TMA's bytes; dK/dV: 32 lanes' columns
      mbar_init(&empty[s], 32 * kF32Warps);    // every MMA thread releases it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kF32Warps) {
    // The producer warp: one thread issues every TMA load; for dK/dV all
    // 32 lanes write the tile's query columns, lse log2 e and di, and
    // arrive. Queries past S_q have neither: their lse is +inf (P = 0) and
    // their di 0, and nothing past S_q is read.
    if (lane == 0) {
      mbar_expect_tx(res_full, 2 * kF32ResBytes);
      load_rows_f32<kF32Rows>(res0, &res0_map, res0_perm, row0, h, b, res_full);
      load_rows_f32<kF32Rows>(res1, &res1_map, res1_perm, row0, h, b, res_full);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kF32Stages;
      if (t >= kF32Stages) mbar_wait(&empty[st], ((t / kF32Stages) - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&full[st], 2 * kF32TileBytes);
        load_rows_f32<kF32Tile>(str0 + st * kF32TileBytes, &str0_map, str0_perm, t * kF32Tile,
                                h, b, &full[st]);
        load_rows_f32<kF32Tile>(str1 + st * kF32TileBytes, &str1_map, str1_perm, t * kF32Tile,
                                h, b, &full[st]);
      }
      if (kKeys) {
        float* cl = cols + st * 2 * kF32Tile;
        for (int c = lane; c < kF32Tile; c += 32) {
          const int qi = t * kF32Tile + c;
          cl[c] = qi < Sq ? lse_bh[qi] * kLog2e : INFINITY;
          cl[kF32Tile + c] = qi < Sq ? di_bh[qi] : 0.0f;
        }
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // MMA warp `warp` owns resident rows row0 + 16 warp .. + 15; a thread
  // holds rows r0 and r0 + 8 of the block and, in n8 block j of an
  // accumulator, streamed columns 8 j + 2 (lane % 4) and the one after.
  const int r0 = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  // dK/dV: whether each of the thread's keys is < valid_len. dQ: each of
  // its queries' lse log2 e and di (+inf and 0 past S_q, where nothing is read).
  const bool key_live[2] = {row0 + r0 < valid_len, row0 + r0 + 8 < valid_len};
  float row_lse[2], row_di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + r0 + 8 * i;
    row_lse[i] = (!kKeys && qi < Sq) ? lse_bh[qi] * kLog2e : INFINITY;
    row_di[i] = (!kKeys && qi < Sq) ? di_bh[qi] : 0.0f;
  }
  float acc0[8][4], acc1[8][4];  // dK and dV, or dQ
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[j][e] = acc1[j][e] = 0.0f;

  mbar_wait(res_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kF32Stages;
    mbar_wait(&full[st], (t / kF32Stages) & 1);
    const uint8_t* str0_st = str0 + st * kF32TileBytes;
    const uint8_t* str1_st = str1 + st * kF32TileBytes;
    const float* cl = cols + st * 2 * kF32Tile;  // dK/dV: lse log2 e, then di
    // dQ: keys >= valid_len in the last key tile hold real rows; P = 0.
    const int key_end = valid_len - t * kF32Tile;

    float s[8][4], dp[8][4];  // S^T and dP^T (keys x queries), or S and dP
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      mma_dims<kF32Tile>(s, dims_frag<kF32Rows>(res0, r0, kk, lane % 4), str0_st, kk, lane);
      mma_dims<kF32Tile>(dp, dims_frag<kF32Rows>(res1, r0, kk, lane % 4), str1_st, kk, lane);
    }
    // P in f32 and dS = P (dP - di), by streamed column.
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + cq + (e & 1);
        const bool live = kKeys ? key_live[e >> 1] : col < key_end;
        const float p = live ? exp2f(fmaf(s[j][e], scale_log2,
                                          kKeys ? -cl[col] : -row_lse[e >> 1]))
                             : 0.0f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - (kKeys ? cl[kF32Tile + col] : row_di[e >> 1]));
      }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kKeys) {
        Frag pa = acc_frag(s[j]);
        mma_rows<kF32Tile>(acc1, pa, str1_st, j, lane);  // dV += P^T dO
      }
      Frag da = acc_frag(dp[j]);
      mma_rows<kF32Tile>(acc0, da, str0_st, j, lane);  // dK += dS^T Q, or dQ += dS K
    }
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r0 + 8 * i;
    if (row >= S) continue;
    const long long off = ((static_cast<long long>(b) * S + row) * H + h) * kDh;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(out0 + off + 8 * j + cq) =
          make_float2(acc0[j][2 * i] * out0_scale, acc0[j][2 * i + 1] * out0_scale);
      if (kKeys)
        *reinterpret_cast<float2*>(out1 + off + 8 * j + cq) =
            make_float2(acc1[j][2 * i], acc1[j][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma.

constexpr int kTcRows = 64;                         // rows of a consumer and of a streamed tile
constexpr int kTcConsumers = 2;                     // warpgroups of 64 resident rows
constexpr int kTcBlock = kTcRows * kTcConsumers;    // resident rows a block
constexpr int kTcStages = 4;                        // ring depth (streamed tile pairs)
constexpr int kTcThreads = 128 * (kTcConsumers + 1);  // producer, consumers
// Registers a thread after setmaxnreg: the consumers hold four 64 x 64 f32
// accumulators (128) and two bf16 fragments (32).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * (kProducerRegs + kTcConsumers * kConsumerRegs) <= 65536, "registers");
constexpr int kTcTileBytes = kTcRows * kDh * 2;     // one 64-row tile, 8 KB
constexpr int kTcResBytes = kTcBlock * kDh * 2;     // one resident operand, 16 KB
constexpr int kTcColBytes = 2 * kTcRows * 4;        // a dK/dV tile's lse log2 e and di
constexpr int kTcSmem =
    2 * kTcResBytes + kTcStages * (2 * kTcTileBytes + kTcColBytes) + 1024 + 128;

// 2**x (ex2.approx: 2 ulp, 0 for -inf).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A thread's place in a 64 x 64 accumulator: index j holds row r0 + 8
// frag_row(j) and column frag_col(j, cq), cq = 2 (lane % 4).
__device__ __forceinline__ int frag_row(int j) { return (j >> 1) & 1; }
__device__ __forceinline__ int frag_col(int j, int cq) { return 8 * (j / 4) + cq + (j & 1); }

// Rows row and row + 8 of one 64 x 64 accumulator, times `scale`, as bf16
// into a contiguous (B, S, H, 64) gradient; rows >= S are skipped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[32], float scale,
                                           int row, int cq, int b, int h, int S, int H) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row + 8 * i >= S) continue;
    __nv_bfloat16* op = out + ((static_cast<long long>(b) * S + row + 8 * i) * H + h) * kDh;
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * c + cq) =
          __floats2bfloat162_rn(acc[4 * c + 2 * i] * scale, acc[4 * c + 2 * i + 1] * scale);
  }
}

// kKeys: the dK/dV kernel (resident K and V, streamed Q and dO tiles,
// out0 = dK, out1 = dV); else the dQ kernel (resident Q and dO, streamed K
// and V tiles, out0 = dQ). out0 is scaled by out0_scale (1 / sqrt(dh)).
template <bool kKeys>
__global__ void __launch_bounds__(kTcThreads, 1)
attention_bwd_tc_kernel(const __grid_constant__ CUtensorMap res0_map,
                        const __grid_constant__ CUtensorMap res1_map,
                        const __grid_constant__ CUtensorMap str0_map,
                        const __grid_constant__ CUtensorMap str1_map, int res0_perm,
                        int res1_perm, int str0_perm, int str1_perm,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        __nv_bfloat16* __restrict__ out0, __nv_bfloat16* __restrict__ out1,
                        int Sq, int Sk, int H, int valid_len, float scale_log2,
                        float out0_scale) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: tiles start on that.
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* res0 = base;                        // K (dK/dV) or Q (dQ), 128 rows
  uint8_t* res1 = res0 + kTcResBytes;          // V or dO
  uint8_t* str0 = res1 + kTcResBytes;          // Q or K tiles, one a stage
  uint8_t* str1 = str0 + kTcStages * kTcTileBytes;  // dO or V tiles
  // dK/dV: each stage's 64 query columns, lse log2 e then di.
  float* cols = reinterpret_cast<float*>(str1 + kTcStages * kTcTileBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(cols + kTcStages * 2 * kTcRows);
  uint64_t* res_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kTcStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int row0 = blockIdx.x * kTcBlock;  // first resident row (key or query)
  const int S = kKeys ? Sk : Sq;            // resident rows of the side
  const float* lse_bh = lse + static_cast<long long>(bh) * Sq;
  const float* di_bh = di + static_cast<long long>(bh) * Sq;

  if (kKeys && row0 >= valid_len) {
    // Every key of the block is masked: dK and dV rows of zeros.
    const int rows = min(kTcBlock, Sk - row0);
    for (int idx = threadIdx.x; idx < rows * (kDh / 8); idx += kTcThreads) {
      const long long off =
          ((static_cast<long long>(b) * Sk + row0 + idx / 8) * H + h) * kDh + 8 * (idx % 8);
      *reinterpret_cast<uint4*>(out0 + off) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(out1 + off) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  // Streamed tiles: every query for dK/dV, keys < valid_len for dQ.
  const int n_tiles = ((kKeys ? Sq : valid_len) + kTcRows - 1) / kTcRows;

  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], kKeys ? 33 : 1);  // the TMA's bytes; dK/dV: 32 lanes' columns
      mbar_init(&empty[s], 128 * kTcConsumers);  // every consumer thread releases it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // Producer warpgroup: its first warp fills the ring. One thread issues
    // every TMA load; for dK/dV all 32 lanes also write the tile's query
    // columns, lse log2 e and di, and arrive. Queries past S_q have
    // neither: their lse is +inf (P = 0) and their di 0, and nothing past
    // S_q is read.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 0) {
      if (lane == 0) {
        mbar_expect_tx(res_full, 2 * kTcResBytes);
        load_rows(res0, &res0_map, res0_perm, row0, h, b, res_full);
        load_rows(res1, &res1_map, res1_perm, row0, h, b, res_full);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kTcStages;
        if (t >= kTcStages) mbar_wait(&empty[st], ((t / kTcStages) - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(&full[st], 2 * kTcTileBytes);
          load_rows(str0 + st * kTcTileBytes, &str0_map, str0_perm, t * kTcRows, h, b, &full[st]);
          load_rows(str1 + st * kTcTileBytes, &str1_map, str1_perm, t * kTcRows, h, b, &full[st]);
        }
        if (kKeys) {
          float* cl = cols + st * 2 * kTcRows;
          for (int c = lane; c < kTcRows; c += 32) {
            const int q = t * kTcRows + c;
            cl[c] = q < Sq ? lse_bh[q] * kLog2e : INFINITY;
            cl[kTcRows + c] = q < Sq ? di_bh[q] : 0.0f;
          }
          mbar_arrive(&full[st]);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    // Consumer warpgroup wg owns resident rows row0 + 64 wg .. + 63; a
    // thread holds rows `row` and row + 8 of its accumulators.
    const int wg = warp / 4 - 1;
    const int row = row0 + wg * kTcRows + (warp % 4) * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
    const uint64_t res0_desc = sw128_desc(res0 + wg * kTcTileBytes);
    const uint64_t res1_desc = sw128_desc(res1 + wg * kTcTileBytes);

    // dK/dV: whether each of the thread's keys is < valid_len. dQ: each
    // of its queries' lse log2 e and di (+inf and 0 past S_q).
    bool key_live[2];
    float row_lse[2], row_di[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      key_live[i] = r < valid_len;
      row_lse[i] = (!kKeys && r < Sq) ? lse_bh[r] * kLog2e : INFINITY;
      row_di[i] = (!kKeys && r < Sq) ? di_bh[r] : 0.0f;
    }

    float acc0[32], acc1[32];  // dK and dV, or dQ
#pragma unroll
    for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.0f;

    mbar_wait(res_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kTcStages;
      mbar_wait(&full[st], (t / kTcStages) & 1);
      const uint64_t str0_desc = sw128_desc(str0 + st * kTcTileBytes);
      const uint64_t str1_desc = sw128_desc(str1 + st * kTcTileBytes);
      float s[32], dp[32];
      issue_ss64(s, res0_desc, str0_desc);   // S^T = K Q^T, or S = Q K^T
      issue_ss64(dp, res1_desc, str1_desc);  // dP^T = V dO^T, or dP = dO V^T

      const float* cl = cols + st * 2 * kTcRows;  // dK/dV: lse log2 e, then di
      // dQ: keys >= valid_len in the last key tile hold real rows; P = 0.
      const int key_end = valid_len - t * kTcRows;

      wgmma_wait_one();  // the scores
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int i = frag_row(j);
        if (kKeys)
          s[j] = key_live[i] ? ex2(fmaf(s[j], scale_log2, -cl[frag_col(j, cq)])) : 0.0f;
        else
          s[j] = frag_col(j, cq) < key_end ? ex2(fmaf(s[j], scale_log2, -row_lse[i])) : 0.0f;
      }
      uint32_t pf[4][4];
      if (kKeys) {
        to_bf16(s, pf);
        issue_pv(acc1, pf, str1_desc);  // dV += bf16(P^T) dO, dO MN-major
        wgmma_wait_one();               // dP (groups complete in order)
      } else {
        wgmma_wait_all();
      }
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        dp[j] = s[j] * (dp[j] - (kKeys ? cl[kTcRows + frag_col(j, cq)] : row_di[frag_row(j)]));
      uint32_t df[4][4];
      to_bf16(dp, df);
      issue_pv(acc0, df, str0_desc);  // dK += bf16(dS^T) Q, or dQ += bf16(dS) K
      wgmma_wait_all();
      fence_regs(acc0);
      fence_regs(acc1);
      if (kKeys) fence_frag(pf);
      fence_frag(df);
      mbar_arrive(&empty[st]);
    }

    store_rows(out0, acc0, out0_scale, row, cq, b, h, S, H);
    if (kKeys) store_rows(out1, acc1, 1.0f, row, cq, b, h, S, H);
  }
}

// The four tensor maps of a launch (res0, res1, str0, str1), over rows[i]
// rows each (S_k for k and v, S_q for q and dO): bf16 (resident boxes of
// kTcBlock rows, streamed ones of kTcRows) or, with `f32`, the f32 kernels'
// (kF32Rows and kF32Tile rows); false if one is misaligned or refused.
struct TcMaps {
  CUtensorMap map[4];
  int perm[4];
};

bool make_tc_maps(TcMaps* m, const void* const ptr[4], const long long (*st)[3], int B,
                  const int rows[4], int H, bool f32) {
  for (int i = 0; i < 4; ++i)
    if (!aligned16(ptr[i], st[i][0], st[i][1], st[i][2], f32 ? 4 : 2) ||
        !make_map(&m->map[i], &m->perm[i], ptr[i], B, rows[i], H, st[i][0], st[i][1], st[i][2],
                  f32 ? (i < 2 ? kF32Rows : kF32Tile) : (i < 2 ? kTcBlock : kTcRows), f32))
      return false;
  return true;
}

template <bool kKeys>
int launch_tc(const TcMaps& m, const float* lse, const float* di, void* out0, void* out1,
              int B, int Sq, int Sk, int H, int valid_len, float out0_scale, cudaStream_t st) {
  // The shared-memory opt-in is per device; set it on every call (a
  // host-side attribute write, no device work).
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_tc_kernel<kKeys>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Blocks over the resident side: keys for dK/dV, queries for dQ.
  const dim3 grid(((kKeys ? Sk : Sq) + kTcBlock - 1) / kTcBlock, B * H);
  // 64 ** -0.5 (exact) times log2(e): scores go straight to ex2.
  attention_bwd_tc_kernel<kKeys><<<grid, kTcThreads, kTcSmem, st>>>(
      m.map[0], m.map[1], m.map[2], m.map[3], m.perm[0], m.perm[1], m.perm[2], m.perm[3], lse,
      di, static_cast<__nv_bfloat16*>(out0), static_cast<__nv_bfloat16*>(out1), Sq, Sk, H,
      valid_len, 0.125f * kLog2e, out0_scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kKeys>
int launch_f32(const TcMaps& m, const float* lse, const float* di, void* out0, void* out1,
               int B, int Sq, int Sk, int H, int valid_len, float out0_scale, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_f32_kernel<kKeys>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((kKeys ? Sk : Sq) + kF32Rows - 1) / kF32Rows, B * H);
  // 64 ** -0.5 (exact) times log2(e): scores go straight to exp2.
  attention_bwd_f32_kernel<kKeys><<<grid, kF32Threads, kF32Smem, st>>>(
      m.map[0], m.map[1], m.map[2], m.map[3], m.perm[0], m.perm[1], m.perm[2], m.perm[3], lse,
      di, static_cast<float*>(out0), static_cast<float*>(out1), Sq, Sk, H, valid_len,
      0.125f * kLog2e, out0_scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_args(int dtype, int B, int Sq, int Sk, int H, int dh, int valid_len) {
  return dh != kDh || (dtype != 0 && dtype != 1) || B < 1 || Sq < 1 || Sk < 1 || H < 1 ||
         B * H > 65535 || valid_len < 1 || valid_len > Sk;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Strides are in elements; q and dout are
// (B, S_q, H, 64), k and v (B, S_k, H, 64); dk and dv are contiguous
// (B, S_k, H, 64), dq (B, S_q, H, 64), of the operand type; lse and di f32
// (B, H, S_q). 1 <= valid_len <= S_k. Both kernels, in both types, need 16-byte-aligned
// base pointers and strides of q, k, v and dout (TMA). Returns
// cudaGetLastError() (cudaErrorInvalidValue for dh != 64, an argument out
// of range, a misaligned operand or a tensor map cuTensorMapEncodeTiled
// refuses).
extern "C" int twt_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* di,
                                     void* dk, void* dv, int dtype, int B, int S_q, int S_k,
                                     int H, int dh, long long q_sb, long long q_ss,
                                     long long q_sh, long long k_sb, long long k_ss,
                                     long long k_sh, long long v_sb, long long v_ss,
                                     long long v_sh, long long do_sb, long long do_ss,
                                     long long do_sh, int valid_len, int device, void* stream) {
  if (bad_args(dtype, B, S_q, S_k, H, dh, valid_len))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Resident k and v, streamed q and dout.
  const void* ptrs[4] = {k, v, q, dout};
  const int rows[4] = {S_k, S_k, S_q, S_q};
  const long long strides[4][3] = {
      {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}, {q_sb, q_ss, q_sh}, {do_sb, do_ss, do_sh}};
  TcMaps m;
  if (!make_tc_maps(&m, ptrs, strides, B, rows, H, dtype == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return launch_tc<true>(m, l, d, dk, dv, B, S_q, S_k, H, valid_len, 0.125f /* dK */, st);
  return launch_f32<true>(m, l, d, dk, dv, B, S_q, S_k, H, valid_len, 0.125f /* f32 dK */, st);
}

extern "C" int twt_attention_bwd_dq(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* di, void* dq,
                                    int dtype, int B, int S_q, int S_k, int H, int dh,
                                    long long q_sb, long long q_ss, long long q_sh,
                                    long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh,
                                    long long do_sb, long long do_ss, long long do_sh,
                                    int valid_len, int device, void* stream) {
  if (bad_args(dtype, B, S_q, S_k, H, dh, valid_len))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(di);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Resident q and dout, streamed k and v.
  const void* ptrs[4] = {q, dout, k, v};
  const int rows[4] = {S_q, S_q, S_k, S_k};
  const long long strides[4][3] = {
      {q_sb, q_ss, q_sh}, {do_sb, do_ss, do_sh}, {k_sb, k_ss, k_sh}, {v_sb, v_ss, v_sh}};
  TcMaps m;
  if (!make_tc_maps(&m, ptrs, strides, B, rows, H, dtype == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1)
    return launch_tc<false>(m, l, d, dq, nullptr, B, S_q, S_k, H, valid_len, 0.125f /* dQ */,
                            st);
  return launch_f32<false>(m, l, d, dq, nullptr, B, S_q, S_k, H, valid_len,
                           0.125f /* f32 dQ */, st);
}
