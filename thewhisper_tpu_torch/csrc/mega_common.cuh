// What K3 (mega_step.cu), K4 (mega_verify.cu) and P2/P3 (mlp_chain.cu)
// share: bf16 and int8 unpacking, warp reductions, tanh GELU, and the
// decode engine (below): its TMA weight ring, LayerNorm, loads, products,
// epilogues, grid barrier and launch. Each including source gets its own
// copy (an unnamed namespace), so they link into one library.

#pragma once

#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDh = 64;
constexpr float kScale = 0.125f;  // 64 ** -0.5, exact
constexpr unsigned kFull = 0xffffffffu;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_lo(unsigned int u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned int u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }
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

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.0f + tanhf(0.7978845608028654f * fmaf(0.044715f * v, v * v, v)));
}

__host__ __device__ inline int round_up(int n, int m) { return (n + m - 1) / m * m; }


namespace engine {

// ---------------------------------------------------------------------------
// The decode engine: K3 (one token, alignment kept) and K4 (a window of W <= 16
// tokens) are both this kernel.
//
// Bound on the H100: device memory. At large-v3 (L 32, D 1280, F 5120,
// V 51866, T 1500) a launch reads 14 D^2 = 22.9 MB of int8 weights a layer
// (734 MB), the 66.4 MB int8 table and 2 T D = 3.84 MB of int8 cross K/V a
// layer (123 MB): about 0.93 GB, 0.28 ms at 3.35 TB/s. None of those bytes
// depends on the token, and the first kernel lost most of its time where
// the memory pipe drained: at each of the 8 grid barriers of a layer, and in
// attention phases that ran on 20 of the 132 SMs.
//
// Design. One cooperative launch of one block on every SM, persistent over
// every phase: 16 consumer warps and one producer warp.
// - The producer streams the block's fixed share of every matrix of the
//   launch (a contiguous row range of each (out, in) int8 matrix, as stored,
//   and the int8 cross K/V of the block's attention items) into a ring of
//   shared-memory stages with 1-D TMA bulk copies (cp.async.bulk, one per
//   row of a 16-row tile, 64 bytes of padding a row so that the consumers'
//   reads hit every bank once), an mbarrier for each stage full and one for
//   each stage empty. It takes no part in the grid barrier, so it runs ahead
//   across phase and layer boundaries for as far as the ring allows: the
//   pipe never drains while the consumers wait at a barrier.
// - The consumers turn each 16-row tile into bf16 exactly (an int8 fits
//   bf16's 8-bit significand: a byte placed in a float's mantissa, one
//   subtraction, the high halves packed) and multiply it on the tensor cores
//   (mma.sync m16n8k16, f32 accumulate) with the W activation rows as the
//   n = 8 operand (two n-tiles for W > 8): the unpacking is done once for all
//   W rows. The k order inside an mma is permuted alike in both operands, so
//   each thread reads 16 contiguous bytes a row. Each 64-column block of the
//   sum starts from zero in the mma and is added to the f32 total, which
//   keeps the tensor core's truncating additions to f32 noise; the 16 warps'
//   totals are added in warp order. Scale and bias come after the sum.
// - LayerNorm runs in every block (cheaper than a barrier), on x read once.
// - The consumers walk the 8 L + 1 phases in one loop in which the product,
//   LayerNorm and loads are each called once, so their code stays in the
//   instruction cache from one phase to the next.
// - Attention runs on every SM: (head, chunk) items, as many as there are
//   blocks or one balanced wave, over T for the cross K/V and over the slots
//   a window sees for the self K/V. Each item writes, for every window row,
//   its max, sum and un-normalised 64-wide output, then counts itself done
//   for its head; the block that completes a head's last chunk combines its
//   chunks (the flash-decoding combine) into the bf16 attention output, so
//   the split costs no barrier. (Combining every head in every block of the
//   next phase, as first written, left each block waiting on chains of L2
//   reads: 8.8 us of a 10 us phase at W = 1, 25 us at W = 5; H100 80GB
//   HBM3, 700 W.) The alignment heads' raw scores wait in scratch until the
//   combine gives their max and sum, then are normalised into `align`.
// - The grid barrier is one arrival counter: red.release.gpu to arrive, one
//   thread polling with ld.acquire.gpu, no sleep. Eight a layer remain:
//   attention items that waited, in place of two of them, on counters of
//   only the blocks that hold their head's rows measured slower (1.86
//   against 1.67 ms a step in two runs on H100 80GB HBM3, 700 W: each
//   release fence cost about what the skew it skipped did).
// - The window's first cache slot `pos` is read from device memory, as the
//   TPU kernel reads it from SMEM: a CUDA graph of a launch replays it at
//   whatever slot the device holds. Each phase that needs it loads it
//   (`window_pos`). The self-attention chunks
//   and the scratch are planned on the host for a bound on pos + W (pos + W
//   itself for a host int, the cache's length for a device slot, as a
//   captured launch needs); chunks past pos + W are
//   neutral. A pos outside [0, bound - W] sets the error word and the launch
//   does nothing else.
// - With `stamps` given, thread 0 of block 0 and of the last block record
//   %globaltimer at every phase's start, barrier arrival and leaving, and
//   what of the phase its product, its waits for the ring and its product
//   loops took.
//
// Numerics (the plain version's rounding points): LayerNorm in f32; every
// int8 product summed in f32, then scaled and biased; projections and the
// residual in bf16; attention scores, softmax and the combine in f32; tanh
// GELU; f32 logits. Row j of a window is computed exactly as a one-row
// launch computes the same token: every mma column and every reduction is
// independent of the other rows.

constexpr int kConsumerWarps = 16;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kBlockThreads = kConsumers + 32;   // and the producer warp
constexpr int kKc = 1280;                        // weight columns a stage
constexpr int kPitch = kKc + 64;                 // bytes a stage row
constexpr int kStageBytes = 16 * kPitch;
constexpr int kMaxChunk = kStageBytes / kDh;     // cross K/V rows a stage
constexpr int kMaxStages = 16;
constexpr int kMaxW = 16;
constexpr int kPart = 68;                        // m, l, 2 unused, o[64]

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
  bf16* x;                                                  // (W, D) residual
  bf16 *qkv, *att, *hid;                                    // (W, 3D | D | F)
  float* cq;                                                // (W, D)
  float *spart, *cpart;                                     // (W, H, chunks, kPart)
  float* ascore;                                            // (max(A, 1), T)
  float* logits;                                            // (W, V)
  float* align;                                             // (max(A, 1), T)
  unsigned int* bar;                                        // (1) arrivals
  unsigned int* done;                                       // (L, 2, H) items done
  unsigned long long* stamps;                               // (2, phases, 3) or null
  const int* pos;                                           // (1) first slot, device
  int* err;                                                 // (1) set on a bad pos
  int L, D, F, H, V, S, T, A, W, bound, capture, phases;
  int sc, sn, cc, cn;     // self / cross chunk length and chunks a head
  int stages, pitch;      // ring stages; bf16 elements a row of act
};

// The counters a launch zeroes first: the grid barrier's and the items
// done of each (layer, attention, head), in bytes, a multiple of 16.
__host__ __device__ inline size_t counter_bytes(int L, int H) {
  return static_cast<size_t>(round_up(4 * (1 + 2 * L * H), 16));
}

// The work (bytes) a launch needs beside its outputs, in the order of the
// fields above: the counters, qkv, att, hid, cq, spart, cpart, ascore.
__host__ __device__ inline size_t work_bytes(int L, int W, int D, int F, int H, int sn, int cn,
                                             int A, int T) {
  return counter_bytes(L, H) + 2 * static_cast<size_t>(W) * (4 * D + F) +
         4 * static_cast<size_t>(W) * D + 4 * static_cast<size_t>(kPart) * W * H * (sn + cn) +
         4 * static_cast<size_t>(A > 0 ? A : 1) * T;
}

// Block b's rows of an R-row matrix: [row_lo(b), row_lo(b + 1)).
__device__ __forceinline__ int row_lo(int b, int R) {
  return static_cast<int>(static_cast<long long>(b) * R / gridDim.x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait of 2 s inside a launch of a few ms is a fault (a ring or the
// barrier out of step): trap, so that the launch fails instead of hanging.
__device__ __forceinline__ void check_stuck(unsigned long long t0) {
  if (now_ns() - t0 > 2000000000ull) __trap();
}

// Phase stamps: with `stamps` given, thread 0 of block 0 and of the grid's
// last block write %globaltimer (ns) into stamps (2, phases, kStamps): the
// start of phase k, its arrival at the barrier that ends it, its leaving,
// the start of its matrix product (0 if it has none), the ns it waited for
// ring stages and the ns its product's loops took (warp 0).
enum { kStart = 0, kArrive = 1, kLeave = 2, kGemm = 3, kRingWait = 4, kMma = 5, kStamps = 6 };

__device__ __forceinline__ void stamp(unsigned long long* stamps, int phases, int k, int what) {
  if (stamps == nullptr || threadIdx.x != 0) return;
  const int who = blockIdx.x == 0 ? 0 : (blockIdx.x == gridDim.x - 1 ? 1 : -1);
  if (who < 0) return;
  stamps[(static_cast<size_t>(who) * phases + k) * kStamps + what] = now_ns();
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_try(bar, parity)) check_stuck(t0);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// A 1-D TMA copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// that completes `bytes` of the mbarrier's transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The consumers' own barrier (named barrier 1; the producer never joins).
__device__ __forceinline__ void cbar() { asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory"); }

// The ring as every consumer thread (and the producer) walks it: stage `it`
// sits in slot it % stages and is that slot's (it / stages)-th use.
// What thread 0 measures inside a phase for the stamps: the start of its
// matrix product, the ns waited for ring stages and the ns in the product's
// loops.
struct Clock {
  unsigned long long gemm, waited, mma;
};

struct Ring {
  unsigned char* base;
  uint32_t full, empty;  // mbarrier arrays, 8 bytes a slot
  int stages, it;
  Clock* clock;          // null without stamps
};

__device__ __forceinline__ const unsigned char* ring_acquire(Ring& r) {
  const int slot = r.it % r.stages;
  const uint32_t bar = r.full + 8 * slot, parity = (r.it / r.stages) & 1;
  if (r.clock && threadIdx.x == 0 && !mbar_try(bar, parity)) {
    const unsigned long long t0 = now_ns();
    mbar_wait(bar, parity);
    r.clock->waited += now_ns() - t0;
  } else {
    mbar_wait(bar, parity);
  }
  return r.base + static_cast<size_t>(slot) * kStageBytes;
}

// Each consumer warp hands the stage back once its reads are done.
__device__ __forceinline__ void ring_release(Ring& r) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * (r.it % r.stages));
  ++r.it;
}

// ---------------------------------------------------------------------------
// The producer warp: the same walk as the consumers', in the same order.

struct Producer {
  Ring r;
  int lane;

  // Wait for the slot of the next stage to be free and expect its bytes.
  __device__ __forceinline__ uint32_t open(uint32_t bytes, unsigned char** dst) {
    const int slot = r.it % r.stages;
    if (r.it >= r.stages) mbar_wait(r.empty + 8 * slot, ((r.it / r.stages) - 1) & 1);
    const uint32_t full = r.full + 8 * slot;
    if (lane == 0) mbar_expect(full, bytes);
    __syncwarp();
    *dst = r.base + static_cast<size_t>(slot) * kStageBytes;
    ++r.it;
    return full;
  }

  // The block's rows of an (R, K) matrix: 16-row tiles, kKc columns a stage.
  __device__ void tiles(const int8_t* w, int R, int K) {
    const int r1 = row_lo(blockIdx.x + 1, R);
    for (int m0 = row_lo(blockIdx.x, R); m0 < r1; m0 += 16) {
      const int rows = min(16, r1 - m0);
      for (int k0 = 0; k0 < K; k0 += kKc) {
        const int kl = min(kKc, K - k0);
        unsigned char* dst;
        const uint32_t full = open(rows * kl, &dst);
        if (lane < rows)
          bulk_copy(smem_addr(dst + lane * kPitch), w + static_cast<size_t>(m0 + lane) * K + k0, kl,
                    full);
      }
    }
  }

  // One contiguous run of bytes (a cross K or V chunk) as one stage.
  __device__ void run(const int8_t* src, int bytes) {
    unsigned char* dst;
    const uint32_t full = open(bytes, &dst);
    if (lane == 0) bulk_copy(smem_addr(dst), src, bytes, full);
  }
};

__device__ void produce(const Args& p, Ring ring) {
  Producer pr{ring, static_cast<int>(threadIdx.x & 31)};
  const int D = p.D, F = p.F;
  const size_t dd = static_cast<size_t>(D) * D, df = static_cast<size_t>(D) * F;
  for (int l = 0; l < p.L; ++l) {
    pr.tiles(p.qkv_w + 3 * l * dd, 3 * D, D);
    pr.tiles(p.o_w + l * dd, D, D);
    pr.tiles(p.cq_w + l * dd, D, D);
    for (int it = blockIdx.x; it < p.H * p.cn; it += gridDim.x) {
      const int h = it / p.cn, t0 = (it % p.cn) * p.cc;
      const int nt = min(p.cc, p.T - t0);
      const size_t off = ((static_cast<size_t>(l) * p.H + h) * p.T + t0) * kDh;
      pr.run(p.cross_k + off, nt * kDh);
      pr.run(p.cross_v + off, nt * kDh);
    }
    pr.tiles(p.co_w + l * dd, D, D);
    pr.tiles(p.fc1_w + l * df, F, D);
    pr.tiles(p.fc2_w + l * df, D, F);
  }
  pr.tiles(p.emb_q, p.V, D);
}

// ---------------------------------------------------------------------------
// The consumers.

// Four signed bytes of w, exactly, as two bf16x2: lo = (b0, b1), hi = (b2, b3).
__device__ __forceinline__ void s8x4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // each byte + 128, as unsigned
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// Four signed bytes of w as floats, exactly, without the slow int-to-float
// conversion.
__device__ __forceinline__ void s8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// What a gemm's epilogue reads besides the sum, for row r and window row
// n: scale[r], bias[r] (0 if null), extra[r] (0 if null) and resid[n][r]
// (the residual stream, 0 if null). They are loaded before the tile's
// products, so that their reads overlap them.
struct EpiIn {
  const float *scale, *bias, *extra;
  const bf16* resid;
};

// The window's first cache slot, from device memory: each phase that needs
// it loads it again. The load is volatile, so that the compiler neither
// hoists it nor keeps it in a register across the phases (kept there, it
// made the kernel spill 16 bytes; this way it spills 4, against the host
// int's none).
__device__ __forceinline__ int window_pos(const Args& p) {
  int pos;
  asm volatile("ld.global.nc.b32 %0, [%1];" : "=r"(pos) : "l"(p.pos));
  return pos;
}

// What a gemm's epilogue does with y = sum * scale + bias of row r, window
// row n: the qkv rows (k and v also into cache slot pos + n of layer l),
// the residual add, the cross query (extra = the K scale), fc1's GELU, the
// logits.
enum EpiKind { kQkv, kResidual, kCrossQuery, kGelu, kLogits };

__device__ __forceinline__ void epilogue(const Args& p, int kind, int l, int r, int n, float y,
                                         float ex, float xr) {
  const int D = p.D;
  switch (kind) {
    case kQkv: {
      const bf16 v = __float2bfloat16(y);
      p.qkv[static_cast<size_t>(n) * 3 * D + r] = v;
      if (r >= D) {
        const int c = r >= 2 * D ? r - 2 * D : r - D;
        bf16* cache = r >= 2 * D ? p.self_v : p.self_k;
        const int pos = window_pos(p);
        cache[((static_cast<size_t>(l) * p.H + c / kDh) * p.S + pos + n) * kDh + c % kDh] = v;
      }
      break;
    }
    case kResidual:
      p.x[static_cast<size_t>(n) * D + r] = __float2bfloat16(xr + round_bf16(y));
      break;
    case kCrossQuery:
      p.cq[static_cast<size_t>(n) * D + r] = round_bf16(y) * ex * kScale;
      break;
    case kGelu:
      p.hid[static_cast<size_t>(n) * p.F + r] = __float2bfloat16(gelu_tanh(round_bf16(y)));
      break;
    default:
      p.logits[static_cast<size_t>(n) * p.V + r] = y;
  }
}

// For every row r of the block's share of the (R, K) int8 matrix and every
// window row n < W: out(r, n, y, extra[r], resid[n][r]) with y = (sum_k
// act[n][k] W[r, k]) * scale[r] + bias[r]. The matrix comes from the ring,
// one 16-row tile at a time in kKc-column stages; each warp takes 64-column
// blocks j = warp, warp + 8, ... of a stage. Lane (g, t) holds bytes
// 16t .. 16t + 15 of a block for rows g and g + 8 and the same 16 columns
// of window row n = 8 nt + g; mma step jj of the block pairs columns
// 16t + 4jj + {0, 1, 2, 3} with the fragment slots {2t, 2t + 1, 2t + 8,
// 2t + 9}, in both operands alike. Steps 0, 2 and 1, 3 form two chains.
template <int NT>
__device__ __forceinline__ void gemm(const Args& p, Ring& ring, int R, int K, const bf16* act,
                                  float* red, int& rbuf, EpiIn in, int kind, int l) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r1 = row_lo(blockIdx.x + 1, R);
  constexpr int kCols = 8 * NT;
  if (ring.clock && threadIdx.x == 0) ring.clock->gemm = now_ns();
  for (int m0 = row_lo(blockIdx.x, R); m0 < r1; m0 += 16) {
    // This thread's epilogue slot: row m0 + (idx & 15), window row idx >> 4.
    const int er = m0 + (threadIdx.x & 15), en = threadIdx.x >> 4;
    const bool mine = en < p.W && er < r1;
    float sc = 0.0f, bi = 0.0f, ex = 0.0f, xr = 0.0f;
    if (mine) {
      sc = in.scale[er];
      if (in.bias) bi = in.bias[er];
      if (in.extra) ex = in.extra[er];
      if (in.resid) xr = load_shared_bf16(in.resid + static_cast<size_t>(en) * p.D + er);
    }
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += kKc) {
      const int blocks = min(kKc, K - k0) / 64;
      const unsigned char* st = ring_acquire(ring);
      const unsigned long long t_mma = ring.clock && threadIdx.x == 0 ? now_ns() : 0;
#pragma unroll 2
      for (int j = warp; j < blocks; j += kConsumerWarps) {
        const uint4 alo = *reinterpret_cast<const uint4*>(st + g * kPitch + j * 64 + 16 * t);
        const uint4 ahi = *reinterpret_cast<const uint4*>(st + (g + 8) * kPitch + j * 64 + 16 * t);
        uint4 bv[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = 8 * nt + g;
          if (n < p.W) {
            const uint4* a = reinterpret_cast<const uint4*>(act + static_cast<size_t>(n) * p.pitch +
                                                            k0 + j * 64 + 16 * t);
            bv[nt][0] = a[0];
            bv[nt][1] = a[1];
          } else {
            bv[nt][0] = bv[nt][1] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
        float c[2][NT][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) c[h][nt][i] = 0.0f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t a0, a1, a2, a3;
          s8x4_to_bf16x2(word(alo, jj), a0, a2);
          s8x4_to_bf16x2(word(ahi, jj), a1, a3);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma_bf16(c[jj & 1][nt], a0, a1, a2, a3, word(bv[nt][jj >> 1], 2 * (jj & 1)),
                     word(bv[nt][jj >> 1], 2 * (jj & 1) + 1));
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[nt][i] += c[0][nt][i] + c[1][nt][i];
      }
      if (ring.clock && threadIdx.x == 0) ring.clock->mma += now_ns() - t_mma;
      ring_release(ring);
    }
    // The warps' totals, added in warp order. With one n-tile, two buffers:
    // the next tile writes the other one while slow threads still read
    // this one; with two (W > 8, where shared memory is short), one buffer
    // and a second barrier.
    float* rb = red + rbuf * (kConsumerWarps * 16 * kCols);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float* row = rb + (warp * 16 + g) * kCols + 8 * nt + 2 * t;
      row[0] = acc[nt][0];
      row[1] = acc[nt][1];
      row[8 * kCols] = acc[nt][2];
      row[8 * kCols + 1] = acc[nt][3];
    }
    cbar();
    if (mine) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kConsumerWarps; ++w) sum += rb[(w * 16 + (threadIdx.x & 15)) * kCols + en];
      epilogue(p, kind, l, er, en, fmaf(sum, sc, bi), ex, xr);
    }
    if (NT == 1)
      rbuf ^= 1;
    else
      cbar();
  }
}

// act[w][0 : n] = src[w][0 : n] (n % 8 == 0), another phase's output.
__device__ void load_rows(const Args& p, const bf16* src, int n, bf16* act) {
  const int per_row = n / 8;
  for (int i = threadIdx.x; i < p.W * per_row; i += kConsumers) {
    const int w = i / per_row, c = i % per_row;
    reinterpret_cast<uint4*>(act + static_cast<size_t>(w) * p.pitch)[c] =
        __ldcg(reinterpret_cast<const uint4*>(src + static_cast<size_t>(w) * n) + c);
  }
  cbar();
}

// act[w][i] = bf16(LayerNorm(x[w]) * g + b) for the W rows of x, read once
// into act and normalised in place; each row summed alike (each thread's
// elements in order, the warps' sums in order). `stats` holds 2 kMaxW
// floats, `wred` kMaxW x kConsumerWarps.
__device__ void ln_rows(const Args& p, const float* g, const float* b, bf16* act, float* stats,
                        float* wred) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, D = p.D;
  load_rows(p, p.x, D, act);
  for (int pass = 0; pass < 2; ++pass) {
    for (int w = 0; w < p.W; ++w) {
      const bf16* row = act + static_cast<size_t>(w) * p.pitch;
      const float mean = pass ? stats[w] : 0.0f;
      float s = 0.0f;
      for (int i = threadIdx.x; i < D; i += kConsumers) {
        const float v = __bfloat162float(row[i]);
        if (pass) {
          const float d = v - mean;
          s = fmaf(d, d, s);
        } else {
          s += v;
        }
      }
      s = warp_sum(s);
      if (lane == 0) wred[w * kConsumerWarps + warp] = s;
    }
    cbar();
    if (threadIdx.x < p.W) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < kConsumerWarps; ++j) s += wred[threadIdx.x * kConsumerWarps + j];
      if (pass)
        stats[kMaxW + threadIdx.x] = rsqrtf(s / D + 1e-5f);
      else
        stats[threadIdx.x] = s / D;
    }
    cbar();
  }
  for (int w = 0; w < p.W; ++w) {
    bf16* row = act + static_cast<size_t>(w) * p.pitch;
    const float mean = stats[w], rstd = stats[kMaxW + w];
    for (int i = threadIdx.x; i < D; i += kConsumers)
      row[i] = __float2bfloat16((__bfloat162float(row[i]) - mean) * rstd * g[i] + b[i]);
  }
  cbar();
}


// One pass over head h's chunk partials pp (for one window row) in batches
// of 8, every load of a batch in flight at once: the max M and sum Z of the
// head's softmax and, for column d >= 0, sum_c e^(m_c - M) o_c[d].
__device__ float combine_col(const float* pp, int chunks, int d, float& M, float& Z) {
  M = -INFINITY;
  Z = 0.0f;
  float o = 0.0f;
  for (int c0 = 0; c0 < chunks; c0 += 8) {
    float m[8], l[8], v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* q = pp + static_cast<size_t>(c0 + i) * kPart;
      const bool in = c0 + i < chunks;
      m[i] = in ? __ldcg(q) : -INFINITY;
      l[i] = in ? __ldcg(q + 1) : 0.0f;
      v[i] = in && d >= 0 ? __ldcg(q + 4 + d) : 0.0f;
    }
    float bm = M;
#pragma unroll
    for (int i = 0; i < 8; ++i) bm = fmaxf(bm, m[i]);
    if (bm == -INFINITY) continue;
    const float r = M == -INFINITY ? 0.0f : expf(M - bm);
    Z *= r;
    o *= r;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (m[i] != -INFINITY) {
        const float e = expf(m[i] - bm);
        Z = fmaf(l[i], e, Z);
        o = fmaf(v[i], e, o);
      }
    M = bm;
  }
  return o;
}

// After an item of head h has written its partials (part (W, H, chunks,
// kPart)): it counts itself done (an acquire-release add, which also makes
// its writes visible), and the block that completes the head combines the
// head's chunks for every window row, att[w][h 64 + d] = bf16(sum_c
// e^(m_c - M) o_c[d] / Z (x vs[h 64 + d])), and, for an alignment head of
// layer l (cross-attention, alignment kept), adds its probabilities
// e^(s_t - M) / Z to `align`. `flag` is one int of shared memory.
__device__ void finish_item(const Args& p, const float* part, int chunks, unsigned int* done,
                            const float* vs, int h, int l, int* flag) {
  cbar();
  if (threadIdx.x == 0) {
    unsigned int before;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(before)
                 : "l"(done)
                 : "memory");
    *flag = before == static_cast<unsigned int>(chunks - 1);
  }
  cbar();
  if (!*flag) return;
  for (int tk = threadIdx.x; tk < p.W * kDh; tk += kConsumers) {
    const int w = tk >> 6, d = tk & 63;
    float M, Z;
    const float o =
        combine_col(part + (static_cast<size_t>(w) * p.H + h) * chunks * kPart, chunks, d, M, Z);
    const int col = h * kDh + d;
    const float y = o * (1.0f / Z);
    p.att[static_cast<size_t>(w) * p.D + col] = __float2bfloat16(vs ? y * vs[col] : y);
  }
  if (vs && p.capture)
    for (int a = 0; a < p.A; ++a) {
      if (p.heads[2 * a] != l || p.heads[2 * a + 1] != h) continue;
      float M, Z;
      combine_col(part + static_cast<size_t>(h) * chunks * kPart, chunks, -1, M, Z);
      const float inv = 1.0f / Z;
#pragma unroll 4
      for (int t = threadIdx.x; t < p.T; t += kConsumers) {
        const size_t i = static_cast<size_t>(a) * p.T + t;
        p.align[i] = __ldcg(p.align + i) + expf(__ldcg(p.ascore + i) - M) * inv;
      }
    }
}

// Thread 0 writes the phase's clock into the stamps and resets it.
__device__ __forceinline__ void stamp_clock(const Args& p, Clock* clock, int k) {
  if (!clock || threadIdx.x != 0) return;
  const int who = blockIdx.x == 0 ? 0 : (blockIdx.x == gridDim.x - 1 ? 1 : -1);
  if (who >= 0) {
    unsigned long long* row = p.stamps + (static_cast<size_t>(who) * p.phases + k) * kStamps;
    row[kGemm] = clock->gemm;
    row[kRingWait] = clock->waited;
    row[kMma] = clock->mma;
  }
  clock->gemm = clock->waited = clock->mma = 0;
}

// The softmax of each window row's scores lg[w][0 : n] (-inf where a slot is
// masked): lg becomes e^(s - m); mz[w] and the chunk's partial in part get m
// and the sum. One warp a row.
__device__ void chunk_softmax(const Args& p, float* lg, int stride, int n, float* part,
                              int chunks, int h, int c, float* mz) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int w = warp; w < p.W; w += kConsumerWarps) {
    float* row = lg + w * stride;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float z = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = m == -INFINITY ? 0.0f : expf(row[j] - m);
      row[j] = e;
      z += e;
    }
    z = warp_sum(z);
    if (lane == 0) {
      mz[2 * w] = m;
      mz[2 * w + 1] = z;
      float* pp = part + ((static_cast<size_t>(w) * p.H + h) * chunks + c) * kPart;
      pp[0] = m;
      pp[1] = z;
    }
  }
  cbar();
}

// The self-attention output of head h for window row w, column d, where the
// head is one chunk (this item): o / z, as finish_item would combine it.
__device__ __forceinline__ void write_att(const Args& p, int w, int h, int d, float o,
                                          const float* mz) {
  p.att[static_cast<size_t>(w) * p.D + h * kDh + d] = __float2bfloat16(o * (1.0f / mz[2 * w + 1]));
}

// Self-attention of layer l over (head, slot-chunk) items: window row w sees
// slots [0, pos + w]. Slots below pos come from earlier launches, the
// window's from this launch's qkv phase (read from L2). The queries and the
// chunk's V rows come in one round of loads, the K rows in a second. The
// chunks are planned for the host's bound on pos + W, so those that start
// at or past pos + W hold no slot a row sees: with ns <= 0 every loop below
// is empty and the chunk's partial comes out neutral (max -inf, sum 0, o
// 0), which the combine skips.
__device__ void self_attention(const Args& p, int l, float* u, int* flag) {
  const int W = p.W, H = p.H, pos = window_pos(p), D = p.D;
  uint4* vsm = reinterpret_cast<uint4*>(u);            // (sc, 64) bf16
  float* mz = u + 32 * p.sc;                            // (kMaxW, 2)
  float* qs = mz + 2 * kMaxW;                           // (W, 64)
  float* lg = qs + W * kDh;                             // (W, sc)
  float* ored = lg + W * p.sc;                          // (groups, W 32, 2)
  const int tasks = W * 32, groups = max(1, kConsumers / tasks);
  for (int it = blockIdx.x; it < H * p.sn; it += gridDim.x) {
    const int h = it / p.sn, c = it % p.sn;
    const int s0 = c * p.sc, ns = min(p.sc, pos + W - s0);
    const size_t base = (static_cast<size_t>(l) * H + h) * p.S * kDh;
    for (int i = threadIdx.x; i < W * kDh; i += kConsumers)
      qs[i] = load_shared_bf16(p.qkv + static_cast<size_t>(i >> 6) * 3 * D + h * kDh + (i & 63)) *
              kScale;
    const uint4* vg = reinterpret_cast<const uint4*>(p.self_v + base + static_cast<size_t>(s0) * kDh);
    for (int i = threadIdx.x; i < ns * 8; i += kConsumers) vsm[i] = __ldcg(vg + i);
    cbar();
    for (int i = threadIdx.x; i < W * ns; i += kConsumers) {
      const int w = i / ns, s = s0 + i % ns;
      float d = -INFINITY;
      if (s <= pos + w) {
        const uint4* kr = reinterpret_cast<const uint4*>(p.self_k + base + static_cast<size_t>(s) * kDh);
        uint4 kv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) kv[j] = __ldcg(kr + j);
        const float* q = qs + w * kDh;
        d = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const unsigned int vv[4] = {kv[j].x, kv[j].y, kv[j].z, kv[j].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            d = fmaf(q[8 * j + 2 * e + 1], bf16_hi(vv[e]), fmaf(q[8 * j + 2 * e], bf16_lo(vv[e]), d));
        }
      }
      lg[w * p.sc + (s - s0)] = d;
    }
    cbar();
    chunk_softmax(p, lg, p.sc, ns, p.spart, p.sn, h, c, mz);
    const unsigned int* vs = reinterpret_cast<const unsigned int*>(vsm);
    for (int tk = threadIdx.x; tk < tasks * groups; tk += kConsumers) {
      const int task = tk % tasks, grp = tk / tasks, w = task >> 5, dp = task & 31;
      float a0 = 0.0f, a1 = 0.0f;
      for (int j = grp; j < ns; j += groups) {
        const float e = lg[w * p.sc + j];
        const unsigned int v = vs[j * 32 + dp];
        a0 = fmaf(e, bf16_lo(v), a0);
        a1 = fmaf(e, bf16_hi(v), a1);
      }
      ored[2 * tk] = a0;
      ored[2 * tk + 1] = a1;
    }
    cbar();
    for (int task = threadIdx.x; task < tasks; task += kConsumers) {
      const int w = task >> 5, dp = task & 31;
      float a0 = 0.0f, a1 = 0.0f;
      for (int grp = 0; grp < groups; ++grp) {
        a0 += ored[2 * (grp * tasks + task)];
        a1 += ored[2 * (grp * tasks + task) + 1];
      }
      if (p.sn == 1) {
        write_att(p, w, h, 2 * dp, a0, mz);
        write_att(p, w, h, 2 * dp + 1, a1, mz);
      } else {
        float* pp = p.spart + ((static_cast<size_t>(w) * H + h) * p.sn + c) * kPart + 4;
        pp[2 * dp] = a0;
        pp[2 * dp + 1] = a1;
      }
    }
    if (p.sn > 1) finish_item(p, p.spart, p.sn, p.done + (2 * l) * H + h, nullptr, h, l, flag);
    cbar();
  }
}

// Cross-attention of layer l over (head, T-chunk) items, the int8 K and V
// chunks from the ring. The queries in cq already carry the K scale and
// 1/sqrt(64); the V scale is applied in the combine. The alignment heads'
// raw scores (window row 0) go to ascore.
__device__ void cross_attention(const Args& p, int l, Ring& ring, float* u, int* flag) {
  const int W = p.W, H = p.H, D = p.D;
  float* mz = u;                    // (kMaxW, 2)
  float* qs = mz + 2 * kMaxW;       // (W, 64)
  float* lg = qs + W * kDh;         // (W, cc)
  float* ored = lg + W * p.cc;      // (groups, W 16, 4)
  const int tasks = W * 16, groups = max(1, kConsumers / tasks);
  for (int it = blockIdx.x; it < H * p.cn; it += gridDim.x) {
    const int h = it / p.cn, c = it % p.cn;
    const int t0 = c * p.cc, nt = min(p.cc, p.T - t0);
    for (int i = threadIdx.x; i < W * kDh; i += kConsumers)
      qs[i] = __ldcg(p.cq + static_cast<size_t>(i >> 6) * D + h * kDh + (i & 63));
    cbar();
    const unsigned char* ks = ring_acquire(ring);
    for (int i = threadIdx.x; i < W * nt; i += kConsumers) {
      const int w = i / nt, j = i % nt;
      const uint4* kr = reinterpret_cast<const uint4*>(ks + j * kDh);
      const float* q = qs + w * kDh;
      float d = 0.0f;
#pragma unroll
      for (int q4 = 0; q4 < 4; ++q4) {
        const int c4 = (q4 + j) & 3;  // rotate: neighbouring rows, other banks
        const uint4 v = kr[c4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float kf[4];
          s8x4_to_f32(word(v, e), kf);
#pragma unroll
          for (int b = 0; b < 4; ++b) d = fmaf(kf[b], q[16 * c4 + 4 * e + b], d);
        }
      }
      lg[w * p.cc + j] = d;
    }
    ring_release(ring);
    cbar();
    if (p.capture)
      for (int a = 0; a < p.A; ++a)
        if (p.heads[2 * a] == l && p.heads[2 * a + 1] == h)
          for (int j = threadIdx.x; j < nt; j += kConsumers)
            p.ascore[static_cast<size_t>(a) * p.T + t0 + j] = lg[j];
    if (p.capture) cbar();
    chunk_softmax(p, lg, p.cc, nt, p.cpart, p.cn, h, c, mz);
    const unsigned int* vs = reinterpret_cast<const unsigned int*>(ring_acquire(ring));
    for (int tk = threadIdx.x; tk < tasks * groups; tk += kConsumers) {
      const int task = tk % tasks, grp = tk / tasks, w = task >> 4, d4 = task & 15;
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = grp; j < nt; j += groups) {
        const float e = lg[w * p.cc + j];
        float vf[4];
        s8x4_to_f32(vs[j * 16 + d4], vf);
#pragma unroll
        for (int b = 0; b < 4; ++b) a[b] = fmaf(e, vf[b], a[b]);
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) ored[4 * tk + b] = a[b];
    }
    ring_release(ring);
    cbar();
    for (int task = threadIdx.x; task < tasks; task += kConsumers) {
      const int w = task >> 4, d4 = task & 15;
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int grp = 0; grp < groups; ++grp)
#pragma unroll
        for (int b = 0; b < 4; ++b) a[b] += ored[4 * (grp * tasks + task) + b];
      float* pp = p.cpart + ((static_cast<size_t>(w) * H + h) * p.cn + c) * kPart + 4 + 4 * d4;
#pragma unroll
      for (int b = 0; b < 4; ++b) pp[b] = a[b];
    }
    finish_item(p, p.cpart, p.cn, p.done + (2 * l + 1) * H + h,
                p.cross_vs + static_cast<size_t>(l) * D, h, l, flag);
    cbar();
  }
}

// Every block's consumers arrive before any leave; their writes before it
// are visible (through L2) after it. One monotone arrival counter, zeroed
// before the launch: the k-th barrier waits for k x gridDim.x arrivals.
__device__ __forceinline__ void grid_barrier(const Args& p, unsigned int& target, int k,
                                             Clock* clock) {
  cbar();
  if (threadIdx.x == 0) {
    stamp(p.stamps, p.phases, k, kArrive);
    stamp_clock(p, clock, k);
    target += gridDim.x;
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(p.bar) : "memory");
    const unsigned long long t0 = now_ns();
    unsigned int seen;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(p.bar) : "memory");
      if (seen >= target) break;
      check_stuck(t0);
    }
    stamp(p.stamps, p.phases, k, kLeave);
    stamp(p.stamps, p.phases, k + 1, kStart);
  }
  cbar();
}

// Shared memory: the ring's mbarriers (2 kMaxStages x 8 bytes) | red (two
// buffers of kConsumerWarps x 16 x 8 NT floats) | stats (2 kMaxW, then the
// finish flag and the stamps' clock) | wred
// (kMaxW x kConsumerWarps) | act (W rows of `pitch` bf16) or the attention
// scratch | the ring (stages x kStageBytes), each part 128-byte aligned.
struct Layout {
  size_t red, stats, wred, act, ring, total;
};

__host__ __device__ inline Layout layout(int NT, int W, int pitch, int sc, int cc, int stages) {
  Layout s;
  s.red = 2 * kMaxStages * 8;
  s.stats = s.red + 4 * static_cast<size_t>((NT == 1 ? 2 : 1) * kConsumerWarps * 16 * 8 * NT);
  s.wred = s.stats + round_up(4 * (2 * kMaxW + 10), 128);
  s.act = s.wred + round_up(4 * kMaxW * kConsumerWarps, 128);
  const size_t act = 2 * static_cast<size_t>(W) * pitch;
  const size_t attn = 4 * (2 * kMaxW + static_cast<size_t>(W) * kDh +
                           static_cast<size_t>(W) * (sc > cc ? sc : cc) +
                           4 * static_cast<size_t>(kConsumers > W * 32 ? kConsumers : W * 32)) +
                      2 * static_cast<size_t>(sc) * kDh;
  s.ring = s.act + round_up(static_cast<int>(act > attn ? act : attn), 128);
  s.total = s.ring + static_cast<size_t>(stages) * kStageBytes;
  return s;
}

template <int NT>
__global__ void __launch_bounds__(kBlockThreads, 1) mega_kernel(Args p) {
  extern __shared__ __align__(128) unsigned char engine_smem[];
  unsigned char* smem = engine_smem;
  const Layout s = layout(NT, p.W, p.pitch, p.sc, p.cc, p.stages);
  Ring ring{smem + s.ring, smem_addr(smem), smem_addr(smem + 8 * kMaxStages), p.stages, 0,
            nullptr};
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(ring.full + 8 * i, 1);
      mbar_init(ring.empty + 8 * i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // The window's first slot, from device memory (a CUDA graph replays the
  // launch at whatever slot the device holds then). Outside [0, bound - W]
  // (the host planned the chunks and the scratch for pos + W <= bound <= S)
  // every thread of every block leaves before any read or write, and the
  // wrapper finds the error word set. The phases that need it read it
  // again (`window_pos`).
  const int pos = window_pos(p);
  if (pos < 0 || pos > p.bound - p.W) {
    if (blockIdx.x == 0 && threadIdx.x == 0) atomicExch(p.err, 1);
    return;
  }
  if (threadIdx.x >= kConsumers) {
    produce(p, ring);
    return;
  }

  float* red = reinterpret_cast<float*>(smem + s.red);
  float* stats = reinterpret_cast<float*>(smem + s.stats);
  int* flag = reinterpret_cast<int*>(stats + 2 * kMaxW);
  Clock* clock = reinterpret_cast<Clock*>(stats + 2 * kMaxW + 2);  // 8-byte aligned
  if (p.stamps) {
    if (threadIdx.x == 0) clock->gemm = clock->waited = clock->mma = 0;
    ring.clock = clock;
  }
  float* wred = reinterpret_cast<float*>(smem + s.wred);
  bf16* act = reinterpret_cast<bf16*>(smem + s.act);
  float* u = reinterpret_cast<float*>(smem + s.act);  // the attention scratch
  const int D = p.D, F = p.F;
  int rbuf = 0;
  unsigned int target = 0;
  stamp(p.stamps, p.phases, 0, kStart);
  if (p.align) {
    const int n_align = (p.A > 0 ? p.A : 1) * p.T;
    for (int i = blockIdx.x * kConsumers + threadIdx.x; i < n_align; i += gridDim.x * kConsumers)
      p.align[i] = 0.0f;
  }

  // One loop over the 8 L + 1 phases, each call site once in the code: the
  // products, LayerNorms and loads of all phases share one copy, which
  // stays in the instruction cache (an inlined copy a phase fetched its
  // code anew every layer, about 1 us a phase on H100 80GB HBM3, 700 W).
  for (int k = 0; k < p.phases; ++k) {
    const int l = k >> 3, ph = k & 7;
    const bool last = k == p.phases - 1;   // the final LN and the logits
    const float* sm = p.smalls + static_cast<size_t>(last ? 0 : l) * (20 * D + 2 * F);
    // The phase's input rows in act: a LayerNorm of x or another phase's output.
    if (last)
      ln_rows(p, p.lnp, p.lnp + D, act, stats, wred);
    else if (ph == 0 || ph == 3 || ph == 6)
      ln_rows(p, sm + (ph == 0 ? 0 : ph == 3 ? 10 : 16) * D, sm + (ph == 0 ? 1 : ph == 3 ? 11 : 17) * D,
              act, stats, wred);
    else if (ph == 2 || ph == 5 || ph == 7)
      load_rows(p, ph == 7 ? p.hid : p.att, ph == 7 ? F : D, act);
    if (!last && ph == 1) {
      self_attention(p, l, u, flag);
    } else if (!last && ph == 4) {
      cross_attention(p, l, ring, u, flag);
    } else {
      // The phase's product: 0 LN1 + qkv (k, v into the cache), 2 the
      // out-projection, 3 the cross query, 5 the cross out-projection,
      // 6 fc1 + GELU, 7 fc2 (residual adds after 2, 5, 7); the logits.
      int R = D, K = D, kind = kResidual;
      EpiIn in = {nullptr, nullptr, nullptr, p.x};
      switch (last ? -1 : ph) {
        case 0: R = 3 * D; kind = kQkv; in = {sm + 2 * D, sm + 5 * D, nullptr, nullptr}; break;
        case 2: in.scale = sm + 8 * D; in.bias = sm + 9 * D; break;
        case 3:
          kind = kCrossQuery;
          in = {sm + 12 * D, sm + 13 * D, p.cross_ks + static_cast<size_t>(l) * D, nullptr};
          break;
        case 5: in.scale = sm + 14 * D; in.bias = sm + 15 * D; break;
        case 6: R = F; kind = kGelu; in = {sm + 18 * D, sm + 18 * D + F, nullptr, nullptr}; break;
        case 7: K = F; in.scale = sm + 18 * D + 2 * F; in.bias = sm + 19 * D + 2 * F; break;
        default: R = p.V; kind = kLogits; in = {p.emb_s, nullptr, nullptr, nullptr};
      }
      gemm<NT>(p, ring, R, K, act, red, rbuf, in, kind, l);
    }
    if (!last) grid_barrier(p, target, k, ring.clock);
  }
  stamp(p.stamps, p.phases, p.phases - 1, kArrive);
  stamp(p.stamps, p.phases, p.phases - 1, kLeave);
  stamp_clock(p, ring.clock, p.phases - 1);
}

// The card's SM count and opt-in shared memory, asked once a device.
int device_info(int device, int* sms, int* smem_limit) {
  constexpr int kDevices = 64;
  static int known[kDevices][2];
  if (device < 0 || device >= kDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (known[device][0] == 0) {
    int n = 0, limit = 0;
    cudaError_t err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    known[device][1] = limit;
    known[device][0] = n;
  }
  *sms = known[device][0];
  *smem_limit = known[device][1];
  return 0;
}

// One cooperative launch of a ring kernel (`args`, which point at p among
// others) on every SM, for K3/K4 and P2/P3 alike: the ring as deep as the
// shared memory left beside the layout's fixed part (NT product columns, W
// rows of `pitch`, the attention chunks sc and cc) allows, at least 2 and
// at most kMaxStages stages, into p.stages; the kernel opened to that much
// shared memory once a device (`opened`, one array a kernel); `counters`
// bytes at p.bar zeroed on the stream first.
inline int ring_launch(const void* kernel, size_t* opened, Args& p, int NT, void** args,
                       size_t counters, int device, cudaStream_t stream) {
  int sms = 0, limit = 0;
  int code = device_info(device, &sms, &limit);
  if (code) return code;
  const size_t fixed = layout(NT, p.W, p.pitch, p.sc, p.cc, 0).total;
  if (fixed + 2 * static_cast<size_t>(kStageBytes) > static_cast<size_t>(limit))
    return static_cast<int>(cudaErrorInvalidValue);
  p.stages = static_cast<int>((limit - fixed) / kStageBytes);
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  const size_t smem = layout(NT, p.W, p.pitch, p.sc, p.cc, p.stages).total;
  cudaError_t err;
  if (opened[device] < smem) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opened[device] = smem;
  }
  err = cudaMemsetAsync(p.bar, 0, counters, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchCooperativeKernel(kernel, dim3(sms), dim3(kBlockThreads), args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K3/K4: one launch of mega_kernel<NT>.
template <int NT>
int launch(Args p, size_t work_size, int device, cudaStream_t stream) {
  if (p.sc < 1 || p.sc > kMaxChunk || static_cast<long long>(p.sc) * p.sn < p.bound ||
      p.cc < 1 || p.cc > kMaxChunk || static_cast<long long>(p.cc) * p.cn < p.T ||
      work_size < work_bytes(p.L, p.W, p.D, p.F, p.H, p.sn, p.cn, p.A, p.T))
    return static_cast<int>(cudaErrorInvalidValue);
  p.pitch = (p.D > p.F ? p.D : p.F) + 8;
  static size_t opened[64];
  void* args[] = {&p};
  return ring_launch(reinterpret_cast<const void*>(mega_kernel<NT>), opened, p, NT, args,
                     counter_bytes(p.L, p.H), device, stream);
}

// The operands both entry points share, carved out of `work` as work_bytes
// lays it out.
inline void bind(Args& p, const void* const* w16, void* x, void* work) {
  p.qkv_w = static_cast<const int8_t*>(w16[0]);
  p.o_w = static_cast<const int8_t*>(w16[1]);
  p.cq_w = static_cast<const int8_t*>(w16[2]);
  p.co_w = static_cast<const int8_t*>(w16[3]);
  p.fc1_w = static_cast<const int8_t*>(w16[4]);
  p.fc2_w = static_cast<const int8_t*>(w16[5]);
  p.smalls = static_cast<const float*>(w16[6]);
  p.lnp = static_cast<const float*>(w16[7]);
  p.emb_q = static_cast<const int8_t*>(w16[8]);
  p.emb_s = static_cast<const float*>(w16[9]);
  p.self_k = static_cast<bf16*>(const_cast<void*>(w16[10]));
  p.self_v = static_cast<bf16*>(const_cast<void*>(w16[11]));
  p.cross_k = static_cast<const int8_t*>(w16[12]);
  p.cross_v = static_cast<const int8_t*>(w16[13]);
  p.cross_ks = static_cast<const float*>(w16[14]);
  p.cross_vs = static_cast<const float*>(w16[15]);
  p.x = static_cast<bf16*>(x);
  unsigned char* b = static_cast<unsigned char*>(work);
  const size_t W = p.W, D = p.D, F = p.F;
  p.bar = reinterpret_cast<unsigned int*>(b);
  p.done = p.bar + 1;
  p.qkv = reinterpret_cast<bf16*>(b + counter_bytes(p.L, p.H));
  p.att = p.qkv + W * 3 * D;
  p.hid = p.att + W * D;
  p.cq = reinterpret_cast<float*>(p.hid + W * F);
  p.spart = p.cq + W * D;
  p.cpart = p.spart + static_cast<size_t>(kPart) * W * p.H * p.sn;
  p.ascore = p.cpart + static_cast<size_t>(kPart) * W * p.H * p.cn;
  p.phases = 8 * p.L + 1;
}

// What both entry points refuse: D == 64 H, D and F multiples of 128,
// 1 <= W <= kMaxW, a bound on the window's end inside the cache.
inline bool shapes_ok(int L, int D, int F, int H, int V, int S, int T, int W, int bound) {
  return L >= 1 && D == H * kDh && D % 128 == 0 && F % 128 == 0 && V >= 1 && T >= 1 && W >= 1 &&
         W <= kMaxW && bound >= W && bound <= S;
}

}  // namespace engine

}  // namespace
