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
// corrected), so the kernel keeps those tile boundaries: the row max of all
// 512 scores of a tile is known before any p of it is made. (Every p <= 0,
// so l <= 0 and the division is by 1; `row_sums` lets a caller read l.)
//
// Bound on the H100: operations. 4 S^2 dh per (batch, head) against 4 S dh
// elements moved: 386.5 GFLOP at B = 32, H = 20, S = 1536, 0.39 ms at the
// 989 TFLOP/s bf16 tensor-core rate.
//
// bf16 (the probe's type): K2's TMA + wgmma pipeline (tc_common.cuh). One
// block per (batch x head, 192 query rows): a producer warpgroup, one thread
// of which loads the Q tile once and 128-key subtiles of K and V by TMA
// into rings of eight K stages (two 512-key tiles) and four V stages, and
// three consumer warpgroups of 64 query rows (setmaxnreg moves the
// producer's registers to them). A consumer runs each 512-key tile in two
// passes over its four K subtiles, which stay in shared memory for both:
// pass A makes S = Q K^T (wgmma m64n128k16) of each and keeps only the row
// max; pass B makes the same products again (the same instructions on the
// same operands, so the same f32 scores), then p = s - m_new and l in f32
// on the accumulator fragments, p rounded to bf16 in registers as the A
// operand of O += P V (m64n64k16, V transposed from shared memory). A tile
// thus costs 1.5 times the function's operations, in exchange for keeping
// no scores and reading K/V from L2 once per 192 rows (a split of each
// tile's keys over the consumers would read them once per 64 rows). A
// consumer waits for each of its products, so it never holds S, P and O at
// once (S + O is 96 registers a thread, P V's operand 32 more): ptxas then
// neither spills nor serializes the wgmma k-steps, which it did when a
// consumer issued P V with the next score product as K2 does. The three
// consumers run freely; while one waits or does its bookkeeping, the
// others' products keep the tensor cores busy. Rows past S arrive as zeros
// and are not written.
//
// f32 (exact f32, no TF32): on the CUDA cores, whose 67 TFLOP/s f32 rate
// is its ceiling. One block per (batch x head, 64 query rows), 256 threads,
// four a query row; q's row stays in registers. A tile's 64 x 512 f32
// scores live in shared memory (129 KB). First pass: 64-key chunks of K
// staged; thread (row, c) makes the scores of keys c, c + 4, ... of each
// chunk, and the four threads of a row combine their maxima by shuffles.
// Second pass: 64-key chunks of V staged; thread (row, c) owns the float4
// chunks c, c + 4, c + 8, c + 12 of the output row and sums p[row, key]
// v[key] over the tile's keys in order. Row strides are padded by four
// floats so that neither pass has bank conflicts.

#include <math.h>

#include "tc_common.cuh"

namespace {

constexpr int kTile = 512;  // keys a tile (the probe's block_k)
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// f32: CUDA cores.

constexpr int kRows = 64;                // query rows a block
constexpr int kChunk = 64;               // keys staged at a time
constexpr int kThreads = 4 * kRows;
constexpr int kStride = kDh + 4;         // floats a staged K/V row
constexpr int kScoreStride = kTile + 4;  // floats a score row

// dst (kChunk, kStride) = the kChunk contiguous (64)-rows at src.
__device__ void stage(const float* __restrict__ src, float* dst) {
  for (int i = threadIdx.x; i < kChunk * kDh; i += kThreads)
    dst[(i / kDh) * kStride + i % kDh] = src[i];
}

constexpr size_t kF32Smem = sizeof(float) * (kRows * kScoreStride + kChunk * kStride);

__global__ void __launch_bounds__(kThreads)
attention_control_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ row_sums, int S) {
  extern __shared__ __align__(16) float smem[];
  float* sc = smem;                           // (kRows, kScoreStride)
  float* kv = smem + kRows * kScoreStride;    // (kChunk, kStride)
  const int r = threadIdx.x >> 2, c = threadIdx.x & 3;
  const size_t head = static_cast<size_t>(blockIdx.y) * S * kDh;
  const size_t row = head + static_cast<size_t>(blockIdx.x * kRows + r) * kDh;
  float* my_scores = sc + r * kScoreStride;

  float qr[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) qr[d] = q[row + d];
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
        const float* vr = kv + key * kStride;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 w = *reinterpret_cast<const float4*>(vr + 4 * (c + 4 * i));
          acc[4 * i + 0] = fmaf(p, w.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(p, w.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, w.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, w.w, acc[4 * i + 3]);
        }
      }
    }
    m = m_new;
  }

  const float denom = fmaxf(l, 1.0f);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[row + 4 * (c + 4 * i) + e] = acc[4 * i + e] / denom;
  if (row_sums != nullptr && c == 0) row_sums[row / kDh] = l;
}

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma.

constexpr int kConsumers = 3;  // warpgroups of 64 query rows
constexpr int kBlockQ = 64 * kConsumers;
constexpr int kSub = kTile / kKeyTile;  // K/V subtiles a tile
constexpr int kKStages = 2 * kSub;      // two tiles of K
constexpr int kVStages = 4;
constexpr int kTcThreads = 128 * (kConsumers + 1);  // producer, consumers
// Registers a thread after setmaxnreg: the consumers hold S, P and O.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;
static_assert(128 * (kProducerRegs + kConsumers * kConsumerRegs) <= 65536, "registers");
constexpr int kRowBytes = kDh * 2;
constexpr int kSubBytes = kKeyTile * kRowBytes;  // one K or V subtile, 16 KB
constexpr int kQBytes = kBlockQ * kRowBytes;
constexpr int kBars = 1 + 2 * kKStages + 2 * kVStages;
constexpr int kTcSmem = kQBytes + (kKStages + kVStages) * kSubBytes + 1024 + 8 * kBars;
static_assert(kTcSmem <= 232448, "shared memory");

// Shared memory from the block's 1024-aligned base: the Q tile, the K ring
// (kKStages subtiles; subtile i of the sequence in stage i % kKStages), the
// V ring, then the mbarriers (q_full, k_full[], k_empty[], v_full[],
// v_empty[]). The consumers address it through one 32-bit register.
constexpr int kKOff = kQBytes;
constexpr int kVOff = kKOff + kKStages * kSubBytes;
constexpr int kBarOff = kVOff + kVStages * kSubBytes;

struct Smem {
  uint32_t base;
  __device__ __forceinline__ uint32_t k(int i) const {
    return base + kKOff + (i % kKStages) * kSubBytes;
  }
  __device__ __forceinline__ uint32_t v(int i) const {
    return base + kVOff + (i % kVStages) * kSubBytes;
  }
  __device__ __forceinline__ uint32_t bar(int n) const { return base + kBarOff + 8 * n; }
  __device__ __forceinline__ uint32_t k_full(int i) const { return bar(1 + i % kKStages); }
  __device__ __forceinline__ uint32_t k_empty(int i) const {
    return bar(1 + kKStages + i % kKStages);
  }
  __device__ __forceinline__ uint32_t v_full(int i) const {
    return bar(1 + 2 * kKStages + i % kVStages);
  }
  __device__ __forceinline__ uint32_t v_empty(int i) const {
    return bar(1 + 2 * kKStages + kVStages + i % kVStages);
  }
};

// Waits for the phase of parity `parity` of the mbarrier at `bar`; a wait
// of 2 s traps, so a ring out of step fails the launch instead of hanging.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (t0 == 0) t0 = now;
    if (now - t0 > 2000000000ull) __trap();
  }
}

// S = Q K^T of one K subtile; back once S is ready.
__device__ __forceinline__ void qk_now(float (&s)[64], uint64_t q_desc, uint32_t k_tile) {
  issue_qk(s, q_desc, sw128_desc(k_tile));
  wgmma_wait_all();
  fence_regs(s);
}

// O += P V of one V subtile; back once it is done (p is free).
__device__ __forceinline__ void pv_now(float (&o)[32], const uint32_t (&p)[8][4],
                                       uint32_t v_tile) {
  issue_pv(o, p, sw128_desc(v_tile));
  wgmma_wait_all();
  fence_regs(o);
}

// tmax[i] = max(tmax[i], this thread's 32 scores of row r0 + 8 i). A thread
// holds rows r0 (accumulator index bit 1 clear) and r0 + 8.
__device__ __forceinline__ void row_max(const float (&s)[64], float (&tmax)[2]) {
  float part[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[i][c] = -INFINITY;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    float& a = part[(j >> 1) & 1][(j >> 2) & 3];
    a = fmaxf(a, s[j]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    tmax[i] = fmaxf(tmax[i], fmaxf(fmaxf(part[i][0], part[i][1]), fmaxf(part[i][2], part[i][3])));
}

// p = s - m_new in place and l += p, in f32 (p before it is rounded).
__device__ __forceinline__ void sub_max(float (&s)[64], const float (&mn)[2], float (&l)[2]) {
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    s[j] -= mn[(j >> 1) & 1];
    l[(j >> 1) & 1] += s[j];
  }
}

// p rounded to bf16 (the plain version's rounding point) as the A
// fragments of P V.
__device__ __forceinline__ void round_p(const float (&s)[64], uint32_t (&p)[8][4]) {
  to_bf16(s, p);
}

// Pass A of the tile whose first subtile is i0: the row max of its 512
// scores (this thread's part, in tmax).
__device__ __forceinline__ void pass_a(float (&s)[64], float (&tmax)[2], const Smem& sm,
                                       uint64_t q_desc, int i0) {
  tmax[0] = tmax[1] = -INFINITY;
#pragma unroll 1
  for (int i = i0; i < i0 + kSub; ++i) {
    wait_phase(sm.k_full(i), (i / kKStages) & 1);
    qk_now(s, q_desc, sm.k(i));
    row_max(s, tmax);
  }
}

// Pass B of the tile whose first subtile is i0: the same four score
// products again, each made into p (against the tile's m_new) and l, p
// rounded to bf16 and O += P V. A K stage is released once its second
// product is done, a V stage once its product is.
__device__ __forceinline__ void pass_b(float (&s)[64], float (&o)[32], uint32_t (&p)[8][4],
                                       float (&l)[2], const float (&mn)[2], const Smem& sm,
                                       uint64_t q_desc, int i0) {
  const uint32_t kb = sm.k(i0);  // the tile's K stages, in order
#pragma unroll 1
  for (int j = 0; j < kSub; ++j) {
    const int i = i0 + j;
    qk_now(s, q_desc, kb + j * kSubBytes);
    mbar_arrive(sm.k_empty(i));
    sub_max(s, mn, l);
    round_p(s, p);
    wait_phase(sm.v_full(i), (i / kVStages) & 1);
    pv_now(o, p, sm.v(i));
    mbar_arrive(sm.v_empty(i));
  }
}

__global__ void __launch_bounds__(kTcThreads, 1)
attention_control_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map, int q_perm, int k_perm,
                            int v_perm, __nv_bfloat16* __restrict__ out,
                            float* __restrict__ row_sums, int S, int H) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: tiles start on that.
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + kBarOff);
  const Smem sm = {smem_u32(base)};

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int n_sub = S / kKeyTile;

  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);  // q_full
    for (int st = 0; st < kKStages; ++st) {
      mbar_init(&bars[1 + st], 1);
      mbar_init(&bars[1 + kKStages + st], 128 * kConsumers);  // every consumer thread
    }
    for (int st = 0; st < kVStages; ++st) {
      mbar_init(&bars[1 + 2 * kKStages + st], 1);
      mbar_init(&bars[1 + 2 * kKStages + kVStages + st], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // Producer warpgroup: one thread issues every TMA load. The first
    // tile's K, then V subtile i followed by K subtile i + kSub (the next
    // tile's), so the next tile's K arrives while this one's pass B runs.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 0 && lane == 0) {
      const int b = bh / H;
      const int h = bh - b * H;
      auto load = [&](int off, int full, int empty, int stages, const CUtensorMap* map, int perm,
                      int i) {
        const int st = i % stages;
        if (i >= stages) wait_phase(sm.bar(empty + st), ((i / stages) - 1) & 1);
        mbar_expect_tx(&bars[full + st], kSubBytes);
        load_rows(base + off + st * kSubBytes, map, perm, i * kKeyTile, h, b, &bars[full + st]);
      };
      mbar_expect_tx(&bars[0], kQBytes);
      load_rows(base, &q_map, q_perm, q0, h, b, &bars[0]);
      for (int i = 0; i < kSub; ++i) load(kKOff, 1, 1 + kKStages, kKStages, &k_map, k_perm, i);
      for (int i = 0; i < n_sub; ++i) {
        load(kVOff, 1 + 2 * kKStages, 1 + 2 * kKStages + kVStages, kVStages, &v_map, v_perm, i);
        if (i + kSub < n_sub)
          load(kKOff, 1, 1 + kKStages, kKStages, &k_map, k_perm, i + kSub);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    // Consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63. In the
    // accumulator fragments a thread holds rows r0 and r0 + 8 and, for each
    // n8 column block c, columns 8 c + 2 (lane % 4) and the one after. The
    // three consumers run freely: while one waits for its product or does
    // its bookkeeping, the others' products keep the tensor cores busy.
    const int wg = warp / 4 - 1;
    const uint64_t q_desc = sw128_desc(sm.base + wg * 64 * kRowBytes);

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    float m[2] = {-1e9f, -1e9f};  // the max of the tiles before
    float l[2] = {0.0f, 0.0f};    // this thread's part of the row sum
    float s[64], tmax[2], mn[2];
    uint32_t p[8][4];

    wait_phase(sm.bar(0), 0);
    for (int i0 = 0; i0 < n_sub; i0 += kSub) {
      pass_a(s, tmax, sm, q_desc, i0);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(kFull, tmax[i], 1));
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(kFull, tmax[i], 2));
        mn[i] = fmaxf(m[i], tmax[i]);
      }
      pass_b(s, o, p, l, mn, sm, q_desc, i0);
      m[0] = mn[0];
      m[1] = mn[1];
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(kFull, l[i], 1);
      l[i] += __shfl_xor_sync(kFull, l[i], 2);
    }
    const int r0 = (warp % 4) * 16 + lane / 4;
    const int cq = 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wg * 64 + r0 + 8 * i;
      if (row >= S) continue;
      const float denom = fmaxf(l[i], 1.0f);
      const size_t at = static_cast<size_t>(bh) * S + row;
      __nv_bfloat16* op = out + at * kDh;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<__nv_bfloat162*>(op + 8 * c + cq) =
            __floats2bfloat162_rn(o[4 * c + 2 * i] / denom, o[4 * c + 2 * i + 1] / denom);
      if (row_sums != nullptr && cq == 0) row_sums[at] = l[i];
    }
  }
}

}  // namespace

// q, k, v, out: contiguous (B, H, S, 64) device tensors of one type (dtype 0
// = f32, 1 = bf16, whose base pointers must be 16-byte aligned for TMA); S a
// multiple of 512. row_sums: null or a (B, H, S) f32 device tensor that
// receives each row's l. Returns cudaGetLastError() (cudaErrorInvalidValue
// for shapes it does not take, a misaligned bf16 operand or a tensor map
// the driver refuses).
extern "C" int twt_attention_control(const void* q, const void* k, const void* v, void* out,
                                     void* row_sums, int dtype, int B, int H, int S, int dh,
                                     int device, void* stream) {
  const long long bh = static_cast<long long>(B) * H;
  if (dh != kDh || B < 1 || H < 1 || bh > 65535 || S < kTile || S % kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sums = static_cast<float*>(row_sums);
  if (dtype == 1) {
    // (B, H, S, 64) contiguous as make_map's (B, S, H) view: strides in
    // elements of the batch, sequence and head dims.
    const long long sb = static_cast<long long>(H) * S * kDh, ss = kDh, sh = 1LL * S * kDh;
    if (!aligned16(q, sb, ss, sh) || !aligned16(k, sb, ss, sh) || !aligned16(v, sb, ss, sh))
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap maps[3];
    int perms[3];
    if (!make_map(&maps[0], &perms[0], q, B, S, H, sb, ss, sh, kBlockQ) ||
        !make_map(&maps[1], &perms[1], k, B, S, H, sb, ss, sh, kKeyTile) ||
        !make_map(&maps[2], &perms[2], v, B, S, H, sb, ss, sh, kKeyTile))
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(attention_control_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S + kBlockQ - 1) / kBlockQ, static_cast<unsigned>(bh));
    attention_control_tc_kernel<<<grid, kTcThreads, kTcSmem, st>>>(
        maps[0], maps[1], maps[2], perms[0], perms[1], perms[2],
        static_cast<__nv_bfloat16*>(out), sums, S, H);
  } else {
    err = cudaFuncSetAttribute(attention_control_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kF32Smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attention_control_kernel<<<dim3(S / kRows, static_cast<unsigned>(bh)), kThreads, kF32Smem,
                               st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                     static_cast<const float*>(v), static_cast<float*>(out),
                                     sums, S);
  }
  return static_cast<int>(cudaGetLastError());
}
