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
// ragged tile is masked here instead of padded to 512 as on the TPU). The
// output is written in the input type, (B, S, H, 64) contiguous.
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
// f32 (the "XL32" size and the f32 references, which need f32 results,
// so no TF32): on the CUDA cores, whose 67 TFLOP/s f32 rate is its ceiling.
// One block per (batch x head, tile of 128 queries); 256 threads, two per
// query, each owning half of the 64 dims in interleaved float4 chunks so
// the pair's shared-memory reads never collide. The block walks 32-key
// tiles of K and V staged in shared memory as f32; a thread's q, its 32
// scores and its output accumulator stay in registers, and the pair
// combines its partial dot products with one shuffle. Scores are kept in
// the log2 domain for exp2f.

#include <math.h>
#include <stdint.h>

#include <cuda.h>
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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma.

constexpr int kConsumers = 3;                      // warpgroups of 64 query rows
constexpr int kTcBlockQ = 64 * kConsumers;
constexpr int kTcBlockK = 128;                     // keys a tile
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// One box (rows x 64 bf16) of a 4-D tensor map into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a tile of 128-byte rows in the 128-byte
// swizzle TMA writes: 8-row atoms of 1024 bytes (stride byte offset); the
// leading byte offset is unused for K-major and, with 64 columns (one atom
// wide), for MN-major too, so it is set to the atom stride as well.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// The consumers take turns on the tensor cores: warpgroup w waits on named
// barrier 1 + w, which the warpgroup before it arrives on after issuing its
// products (two warpgroups, 256 threads, a barrier).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the wgmma issue and wait points (ptxas serializes the wgmmas
// otherwise).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d(64 x 128, f32) (+)= A(64 x 16) B(16 x 128): both operands in shared
// memory, K-major.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d(64 x 64, f32) += A(64 x 16, bf16 registers) B(16 x 64): B in shared
// memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2**x (ex2.approx: 2 ulp, 0 for -inf, 1 for 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Which tensor-map dimension (1..3) holds the sequence, head and batch index
// of one operand: the C entry point orders them by stride. Packed 2 bits
// each as s | h << 2 | b << 4, values 0..2 for map dims 1..3; coord(perm,
// d, ...) is the coordinate of map dimension 1 + d.
__device__ __forceinline__ int coord(int perm, int d, int row, int h, int b) {
  return ((perm & 3) == d) ? row : (((perm >> 2) & 3) == d) ? h : b;
}

__device__ __forceinline__ void load_rows(void* dst, const CUtensorMap* map, int perm, int row,
                                          int h, int b, uint64_t* bar) {
  tma_load(dst, map, 0, coord(perm, 0, row, h, b), coord(perm, 1, row, h, b),
           coord(perm, 2, row, h, b), bar);
}

// S (64 x 128, f32) = Q K^T for one warpgroup: four k-steps of 16 dims.
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t q_desc, uint64_t k_desc) {
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk)  // 32 bytes of each row a step
    wgmma_qk(s, q_desc + 2 * kk, k_desc + 2 * kk, kk > 0);
  wgmma_commit();
  fence_regs(s);
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

// O (64 x 64, f32) += P V for one warpgroup: eight k-steps of 16 keys,
// 2048 bytes of V apart.
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[8][4],
                                         uint64_t v_desc) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kTcBlockK / 16; ++kk) wgmma_pv(o, p[kk], v_desc + 128 * kk);
  wgmma_commit();
  fence_regs(o);
}

// P in bf16 as the A fragments of P V: accumulator columns 16 kk .. 16 kk +
// 15 are k-step kk's fragment, registers (j / 2) % 4 in the order a0..a3.
__device__ __forceinline__ void to_bf16(const float (&s)[64], uint32_t (&p)[8][4]) {
#pragma unroll
  for (int j = 0; j < 64; j += 2) p[j / 8][(j / 2) % 4] = pack_bf16(s[j], s[j + 1]);
}

__global__ void __launch_bounds__(kTcThreads, 1)
encoder_attention_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map, int q_perm, int k_perm,
                            int v_perm, __nv_bfloat16* __restrict__ out, int S, int H,
                            int valid_len, float scale_log2) {
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

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver: the library links only the
// runtime, so the driver entry point is looked up once.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A 4-D map (dh, then the sequence, head and batch dims in increasing stride
// order) over one (B, S, H, 64) bf16 operand, boxes of box_rows x 64, the
// 128-byte swizzle, rows past S read as zeros. Returns false if the driver
// refuses it; *perm receives the dimension order (see coord()).
bool make_map(CUtensorMap* map, int* perm, const void* ptr, int B, int S, int H, long long sb,
              long long ss, long long sh, int box_rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  long long strides[3] = {ss, sh, sb};  // roles: 0 = s, 1 = h, 2 = b
  int sizes[3] = {S, H, B};
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (strides[order[j]] < strides[order[i]]) {
        const int tmp = order[i];
        order[i] = order[j];
        order[j] = tmp;
      }
  cuuint64_t dims[4] = {kDh, 0, 0, 0};
  cuuint64_t gstrides[3];
  cuuint32_t box[4] = {kDh, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  int pos[3];
  for (int d = 0; d < 3; ++d) {
    const int role = order[d];
    pos[role] = d;
    dims[1 + d] = static_cast<cuuint64_t>(sizes[role]);
    gstrides[d] = static_cast<cuuint64_t>(strides[role]) * 2;
    if (role == 0) box[1 + d] = box_rows;
  }
  *perm = pos[0] | (pos[1] << 2) | (pos[2] << 4);
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                gstrides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p, long long sb, long long ss, long long sh) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (sb * 2) % 16 == 0 &&
         (ss * 2) % 16 == 0 && (sh * 2) % 16 == 0;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Strides are in elements. 1 <= valid_len <= S.
// bf16 needs 16-byte-aligned base pointers and strides (TMA).
// Returns cudaGetLastError() (cudaErrorInvalidValue for dh != 64, a
// misaligned bf16 operand or a tensor map the driver refuses).
extern "C" int twt_encoder_attention(const void* q, const void* k, const void* v, void* out,
                                     int dtype, int B, int S, int H, int dh,
                                     long long q_sb, long long q_ss, long long q_sh,
                                     long long k_sb, long long k_ss, long long k_sh,
                                     long long v_sb, long long v_ss, long long v_sh,
                                     int valid_len, int device, void* stream) {
  if (dh != kDh || valid_len < 1 || valid_len > S) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (!aligned16(q, q_sb, q_ss, q_sh) || !aligned16(k, k_sb, k_ss, k_sh) ||
        !aligned16(v, v_sb, v_ss, v_sh))
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap maps[3];
    int perms[3];
    if (!make_map(&maps[0], &perms[0], q, B, S, H, q_sb, q_ss, q_sh, kTcBlockQ) ||
        !make_map(&maps[1], &perms[1], k, B, S, H, k_sb, k_ss, k_sh, kTcBlockK) ||
        !make_map(&maps[2], &perms[2], v, B, S, H, v_sb, v_ss, v_sh, kTcBlockK))
      return static_cast<int>(cudaErrorInvalidValue);
    // The shared-memory opt-in is per device; set it on every call (a
    // host-side attribute write, no device work).
    err = cudaFuncSetAttribute(encoder_attention_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S + kTcBlockQ - 1) / kTcBlockQ, B * H);
    // 64 ** -0.5 (exact) times log2(e): scores go straight to ex2.
    encoder_attention_tc_kernel<<<grid, kTcThreads, kTcSmem, st>>>(
        maps[0], maps[1], maps[2], perms[0], perms[1], perms[2],
        static_cast<__nv_bfloat16*>(out), S, H, valid_len, 0.125f * kLog2e);
  } else {
    const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
    const float scale = 0.125f;  // 64 ** -0.5, exact
    encoder_attention_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), S, H,
        q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, valid_len, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
