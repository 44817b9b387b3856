// Q4: the int4 weight-only linear of the "S4" decoder, y = x W^T (+ b), with
// W kept as packed two's-complement nibbles and one f32 scale a row.
//
// It replaces no Pallas kernel. The JAX package runs an S4 linear as an XLA
// fusion (thewhisper_tpu/models/whisper.py:110-123, `_linear`): the
// jnp.int4 leaf, which XLA packs two nibbles a byte in HBM, is converted,
// scaled and contracted in one fusion. PyTorch has no product over packed
// nibbles, and dequantizing the whole weight before a library product would
// read the packed weight, write a bf16 copy four times its size and read it
// again: more bytes than the int8 mode, where S4's only point is fewer.
//
// Rounding (JAX's bf16 `_linear`): each weight is bf16(q) * bf16(s) rounded
// to bf16, two fma.rn.bf16x2 (q = (128 + (n ^ 8)) - 136 exactly, then q * s
// with one rounding); the product is summed in f32, rounded to bf16, then
// the bias added and rounded again. Every route dequantizes bit for bit
// alike; only the order of the f32 sum differs between them.
//
// Two bf16 routes, which ops/int4_linear.py `plan()` picks by M, and the f32
// route of the small f32 S4 models:
//
// 1. Decode (the decode step's M = 1-32 rows). Bound by the packed weight's
//    bytes (a large-v3 layer's six linears hold 11.5 MB against a few KB of
//    x), and at these sizes by the latency of each launch: a launch that
//    moves 0.8-3.3 MB takes a few microseconds, most of it waiting on
//    memory. So every lane issues every 16-byte load of its weight before
//    its first product, before pdl_wait (no kernel on the path writes the
//    packed weights or the scales), and x is read straight from L2: one
//    round trip to memory a launch. A block owns 16 output rows; its W
//    warps take the block's 128-column k-blocks kb0 + p, kb0 + p + W, ...
//    (at most KPW each, held in registers), and the block adds the warps'
//    sums in warp order through shared memory. Where K has more than 10
//    k-blocks (fc2's 5120), a cluster of `split` blocks splits K
//    (split-K): after a cluster barrier, rank r adds the blocks' partials
//    in rank order 0 .. split - 1 through distributed shared memory for its
//    share of the outputs. The order is fixed, with no atomics and no
//    workspace, so an output is bitwise equal from run to run and from a
//    CUDA-graph replay. Products on mma.sync m16n8k16 with the weight rows
//    as the m16 operand and 8 x rows as n8 (M-tiles of 8 NT rows, NT 1 or 4,
//    the weight registers reused across M-tiles): one mask of a packed word
//    gives the pairs (k + j, k + j + 4), so x's pairs are permuted alike
//    with __byte_perm. Each 128-column block's sum starts from zero in the
//    mma and is added to the f32 total (the tensor core truncates its own
//    additions).
// 2. Tiled (M above the crossover: the cross K/V's B x 1500 rows, the
//    prefill, beams). Bound by the products at B x 1500. A block is a GEMM
//    tile of 128 output rows x BN x rows (BN 32 up to 256 rows, else 128):
//    one producer warp keeps a ring of stages of 128 k-columns full with
//    TMA (x as two 64-column boxes in the 128-byte swizzle, the packed
//    weight tile beside it), and two consumer warpgroups, 64 output rows
//    each, dequantize each packed tile once from shared memory into the
//    register-resident A operand of wgmma m64nBNk16 (W is K-major) against
//    the staged x tile as B (K-major), so each weight is dequantized once
//    per block and used for BN x rows, and each x tile is read once per
//    block and used for 128 output rows. Each stage's product starts from
//    zero and is added to an f32 total. Rows past M or N read zeros (TMA)
//    and are not stored. With 32-row tiles a cluster of `split` blocks may
//    split K's stages, reduced as in the decode route.
// 3. f32 x (the small f32 S4 models of the card parity runs): a block of 16
//    rows whose warps split K, the loads on the CUDA cores, q * s rounded
//    to f32, f32 fused multiply-adds, M-tiles spread over grid.y.
//
// The decode and tiled routes launch with programmatic dependent launch
// when asked (launch_common.cuh): each calls pdl_trigger at entry and reads
// x, and writes y, only after pdl_wait. Capture-safe: no synchronisation,
// no allocation, the caller's stream. Needs N % 16 == 0, K % 128 == 0
// (every Whisper width) and 16-byte-aligned x and W; ops/int4_linear.py
// checks them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch_common.cuh"
#include "tc_common.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kRows = 16;      // output rows of a decode (and f32) block
constexpr int kBlockK = 128;   // k columns a warp takes at a time: 64 bytes a row
constexpr int kMaxWarps = 8;   // warps of an f32 block
// Warps of a decode block: 16 where a thread's state fits 128 registers
// (M-tiles of 8 rows, at most 2 k-blocks a warp), else 8.
__host__ __device__ constexpr int decode_warps(int nt, int kpw) {
  return nt == 1 && kpw <= 2 ? 16 : 8;
}
constexpr int kMaxKpw = 4;     // k-blocks a decode warp holds in registers
constexpr int kMaxSplit = 8;   // blocks of a cluster (the portable limit)

// The tiled route's geometry: a block is 128 output rows by BN x rows
// (32 or 128, the wgmma n).
constexpr int kTileN = 128;                       // output rows a block
constexpr int kStageK = 128;                      // k columns a stage
constexpr int kWTile = kTileN * kStageK / 2;      // the packed weight tile: 8 KB
constexpr int kTiledThreads = 288;                // two consumer warpgroups + a producer warp
// One 64-column box of x (BN rows of 128 bytes), a stage (two boxes and the
// weight tile: 16 or 40 KB, multiples of 1024), the ring's stages (6 of 16
// KB, two blocks an SM; 4 of 40, one) and the dynamic shared memory of a
// block.
__host__ __device__ constexpr int x_box(int bn) { return bn * 128; }
__host__ __device__ constexpr int stage_bytes(int bn) { return 2 * x_box(bn) + kWTile; }
__host__ __device__ constexpr int ring_stages(int bn) { return bn == 32 ? 6 : 4; }
__host__ __device__ constexpr int tiled_smem(int bn) {
  return 1024 + ring_stages(bn) * stage_bytes(bn) + 2 * ring_stages(bn) * 8;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// d = a * b + c on bf16 pairs, each half rounded once to nearest even.
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// bf16(s) in both halves.
__device__ __forceinline__ uint32_t splat_bf16(float s) {
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(s));
  return h | (h << 16);
}

// Two nibbles n (bits 0-3 and 16-19 of v, the rest ignored) dequantized as
// bf16(q) * s2, rounded to bf16, q the nibble as a signed int4.
__device__ __forceinline__ uint32_t dequant_pair(uint32_t v, uint32_t s2) {
  // 0x4300 | (n ^ 8) is the bf16 128 + (n ^ 8); less 136 it is q, exactly.
  const uint32_t m = (v & 0x000F000Fu) ^ 0x43084308u;
  const uint32_t q = fma_bf16x2(m, 0x3F803F80u, 0xC308C308u);  // m * 1 - 136
  return fma_bf16x2(q, s2, 0x80008000u);                         // q * s - 0
}

// The 8 nibbles of w (nibble j at bits 4j is k + j) dequantized: pair j
// (0 .. 3) holds k + j in its low half and k + j + 4 in its high half.
__device__ __forceinline__ void dequant_bf16(uint32_t w, uint32_t s2, uint32_t (&p)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) p[j] = dequant_pair(w >> (4 * j), s2);
}

// Byte t of w (inputs 2t and 2t + 1 of the word) dequantized in input
// order: 2t in the low half. `sel` is t | (4 + t) << 8: byte t of w and of
// w >> 4, whose low nibbles are the byte's two.
__device__ __forceinline__ uint32_t dequant_byte(uint32_t w, uint32_t sel, uint32_t s2) {
  return dequant_pair(__byte_perm(w, w >> 4, sel), s2);
}

// x[k .. k + 7] (one uint4 of bf16) as the pairs dequant_bf16 makes.
__device__ __forceinline__ void pair_x(const uint4& v, uint32_t (&b)[4]) {
  b[0] = __byte_perm(v.x, v.z, 0x5410);  // (k, k + 4)
  b[1] = __byte_perm(v.x, v.z, 0x7632);  // (k + 1, k + 5)
  b[2] = __byte_perm(v.y, v.w, 0x5410);  // (k + 2, k + 6)
  b[3] = __byte_perm(v.y, v.w, 0x7632);  // (k + 3, k + 7)
}

// The 8 nibbles of w dequantized as f32: q * s rounded to f32.
__device__ __forceinline__ void dequant_f32(uint32_t w, float s, float (&v)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // 0x4B000000 | (n ^ 8) is the float 2^23 + (n ^ 8); less 2^23 + 8 it is q.
    const float q = __uint_as_float(((w >> (4 * j)) & 0xFu) ^ 0x4B000008u) - 8388616.0f;
    v[j] = __fmul_rn(q, s);
  }
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The product rounded to the output type, then the bias added and rounded.
template <typename T>
__device__ __forceinline__ T epilogue(float sum, const T* __restrict__ bias, int f) {
  if constexpr (sizeof(T) == 2) {
    const float p = __bfloat162float(__float2bfloat16_rn(sum));
    return __float2bfloat16_rn(bias ? p + __bfloat162float(bias[f]) : p);
  } else {
    return bias ? sum + bias[f] : sum;
  }
}

// Entry i of the cluster's partials added in rank order 0 .. split - 1; all
// the ranks' loads are issued before the first add.
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster, const float* part, int i,
                                             int split) {
  float v[kMaxSplit];
#pragma unroll
  for (int s = 0; s < kMaxSplit; ++s) v[s] = s < split ? cluster.map_shared_rank(part, s)[i] : 0.0f;
  float sum = v[0];
#pragma unroll
  for (int s = 1; s < kMaxSplit; ++s)
    if (s < split) sum += v[s];
  return sum;
}

// ---------------------------------------------------------------------------
// Route 1: decode.
// ---------------------------------------------------------------------------

// Block (rank, b) of a cluster of `split` along x: output rows f0 = 16 b ..
// f0 + 15 and k-blocks kb0 .. kb1 - 1 of the cluster's K. Its W warps:
// warp p takes k-blocks kb0 + p, kb0 + p + W, ... (at most KPW), which each
// lane holds in registers from before pdl_wait; x is read straight from
// global memory (L2).
template <int NT, int KPW>
__global__ void __launch_bounds__(32 * decode_warps(NT, KPW))
q4_decode_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ scale, const bf16* __restrict__ bias,
                 bf16* __restrict__ y, int M, int N, int K, int split) {
  constexpr int kTile = 8 * NT;
  __shared__ float red[16][kRows * kTile];  // the warps' sums: [warp][x row][row]
  __shared__ float part[kRows * kTile];     // the block's, read by its cluster
  pdl_trigger();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int W = blockDim.x >> 5, kblocks = K / kBlockK, rank = blockIdx.x;
  const int f0 = blockIdx.y * kRows;
  const int kb0 = rank * kblocks / split, kb1 = (rank + 1) * kblocks / split;
  const size_t wpitch = static_cast<size_t>(K) / 2;
  const uint32_t sg = splat_bf16(scale[f0 + g]), sh = splat_bf16(scale[f0 + g + 8]);
  const uint8_t* wg = w + (f0 + g) * wpitch + 16 * t;
  const uint8_t* wh = wg + 8 * wpitch;
  // Lane (g, t) holds bytes 16t .. 16t + 15 of the 64 of rows g and g + 8
  // in each of its warp's k-blocks: every load issued before the first
  // product, and before pdl_wait (nothing on the path writes W).
  uint4 ag[KPW], ah[KPW];
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    const int kb = kb0 + warp + j * W;
    ag[j] = ah[j] = make_uint4(0u, 0u, 0u, 0u);
    if (kb < kb1) {
      ag[j] = __ldg(reinterpret_cast<const uint4*>(wg + kb * 64));
      ah[j] = __ldg(reinterpret_cast<const uint4*>(wh + kb * 64));
    }
  }
  pdl_wait();
  const int mtiles = (M + kTile - 1) / kTile;
  for (int mt = 0; mt < mtiles; ++mt) {
    const int n0 = mt * kTile;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      const int kb = kb0 + warp + j * W;
      if (kb >= kb1) break;
      float c[2][NT][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[h][nt][i] = 0.0f;
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        uint32_t pg[4], ph[4];
        dequant_bf16(word(ag[j], wd), sg, pg);
        dequant_bf16(word(ah[j], wd), sh, ph);
        const int k = kb * kBlockK + 32 * t + 8 * wd;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int n = n0 + 8 * nt + g;
          uint4 xv = make_uint4(0u, 0u, 0u, 0u);
          if (n < M) xv = __ldg(reinterpret_cast<const uint4*>(x + static_cast<size_t>(n) * K + k));
          uint32_t b[4];
          pair_x(xv, b);
          mma_bf16(c[0][nt], pg[0], ph[0], pg[1], ph[1], b[0], b[1]);
          mma_bf16(c[1][nt], pg[2], ph[2], pg[3], ph[3], b[2], b[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] += c[0][nt][i] + c[1][nt][i];
    }
    // Fragment: acc[nt] = (row g, x row 8 nt + 2t), (g, + 1), (g + 8, 2t),
    // (g + 8, + 1); entry 16 n + row of the sums.
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[warp][(8 * nt + 2 * t + (i & 1)) * kRows + g + 8 * (i >> 1)] = acc[nt][i];
    __syncthreads();
    // The warps' sums in warp order.
    for (int i = threadIdx.x; i < kRows * kTile; i += blockDim.x) {
      float sum = 0.0f;
      for (int v = 0; v < W; ++v) sum += red[v][i];
      const int n = n0 + i / kRows, f = f0 + i % kRows;
      if (split == 1) {
        if (n < M) y[static_cast<size_t>(n) * N + f] = epilogue(sum, bias, f);
      } else {
        part[i] = sum;
      }
    }
    if (split == 1) {
      __syncthreads();  // red is written again by the next M-tile
      continue;
    }
    // Split-K: rank r adds entries r, r + split, ... of the cluster's
    // partials in rank order.
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    for (int i = rank + split * threadIdx.x; i < kRows * kTile; i += split * blockDim.x) {
      const float sum = cluster_sum(cluster, part, i, split);
      const int n = n0 + i / kRows, f = f0 + i % kRows;
      if (n < M) y[static_cast<size_t>(n) * N + f] = epilogue(sum, bias, f);
    }
    cluster.sync();  // no block rewrites part, or exits, while another reads it
  }
}

// ---------------------------------------------------------------------------
// Route 2: tiled.
// ---------------------------------------------------------------------------

// One box of a 2-D tensor map into shared memory.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// d(64 x 128, f32) (+)= A(64 x 16, bf16 registers) B(16 x 128): B in
// shared memory, K-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d(64 x 32, f32) (+)= A(64 x 16, bf16 registers) B(16 x 32), as above.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The A fragments of four k-steps (64 columns: 32 bytes of rows r and r + 8,
// at wr and wr + 8 rows of the tile): step s's registers are (r, 2t..2t+1),
// (r + 8, 2t..), (r, 2t + 8..), (r + 8, 2t + 8..), inputs 16s + those, which
// are byte t of the row's words 2s and 2s + 1.
__device__ __forceinline__ void dequant_steps(const uint8_t* wr, uint32_t sel, uint32_t sg,
                                              uint32_t sh, uint32_t (&a)[4][4]) {
  const uint4 g0 = *reinterpret_cast<const uint4*>(wr);
  const uint4 g1 = *reinterpret_cast<const uint4*>(wr + 16);
  const uint4 h0 = *reinterpret_cast<const uint4*>(wr + 8 * 64);
  const uint4 h1 = *reinterpret_cast<const uint4*>(wr + 8 * 64 + 16);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const uint4& gv = s < 2 ? g0 : g1;
    const uint4& hv = s < 2 ? h0 : h1;
    const int i = 2 * (s & 1);
    a[s][0] = dequant_byte(word(gv, i), sel, sg);
    a[s][1] = dequant_byte(word(hv, i), sel, sh);
    a[s][2] = dequant_byte(word(gv, i + 1), sel, sg);
    a[s][3] = dequant_byte(word(hv, i + 1), sel, sh);
  }
}

// Block (rank, tile) of a cluster of `split` along x: output rows f0 ..
// f0 + 127 of tile blockIdx.x / split, x rows n0 .. n0 + BN - 1, and the
// cluster rank's share of the K / 128 stages. With split > 1 each block
// leaves its f32 sums in shared memory and rank r adds entries r, r +
// split, ... of the cluster's in rank order.
template <int BN>
__global__ void __launch_bounds__(kTiledThreads, 1)
q4_tiled_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                const float* __restrict__ scale, const bf16* __restrict__ bias,
                bf16* __restrict__ y, int M, int N, int K, int split) {
  constexpr int kBox = x_box(BN), kStage = stage_bytes(BN), kAcc = BN / 2;
  constexpr int kStages = ring_stages(BN);
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: stages start on that.
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * kStage);
  uint64_t* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = blockIdx.x % split, f0 = (blockIdx.x / split) * kTileN, n0 = blockIdx.y * BN;
  const int nk = K / kStageK, s0 = rank * nk / split, stages = (rank + 1) * nk / split - s0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // every consumer thread releases it
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  pdl_trigger();

  if (warp == 8) {
    // Producer: one thread issues every TMA load; stage it holds x columns
    // kt * 128 .. + 127 of rows n0 .. n0 + BN - 1 (two 64-column boxes) and
    // the packed weight bytes kt * 64 .. + 63 of rows f0 .. f0 + 127.
    pdl_wait();
    if (lane == 0) {
      for (int it = 0; it < stages; ++it) {
        const int st = it % kStages, kt = s0 + it;
        if (it >= kStages) mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
        uint8_t* stage = base + st * kStage;
        mbar_expect_tx(&full[st], kStage);
        tma_load_2d(stage, &x_map, kt * kStageK, n0, &full[st]);
        tma_load_2d(stage + kBox, &x_map, kt * kStageK + 64, n0, &full[st]);
        tma_load_2d(stage + 2 * kBox, &w_map, kt * (kStageK / 2), f0, &full[st]);
      }
    }
  } else {
    // Consumers: warpgroup c owns output rows f0 + 64c .. + 63; a thread's
    // A rows are r and r + 8, its accumulator rows the same, and for each
    // n8 block i the x rows n0 + 8i + 2t and the one after.
    const int c = warp >> 2, g = lane >> 2, t = lane & 3;
    const int r = 64 * c + 16 * (warp & 3) + g;
    const uint32_t sel = static_cast<uint32_t>(t | ((4 + t) << 8));
    const uint32_t sg = f0 + r < N ? splat_bf16(scale[f0 + r]) : 0u;
    const uint32_t sh = f0 + r + 8 < N ? splat_bf16(scale[f0 + r + 8]) : 0u;
    float total[kAcc], acc[kAcc];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) total[j] = acc[j] = 0.0f;
    pdl_wait();
    for (int it = 0; it < stages; ++it) {
      const int st = it % kStages;
      uint8_t* stage = base + st * kStage;
      const uint8_t* wr = stage + 2 * kBox + r * (kStageK / 2);
      mbar_wait(&full[st], (it / kStages) & 1);
      // Two halves of 64 columns: the second half's dequantization runs
      // while the first half's products are on the tensor cores.
      uint32_t a0[4][4], a1[4][4];
      dequant_steps(wr, sel, sg, sh, a0);
      fence_regs(acc);
      wgmma_fence();
      const uint64_t d0 = sw128_desc(stage);
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_rs(acc, a0[s], d0 + 2 * s, s > 0);
      dequant_steps(wr + 32, sel, sg, sh, a1);
      wgmma_fence();
      const uint64_t d1 = sw128_desc(stage + kBox);
#pragma unroll
      for (int s = 0; s < 4; ++s) wgmma_rs(acc, a1[s], d1 + 2 * s, 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_frag(a0);
      fence_frag(a1);
      mbar_arrive(&empty[st]);
#pragma unroll
      for (int j = 0; j < kAcc; ++j) total[j] += acc[j];
    }
    // total[4i + 2h + e]: output row r + 8h, x row n0 + 8i + 2t + e.
    if (split == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = f0 + r + 8 * h;
        if (f >= N) continue;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 8 * i + 2 * t + e;
            if (n < M) y[static_cast<size_t>(n) * N + f] = epilogue(total[4 * i + 2 * h + e], bias, f);
          }
      }
    } else {
      named_sync(1);  // every consumer's products have read the ring
      float* part = reinterpret_cast<float*>(base);  // [BN][128]
#pragma unroll
      for (int i = 0; i < BN / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            part[(8 * i + 2 * t + e) * kTileN + r + 8 * h] = total[4 * i + 2 * h + e];
    }
  }
  if (split == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const float* part = reinterpret_cast<const float*>(base);
  for (int i = rank + split * threadIdx.x; i < BN * kTileN; i += split * blockDim.x) {
    const float sum = cluster_sum(cluster, part, i, split);
    const int n = n0 + i / kTileN, f = f0 + i % kTileN;
    if (n < M && f < N) y[static_cast<size_t>(n) * N + f] = epilogue(sum, bias, f);
  }
  cluster.sync();  // no block exits while another reads its sums
}

// A 2-D map over a row-major (rows, cols) operand of `elem` bytes, boxes of
// box_rows x box_cols, rows and columns past the edge read as zeros.
bool make_map_2d(CUtensorMap* map, CUtensorMapDataType type, int elem, const void* ptr,
                 long long rows, long long cols, int box_rows, int box_cols,
                 CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t one[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---------------------------------------------------------------------------
// Route 3: f32.
// ---------------------------------------------------------------------------

template <int NT>
__global__ void __launch_bounds__(32 * kMaxWarps)
q4_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scale, const float* __restrict__ bias,
              float* __restrict__ y, int M, int N, int K) {
  constexpr int kTile = 8 * NT;
  __shared__ float red[kMaxWarps][kRows][kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warps = blockDim.x >> 5, kblocks = K / kBlockK;
  const int f0 = blockIdx.x * kRows;
  const size_t pitch = static_cast<size_t>(K) / 2;
  const float sg = scale[f0 + g], sh = scale[f0 + g + 8];
  const uint8_t* wg = w + (f0 + g) * pitch + 16 * t;
  const uint8_t* wh = wg + 8 * pitch;
  const int mtiles = (M + kTile - 1) / kTile;
  for (int mt = blockIdx.y; mt < mtiles; mt += gridDim.y) {
    const int n0 = mt * kTile;
    float acc[2][kTile];
#pragma unroll
    for (int n = 0; n < kTile; ++n) acc[0][n] = acc[1][n] = 0.0f;
    for (int kb = warp; kb < kblocks; kb += warps) {
      const uint4 ag = __ldg(reinterpret_cast<const uint4*>(wg + kb * 64));
      const uint4 ah = __ldg(reinterpret_cast<const uint4*>(wh + kb * 64));
#pragma unroll
      for (int wd = 0; wd < 4; ++wd) {
        float vg[8], vh[8];
        dequant_f32(word(ag, wd), sg, vg);
        dequant_f32(word(ah, wd), sh, vh);
        const int k = kb * kBlockK + 32 * t + 8 * wd;
#pragma unroll
        for (int n = 0; n < kTile; ++n) {
          if (n0 + n >= M) break;
          const float4* xp =
              reinterpret_cast<const float4*>(x + static_cast<size_t>(n0 + n) * K + k);
          const float4 lo = __ldg(xp), hi = __ldg(xp + 1);
          const float xs[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[0][n] = fmaf(vg[j], xs[j], acc[0][n]);
            acc[1][n] = fmaf(vh[j], xs[j], acc[1][n]);
          }
        }
      }
    }
    // The 4 lanes (t) of a row hold its four 32-column shares.
#pragma unroll
    for (int n = 0; n < kTile; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        acc[r][n] += __shfl_xor_sync(0xffffffffu, acc[r][n], 1);
        acc[r][n] += __shfl_xor_sync(0xffffffffu, acc[r][n], 2);
      }
    if (t == 0) {
#pragma unroll
      for (int n = 0; n < kTile; ++n) {
        red[warp][g][n] = acc[0][n];
        red[warp][g + 8][n] = acc[1][n];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kTile; i += blockDim.x) {
      const int r = i % kRows, n = i / kRows;
      if (n0 + n >= M) continue;
      float sum = 0.0f;
      for (int v = 0; v < warps; ++v) sum += red[v][r][n];
      y[static_cast<size_t>(n0 + n) * N + f0 + r] = epilogue(sum, bias, f0 + r);
    }
    __syncthreads();  // red is written again by the next M-tile
  }
}

template <int NT>
int launch_decode(int kpw, dim3 grid, dim3 block, cudaStream_t s, int split, bool pdl,
                  const bf16* x, const uint8_t* w, const float* scale, const bf16* bias, bf16* y,
                  int m, int n, int k) {
  switch (kpw) {
    case 1: return launch_cluster(q4_decode_kernel<NT, 1>, grid, block, 0, s, split, pdl, x, w, scale, bias, y, m, n, k, split);
    case 2: return launch_cluster(q4_decode_kernel<NT, 2>, grid, block, 0, s, split, pdl, x, w, scale, bias, y, m, n, k, split);
    case 3: return launch_cluster(q4_decode_kernel<NT, 3>, grid, block, 0, s, split, pdl, x, w, scale, bias, y, m, n, k, split);
    default: return launch_cluster(q4_decode_kernel<NT, 4>, grid, block, 0, s, split, pdl, x, w, scale, bias, y, m, n, k, split);
  }
}

}  // namespace

// Q4: y (m, n) = x (m, k) W^T (+ bias), W the (n, k / 2) packed nibbles
// (k index 2j in the low nibble of byte j, 2j + 1 in the high one), scale
// (n,) f32; x, bias and y bf16 (routes 1, 2) or f32 (route 0).
// route 0, f32: `warps` (dividing k / 128, at most 8) a block, M-tiles of
//   8 nt rows (nt 1 or 4), grid (n / 16, grid_y).
// route 1, decode: `warps` a block of 16 output rows, each warp holding at
//   most `kpw` (1-4) k-blocks, warps * kpw covering a block's share of
//   k / 128 (see plan()); M-tiles of 8 nt rows; grid (split, n / 16),
//   clusters of `split` (1, 2, 4 or 8).
// route 2, tiled: 288 threads, tiles of 128 output rows by 8 nt x rows
//   (nt 4 or 16), grid (split * ceil(n / 128), ceil(m / (8 nt))) in
//   clusters of `split` (1, 2, 4 or 8; at most k / 128).
// `pdl` launches routes 1 and 2 with programmatic stream serialization.
// Returns the CUDA error of the launch (cudaErrorInvalidValue for a plan
// the kernels do not take).
extern "C" int twt_int4_linear(const void* x, const void* w, const void* scale, const void* bias,
                               void* y, int m, int n, int k, int route, int warps, int nt,
                               int kpw, int split, int grid_y, int pdl, int device,
                               void* stream) {
  if (m < 1 || n < kRows || n % kRows || k < kBlockK || k % kBlockK)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(scale);
  const uint8_t* wt = static_cast<const uint8_t*>(w);
  if (route == 0) {
    if (warps < 1 || warps > kMaxWarps || (k / kBlockK) % warps || (nt != 1 && nt != 4) ||
        grid_y < 1 || grid_y > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(n / kRows, grid_y), block(32 * warps);
    const float* xt = static_cast<const float*>(x);
    const float* bt = static_cast<const float*>(bias);
    float* yt = static_cast<float*>(y);
    if (nt == 1)
      q4_f32_kernel<1><<<grid, block, 0, s>>>(xt, wt, st, bt, yt, m, n, k);
    else
      q4_f32_kernel<4><<<grid, block, 0, s>>>(xt, wt, st, bt, yt, m, n, k);
    return static_cast<int>(cudaGetLastError());
  }
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* bt = static_cast<const bf16*>(bias);
  bf16* yt = static_cast<bf16*>(y);
  if (route == 1) {
    const int kblocks = k / kBlockK;
    if ((nt != 1 && nt != 4) || kpw < 1 || kpw > kMaxKpw || warps < 1 ||
        warps > decode_warps(nt, kpw) ||
        (split != 1 && split != 2 && split != 4 && split != kMaxSplit) || split > kblocks ||
        warps * kpw < (kblocks + split - 1) / split || n / kRows > 65535)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(split, n / kRows), block(32 * warps);
    return nt == 1 ? launch_decode<1>(kpw, grid, block, s, split, pdl != 0, xt, wt, st, bt, yt, m, n, k)
                   : launch_decode<4>(kpw, grid, block, s, split, pdl != 0, xt, wt, st, bt, yt, m, n, k);
  }
  const int bn = 8 * nt;
  if (route != 2 || (bn != 32 && bn != 128) ||
      (split != 1 && split != 2 && split != 4 && split != kMaxSplit) || split > k / kStageK)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long gy = (static_cast<long long>(m) + bn - 1) / bn;
  if (gy > 65535 || grid_y != gy) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[2];
  if (!make_map_2d(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, k, bn, 64,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, n, k / 2, kTileN, kStageK / 2,
                   CU_TENSOR_MAP_SWIZZLE_NONE))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(split * ((n + kTileN - 1) / kTileN), static_cast<unsigned>(gy));
  // The shared-memory opt-in is per device; set it on every call (a
  // host-side attribute write, no device work).
  if (bn == 32) {
    err = cudaFuncSetAttribute(q4_tiled_kernel<32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               tiled_smem(32));
    if (err != cudaSuccess) return static_cast<int>(err);
    return launch_cluster(q4_tiled_kernel<32>, grid, dim3(kTiledThreads), tiled_smem(32), s, split,
                     pdl != 0, maps[0], maps[1], st, bt, yt, m, n, k, split);
  }
  err = cudaFuncSetAttribute(q4_tiled_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tiled_smem(128));
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_cluster(q4_tiled_kernel<128>, grid, dim3(kTiledThreads), tiled_smem(128), s, split,
                   pdl != 0, maps[0], maps[1], st, bt, yt, m, n, k, split);
}
