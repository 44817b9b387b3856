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
// Bound. In the decode step (M = 1-32 rows, up to 160 with beams) the
// packed weight's bytes bound it: a large-v3 layer's six linears hold
// 22.9 M weights, 11.5 MB, against a few KB of activations. Each packed
// byte is read once from device memory, into registers, and never written
// back dequantized. At the cross K/V's M = B x 1500 the products bound it.
//
// Design (a first kernel: right and simple; TMA, wgmma and split-K across
// blocks are later work). A block owns 16 output rows (features) f0 ..
// f0 + 15 and sweeps the x rows in M-tiles of 8 NT rows (NT = 1 for M <= 8,
// else 4); grid.y spreads the M-tiles over more blocks. Its warps split K
// in 128-column blocks (kb = warp, warp + warps, ...; the host picks a warp
// count that divides K / 128, so every warp takes as many) and the block
// adds the warps' sums in warp order through shared memory, so every
// output is the same from run to run and from a CUDA-graph replay. Lane
// (g, t) of a warp loads bytes 16t .. 16t + 15 of the block's 64 bytes of
// rows g and g + 8 (32 k each) with one 16-byte load a row, and x[n][k ..
// k + 7] for each word of them.
// - bf16 x: each nibble is dequantized in registers as JAX's bf16 `_linear`
//   rounds it, bf16(q) * bf16(s) rounded to bf16 (two fma.rn.bf16x2, exact
//   up to that one rounding), and the product runs on the tensor cores
//   (mma.sync m16n8k16, f32 accumulate) with the weight rows as the m = 16
//   operand and 8 x rows as the n = 8 operand: the dequantization is done
//   once for all the rows of an M-tile. The k order inside an mma is
//   permuted alike in both operands: slots (2t, 2t + 1) of a step hold k + j
//   and k + j + 4 of a word's eight, which is the pair one mask of the
//   packed word gives. Each 128-column block's sum starts from zero in the
//   mma and is added to the f32 total (the tensor core truncates its own
//   additions). The output is rounded to bf16, then the bias added and
//   rounded again: the plain version's two roundings.
// - f32 x: the same loads on the CUDA cores, q * s rounded to f32, f32
//   fused multiply-adds, the 4 lanes of a row added by shuffles.
//
// Capture-safe: no synchronisation, no allocation, the caller's stream.
// Needs N % 16 == 0, K % 128 == 0 (every Whisper width) and 16-byte-aligned
// x and W; ops/int4_linear.py checks them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "launch_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 16;      // output rows of a block
constexpr int kBlockK = 128;   // k columns a warp takes at a time: 64 bytes a row
constexpr int kMaxWarps = 8;

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

// The 8 nibbles of w (nibble j at bits 4j is k + j) dequantized as
// bf16(q) * s2, rounded to bf16, q the nibble as a signed int4. Pair j
// (0 .. 3) holds k + j in its low half and k + j + 4 in its high half.
__device__ __forceinline__ void dequant_bf16(uint32_t w, uint32_t s2, uint32_t (&p)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // 0x4300 | (n ^ 8) is the bf16 128 + (n ^ 8); less 136 it is q, exactly.
    const uint32_t m = ((w >> (4 * j)) & 0x000F000Fu) ^ 0x43084308u;
    const uint32_t q = fma_bf16x2(m, 0x3F803F80u, 0xC308C308u);  // m * 1 - 136
    p[j] = fma_bf16x2(q, s2, 0x80008000u);                         // q * s - 0
  }
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

// The warps' sums of one M-tile (red[warp][row][x row]) added in warp order,
// then the epilogue: y[n0 + n][f0 + r].
template <int NT, typename T>
__device__ __forceinline__ void finish_tile(const float (*red)[kRows][8 * NT], int warps,
                                            const T* __restrict__ bias, T* __restrict__ y, int M,
                                            int N, int f0, int n0) {
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * 8 * NT; i += blockDim.x) {
    const int r = i % kRows, n = i / kRows;
    if (n0 + n >= M) continue;
    float sum = 0.0f;
    for (int v = 0; v < warps; ++v) sum += red[v][r][n];
    T* out = y + static_cast<size_t>(n0 + n) * N + f0 + r;
    if constexpr (sizeof(T) == 2) {
      // The product rounded to bf16, then the bias added and rounded.
      const float p = __bfloat162float(__float2bfloat16_rn(sum));
      *out = __float2bfloat16_rn(bias ? p + __bfloat162float(bias[f0 + r]) : p);
    } else {
      *out = bias ? sum + bias[f0 + r] : sum;
    }
  }
  __syncthreads();  // red is written again by the next M-tile
}

template <int NT>
__global__ void __launch_bounds__(32 * kMaxWarps)
q4_bf16_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ scale, const bf16* __restrict__ bias,
               bf16* __restrict__ y, int M, int N, int K) {
  __shared__ float red[kMaxWarps][kRows][8 * NT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warps = blockDim.x >> 5, kblocks = K / kBlockK;
  const int f0 = blockIdx.x * kRows;
  const size_t pitch = static_cast<size_t>(K) / 2;
  const uint32_t sg = splat_bf16(scale[f0 + g]), sh = splat_bf16(scale[f0 + g + 8]);
  const uint8_t* wg = w + (f0 + g) * pitch + 16 * t;
  const uint8_t* wh = wg + 8 * pitch;
  const int mtiles = (M + 8 * NT - 1) / (8 * NT);
  for (int mt = blockIdx.y; mt < mtiles; mt += gridDim.y) {
    const int n0 = mt * 8 * NT;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0f;
    for (int kb = warp; kb < kblocks; kb += warps) {
      const uint4 ag = __ldg(reinterpret_cast<const uint4*>(wg + kb * 64));
      const uint4 ah = __ldg(reinterpret_cast<const uint4*>(wh + kb * 64));
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
        dequant_bf16(word(ag, wd), sg, pg);
        dequant_bf16(word(ah, wd), sh, ph);
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
    // Fragment: acc[nt] = (row g, x row 8 nt + 2t), (g, + 1), (g + 8, 2t), (g + 8, + 1).
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      red[warp][g][8 * nt + 2 * t] = acc[nt][0];
      red[warp][g][8 * nt + 2 * t + 1] = acc[nt][1];
      red[warp][g + 8][8 * nt + 2 * t] = acc[nt][2];
      red[warp][g + 8][8 * nt + 2 * t + 1] = acc[nt][3];
    }
    finish_tile<NT, bf16>(red, warps, bias, y, M, N, f0, n0);
  }
}

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
    finish_tile<NT, float>(red, warps, bias, y, M, N, f0, n0);
  }
}

template <typename T>
void launch(dim3 grid, dim3 block, cudaStream_t stream, int nt, const void* x, const void* w,
            const void* scale, const void* bias, void* y, int m, int n, int k) {
  const T* xt = static_cast<const T*>(x);
  const uint8_t* wt = static_cast<const uint8_t*>(w);
  const float* st = static_cast<const float*>(scale);
  const T* bt = static_cast<const T*>(bias);
  T* yt = static_cast<T*>(y);
  if constexpr (sizeof(T) == 2) {
    if (nt == 1)
      q4_bf16_kernel<1><<<grid, block, 0, stream>>>(xt, wt, st, bt, yt, m, n, k);
    else
      q4_bf16_kernel<4><<<grid, block, 0, stream>>>(xt, wt, st, bt, yt, m, n, k);
  } else {
    if (nt == 1)
      q4_f32_kernel<1><<<grid, block, 0, stream>>>(xt, wt, st, bt, yt, m, n, k);
    else
      q4_f32_kernel<4><<<grid, block, 0, stream>>>(xt, wt, st, bt, yt, m, n, k);
  }
}

}  // namespace

// Q4: y (m, n) = x (m, k) W^T (+ bias), W the (n, k / 2) packed nibbles
// (k index 2j in the low nibble of byte j, 2j + 1 in the high one), scale
// (n,) f32; x, bias and y bf16 (f32 = 0) or f32. `warps` (dividing k / 128,
// at most 8) a block, M-tiles of 8 nt rows (nt 1 or 4), grid (n / 16,
// grid_y). Returns the CUDA error of the launch.
extern "C" int twt_int4_linear(const void* x, const void* w, const void* scale, const void* bias,
                               void* y, int m, int n, int k, int f32, int warps, int nt,
                               int grid_y, int device, void* stream) {
  if (m < 1 || n < kRows || n % kRows || k < kBlockK || k % kBlockK || warps < 1 ||
      warps > kMaxWarps || (k / kBlockK) % warps || (nt != 1 && nt != 4) || grid_y < 1 ||
      grid_y > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / kRows, grid_y), block(32 * warps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    launch<float>(grid, block, s, nt, x, w, scale, bias, y, m, n, k);
  else
    launch<bf16>(grid, block, s, nt, x, w, scale, bias, y, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
