// 3xTF32 building blocks of the f32 attention kernels: K2's f32 route
// (encoder_attention.cu, with or without lse), K2-dkv's and K2-dq's
// (encoder_attention_bwd.cu).
//
// f32 results on the tensor cores: each f32 operand x is split into a TF32
// high part hi = rna(x) (cvt.rna.tf32.f32's rounding: to 10 mantissa bits,
// ties away from zero) and a rest lo = x - hi (exact in f32; the tensor
// core reads its top 10 mantissa bits), and a product is a_lo b_hi + a_hi
// b_lo + a_hi b_hi, the small terms first, summed in f32 by mma.sync
// m16n8k8 (the a_lo b_lo term, about 2^-22 of the product, is left out).
// Plain TF32 (one product, 10 mantissa bits) misses the f32 routes' bounds
// by an order of magnitude. The split is three instructions an element
// (cvt.rna itself compiles to four, with a check for inf and NaN that the
// finite operands here do not need), and a warp splits each operand it
// reads, since every warp reads the streamed tiles.
//
// Tiles arrive by TMA (tc_common.cuh) as (rows, 64) f32 in two halves of 32
// floats, each half rows x 128 bytes in the 128-byte swizzle: element (r, d)
// of a half at r * 128 + ((d / 4) ^ (r % 8)) * 16 + (d % 4) * 4. mma.sync's
// operands are read from there in any layout (wgmma's TF32 form takes
// shared-memory operands K-major only), and split in registers after the
// load. A warp owns 16 rows of a resident tile and runs two kinds of
// product against a 64-row streamed tile T:
//   over the 64 dims, acc (16 x 64) += A T^T (S = Q K^T and dP = dO V^T;
//     S^T = K Q^T and dP^T = V dO^T): k-step kk takes, in half kk / 4,
//     16-byte chunks kk % 4 and kk % 4 + 4; lane (g, t) holds the float
//     pair 2 (t % 2) of chunk kk % 4 + 4 (t / 2) as its k = t and k = t + 4,
//     in A (rows g and g + 8 of the warp's 16) and in B (row 8 nt + g of
//     T). The order of the dims in a k-step is the products' own affair;
//     this one makes the half-warp's 64-bit loads hit 32 distinct banks
//     under the swizzle;
//   over the 64 rows of T, acc (16 x 64) += F T (O += P V; dV += P^T dO,
//     dK += dS^T Q and dQ += dS K): F is a 16 x 64 accumulator of the
//     first kind (P, P^T, dS^T or dS), whose n8 block j is k-step j's A
//     fragment as it stands (lane (g, t) holds columns 2 t and 2 t + 1 of
//     rows g and g + 8: its k = t and k = t + 4 are rows 8 j + 2 t and
//     8 j + 2 t + 1 of T); B is element (8 j + 2 t (+ 1), 8 nn + g) of T,
//     conflict-free under the swizzle as scalar loads.

#pragma once

#include "tc_common.cuh"

namespace {

// Byte offset of element (r, d), d < 64, of a kRows-row f32 tile as TMA
// writes it (see above).
template <int kRows>
__device__ __forceinline__ int f32_offset(int r, int d) {
  return (d >> 5) * kRows * 128 + r * 128 + ((((d & 31) >> 2) ^ (r & 7)) << 4) + ((d & 3) << 2);
}

// The dim lane t takes as its k = t in k-step kk of a product over the dims
// (its k = t + 4 is the next one).
__device__ __forceinline__ int pair_dim(int kk, int t) {
  return 32 * (kk >> 2) + 4 * ((kk & 3) + 4 * (t >> 1)) + 2 * (t & 1);
}

template <int kRows>
__device__ __forceinline__ float2 ld_pair(const uint8_t* tile, int r, int kk, int t) {
  return *reinterpret_cast<const float2*>(tile + f32_offset<kRows>(r, pair_dim(kk, t)));
}

template <int kRows>
__device__ __forceinline__ float ld_f32(const uint8_t* tile, int r, int d) {
  return *reinterpret_cast<const float*>(tile + f32_offset<kRows>(r, d));
}

// Rows row .. row + kRows - 1 of an f32 map into a tile: its two halves.
template <int kRows>
__device__ __forceinline__ void load_rows_f32(uint8_t* dst, const CUtensorMap* map, int perm,
                                              int row, int h, int b, uint64_t* bar) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
    tma_load(dst + half * kRows * 128, map, 32 * half, coord(perm, 0, row, h, b),
             coord(perm, 1, row, h, b), coord(perm, 2, row, h, b), bar);
}

// x's TF32 parts (see above): hi = rna(x) on the bit pattern (add half a
// TF32 ulp, clear the 13 low bits), lo = x - hi.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// An A fragment (a0..a3) split into its TF32 parts.
struct Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ Frag split_a(float a0, float a1, float a2, float a3) {
  Frag f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// k-step kk's A fragment of a product over the dims: rows r and r + 8 of
// a resident kRows-row tile.
template <int kRows>
__device__ __forceinline__ Frag dims_frag(const uint8_t* tile, int r, int kk, int t) {
  const float2 x = ld_pair<kRows>(tile, r, kk, t);
  const float2 y = ld_pair<kRows>(tile, r + 8, kk, t);
  return split_a(x.x, y.x, x.y, y.y);
}

// n8 block j of a 16 x 64 accumulator as k-step j's A fragment of a
// product over the rows of a tile.
__device__ __forceinline__ Frag acc_frag(const float (&c)[4]) {
  return split_a(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32 for one n8 block: a_lo b_hi + a_hi b_lo + a_hi b_hi.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(d, a.lo, bh0, bh1);
  mma_tf32(d, a.hi, bl0, bl1);
  mma_tf32(d, a.hi, bh0, bh1);
}

// k-step kk of acc (16 x 64) += A T^T over the dims, T a kRows-row tile
// whose rows 0..63 are the n8 blocks' columns.
template <int kRows>
__device__ __forceinline__ void mma_dims(float (&acc)[8][4], const Frag& a, const uint8_t* tile,
                                         int kk, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const float2 b = ld_pair<kRows>(tile, 8 * nt + lane / 4, kk, lane % 4);
    mma3(acc[nt], a, b.x, b.y);
  }
}

// k-step j of acc (16 x 64) += F T over T's rows 8 j .. 8 j + 7, a the
// fragment of F's n8 block j (acc_frag), T a kRows-row tile.
template <int kRows>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], const Frag& a, const uint8_t* tile,
                                         int j, int lane) {
  const int r = 8 * j + 2 * (lane % 4);
#pragma unroll
  for (int nn = 0; nn < 8; ++nn) {
    const int d = 8 * nn + lane / 4;
    mma3(acc[nn], a, ld_f32<kRows>(tile, r, d), ld_f32<kRows>(tile, r + 1, d));
  }
}

}  // namespace
