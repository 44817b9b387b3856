// Hopper building blocks shared by the bf16 attention kernels: K2
// (encoder_attention.cu), its backward K2-dkv and K2-dq
// (encoder_attention_bwd.cu) and P1 (attention_control.cu); the f32 routes
// of K2 and K2-dkv take the mbarriers, TMA loads and tensor maps from here
// (their 3xTF32 products are in tf32_common.cuh).
//
// Shared-memory addresses, mbarriers, TMA tile loads through 4-D tensor
// maps over (B, S, H, 64) bf16 or f32 operands (128-byte swizzle, rows past
// S read as zeros), wgmma descriptors and products for one warpgroup (S =
// Q K^T as m64n128k16 or m64n64k16 with both operands in shared memory;
// O += P V as m64n64k16 with P in registers and V transposed), named
// barriers, and the host code that encodes the tensor maps. Each including
// source gets its own copy (an unnamed namespace).

#pragma once

#include <stdint.h>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kDh = 64;        // head dim: one 128-byte bf16 row
constexpr int kKeyTile = 128;  // keys of one score tile (n of S = Q K^T)

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) { mbar_arrive(smem_u32(bar)); }

// Whether the phase of parity `parity` has completed (one bounded try).
__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed: the one wait of
// every ring here. The package's build waits without bound, since a context
// that is preempted or time-sliced can hold a sound wait past any fixed
// limit. A build with TWT_MBAR_TRAP_NS defined (the mutation check's copies,
// tools/mega_mutants.py) traps once one wait passes that many ns of
// %globaltimer, so that a barrier out of step fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
#ifdef TWT_MBAR_TRAP_NS
  if (mbar_try(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!mbar_try(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (t - t0 > TWT_MBAR_TRAP_NS) __trap();
  }
#else
  while (!mbar_try(bar, parity)) {
  }
#endif
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
__device__ __forceinline__ uint64_t sw128_desc(uint32_t tile) {
  const uint64_t addr = tile;
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return sw128_desc(smem_u32(tile));
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

// d(64 x 64, f32) (+)= A(64 x 16) B(16 x 64): both operands in shared
// memory, K-major.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
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

// D (64 x 64, f32) = A B^T for one warpgroup: A and B 64-row tiles of
// 128-byte rows (K-major both), four k-steps of 16 dims.
__device__ __forceinline__ void issue_ss64(float (&d)[32], uint64_t a_desc, uint64_t b_desc) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) wgmma_ss64(d, a_desc + 2 * kk, b_desc + 2 * kk, kk > 0);
  wgmma_commit();
  fence_regs(d);
}

// O (64 x 64, f32) += P V for one warpgroup: kSteps k-steps of 16 rows of
// V (8 for a 128-key tile, 4 for a 64-row one), 2048 bytes apart.
template <int kSteps>
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[kSteps][4],
                                         uint64_t v_desc) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) wgmma_pv(o, p[kk], v_desc + 128 * kk);
  wgmma_commit();
  fence_regs(o);
}

// P in bf16 as the A fragments of P V: accumulator columns 16 kk .. 16 kk +
// 15 are k-step kk's fragment, registers (j / 2) % 4 in the order a0..a3
// (N = 64 for a 128-column accumulator, 32 for a 64-column one).
template <int N, int K>
__device__ __forceinline__ void to_bf16(const float (&s)[N], uint32_t (&p)[K][4]) {
  static_assert(8 * K == N, "a fragment a k-step of 16 columns (8 accumulator values)");
#pragma unroll
  for (int j = 0; j < N; j += 2) p[j / 8][(j / 2) % 4] = pack_bf16(s[j], s[j + 1]);
}

// Keeps the compiler from reusing the registers of an A fragment before the
// wgmma that reads them has been waited for.
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&p)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(p[i][j])::"memory");
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
// 128-byte swizzle, rows past S read as zeros. An f32 operand (`f32`) takes
// boxes of box_rows x 32 (128 bytes a row, the widest the swizzle takes), so
// a 64-float row is two loads. Returns false if the driver refuses it;
// *perm receives the dimension order (see coord()).
bool make_map(CUtensorMap* map, int* perm, const void* ptr, int B, int S, int H, long long sb,
              long long ss, long long sh, int box_rows, bool f32 = false) {
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
  const int elem_bytes = f32 ? 4 : 2;
  cuuint32_t box[4] = {f32 ? 128u / 4 : kDh, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  int pos[3];
  for (int d = 0; d < 3; ++d) {
    const int role = order[d];
    pos[role] = d;
    dims[1 + d] = static_cast<cuuint64_t>(sizes[role]);
    gstrides[d] = static_cast<cuuint64_t>(strides[role]) * elem_bytes;
    if (role == 0) box[1 + d] = box_rows;
  }
  *perm = pos[0] | (pos[1] << 2) | (pos[2] << 4);
  return encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims,
                gstrides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether TMA takes an operand: a 16-byte-aligned base pointer and batch,
// sequence and head strides (elem_bytes 2 for bf16, 4 for f32).
bool aligned16(const void* p, long long sb, long long ss, long long sh, int elem_bytes = 2) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (sb * elem_bytes) % 16 == 0 &&
         (ss * elem_bytes) % 16 == 0 && (sh * elem_bytes) % 16 == 0;
}

}  // namespace
