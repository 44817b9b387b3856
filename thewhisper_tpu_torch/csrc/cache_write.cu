// P4 and P5: one slot of a bf16 KV cache written in place, at a slot given
// by the host or read from device memory when the kernel runs.
//
// P4 replaces tools/mega_caps_probe.py:74 `write_row_b` and :172
// `write_row_big`: one (1, D) row into a slot-major cache, which Mosaic could
// only do as a read-modify-write of the 8-row group around the slot. Here
// one block of D / 8 threads copies the row, each thread one 16-byte
// read-only load and one 16-byte store, no loop. The row's 2 x 2.5 KB take
// 1.5 ns at 3.35 TB/s, so a launch bounds it: the body does the least work
// a launch can, and the launch is programmatic (launch_common.cuh), so the
// next launch on the stream starts while this one runs.
//
// P5 replaces tools/cache_write_probe.py:127 `pallas_write`: column `pos`
// of a feature-major (R, F, T) cache from an (R, F, 1) column, which the TPU
// kernel round-tripped whole through VMEM. Element i of the column goes to
// i T + pos: every 2-byte store lands in its own 32-byte sector (the row
// pitch is 2 T bytes), so 163,840 separate sector writes bound it at the
// probe's (128, 1280, 228), 5.24 MB of sectors for 0.33 MB of data, not its
// bytes. TMA cannot help: a tensor map's global strides must be multiples
// of 16 bytes (456 is not) and a box at least 16 bytes wide (a column is
// 2). So each thread loads 8 consecutive column values with one 16-byte load
// and issues their 8 scattered stores, and the grid (sized by the wrapper
// from the SM count) is resident at once, keeping every store in flight:
// blocks of one warp, so that 640 of them spread evenly over the SMs (an
// SM's stores issue at a bounded rate, and with blocks of 128 a fifth of
// the SMs held two blocks where the rest held one).
// The stores are plain: a streaming (evict-first) form timed within 1% of
// them on an H100, the faster changing from run to run. No store form
// makes a 2-byte write cheaper than its sector: L2-resident, the
// partial-sector writes hold the kernel near torch's strided copy of the
// same column; HBM-cold, each write-back is a partial sector.
//
// The slot. A host slot comes as `pos`; a device slot as `slot`, one int32
// read after pdl_wait (a predecessor may have written it), the counterpart
// of the TPU kernels' SMEM scalar, so a CUDA graph replays the write at
// whatever slot the device holds then. The host cannot see a device slot,
// so the kernel checks it: a slot outside the cache traps (a launch failure
// at the next synchronise) before any thread stores.

#include <cuda_runtime.h>

#include "launch_common.cuh"

namespace {

// The slot this launch writes; traps when it is outside [0, limit).
__device__ __forceinline__ int checked_slot(const int* slot, int pos, int limit) {
  const int s = slot != nullptr ? *slot : pos;
  if (s < 0 || s >= limit) __trap();
  return s;
}

// cache: (rows, D) as rows x chunks 16-byte chunks; one block of `chunks`
// threads.
__global__ void __launch_bounds__(1024)
write_row_kernel(uint4* __restrict__ cache, const uint4* __restrict__ row,
                 const int* __restrict__ slot, int pos, int rows) {
  pdl_trigger();
  pdl_wait();
  // The row's load first: it and the slot's are both in flight before the
  // slot is needed.
  const unsigned int c = threadIdx.x;
  const uint4 v = __ldg(row + c);
  const int s = checked_slot(slot, pos, rows);
  uint4* dst = cache + static_cast<size_t>(s) * blockDim.x;
  dst[c] = v;
}

// cache: (R F, T) 2-byte elements, R F T < 2^31; col: R F values as
// `groups` 16-byte groups of 8; a grid-stride loop over the groups. A
// thread with no group stores nothing and reads no slot.
__global__ void write_column_kernel(unsigned short* __restrict__ cache,
                                    const uint4* __restrict__ col, const int* __restrict__ slot,
                                    int pos, int t, int groups) {
  pdl_trigger();
  pdl_wait();
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  uint4 v = __ldg(col + g);  // in flight with the slot's load
  const int s = checked_slot(slot, pos, t);
  const int stride = t;
  for (;;) {
    unsigned short* dst = cache + 8 * g * stride + s;
    const unsigned int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 8; ++k)
      dst[k * stride] = static_cast<unsigned short>(w[k / 2] >> (16 * (k % 2)));
    g += gridDim.x * blockDim.x;
    if (g >= groups) break;
    v = __ldg(col + g);
  }
}

// What a launch costs alone: no memory touched, the same PDL instructions
// (the argument is unused: cudaLaunchKernelEx's template takes no empty
// argument list).
__global__ void empty_kernel(int) {
  pdl_trigger();
  pdl_wait();
}

}  // namespace

// P4: row `slot ? *slot : pos` of a (rows, 8 chunks) bf16 cache = `row`
// (8 chunks values); cache and row 16-byte aligned, 1 <= chunks <= 1024.
// Returns the CUDA error of the launch.
extern "C" int twt_write_row(void* cache, const void* row, const void* slot, int pos, int rows,
                             int chunks, int device, void* stream) {
  if (rows < 1 || chunks < 1 || chunks > 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_pdl(write_row_kernel, dim3(1), dim3(chunks), 0, static_cast<cudaStream_t>(stream),
                    true, static_cast<uint4*>(cache), static_cast<const uint4*>(row),
                    static_cast<const int*>(slot), pos, rows);
}

// P5: column `slot ? *slot : pos` of an (R F, t) bf16 cache = `col` (R F =
// 8 groups values); col 16-byte aligned, 8 groups t < 2^31; `blocks` x
// `threads` over the groups. Returns the CUDA error of the launch.
extern "C" int twt_write_column(void* cache, const void* col, const void* slot, int pos, int t,
                                int groups, int blocks, int threads, int device, void* stream) {
  if (t < 1 || groups < 1 || blocks < 1 || threads < 1 || threads > 1024 ||
      8LL * groups * t >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_pdl(write_column_kernel, dim3(blocks), dim3(threads), 0,
                    static_cast<cudaStream_t>(stream), true, static_cast<unsigned short*>(cache),
                    static_cast<const uint4*>(col), static_cast<const int*>(slot), pos, t, groups);
}

// One block of one warp running empty_kernel, with or without PDL: the
// launch floor the cache writes are measured against. No path calls it.
extern "C" int twt_empty_launch(int pdl, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_pdl(empty_kernel, dim3(1), dim3(32), 0, static_cast<cudaStream_t>(stream),
                    pdl != 0, 0);
}
