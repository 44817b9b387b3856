// P4 and P5: one slot of a bf16 KV cache written in place.
//
// Replaces tools/mega_caps_probe.py:74 `write_row_b` and :172
// `write_row_big` (P4: one (1, D) row into a slot-major cache, which Mosaic
// could only do as a read-modify-write of the 8-row group around the slot)
// and tools/cache_write_probe.py:127 `pallas_write` (P5: one column at `pos`
// into a feature-major (R, F, T) cache, which the TPU kernel round-trips
// whole through VMEM with the buffer aliased). Neither workaround carries
// over: the kernel writes the slot's elements and nothing else.
//
// Both are one strided copy, dst[base + i * stride] = src[i] for i < n:
// P4 is (base, stride, n) = (pos D, 1, D) on the (rows, D) view of the
// cache, P5 (pos, T, R F) on the (R F, T) view.
//
// Bound on the H100: device memory, 2 n bytes read and 2 n written: 5.1 KB
// for a 1280-wide row (1.5 ns at 3.35 TB/s), 0.66 MB for P5's 32 x 4 x 1280
// column (0.2 us); P5's writes are 2 bytes every 2 T bytes, so each fills
// one 32-byte sector. Either is far below a launch's own cost, which is what
// the probes measure against torch's in-place writes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
strided_write_kernel(unsigned short* __restrict__ dst, const unsigned short* __restrict__ src,
                     long long n, long long base, long long stride) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads)
    dst[base + i * stride] = src[i];
}

}  // namespace

// dst, src: device pointers of 2-byte elements; writes dst[base + i * stride]
// = src[i] for 0 <= i < n (the caller checks the bounds). Returns
// cudaGetLastError().
extern "C" int twt_strided_write(void* dst, const void* src, long long n, long long base,
                                 long long stride, int device, void* stream) {
  if (n < 1 || base < 0 || stride < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + kThreads - 1) / kThreads;
  strided_write_kernel<<<static_cast<unsigned int>(blocks < 4096 ? blocks : 4096), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned short*>(dst), static_cast<const unsigned short*>(src), n, base, stride);
  return static_cast<int>(cudaGetLastError());
}
