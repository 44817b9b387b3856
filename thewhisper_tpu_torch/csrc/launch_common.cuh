// Launch helpers a source includes for its own copy (an unnamed namespace):
// programmatic dependent launch (PDL) on Hopper, thread-block clusters, and
// the device made current only when it is not already.
//
// PDL. A kernel launched with programmatic stream serialization may start
// while the kernel before it on the stream still runs: as soon as every
// block of that kernel has executed `griddepcontrol.launch_dependents`
// (pdl_trigger), or exited. `griddepcontrol.wait` (pdl_wait) then blocks
// until that kernel has completed and its writes are visible. So each
// kernel launched this way calls pdl_trigger at entry, and pdl_wait before
// its first read or write of global memory: a predecessor may have written
// anything it touches. A kernel launched without the attribute, which is
// every PyTorch kernel, still waits for the full completion of the one
// before it. Without a programmatic predecessor both instructions return at
// once. CUDA graphs captured from a stream keep the programmatic edges
// (CUDA 12.3 and later).

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() { asm volatile("griddepcontrol.wait;" ::: "memory"); }

// cudaSetDevice only when `device` is not current: the call costs host
// time on every launch, and the device is nearly always current.
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

// One launch of `kernel` through cudaLaunchKernelEx, in clusters of
// `cluster` blocks along x when it is above 1, with programmatic stream
// serialization when `pdl` is set. Returns the launch's error, else
// cudaGetLastError(), which it clears either way (PyTorch reads it after
// its own launches).
template <typename... Params, typename... Args>
inline int launch_cluster(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                          cudaStream_t stream, int cluster, bool pdl, Args... args) {
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = n;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// One launch of `kernel`, with programmatic stream serialization when `pdl`
// is set.
template <typename... Params, typename... Args>
inline int launch_pdl(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem,
                      cudaStream_t stream, bool pdl, Args... args) {
  return launch_cluster(kernel, grid, block, smem, stream, 1, pdl, args...);
}

}  // namespace
