// P2 and P3: the batch-1 int8 MLP chain of a decoder stack.
//
// Replaces tools/gemv_chain_probe.py:150 (build_mlp_chain_kernel, P2: the
// L-layer chain as one Pallas program) and tools/gemv_chain_probe.py:259
// (build_mlp_layer_kernel, P3: one pallas_call a layer, the layer index a
// scalar prefetch). For each layer l of [l0, l1):
//   q_in = bf16(LayerNorm(x) * ln_s[l] + ln_b[l]), f32 statistics, eps 1e-5;
//   h = bf16(gelu_tanh(bf16((q_in @ W1[l]) * s1[l] + b1[l])));
//   y = (h @ W2[l]) * s2[l] + b2[l];
//   x = bf16(x + bf16(y));
// every product over int8 weights widened exactly, summed in f32. P2 is one
// launch over [0, L); P3 one launch over [l, l + 1).
//
// Bound on the H100: device memory. A layer reads 2 D F int8 weight bytes:
// 13.1 MB at D 1280, F 5120, and 419.4 MB over 32 layers, 0.125 ms at
// 3.35 TB/s. Its 4 D F operations are two a byte, far below every compute
// rate. The second bound is the chain of dependent phases.
//
// Design: a second client of the decode engine (mega_common.cuh), which
// already computes this function in K3's phases 7 and 8, its pieces used
// unchanged. The weights come packed once by the wrapper into (L, out, in)
// layout (ops/mlp_chain.py::pack_mlp_weights), so each block owns whole
// output rows of both matrices: no partial sums and no column-sum pass, two
// grid barriers a layer (after fc1 + GELU, after fc2). One cooperative
// launch of one block an SM: the engine's producer warp streams the block's
// rows of W1[l] and W2[l], layer after layer, through the TMA ring (it takes
// no part in the barriers, so it runs ahead across them), and 16 consumer
// warps run the engine's LayerNorm, loads, tensor-core product, epilogues
// and grid barrier. At each layer the producer also asks L2 for the layer's
// LayerNorm parameters and its block's scales and biases, about a layer
// before the consumers read them: otherwise each such read came from device
// memory on the phase's critical path (P2 0.4754 ms without, 0.4260 with,
// H100 80GB HBM3, 700 W).
//
// A product of one warp an output row (no shared partials, no consumer
// barrier a tile) measured slower than the engine's: 0.5333 against 0.4781
// ms, its loops 2.3 and 2.9 us a layer's fc1 and fc2 against 1.1 and 1.7
// (same card): every warp unpacks the row's bytes and the activations on
// the CUDA cores, where the tensor cores take 16 rows at once.
//
// Every block's rows (row_lo) and every sum's order are independent of the
// layer range, so L launches of P3 give P2's bits exactly; no float
// atomics, so a run is deterministic.

#include "mega_common.cuh"

using namespace engine;

namespace {

// What the chain reads beside the engine's Args, for layers [l0, l1).
struct Chain {
  const int8_t *w1t, *w2t;                   // (L, F, D), (L, D, F) int8, packed
  const float *ln_s, *ln_b, *s2, *b2;        // (L, D)
  const float *s1, *b1;                      // (L, F)
  int l0, l1;
};

// n floats from p on into L2 (the 16-byte-aligned span around them), no wait.
__device__ __forceinline__ void prefetch_l2(const float* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p) & ~static_cast<uintptr_t>(15);
  const uintptr_t e = (reinterpret_cast<uintptr_t>(p + n) + 15) & ~static_cast<uintptr_t>(15);
  if (e > a)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(a),
                 "r"(static_cast<uint32_t>(e - a))
                 : "memory");
}

__global__ void __launch_bounds__(kBlockThreads, 1) mlp_chain_kernel(Args p, Chain c) {
  extern __shared__ __align__(128) unsigned char mlp_smem[];
  unsigned char* smem = mlp_smem;
  const Layout s = layout(1, 1, p.pitch, 0, 0, p.stages);
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
  const int D = p.D, F = p.F;
  const size_t df = static_cast<size_t>(D) * F;
  if (threadIdx.x >= kConsumers) {
    // The producer: for each layer, the small vectors into L2, then the
    // block's rows of W1[l] and of W2[l] into the ring.
    Producer pr{ring, static_cast<int>(threadIdx.x & 31)};
    const int f0 = row_lo(blockIdx.x, F), f1 = row_lo(blockIdx.x + 1, F);
    const int d0 = row_lo(blockIdx.x, D), d1 = row_lo(blockIdx.x + 1, D);
    for (int l = c.l0; l < c.l1; ++l) {
      if (pr.lane == 0) {
        prefetch_l2(c.ln_s + l * D, D);
        prefetch_l2(c.ln_b + l * D, D);
        prefetch_l2(c.s1 + l * F + f0, f1 - f0);
        prefetch_l2(c.b1 + l * F + f0, f1 - f0);
        prefetch_l2(c.s2 + l * D + d0, d1 - d0);
        prefetch_l2(c.b2 + l * D + d0, d1 - d0);
      }
      pr.tiles(c.w1t + l * df, F, D);
      pr.tiles(c.w2t + l * df, D, F);
    }
    return;
  }

  float* red = reinterpret_cast<float*>(smem + s.red);
  float* stats = reinterpret_cast<float*>(smem + s.stats);
  Clock* clock = reinterpret_cast<Clock*>(stats + 2 * kMaxW + 2);  // 8-byte aligned
  if (p.stamps) {
    if (threadIdx.x == 0) clock->gemm = clock->waited = clock->mma = 0;
    ring.clock = clock;
  }
  float* wred = reinterpret_cast<float*>(smem + s.wred);
  bf16* act = reinterpret_cast<bf16*>(smem + s.act);
  int rbuf = 0;
  unsigned int target = 0;
  stamp(p.stamps, p.phases, 0, kStart);
  for (int l = c.l0; l < c.l1; ++l) {
    const int k = 2 * (l - c.l0);     // the layer's fc1 phase; k + 1 its fc2
    ln_rows(p, c.ln_s + l * D, c.ln_b + l * D, act, stats, wred);
    gemm<1>(p, ring, F, D, act, red, rbuf, {c.s1 + l * F, c.b1 + l * F, nullptr, nullptr}, kGelu,
            l);
    grid_barrier(p, target, k, ring.clock);
    load_rows(p, p.hid, F, act);
    gemm<1>(p, ring, D, F, act, red, rbuf, {c.s2 + l * D, c.b2 + l * D, nullptr, p.x}, kResidual,
            l);
    if (l + 1 < c.l1) grid_barrier(p, target, k + 1, ring.clock);
  }
  stamp(p.stamps, p.phases, p.phases - 1, kArrive);
  stamp(p.stamps, p.phases, p.phases - 1, kLeave);
  stamp_clock(p, ring.clock, p.phases - 1);
}

}  // namespace

// Device pointers of contiguous tensors (shapes in Chain); x (D) bf16 is
// updated in place; `work` holds 16 + 2 F bytes (the grid barrier's
// counter, zeroed by the launch, then h); `stamps` null or (2, 2 (l1 - l0),
// kStamps) u64, phase 2 i the fc1 phase of layer l0 + i and 2 i + 1 its
// fc2. Needs D and F multiples of 128 and 0 <= l0 < l1 <= L. Returns the
// CUDA error of the launch (cudaErrorInvalidValue for shapes it does not
// take).
extern "C" int twt_mlp_chain(void* x, const void* ln_s, const void* ln_b, const void* s1,
                             const void* b1, const void* s2, const void* b2, const void* w1t,
                             const void* w2t, void* work, void* stamps, int L, int D, int F,
                             int l0, int l1, int device, void* stream) {
  if (D < 128 || F < 128 || D % 128 || F % 128 || l0 < 0 || l0 >= l1 || l1 > L)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args p = {};
  p.D = D; p.F = F; p.W = 1;
  p.pitch = (D > F ? D : F) + 8;
  p.x = static_cast<bf16*>(x);
  p.bar = static_cast<unsigned int*>(work);
  p.hid = reinterpret_cast<bf16*>(static_cast<unsigned char*>(work) + 16);
  p.stamps = static_cast<unsigned long long*>(stamps);
  p.phases = 2 * (l1 - l0);
  Chain c;
  c.w1t = static_cast<const int8_t*>(w1t);
  c.w2t = static_cast<const int8_t*>(w2t);
  c.ln_s = static_cast<const float*>(ln_s);
  c.ln_b = static_cast<const float*>(ln_b);
  c.s1 = static_cast<const float*>(s1);
  c.b1 = static_cast<const float*>(b1);
  c.s2 = static_cast<const float*>(s2);
  c.b2 = static_cast<const float*>(b2);
  c.l0 = l0;
  c.l1 = l1;
  static size_t opened[64];
  void* args[] = {&p, &c};
  return ring_launch(reinterpret_cast<const void*>(mlp_chain_kernel), opened, p, 1, args, 16,
                     device, static_cast<cudaStream_t>(stream));
}
