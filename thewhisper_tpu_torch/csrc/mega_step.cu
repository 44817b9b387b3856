// K3: the batch-1 decoder step of an int8 "S" engine in one launch.
//
// Replaces thewhisper_tpu/ops/mega_step.py:602, `run` in _build_mega_fn:
// the Pallas TPU megakernel that the JAX package's greedy loop calls for
// every token of a bs=1 bf16 engine with int8 weights and int8 cross K/V.
// For each of L layers: LN1, the fused int8 qkv product (k and v also go to
// self-cache slot `pos`, read from device memory as the TPU kernel reads it
// from SMEM), self-attention over slots [0, pos] (the fresh
// token's k/v from this launch), the int8 out-projection, LN, the int8
// cross query, cross-attention over the int8 K/V with its scales folded
// (the K scale into the query, the V scale into the output) and the
// alignment heads' probabilities summed into `align`, the int8 cross
// out-projection, LN2, int8 fc1, tanh GELU, int8 fc2. Then the final LN and
// the int8 tied-table logits, (x . q[v]) * s[v] in f32.
// ops/mega_step.py::mega_step_plain is the same function in plain torch.
//
// K3 is the decode engine of mega_common.cuh at a window of one row, with
// the alignment kept: its bound, design and numerics are described there.
// It is K4 (mega_verify.cu) at W = 1, so a window's row j equals K3
// stepping token j.

#include "mega_common.cuh"

using namespace engine;

// Pointers are device pointers of contiguous tensors (shapes in Args); `x`
// (D) bf16 is the embedded token, updated in place; `work` holds
// `work_size` bytes, at least work_bytes(L, 1, ...), the counters first
// (zeroed by the launch); `stamps` null or (2, 8 L + 1, 3) u64; `pos` one
// int32, the cache slot, read by the kernel; `pos_error` one int32 that the
// kernel sets to 1 (and does nothing else) when pos is outside [0, bound).
// (sc, sn) and (cc, cn) are the self and cross chunk lengths and counts
// (ops/mega_step.py::attention_chunks), sc sn >= bound. Needs D == 64 H, D
// and F multiples of 128, 1 <= bound <= S. Returns the CUDA error of the
// launch (cudaErrorInvalidValue for shapes or chunks it does not take).
extern "C" int twt_mega_step(const void* qkv_w, const void* o_w, const void* cq_w,
                             const void* co_w, const void* fc1_w, const void* fc2_w,
                             const void* smalls, const void* lnp, const void* emb_q,
                             const void* emb_s, void* self_k, void* self_v, const void* cross_k,
                             const void* cross_v, const void* cross_ks, const void* cross_vs,
                             const void* heads, void* x, void* work, long long work_size,
                             void* logits, void* align, void* stamps, const void* pos,
                             void* pos_error, int L, int D, int F, int H, int V, int S, int T,
                             int A, int bound, int capture, int sc, int sn, int cc, int cn,
                             int device, void* stream) {
  if (!shapes_ok(L, D, F, H, V, S, T, 1, bound) || A < 0 || work_size < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args p = {};
  p.L = L; p.D = D; p.F = F; p.H = H; p.V = V; p.S = S; p.T = T; p.A = A; p.W = 1;
  p.pos = static_cast<const int*>(pos); p.err = static_cast<int*>(pos_error); p.bound = bound;
  p.capture = capture && A > 0; p.sc = sc; p.sn = sn; p.cc = cc; p.cn = cn;
  const void* w16[16] = {qkv_w, o_w, cq_w, co_w, fc1_w, fc2_w, smalls, lnp, emb_q, emb_s,
                         self_k, self_v, cross_k, cross_v, cross_ks, cross_vs};
  bind(p, w16, x, work);
  p.heads = static_cast<const int*>(heads);
  p.logits = static_cast<float*>(logits);
  p.align = static_cast<float*>(align);
  p.stamps = static_cast<unsigned long long*>(stamps);
  return launch<1>(p, static_cast<size_t>(work_size), device, static_cast<cudaStream_t>(stream));
}
