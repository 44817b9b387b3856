// K4: the speculative-verify window of an int8 "S" engine in one launch.
//
// Replaces thewhisper_tpu/ops/mega_step.py:1061, the pallas_call in `run`
// of _build_mega_verify_fn: the TPU megakernel that the JAX package's
// speculative loop calls for every verify round of a bs=1 bf16 engine with
// int8 weights and int8 cross K/V. It is K3 (mega_step.cu) over a window
// of W <= 16 tokens at cache slots pos .. pos + W - 1: for each of L
// layers, LN1 and the fused int8 qkv of every row (k and v also go to the
// cache slots), self-attention of row r over slots [0, pos + r] (the cache
// below the window plus the window's rows up to r), the int8
// out-projection, LN, the int8 cross query, cross-attention over the int8
// K/V with its scales folded, the int8 cross out-projection, LN2, int8
// fc1, tanh GELU and int8 fc2; then the final LN and the int8 tied-table
// logits of every row. No alignment is kept (decodes that need it take the
// plain verify). ops/mega_step.py::mega_verify_plain is the same function
// in plain torch.
//
// K4 is the decode engine of mega_common.cuh (bound, design and numerics
// there) at a window of W rows: every weight tile is unpacked once and
// multiplied on the tensor cores with all W rows as one n = 8 operand
// (W <= 8) or two (W <= 16), and every attention item reads its cross K/V
// chunk once for all W rows. At large-v3 a round reads what a K3 step
// reads, about 0.93 GB (0.28 ms at 3.35 TB/s); the products, 1.6 W GFLOP
// in bf16, stay far below the tensor cores' rate. Row r equals K3's step at
// slot pos + r.

#include "mega_common.cuh"

using namespace engine;

// Pointers are device pointers of contiguous tensors (shapes in Args); `x`
// is the embedded window (W, D) bf16, updated in place; `work` holds
// `work_size` bytes, at least work_bytes(L, W, ...), the counters first;
// `stamps` null or (2, 8 L + 1, 3) u64; `pos` and `pos_error` as for
// twt_mega_step (pos + W <= bound); the chunks as for twt_mega_step. Needs
// D == 64 H, D and F multiples of 128, 1 <= W <= 16, W <= bound <= S.
// Returns the CUDA error of the launch.
extern "C" int twt_mega_verify(const void* qkv_w, const void* o_w, const void* cq_w,
                               const void* co_w, const void* fc1_w, const void* fc2_w,
                               const void* smalls, const void* lnp, const void* emb_q,
                               const void* emb_s, void* self_k, void* self_v, const void* cross_k,
                               const void* cross_v, const void* cross_ks, const void* cross_vs,
                               void* x, void* work, long long work_size, void* logits,
                               void* stamps, const void* pos, void* pos_error, int L, int D, int F,
                               int H, int V, int S, int T, int W, int bound, int sc, int sn,
                               int cc, int cn, int device, void* stream) {
  if (!shapes_ok(L, D, F, H, V, S, T, W, bound) || work_size < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args p = {};
  p.L = L; p.D = D; p.F = F; p.H = H; p.V = V; p.S = S; p.T = T; p.A = 0; p.W = W;
  p.pos = static_cast<const int*>(pos); p.err = static_cast<int*>(pos_error); p.bound = bound;
  p.capture = 0; p.sc = sc; p.sn = sn; p.cc = cc; p.cn = cn;
  const void* w16[16] = {qkv_w, o_w, cq_w, co_w, fc1_w, fc2_w, smalls, lnp, emb_q, emb_s,
                         self_k, self_v, cross_k, cross_v, cross_ks, cross_vs};
  bind(p, w16, x, work);
  p.logits = static_cast<float*>(logits);
  p.stamps = static_cast<unsigned long long*>(stamps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t size = static_cast<size_t>(work_size);
  return W <= 8 ? launch<1>(p, size, device, st) : launch<2>(p, size, device, st);
}
