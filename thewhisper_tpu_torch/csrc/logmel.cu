// Log-mel front end (K1): raw audio -> log10 mel power, one launch.
//
// Replaces the TPU kernel thewhisper_tpu/ops/logmel_pallas.py::_logmel_raw
// (body _logmel_kernel) together with the framing it needs (_frame).
//
// What it computes, per batch row b and frame f < F = N / 160:
//   x[n]   = audio[b, reflect(f * 160 + n - 200)],  n < 400   (center=True)
//   X[k]   = sum_n x[n] * w[n] * exp(-2 pi i n k / 400),  k < 201
//   out[f] = log10(max(|X|^2 @ mel_fb, 1e-10))                (B, F, n_mels)
// The target is parity with the HF feature extractor in f32. The max-8
// clamp and (x + 4) / 4 stay outside, as in the JAX package.
//
// Bound on the H100: arithmetic. A direct DFT is 400 x 402 multiply-adds
// a frame against 1.6 KB of audio read; the mel stage and the log are
// small.
// Design: each windowed frame wx is folded about its middle,
//   c[n] = wx[n] + wx[400 - n],  s[n] = wx[n] - wx[400 - n]  (0 < n < 200),
// c[0] = wx[0], c[200] = wx[200], so that Re X[k] = sum c[n] cos and
// -Im X[k] = sum s[n] sin over 208 rows n: half the direct sum's products,
// exact for any window. The two sums are matrix products of the folded
// frames by a constant basis (ops/logmel.py: 26 groups of 8 bins, each the
// cos then the sin of its bins), on the tensor cores with mma.sync m16n8k8
// TF32 and f32 accumulation. Plain TF32 keeps 10 mantissa bits and breaks HF
// parity, so each operand is split into a TF32 high part and a TF32 rest
// (cvt.rna) and the product is a_lo b_hi + a_hi b_lo + a_hi b_hi (3xTF32,
// the counterpart of the TPU kernel's Precision.HIGHEST); the basis halves
// are precomputed by the wrapper in the order the B fragments are read (a
// float4 a lane: hi and lo of two rows). A group's cos and sin n8 blocks
// give a thread the real and imaginary parts of the same two bins, so
// |X|^2 is formed in registers.
// One block per (tile of 64 frames, split of the mels, batch row); four
// warps, each 32 frames (two m16 tiles) by 4 bin groups, so each B fragment
// feeds six products. A split covers at most 64 bins, those its mels'
// filters touch, so the card fills at batch 1 (3000 frames are 47 tiles,
// times the splits) and no bin a split does not need is computed. The block
// stages the tile's 10,480 samples and the window in shared memory once,
// reflect pad done by index (no frame tensor in device memory); every 160
// samples are followed by 4 floats of skew, since the hop is a multiple of
// 32 banks and the 8 frame rows of an A fragment would otherwise hit one
// bank. The fold is formed from there as the A fragments are built. The B
// fragments (0.7 MB for the whole basis, resident in L2) are read as one
// float4 a lane through L1, which the two warps of a column half share. The
// mel stage reads each mel's non-zero span of the filter bank (at most 16
// bins; 9 at 128 mels, 14 at 80) from the power spectrum, which takes the
// staged span's place in shared memory.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kNFft = 400;
constexpr int kHop = 160;
constexpr int kPad = kNFft / 2;
constexpr int kTileF = 64;                  // frames a block
constexpr int kThreads = 128;               // 2 x 2 warps of 32 frames x 4 bin groups
constexpr int kNb = 16;                     // n8 blocks a split: 8 groups of cos, sin
constexpr int kNbWarp = kNb / 2;
constexpr int kNbTotal = 52;                // 416 basis columns, 26 groups of 8 bins
constexpr int kKSteps = 26;                 // 208 folded rows, 8 a k-step
constexpr int kSkew = 4;                    // floats after every 160 samples
constexpr int kRowStride = kHop + kSkew;    // one frame row in the staged span
constexpr int kSpan = (kTileF - 1) * kHop + kNFft;
constexpr int kXsLen = kSpan + kSkew * (kSpan / kHop + 1);
constexpr int kPowStride = 4 * kNb + 4;     // 68
constexpr int kMaxSpan = 16;
constexpr int kSmem = (kXsLen + kNFft) * 4;  // 45 KB: no opt-in above 48 KB needed

static_assert(kTileF * kPowStride <= kXsLen, "the power spectrum fits in the span's place");
static_assert(kSpan % 4 == 0 && kHop % 4 == 0 && kPad % 4 == 0, "float4 staging");

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 3xTF32 product a b of one n8 block: a_lo b_hi + a_hi b_lo + a_hi b_hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&hi)[4],
                                           const uint32_t (&lo)[4], float4 b) {
  const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
  mma_tf32(d, lo, bh0, bh1);
  mma_tf32(d, hi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, hi, bh0, bh1);
}

// Offset of sample n of a frame row in the staged span.
__device__ __forceinline__ int skewed(int n) { return n + kSkew * (n / kHop); }

// basis: (26 k-steps, 52 n8 blocks, 32 lanes) float4s, lane (g, t) = (lane / 4,
// lane % 4) holding hi(n = 8 ks + t), hi(n + 4), lo(n), lo(n + 4) of column
// 8 nb + g (ops/logmel.py: the folded basis). window: (400,). mel_w: (n_mels,
// 16) the non-zero span of each filter; mel_span: (n_mels, 2) its first bin
// and length. splits: (n_splits, 3) first group of 8 bins, first mel, end mel.
__global__ void __launch_bounds__(kThreads)
logmel_kernel(const float* __restrict__ audio, const float4* __restrict__ basis,
              const float* __restrict__ window, const float* __restrict__ mel_w,
              const int* __restrict__ mel_span, const int* __restrict__ splits,
              float* __restrict__ out, int n_samples, int n_frames, int n_mels) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ws = xs + kXsLen;

  const int b = blockIdx.z;
  const int grp_lo = splits[3 * blockIdx.y];
  const int m_lo = splits[3 * blockIdx.y + 1];
  const int m_hi = splits[3 * blockIdx.y + 2];
  const int nb_count = min(kNb, kNbTotal - 2 * grp_lo);
  const int f0 = blockIdx.x * kTileF;

  // Frame f covers padded samples [f * 160, f * 160 + 400); padded index p
  // is audio index p - 200, reflected without repeating the edge sample.
  // Staged four samples at a time: the span starts on a multiple of 4 (as
  // do the row, which the wrapper aligns to 16 bytes, and the skew), so a
  // float4 wholly inside the row is one load.
  const float* row = audio + static_cast<size_t>(b) * n_samples;
  const int start = f0 * kHop - kPad;
#pragma unroll 4
  for (int q = threadIdx.x; q < kSpan / 4; q += kThreads) {
    const int p = 4 * q;
    const int i0 = start + p;
    float4 v;
    if (i0 >= 0 && i0 + 3 < n_samples) {
      v = __ldg(reinterpret_cast<const float4*>(row + i0));
    } else {
      float e[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int i = i0 + u;
        if (i < 0) i = -i;
        if (i >= n_samples) i = 2 * (n_samples - 1) - i;
        e[u] = (i >= 0 && i < n_samples) ? row[i] : 0.0f;
      }
      v = make_float4(e[0], e[1], e[2], e[3]);
    }
    *reinterpret_cast<float4*>(xs + skewed(p)) = v;
  }
  for (int n = threadIdx.x; n < kNFft; n += kThreads) ws[n] = window[n];
  __syncthreads();

  // Warp (fh, ch): frames 32 fh .. 32 fh + 31 as two m16 tiles, bin groups
  // 4 ch .. 4 ch + 3 of the split (n8 blocks 8 ch .. 8 ch + 7: each group's
  // cos, then its sin). Each B fragment (a float4 a lane, read through L1,
  // which the warp of the other frame half shares) feeds six products.
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int fh = warp & 1;
  const int nb0 = (warp >> 1) * kNbWarp;
  const float* xr = xs + (32 * fh + g) * kRowStride;
  const float4* bp = basis + (2 * grp_lo + nb0) * 32 + lane;

  float acc[2][kNbWarp][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < kNbWarp; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;

#pragma unroll 2
  for (int ks = 0; ks < kKSteps; ++ks) {
    float4 bv[kNbWarp];
#pragma unroll
    for (int j = 0; j < kNbWarp; ++j)
      if (nb0 + j < nb_count) bv[j] = __ldg(bp + (ks * kNbTotal + j) * 32);
    // The A fragment's columns: rows n = 8 ks + t and n + 4 of the fold,
    // each with its partner 400 - n (weight 0 at n = 0 and n >= 200).
    int off1[2], off2[2];
    float w1[2], w2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = 8 * ks + t + 4 * h;
      const int partner = n == 0 ? 0 : kNFft - n;
      off1[h] = skewed(n);
      off2[h] = skewed(partner);
      w1[h] = ws[n];
      w2[h] = (n == 0 || n >= kNFft / 2) ? 0.0f : ws[partner];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t c_hi[4], c_lo[4], s_hi[4], s_lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a0..a3: (row g, col t), (row g + 8, col t), (g, t + 4), (g + 8, t + 4).
        const float* x = xr + (16 * mt + 8 * (e & 1)) * kRowStride;
        const int h = e >> 1;
        const float pw = w2[h] * x[off2[h]];
        const float c = fmaf(w1[h], x[off1[h]], pw);
        const float s = fmaf(w1[h], x[off1[h]], -pw);
        c_hi[e] = tf32(c);
        c_lo[e] = tf32(c - __uint_as_float(c_hi[e]));
        s_hi[e] = tf32(s);
        s_lo[e] = tf32(s - __uint_as_float(s_hi[e]));
      }
#pragma unroll
      for (int j = 0; j < kNbWarp; j += 2) {
        if (nb0 + j < nb_count) {
          mma_3xtf32(acc[mt][j], c_hi, c_lo, bv[j]);
          mma_3xtf32(acc[mt][j + 1], s_hi, s_lo, bv[j + 1]);
        }
      }
    }
  }
  __syncthreads();  // the span is read; the power spectrum takes its place

  // acc[mt][j] (cos) and acc[mt][j + 1] (sin) hold bins 8 (grp_lo + nb0 / 2
  // + j / 2) + 2 t and the next, for frame rows 32 fh + 16 mt + g and 8 below.
  float* power = xs;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = 32 * fh + 16 * mt + g;
#pragma unroll
    for (int j = 0; j < kNbWarp; j += 2) {
      if (nb0 + j < nb_count) {
        const float* c = acc[mt][j];
        const float* s = acc[mt][j + 1];
        const int bin = 4 * (nb0 + j) + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          power[(r + 8 * (e >> 1)) * kPowStride + bin + (e & 1)] = c[e] * c[e] + s[e] * s[e];
      }
    }
  }
  __syncthreads();

  const int n_m = m_hi - m_lo;
  const int bin0 = 8 * grp_lo;
  for (int idx = threadIdx.x; idx < kTileF * n_m; idx += kThreads) {
    const int f = idx / n_m;
    const int m = m_lo + idx - f * n_m;
    if (f0 + f >= n_frames) break;  // idx only grows past the last frame
    const int first = mel_span[2 * m];
    const int count = mel_span[2 * m + 1];
    const float* pw = power + f * kPowStride + first - bin0;
    const float* w = mel_w + m * kMaxSpan;
    float sum = 0.0f;
    for (int i = 0; i < count; ++i) sum = fmaf(pw[i], __ldg(w + i), sum);
    out[(static_cast<size_t>(b) * n_frames + f0 + f) * n_mels + m] = log10f(fmaxf(sum, 1e-10f));
  }
}

}  // namespace

// audio (batch, n_samples) f32 contiguous and 16-byte aligned, n_samples %
// 160 == 0 and > 200; basis (26, 52, 32, 4), window (400,), mel_w (n_mels,
// 16), mel_span (n_mels, 2) int32, splits (n_splits, 3) int32 as
// logmel_kernel reads them; out (batch, n_samples / 160, n_mels) f32
// contiguous. Returns cudaGetLastError().
extern "C" int twt_logmel(const float* audio, const float* basis, const float* window,
                          const float* mel_w, const int* mel_span, const int* splits, float* out,
                          int batch, int n_samples, int n_mels, int n_splits, int device,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_frames = n_samples / kHop;
  const dim3 grid((n_frames + kTileF - 1) / kTileF, n_splits, batch);
  logmel_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      audio, reinterpret_cast<const float4*>(basis), window, mel_w, mel_span, splits, out,
      n_samples, n_frames, n_mels);
  return static_cast<int>(cudaGetLastError());
}
