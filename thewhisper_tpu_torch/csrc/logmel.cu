// Log-mel front end (K1): raw audio -> log10 mel power, one launch.
//
// Replaces the TPU kernel thewhisper_tpu/ops/logmel_pallas.py::_logmel_raw
// (body _logmel_kernel) together with the framing it needs (_frame).
//
// What it computes, per batch row b and frame f < F = N / 160:
//   x[n]   = audio[b, reflect(f * 160 + n - 200)],  n < 400   (center=True)
//   X[k]   = sum_n x[n] * w[n] * exp(-2 pi i n k / 400),  k < 201
//   out[f] = log10(max(|X|^2 @ mel_fb, 1e-10))                (B, F, n_mels)
// All f32 on the CUDA cores (no TF32): the target is parity with the HF
// feature extractor. The max-8 clamp and (x + 4) / 4 stay outside, as in
// the JAX package.
//
// Bound on the H100: on-chip, not device memory. 400 x 201 x 2 FMAs per
// frame (the DFT) against 1.6 KB of audio read per frame. The inner loop
// below issues 16 shared-memory loads per 32 FMAs, so load issue, not the
// f32 FMA rate, is what bounds this first version.
// Design: one block per (batch row, tile of 16 frames). The block loads the
// tile's 2800 samples and the 400-point window once into shared memory,
// doing the reflect pad by index at both ends (no frame tensor in device
// memory, none of the TPU's 512-lane padding). Thread k owns DFT bin k and
// keeps the 16 frames' Re/Im sums in registers, so each cos/sin table entry
// it loads (coalesced across the warp, L1/L2 resident: 643 KB in all) and
// scales by the window feeds 32 FMAs, and every sample read is a
// shared-memory broadcast. The power spectrum goes to shared memory and the
// mel projection runs from there.

#include <cuda_runtime.h>

namespace {

constexpr int kNFft = 400;
constexpr int kHop = 160;
constexpr int kPad = kNFft / 2;
constexpr int kBins = kNFft / 2 + 1;   // 201
constexpr int kTileF = 16;
constexpr int kThreads = 256;          // >= kBins
constexpr int kSpan = (kTileF - 1) * kHop + kNFft;

__global__ void __launch_bounds__(kThreads)
logmel_kernel(const float* __restrict__ audio, const float* __restrict__ cos_t,
              const float* __restrict__ sin_t, const float* __restrict__ window,
              const float* __restrict__ mel_fb, float* __restrict__ out, int n_samples,
              int n_frames, int n_mels) {
  __shared__ float xs[kSpan];
  __shared__ float ws[kNFft];
  __shared__ float power[kTileF][kBins];

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kTileF;
  const float* row = audio + static_cast<size_t>(b) * n_samples;

  // Frame f covers padded samples [f * 160, f * 160 + 400); padded index p
  // is audio index p - 200, reflected without repeating the edge sample.
  for (int p = threadIdx.x; p < kSpan; p += kThreads) {
    int i = f0 * kHop + p - kPad;
    if (i < 0) i = -i;
    if (i >= n_samples) i = 2 * (n_samples - 1) - i;
    xs[p] = (i >= 0 && i < n_samples) ? row[i] : 0.0f;
  }
  for (int n = threadIdx.x; n < kNFft; n += kThreads) ws[n] = window[n];
  __syncthreads();

  const int k = threadIdx.x;
  if (k < kBins) {
    float re[kTileF], im[kTileF];
#pragma unroll
    for (int f = 0; f < kTileF; ++f) {
      re[f] = 0.0f;
      im[f] = 0.0f;
    }
    for (int n = 0; n < kNFft; ++n) {
      const float c = ws[n] * __ldg(cos_t + n * kBins + k);
      const float s = ws[n] * __ldg(sin_t + n * kBins + k);
#pragma unroll
      for (int f = 0; f < kTileF; ++f) {
        const float x = xs[f * kHop + n];
        re[f] = fmaf(x, c, re[f]);
        im[f] = fmaf(x, s, im[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kTileF; ++f) power[f][k] = re[f] * re[f] + im[f] * im[f];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kTileF * n_mels; idx += kThreads) {
    const int f = idx / n_mels;
    const int m = idx - f * n_mels;
    if (f0 + f >= n_frames) continue;
    float acc = 0.0f;
    for (int kk = 0; kk < kBins; ++kk)
      acc = fmaf(power[f][kk], __ldg(mel_fb + kk * n_mels + m), acc);
    out[(static_cast<size_t>(b) * n_frames + f0 + f) * n_mels + m] =
        log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// audio (batch, n_samples) f32 contiguous, n_samples % 160 == 0 and > 200;
// cos_t, sin_t (400, 201): cos and sin of 2 pi n k / 400; window (400,);
// mel_fb (201, n_mels); out (batch, n_samples / 160, n_mels), all f32
// contiguous. Returns cudaGetLastError().
extern "C" int twt_logmel(const float* audio, const float* cos_t, const float* sin_t,
                          const float* window, const float* mel_fb, float* out, int batch,
                          int n_samples, int n_mels, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_frames = n_samples / kHop;
  const dim3 grid((n_frames + kTileF - 1) / kTileF, batch);
  logmel_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      audio, cos_t, sin_t, window, mel_fb, out, n_samples, n_frames, n_mels);
  return static_cast<int>(cudaGetLastError());
}
