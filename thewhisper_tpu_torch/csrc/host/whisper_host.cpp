// Host runtime of the PyTorch port: the DTW path of the word-timestamp
// alignment (once a decoded window, every streaming tick included),
// Levenshtein edit statistics (WER/CER), the streaming pipeline's rolling
// audio ring buffer, and a linear resampler for hosts without scipy.
//
// The port's own copy of the JAX package's host runtime, the same
// arithmetic, so both give the same bits; the ring copies its two
// contiguous pieces with memcpy where the JAX copy indexes each sample
// modulo the capacity. Plain C ABI for ctypes; no dependencies. Built
// at first use by thewhisper_tpu_torch/native_lib.py:
//   g++ -O3 -shared -fPIC -std=c++17 -o libwhisper_host-<hash>.so whisper_host.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// DTW: monotonic alignment through an (s x t) cost matrix.
// Moves: diagonal, up (advance text), left (advance time) — matches the
// numpy version, align.py::dtw_path_plain (and HF _dynamic_time_warping).
// Returns the path length; text_idx/time_idx must hold >= s + t entries.
// ---------------------------------------------------------------------------
int whisper_dtw_path(const double* cost, int s, int t,
                     int* text_idx, int* time_idx) {
  const double inf = 1e300;
  const int w = t + 1;
  std::vector<double> acc(static_cast<size_t>(s + 1) * w, inf);
  std::vector<int8_t> trace(static_cast<size_t>(s + 1) * w, 2);
  acc[0] = 0.0;
  for (int j = 0; j <= t; ++j) trace[j] = 2;
  for (int i = 0; i <= s; ++i) trace[static_cast<size_t>(i) * w] = 1;

  for (int i = 1; i <= s; ++i) {
    const double* row_cost = cost + static_cast<size_t>(i - 1) * t;
    double* acc_prev = acc.data() + static_cast<size_t>(i - 1) * w;
    double* acc_cur = acc.data() + static_cast<size_t>(i) * w;
    int8_t* tr_cur = trace.data() + static_cast<size_t>(i) * w;
    for (int j = 1; j <= t; ++j) {
      const double c_diag = acc_prev[j - 1];
      const double c_up = acc_prev[j];
      const double c_left = acc_cur[j - 1];
      // HF's exact tie cascade (strict <): ties fall through to LEFT,
      // even when left is not the minimum. Matches align.py::dtw_path_plain.
      double best;
      int8_t move;
      if (c_diag < c_up && c_diag < c_left) { best = c_diag; move = 0; }
      else if (c_up < c_diag && c_up < c_left) { best = c_up; move = 1; }
      else { best = c_left; move = 2; }
      acc_cur[j] = row_cost[j - 1] + best;
      tr_cur[j] = move;
    }
  }

  int i = s, j = t, n = 0;
  while (i > 0 || j > 0) {
    text_idx[n] = i - 1;
    time_idx[n] = j - 1;
    ++n;
    switch (trace[static_cast<size_t>(i) * w + j]) {
      case 0: --i; --j; break;
      case 1: --i; break;
      default: --j; break;
    }
  }
  std::reverse(text_idx, text_idx + n);
  std::reverse(time_idx, time_idx + n);
  return n;
}

// ---------------------------------------------------------------------------
// Levenshtein S/D/I/hits between two int32 token sequences.
// out5 = {subs, dels, ins, hits, distance}
// ---------------------------------------------------------------------------
void whisper_edit_stats(const int32_t* ref, int n, const int32_t* hyp, int m,
                        int32_t* out5) {
  const int w = m + 1;
  std::vector<int32_t> cost(static_cast<size_t>(n + 1) * w);
  for (int i = 0; i <= n; ++i) cost[static_cast<size_t>(i) * w] = i;
  for (int j = 0; j <= m; ++j) cost[j] = j;
  for (int i = 1; i <= n; ++i) {
    const int32_t r = ref[i - 1];
    int32_t* prev = cost.data() + static_cast<size_t>(i - 1) * w;
    int32_t* cur = cost.data() + static_cast<size_t>(i) * w;
    for (int j = 1; j <= m; ++j) {
      const int32_t sub = prev[j - 1] + (r != hyp[j - 1] ? 1 : 0);
      const int32_t del = prev[j] + 1;
      const int32_t ins = cur[j - 1] + 1;
      cur[j] = std::min(sub, std::min(del, ins));
    }
  }
  // Backtrace for the S/D/I split (same tie-breaking as utils/wer.py's numpy
  // version, edit_stats_plain:
  // prefer diagonal, then deletion, then insertion).
  int i = n, j = m;
  int32_t subs = 0, dels = 0, ins = 0, hits = 0;
  while (i > 0 || j > 0) {
    const int32_t cur = cost[static_cast<size_t>(i) * w + j];
    if (i > 0 && j > 0 &&
        cur == cost[static_cast<size_t>(i - 1) * w + (j - 1)] +
                   (ref[i - 1] != hyp[j - 1] ? 1 : 0)) {
      if (ref[i - 1] != hyp[j - 1]) ++subs; else ++hits;
      --i; --j;
    } else if (i > 0 && cur == cost[static_cast<size_t>(i - 1) * w + j] + 1) {
      ++dels; --i;
    } else {
      ++ins; --j;
    }
  }
  out5[0] = subs; out5[1] = dels; out5[2] = ins; out5[3] = hits;
  out5[4] = subs + dels + ins;
}

// ---------------------------------------------------------------------------
// Audio ring buffer: single-producer/single-consumer float samples with
// amortized O(1) append and O(n) drain — the rolling stream buffer backend.
// ---------------------------------------------------------------------------
struct Ring {
  std::vector<float> data;
  size_t head = 0;  // read position
  size_t size = 0;  // valid samples
};

// Copies n samples from offset past the head into dst: the stored run is
// at most two contiguous pieces, one up to the end of the storage and one
// from its start.
static void ring_copy_out(const Ring* r, size_t offset, size_t n, float* dst) {
  const size_t cap = r->data.size();
  const size_t start = (r->head + offset) % cap;
  const size_t first = std::min(n, cap - start);
  std::memcpy(dst, r->data.data() + start, first * sizeof(float));
  std::memcpy(dst + first, r->data.data(), (n - first) * sizeof(float));
}

void* whisper_ring_new(size_t capacity) {
  Ring* r = new Ring();
  r->data.resize(std::max<size_t>(capacity, 1024));
  return r;
}

void whisper_ring_free(void* h) { delete static_cast<Ring*>(h); }

static void ring_grow(Ring* r, size_t need) {
  size_t cap = r->data.size();
  if (r->size + need <= cap) return;
  size_t new_cap = cap;
  while (r->size + need > new_cap) new_cap *= 2;
  std::vector<float> fresh(new_cap);
  ring_copy_out(r, 0, r->size, fresh.data());
  r->data.swap(fresh);
  r->head = 0;
}

size_t whisper_ring_write(void* h, const float* src, size_t n) {
  Ring* r = static_cast<Ring*>(h);
  ring_grow(r, n);
  const size_t cap = r->data.size();
  const size_t tail = (r->head + r->size) % cap;
  const size_t first = std::min(n, cap - tail);
  std::memcpy(r->data.data() + tail, src, first * sizeof(float));
  std::memcpy(r->data.data(), src + first, (n - first) * sizeof(float));
  r->size += n;
  return n;
}

// Copy out up to n samples starting at offset without consuming.
size_t whisper_ring_peek(void* h, float* dst, size_t offset, size_t n) {
  Ring* r = static_cast<Ring*>(h);
  if (offset >= r->size) return 0;
  const size_t avail = std::min(n, r->size - offset);
  ring_copy_out(r, offset, avail, dst);
  return avail;
}

// Drop n samples from the front (buffer trim).
size_t whisper_ring_discard(void* h, size_t n) {
  Ring* r = static_cast<Ring*>(h);
  const size_t drop = std::min(n, r->size);
  r->head = (r->head + drop) % r->data.size();
  r->size -= drop;
  return drop;
}

size_t whisper_ring_size(void* h) { return static_cast<Ring*>(h)->size; }

void whisper_ring_clear(void* h) {
  Ring* r = static_cast<Ring*>(h);
  r->head = 0;
  r->size = 0;
}

// ---------------------------------------------------------------------------
// Linear resampler (fallback when scipy's polyphase is unavailable).
// ---------------------------------------------------------------------------
size_t whisper_resample_linear(const float* in, size_t n, double ratio,
                               float* out, size_t out_cap) {
  if (n == 0 || ratio <= 0.0) return 0;
  const size_t n_out =
      std::min(out_cap, static_cast<size_t>(n * ratio + 0.5));
  for (size_t k = 0; k < n_out; ++k) {
    const double pos = k / ratio;
    const size_t lo = std::min(static_cast<size_t>(pos), n - 1);
    const size_t hi = std::min(lo + 1, n - 1);
    const double w = pos - lo;
    out[k] = static_cast<float>((1.0 - w) * in[lo] + w * in[hi]);
  }
  return n_out;
}

}  // extern "C"
