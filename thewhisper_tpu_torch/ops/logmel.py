"""Log-mel front end: the K1 kernel's wrapper and its plain version.

``log_mel`` maps (B, N) f32 audio to (B, N // 160, n_mels) log10 mel power,
the part of the HF feature extractor that thewhisper_tpu runs in the Pallas
kernel ``ops/logmel_pallas.py::_logmel_raw``. On a CUDA tensor it launches
``csrc/logmel.cu`` (framing, window, the DFT of each frame folded about
its middle as a 3xTF32 tensor-core product, power, the mel filters'
non-zero spans and log10 in one launch); on a CPU tensor it runs
:func:`log_mel_plain`. The kernel's tables: :func:`dft_basis` and
:func:`pack_basis` once per device, :func:`mel_spans` and
:func:`mel_splits` once per filter-bank tensor; :func:`fold_frames` is the
fold as the kernel computes it. The dynamic
range clamp and the (x + 4) / 4 scaling follow in
``audio.features.normalize_log_mel``, outside the kernel as in JAX.
"""

from __future__ import annotations

import math
import weakref
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from thewhisper_tpu_torch.config import HOP_LENGTH, N_FFT
from thewhisper_tpu_torch.ops import _build

N_BINS = N_FFT // 2 + 1

# Launches of the CUDA kernel (not of the plain version) since import.
LOGMEL_LAUNCHES = 0


def log_mel_plain(audio: torch.Tensor, mel_fb: torch.Tensor,
                  window: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 -> (B, N // 160, n_mels) log10 mel power, plain torch."""
    n_frames = audio.shape[-1] // HOP_LENGTH
    padded = F.pad(audio[:, None].float(), (N_FFT // 2, N_FFT // 2),
                   mode="reflect")[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames]
    spec = torch.fft.rfft(frames * window, n=N_FFT, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    mel = torch.matmul(power, mel_fb)
    return torch.log10(torch.clamp_min(mel, 1e-10))


# The kernel's DFT folds each windowed frame wx about its middle:
#   c[n] = wx[n] + wx[400 - n], s[n] = wx[n] - wx[400 - n]   (0 < n < 200),
#   c[0] = wx[0], c[200] = wx[200], s[0] = s[200] = 0,
# so that Re X[k] = sum_{n <= 200} c[n] cos(2 pi n k / 400) and
# -Im X[k] = sum_{n < 200} s[n] sin(2 pi n k / 400): half the products of
# the 400-point sum, exact for any window. Its basis has N_ROWS = 208 rows
# n (201..207 zero, as are the sin rows 0 and 200) and N_COLS = 416
# columns in 26 groups of 16: the cos of 8 bins, then their sin (bins past
# 200 zero). The kernel reads it in k-steps of 8 rows and n8 blocks of 8
# columns, so n8 block 2j is group j's cos and 2j + 1 its sin.
N_ROWS = 208
N_GROUPS = 26
N_COLS = 16 * N_GROUPS
MAX_SPAN = 16      # non-zero bins a mel filter may span (9 at 128 mels, 14 at 80)
SPLIT_BINS = 64    # bins one block of the kernel computes: 8 groups


def tf32_round(x: np.ndarray) -> np.ndarray:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from zero:
    what ``cvt.rna.tf32.f32`` gives, as f32 with the low 13 bits zero."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def dft_basis() -> Tuple[np.ndarray, np.ndarray]:
    """The folded DFT basis split for the 3xTF32 product: (208, 416) f32
    ``hi`` (TF32) and ``lo`` with ``hi + lo`` the f32 basis exactly
    (``basis - hi`` is exact in f32). Entries are cos and sin of
    2 pi n k / 400, computed in f64 with the angle reduced exactly
    (n * k mod 400) and rounded once to f32, laid out as the comment above
    says."""
    n = np.arange(N_ROWS)[:, None]
    k = np.arange(8 * N_GROUPS)[None, :]
    ang = (n * k % N_FFT) * (2.0 * math.pi / N_FFT)
    cos = np.where((n <= N_FFT // 2) & (k < N_BINS), np.cos(ang), 0.0)
    sin = np.where((n >= 1) & (n < N_FFT // 2) & (k < N_BINS), np.sin(ang), 0.0)
    basis = np.stack([cos.reshape(N_ROWS, N_GROUPS, 8),
                      sin.reshape(N_ROWS, N_GROUPS, 8)], axis=2)
    basis = basis.reshape(N_ROWS, N_COLS).astype(np.float32)
    hi = tf32_round(basis)
    return hi, basis - hi


def fold_frames(frames: np.ndarray, window: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(F, 400) frames -> the folded (F, 208) c and s the kernel multiplies
    by the basis, in f32 as the kernel forms them (to f32 rounding):
    c = fma(w[n], x[n], w[400 - n] x[400 - n]), s = fma(w[n], x[n],
    -(w[400 - n] x[400 - n])), with the partner's weight 0 at n = 0 and
    n >= 200 (rows 201..207 meet zero basis rows)."""
    x = np.asarray(frames, np.float32)
    w = np.asarray(window, np.float32)
    n = np.arange(N_ROWS)
    partner = np.where(n == 0, 0, N_FFT - n)
    w2 = np.where((n == 0) | (n >= N_FFT // 2), 0.0, w[partner]).astype(np.float32)
    wx = x[:, n].astype(np.float64) * w[n]                 # exact in f64
    p2 = (x[:, partner] * w2).astype(np.float32)
    return (wx + p2).astype(np.float32), (wx - p2).astype(np.float32)


def pack_basis(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """(208, 416) halves -> the kernel's (26, 52, 32, 4) B-fragment order:
    k-step ks, n8 block nb, lane (g, t) = (lane // 4, lane % 4) holds hi and
    TF32-rounded lo of rows 8 ks + t and 8 ks + t + 4 of column 8 nb + g."""
    def frag(x):        # (208, 416) -> (26, 52, 8 [g], 4 [t], 2 [row pair])
        x = x.reshape(N_ROWS // 8, 2, 4, N_COLS // 8, 8)     # ks, half, t, nb, g
        return x.transpose(0, 3, 4, 2, 1)
    packed = np.concatenate([frag(hi), frag(tf32_round(lo))], axis=-1)
    return np.ascontiguousarray(packed.reshape(N_ROWS // 8, N_COLS // 8, 32, 4))


def mel_spans(mel_fb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each mel filter's non-zero span: (n_mels,) first bin and length, and
    the (n_mels, 16) weights of the span (zero-padded). An all-zero filter
    has length 0."""
    fb = np.asarray(mel_fb, dtype=np.float32)
    n_mels = fb.shape[1]
    first = np.zeros(n_mels, np.int32)
    count = np.zeros(n_mels, np.int32)
    weights = np.zeros((n_mels, MAX_SPAN), np.float32)
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        if nz.size:
            first[m], count[m] = nz[0], nz[-1] - nz[0] + 1
            if count[m] > MAX_SPAN:
                raise ValueError(f"log_mel: mel {m} spans {count[m]} bins, the "
                                 f"kernel takes at most {MAX_SPAN}")
            weights[m, :count[m]] = fb[first[m]:first[m] + count[m], m]
    return first, count, weights


def mel_splits(first: np.ndarray, count: np.ndarray) -> np.ndarray:
    """The kernel's blocks along the mels: (n_splits, 3) int32 rows of (first
    group of 8 bins, first mel, end mel). A split takes mels in order while
    their spans fit in the 64 bins from 8 x its first group."""
    splits, m, n_mels = [], 0, len(first)
    while m < n_mels:
        live = [i for i in range(m, n_mels) if count[i]]
        grp_lo = int(first[live[0]]) // 8 if live else 0
        end = m
        while end < n_mels and (count[end] == 0 or
                                first[end] + count[end] <= 8 * grp_lo + SPLIT_BINS):
            end += 1
        splits.append((grp_lo, m, end))
        m = end
    return np.asarray(splits, np.int32)


class _PerTensor:
    """Tables derived from a tensor's values, made once per tensor (and
    again after an in-place change): the kernel's span tables from the
    filter bank. Keyed by ``id``; an entry goes when its tensor does. An
    inference tensor (made under ``torch.inference_mode``) has no version
    counter; it cannot be changed outside inference mode, so it is keyed
    without one."""

    def __init__(self, make):
        self._make = make
        self._cache = {}

    def __call__(self, t: torch.Tensor):
        key = id(t)
        version = None if t.is_inference() else t._version
        hit = self._cache.get(key)
        if hit is None or hit[0]() is not t or hit[1] != version:
            ref = weakref.ref(t, lambda _, k=key: self._cache.pop(k, None))
            hit = (ref, version, self._make(t))
            self._cache[key] = hit
        return hit[2]


# The packed basis, a constant of N_FFT: made once per device.
_BASIS: Dict[torch.device, torch.Tensor] = {}


def _basis(device: torch.device) -> torch.Tensor:
    if device not in _BASIS:
        _BASIS[device] = torch.from_numpy(pack_basis(*dft_basis())).to(device)
    return _BASIS[device]


@_PerTensor
def _mel_tables(mel_fb: torch.Tensor):
    first, count, weights = mel_spans(mel_fb.detach().cpu().numpy())
    dev = mel_fb.device
    return (torch.from_numpy(weights).to(dev),
            torch.from_numpy(np.stack([first, count], 1)).to(dev),
            torch.from_numpy(mel_splits(first, count)).to(dev))


def log_mel(audio: torch.Tensor, mel_fb: torch.Tensor,
            window: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 -> (B, N // 160, n_mels) log10 mel power.

    CPU tensors take :func:`log_mel_plain`; CUDA tensors launch the kernel
    or raise. ``mel_fb`` is (201, n_mels), ``window`` the 400-point window,
    both f32 on the audio's device.
    """
    global LOGMEL_LAUNCHES
    if audio.device.type == "cpu":
        return log_mel_plain(audio, mel_fb, window)
    if audio.device.type != "cuda":
        raise ValueError(f"log_mel: unsupported device {audio.device}")
    if audio.ndim != 2 or audio.dtype != torch.float32:
        raise ValueError("log_mel: audio must be (B, N) float32")
    b, n = audio.shape
    if n % HOP_LENGTH or n <= N_FFT // 2:
        raise ValueError(f"log_mel: N={n} must be a multiple of {HOP_LENGTH} "
                         f"above {N_FFT // 2}")
    if mel_fb.ndim != 2 or mel_fb.shape[0] != N_BINS or window.shape != (N_FFT,):
        raise ValueError("log_mel: mel_fb must be (201, n_mels), window (400,)")
    dev = audio.device
    if any(t.device != dev or t.dtype != torch.float32 for t in (mel_fb, window)):
        raise ValueError("log_mel: mel_fb and window must be float32 on the "
                         "audio's device")
    audio, window = audio.contiguous(), window.contiguous()
    if audio.data_ptr() % 16:           # the kernel stages float4s
        audio = audio.clone()
    basis = _basis(dev)
    mel_w, mel_span, splits = _mel_tables(mel_fb)
    n_mels = mel_fb.shape[1]
    out = torch.empty(b, n // HOP_LENGTH, n_mels, device=dev,
                      dtype=torch.float32)
    code = _build.lib().twt_logmel(
        audio.data_ptr(), basis.data_ptr(), window.data_ptr(), mel_w.data_ptr(),
        mel_span.data_ptr(), splits.data_ptr(), out.data_ptr(), b, n, n_mels,
        splits.shape[0], dev.index or 0, _build.stream_handle(dev))
    _build.check(code, "twt_logmel")
    LOGMEL_LAUNCHES += 1
    return out
