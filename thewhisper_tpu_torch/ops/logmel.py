"""Log-mel front end: the K1 kernel's wrapper and its plain version.

``log_mel`` maps (B, N) f32 audio to (B, N // 160, n_mels) log10 mel power,
the part of the HF feature extractor that thewhisper_tpu runs in the Pallas
kernel ``ops/logmel_pallas.py::_logmel_raw``. On a CUDA tensor it launches
``csrc/logmel.cu`` (framing, windowed DFT, power, mel projection and log10
in one launch); on a CPU tensor it runs :func:`log_mel_plain`. The dynamic
range clamp and the (x + 4) / 4 scaling follow in
``audio.features.normalize_log_mel``, outside the kernel as in JAX.
"""

from __future__ import annotations

import math
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


# Per-device (cos, sin) DFT tables: constants of N_FFT, made once per device.
_DFT_TABLES: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _dft_tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(400, 201) cos and sin of 2 pi n k / 400 in f32, computed in f64 with
    the angle reduced exactly (n * k mod 400) before the trig call."""
    tables = _DFT_TABLES.get(device)
    if tables is None:
        n = np.arange(N_FFT)[:, None]
        k = np.arange(N_BINS)[None, :]
        ang = (n * k % N_FFT) * (2.0 * math.pi / N_FFT)
        tables = tuple(torch.from_numpy(f(ang).astype(np.float32)).to(device)
                       for f in (np.cos, np.sin))
        _DFT_TABLES[device] = tables
    return tables


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
    audio, mel_fb, window = (t.contiguous() for t in (audio, mel_fb, window))
    cos_t, sin_t = _dft_tables(dev)
    n_mels = mel_fb.shape[1]
    out = torch.empty(b, n // HOP_LENGTH, n_mels, device=dev,
                      dtype=torch.float32)
    code = _build.lib().twt_logmel(
        audio.data_ptr(), cos_t.data_ptr(), sin_t.data_ptr(),
        window.data_ptr(), mel_fb.data_ptr(), out.data_ptr(), b, n, n_mels,
        dev.index or 0, _build.stream_handle(dev))
    _build.check(code, "twt_logmel")
    LOGMEL_LAUNCHES += 1
    return out
