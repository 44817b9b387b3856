"""Log-mel front end, numerically matched to HF Whisper (torch port).

Counterpart of ``thewhisper_tpu/audio/features.py``: the same slaney mel
bank and periodic Hann window, the same padding/truncation to the chunk
length, the same (B, n_mels, F) output layout. The raw log10 mel comes from
``ops.logmel.log_mel`` (the K1 CUDA kernel on the card, the plain torch
version on the CPU); the max - 8 clamp and (x + 4) / 4 follow here.
"""

from __future__ import annotations

import numpy as np
import torch

from thewhisper_tpu_torch.config import HOP_LENGTH, N_FFT, SAMPLE_RATE
from thewhisper_tpu_torch.ops.logmel import log_mel, log_mel_plain


def _hertz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    return np.where(
        freq >= min_log_hertz,
        min_log_mel + np.log(np.maximum(freq, min_log_hertz) / min_log_hertz) * logstep,
        mels,
    )


def _mel_to_hertz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(
        mels >= min_log_mel,
        1000.0 * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freq,
    )


def mel_filter_bank(
    num_frequency_bins: int = N_FFT // 2 + 1,
    num_mel_filters: int = 128,
    min_frequency: float = 0.0,
    max_frequency: float = 8000.0,
    sampling_rate: int = SAMPLE_RATE,
) -> np.ndarray:
    """Triangular slaney-normed mel filter bank, shape (n_freq, n_mel).

    Matches ``transformers.audio_utils.mel_filter_bank(norm="slaney",
    mel_scale="slaney")``.
    """
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, num_frequency_bins)
    mel_min = _hertz_to_mel_slaney(np.array(min_frequency))
    mel_max = _hertz_to_mel_slaney(np.array(max_frequency))
    mel_points = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = _mel_to_hertz_slaney(mel_points)

    fdiff = np.diff(filter_freqs)
    ramps = filter_freqs[:, None] - fft_freqs[None, :]      # (n_mel+2, n_freq)
    down = -ramps[:-2] / fdiff[:-1, None]
    up = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(down, up))              # (n_mel, n_freq)

    enorm = 2.0 / (filter_freqs[2:] - filter_freqs[:-2])
    fb *= enorm[:, None]
    return fb.T.astype(np.float32)                          # (n_freq, n_mel)


def hann_window(n: int = N_FFT) -> np.ndarray:
    """Periodic Hann window (matches ``window_function(400, "hann")``)."""
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))).astype(np.float32)


def normalize_log_mel(log_spec: torch.Tensor) -> torch.Tensor:
    """(B, F, n_mels) log10 mel -> (B, n_mels, F) Whisper features: clamp to
    each row's max - 8, then (x + 4) / 4."""
    max_val = log_spec.amax(dim=(1, 2), keepdim=True)
    log_spec = torch.maximum(log_spec, max_val - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(1, 2)


def log_mel_spectrogram(audio: torch.Tensor, mel_fb: torch.Tensor,
                        window: torch.Tensor) -> torch.Tensor:
    """(B, N) f32 audio -> (B, n_mels, N // 160) features through K1 on a
    CUDA tensor (the plain version on a CPU one). N % 160 == 0."""
    if audio.ndim == 1:
        audio = audio[None]
    return normalize_log_mel(log_mel(audio, mel_fb, window))


def log_mel_spectrogram_plain(audio: torch.Tensor, mel_fb: torch.Tensor,
                              window: torch.Tensor) -> torch.Tensor:
    """:func:`log_mel_spectrogram` through the plain torch version on any
    device (the reference the kernel is held to on the card)."""
    if audio.ndim == 1:
        audio = audio[None]
    return normalize_log_mel(log_mel_plain(audio, mel_fb, window))


class LogMelFeaturizer:
    """HF-compatible padding to ``chunk_length_s`` and featurization on
    ``device``: ``__call__`` returns (B, n_mels, chunk_length_s * 100)."""

    def __init__(self, n_mels: int = 128, chunk_length_s: float = 30.0,
                 sample_rate: int = SAMPLE_RATE, device="cuda"):
        self.n_mels = n_mels
        self.chunk_length_s = float(chunk_length_s)
        self.sample_rate = sample_rate
        self.n_samples = int(self.chunk_length_s * sample_rate)
        self.device = torch.device(device)
        self.mel_fb = torch.from_numpy(
            mel_filter_bank(num_mel_filters=n_mels)).to(self.device)
        self.window = torch.from_numpy(hann_window()).to(self.device)

    def pad(self, audio) -> np.ndarray:
        """(B, n) or (n,) audio -> (B, n_samples) f32, zero-padded on the
        right or truncated."""
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 1:
            audio = audio[None, :]
        n = audio.shape[-1]
        if n < self.n_samples:
            audio = np.pad(audio, ((0, 0), (0, self.n_samples - n)))
        elif n > self.n_samples:
            audio = audio[:, : self.n_samples]
        return audio

    def __call__(self, audio) -> torch.Tensor:
        """Host audio, or a tensor on ``device`` (padded or cut there)."""
        if isinstance(audio, torch.Tensor):
            if audio.device != self.device:
                raise ValueError(f"audio on {audio.device}, the featurizer "
                                 f"on {self.device}")
            x = audio.float().reshape(-1, audio.shape[-1])[:, : self.n_samples]
            x = torch.nn.functional.pad(x, (0, self.n_samples - x.shape[1]))
        else:
            x = torch.from_numpy(self.pad(audio)).to(self.device)
        return log_mel_spectrogram(x, self.mel_fb, self.window)

    def num_mel_frames(self) -> int:
        return self.n_samples // HOP_LENGTH
