"""Voice activity detection with the Silero-compatible interface (the
port's copy of thewhisper_tpu's ``streaming/vad.py``).

The reference loads Silero VAD from torch.hub at runtime
(``streaming_pipeline.py:533-538``) and calls it statefully on exact
512-sample windows at 16 kHz (``:589-622``), resetting via
``reset_states()`` (``:987-988``). Without network access the default is
:class:`NeuralVAD`, a Silero-shaped neural model (STFT features -> conv
stack -> LSTM -> sigmoid, ~70k params) whose trained weights,
``vad_weights.npz`` beside this module, are a copy of the JAX package's.
It stays numpy on the host: about 31 calls a second per stream on
512-sample windows. All backends share the call contract:
``vad(chunk_512, sample_rate) -> float prob``, ``reset_states()``.

If real Silero weights are available locally (an explicit TorchScript
file), ``make_vad`` prefers them behind the same interface.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

# NeuralVAD feature/model geometry (that of the shipped weights).
_N_FFT = 256
_HOP = 128
_N_FRAMES = 3          # frames at offsets 0/128/256 inside a 512 window
_N_BINS = _N_FFT // 2 + 1
_HIDDEN = 64
_WEIGHTS_FILE = os.path.join(os.path.dirname(__file__), "vad_weights.npz")
_HANN = np.hanning(_N_FFT).astype(np.float32)   # hot path: ~31 calls/s/stream


def vad_features(window: np.ndarray) -> np.ndarray:
    """(512,) audio -> (129, 3) log-magnitude STFT features."""
    hann = _HANN
    frames = np.stack([window[o: o + _N_FFT] for o in
                       range(0, _N_FRAMES * _HOP, _HOP)])
    mag = np.abs(np.fft.rfft(frames * hann, axis=-1)).astype(np.float32)
    return np.log1p(mag).T                      # (129, 3)


class NeuralVAD:
    """Trained neural VAD: conv over STFT features + stateful LSTM.

    Architecture (Silero-shaped, own design): per 512-sample window the
    log-magnitude STFT (129 bins x 3 frames) runs through two k=3 convs
    over the frame axis (129->64->64, ReLU), mean-pools over frames, and
    steps one LSTM cell whose (h, c) persist across windows — the same
    stateful-streaming contract as Silero. A linear head + sigmoid yields
    P(speech).
    """

    WINDOW = 512

    def __init__(self, params: Optional[Dict[str, np.ndarray]] = None,
                 sample_rate: int = 16000):
        if params is None:
            with np.load(_WEIGHTS_FILE) as z:
                params = {k: z[k] for k in z.files}
        self.p = {k: np.asarray(v, np.float32) for k, v in params.items()}
        self.sample_rate = sample_rate
        # LSTM width comes from the weights (the trainer's --hidden knob;
        # the shipped file uses _HIDDEN).
        self._hidden = self.p["lstm_b"].shape[0] // 4
        self.reset_states()

    def reset_states(self) -> None:
        self._h = np.zeros(self._hidden, np.float32)
        self._c = np.zeros(self._hidden, np.float32)
        self._last = 0.0

    @staticmethod
    def _conv3(x: np.ndarray, w: np.ndarray, b: np.ndarray) -> np.ndarray:
        """x (Cin, T), w (Cout, Cin, 3), pad=1 over T -> (Cout, T)."""
        xp = np.pad(x, ((0, 0), (1, 1)))
        t = x.shape[1]
        # Direct small-T computation: sum_k w[..., k] @ xp[:, k:k+T].
        return b[:, None] + sum(
            w[:, :, k] @ xp[:, k: k + t] for k in range(3))

    def __call__(self, chunk: np.ndarray, sample_rate: Optional[int] = None) -> float:
        x = np.asarray(chunk, np.float32).reshape(-1)
        if len(x) < self.WINDOW:
            x = np.pad(x, (0, self.WINDOW - len(x)))
        p = self.p
        f = vad_features(x[: self.WINDOW])                 # (129, 3)
        h1 = np.maximum(self._conv3(f, p["conv1_w"], p["conv1_b"]), 0.0)
        h2 = np.maximum(self._conv3(h1, p["conv2_w"], p["conv2_b"]), 0.0)
        feat = h2.mean(axis=1)                             # (64,)
        gates = feat @ p["lstm_wx"] + self._h @ p["lstm_wh"] + p["lstm_b"]
        i, fg, g, o = np.split(gates, 4)
        i = 1.0 / (1.0 + np.exp(-i))
        fg = 1.0 / (1.0 + np.exp(-fg))
        o = 1.0 / (1.0 + np.exp(-o))
        g = np.tanh(g)
        self._c = fg * self._c + i * g
        self._h = o * np.tanh(self._c)
        z = float(self._h @ p["out_w"][:, 0] + p["out_b"][0])
        self._last = float(1.0 / (1.0 + np.exp(-z)))
        return self._last

    def item(self) -> float:  # pragma: no cover - API-shape compatibility
        return self._last


def neural_weights_available() -> bool:
    return os.path.exists(_WEIGHTS_FILE)


class EnergyVAD:
    """Adaptive-noise-floor spectral energy VAD on 512-sample windows.

    Tracks a slowly rising noise floor (fast decay on quiet frames) and maps
    the band-limited SNR of the 300-3400 Hz speech band through a soft
    threshold. Stateful across calls like Silero: consecutive windows share
    the noise estimate; ``reset_states`` clears it.
    """

    WINDOW = 512

    def __init__(self, sample_rate: int = 16000, sensitivity: float = 2.0):
        self.sample_rate = sample_rate
        self.sensitivity = sensitivity
        n_fft = self.WINDOW
        freqs = np.fft.rfftfreq(n_fft, d=1.0 / sample_rate)
        self._band = ((freqs >= 300.0) & (freqs <= 3400.0)).astype(np.float32)
        self._window = np.hanning(n_fft).astype(np.float32)
        self.reset_states()

    def reset_states(self) -> None:
        self._noise_floor: Optional[float] = None
        self._smoothed_prob = 0.0

    def __call__(self, chunk: np.ndarray, sample_rate: Optional[int] = None) -> float:
        x = np.asarray(chunk, dtype=np.float32).reshape(-1)
        if len(x) < self.WINDOW:
            x = np.pad(x, (0, self.WINDOW - len(x)))
        spec = np.abs(np.fft.rfft(x[: self.WINDOW] * self._window)) ** 2
        band_energy = float(np.sum(spec * self._band)) / self._band.sum()

        if self._noise_floor is None:
            self._noise_floor = band_energy + 1e-10
        elif band_energy < self._noise_floor:
            # Track down fast: quiet frames define the floor.
            self._noise_floor = 0.8 * self._noise_floor + 0.2 * band_energy
        else:
            # Drift up very slowly so sustained speech can't become "noise".
            self._noise_floor = 1.005 * self._noise_floor

        snr = band_energy / (self._noise_floor + 1e-10)
        raw = 1.0 - float(np.exp(-max(0.0, np.log10(max(snr, 1e-6))) * self.sensitivity))
        # Light smoothing mirrors Silero's temporal context.
        self._smoothed_prob = 0.6 * raw + 0.4 * self._smoothed_prob
        return float(np.clip(self._smoothed_prob, 0.0, 1.0))

    def item(self) -> float:  # pragma: no cover - API-shape compatibility
        return self._smoothed_prob


class _SileroWrapper:
    """Silero TorchScript model behind the EnergyVAD interface."""

    def __init__(self, model):
        import torch

        self._torch = torch
        self.model = model

    def reset_states(self) -> None:
        self.model.reset_states()

    def __call__(self, chunk: np.ndarray, sample_rate: int = 16000) -> float:
        t = self._torch.from_numpy(np.asarray(chunk, dtype=np.float32))
        return float(self.model(t, sample_rate).item())


def make_vad(kind: str = "auto", sample_rate: int = 16000):
    """Build a VAD.

    "auto" (default) prefers a local Silero TorchScript file
    (``SILERO_VAD_JIT``), then the shipped trained :class:`NeuralVAD`,
    then the :class:`EnergyVAD` heuristic. Explicit kinds: "silero",
    "neural", "energy".
    """
    if kind in ("silero", "auto"):
        path = os.environ.get("SILERO_VAD_JIT", "")
        if path and os.path.exists(path):
            try:
                import torch

                return _SileroWrapper(torch.jit.load(path))
            except Exception as e:
                # "auto" degrades per its contract (missing torch, corrupt
                # file); the explicit kind still fails loudly.
                if kind == "silero":
                    raise
                import logging

                logging.getLogger(__name__).warning(
                    "SILERO_VAD_JIT set but unusable (%s); falling back", e)
        if kind == "silero":
            raise FileNotFoundError(
                "Silero VAD requested but SILERO_VAD_JIT not set/found")
    if kind in ("neural", "auto"):
        if neural_weights_available():
            return NeuralVAD(sample_rate=sample_rate)
        if kind == "neural":
            raise FileNotFoundError(
                "NeuralVAD requested but vad_weights.npz is missing")
    return EnergyVAD(sample_rate=sample_rate)
