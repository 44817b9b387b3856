"""WAV loading and resampling with the standard library, numpy and scipy.

Counterpart of ``thewhisper_tpu/audio/io.py::load_audio`` for the formats
the port reads: PCM 8/16/24/32-bit and IEEE float WAV through ``wave``
(float WAV, which ``wave`` refuses, through a small RIFF chunk walk), mixed
down to mono and resampled with scipy's polyphase filter (numpy linear
interpolation where scipy is missing). ``wav_bytes`` encodes audio as
16-bit PCM WAV for the remote streaming backends.
"""

from __future__ import annotations

import io
import struct
import wave
from typing import Tuple, Union

import numpy as np

_WAVE_FORMAT_PCM = 1
_WAVE_FORMAT_FLOAT = 3


def _pcm_to_float(raw: bytes, width: int) -> np.ndarray:
    if width == 1:
        return (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    if width == 2:
        return np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    if width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        x = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        return np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    if width == 4:
        return np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    raise ValueError(f"unsupported PCM sample width: {width} bytes")


def _read_float_wav(data: bytes) -> Tuple[np.ndarray, int, int]:
    """IEEE-float WAV (format 3, or extensible with a float subformat)."""
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos, fmt, raw = 12, None, None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError("missing fmt/data chunk")
    code, channels, rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if code == 0xFFFE and len(fmt) >= 26:
        code = struct.unpack("<H", fmt[24:26])[0]
    if code != _WAVE_FORMAT_FLOAT or bits not in (32, 64):
        raise ValueError(f"unsupported WAVE format code {code} ({bits} bit)")
    x = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float32)
    return x, channels, rate


def _read_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """WAV bytes -> (float32 samples (n, channels), sample rate)."""
    try:
        with wave.open(io.BytesIO(data), "rb") as wf:
            channels, rate = wf.getnchannels(), wf.getframerate()
            x = _pcm_to_float(wf.readframes(wf.getnframes()), wf.getsampwidth())
    except wave.Error:
        x, channels, rate = _read_float_wav(data)
    return x[: (len(x) // channels) * channels].reshape(-1, channels), rate


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Resample 1-D float audio (polyphase filter; linear without scipy)."""
    if orig_sr == target_sr:
        return audio.astype(np.float32, copy=False)
    try:
        from scipy.signal import resample_poly
    except ImportError:
        n_out = int(round(len(audio) * target_sr / orig_sr))
        t = np.linspace(0.0, len(audio) - 1.0, n_out)
        return np.interp(t, np.arange(len(audio)), audio).astype(np.float32)
    g = np.gcd(int(orig_sr), int(target_sr))
    out = resample_poly(audio.astype(np.float64), target_sr // g, orig_sr // g)
    return out.astype(np.float32)


def load_audio(path_or_bytes: Union[str, bytes], sr: int = 16000) -> np.ndarray:
    """Load a WAV file (path or bytes) as mono float32 in [-1, 1] at ``sr``."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    x, rate = _read_wav(data)
    return resample(x.mean(axis=1), rate, sr)


def wav_bytes(audio: np.ndarray, sr: int = 16000) -> bytes:
    """Encode mono float audio as 16-bit PCM WAV bytes (for HTTP backends).

    Mirrors ``RemoteAPIBackend._audio_to_wav_bytes``
    (reference ``streaming_pipeline.py:94-113``).
    """
    buf = io.BytesIO()
    pcm = (np.clip(audio.astype(np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(pcm.tobytes())
    return buf.getvalue()
