"""Audio loading and resampling with the standard library, numpy and scipy.

Counterpart of ``thewhisper_tpu/audio/io.py``: PCM 8/16/24/32-bit and IEEE
float WAV through ``wave`` (float WAV, which ``wave`` refuses, through a
small RIFF chunk walk), mixed down to mono and resampled with scipy's
polyphase filter (the host runtime's linear resampler where scipy is
missing); any other container (mp3, flac, ogg, m4a, ...) through an
``ffmpeg`` subprocess when the binary is installed. ``save_wav`` and
``wav_bytes`` write 16-bit PCM WAV.
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
    """Resample 1-D float audio: scipy's polyphase filter, or without scipy
    the host runtime's linear resampler."""
    if orig_sr == target_sr:
        return audio.astype(np.float32, copy=False)
    try:
        from scipy.signal import resample_poly
    except ImportError:
        from thewhisper_tpu_torch.native_lib import resample_linear_native

        return resample_linear_native(np.asarray(audio, np.float32),
                                      target_sr / orig_sr)
    g = np.gcd(int(orig_sr), int(target_sr))
    out = resample_poly(audio.astype(np.float64), target_sr // g, orig_sr // g)
    return out.astype(np.float32)


def resample_linear_plain(audio: np.ndarray, ratio: float) -> np.ndarray:
    """``native_lib.resample_linear_native`` in numpy: ``round(n * ratio)``
    samples interpolated at ``k / ratio``, the last sample held past the end."""
    n = len(audio)
    if n == 0 or ratio <= 0.0:
        return np.empty(0, np.float32)
    pos = np.arange(int(n * ratio + 0.5)) / ratio
    return np.interp(pos, np.arange(n), audio.astype(np.float64)).astype(np.float32)


def _ffmpeg_decode(data: bytes, sr: int) -> np.ndarray:
    """Any container ffmpeg reads, as mono float32 at ``sr``: ``ffmpeg``
    writes f32le PCM to a pipe. FileNotFoundError when the binary is not on
    PATH."""
    import shutil
    import subprocess

    exe = shutil.which("ffmpeg")
    if exe is None:
        raise FileNotFoundError("ffmpeg not found on PATH")
    proc = subprocess.run(
        [exe, "-v", "error", "-i", "pipe:0", "-f", "f32le", "-ac", "1",
         "-ar", str(int(sr)), "pipe:1"],
        input=data, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        check=False)
    if proc.returncode != 0 or not proc.stdout:
        raise ValueError(
            f"ffmpeg decode failed: {proc.stderr.decode(errors='replace')[:200]}")
    return np.frombuffer(proc.stdout, dtype="<f4").astype(np.float32)


def load_audio(path_or_bytes: Union[str, bytes], sr: int = 16000) -> np.ndarray:
    """Load an audio file (path or bytes) as mono float32 in [-1, 1] at
    ``sr``: WAV in-process, any other container through ``ffmpeg`` (a
    ValueError naming ffmpeg where it is not installed)."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    try:
        x, rate = _read_wav(data)
    except (ValueError, EOFError) as wav_err:
        try:
            return _ffmpeg_decode(data, sr)
        except FileNotFoundError:
            raise ValueError(
                f"{wav_err}; install ffmpeg for non-WAV formats") from None
    return resample(x.mean(axis=1), rate, sr)


def save_wav(path: str, audio: np.ndarray, sr: int = 16000) -> None:
    """Write mono float32 audio as 16-bit PCM WAV."""
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(pcm.tobytes())


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
