"""The port's log-mel front end (K1's plain version and the featurizer) and
WAV loading against the JAX package.

Features are compared after the (x + 4) / 4 normalization at ``atol 5e-4``,
the bound ``tests/test_logmel_pallas.py`` holds the Pallas kernel to. The
CUDA kernel is held to this plain version in ``test_torch_kernels.py``.
"""

import io
import wave

import numpy as np
import pytest
import torch

from thewhisper_tpu.audio import features as jf
from thewhisper_tpu.audio import io as jio
from thewhisper_tpu.ops.logmel_pallas import log_mel_pallas
from thewhisper_tpu_torch.audio import features as tf
from thewhisper_tpu_torch.audio import io as tio
from thewhisper_tpu_torch.ops import logmel

from _torch_tiny import one_cpu_thread  # noqa: F401


def _sig(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.4 * np.sin(2 * np.pi * (180 + 80 * t) * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def _port_features(audio, n_mels, plain=False):
    fb = torch.from_numpy(tf.mel_filter_bank(num_mel_filters=n_mels))
    win = torch.from_numpy(tf.hann_window())
    fn = tf.log_mel_spectrogram_plain if plain else tf.log_mel_spectrogram
    return fn(torch.from_numpy(audio), fb, win).numpy()


def test_banks_match_jax():
    for n_mels in (80, 128):
        np.testing.assert_array_equal(tf.mel_filter_bank(num_mel_filters=n_mels),
                                      jf.mel_filter_bank(num_mel_filters=n_mels))
    np.testing.assert_array_equal(tf.hann_window(), jf.hann_window())


@pytest.mark.parametrize("n_mels,seconds,batch", [
    (128, 3.0, 1), (80, 3.0, 1), (128, 1.3, 2)])
def test_plain_log_mel_matches_jax(n_mels, seconds, batch):
    audio = np.stack([_sig(seconds, seed=s) for s in range(batch)])
    fb, win = jf.mel_filter_bank(num_mel_filters=n_mels), jf.hann_window()
    ref = np.asarray(jf.log_mel_spectrogram(audio, fb, win))
    pallas = np.asarray(log_mel_pallas(audio, fb, win, interpret=True))
    out = _port_features(audio, n_mels)
    assert out.shape == ref.shape == (batch, n_mels, int(seconds * 100))
    np.testing.assert_allclose(out, ref, atol=5e-4)
    np.testing.assert_allclose(out, pallas, atol=5e-4)
    # On CPU tensors the kernel's wrapper is the plain version.
    np.testing.assert_array_equal(out, _port_features(audio, n_mels, plain=True))


@pytest.mark.parametrize("seconds", [1.7, 3.0, 4.2])
def test_featurizer_pads_and_truncates_like_jax(seconds):
    a = _sig(seconds, seed=3)
    ref = np.asarray(jf.LogMelFeaturizer(n_mels=80, chunk_length_s=3.0,
                                         use_pallas=False)(a))
    feat = tf.LogMelFeaturizer(n_mels=80, chunk_length_s=3.0, device="cpu")
    out = feat(a).numpy()
    assert out.shape == ref.shape == (1, 80, feat.num_mel_frames())
    np.testing.assert_allclose(out, ref, atol=5e-4)


def test_kernel_wrapper_rejects_other_devices():
    a = torch.zeros(1, 480, device="meta")
    fb = torch.zeros(201, 80, device="meta")
    with pytest.raises(ValueError, match="device"):
        logmel.log_mel(a, fb, torch.zeros(400, device="meta"))


def _pcm16_wav(x, rate, channels=1):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(channels)
        wf.setsampwidth(2)
        wf.setframerate(rate)
        wf.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _float_wav(x, rate):
    data = x.astype("<f4").tobytes()
    fmt = (b"fmt " + (16).to_bytes(4, "little") + (3).to_bytes(2, "little")
           + (1).to_bytes(2, "little") + rate.to_bytes(4, "little")
           + (rate * 4).to_bytes(4, "little") + (4).to_bytes(2, "little")
           + (32).to_bytes(2, "little"))
    body = b"WAVE" + fmt + b"data" + len(data).to_bytes(4, "little") + data
    return b"RIFF" + len(body).to_bytes(4, "little") + body


@pytest.mark.parametrize("kind,rate,channels", [
    ("pcm16", 16000, 1), ("pcm16", 44100, 2), ("float", 16000, 1),
    ("float", 8000, 1)])
def test_load_audio_matches_jax(kind, rate, channels, tmp_path):
    x = _sig(0.5, seed=4)
    if kind == "pcm16":
        data = _pcm16_wav(np.repeat(x, channels), rate, channels)
    else:
        data = _float_wav(x, rate)
    ref = jio.load_audio(data, sr=16000)
    np.testing.assert_array_equal(tio.load_audio(data, sr=16000), ref)
    path = tmp_path / "a.wav"
    path.write_bytes(data)
    np.testing.assert_array_equal(tio.load_audio(str(path)), ref)


def test_load_audio_rejects_non_wav():
    with pytest.raises(ValueError):
        tio.load_audio(b"not a wav file at all")
