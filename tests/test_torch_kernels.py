"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (``cuda`` marker) and skips elsewhere:
a CUDA kernel has no CPU mode. The module imports no JAX, so it also runs
where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Shapes are the slice's production shapes: 10 s and 30 s of audio (1000 and
3000 frames), S = 1500 and 500 encoder positions, 20 heads of 64.
"""

import numpy as np
import pytest
import torch

from thewhisper_tpu_torch.audio import features as tf
from thewhisper_tpu_torch.ops import _build, logmel
from thewhisper_tpu_torch.ops import attention as ta

from _torch_tiny import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


def _sig(batch, seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    rows = [0.4 * np.sin(2 * np.pi * (180 + 80 * t + 40 * b) * t)
            + 0.05 * rng.standard_normal(len(t)) for b in range(batch)]
    return np.stack(rows).astype(np.float32)


def test_build_reports_resources(cuda_device):
    """The library builds (or loads) and exports both entry points."""
    lib = _build.lib()
    assert hasattr(lib, "twt_logmel") and hasattr(lib, "twt_encoder_attention")
    if _build.build_log is not None:
        print(_build.build_log)


@pytest.mark.parametrize("batch,seconds,n_mels", [
    (1, 30.0, 128), (4, 10.0, 80), (4, 30.0, 128), (2, 1.3, 128)])
def test_logmel_kernel_matches_plain(cuda_device, batch, seconds, n_mels):
    audio = torch.from_numpy(_sig(batch, seconds)).to(cuda_device)
    fb = torch.from_numpy(tf.mel_filter_bank(num_mel_filters=n_mels)).to(cuda_device)
    win = torch.from_numpy(tf.hann_window()).to(cuda_device)
    before = logmel.LOGMEL_LAUNCHES
    out = tf.log_mel_spectrogram(audio, fb, win)
    torch.cuda.synchronize()
    assert logmel.LOGMEL_LAUNCHES == before + 1
    ref = tf.log_mel_spectrogram_plain(audio, fb, win)
    # The bound tests/test_logmel_pallas.py holds the TPU kernel to.
    torch.testing.assert_close(out, ref, atol=5e-4, rtol=0)


def test_logmel_kernel_rejects_bad_input(cuda_device):
    fb = torch.from_numpy(tf.mel_filter_bank(num_mel_filters=80)).to(cuda_device)
    win = torch.from_numpy(tf.hann_window()).to(cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        logmel.log_mel(torch.zeros(1, 1000, device=cuda_device), fb, win)
    with pytest.raises(ValueError, match="float32"):
        logmel.log_mel(torch.zeros(1, 1600, device=cuda_device,
                                   dtype=torch.float64), fb, win)


def _qkv(b, s, h, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(b, s, h, 64, generator=g).to(device, dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,valid_len", [
    (4, 1500, None), (4, 500, None), (2, 1500, 1111), (1, 77, 5)])
def test_attention_kernel_matches_plain(cuda_device, dtype, b, s, valid_len):
    q, k, v = _qkv(b, s, 20, dtype, cuda_device)
    before = ta.ATTN_LAUNCHES
    out = ta.encoder_attention(q, k, v, valid_len=valid_len)
    torch.cuda.synchronize()
    assert ta.ATTN_LAUNCHES == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    ref = ta.encoder_attention_plain(q, k, v, valid_len=valid_len)
    # f32: summation order only. bf16: the kernel keeps the probabilities in
    # f32 where the plain version rounds them to bf16 before the value
    # product; both round the output to bf16 once.
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


def test_attention_kernel_takes_strided_views(cuda_device):
    """The encoder passes (B, S, H, dh) views of (B, S, d) projections."""
    x = torch.randn(2, 300, 3 * 20 * 64, device=cuda_device)
    q, k, v = (t.view(2, 300, 20, 64) for t in x.chunk(3, dim=-1))
    torch.testing.assert_close(ta.encoder_attention(q, k, v),
                               ta.encoder_attention_plain(q, k, v),
                               atol=1e-4, rtol=1e-4)


def test_attention_kernel_rejects_bad_input(cuda_device):
    x = torch.zeros(1, 16, 2, 32, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        ta.encoder_attention(x, x, x)
    y = torch.zeros(1, 16, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        ta.encoder_attention(y, y, y)
    z = torch.zeros(1, 16, 2, 64, device=cuda_device)
    with pytest.raises(ValueError, match="valid_len"):
        ta.encoder_attention(z, z, z, valid_len=0)
