"""The host-side tables of the K1 kernel (``ops/logmel.py``) on the CPU.

The kernel computes the DFT of each windowed frame, folded about its
middle, as a 3xTF32 tensor-core product, and the mel stage over each
filter's non-zero span; neither runs here, so these tests hold what the
wrapper hands it and the arithmetic it does: the split basis, the fold, the
packing into the kernel's B-fragment order, the spans and the splits along
the mels, and a numpy emulation of the kernel (``cvt.rna`` rounding, the
three products, power, spans, log10) against ``log_mel_plain`` at the bound
of ``tests/test_logmel_pallas.py``.
"""

import math

import numpy as np
import pytest
import torch

from thewhisper_tpu_torch.audio import features as tf
from thewhisper_tpu_torch.ops import logmel


def _sig(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.4 * np.sin(2 * np.pi * (180 + 80 * t) * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def _basis_f32():
    """The folded basis, built here independently of ``dft_basis``: column
    16 j + i is cos, 16 j + 8 + i sin, of bin 8 j + i; cos rows n <= 200,
    sin rows 0 < n < 200, bins <= 200."""
    basis = np.zeros((208, 416), np.float32)
    for k in range(201):
        j, i = divmod(k, 8)
        ang = ((np.arange(208) * k) % 400) * (2 * math.pi / 400)
        basis[:201, 16 * j + i] = np.cos(ang)[:201]
        basis[1:200, 16 * j + 8 + i] = np.sin(ang)[1:200]
    return basis


def _rna(x):
    """Round f32 to TF32, to nearest with ties away from zero, in floats."""
    x = np.asarray(x, np.float32).astype(np.float64)
    m, e = np.frexp(np.abs(x))                 # |x| = m 2**e, m in [0.5, 1)
    r = np.floor(m * 2 ** 11 + 0.5) / 2 ** 11  # 11 significant bits
    return (np.sign(x) * np.ldexp(r, e)).astype(np.float32)


def test_tf32_round_is_cvt_rna():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(10000).astype(np.float32),
                        np.float32([0.0, -0.0, 1.0, -1.0, 1 + 2 ** -11,
                                    -(1 + 2 ** -11), 1 + 3 * 2 ** -12])])
    got = logmel.tf32_round(x)
    np.testing.assert_array_equal(got, _rna(x))
    # Ties go away from zero.
    assert got[-3] == np.float32(1 + 2 ** -10) and got[-2] == -got[-3]


def test_basis_split_is_exact():
    """``hi`` has TF32's 10-bit mantissa (the low 13 bits are zero), and
    ``hi + lo`` is the f32 cos/sin basis of the folded DFT exactly, because
    ``basis - hi`` is exact in f32."""
    hi, lo = logmel.dft_basis()
    assert hi.dtype == lo.dtype == np.float32 and hi.shape == (208, 416)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi + lo, _basis_f32())
    assert np.abs(lo).max() <= 2 ** -11 * np.abs(hi).max()


@pytest.mark.parametrize("window", ["hann", "random"])
def test_fold_gives_the_windowed_dft(window):
    """The folded product (c by the cos rows, s by the sin rows) is the
    windowed 400-point DFT of each frame, for any window."""
    rng = np.random.default_rng(3)
    w = (tf.hann_window() if window == "hann"
         else rng.uniform(0, 1, 400).astype(np.float32))
    frames = rng.standard_normal((6, 400)).astype(np.float32)
    c, s = logmel.fold_frames(frames, w)
    basis = _basis_f32().astype(np.float64).reshape(208, 26, 2, 8)
    re = (c @ basis[:, :, 0].reshape(208, 208))[:, :201]
    im = (s @ basis[:, :, 1].reshape(208, 208))[:, :201]
    ref = np.fft.rfft(frames.astype(np.float64) * w, n=400)
    np.testing.assert_allclose(re, ref.real, atol=1e-4)
    np.testing.assert_allclose(im, -ref.imag, atol=1e-4)


def test_packed_basis_is_in_fragment_order():
    """Lane (g, t) of k-step ks and n8 block nb holds hi and TF32-rounded lo
    of rows 8 ks + t and 8 ks + t + 4 of column 8 nb + g (the m16n8k8 B
    fragment)."""
    hi, lo = logmel.dft_basis()
    packed = logmel.pack_basis(hi, lo)
    assert packed.shape == (26, 52, 32, 4) and packed.flags["C_CONTIGUOUS"]
    lo_r = _rna(lo)
    for ks in range(26):
        for nb in (0, 17, 51):
            for lane in range(32):
                g, t = divmod(lane, 4)
                n, c = 8 * ks + t, 8 * nb + g
                want = [hi[n, c], hi[n + 4, c], lo_r[n, c], lo_r[n + 4, c]]
                np.testing.assert_array_equal(packed[ks, nb, lane], want)


@pytest.mark.parametrize("n_mels", [128, 80])
def test_mel_spans_are_tight_and_exact(n_mels):
    """Every non-zero of the filter bank lies in its mel's span, each span
    starts and ends on a non-zero, and the span product equals the dense
    product."""
    fb = tf.mel_filter_bank(num_mel_filters=n_mels)
    first, count, weights = logmel.mel_spans(fb)
    assert count.max() <= logmel.MAX_SPAN
    rebuilt = np.zeros_like(fb)
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        assert count[m] == (nz[-1] - nz[0] + 1 if nz.size else 0)
        if nz.size:
            assert first[m] == nz[0]
            assert fb[first[m], m] != 0 and fb[first[m] + count[m] - 1, m] != 0
        rebuilt[first[m]:first[m] + count[m], m] = weights[m, :count[m]]
        assert not weights[m, count[m]:].any()
    np.testing.assert_array_equal(rebuilt, fb)
    power = np.random.default_rng(2).uniform(0, 10, (50, 201)).astype(np.float32)
    span = np.stack([power[:, first[m]:first[m] + count[m]] @ weights[m, :count[m]]
                     for m in range(n_mels)], 1)
    np.testing.assert_allclose(span, power @ fb, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_mels", [128, 80])
def test_mel_splits_cover_each_mel_once(n_mels):
    """The kernel's blocks along the mels: each mel in exactly one split,
    in order, and each split's spans within its 64 bins."""
    first, count, _ = logmel.mel_spans(tf.mel_filter_bank(num_mel_filters=n_mels))
    splits = logmel.mel_splits(first, count)
    assert splits.dtype == np.int32 and splits[0, 1] == 0
    assert splits[-1, 2] == n_mels
    assert (splits[1:, 1] == splits[:-1, 2]).all()
    for grp_lo, m_lo, m_hi in splits:
        assert m_hi > m_lo and 0 <= grp_lo < 26
        for m in range(m_lo, m_hi):
            if count[m]:
                assert 8 * grp_lo <= first[m]
                assert first[m] + count[m] <= 8 * grp_lo + logmel.SPLIT_BINS


def _emulate(audio, n_mels, split=True):
    """The kernel's arithmetic in numpy: frames, the fold, the 3xTF32
    product with the packed basis's halves (or plain TF32), f32 power,
    spans, log10."""
    hi, lo = logmel.dft_basis()
    fb = tf.mel_filter_bank(num_mel_filters=n_mels)
    frames = np.lib.stride_tricks.sliding_window_view(
        np.pad(audio, 200, mode="reflect"), 400)[::160][:len(audio) // 160]
    b_hi, b_lo = hi.astype(np.float64), logmel.tf32_round(lo).astype(np.float64)
    cols = np.arange(416).reshape(26, 2, 8)
    parts = []
    for a, which in zip(logmel.fold_frames(frames, tf.hann_window()), (0, 1)):
        a_hi = logmel.tf32_round(a)
        a_lo = logmel.tf32_round(a - a_hi).astype(np.float64)
        a_hi = a_hi.astype(np.float64)
        c = cols[:, which].ravel()
        prod = a_hi @ b_hi[:, c]
        if split:
            prod = a_lo @ b_hi[:, c] + a_hi @ b_lo[:, c] + prod
        parts.append(prod.astype(np.float32)[:, :201])
    power = parts[0] ** 2 + parts[1] ** 2
    first, count, weights = logmel.mel_spans(fb)
    mel = np.stack([power[:, first[m]:first[m] + count[m]] @ weights[m, :count[m]]
                    for m in range(n_mels)], 1)
    log = np.log10(np.maximum(mel, 1e-10))[None].astype(np.float32)
    return tf.normalize_log_mel(torch.from_numpy(log)).numpy()


@pytest.mark.parametrize("n_mels", [128, 80])
def test_split_product_emulation_matches_plain(n_mels):
    """A seeded 30 s signal through the emulated kernel stays within 5e-4 of
    ``log_mel_plain`` on the normalized features; without the split (plain
    TF32) it does not."""
    audio = _sig(30.0, seed=n_mels)
    ref = tf.log_mel_spectrogram_plain(
        torch.from_numpy(audio[None]),
        torch.from_numpy(tf.mel_filter_bank(num_mel_filters=n_mels)),
        torch.from_numpy(tf.hann_window())).numpy()
    assert np.abs(_emulate(audio, n_mels) - ref).max() <= 5e-4
    assert np.abs(_emulate(audio, n_mels, split=False) - ref).max() > 5e-4


def test_tables_are_made_once():
    """The wrapper makes the packed basis once per device and the span
    tables once per filter-bank tensor, and again after an in-place change."""
    basis = logmel._basis(torch.device("cpu"))
    assert logmel._basis(torch.device("cpu")) is basis
    assert basis.shape == (26, 52, 32, 4) and basis.dtype == torch.float32
    fb = torch.from_numpy(tf.mel_filter_bank(num_mel_filters=80))
    w, span, splits = logmel._mel_tables(fb)
    assert w.shape == (80, 16) and span.shape == (80, 2) and splits.shape[1] == 3
    assert logmel._mel_tables(fb)[0] is w
    fb.mul_(0.5)
    again = logmel._mel_tables(fb)[0]
    assert again is not w
    torch.testing.assert_close(again, 0.5 * w, rtol=0, atol=0)
