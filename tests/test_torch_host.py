"""The port's own host modules (``config``, ``align``, ``text``) against the
JAX package's, which they copy: the same values field for field, the same
DTW paths and timestamps, the same word grouping and window merge on seeded
inputs."""

import dataclasses

import numpy as np
import pytest

from thewhisper_tpu import align as jax_align
from thewhisper_tpu import config as jax_config
from thewhisper_tpu import text as jax_text
from thewhisper_tpu_torch import align, config, text

from _torch_tiny import one_cpu_thread  # noqa: F401


def test_arch_presets_equal_jax():
    assert config.ARCH_PRESETS.keys() == jax_config.ARCH_PRESETS.keys()
    for name, arch in config.ARCH_PRESETS.items():
        assert dataclasses.asdict(arch) == dataclasses.asdict(
            jax_config.ARCH_PRESETS[name]), name
        assert arch.head_dim == jax_config.ARCH_PRESETS[name].head_dim
    assert dataclasses.asdict(config.WhisperArch()) == dataclasses.asdict(
        jax_config.WhisperArch())


@pytest.mark.parametrize("vocab", [None, 51864, 51865, 51866, 51867])
def test_special_tokens_equal_jax(vocab):
    if vocab is None:
        ours, theirs = config.SpecialTokens(), jax_config.SpecialTokens()
    else:
        ours = config.SpecialTokens.for_vocab(vocab)
        theirs = jax_config.SpecialTokens.for_vocab(vocab)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for lang in ("en", "zh", "yue", "haw"):
        assert (ours.language_id(lang, config.LANGUAGES)
                == theirs.language_id(lang, jax_config.LANGUAGES))
    with pytest.raises(ValueError, match="unknown language"):
        ours.language_id("xx", config.LANGUAGES)


def test_languages_constants_and_options_equal_jax():
    assert config.LANGUAGES == jax_config.LANGUAGES
    for name in ("SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "CHUNK_LENGTH_S",
                 "FRAMES_PER_SECOND", "TIME_PRECISION"):
        assert getattr(config, name) == getattr(jax_config, name), name
    assert dataclasses.asdict(config.GenerationOptions()) == dataclasses.asdict(
        jax_config.GenerationOptions())
    for seconds in (1, 10, 15, 20, 29.5, 30):
        assert (config.source_positions_for_seconds(seconds)
                == jax_config.source_positions_for_seconds(seconds))


def _cost(seed: int) -> np.ndarray:
    """A seeded (S, T) cost matrix; seed 0 draws small integers, so that
    many cells tie and the HF tie cascade decides the path."""
    rng = np.random.default_rng(seed)
    s, t = int(rng.integers(1, 40)), int(rng.integers(1, 160))
    if seed == 0:
        return rng.integers(0, 3, (s, t)).astype(np.float32)
    return rng.standard_normal((s, t)).astype(np.float32)


@pytest.mark.parametrize("seed", range(20))
def test_dtw_path_equals_jax(seed):
    cost = _cost(seed)
    got, want = align.dtw_path(cost), jax_align.dtw_path(cost)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("width", [1, 3, 7, 8])
def test_median_filter_and_timestamps_equal_jax(width):
    rng = np.random.default_rng(width)
    x = rng.standard_normal((2, 3, 11, 40)).astype(np.float32)
    np.testing.assert_array_equal(align.median_filter(x, width),
                                  jax_align.median_filter(x, width))
    align_m = rng.random((3, 2, 12, 75)).astype(np.float32)
    rows = np.array([12, 5, 0])
    frames = np.array([150, 90, 40])
    np.testing.assert_array_equal(
        align.token_timestamps_from_alignment(align_m, rows, frames, width),
        jax_align.token_timestamps_from_alignment(align_m, rows, frames, width))


# Byte-level vocabulary: words with and without a leading space,
# punctuation, and UTF-8 sequences split over two or three tokens (so that
# prefixes decode to U+FFFD and the unicode split has to wait).
_VOCAB = [b" the", b" cat", b"s", b",", b".", b" (", b")", b"!", b" \xc3",
          b"\xa9", b" \xe2\x80", b"\x9c", b"ab", b" \"", b"\xe4\xb8", b"\xad",
          b"?", b" d\xc3\xa9j\xc3\xa0", b" -", b"'s"]
_SPECIAL = len(_VOCAB)


def _decode(ids):
    return b"".join(_VOCAB[i] for i in ids if i < _SPECIAL).decode(
        "utf-8", errors="replace")


@pytest.mark.parametrize("language", [None, "en", "zh", "ja"])
@pytest.mark.parametrize("seed", range(4))
def test_combine_tokens_into_words_equals_jax(seed, language):
    rng = np.random.default_rng(100 + seed)
    tokens = [int(t) for t in rng.integers(0, _SPECIAL + 2, 40)]
    assert (text.combine_tokens_into_words(_decode, tokens, language, _SPECIAL)
            == jax_text.combine_tokens_into_words(_decode, tokens, language,
                                                  _SPECIAL))


def _windows(seed: int):
    """Overlapping windows of one seeded token stream, with per-token
    (start, end) timestamps that drift a little between windows; some ends
    are None, as the last kept token of a window has."""
    rng = np.random.default_rng(200 + seed)
    stream = [int(t) for t in rng.integers(0, 12, 120)]
    starts = np.cumsum(rng.uniform(0.05, 0.4, len(stream)))
    seqs, stamps, lo = [], [], 0
    while lo < len(stream):
        hi = min(len(stream), lo + int(rng.integers(20, 40)))
        seq = stream[lo:hi]
        jitter = rng.normal(0, 0.05, len(seq))
        ts = [(float(starts[lo + i] + jitter[i]),
               None if rng.random() < 0.1 else float(starts[lo + i] + 0.2))
              for i in range(len(seq))]
        seqs.append(seq)
        stamps.append(ts)
        lo = hi - int(rng.integers(3, 12)) if hi < len(stream) else hi
    return seqs, stamps


@pytest.mark.parametrize("seed", range(6))
def test_find_longest_common_sequence_equals_jax(seed):
    seqs, stamps = _windows(seed)
    assert len(seqs) > 2
    assert (text.find_longest_common_sequence(seqs)
            == jax_text.find_longest_common_sequence(seqs))
    assert (text.find_longest_common_sequence(seqs, stamps)
            == jax_text.find_longest_common_sequence(seqs, stamps))
