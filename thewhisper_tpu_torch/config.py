"""Typed configuration: model architectures, special tokens, languages,
generation options and the audio front end's constants (the port's own
copy of thewhisper_tpu's ``config.py``; the values are the same, and
``tests/test_torch_host.py`` holds them equal field for field).

Every consumer in the port reads an arch by its attributes, so a JAX
``WhisperArch`` works wherever this one does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WhisperArch:
    """Whisper architecture hyper-parameters (mirrors HF ``WhisperConfig``)."""

    d_model: int = 1280
    encoder_layers: int = 32
    encoder_heads: int = 20
    decoder_layers: int = 4
    decoder_heads: int = 20
    d_ff: int = 5120
    n_mels: int = 128
    vocab_size: int = 51866
    max_source_positions: int = 1500
    max_target_positions: int = 448
    median_filter_width: int = 7
    # (layer, head) pairs of cross-attention heads used for DTW alignment;
    # loaded from the checkpoint's generation_config.alignment_heads.
    alignment_heads: Tuple[Tuple[int, int], ...] = ()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_heads

    def with_source_positions(self, max_source_positions: int) -> "WhisperArch":
        return dataclasses.replace(self, max_source_positions=max_source_positions)


# Architecture presets keyed by the common model names. Dims match the OpenAI /
# HF checkpoints; used when instantiating random models and in tests.
ARCH_PRESETS = {
    "tiny": WhisperArch(
        d_model=384, encoder_layers=4, encoder_heads=6, decoder_layers=4,
        decoder_heads=6, d_ff=1536, n_mels=80, vocab_size=51865,
    ),
    "base": WhisperArch(
        d_model=512, encoder_layers=6, encoder_heads=8, decoder_layers=6,
        decoder_heads=8, d_ff=2048, n_mels=80, vocab_size=51865,
    ),
    "small": WhisperArch(
        d_model=768, encoder_layers=12, encoder_heads=12, decoder_layers=12,
        decoder_heads=12, d_ff=3072, n_mels=80, vocab_size=51865,
    ),
    "medium": WhisperArch(
        d_model=1024, encoder_layers=24, encoder_heads=16, decoder_layers=24,
        decoder_heads=16, d_ff=4096, n_mels=80, vocab_size=51865,
    ),
    "large-v3": WhisperArch(
        d_model=1280, encoder_layers=32, encoder_heads=20, decoder_layers=32,
        decoder_heads=20, d_ff=5120, n_mels=128, vocab_size=51866,
    ),
    "large-v3-turbo": WhisperArch(
        d_model=1280, encoder_layers=32, encoder_heads=20, decoder_layers=4,
        decoder_heads=20, d_ff=5120, n_mels=128, vocab_size=51866,
    ),
}


@dataclasses.dataclass(frozen=True)
class SpecialTokens:
    """Whisper control-token ids.

    Defaults are the large-v3 family (vocab 51866); ``for_vocab`` adjusts
    for the 51865-vocab models where the task/timestamp block sits one id
    lower.
    """

    eot: int = 50257            # <|endoftext|>
    sot: int = 50258            # <|startoftranscript|>
    first_language: int = 50259  # <|en|>
    n_languages: int = 100
    translate: int = 50359
    transcribe: int = 50360
    # <|startoflm|> 50361, <|startofprev|> 50362, <|nospeech|> 50363
    # (= no_timestamps - 1, the HF convention).
    no_speech: int = 50363
    no_timestamps: int = 50364
    timestamp_begin: int = 50365

    @staticmethod
    def for_vocab(vocab_size: int) -> "SpecialTokens":
        if vocab_size >= 51866:
            return SpecialTokens()
        # large-v2 / earlier: 99 languages, block shifted down by one.
        return SpecialTokens(
            eot=50257, sot=50258, first_language=50259, n_languages=99,
            translate=50358, transcribe=50359, no_speech=50362,
            no_timestamps=50363, timestamp_begin=50364,
        )

    def language_id(self, language: str, lang_codes: Tuple[str, ...]) -> int:
        try:
            return self.first_language + lang_codes.index(language)
        except ValueError as e:
            raise ValueError(f"unknown language code: {language!r}") from e


# Language order of the Whisper tokenizer (first 100 language tokens).
LANGUAGES: Tuple[str, ...] = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su", "yue",
)


@dataclasses.dataclass(frozen=True)
class GenerationOptions:
    """Options for the decode loop: greedy by default (``num_beams=1``,
    ``temperature=0``); a failed window re-decodes at rising temperature on
    the opt-in fallback ladder, sampling from ``seed``."""

    max_new_tokens: int = 128
    num_beams: int = 1
    language: Optional[str] = None   # None => rely on detected/default "en"
    task: str = "transcribe"
    return_timestamps: bool = False  # word timestamps via DTW alignment
    temperature: float = 0.0
    seed: int = 0                    # generator seed when temperature > 0


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Streaming state-machine constants (reference streaming_pipeline.py):
    the defaults of ``streaming.pipeline`` (``StreamingPipeline``, the
    local backend, the gibberish gate and the open-end clamp), of
    ``BatchedTranscriber`` and of the server's ``SessionManager``."""

    sample_rate: int = 16000
    chunk_length_s: float = 10.0
    min_process_chunk_s: float = 0.5
    # window = chunk_length - 1 (reference :479)
    use_vad: bool = True
    vad_threshold: float = 0.1
    vad_no_speech_chunks: int = 1
    vad_prepend_chunks: int = 3
    language: str = "en"
    max_new_tokens: int = 128
    gibberish_threshold: float = 2.2   # zlib compression-ratio filter (:41-43)
    max_word_duration: float = 1.0     # clamp for open-ended words (:416-426)

    @property
    def window_size_s(self) -> float:
        return self.chunk_length_s - 1.0


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """REST server config (env parity with reference ``examples/server.py``)."""

    host: str = "127.0.0.1"
    port: int = 8800
    chunk_length_s: int = 10
    pidfile: str = "/tmp/asr_streaming_server.pid"

    @staticmethod
    def from_env() -> "ServerConfig":
        return ServerConfig(
            host=os.getenv("ASR_STREAMING_HOST", "127.0.0.1"),
            port=int(os.getenv("ASR_STREAMING_PORT", "8800")),
            chunk_length_s=int(os.getenv("CHUNK_SECONDS", "10")),
        )


# Audio front-end constants (HF WhisperFeatureExtractor parity).
SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH_S = 30
# Encoder frames per second after the stride-2 conv stem.
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH // 2  # 50
# DTW time resolution in seconds per encoder frame.
TIME_PRECISION = 0.02


def mel_frames_for_seconds(seconds: float) -> int:
    """Number of mel frames the featurizer produces for `seconds` of audio."""
    return int(seconds * SAMPLE_RATE) // HOP_LENGTH


def source_positions_for_seconds(seconds: float) -> int:
    """Encoder positions for a flexible chunk length (1500 * s/30)."""
    return int(1500 * seconds / 30)
