"""The port's offline pipeline against the JAX ASRPipeline, end to end.

Both pipelines get the same weights (the JAX tree through
``params_from_jax``) and the same audio, at f32 on the CPU, and must give
identical text and identical word timestamps: the greedy tokens are argmax
picks and the timestamps are DTW frame indices times 0.02 s, so agreement
is exact, not within a tolerance.
"""

import numpy as np
import pytest
import torch

from thewhisper_tpu.config import GenerationOptions
from thewhisper_tpu.engine import WhisperEngine as JaxEngine
from thewhisper_tpu.pipeline import ASRPipeline as JaxPipeline
from thewhisper_tpu_torch.engine import WhisperEngine
from thewhisper_tpu_torch.models.load import params_from_jax
from thewhisper_tpu_torch.pipeline import ASRPipeline

from _torch_tiny import ARCH, SPECIAL, SUPPRESS, WordTokenizer, audio, jax_params_numpy

KW = {"max_new_tokens": 8, "language": "en"}


@pytest.fixture(scope="module")
def pipelines():
    tree = jax_params_numpy()
    jax_eng = JaxEngine(tree, ARCH, special=SPECIAL, batch_buckets=(1, 2, 4),
                        suppress_tokens=SUPPRESS)
    eng = WhisperEngine(params_from_jax(tree, ARCH, dtype=torch.float32),
                        special=SPECIAL, suppress_tokens=SUPPRESS)
    tok = WordTokenizer()
    return (JaxPipeline(jax_eng, tokenizer=tok, chunk_length_s=3),
            ASRPipeline(eng, tokenizer=tok, chunk_length_s=3))


@pytest.mark.parametrize("seconds,chunk_length_s,mode", [
    (2.0, None, "word"),       # one window
    (7.0, 2.0, "word"),        # five overlapping windows, LCS merge
    (7.0, 2.0, "segment"),
    (2.0, None, False),
])
def test_pipeline_matches_jax(pipelines, seconds, chunk_length_s, mode):
    jax_pipe, pipe = pipelines
    a = audio(seconds, seed=1)
    ref = jax_pipe(a, return_timestamps=mode, generate_kwargs=dict(KW),
                   chunk_length_s=chunk_length_s)
    out = pipe(a, return_timestamps=mode, generate_kwargs=dict(KW),
               chunk_length_s=chunk_length_s)
    assert out == ref
    assert out["text"].strip()
    if mode:
        assert out["chunks"]


def test_transcribe_batch_matches_jax(pipelines):
    jax_pipe, pipe = pipelines
    audios = [audio(s, seed=10 + i) for i, s in enumerate((1.0, 2.5, 3.0, 4.0))]
    ref = jax_pipe.transcribe_batch(audios, generate_kwargs=dict(KW))
    out = pipe.transcribe_batch(audios, generate_kwargs=dict(KW))
    assert len(out) == 4
    for o, r in zip(out, ref):
        assert o["text"] == r["text"]
        assert [c["text"] for c in o["chunks"]] == [c["text"] for c in r["chunks"]]
        assert [c["timestamp"] for c in o["chunks"]] == [c["timestamp"] for c in r["chunks"]]
        # Confidences come from f32 logprobs computed in two frameworks.
        np.testing.assert_allclose([c["confidence"] for c in o["chunks"]],
                                   [c["confidence"] for c in r["chunks"]],
                                   rtol=1e-5)


def test_engine_result_matches_jax(pipelines):
    """The EngineResult fields behind the pipeline: tokens exactly, the
    f32 numbers to a tolerance that covers summation order."""
    jax_pipe, pipe = pipelines
    batch = np.stack([audio(3.0, seed=20), audio(3.0, seed=21)])
    opts = GenerationOptions(max_new_tokens=8, language="en",
                             return_timestamps=True)
    ref = jax_pipe.engine.transcribe_audio(batch, opts)
    out = pipe.engine.transcribe_audio(batch, opts)
    np.testing.assert_array_equal(out.tokens, ref.tokens)
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)
    assert out.prompt_len == ref.prompt_len
    np.testing.assert_allclose(out.align, ref.align, atol=1e-5)
    np.testing.assert_allclose(out.sum_logprob, ref.sum_logprob, atol=1e-4)
    np.testing.assert_allclose(out.token_logprobs, ref.token_logprobs, atol=1e-4)
    np.testing.assert_allclose(out.no_speech_prob, ref.no_speech_prob, atol=1e-6)


def test_detect_language_matches_jax(pipelines):
    jax_pipe, pipe = pipelines
    mel = np.asarray(jax_pipe.featurizer(np.stack([audio(3.0, seed=30),
                                                   audio(3.0, seed=31)])))
    ref_codes, ref_p = jax_pipe.engine.detect_language(mel)
    codes, p = pipe.engine.detect_language(mel)
    np.testing.assert_array_equal(codes, ref_codes)
    np.testing.assert_allclose(p, ref_p, rtol=1e-5)


def test_auto_language_and_fallback_ladder(pipelines):
    """language=None detects per window; the fallback ladder re-decodes
    failing windows by sampling from a seeded generator (its tokens differ
    from JAX's sampler, so only the greedy-accepted path is compared)."""
    jax_pipe, pipe = pipelines
    a = audio(2.0, seed=40)
    kw = {"max_new_tokens": 8, "language": None}
    assert pipe(a, generate_kwargs=dict(kw)) == jax_pipe(a, generate_kwargs=dict(kw))
    out = pipe(a, return_timestamps="word",
               generate_kwargs={**KW, "fallback_temperatures": True})
    assert isinstance(out["text"], str)
    for ch in out["chunks"]:
        assert ch["timestamp"][0] is not None


def test_load_audio_path_matches_jax(pipelines, tmp_path):
    """A WAV path goes through the port's own load_audio."""
    from thewhisper_tpu.audio.io import save_wav

    jax_pipe, pipe = pipelines
    path = str(tmp_path / "a.wav")
    save_wav(path, audio(2.0, seed=50))
    kw = dict(return_timestamps="word", generate_kwargs=dict(KW))
    assert pipe(path, **kw) == jax_pipe(path, **kw)


@pytest.fixture(scope="module")
def s_pipelines():
    """Both "S" pipelines ("int8-all": weight-only int8 decoder and table,
    W8A8 encoder, int8 cross K/V) at f32 on the same float weights, each
    package quantizing them itself."""
    from thewhisper_tpu.models.quant import quantize_params as jax_quantize
    from thewhisper_tpu_torch.models.quant import quantize_params

    tree = jax_params_numpy()
    jtree = jax_quantize(jax_quantize(tree, components=("decoder",)),
                         components=("encoder",), activation_int8=True)
    jax_eng = JaxEngine(jtree, ARCH, special=SPECIAL, batch_buckets=(1, 2, 4),
                        suppress_tokens=SUPPRESS, cross_kv_int8=True)
    model = params_from_jax(tree, ARCH, dtype=torch.float32)
    quantize_params(model, components=("decoder",))
    quantize_params(model, components=("encoder",), activation_int8=True)
    eng = WhisperEngine(model, special=SPECIAL, suppress_tokens=SUPPRESS,
                        cross_kv_int8=True)
    tok = WordTokenizer()
    return (JaxPipeline(jax_eng, tokenizer=tok, chunk_length_s=3),
            ASRPipeline(eng, tokenizer=tok, chunk_length_s=3))


@pytest.mark.parametrize("seconds,chunk_length_s", [
    (2.0, None),               # one window
    (7.0, 2.0),                # five overlapping windows, LCS merge
])
def test_s_pipeline_matches_jax(s_pipelines, seconds, chunk_length_s):
    """Identical text and word timestamps, as for the float pipeline."""
    jax_pipe, pipe = s_pipelines
    a = audio(seconds, seed=2)
    kw = dict(return_timestamps="word", generate_kwargs=dict(KW),
              chunk_length_s=chunk_length_s)
    out, ref = pipe(a, **kw), jax_pipe(a, **kw)
    assert out == ref
    assert out["text"].strip() and out["chunks"]


def test_s_engine_result_matches_jax(s_pipelines):
    jax_pipe, pipe = s_pipelines
    batch = np.stack([audio(3.0, seed=22), audio(3.0, seed=23)])
    opts = GenerationOptions(max_new_tokens=8, language="en",
                             return_timestamps=True)
    ref = jax_pipe.engine.transcribe_audio(batch, opts)
    out = pipe.engine.transcribe_audio(batch, opts)
    np.testing.assert_array_equal(out.tokens, ref.tokens)
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)
    np.testing.assert_allclose(out.align, ref.align, atol=1e-5)
    np.testing.assert_allclose(out.token_logprobs, ref.token_logprobs, atol=1e-4)
