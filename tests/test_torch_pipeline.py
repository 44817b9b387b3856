"""The port's offline pipeline against the JAX ASRPipeline, end to end.

Both pipelines get the same weights (the JAX tree through
``params_from_jax``) and the same audio, at f32 on the CPU, and must give
identical text and identical word timestamps: the greedy tokens are argmax
picks and the timestamps are DTW frame indices times 0.02 s, so agreement
is exact, not within a tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

from thewhisper_tpu.config import GenerationOptions
from thewhisper_tpu.engine import WhisperEngine as JaxEngine
from thewhisper_tpu.pipeline import ASRPipeline as JaxPipeline
from thewhisper_tpu_torch.engine import WhisperEngine
from thewhisper_tpu_torch.models.load import params_from_jax
from thewhisper_tpu_torch.models.whisper import Whisper
from thewhisper_tpu_torch.pipeline import ASRPipeline

from _torch_tiny import ARCH, SPECIAL, SUPPRESS, WordTokenizer, audio, jax_params_numpy
from _torch_tiny import one_cpu_thread  # noqa: F401

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


# ---------------------------------------------------------------------------
# Speculative decoding through the engine and the pipeline
# ---------------------------------------------------------------------------


def _spec_engines(kind, tree=None):
    """A JAX and a port engine on the same f32 weights, speculating with
    ngram drafting or a one-layer layer-skip draft."""
    from thewhisper_tpu.engine.speculative import make_layer_skip_draft as jax_skip
    from thewhisper_tpu_torch.engine.speculative import make_layer_skip_draft

    tree = tree if tree is not None else jax_params_numpy()
    model = params_from_jax(tree, ARCH, dtype=torch.float32)
    jkw = dict(special=SPECIAL, batch_buckets=(1, 2, 4),
               suppress_tokens=SUPPRESS, spec_window=3)
    kw = dict(special=SPECIAL, suppress_tokens=SUPPRESS, spec_window=3)
    if kind == "ngram":
        return (JaxEngine(tree, ARCH, spec_ngram=True, **jkw),
                WhisperEngine(model, spec_ngram=True, **kw))
    d_tree, d_arch = jax_skip(tree, ARCH, 1)
    return (JaxEngine(tree, ARCH, draft_params=d_tree, draft_arch=d_arch, **jkw),
            WhisperEngine(model, draft_model=make_layer_skip_draft(model, 1),
                          **kw))


def _same_result(out, ref, rounds=True):
    """Equal tokens and lengths (and verify rounds); alignment rows of the
    fed tokens and the generated tokens' logprobs to f32 tolerance (past a
    row's end greedy and speculation leave different filler)."""
    np.testing.assert_array_equal(out.tokens, ref.tokens)
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)
    if rounds:
        assert out.spec_rounds == ref.spec_rounds > 0
    for i, n in enumerate(ref.num_generated):
        upto = min(int(n) + 1, ref.token_logprobs.shape[1])
        np.testing.assert_allclose(out.token_logprobs[i, :upto],
                                   ref.token_logprobs[i, :upto], atol=1e-4)
        if ref.align is not None:
            rows = ref.prompt_len + max(int(n) - 1, 0)
            np.testing.assert_allclose(out.align[i, :, :rows],
                                       ref.align[i, :, :rows], atol=1e-5)


@pytest.mark.parametrize("kind", ["ngram", "layer-skip"])
def test_speculative_engine_matches_jax(pipelines, kind):
    """Tokens and rounds of the speculative engines, and their tokens
    against the plain greedy engine; proposal tokens take precedence."""
    jax_eng, eng = _spec_engines(kind)
    batch = np.stack([audio(3.0, seed=60), audio(3.0, seed=61)])
    opts = GenerationOptions(max_new_tokens=12, language="en",
                             return_timestamps=True)
    ref, out = jax_eng.transcribe_audio(batch, opts), eng.transcribe_audio(batch, opts)
    _same_result(out, ref)
    plain = pipelines[1].engine.transcribe_audio(batch, opts)
    _same_result(out, plain, rounds=False)
    assert plain.spec_rounds is None
    # The greedy output itself as proposals: accepted a window a round.
    mel = np.asarray(pipelines[0].featurizer(batch))
    props = ref.tokens[:, ref.prompt_len:]
    ref_p = jax_eng.transcribe_features(mel, opts, draft_tokens=props)
    out_p = eng.transcribe_features(mel, opts, draft_tokens=props)
    _same_result(out_p, ref_p)
    np.testing.assert_array_equal(out_p.tokens, out.tokens)
    # Sampling and beam calls drop the proposals (sampling runs plainly).
    sampled = eng.transcribe_features(
        mel, GenerationOptions(max_new_tokens=4, language="en",
                               temperature=0.5), draft_tokens=props)
    assert sampled.spec_rounds is None


def test_engine_draft_arguments_checked():
    from thewhisper_tpu_torch.engine.speculative import make_layer_skip_draft

    model = params_from_jax(jax_params_numpy(), ARCH)
    with pytest.raises(ValueError, match="pick one"):
        WhisperEngine(model, spec_ngram=True,
                      draft_model=make_layer_skip_draft(model, 1))
    other = dataclasses.replace(ARCH, vocab_size=ARCH.vocab_size + 1)
    with torch.device("meta"):
        bad = Whisper(other)
    with pytest.raises(ValueError, match="vocab"):
        WhisperEngine(model, draft_model=bad)


def test_draft_int8_leaves_the_target_float():
    """draft_int8 quantizes a layer-skip draft's copy of the shared layers;
    the target keeps its float layers and the tokens stay greedy's."""
    from thewhisper_tpu_torch.engine.speculative import make_layer_skip_draft
    from thewhisper_tpu_torch.models.quant import Int8Linear

    model = params_from_jax(jax_params_numpy(), ARCH)
    eng = WhisperEngine(model, special=SPECIAL, suppress_tokens=SUPPRESS,
                        draft_model=make_layer_skip_draft(model, 1),
                        spec_window=3, draft_int8=True)
    assert type(eng.draft_model.decoder.layers[0].fc1) is Int8Linear
    assert type(model.decoder.layers[0].fc1) is torch.nn.Linear
    plain = WhisperEngine(model, special=SPECIAL, suppress_tokens=SUPPRESS)
    batch = np.stack([audio(3.0, seed=62)])
    opts = GenerationOptions(max_new_tokens=10, language="en")
    out, ref = eng.transcribe_audio(batch, opts), plain.transcribe_audio(batch, opts)
    np.testing.assert_array_equal(out.tokens, ref.tokens)


def test_reuse_previous_tokens_matches_jax():
    """Two transcribe_batch calls with cross-call reuse: the second call
    speculates off the first's tokens; both give JAX's text and times."""
    tree = jax_params_numpy()
    jax_eng = JaxEngine(tree, ARCH, special=SPECIAL, batch_buckets=(1, 2, 4),
                        suppress_tokens=SUPPRESS)
    eng = WhisperEngine(params_from_jax(tree, ARCH, dtype=torch.float32),
                        special=SPECIAL, suppress_tokens=SUPPRESS)
    tok = WordTokenizer()
    jax_pipe = JaxPipeline(jax_eng, tokenizer=tok, chunk_length_s=3,
                           reuse_previous_tokens=True)
    pipe = ASRPipeline(eng, tokenizer=tok, chunk_length_s=3,
                       reuse_previous_tokens=True)
    audios = [audio(2.0, seed=70), audio(2.5, seed=71)]
    calls = []
    generate = eng._generate

    def recording(*args, **kwargs):
        res = generate(*args, **kwargs)
        calls.append(res)
        return res

    eng._generate = recording
    for _ in range(2):
        ref = jax_pipe.transcribe_batch(audios, generate_kwargs=dict(KW))
        out = pipe.transcribe_batch(audios, generate_kwargs=dict(KW))
        for o, r in zip(out, ref):
            assert o["text"] == r["text"]
            assert [c["timestamp"] for c in o["chunks"]] == [
                c["timestamp"] for c in r["chunks"]]
        np.testing.assert_array_equal(pipe._prev_gen_tokens,
                                      jax_pipe._prev_gen_tokens)
    assert calls[0].spec_rounds is None and calls[1].spec_rounds > 0
    np.testing.assert_array_equal(calls[0].tokens, calls[1].tokens)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    import sys

    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    sys.path.insert(0, "tools")
    from make_tiny_checkpoint import make_checkpoint

    return make_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny"), seed=3)


def test_from_checkpoint_drafts_match_jax(tiny_ckpt, tmp_path):
    """from_checkpoint(draft=...) with a layer-skip draft and with a draft
    .npz written by JAX's save_draft: JAX's tokens and rounds."""
    import jax.numpy as jnp

    from thewhisper_tpu.engine.speculative import make_layer_skip_draft, save_draft
    from thewhisper_tpu.models.load import load_checkpoint

    tree, arch = load_checkpoint(tiny_ckpt, dtype=jnp.float32,
                                 chunk_length_s=10)
    npz = str(tmp_path / "draft")
    save_draft(npz, *make_layer_skip_draft(tree, arch, 1))
    mel = np.random.default_rng(9).standard_normal(
        (1, arch.n_mels, 60)).astype(np.float32)
    opts = GenerationOptions(max_new_tokens=8, language="en")
    for draft in ("layer-skip:1", npz + ".npz"):
        ref = JaxEngine.from_checkpoint(
            tiny_ckpt, chunk_length_s=10, compute_dtype=jnp.float32,
            draft=draft, spec_window=2).transcribe_features(mel, opts)
        eng = WhisperEngine.from_checkpoint(
            tiny_ckpt, chunk_length_s=10, compute_dtype=torch.float32,
            device="cpu", draft=draft, spec_window=2)
        assert eng.draft_model.arch.decoder_layers == 1
        _same_result(eng.transcribe_features(mel, opts), ref)


def test_ngram_pipeline_from_checkpoint_matches_jax(tiny_ckpt):
    """ASRPipeline(draft="ngram") on a checkpoint: JAX's text and word
    timestamps."""
    a = audio(2.0, seed=80)
    kw = dict(return_timestamps="word",
              generate_kwargs={"max_new_tokens": 12, "language": "en"})
    pipe = ASRPipeline(tiny_ckpt, model_size="XL32", device="cpu",
                       draft="ngram")
    assert pipe.engine.spec_ngram
    assert pipe(a, **kw) == JaxPipeline(tiny_ckpt, model_size="XL32",
                                        draft="ngram")(a, **kw)
