"""The port's beam search against the JAX package's, at f32 on the CPU.

``engine.decode.beam_decode`` against JAX's ``beam_decode`` (B x K cache
rows, the cross K/V tiled per beam), the engine's ``num_beams`` calls
against the JAX engine's on the same buckets, and the pipeline's text and
word timestamps. Tokens, every beam's tokens and the lengths are exact
(ties between candidates go to the lower flat index, as ``lax.top_k``
puts them); sum_logprob and token_logprobs within 1e-4, alignment 1e-5,
no_speech_prob 1e-6.

The tiny model's decoder position table is ten times larger than its
random init, so that the decoder emits a different token at most steps
(at 1x it repeats one): EOT, suppressed ids and the beams' scores then
decide something.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thewhisper_tpu.config import GenerationOptions
from thewhisper_tpu.engine import WhisperEngine as JaxEngine
from thewhisper_tpu.engine.decode import beam_decode as jax_beam
from thewhisper_tpu.engine.decode import suppress_mask
from thewhisper_tpu.models import whisper as jw
from thewhisper_tpu.pipeline import ASRPipeline as JaxPipeline
from thewhisper_tpu_torch.engine import WhisperEngine
from thewhisper_tpu_torch.engine import decode as td
from thewhisper_tpu_torch.models import whisper as tw
from thewhisper_tpu_torch.models.load import params_from_jax
from thewhisper_tpu_torch.pipeline import ASRPipeline

from _torch_tiny import ARCH, SPECIAL, SUPPRESS, WordTokenizer, audio, jax_params_numpy
from _torch_tiny import one_cpu_thread  # noqa: F401

PROMPT = np.asarray([[102, 110, 121, 123], [102, 111, 121, 123]], np.int32)
EOT = 70          # a token the varied model emits at its third step


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def varied():
    tree = jax_params_numpy()
    tree["decoder"]["pos_emb"] = tree["decoder"]["pos_emb"] * 10.0
    return tree, params_from_jax(tree, ARCH, dtype=torch.float32)


@pytest.fixture(scope="module")
def enc(varied):
    """JAX's encoder output on two random 300-frame mels."""
    tree, _ = varied
    rng = np.random.default_rng(3)
    mel = rng.standard_normal((2, ARCH.n_mels, 300)).astype(np.float32)
    return np.asarray(jw.encoder_forward(tree, jnp.asarray(mel), ARCH))


def _both_beams(tree, model, enc, beams, suppress, timestamps, k=8,
                max_new=8, jax_too=True):
    kw = dict(capture_alignment=timestamps, no_speech_id=SPECIAL.no_speech)
    mask = suppress_mask(ARCH.vocab_size, SUPPRESS) if suppress else None
    ref = None
    if jax_too:
        ck, cv = jw.compute_cross_kv(tree, jnp.asarray(enc), ARCH)
        rep = lambda x: jnp.repeat(x, beams, axis=1)       # noqa: E731
        jcache = jw.make_cache(ARCH, 2 * beams, 4 + max_new, rep(ck), rep(cv))
        ref = jax_beam(jax.tree.map(jnp.asarray, tree), ARCH,
                       jnp.asarray(PROMPT), jcache, beams, max_new, EOT,
                       suppress=None if mask is None else jnp.asarray(mask),
                       **kw)
    tk, tv = (x.repeat_interleave(beams, dim=1)
              for x in tw.compute_cross_kv(model, _t(enc)))
    cache = tw.make_cache(ARCH, 2 * beams, 4 + max_new, tk, tv)
    out = td.beam_decode(model, _t(PROMPT).long(), cache, beams, max_new, EOT,
                         suppress=None if mask is None else _t(mask),
                         steps_per_check=k, **kw)
    return ref, out


@pytest.mark.parametrize("beams,suppress,timestamps", [
    (2, True, True), (3, False, True), (4, True, False)])
def test_beam_decode_matches_jax(varied, enc, beams, suppress, timestamps):
    tree, model = varied
    ref, out = _both_beams(tree, model, enc, beams, suppress, timestamps)
    for name in ("tokens", "all_tokens", "num_generated"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    # Some beam took the EOT, so the finished-beam rule was exercised.
    assert (out.all_tokens[:, :, 4:] == EOT).any()
    np.testing.assert_allclose(out.sum_logprob.numpy(),
                               np.asarray(ref.sum_logprob), atol=1e-4)
    np.testing.assert_allclose(out.token_logprobs.numpy(),
                               np.asarray(ref.token_logprobs), atol=1e-4)
    np.testing.assert_allclose(out.no_speech_prob.numpy(),
                               np.asarray(ref.no_speech_prob), atol=1e-6)
    np.testing.assert_allclose(out.align.numpy(), np.asarray(ref.align),
                               atol=1e-5)
    # The best beam's total is the sum of its per-token logprobs.
    np.testing.assert_allclose(out.token_logprobs.sum(-1).numpy(),
                               out.sum_logprob.numpy(), atol=1e-4)


def test_beam_host_check_interval_changes_no_output(varied, enc):
    tree, model = varied
    runs = [_both_beams(tree, model, enc, 3, True, True, k=k, jax_too=False)[1]
            for k in (1, 5)]
    for name in td.BeamResult._fields[:-1]:
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name)), name


def test_ties_go_to_the_lower_index():
    x = torch.tensor([[0.5, 2.0, 2.0, -1.0, 2.0, 0.5]])
    values, idx = td._top_k(x, 4)
    assert idx.tolist() == [[1, 2, 4, 0]]
    assert values.tolist() == [[2.0, 2.0, 2.0, 0.5]]


@pytest.fixture(scope="module")
def engines(varied):
    tree, _ = varied
    jax_eng = JaxEngine(tree, ARCH, special=SPECIAL, batch_buckets=(1, 2, 4),
                        suppress_tokens=SUPPRESS)
    eng = WhisperEngine(params_from_jax(tree, ARCH, dtype=torch.float32),
                        special=SPECIAL, suppress_tokens=SUPPRESS,
                        batch_buckets=(1, 2, 4))
    return jax_eng, eng


@pytest.mark.parametrize("beams", [2, 3, 4])
def test_engine_beam_call_matches_jax(engines, beams):
    """Batch 3 in bucket 4, B K cache rows, word timestamps."""
    jax_eng, eng = engines
    mel = np.random.default_rng(11).standard_normal(
        (3, ARCH.n_mels, 300)).astype(np.float32)
    opts = GenerationOptions(max_new_tokens=8, language="en", num_beams=beams,
                             return_timestamps=True)
    ref = jax_eng.transcribe_features(mel, opts)
    out = eng.transcribe_features(mel, opts)
    assert out.tokens.shape == (3, 12)
    np.testing.assert_array_equal(out.tokens, ref.tokens)
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)
    np.testing.assert_allclose(out.sum_logprob, ref.sum_logprob, atol=1e-4)
    np.testing.assert_allclose(out.token_logprobs, ref.token_logprobs, atol=1e-4)
    np.testing.assert_allclose(out.align, ref.align, atol=1e-5)
    np.testing.assert_allclose(out.no_speech_prob, ref.no_speech_prob, atol=1e-6)
    assert (4, 300, 4, 8, True, beams) in [p["key"] for p in eng.programs()]


def test_pipeline_beam_text_and_words_match_jax(engines):
    jax_eng, eng = engines
    tok = WordTokenizer()
    jax_pipe = JaxPipeline(jax_eng, tokenizer=tok, chunk_length_s=3)
    pipe = ASRPipeline(eng, tokenizer=tok, chunk_length_s=3)
    a = audio(2.0, seed=1)
    kw = dict(return_timestamps="word",
              generate_kwargs={"max_new_tokens": 8, "language": "en",
                               "num_beams": 3})
    ref = jax_pipe(a, **kw)
    out = pipe(a, **kw)
    assert out == ref
    assert out["chunks"]
