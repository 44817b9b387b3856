"""Speculative decoding on device state against the JAX package, at f32 on
the CPU.

``SpecLoop`` keeps the speculative loop's state in tensors and gates every
write of a round on its row being live, so the host may read the stop flag
every k rounds without changing an output, and a round reads nothing back
to the host (``decoder_verify`` writes its window at positions it never
reads). The engine pads a speculative call to its bucket and keys a
program on it, as JAX's engine does, so its tokens, alignment and verify
rounds are JAX's at a batch that is no bucket too. Sampled steps draw by
the exponential race, the same draws however the steps are grouped.
Tolerances are those of ``tests/test_torch_speculative.py`` and
``tests/test_torch_pipeline.py``; tokens and rounds are exact.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thewhisper_tpu.config import GenerationOptions
from thewhisper_tpu.engine import WhisperEngine as JaxEngine
from thewhisper_tpu.engine import speculative as jspec
from thewhisper_tpu.engine.decode import suppress_mask
from thewhisper_tpu_torch.engine import WhisperEngine
from thewhisper_tpu_torch.engine import decode as td
from thewhisper_tpu_torch.engine import engine as te
from thewhisper_tpu_torch.engine import speculative as tspec
from thewhisper_tpu_torch.models import whisper as tw
from thewhisper_tpu_torch.models.load import params_from_jax
from thewhisper_tpu_torch.ops import mega_step as tm

import _torch_tiny as tiny
from test_torch_decode_device import _RunningGraph, _copy, packed  # noqa: F401
from test_torch_speculative import (  # noqa: F401
    ARCH,
    MAX_NEW,
    PROMPT,
    SP,
    W,
    _assert_exact,
    _caches,
    _draft,
    _t,
    models,
)
from _torch_tiny import one_cpu_thread  # noqa: F401

SUP = suppress_mask(ARCH.vocab_size, (0, 3))
BEG = suppress_mask(ARCH.vocab_size, (5,))
S_CAP = 4 + MAX_NEW + W + 1
FIELDS = ("tokens", "num_generated", "sum_logprob", "token_logprobs",
          "no_speech_prob", "align")


@pytest.fixture(scope="module")
def spec(models):
    """What the loop tests share, made once: the encoder states, the JAX
    and port caches of the target and of the layer-skip draft (the port's
    copied for every loop), the proposals and JAX's results by kind, each
    made once with alignment (without it JAX's loop is the same but for
    the alignment). A perfect draft proposes greedy's own tokens; the
    half-right one greedy's for the first half of the generation, then a
    wrong one. (``tests/test_torch_speculative.py`` holds the target as
    its own draft against JAX; its JAX loop takes 9 s to compile.)"""
    tree, model = models["target"]
    mel = np.random.default_rng(5).standard_normal(
        (3, ARCH.n_mels, 100)).astype(np.float32)
    with torch.inference_mode():
        enc = tw.encoder_forward(model, torch.from_numpy(mel)).numpy()
    caches = {None: _caches(tree, ARCH, enc, S_CAP)}
    d_tree, d_arch, _ = _draft(models, "layer-skip")
    caches["layer-skip"] = _caches(d_tree, d_arch, enc, S_CAP)
    greedy = td.greedy_decode(model, _t(PROMPT).long(), _copy(caches[None][1]),
                              MAX_NEW, SP.eot, suppress=_t(SUP),
                              begin_suppress=_t(BEG))
    perfect = greedy.tokens.numpy()[:, 4:].copy()
    half = perfect.copy()
    half[:, MAX_NEW // 2:] = 7
    return SimpleNamespace(caches=caches, refs={}, props={
        "perfect": perfect, "proposals-half": half})


def _props(spec, kind):
    return spec.props.get(kind)


def _model_draft(models, kind):
    """(JAX tree, JAX arch, port model) of the layer-skip draft, else
    Nones: the other kinds draft without a model."""
    return _draft(models, kind if kind == "layer-skip" else None)


def _loop(models, spec, kind, capture):
    """A started ``SpecLoop`` of ``kind`` over fresh caches."""
    _, model = models["target"]
    _, _, d_model = _model_draft(models, kind)
    d = spec.caches.get(kind)
    props = _props(spec, kind)
    loop = tspec.SpecLoop(
        model, d_model, _copy(spec.caches[None][1]),
        None if d is None else _copy(d[1]), 4, MAX_NEW, SP.eot, W, _t(SUP),
        _t(BEG), capture, SP.no_speech, ngram_draft=kind == "ngram",
        proposals=props is not None)
    loop.start(_t(PROMPT).long(), None if props is None else _t(props))
    return loop


def _jax_ref(models, spec, kind):
    if kind not in spec.refs:
        tree, _ = models["target"]
        d_tree, d_arch, _ = _model_draft(models, kind)
        d = spec.caches.get(kind)
        props = _props(spec, kind)
        spec.refs[kind] = jspec.speculative_decode(
            tree, ARCH, d_tree, d_arch, jnp.asarray(PROMPT),
            spec.caches[None][0], None if d is None else d[0], MAX_NEW,
            SP.eot, spec_window=W, suppress=jnp.asarray(SUP),
            begin_suppress=jnp.asarray(BEG), capture_alignment=True,
            no_speech_id=SP.no_speech, ngram_draft=kind == "ngram",
            proposal_tokens=None if props is None else jnp.asarray(props))
    return spec.refs[kind]


@pytest.mark.parametrize("capture", [True, False])
@pytest.mark.parametrize("kind", ["perfect", "layer-skip", "ngram",
                                  "proposals-half"])
def test_spec_loop_matches_jax_at_any_grouping(models, spec, kind, capture):
    """``SpecLoop`` run with the stop flag read every 1, 2 and 3 rounds:
    the same bits each time, tails included, and JAX's
    ``speculative_decode``'s tokens, lengths, logprobs, alignment and
    rounds."""
    runs = []
    for k in (1, 2, 3):
        loop = _loop(models, spec, kind, capture)
        loop.run(k)
        runs.append(loop.result())
    for r in runs[1:]:
        for name in FIELDS:
            assert torch.equal(getattr(r, name), getattr(runs[0], name)), name
        assert r.rounds == runs[0].rounds
    ref = _jax_ref(models, spec, kind)
    got = runs[0]
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(ref.num_generated))
    assert got.rounds == int(ref.rounds) > 0
    _assert_exact(ref, got, capture)
    if not capture:
        assert got.align.shape == (3, 1, 1, 1)
    if kind == "perfect":
        # Every round accepts the whole window.
        assert got.rounds <= -(-(MAX_NEW - 1) // (W + 1)) + 1


def test_a_loop_done_after_the_prefill_runs_no_round(models, spec,
                                                     monkeypatch):
    """As JAX's ``while_loop`` tests its condition first, a loop whose rows
    are all done after the prefill (here one new token) runs no round,
    eagerly or from a graph: no draft pass, no verify (no K4 launch), 0
    rounds, and greedy's token."""
    _, model = models["target"]
    d = spec.caches["layer-skip"]
    _, _, d_model = _model_draft(models, "layer-skip")
    ref = td.greedy_decode(model, _t(PROMPT).long(), _copy(spec.caches[None][1]),
                           1, SP.eot, suppress=_t(SUP), begin_suppress=_t(BEG))
    loop = tspec.SpecLoop(model, d_model, _copy(spec.caches[None][1]),
                          _copy(d[1]), 4, 1, SP.eot, W, _t(SUP), _t(BEG))
    loop.start(_t(PROMPT).long())

    def refuse(*a, **k):
        raise AssertionError("a round ran")

    monkeypatch.setattr(loop, "_step", refuse)
    assert loop.run(1) == 0 and loop.run(1, replay=refuse) == 0
    got = loop.result()
    assert got.rounds == 0
    assert torch.equal(got.tokens, ref.tokens.long()[:, :5].int())


@pytest.mark.parametrize("kind", ["layer-skip", "ngram", "proposals-half"])
def test_a_round_reads_nothing_back(models, spec, monkeypatch, kind):
    """Three rounds from the start and three past the stop run with
    ``item``, ``tolist``, ``__bool__``, ``nonzero`` and ``cpu`` raising: the
    rounds past the stop verify windows that reach past the cache's end
    (their writes dropped) and change no output, and the outputs are
    ``speculative_decode``'s."""
    loop = _loop(models, spec, kind, True)

    def rounds_without_reads(n):
        with monkeypatch.context() as m:
            for name in ("item", "tolist", "__bool__", "nonzero", "cpu"):
                def refuse(*a, _name=name, **k):
                    raise AssertionError(f"a round called Tensor.{_name}")
                m.setattr(torch.Tensor, name, refuse)
            with pytest.raises(AssertionError, match="__bool__"):
                bool(loop.done.all())
            loop.steps(n)

    rounds_without_reads(3)
    loop.run(1)
    assert bool(loop.done.all())
    before = [getattr(loop.result(), name).clone() for name in FIELDS]
    # The most a finished row can have accepted (its last round overshot
    # by W): its windows start past the cache's end.
    loop.n_acc.fill_(MAX_NEW + W)
    assert loop.p + MAX_NEW + W - 1 + W >= loop.s_buf
    rounds_without_reads(3)
    got = loop.result()
    for name, b in zip(FIELDS, before):
        assert torch.equal(getattr(got, name), b), name
    _, model = models["target"]
    _, _, d_model = _model_draft(models, kind)
    d = spec.caches.get(kind)
    props = _props(spec, kind)
    ref = tspec.speculative_decode(
        model, d_model, _t(PROMPT).long(), _copy(spec.caches[None][1]),
        None if d is None else _copy(d[1]), MAX_NEW, SP.eot, spec_window=W,
        suppress=_t(SUP), begin_suppress=_t(BEG), capture_alignment=True,
        no_speech_id=SP.no_speech, ngram_draft=kind == "ngram",
        proposal_tokens=None if props is None else _t(props))
    for name in FIELDS:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    assert got.rounds == ref.rounds


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_tree():
    tree = tiny.jax_params_numpy()
    return tree, params_from_jax(tree, tiny.ARCH, dtype=torch.float32)


def _engine_kw(mode):
    return dict(special=tiny.SPECIAL, suppress_tokens=tiny.SUPPRESS,
                batch_buckets=(1, 2, 4), spec_window=3,
                spec_ngram=mode == "ngram")


def _engine(tiny_tree, mode):
    """A port engine on the f32 weights, buckets (1, 2, 4), ngram drafting
    or not (proposals come with the call)."""
    return WhisperEngine(tiny_tree[1], **_engine_kw(mode))


def _mel(batch=3, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (batch, tiny.ARCH.n_mels, 300)).astype(np.float32)


def _same(out, ref):
    np.testing.assert_array_equal(out.tokens, ref.tokens)
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)
    assert out.spec_rounds == ref.spec_rounds > 0
    np.testing.assert_allclose(out.align, ref.align, atol=1e-5)
    np.testing.assert_allclose(out.sum_logprob, ref.sum_logprob, atol=1e-4)
    np.testing.assert_allclose(out.token_logprobs, ref.token_logprobs,
                               atol=1e-4)
    np.testing.assert_allclose(out.no_speech_prob, ref.no_speech_prob,
                               atol=1e-6)


OPTS = GenerationOptions(max_new_tokens=8, language="en",
                         return_timestamps=True)


@pytest.mark.parametrize("mode", ["proposals", "ngram"])
def test_padded_speculative_call_matches_jax(tiny_tree, mode):
    """Batch 3 on buckets (1, 2, 4): both engines decode four rows (a zero
    mel and zero proposals in the last) and return three, with JAX's verify
    rounds and alignment (``tests/test_torch_pipeline.py`` holds a batch
    that is a bucket); the port keeps one program for the key."""
    jax_eng = JaxEngine(tiny_tree[0], tiny.ARCH, **_engine_kw(mode))
    eng = _engine(tiny_tree, mode)
    mel = _mel()
    props = None
    if mode == "proposals":
        plain = eng.transcribe_features(mel, OPTS)
        props = plain.tokens[:, plain.prompt_len:].copy()
        props[:, 4:] = 7
    ref = jax_eng.transcribe_features(mel, OPTS, draft_tokens=props)
    out = eng.transcribe_features(mel, OPTS, draft_tokens=props)
    assert out.tokens.shape == ref.tokens.shape == (3, 12)
    _same(out, ref)
    key = (4, 300, 4, 8, True, 1, 0.0, mode)
    assert key in [p["key"] for p in eng.programs()]


@pytest.mark.parametrize("mode", ["proposals", "ngram"])
def test_speculative_graph_route_matches_eager(tiny_tree, monkeypatch, mode):
    """The engine's graph route for a speculative key (the loop parked, one
    warm-up round, then replays of ROUNDS_PER_CHECK rounds), with the
    graph run by ``_RunningGraph``: every output equal to the eager
    engine's, on a second call of the key as on the first."""
    eager = _engine(tiny_tree, mode)
    mel = _mel()
    calls = [(mel, None), (mel[::-1], None)]
    if mode == "proposals":
        plain = eager.transcribe_features(mel, OPTS)
        props = plain.tokens[:, plain.prompt_len:]
        calls = [(mel, props), (mel[::-1], props[::-1])]
    ref = [eager.transcribe_features(m, OPTS, draft_tokens=d) for m, d in calls]
    monkeypatch.setattr(te, "StepGraph", _RunningGraph)
    graphed = _engine(tiny_tree, mode)
    graphed.cuda_graphs = True
    for (m, d), r in zip(calls, ref):
        out = graphed.transcribe_features(m, OPTS, draft_tokens=d)
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(out, name),
                                          getattr(r, name), name)
        assert out.spec_rounds == r.spec_rounds
    assert [p["graph"] for p in graphed.programs()] == [True]


def test_k4_plain_takes_a_device_window_position(packed):  # noqa: F811
    """``mega_decoder_verify`` (K4's route, its plain version on the CPU)
    at a window position held in a tensor gives the bits it gives at the
    host int, cache included."""
    model, cache = packed
    tokens = torch.arange(17, 21)[None]
    for pos in (0, 9, 16):
        a, b = _copy(cache), _copy(cache)
        la, _, _ = tm.mega_decoder_verify(model, tokens, pos, a, plain=True)
        lb, _, _ = tm.mega_decoder_verify(model, tokens, torch.tensor([pos]),
                                          b, plain=True)
        assert torch.equal(la, lb)
        assert torch.equal(a.self_k, b.self_k) and torch.equal(a.self_v, b.self_v)


def test_warmup_makes_the_proposals_programs(tiny_tree):
    """``warmup(proposals=True)`` makes each bucket's greedy and proposals
    programs (JAX's warm-up compiles both); the server's ``warm_up`` makes
    them when the pipeline reuses the previous tick's tokens, so a drafted
    call of those shapes makes no program."""
    from thewhisper_tpu_torch.pipeline import ASRPipeline
    from thewhisper_tpu_torch.server.launch import warm_up

    eng = _engine(tiny_tree, "proposals")
    eng.warmup(300, (1, 3), 3, True, proposals=True)
    keys = [p["key"] for p in eng.programs()]
    base = [(b, 300, 4, 3, True, 1) for b in (1, 4)]
    assert sorted(keys, key=len) == base + [k + (0.0, "proposals") for k in base]

    eng = _engine(tiny_tree, "proposals")
    asr = ASRPipeline(eng, tokenizer=tiny.WordTokenizer(), chunk_length_s=3,
                      reuse_previous_tokens=True)
    warm_up(asr, 3, max_new_tokens=3, max_batch=1)
    keys = {p["key"] for p in eng.programs()}
    assert keys == {(1, 300, 4, 3, True, 1),
                    (1, 300, 4, 3, True, 1, 0.0, "proposals")}
    gk = {"max_new_tokens": 3, "language": "en"}
    for _ in range(2):             # the second call drafts from the first
        asr.transcribe_batch([tiny.audio(2.0, seed=3)],
                             return_timestamps="word", generate_kwargs=gk)
    assert {p["key"] for p in eng.programs()} == keys


def test_sampled_tokens_do_not_depend_on_the_grouping(tiny_tree, monkeypatch):
    """A sampled decode with the host reading the flag every 1, 2 and 3
    steps draws the same tokens for a seed (steps past the stop draw and
    change nothing), another seed others; the engine's graph route
    (``_RunningGraph``, the generator passed to the graph) gives the eager
    engine's tokens for two seeds and two temperatures on one program."""
    tree, model = tiny_tree
    enc = tw.encoder_forward(model, torch.from_numpy(_mel(2)))
    runs = {}
    for seed, k in ((0, 1), (0, 2), (0, 3), (1, 1)):
        tk, tv = tw.compute_cross_kv(model, enc)
        cache = tw.make_cache(tiny.ARCH, 2, 4 + 10, tk, tv)
        res = td.greedy_decode(
            model, torch.tensor([[102, 110, 121, 123]] * 2), cache, 10,
            tiny.SPECIAL.eot, capture_alignment=True, temperature=1.0,
            generator=torch.Generator().manual_seed(seed), steps_per_check=k)
        runs[seed, k] = res
    for k in (2, 3):
        for name in ("tokens", "num_generated", "sum_logprob",
                     "token_logprobs", "align"):
            assert torch.equal(getattr(runs[0, k], name),
                               getattr(runs[0, 1], name)), name
    assert not torch.equal(runs[1, 1].tokens, runs[0, 1].tokens)

    class Graph(_RunningGraph):
        def __init__(self, run, warm, device, *generators):
            assert len(generators) == 1
            super().__init__(run, warm, device)

    hot = [dataclasses.replace(OPTS, temperature=t, seed=s)
           for t, s in ((0.7, 1), (0.7, 2), (0.3, 1))]
    eager = _engine(tiny_tree, None)
    ref = [eager.transcribe_features(_mel(), o) for o in hot]
    monkeypatch.setattr(te, "StepGraph", Graph)
    graphed = _engine(tiny_tree, None)
    graphed.cuda_graphs = True
    for o, r in zip(hot, ref):
        out = graphed.transcribe_features(_mel(), o)
        for name in FIELDS:
            np.testing.assert_array_equal(getattr(out, name),
                                          getattr(r, name), name)
    assert not np.array_equal(ref[0].tokens, ref[1].tokens)
    # One program, its temperature a device scalar, serves both rungs.
    assert [p["key"] for p in graphed.programs()] == [
        (4, 300, 4, 8, True, 1, True, None)]
