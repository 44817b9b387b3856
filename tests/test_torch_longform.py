"""The port's long-form windowing against the JAX pipeline's, option by
option: latency buckets, dispatch ahead of the fetch, the offset-window
path, the tail split, window groups and the first-window fast path; then
the engine's handles and offset entry points against JAX's, and the
handles a failed call leaves behind.

Both packages get the same weights (the JAX tree through
``params_from_jax``), f32 on the CPU, batch buckets (1, 2, 4), and the same
audio; text, word timestamps and chunks must be identical (greedy tokens
are argmax picks and timestamps DTW frame indices times 0.02 s).
``PIPELINE_DEPTH`` is set on both modules alike.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import thewhisper_tpu.pipeline as jax_pl
import thewhisper_tpu_torch.pipeline as pl
from thewhisper_tpu.config import GenerationOptions as JaxOptions
from thewhisper_tpu.engine import WhisperEngine as JaxEngine
from thewhisper_tpu_torch.audio.features import LogMelFeaturizer
from thewhisper_tpu_torch.config import GenerationOptions
from thewhisper_tpu_torch.engine import WhisperEngine
from thewhisper_tpu_torch.engine.engine import PendingGroup, PendingResult, to_device
from thewhisper_tpu_torch.models.load import params_from_jax

from _torch_tiny import ARCH, SPECIAL, SUPPRESS, WordTokenizer, audio, jax_params_numpy
from _torch_tiny import one_cpu_thread  # noqa: F401

KW = {"max_new_tokens": 8, "language": "en"}
BUCKETS = (1, 2, 4)


@pytest.fixture(scope="module")
def engines():
    tree = jax_params_numpy()
    jax_eng = JaxEngine(tree, ARCH, special=SPECIAL, batch_buckets=BUCKETS,
                        suppress_tokens=SUPPRESS)
    eng = WhisperEngine(params_from_jax(tree, ARCH, dtype=torch.float32),
                        special=SPECIAL, suppress_tokens=SUPPRESS,
                        batch_buckets=BUCKETS)
    return jax_eng, eng


def _pipes(engines, **kw):
    jax_eng, eng = engines
    tok = WordTokenizer()
    return (jax_pl.ASRPipeline(jax_eng, tokenizer=tok, chunk_length_s=3, **kw),
            pl.ASRPipeline(eng, tokenizer=tok, chunk_length_s=3, **kw))


@pytest.fixture(scope="module")
def pipes(engines):
    return _pipes(engines)


ENTRIES = ("transcribe_audio_async", "transcribe_audio",
           "transcribe_window_async", "transcribe_windows_async",
           "transcribe_window_scan_async", "transcribe_batch_scan_async")


def _same(pipes, monkeypatch, a, depth=2, gen=None, entries=(), **call):
    """Both pipelines on ``a`` at ``PIPELINE_DEPTH`` = depth, word
    timestamps, 2 s call windows; the port's output must equal JAX's, and
    its engine must have been called through each of ``entries``."""
    monkeypatch.setattr(jax_pl, "PIPELINE_DEPTH", depth)
    monkeypatch.setattr(pl, "PIPELINE_DEPTH", depth)
    kw = dict(return_timestamps="word", chunk_length_s=2.0, **call)
    jax_pipe, pipe = pipes
    called = set()
    with monkeypatch.context() as m:
        for name in ENTRIES:
            real = getattr(pipe.engine, name)
            m.setattr(pipe.engine, name, lambda *x, _r=real, _n=name, **k: (
                called.add(_n) or _r(*x, **k)))
        out = pipe(a, generate_kwargs=dict(KW, **(gen or {})), **kw)
    ref = jax_pipe(a, generate_kwargs=dict(KW, **(gen or {})), **kw)
    assert out == ref
    assert out["chunks"]
    assert called >= set(entries), called
    return out


def test_latency_buckets_match_jax(engines, monkeypatch):
    jax_pipe, pipe = _pipes(engines, latency_buckets=[1.0, 2.0, 5.0, 0.0])
    assert pipe.latency_buckets == jax_pipe.latency_buckets == [1.0, 2.0, 3.0]
    for s in (0.8, 1.0, 1.5, 2.9, 3.5):
        assert pipe._pick_bucket(s) == jax_pipe._pick_bucket(s)
    # A short buffer rides the 1 s bucket (100 mel frames).
    short = [audio(0.7, seed=9)]
    gk = {"max_new_tokens": 4, "language": "en"}
    [out] = pipe.transcribe_batch(short, generate_kwargs=dict(gk))
    [ref] = jax_pipe.transcribe_batch(short, generate_kwargs=dict(gk))
    assert out["text"] == ref["text"]
    assert ([(c["text"], c["timestamp"]) for c in out["chunks"]]
            == [(c["text"], c["timestamp"]) for c in ref["chunks"]])
    # Confidences come from f32 logprobs computed in two frameworks.
    np.testing.assert_allclose([c["confidence"] for c in out["chunks"]],
                               [c["confidence"] for c in ref["chunks"]],
                               rtol=1e-5)
    assert pipe._featurizers[1.0].num_mel_frames() == 100
    # 2 s call windows on a 2 s bucket, on the offset path and at depth 0.
    jax_pipe, pipe = _pipes(engines, latency_buckets=[2.0])
    for depth, entry in ((0, "transcribe_audio_async"),
                         (2, "transcribe_windows_async")):
        _same((jax_pipe, pipe), monkeypatch, audio(8.0, seed=9), depth=depth,
              entries=[entry])
    assert 2.0 in pipe._featurizers
    assert {k[1] for k in engines[1]._programs} >= {200}


@pytest.mark.parametrize("depth,beams", [(0, 1), (2, 1), (0, 2), (2, 2)])
def test_dispatch_depth_matches_jax(pipes, monkeypatch, depth, beams):
    """Depth 0 decodes each call before the next; depth 2 takes the offset
    path (greedy) or dispatches two beam calls ahead of the fetch."""
    a = audio(12.0 if beams == 1 else 10.0, seed=7 + beams)
    entry = ("transcribe_windows_async" if depth and beams == 1
             else "transcribe_audio_async")
    _same(pipes, monkeypatch, a, depth=depth,
          gen={"num_beams": beams, "max_new_tokens": 6}, entries=[entry])


def test_long_form_language_detection_matches_jax(pipes, monkeypatch):
    """language=None on a long file: its windows, sliced on the device,
    are featurized there for detection and decoded from those features."""
    _same(pipes, monkeypatch, audio(9.0, seed=43), batch_size=3,
          gen={"language": None})


@pytest.mark.parametrize("seconds,batch_size,seed,entries", [
    # one window a call, the last window short
    (11.3, 1, 13, ["transcribe_window_async"]),
    # ten windows: 3 + 3 + 3 + 1
    (13.1, 3, 17, ["transcribe_windows_async", "transcribe_window_async"]),
    # seven windows: 4, then the tail of 3 splits to 2 + 1
    (9.0, 4, 29, ["transcribe_windows_async", "transcribe_window_async"]),
])
def test_offset_path_matches_jax(pipes, monkeypatch, seconds, batch_size,
                                 seed, entries):
    _same(pipes, monkeypatch, audio(seconds, seed=seed), batch_size=batch_size,
          entries=entries)


def test_tail_fit_matches_jax():
    for case in ((7, 4, (1, 2, 4)), (3, 4, (1, 2, 4)), (1, 4, (1, 2, 4)),
                 (36, 64, (4, 32, 64)), (3, 64, (64,))):
        assert pl._tail_fit(*case) == jax_pl._tail_fit(*case)
    assert pl._tail_fit(7, 4, (1, 2, 4)) == 4
    assert pl._tail_fit(3, 4, (1, 2, 4)) == 2
    assert pl._tail_fit(1, 4, (1, 2, 4)) == 1
    assert pl._tail_fit(36, 64, (4, 32, 64)) == 32
    assert pl._tail_fit(3, 64, (64,)) == 3


@pytest.mark.parametrize("wpp,batch_size,seconds", [
    (3, 1, 13.1),      # groups of 3 windows at batch 1: 3 + 3 + 3 + 1
    (2, 3, 14.9),      # 2 x 3 windows under one handle, then 3 and 2
])
def test_window_groups_match_jax(pipes, monkeypatch, wpp, batch_size, seconds):
    for p in pipes:
        monkeypatch.setattr(p, "windows_per_program", wpp)
    entry = ("transcribe_window_scan_async" if batch_size == 1
             else "transcribe_batch_scan_async")
    _same(pipes, monkeypatch, audio(seconds, seed=19), batch_size=batch_size,
          entries=[entry])


@pytest.mark.parametrize("wpp", [1, 2])
def test_first_window_fast_matches_jax(pipes, monkeypatch, wpp):
    firsts = {"jax": [], "torch": []}
    a = audio(13.1, seed=31)
    for name, p in zip(firsts, pipes):
        monkeypatch.setattr(p, "windows_per_program", wpp)
        monkeypatch.setattr(p, "first_window_fast", True)
        monkeypatch.setattr(p, "on_first_result", firsts[name].append)
    out = _same(pipes, monkeypatch, a, batch_size=3,
                entries=["transcribe_window_async"])
    assert firsts["torch"] == firsts["jax"] and len(firsts["torch"]) == 1
    assert firsts["torch"][0] and firsts["torch"][0] in out["text"]
    assert 0 < pipes[1].last_first_result_s < 60
    # The next call reports again, once; a call off the path clears it.
    _same(pipes, monkeypatch, a, batch_size=3)
    assert len(firsts["torch"]) == 2
    pipes[1](audio(2.0, seed=1), generate_kwargs=dict(KW))
    assert pipes[1].last_first_result_s is None


# -- the engine ---------------------------------------------------------------

N_FILE = int(7.3 * 16000) + 3 * 16000          # padded by one model window
WIN, BUCKET = 2 * 16000, 3 * 16000


def _file():
    f = np.zeros(N_FILE, np.float32)
    f[: int(7.3 * 16000)] = audio(7.3, seed=41)
    return f


def _assert_result(got, want, rows):
    assert got.tokens.shape[0] == rows and got.prompt_len == want.prompt_len
    for name in ("tokens", "num_generated"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for name in ("sum_logprob", "token_logprobs", "no_speech_prob", "align"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("entry,args,rows", [
    ("transcribe_window_async", (64000,), 1),
    ("transcribe_windows_async", ([0, 32000, 64000],), 3),     # bucket 4
    ("transcribe_window_scan_async", ([0, 32000, 80000], 4), 3),
    ("transcribe_batch_scan_async", ([0, 16000, 48000, 80000], 2, 2), 4),
])
def test_offset_entry_points_match_jax(engines, entry, args, rows):
    """Each handle's result() against JAX's for the same offsets (word
    alignment on); f32 sums to a tolerance that covers summation order."""
    jax_eng, eng = engines
    f = _file()
    kw = dict(max_new_tokens=6, language="en", return_timestamps=True)
    want = getattr(jax_eng, entry)(f, *args, WIN, BUCKET,
                                   JaxOptions(**kw)).result()
    handle = getattr(eng, entry)(f, *args, WIN, BUCKET, GenerationOptions(**kw))
    assert isinstance(handle, PendingGroup if "scan" in entry else PendingResult)
    got = handle.result()
    _assert_result(got, want, rows)
    assert handle.result() is got


def test_audio_and_feature_handles_match_the_synchronous_calls(engines):
    """transcribe_audio_async / transcribe_features_async equal their
    synchronous calls and JAX's; two handles of one key in flight each
    decode their own audio, whatever order they resolve in; a tensor on the
    engine's device goes in as it is."""
    jax_eng, eng = engines
    opts = dict(max_new_tokens=6, language="en", return_timestamps=True)
    a = np.stack([audio(3.0, seed=50), audio(3.0, seed=51)])
    b = np.stack([audio(3.0, seed=52), audio(3.0, seed=53)])
    ha = eng.transcribe_audio_async(a, GenerationOptions(**opts))
    hb = eng.transcribe_audio_async(torch.from_numpy(b),
                                    GenerationOptions(**opts))
    got_b, got_a = hb.result(), ha.result()
    assert not np.array_equal(got_a.align, got_b.align)
    for got, x in ((got_a, a), (got_b, b)):
        # The same engine on the same shapes: bit for bit.
        sync = eng.transcribe_audio(x, GenerationOptions(**opts))
        for name in ("tokens", "sum_logprob", "token_logprobs", "align"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(sync, name))
        _assert_result(got, jax_eng.transcribe_audio_async(
            x, JaxOptions(**opts)).result(), 2)
    mel = LogMelFeaturizer(n_mels=ARCH.n_mels, chunk_length_s=3,
                           device="cpu")(a)
    got = eng.transcribe_features_async(mel, GenerationOptions(**opts)).result()
    _assert_result(got, got_a, 2)
    assert eng._live() == []


def test_speculative_engine_handles(engines):
    """A speculative engine's handles decode eagerly and unpadded, as its
    synchronous calls do; the scan groups refuse it, as JAX's do."""
    _, eng = engines
    spec = WhisperEngine(eng.model, special=SPECIAL, suppress_tokens=SUPPRESS,
                         batch_buckets=BUCKETS, spec_ngram=True)
    opts = GenerationOptions(max_new_tokens=6, language="en")
    f = _file()
    got = spec.transcribe_windows_async(f, [0, 32000, 64000], WIN, BUCKET,
                                        opts).result()
    want = eng.transcribe_windows_async(f, [0, 32000, 64000], WIN, BUCKET,
                                        opts).result()
    assert got.spec_rounds > 0 and got.tokens.shape[0] == 3
    np.testing.assert_array_equal(got.tokens, want.tokens)
    with pytest.raises(ValueError, match="speculative"):
        spec.transcribe_window_scan_async(f, [0], 2, WIN, BUCKET, opts)
    with pytest.raises(ValueError, match="speculative"):
        spec.transcribe_batch_scan_async(f, [0, 0], 1, 2, WIN, BUCKET, opts)


def test_offset_entry_points_refuse_what_jax_refuses(engines):
    _, eng = engines
    f = _file()
    beams = GenerationOptions(max_new_tokens=4, num_beams=2)
    hot = GenerationOptions(max_new_tokens=4, temperature=0.5)
    greedy = GenerationOptions(max_new_tokens=4)
    calls = {
        "transcribe_window_async": (0,),
        "transcribe_windows_async": ([0, 16000],),
        "transcribe_window_scan_async": ([0], 2),
        "transcribe_batch_scan_async": ([0, 16000], 1, 2),
    }
    for entry, args in calls.items():
        for opts in (beams, hot):
            with pytest.raises(ValueError, match="greedy-only"):
                getattr(eng, entry)(f, *args, WIN, BUCKET, opts)
    with pytest.raises(ValueError, match="scan program"):
        eng.transcribe_window_scan_async(f, [0, 1, 2], 2, WIN, BUCKET, greedy)
    with pytest.raises(ValueError, match="scan program"):
        eng.transcribe_window_scan_async(f, [], 2, WIN, BUCKET, greedy)
    with pytest.raises(ValueError, match="groups must be full"):
        eng.transcribe_batch_scan_async(f, [0, 1, 2], 2, 2, WIN, BUCKET,
                                        greedy)
    with pytest.raises(ValueError, match="read past"):
        eng.transcribe_window_async(f, N_FILE - WIN + 1, WIN, BUCKET, greedy)
    # A tensor on another device never falls back to the engine's.
    with pytest.raises(ValueError, match="the engine on cpu"):
        to_device(torch.empty(4, device="meta"), "cpu")
    assert eng._live() == []


def _recording(eng, monkeypatch, refs, fail_at=None):
    """Wrap the engine's offset entry points: keep a weak reference to
    every handle, and raise at the ``fail_at``-th batched dispatch."""
    calls = {"n": 0}
    for name in ("transcribe_window_async", "transcribe_windows_async"):
        real = getattr(eng, name)

        def wrapped(*a, _real=real, _name=name, **k):
            if _name == "transcribe_windows_async":
                calls["n"] += 1
                if calls["n"] == fail_at:
                    raise RuntimeError("dispatch failed")
            h = _real(*a, **k)
            refs.append(weakref.ref(h))
            return h

        monkeypatch.setattr(eng, name, wrapped)


@pytest.mark.parametrize("fault", ["callback", "dispatch"])
def test_a_failed_call_releases_its_handles(engines, monkeypatch, fault):
    """A raising ``on_first_result`` or a raising group dispatch reaches
    the caller; no handle of the failed call stays referenced or pending on
    the engine, and the next call gives JAX's output."""
    jax_pipe, pipe = _pipes(engines)
    monkeypatch.setattr(pl, "PIPELINE_DEPTH", 2)
    monkeypatch.setattr(jax_pl, "PIPELINE_DEPTH", 2)
    pipe.first_window_fast = True
    refs = []
    _recording(pipe.engine, monkeypatch, refs,
               fail_at=2 if fault == "dispatch" else None)
    if fault == "callback":
        def boom(text):
            raise RuntimeError("callback failed")

        pipe.on_first_result = boom
    a = audio(13.1, seed=31)
    kw = dict(return_timestamps="word", chunk_length_s=2.0, batch_size=3)
    try:
        pipe(a, generate_kwargs=dict(KW), **kw)
    except RuntimeError as e:
        caught = str(e)
        # The traceback still holds the call's frames: every handle was
        # consumed or released all the same.
        assert pipe.engine._live() == []
    else:
        caught = None
    assert caught == ("callback failed" if fault == "callback"
                      else "dispatch failed")
    gc.collect()
    assert refs and all(r() is None for r in refs)
    assert pipe.engine._live() == []
    pipe.on_first_result = None
    jax_pipe.first_window_fast = True
    assert (pipe(a, generate_kwargs=dict(KW), **kw)
            == jax_pipe(a, generate_kwargs=dict(KW), **kw))
