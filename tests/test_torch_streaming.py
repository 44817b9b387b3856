"""The port's streaming slice (``thewhisper_tpu_torch.streaming``) against
the JAX package's: the state machine under scripted fake backends and VADs,
the VAD's probabilities, the ring buffer, the streams, and the whole stack
over the tiny checkpoint with the neural VAD on.

Inputs come from ``np.random.default_rng`` and go to both packages as
numpy arrays; every comparison is exact unless a tolerance is stated.
"""

import io
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import thewhisper_tpu.streaming as jax_streaming
import thewhisper_tpu_torch.streaming as streaming
from thewhisper_tpu.native_lib import RingBuffer as JaxRingBuffer
from thewhisper_tpu.streaming import pipeline as jax_pipeline_mod
from thewhisper_tpu.streaming import vad as jax_vad
from thewhisper_tpu_torch.streaming import pipeline as pipeline_mod
from thewhisper_tpu_torch.streaming import vad
from thewhisper_tpu_torch.streaming.ring import RingBuffer

from _torch_tiny import one_cpu_thread  # noqa: F401

PACKAGES = {"jax": (jax_streaming, jax_pipeline_mod),
            "torch": (streaming, pipeline_mod)}
SR = 16000


class FakeBackend:
    """One word per 0.5 s of buffered audio, every fourth ending a sentence
    and every fourth a phrase, with a 0.3 s pause before each sixth word."""

    def __init__(self):
        self.calls = []

    def transcribe(self, audio, buffer_start_time, sample_rate):
        self.calls.append((len(audio), buffer_start_time))
        words = []
        for i in range(int(len(audio) / sample_rate / 0.5)):
            text = f" word{i}" + {1: ",", 3: "."}.get(i % 4, "")
            start = buffer_start_time + 0.5 * i + (0.3 if i % 6 == 5 else 0.0)
            words.append({"text": text, "start": start,
                          "end": buffer_start_time + 0.5 * (i + 1)})
        return words


class EnergyGateVAD:
    """Speech iff window RMS > 0.01 (the amplitude drives the VAD)."""

    def __call__(self, chunk, sr=16000):
        return 1.0 if float(np.sqrt(np.mean(chunk ** 2))) > 0.01 else 0.0

    def reset_states(self):
        pass


def _chunks(rng, spec):
    """[(seconds, amplitude, count), ...] -> Gaussian chunks."""
    return [(amp * rng.standard_normal(int(sec * SR))).astype(np.float32)
            for sec, amp, n in spec for _ in range(n)]


def _feed(sp, chunks):
    return [sp(c) for c in chunks]


def _state(sp, backend):
    return {"calls": backend.calls, "start": sp.buffer_start_time,
            "now": sp.current_time, "buffered": len(sp._buffer),
            "history": sp.history, "processed": sp.stats["chunks_processed"]}


def _run_stream(pkg, rng, spec, **kw):
    be = FakeBackend()
    sp = pkg[0].StreamingPipeline(backend=be, **kw)
    return _feed(sp, _chunks(rng, spec)), _state(sp, be)


def _gate(pkg, rng):
    return _run_stream(pkg, rng, [(0.05, 0.1, 60)], chunk_length_s=10,
                       use_vad=False)


def _overflow(pkg, rng):
    return _run_stream(pkg, rng, [(0.05, 0.1, 140)], chunk_length_s=4,
                       use_vad=False)


def _vad_blocks_silence(pkg, rng):
    return _run_stream(pkg, rng, [(0.05, 0.001, 60)], chunk_length_s=10,
                       vad=EnergyGateVAD())


def _vad_preroll(pkg, rng):
    return _run_stream(pkg, rng, [(0.2, 0.001, 4), (0.2, 0.2, 12)],
                       chunk_length_s=10, vad=EnergyGateVAD(),
                       vad_prepend_chunks=3)


def _speech_end_trim(pkg, rng):
    # 7 s of speech, then silence: speech ends with > 6 s buffered.
    return _run_stream(pkg, rng, [(0.1, 0.2, 70), (0.1, 0.001, 20),
                                  (0.1, 0.2, 30)],
                       chunk_length_s=10, vad=EnergyGateVAD())


def _postprocess(pkg, rng):
    sp = pkg[0].StreamingPipeline(backend=FakeBackend(), use_vad=False)

    def w(text, s=0.0, e=0.5):
        return {"text": text, "start": s, "end": e}

    cases = [[w(" Hello"), w(" ."), w(" world")], [w(" ."), w(" a")],
             [w("Hi"), w(" -yes")], [w(" gonNA"), w(" gotTA"), w(" wanNA")],
             [w(" The.")], [w(" The")], [w(" I.")], [w(" The."), w(" x")],
             [w(" Same"), w(" next")], [w(" same")]]
    out = [sp._postprocess(c) for c in cases]
    sp._last_committed_word = "same"
    return out + [sp._postprocess(c) for c in cases], None


def _truncation(pkg, rng):
    sp = pkg[0].StreamingPipeline(backend=FakeBackend(), use_vad=False)
    sp.current_time = 10.0

    def w(text, s, e):
        return {"text": text, "start": s, "end": e}

    lists = [[w(" a", 0, 1), w(" b.", 1, 2), w(" c", 2, 3), w(" d", 6, 9.5)],
             [w(" b.", 0, 1), w(" c", 5, 6), w(" d", 6, 7)],
             [w(" a", 0, 1), w(" b,", 1, 2), w(" c", 5, 9)],
             [w(" a", 0, 1), w(" b", 1, 2), w(" c", 5, 6)],
             [w(" a", 0.0, 1), w(" b", 1, 2)], [w(" a", 0.5, 1)], []]
    return [sp._truncation_time(ws, need) for ws in lists
            for need in (True, False)], None


def _clear(pkg, rng):
    be = FakeBackend()
    sp = pkg[0].StreamingPipeline(backend=be, chunk_length_s=4,
                                  vad=EnergyGateVAD())
    first = _feed(sp, _chunks(rng, [(0.05, 0.1, 70)]))
    sp.clear()
    cleared = (sp.current_audio_buffer, sp.buffer_start_time, sp.current_time,
               list(sp.history), sp._last_committed_word,
               sp.process_new_chunk())
    then = _feed(sp, _chunks(rng, [(0.05, 0.1, 50)]))
    return first + then, dict(_state(sp, be), cleared=cleared)


def _gibberish(pkg, rng):
    text = " the" * 24
    res = {"text": text, "chunks": [
        {"text": " a", "timestamp": (0.0, None)},
        {"text": " b", "timestamp": (0.2, 0.4)},
        {"text": " c", "timestamp": (1.5, None)}]}
    mod = pkg[1]
    return [mod.words_from_result(res, 2.0, 3.0),
            mod.words_from_result(dict(res, text=" a b c"), 2.0, 3.0),
            mod.words_from_result(dict(res, text=" a b c"), 1.8, 0.0),
            mod.compression_ratio(text), mod.compression_ratio(" a b c")], None


SCENARIOS = {"two_second_gate": _gate, "window_overflow": _overflow,
             "vad_blocks_silence": _vad_blocks_silence,
             "vad_preroll": _vad_preroll, "speech_end_trim": _speech_end_trim,
             "postprocess": _postprocess, "truncation_policy": _truncation,
             "clear": _clear, "gibberish": _gibberish}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_state_machine_matches_jax(scenario):
    """Scripted backends and VADs: the same (committed, assumption) every
    tick, the same backend calls and the same end state."""
    run = SCENARIOS[scenario]
    ours = run(PACKAGES["torch"], np.random.default_rng(7))
    ref = run(PACKAGES["jax"], np.random.default_rng(7))
    assert repr(ours) == repr(ref)
    if scenario == "two_second_gate":
        ticks, state = ours
        first = next(i for i, t in enumerate(ticks) if t[1])
        assert first == 39 and state["calls"][0][0] == 2 * SR
    if scenario in ("window_overflow", "speech_end_trim", "clear"):
        assert any(c for c, _ in ours[0])
    if scenario == "clear":
        assert ours[1]["cleared"] == (None, 0.0, 0.0, [], None, ([], []))
    if scenario == "vad_blocks_silence":
        assert ours[1]["calls"] == []


def test_vad_probabilities_match_jax():
    """NeuralVAD and EnergyVAD on the same 512-sample windows, state carried
    across them and reset between two passes: JAX's probabilities to 1e-6;
    the port's weights file is JAX's, byte for byte."""
    with open(vad._WEIGHTS_FILE, "rb") as a, open(jax_vad._WEIGHTS_FILE, "rb") as b:
        assert a.read() == b.read()
    assert os.path.dirname(vad._WEIGHTS_FILE) != os.path.dirname(
        jax_vad._WEIGHTS_FILE)
    rng = np.random.default_rng(11)
    amps = np.repeat(rng.choice([0.0005, 0.05, 0.3], size=12), 8)
    windows = (amps[:, None] * rng.standard_normal((len(amps), 512))
               ).astype(np.float32)
    windows[::5] = np.sin(np.arange(512) * 0.07 * (1 + rng.random()))
    for ours, ref in ((vad.NeuralVAD(), jax_vad.NeuralVAD()),
                      (vad.EnergyVAD(), jax_vad.EnergyVAD())):
        for _ in range(2):
            got = [ours(w, SR) for w in windows]
            want = [ref(w, SR) for w in windows]
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            ours.reset_states()
            ref.reset_states()
        assert 0.0 <= min(got) and max(got) <= 1.0
    np.testing.assert_allclose(vad.vad_features(windows[1]),
                               jax_vad.vad_features(windows[1]), atol=1e-6)


def test_make_vad_auto_gives_neural_vad(monkeypatch):
    monkeypatch.delenv("SILERO_VAD_JIT", raising=False)
    assert type(vad.make_vad("auto")).__name__ == "NeuralVAD"
    assert type(jax_vad.make_vad("auto")).__name__ == "NeuralVAD"
    assert isinstance(vad.make_vad("energy"), vad.EnergyVAD)
    with pytest.raises(FileNotFoundError):
        vad.make_vad("silero")


_OPS = st.lists(st.one_of(
    st.tuples(st.just("write"), st.integers(0, 700)),
    st.tuples(st.just("peek"), st.one_of(st.none(), st.integers(0, 900)),
              st.integers(0, 900)),
    st.tuples(st.just("discard"), st.integers(0, 900)),
    st.tuples(st.just("clear"))), max_size=40)


@settings(max_examples=150, deadline=None)
@given(ops=_OPS, capacity=st.sampled_from([1, 7, 256, 1 << 18]),
       seed=st.integers(0, 2 ** 16))
def test_ring_buffer_matches_jax(ops, capacity, seed):
    """Any sequence of write, peek, discard and clear: JAX's ``RingBuffer``'s
    lengths and peeks, through wrap-around and growth."""
    rng = np.random.default_rng(seed)
    ours, ref = RingBuffer(capacity), JaxRingBuffer(capacity)
    for op in ops:
        if op[0] == "write":
            x = rng.standard_normal(op[1]).astype(np.float32)
            ours.write(x)
            ref.write(x)
        elif op[0] == "peek":
            np.testing.assert_array_equal(ours.peek(op[1], op[2]),
                                          ref.peek(op[1], op[2]))
        elif op[0] == "discard":
            ours.discard(op[1])
            ref.discard(op[1])
        else:
            ours.clear()
            ref.clear()
        assert len(ours) == len(ref)
    np.testing.assert_array_equal(ours.peek(), ref.peek())


def test_ring_buffer_appends_in_place():
    """A write that fits copies only its own samples: 0.05 s chunks never
    reallocate or rebuild the buffer."""
    ring = RingBuffer(1 << 18)
    buf = ring._buf
    chunks = [np.full(800, i, np.float32) for i in range(200)]
    for c in chunks:
        ring.write(c)
        ring.discard(400)
    assert ring._buf is buf and len(ring) == 200 * 400
    np.testing.assert_array_equal(ring.peek(800, len(ring) - 800), chunks[-1])


def _stream_outputs(pkg, tmp_path):
    mod = pkg[0]
    rng = np.random.default_rng(5)
    audio = rng.uniform(-1, 1, 20000).astype(np.float32)
    arr = mod.ArrayStream(audio, step_size_s=0.3, real_time=False)
    chunks = []
    while (c := arr.next_chunk()) is not None:
        chunks.append(c)
    chunks.append(arr.next_chunk())
    path = tmp_path / "s.wav"
    if not path.exists():
        from thewhisper_tpu_torch.audio.io import wav_bytes

        path.write_bytes(wav_bytes(audio[:12345], 8000))
    fst = mod.FileStream(str(path), step_size_s=0.25, real_time=False)
    while (c := fst.next_chunk()) is not None:
        chunks.append(c)
    buf = io.StringIO()
    out = mod.StdoutStream(file=buf)
    for committed, assumption in (([" hello"], [" wax"]), ([], [" world"]),
                                  ([], []), ([" world"], [" \x1b[33mtail"]),
                                  (["\x1b[32m 漢字\x1b[0m"], [" x"])):
        out.write([{"text": t} for t in committed],
                  [{"text": t} for t in assumption])
    out.close()
    return chunks, buf.getvalue()


def test_streams_match_jax(tmp_path):
    """ArrayStream (not real time), FileStream (an 8 kHz WAV resampled to
    16 kHz) and StdoutStream's terminal bytes equal JAX's."""
    chunks, text = _stream_outputs(PACKAGES["torch"], tmp_path)
    ref_chunks, ref_text = _stream_outputs(PACKAGES["jax"], tmp_path)
    assert text == ref_text and "\b" in text
    assert len(chunks) == len(ref_chunks)
    for a, b in zip(chunks, ref_chunks):
        if b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    import sys

    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    sys.path.insert(0, "tools")
    from make_tiny_checkpoint import make_checkpoint

    return make_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny"), seed=3)


def _speech_and_silence(seconds: int, seed: int) -> np.ndarray:
    """5 s blocks of formant speech alternating with near-silence: input the
    neural VAD gates."""
    from thewhisper_tpu.streaming.vad_corpus import synth_speech

    rng = np.random.default_rng(seed)
    blocks = []
    for i in range(seconds // 5):
        if i % 2 == 0:
            a, _ = synth_speech(rng, 5.0, SR)
            a = 0.5 * a / (np.abs(a).max() + 1e-9) + 0.002 * rng.standard_normal(len(a))
        else:
            a = 0.0005 * rng.standard_normal(5 * SR)
        blocks.append(a.astype(np.float32))
    return np.concatenate(blocks)


# Three tokens a tick: the random model repeats one word, and more tokens
# would make every tick's text trip the gibberish gate (then both packages
# agree on nothing but empty ticks).
E2E_TOKENS = 3


@pytest.mark.parametrize("reuse", [False, True])
def test_stream_over_tiny_checkpoint_matches_jax(tiny_ckpt, reuse):
    """20 s in 0.05 s chunks through the neural VAD, the state machine and
    ``LocalWhisperBackend`` over the tiny f32 checkpoint: every tick's
    committed and assumption words equal JAX's in text, their timestamps
    to 1e-6; with cross-tick reuse the later ticks decode speculatively."""
    import jax.numpy as jnp

    from thewhisper_tpu.pipeline import ASRPipeline as JaxPipeline
    from thewhisper_tpu_torch.pipeline import ASRPipeline

    audio = _speech_and_silence(20, seed=0)
    runs = {}
    for name, pkg in PACKAGES.items():
        if name == "jax":
            asr = JaxPipeline(tiny_ckpt, chunk_length_s=10,
                              compute_dtype=jnp.float32,
                              reuse_previous_tokens=reuse)
        else:
            asr = ASRPipeline(tiny_ckpt, chunk_length_s=10,
                              compute_dtype=torch.float32, device="cpu",
                              reuse_previous_tokens=reuse)
        backend = pkg[1].LocalWhisperBackend(
            asr, chunk_length_s=10, max_new_tokens=E2E_TOKENS)
        sp = pkg[0].StreamingPipeline(backend=backend, chunk_length_s=10)
        assert type(sp.vad_model).__name__ == "NeuralVAD"
        runs[name] = (_feed(sp, [audio[i: i + 800]
                                 for i in range(0, len(audio), 800)]), sp)
    (ticks, sp), (ref_ticks, ref_sp) = runs["torch"], runs["jax"]
    assert len(ticks) == len(ref_ticks)
    for tick, ref_tick in zip(ticks, ref_ticks):
        for words, ref_words in zip(tick, ref_tick):
            assert [w["text"] for w in words] == [w["text"] for w in ref_words]
            for w, r in zip(words, ref_words):
                assert abs(w["start"] - r["start"]) <= 1e-6
                assert abs(w["end"] - r["end"]) <= 1e-6
    assert sp.stats["chunks_processed"] == ref_sp.stats["chunks_processed"]
    assert 0 < sp.stats["chunks_processed"] < len(ticks)
    assert sum(len(c) for c, _ in ticks) > 0
    assert sp.buffer_start_time == ref_sp.buffer_start_time > 0
    assert len(sp._buffer) <= sp.window_size * SR


def test_local_backend_defaults_match_jax(tiny_ckpt, monkeypatch):
    """Given a checkpoint path, both local backends build their package's
    ASRPipeline with the same arguments: the "S" model, 10 s windows and
    cross-tick reuse on. The port's builds on the CPU when asked; an
    ASRPipeline passed in is used as is."""
    import thewhisper_tpu.pipeline as jax_pipeline
    from thewhisper_tpu_torch.models.quant import Int8Linear
    from thewhisper_tpu_torch.pipeline import ASRPipeline

    seen = []

    class Recorder:
        def __init__(self, *args, **kwargs):
            seen.append((args, kwargs))

    monkeypatch.setattr(jax_pipeline, "ASRPipeline", Recorder)
    ref = jax_pipeline_mod.LocalWhisperBackend(tiny_ckpt)
    ours = pipeline_mod.LocalWhisperBackend(tiny_ckpt, device="cpu")
    assert seen == [((tiny_ckpt,), {
        "model_size": "S", "chunk_length_s": 10, "language": "en",
        "reuse_previous_tokens": True})]
    for attr in ("chunk_length_s", "language", "max_new_tokens"):
        assert getattr(ours, attr) == getattr(ref, attr)
    asr = ours.asr_pipeline
    assert asr._reuse_previous and asr.engine.cross_kv_int8
    assert asr.model_chunk_length_s == 10 and asr.engine.device.type == "cpu"
    assert any(isinstance(m, Int8Linear) for m in asr.engine.model.modules())
    plain = ASRPipeline(asr.engine, chunk_length_s=10)
    assert pipeline_mod.LocalWhisperBackend(plain).asr_pipeline is plain
    assert not plain._reuse_previous


def test_run_streaming_cli_on_cpu(tiny_ckpt, tmp_path, capsys):
    """``python -m thewhisper_tpu_torch.run_streaming --cpu --no-realtime``
    over a WAV runs the "S" model from the checkpoint through the neural
    VAD to the end of the file, inside the ANSI renderer's frame (cursor
    hidden, then shown)."""
    from thewhisper_tpu_torch import run_streaming
    from thewhisper_tpu_torch.audio.io import wav_bytes

    path = tmp_path / "speech.wav"
    path.write_bytes(wav_bytes(_speech_and_silence(10, seed=4)))
    run_streaming.main(["--model", tiny_ckpt, "--file", str(path),
                        "--no-realtime", "--cpu"])
    out = capsys.readouterr().out
    assert out.startswith("\x1b[?25l") and out.endswith("\n\x1b[?25h")
