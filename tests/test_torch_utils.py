"""The port's host utilities against the JAX package's, which they copy:
``utils/wer.py`` (WER, CER, word alignment), ``utils/normalizers.py``,
``utils/subtitles.py``, ``audio/io.py``'s ffmpeg route and ``save_wav``,
and ``config.py``'s two helpers. Every comparison is exact."""

import dataclasses
import importlib
import subprocess

import numpy as np
import pytest

from thewhisper_tpu import config as jax_config
from thewhisper_tpu.audio import io as jax_io
from thewhisper_tpu.utils import normalizers as jax_norm
from thewhisper_tpu.utils import subtitles as jax_subs
from thewhisper_tpu_torch import config
from thewhisper_tpu_torch.audio import io as pio
from thewhisper_tpu_torch.utils import normalizers, subtitles

from _torch_tiny import one_cpu_thread  # noqa: F401

# The modules (each package's ``utils`` exports a function named ``wer``).
wer = importlib.import_module("thewhisper_tpu_torch.utils.wer")
jax_wer = importlib.import_module("thewhisper_tpu.utils.wer")


def _texts(seed: int, n: int = 6):
    rng = np.random.default_rng(seed)
    words = ["the", "cat", "sat", "on", "a", "mat", "hello", "world", "déjà", "vu"]
    return [" ".join(rng.choice(words, int(rng.integers(0, 12)))) for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_wer_cer_and_word_alignment_equal_jax(seed):
    refs, hyps = _texts(seed), _texts(seed + 100)
    assert wer.wer(refs, hyps) == jax_wer.wer(refs, hyps)
    assert wer.cer(refs, hyps) == jax_wer.cer(refs, hyps)
    for ref, hyp in zip(refs, hyps):
        r, h = ref.split(), hyp.split()
        assert wer.align_words(r, h) == jax_wer.align_words(r, h)
        assert wer.edit_stats(list(ref), list(hyp)) == jax_wer.edit_stats(list(ref), list(hyp))
    from thewhisper_tpu_torch import utils

    assert utils.wer is wer.wer and utils.edit_stats is wer.edit_stats


# The inputs of tests/test_eval.py's normalizer tests.
NORMALIZER_INPUTS = [
    "Hello, World!", "this [NOISE] is (um) fine", "  a   b  ",
    "I won't do it.", "It's Mr. Smith's colour TV", "twenty two dogs",
    "one hundred and five", "three thousand two hundred", "the first time",
    "Uh, hello um world", "100% of $5", "twenty-two dogs", "a hundred people",
    "a thousand and one nights", "the twenty-first century",
    "his thirty third birthday", "one hundredth of a second",
    "minus five degrees", "three point five million dollars", "point is moot",
    "two point oh", "fifty thousand", "seven hundred and eighty-nine",
    "nineteen eighty four", "twenty twenty", "nineteen oh five",
    "double oh seven", "two dollars", "$2.50", "two dollars and fifty cents",
    "two dollars and five cents", "fifty cents", "$0.50", "five pounds", "£3",
    "3%", "three per cent", "1 of them", "one of them",
    "I'm gonna go, you wanna come?", "she'd been there", "he's got it",
    "Dr. Brown and Mrs. Jones", "y'all shoulda seen it", "it's fine",
    "colourful neighbourhood", "organisations prioritised",
    "paralysed by analysing", "the theatre's centre",
    "travelling jewellers quarrelled", "defenceless offences",
    "paediatrician manoeuvred", "kilometres of grey tyres",
    "fulfilment of enrolment", "he practised his programme",
    "catalogues and dialogues", "surprise", "advise", "compromise", "exercise",
    "promise", "televise", "franchise", "disguise",
    "three point one four", "twenty two point five percent",
    "the point is clear", "one point five", "minus point five",
    "minus one point five", "point two hundred", "one point five million",
    "zero point twelve five hundred", "one and a half million",
    "five and a half percent", "one second", "twenty first",
    "five point third", "two sixes", "the twenties", "seven cents",
    "1.5 million", "3 dollars and 7 cents", "zero million zero second three",
    "a hundred and five", "Ça, c'est «très» bien — n'est-ce pas?",
]


@pytest.mark.parametrize("name", ["EnglishTextNormalizer", "BasicTextNormalizer"])
def test_normalizers_equal_jax(name):
    ours, theirs = getattr(normalizers, name)(), getattr(jax_norm, name)()
    for text in NORMALIZER_INPUTS:
        assert ours(text) == theirs(text), text


def _chunks(seed: int):
    """Word chunks as the pipeline gives them: pauses, long runs, an open
    last end and a chunk without a timestamp."""
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for i in range(40):
        t += float(rng.choice([0.05, 0.3, 1.2]))
        end = t + float(rng.uniform(0.1, 0.6))
        out.append({"text": f" word{int(rng.integers(0, 1000))}", "timestamp": (t, end)})
        t = end
    out[-1] = {"text": " last", "timestamp": (t, None)}
    out.insert(5, {"text": " none", "timestamp": None})
    return out


@pytest.mark.parametrize("kw", [{}, {"max_chars": 20}, {"max_duration_s": 2.0,
                                                       "max_pause_s": 0.25}])
def test_subtitles_equal_jax(kw, tmp_path):
    for seed in range(3):
        chunks = _chunks(seed)
        assert subtitles.group_cues(chunks, **kw) == jax_subs.group_cues(chunks, **kw)
        assert subtitles.to_srt(chunks, **kw) == jax_subs.to_srt(chunks, **kw)
        assert subtitles.to_vtt(chunks, **kw) == jax_subs.to_vtt(chunks, **kw)
    for ext in ("srt", "vtt"):
        ours, theirs = tmp_path / f"a.{ext}", tmp_path / f"b.{ext}"
        subtitles.write_subtitles(str(ours), chunks, **kw)
        jax_subs.write_subtitles(str(theirs), chunks, **kw)
        assert ours.read_bytes() == theirs.read_bytes()
    with pytest.raises(ValueError, match="srt or .vtt"):
        subtitles.write_subtitles(str(tmp_path / "a.txt"), chunks)


def test_load_audio_takes_jax_ffmpeg_route(tmp_path, monkeypatch):
    """tests/test_audio.py's stub: non-WAV bytes go to the ffmpeg pipe, with
    JAX's command; no binary gives JAX's ValueError; a failed decode JAX's
    message; WAV never reaches ffmpeg."""
    mp3ish = b"ID3\x04\x00" + b"\x00" * 64
    monkeypatch.setattr("shutil.which", lambda _: None)
    errors = []
    for mod in (pio, jax_io):
        with pytest.raises(ValueError, match="ffmpeg") as err:
            mod.load_audio(mp3ish)
        errors.append(str(err.value))
    assert errors[0] == errors[1]

    want = (0.25 * np.sin(np.linspace(0, 20, 1600))).astype("<f4")
    calls = []

    def fake_run(cmd, input=None, stdout=None, stderr=None, check=False):
        assert input == mp3ish
        calls.append(cmd)

        class R:
            returncode = 0 if len(calls) <= 2 else 1
            stdout = want.tobytes() if len(calls) <= 2 else b""
            stderr = b"" if len(calls) <= 2 else b"Invalid data found"
        return R()

    monkeypatch.setattr("shutil.which", lambda _: "/fake/ffmpeg")
    monkeypatch.setattr(subprocess, "run", fake_run)
    outs = [mod.load_audio(mp3ish, sr=22050) for mod in (pio, jax_io)]
    assert calls[0] == calls[1] and calls[0][0] == "/fake/ffmpeg" and "22050" in calls[0]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], want)
    for mod in (pio, jax_io):
        with pytest.raises(ValueError) as err:
            mod.load_audio(mp3ish)
        errors.append(str(err.value))
    assert errors[2] == errors[3] == "ffmpeg decode failed: Invalid data found"

    path = tmp_path / "a.wav"
    pio.save_wav(str(path), want[:160])
    assert len(pio.load_audio(str(path))) == 160 and len(calls) == 4


@pytest.mark.parametrize("sr", [16000, 44100])
def test_save_wav_writes_jax_bytes(tmp_path, sr):
    x = np.random.default_rng(sr).uniform(-1.2, 1.2, 3001).astype(np.float32)
    ours, theirs = tmp_path / "a.wav", tmp_path / "b.wav"
    pio.save_wav(str(ours), x, sr)
    jax_io.save_wav(str(theirs), x, sr)
    assert ours.read_bytes() == theirs.read_bytes() == pio.wav_bytes(x, sr)
    np.testing.assert_array_equal(pio.load_audio(str(ours), sr),
                                  jax_io.load_audio(str(theirs), sr))


def test_config_helpers_equal_jax():
    for seconds in (0, 0.5, 1, 9, 10, 15, 29.99, 30, 600):
        assert config.mel_frames_for_seconds(seconds) == jax_config.mel_frames_for_seconds(
            seconds)
    arch = config.ARCH_PRESETS["large-v3-turbo"].with_source_positions(500)
    want = jax_config.ARCH_PRESETS["large-v3-turbo"].with_source_positions(500)
    assert isinstance(arch, config.WhisperArch)
    assert dataclasses.asdict(arch) == dataclasses.asdict(want)
    assert arch.max_source_positions == 500 and arch.d_model == 1280
