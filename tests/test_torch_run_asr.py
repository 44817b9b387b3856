"""``python -m thewhisper_tpu_torch.run_asr`` against the JAX package's
``examples/run_asr.py`` on the tiny checkpoint at f32 on the CPU: the same
text, the same word chunks as JSON and the same SRT file, byte for byte;
without ``--cpu`` on a machine with no card it raises. And the sharded
checkpoint layout (``shard_safetensors``: two shards and HF's index) loads
equal to the single file."""

import contextlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from thewhisper_tpu_torch import run_asr
from thewhisper_tpu_torch.audio.io import save_wav
from thewhisper_tpu_torch.models.checkpoint import shard_safetensors
from thewhisper_tpu_torch.models.load import load_checkpoint

from _torch_tiny import one_cpu_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    from make_tiny_checkpoint import make_checkpoint

    return make_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny"), seed=0)


def _printed(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def _parts(out: str, srt: str):
    """(text, chunks, subtitle note) of a CLI's output; the seconds after."""
    body, seconds = out.rsplit("\n[transcribed in ", 1)
    assert seconds.strip().endswith("s]")
    text, rest = body.split("\n\n", 1)
    chunks, note = rest.rsplit("\n\n", 1)
    assert note.strip() == f"[subtitles written to {srt}]"
    return text, json.loads(chunks)


def test_run_asr_on_the_cpu_equals_the_jax_example(tiny_ckpt, tmp_path, monkeypatch):
    """A 12 s seeded WAV, 10 s model windows (9 s call windows, two of
    them), 12 new tokens, word timestamps."""
    rng = np.random.default_rng(0)
    wav = tmp_path / "a.wav"
    save_wav(str(wav), (0.1 * rng.standard_normal(12 * 16000)).astype(np.float32))
    args = [str(wav), "--model", tiny_ckpt, "--cpu", "--model-size", "XL32",
            "--chunk-length", "10", "--max-new-tokens", "12"]
    ours_srt, jax_srt = str(tmp_path / "port.srt"), str(tmp_path / "jax.srt")
    result = {}
    ours = _printed(lambda: result.update(run_asr.main(args + ["--srt", ours_srt])))

    monkeypatch.syspath_prepend(os.path.join(REPO, "examples"))
    monkeypatch.setattr(sys, "argv", ["run_asr.py", *args, "--srt", jax_srt])
    import run_asr as jax_run_asr

    theirs = _printed(jax_run_asr.main)
    text, chunks = _parts(ours, ours_srt)
    assert (text, chunks) == _parts(theirs, jax_srt)
    assert text == result["text"] and text.strip() and len(chunks) > 1
    with open(ours_srt, "rb") as a, open(jax_srt, "rb") as b:
        srt = a.read()
        assert srt == b.read()
    assert srt.startswith(b"1\n00:00:")


def test_run_asr_without_a_card_raises(tiny_ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    wav = tmp_path / "a.wav"
    save_wav(str(wav), np.zeros(16000, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_asr.main([str(wav), "--model", tiny_ckpt])


def test_two_shards_and_an_index_load_equal_to_the_single_file(tiny_ckpt, tmp_path):
    sharded = str(tmp_path / "sharded")
    shutil.copytree(tiny_ckpt, sharded)
    files = shard_safetensors(sharded, 2)
    with open(os.path.join(sharded, "model.safetensors.index.json")) as f:
        index = json.load(f)
    assert sorted(set(index["weight_map"].values())) == files == [
        "model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"]
    assert not os.path.exists(os.path.join(sharded, "model.safetensors"))
    single = os.path.join(tiny_ckpt, "model.safetensors")
    with open(single, "rb") as f:
        header = 8 + int.from_bytes(f.read(8), "little")
    assert index["metadata"]["total_size"] == os.path.getsize(single) - header
    one, arch = load_checkpoint(tiny_ckpt, device="cpu")
    two, arch2 = load_checkpoint(sharded, device="cpu")
    assert arch == arch2
    want, got = one.state_dict(), two.state_dict()
    assert want.keys() == got.keys()
    for name in want:
        assert torch.equal(want[name], got[name]), name
