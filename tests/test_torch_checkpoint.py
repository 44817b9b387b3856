"""The port's checkpoint writing and its training entry points, on the CPU.

``save_hf_checkpoint`` (written with the stdlib safetensors writer) round
trips through the port's ``load_checkpoint`` bit for bit and loads in
JAX's; the stdlib reader equals the ``safetensors`` package on
``tools/make_tiny_checkpoint.py``'s output; a saved train state resumes to
the same next step; ``run_finetune`` and ``run_distill`` run with
``--cpu`` on the tiny checkpoint and a two-line manifest.
"""

import json
import sys
import wave

import numpy as np
import pytest
import torch

from _torch_tiny import ARCH, audio
from _torch_tiny import one_cpu_thread  # noqa: F401
from thewhisper_tpu_torch.models import checkpoint as ck
from thewhisper_tpu_torch.models import whisper as tw
from thewhisper_tpu_torch.models.load import (
    jax_tree_from_model,
    load_checkpoint,
    read_safetensors,
)
from thewhisper_tpu_torch.training import train

sys.path.insert(0, "tools")


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    from make_tiny_checkpoint import make_checkpoint

    return make_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny"), seed=0)


def _model(seed=11):
    return tw.init_params(ARCH, torch.Generator().manual_seed(seed), bias_std=0.1)


@pytest.mark.parametrize("chunk_length_s", [None, 3.0])
def test_save_hf_checkpoint_round_trips_bit_for_bit(tmp_path, chunk_length_s):
    """With ``chunk_length_s`` the export is marked flexible, so the reload
    truncates positions (to the same 150 rows) instead of interpolating."""
    model = _model()
    path = ck.save_hf_checkpoint(model, ARCH, str(tmp_path / "ckpt"),
                                 chunk_length_s=chunk_length_s)
    with open(tmp_path / "ckpt" / "generation_config.json") as f:
        gen = json.load(f)
    assert ("chunk_length" in gen) == (chunk_length_s is not None)
    loaded, arch = load_checkpoint(path, device="cpu",
                                   chunk_length_s=chunk_length_s or 30.0)
    assert arch.alignment_heads == ARCH.alignment_heads
    sd, ref = loaded.state_dict(), model.state_dict()
    assert sd.keys() == ref.keys()
    for name in sd:
        assert torch.equal(sd[name], ref[name]), name


def test_stdlib_reader_equals_the_safetensors_package(tiny_ckpt, tmp_path):
    from safetensors.torch import load_file

    path = f"{tiny_ckpt}/model.safetensors"
    ref, got = load_file(path), read_safetensors(path)
    assert got.keys() == ref.keys()
    for name in ref:
        assert got[name].dtype == ref[name].dtype, name
        assert torch.equal(got[name], ref[name]), name
    # And the writer's output, every dtype it writes, through both.
    arrays = {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
              "f16": np.array([1.5, -2.0], np.float16),
              "i8": np.array([[-3, 4]], np.int8), "i64": np.array([7], np.int64),
              "empty": np.zeros((0, 4), np.float32)}
    ck.write_safetensors(arrays, str(tmp_path / "w.safetensors"))
    ref = load_file(str(tmp_path / "w.safetensors"))
    got = read_safetensors(str(tmp_path / "w.safetensors"))
    for name, arr in arrays.items():
        assert torch.equal(got[name], ref[name]), name
        assert np.array_equal(got[name].numpy(), arr), name
    # bf16, which numpy (and so the writer) has no type for.
    from safetensors.torch import save_file

    x = torch.tensor([[1.5, -2.0, 3.0e-3]], dtype=torch.bfloat16)
    save_file({"bf16": x}, str(tmp_path / "b.safetensors"))
    assert torch.equal(read_safetensors(str(tmp_path / "b.safetensors"))["bf16"], x)


def test_written_checkpoint_loads_in_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from thewhisper_tpu.models.load import load_checkpoint as jax_load

    model = _model(12)
    path = ck.save_hf_checkpoint(model, ARCH, str(tmp_path / "ckpt"))
    tree, jarch = jax_load(path, dtype=jnp.float32)
    assert jarch.d_model == ARCH.d_model and jarch.alignment_heads == ARCH.alignment_heads
    want = jax.tree_util.tree_flatten_with_path(jax_tree_from_model(model))[0]
    got = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, tree))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path_))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return train.place_batch({
        "mel": rng.standard_normal((2, ARCH.n_mels, 300)).astype(np.float32),
        "tokens": rng.integers(0, ARCH.vocab_size, (2, 10)),
        "loss_mask": np.ones((2, 10), np.float32)}, "cpu")


def test_train_state_resumes_to_the_same_next_step(tmp_path):
    state, tx = train.init_train_state(_model(13), learning_rate=1e-3)
    step = train.make_train_step(tx)
    state, _ = step(state, _batch(0))
    path = ck.save_train_state(state, str(tmp_path / "state.pt"))
    state, loss = step(state, _batch(1))

    fresh, ftx = train.init_train_state(_model(99), learning_rate=1e-3)
    resumed = ck.load_train_state(path, fresh)
    assert resumed.step == 1
    resumed, loss2 = train.make_train_step(ftx)(resumed, _batch(1))
    assert resumed.step == state.step == 2
    assert torch.equal(loss, loss2)
    for (name, a), b in zip(state.params.named_parameters(),
                            resumed.params.parameters()):
        assert torch.equal(a, b), name


def _manifest(tmp_path, n=2):
    lines = []
    for i in range(n):
        wav = tmp_path / f"a{i}.wav"
        with wave.open(str(wav), "wb") as wf:
            wf.setnchannels(1)
            wf.setsampwidth(2)
            wf.setframerate(16000)
            wf.writeframes((audio(2.0 + i, seed=i) * 32767).astype("<i2").tobytes())
        lines.append(json.dumps({"audio": str(wav), "text": f"hello world {i}"}))
    path = tmp_path / "train.jsonl"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_run_finetune_cpu(tiny_ckpt, tmp_path, capsys):
    from thewhisper_tpu_torch import run_finetune

    out = tmp_path / "tuned"
    run_finetune.main(["--model", tiny_ckpt, "--manifest", _manifest(tmp_path),
                       "--out", str(out), "--steps", "2", "--batch-size", "2",
                       "--max-tokens", "16", "--save-every", "1", "--cpu"])
    text = capsys.readouterr().out
    assert "step     1  loss" in text and "fine-tuned checkpoint written" in text
    assert (out / "state_1.pt").exists() and (out / "tokenizer.json").exists()
    model, arch = load_checkpoint(str(out), device="cpu", chunk_length_s=10)
    assert model.encoder.pos_emb.shape[0] == 500     # truncated: flexible chunk
    with open(out / "generation_config.json") as f:
        assert json.load(f)["chunk_length"] == 10.0


def test_run_distill_cpu(tiny_ckpt, tmp_path, capsys):
    from thewhisper_tpu_torch import run_distill
    from thewhisper_tpu_torch.engine.speculative import load_draft

    out = tmp_path / "draft"
    run_distill.main(["--model", tiny_ckpt, "--manifest", _manifest(tmp_path),
                      "--out", str(out), "--layers", "1", "--steps", "2",
                      "--batch-size", "2", "--max-tokens", "16", "--holdout", "1",
                      "--cpu"])
    text = capsys.readouterr().out
    assert "1 train / 1 held-out samples" in text and "held-out agreement after" in text
    draft = load_draft(str(out), device="cpu")
    assert draft.encoder is None and draft.arch.decoder_layers == 1
