"""The port's checkpoint loader against the JAX loader, on the structurally
real tiny checkpoint of ``tools/make_tiny_checkpoint.py`` (51866-token
vocab, HF layout, tokenizer)."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tools")


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    from make_tiny_checkpoint import make_checkpoint

    return make_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny"), seed=0)


@pytest.mark.parametrize("chunk_length_s,position_mode", [
    (30.0, None), (10.0, None), (10.0, "truncate"), (10.0, "interpolate")])
def test_load_checkpoint_matches_jax(tiny_ckpt, chunk_length_s, position_mode):
    import jax
    import jax.numpy as jnp

    from thewhisper_tpu.models.load import load_checkpoint as jax_load
    from thewhisper_tpu_torch.models.load import load_checkpoint, params_from_jax

    tree, jarch = jax_load(tiny_ckpt, dtype=jnp.float32,
                           chunk_length_s=chunk_length_s,
                           position_mode=position_mode)
    model, arch = load_checkpoint(tiny_ckpt, dtype=torch.float32, device="cpu",
                                  chunk_length_s=chunk_length_s,
                                  position_mode=position_mode)
    # The port's own WhisperArch, field for field the JAX one.
    assert dataclasses.asdict(arch) == dataclasses.asdict(jarch)
    assert model.encoder.pos_emb.shape[0] == int(chunk_length_s * 50)
    ref = params_from_jax(jax.tree.map(np.asarray, tree), jarch).state_dict()
    sd = model.state_dict()
    assert sd.keys() == ref.keys()
    for name in sd:
        # The interpolated position table is computed by two linear-resize
        # implementations (numpy there, F.interpolate here): f32 rounding.
        torch.testing.assert_close(sd[name], ref[name], atol=1e-6, rtol=0,
                                   msg=name)


def test_hf_names_cover_the_state_dict(tiny_ckpt):
    from safetensors.numpy import load_file

    from thewhisper_tpu_torch.models.load import (
        _hf_name,
        _port_names,
        arch_from_hf_config,
    )

    with open(os.path.join(tiny_ckpt, "config.json")) as f:
        arch = arch_from_hf_config(json.load(f))
    hf = set(load_file(os.path.join(tiny_ckpt, "model.safetensors")))
    mapped = {_hf_name(n) for n in _port_names(arch)}
    assert mapped <= hf
    # Everything left over is the untied copy of the embedding HF may save.
    assert hf - mapped <= {"proj_out.weight"}


def test_detect_flexible_checkpoint(tmp_path):
    from thewhisper_tpu.models.load import detect_flexible_checkpoint as jax_detect
    from thewhisper_tpu_torch.models.load import detect_flexible_checkpoint

    cases = [(str(tmp_path), {}, {}), (str(tmp_path / "10sec"), {}, {}),
             (str(tmp_path), {"chunk_length": 10}, {}),
             (str(tmp_path), {}, {"flexible_chunks": True})]
    for path, cfg, gen in cases:
        assert detect_flexible_checkpoint(path, cfg, gen) == jax_detect(path, cfg, gen)


def test_engine_and_pipeline_from_checkpoint(tiny_ckpt):
    """from_checkpoint reads the suppress lists; the pipeline built from
    the directory (HF tokenizer) transcribes as the JAX one does, in the
    float and the "S" mode."""
    from thewhisper_tpu.pipeline import ASRPipeline as JaxPipeline
    from thewhisper_tpu_torch.engine import WhisperEngine
    from thewhisper_tpu_torch.pipeline import ASRPipeline

    eng = WhisperEngine.from_checkpoint(tiny_ckpt, compute_dtype=torch.float32,
                                        device="cpu")
    assert eng.build_prompt("en") == [50258, 50259, 50360, 50364]
    assert eng._begin_suppress is not None and eng._suppress is None
    assert eng.compute_dtype == torch.float32

    rng = np.random.default_rng(0)
    a = (0.1 * rng.standard_normal(32000)).astype(np.float32)
    kw = dict(return_timestamps="word",
              generate_kwargs={"max_new_tokens": 8, "language": "en"})
    pipe = ASRPipeline(tiny_ckpt, model_size="XL32", device="cpu")
    assert pipe.tokenizer is not None
    assert pipe(a, **kw) == JaxPipeline(tiny_ckpt, model_size="XL32")(a, **kw)
    # "S" ("int8-all"): both packages quantize the same checkpoint.
    import jax.numpy as jnp

    s_pipe = ASRPipeline(tiny_ckpt, model_size="S",
                         compute_dtype=torch.float32, device="cpu")
    assert s_pipe.engine.cross_kv_int8
    assert s_pipe(a, **kw) == JaxPipeline(
        tiny_ckpt, model_size="S", compute_dtype=jnp.float32)(a, **kw)
    with pytest.raises(NotImplementedError):
        ASRPipeline(tiny_ckpt, model_size="S4", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        WhisperEngine.from_checkpoint(tiny_ckpt, device="cpu", quantize="int4")


@pytest.mark.parametrize("loader", ["load_checkpoint", "load_draft"])
def test_public_loaders_default_to_the_card(loader):
    """The port's loaders land on the card unless the caller names the CPU,
    as JAX's land on the default accelerator and as
    ``WhisperEngine.from_checkpoint`` and ``ASRPipeline`` already do."""
    import inspect

    from thewhisper_tpu_torch.engine import speculative
    from thewhisper_tpu_torch.models import load

    fn = getattr(load, loader, None) or getattr(speculative, loader)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
