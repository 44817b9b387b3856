"""Checkpoint writing: weights -> an HF checkpoint directory, train states ->
one ``torch.save`` file (port of thewhisper_tpu's ``models/checkpoint.py``).

- :func:`save_hf_checkpoint` inverts ``models/load.py``: a model becomes
  an HF-layout ``model.safetensors`` +
  ``config.json`` + ``generation_config.json`` directory that
  ``load_checkpoint`` of either package and
  ``transformers.WhisperForConditionalGeneration.from_pretrained`` load. The
  file is written by :func:`write_safetensors` with the standard library,
  so the port needs no ``safetensors`` package to write or read one;
  :func:`shard_safetensors` splits it into HF's shards and index.
- :func:`save_train_state` / :func:`load_train_state` persist a fine-tuning
  state (weights, optimizer moments, step) with ``torch.save``, in place of
  JAX's orbax.

A model sharded over a ``(dp, tp)`` mesh saves as an unsharded one does:
every rank calls the save (the shards are gathered over tp, a
collective), rank 0 writes the same files an unsharded run writes, the
other ranks write nothing; a saved train state loads onto any mesh (each
rank keeps its shards of it), as orbax restores onto any sharding.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from thewhisper_tpu_torch.config import WhisperArch
from thewhisper_tpu_torch.models.load import jax_tree_from_model, read_safetensors
from thewhisper_tpu_torch.models.whisper import Whisper, model_from_state
from thewhisper_tpu_torch.parallel.mesh import (
    gather_leaf,
    gather_params,
    local_part,
    param_pspecs,
    placement,
)

_ST_CODES = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
             np.dtype(np.float64): "F64", np.dtype(np.int64): "I64",
             np.dtype(np.int32): "I32", np.dtype(np.int8): "I8",
             np.dtype(np.uint8): "U8", np.dtype(np.bool_): "BOOL"}


def write_safetensors(tensors: Mapping[str, np.ndarray], path: str) -> None:
    """Write numpy arrays as a ``.safetensors`` file: an 8-byte
    little-endian header length, the JSON header (each name's dtype, shape
    and byte offsets, names in sorted order, and PyTorch's format tag;
    padded with spaces to 8 bytes), then each array's little-endian bytes
    in the same order."""
    arrays = {k: np.ascontiguousarray(tensors[k]) for k in sorted(tensors)}
    header: Dict[str, Any] = {}
    offset = 0
    for name, arr in arrays.items():
        header[name] = {"dtype": _ST_CODES[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for arr in arrays.values():
            f.write(arr.astype(arr.dtype.newbyteorder("<"), copy=False).data)


def _hf_state_dict(params: Dict[str, Any], arch: WhisperArch) -> Dict[str, np.ndarray]:
    """JAX's tree -> HF names; linear weights back to HF's (out, in)."""
    state: Dict[str, np.ndarray] = {}

    def t(x):
        return np.ascontiguousarray(np.asarray(x, dtype=np.float32).T)

    def a(x):
        return np.asarray(x, dtype=np.float32)

    enc, dec = params["encoder"], params["decoder"]
    for conv in ("conv1", "conv2"):
        state[f"model.encoder.{conv}.weight"] = a(enc[conv]["w"])
        state[f"model.encoder.{conv}.bias"] = a(enc[conv]["b"])
    state["model.encoder.embed_positions.weight"] = a(enc["pos_emb"])
    state["model.encoder.layer_norm.weight"] = a(enc["ln_post"]["scale"])
    state["model.encoder.layer_norm.bias"] = a(enc["ln_post"]["bias"])

    def unstack_attn(group, prefix, i):
        for proj, w, b in (("q_proj", "q_w", "q_b"), ("k_proj", "k_w", None),
                           ("v_proj", "v_w", "v_b"), ("out_proj", "o_w", "o_b")):
            state[f"{prefix}.{proj}.weight"] = t(group[w][i])
            if b is not None:
                state[f"{prefix}.{proj}.bias"] = a(group[b][i])

    def norms_and_mlp(lay, p, i, norms):
        for ours, theirs in norms:
            state[f"{p}.{theirs}.weight"] = a(lay[ours]["scale"][i])
            state[f"{p}.{theirs}.bias"] = a(lay[ours]["bias"][i])
        for fc in ("fc1", "fc2"):
            state[f"{p}.{fc}.weight"] = t(lay["mlp"][f"{fc}_w"][i])
            state[f"{p}.{fc}.bias"] = a(lay["mlp"][f"{fc}_b"][i])

    for i in range(arch.encoder_layers):
        p, lay = f"model.encoder.layers.{i}", enc["layers"]
        unstack_attn(lay["attn"], f"{p}.self_attn", i)
        norms_and_mlp(lay, p, i, (("ln1", "self_attn_layer_norm"),
                                  ("ln2", "final_layer_norm")))

    state["model.decoder.embed_tokens.weight"] = a(dec["token_emb"])
    state["model.decoder.embed_positions.weight"] = a(dec["pos_emb"])
    state["model.decoder.layer_norm.weight"] = a(dec["ln_post"]["scale"])
    state["model.decoder.layer_norm.bias"] = a(dec["ln_post"]["bias"])
    for i in range(arch.decoder_layers):
        p, lay = f"model.decoder.layers.{i}", dec["layers"]
        unstack_attn(lay["self"], f"{p}.self_attn", i)
        unstack_attn(lay["cross"], f"{p}.encoder_attn", i)
        norms_and_mlp(lay, p, i, (("ln1", "self_attn_layer_norm"),
                                  ("ln_cross", "encoder_attn_layer_norm"),
                                  ("ln2", "final_layer_norm")))
    # Tied LM head.
    state["proj_out.weight"] = a(dec["token_emb"])
    return state


def save_hf_checkpoint(
    model: Whisper,
    arch: WhisperArch,
    path: str,
    generation_config: Optional[Dict[str, Any]] = None,
    chunk_length_s: Optional[float] = None,
) -> str:
    """Write an HF-compatible Whisper checkpoint directory from a float
    model (through JAX's layout, :func:`jax_tree_from_model`).

    The encoder position table is written with however many rows it has,
    and ``max_source_positions`` set to match. Pass ``chunk_length_s`` for
    flexible-chunk fine-tunes: it writes a ``chunk_length`` marker into
    generation_config.json, so ``load_checkpoint`` truncates positions on
    reload instead of interpolating them.

    A sharded model (``parallel.mesh.shard_params``): every rank calls this;
    the whole weights are gathered to rank 0, which writes the directory an
    unsharded model writes, and the other ranks write nothing."""
    if model.tp is not None:
        full = gather_params(model, rank0_only=True)
        if full is None:
            return path
        model = model_from_state(full, model.arch, dtype=model.dtype,
                                 device="cpu")
    tree = jax_tree_from_model(model)
    os.makedirs(path, exist_ok=True)
    write_safetensors(_hf_state_dict(tree, arch),
                      os.path.join(path, "model.safetensors"))
    config = {
        "architectures": ["WhisperForConditionalGeneration"],
        "model_type": "whisper",
        "vocab_size": arch.vocab_size,
        "num_mel_bins": arch.n_mels,
        "d_model": arch.d_model,
        "encoder_layers": arch.encoder_layers,
        "encoder_attention_heads": arch.encoder_heads,
        "decoder_layers": arch.decoder_layers,
        "decoder_attention_heads": arch.decoder_heads,
        "encoder_ffn_dim": arch.d_ff,
        "decoder_ffn_dim": arch.d_ff,
        "max_source_positions": tree["encoder"]["pos_emb"].shape[0],
        "max_target_positions": arch.max_target_positions,
        "median_filter_width": arch.median_filter_width,
    }
    # Whisper-layout special ids only fit the real vocab; tiny test vocabs
    # get in-range placeholders so transformers can build the model.
    if arch.vocab_size >= 51865:
        config.update({"eos_token_id": 50257, "bos_token_id": 50257,
                       "pad_token_id": 50256,
                       "decoder_start_token_id": 50258})
    else:
        config.update({"eos_token_id": 1, "bos_token_id": 0,
                       "pad_token_id": 0, "decoder_start_token_id": 2})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    gen_cfg = dict(generation_config or {})
    gen_cfg.setdefault("alignment_heads",
                       [list(h) for h in arch.alignment_heads])
    if chunk_length_s is not None:
        gen_cfg.setdefault("chunk_length", float(chunk_length_s))
    with open(os.path.join(path, "generation_config.json"), "w") as f:
        json.dump(gen_cfg, f, indent=2)
    return path


def shard_safetensors(path: str, shards: int = 2) -> list:
    """Split a checkpoint directory's ``model.safetensors`` into ``shards``
    files of about equal size, in name order, under HF's names
    (``model-00001-of-00002.safetensors``), beside HF's
    ``model.safetensors.index.json`` (``metadata.total_size`` and each
    tensor's shard in ``weight_map``); the single file is removed. Returns
    the shards' names."""
    single = os.path.join(path, "model.safetensors")
    tensors = read_safetensors(single)
    names = sorted(tensors)
    sizes = [tensors[n].numel() * tensors[n].element_size() for n in names]
    total, done = sum(sizes), 0
    files = [f"model-{i + 1:05d}-of-{shards:05d}.safetensors" for i in range(shards)]
    weight_map = {}
    for name, size in zip(names, sizes):
        weight_map[name] = files[min(shards - 1, done * shards // max(total, 1))]
        done += size
    for file in files:
        write_safetensors({n: tensors[n].numpy() for n in names
                           if weight_map[n] == file}, os.path.join(path, file))
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map},
                  f, indent=2)
    del tensors
    os.remove(single)
    return files


# ---------------------------------------------------------------------------
# Training-state persistence (torch.save)
# ---------------------------------------------------------------------------


def _param_specs(model, opt) -> list:
    """The placement of each of ``opt``'s parameters, in the order of its
    state dict's indices (its groups' parameters in turn)."""
    specs = param_pspecs()
    names = {id(p): n for n, p in model.named_parameters()}
    return [placement(names[id(p)], specs)
            for g in opt.param_groups for p in g["params"]]


def _opt_state_leaves(opt_sd, specs, fn):
    """``opt_sd`` with ``fn(tensor, spec)`` applied to every per-element
    state tensor (the moments, ``ndim > 0``; the step counts stay)."""
    state = {i: {k: fn(v, specs[i]) if torch.is_tensor(v) and v.ndim else v
                 for k, v in entry.items()}
             for i, entry in opt_sd["state"].items()}
    return {**opt_sd, "state": state}


def save_train_state(state, path: str) -> str:
    """Write a ``TrainState`` (or ``DistillState``) to one file: the model's
    weights, the optimizer's state (moments, step counts) and the step.

    A sharded model: every rank calls this; its weights and moments are
    gathered over tp to rank 0, which writes the file an unsharded state
    writes (moments included), and the other ranks write nothing."""
    import torch.distributed as dist

    path = os.path.abspath(path)
    model, opt = state[0], state.opt_state
    params, opt_sd = model.state_dict(), opt.state_dict()
    if model.tp is not None:
        params = gather_params(model, rank0_only=True)
        opt_sd = _opt_state_leaves(opt_sd, _param_specs(model, opt),
                                   lambda v, spec: gather_leaf(v, spec, model.tp))
        if dist.get_rank() != 0:
            return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"params": params, "opt_state": opt_sd,
                "step": int(state.step)}, path)
    return path


def load_train_state(path: str, template):
    """Restore a state written by :func:`save_train_state` into
    ``template``'s model and optimizer (in place, on their device); returns
    the template's type with the saved step. A sharded template (any mesh,
    whatever mesh saved the file) keeps this rank's shards of the saved
    weights and moments."""
    model, opt = template[0], template.opt_state
    saved = torch.load(os.path.abspath(path), map_location=model.device,
                       weights_only=True)
    params, opt_sd = saved["params"], saved["opt_state"]
    if model.tp is not None:
        specs = param_pspecs()
        params = {k: local_part(v, placement(k, specs), model.tp)
                  for k, v in params.items()}
        opt_sd = _opt_state_leaves(opt_sd, _param_specs(model, opt),
                                   lambda v, spec: local_part(v, spec,
                                                              model.tp).clone())
    model.load_state_dict(params)
    opt.load_state_dict(opt_sd)
    return template._replace(step=saved["step"])
