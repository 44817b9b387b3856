"""Weights into the port's :class:`~thewhisper_tpu_torch.models.whisper.Whisper`
(port of thewhisper_tpu's ``models/load.py``).

Three sources, one target naming:

- an HF Whisper checkpoint directory (``config.json``,
  ``generation_config.json``, ``model.safetensors`` or a sharded index),
  :func:`load_checkpoint`; ``safetensors`` is imported only there;
- an HF state dict, :func:`params_from_hf_state_dict`;
- the JAX package's parameter pytree as numpy, :func:`params_from_jax`
  (stacked (L, in, out) linears, (out, in, 3) convs, the fused decoder
  ``qkv_w``/``qkv_b`` an engine may have made, and the int8 leaves of an
  "S" engine, carried across exactly).

Flexible chunk lengths (< 30 s) truncate or linearly interpolate the
encoder position table, as the JAX loader does.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from thewhisper_tpu_torch.config import WhisperArch, source_positions_for_seconds
from thewhisper_tpu_torch.models.quant import (
    Int8Embedding,
    Int8Linear,
    W8A8Linear,
)
from thewhisper_tpu_torch.models.whisper import Whisper, model_from_state


def arch_from_hf_config(cfg: Mapping[str, Any],
                        alignment_heads: Tuple[Tuple[int, int], ...] = ()) -> WhisperArch:
    return WhisperArch(
        d_model=cfg["d_model"],
        encoder_layers=cfg["encoder_layers"],
        encoder_heads=cfg["encoder_attention_heads"],
        decoder_layers=cfg["decoder_layers"],
        decoder_heads=cfg["decoder_attention_heads"],
        d_ff=cfg.get("encoder_ffn_dim", 4 * cfg["d_model"]),
        n_mels=cfg.get("num_mel_bins", 80),
        vocab_size=cfg["vocab_size"],
        max_source_positions=cfg.get("max_source_positions", 1500),
        max_target_positions=cfg.get("max_target_positions", 448),
        median_filter_width=cfg.get("median_filter_width", 7),
        alignment_heads=alignment_heads,
    )


def interpolate_positions(pos: torch.Tensor, new_len: int) -> torch.Tensor:
    """Linear resize of a (T, d) position table along T
    (``F.interpolate(mode="linear", align_corners=False)``)."""
    out = F.interpolate(pos.T[None].float(), size=new_len, mode="linear",
                        align_corners=False)
    return out[0].T.to(pos.dtype)


def _hf_name(port_name: str) -> str:
    """The port's state-dict key -> the HF ``WhisperForConditionalGeneration``
    key."""
    fixed = {
        "encoder.pos_emb": "model.encoder.embed_positions.weight",
        "decoder.token_emb": "model.decoder.embed_tokens.weight",
        "decoder.pos_emb": "model.decoder.embed_positions.weight",
    }
    if port_name in fixed:
        return fixed[port_name]
    for ours, theirs in (
            (".attn.", ".self_attn."), (".cross_attn.", ".encoder_attn."),
            (".ln1.", ".self_attn_layer_norm."),
            (".ln_cross.", ".encoder_attn_layer_norm."),
            (".ln2.", ".final_layer_norm."), ("ln_post.", "layer_norm.")):
        port_name = port_name.replace(ours, theirs)
    port_name = re.sub(r"_attn\.(q|k|v)\.", r"_attn.\1_proj.", port_name)
    port_name = port_name.replace("_attn.out.", "_attn.out_proj.")
    return "model." + port_name


def _port_names(arch: WhisperArch):
    with torch.device("meta"):
        return list(Whisper(arch).state_dict())


def _cut_positions(pos: torch.Tensor, chunk_length_s: float,
                   position_mode: str) -> torch.Tensor:
    n_pos = source_positions_for_seconds(chunk_length_s)
    if n_pos >= pos.shape[0]:
        return pos
    if position_mode == "interpolate":
        return interpolate_positions(pos, n_pos)
    if position_mode == "truncate":
        return pos[:n_pos]
    raise ValueError(
        f"position_mode must be truncate|interpolate, got {position_mode}")


def params_from_hf_state_dict(
    state: Mapping[str, Any],
    arch: WhisperArch,
    dtype: torch.dtype = torch.float32,
    device=None,
    chunk_length_s: float = 30.0,
    position_mode: str = "truncate",
) -> Whisper:
    """Convert an HF Whisper state dict (tensors or numpy arrays)."""
    ours = {}
    for name in _port_names(arch):
        v = state[_hf_name(name)]
        ours[name] = (v if isinstance(v, torch.Tensor)
                      else torch.from_numpy(np.asarray(v, np.float32)))
    ours["encoder.pos_emb"] = _cut_positions(
        ours["encoder.pos_emb"].float(), chunk_length_s, position_mode)
    return model_from_state(ours, arch, dtype=dtype, device=device)


def params_from_jax(tree: Mapping[str, Any], arch: WhisperArch,
                    dtype: torch.dtype = torch.float32, device=None) -> Whisper:
    """The JAX parameter pytree (``jax.tree.map(np.asarray, params)``) as
    the port's model. Linear weights are stored (L, in, out) there and
    (out, in) here; convs are (out, in, 3) in both.

    Quantized leaves carry across exactly, never dequantized: weight-only
    ``{"q", "s"}`` becomes an ``Int8Linear``, W8A8 ``{"q8", "s8"}`` a
    ``W8A8Linear``, a per-row int8 ``token_emb`` an ``Int8Embedding``; a
    fused ``qkv_w`` (float or int8) splits back into q, k and v. A tree
    without ``"encoder"`` (a draft saved by JAX's ``save_draft``) gives a
    decoder-only model."""
    f32 = lambda x: np.asarray(x, np.float32)                 # noqa: E731
    state: Dict[str, np.ndarray] = {}
    quantized: Dict[str, type] = {}
    enc, dec = tree.get("encoder"), tree["decoder"]
    sides = ("decoder",) if enc is None else ("encoder", "decoder")
    if enc is not None:
        for conv in ("conv1", "conv2"):
            state[f"encoder.{conv}.weight"] = f32(enc[conv]["w"])
            state[f"encoder.{conv}.bias"] = f32(enc[conv]["b"])
        state["encoder.pos_emb"] = f32(enc["pos_emb"])
    emb = dec["token_emb"]
    if isinstance(emb, Mapping):
        state["decoder.token_emb.q"] = _int8(emb["q"])
        state["decoder.token_emb.s"] = f32(emb["s"])
        quantized["decoder.token_emb"] = Int8Embedding
    else:
        state["decoder.token_emb"] = f32(emb)
    state["decoder.pos_emb"] = f32(dec["pos_emb"])
    for side in sides:
        for k in ("scale", "bias"):
            state[f"{side}.ln_post.{'weight' if k == 'scale' else k}"] = f32(
                tree[side]["ln_post"][k])

    def linear(path: str, w: Any, i: int, part: int = 0, parts: int = 1) -> None:
        """Layer ``i`` of a stacked linear leaf, out-column block ``part`` of
        ``parts`` (a fused leaf's q, k or v)."""
        if isinstance(w, Mapping):
            w8a8 = "q8" in w
            q, s = (w["q8"], w["s8"]) if w8a8 else (w["q"], w["s"])
            q, s = _int8(q[i]), f32(s[i])
            quantized[path] = W8A8Linear if w8a8 else Int8Linear
            state[path + ".scale"] = np.split(s, parts, axis=-1)[part]
        else:
            q = f32(w[i])
        state[path + ".weight"] = np.split(q, parts, axis=-1)[part].T

    def attn(prefix: str, p: Mapping[str, Any], i: int) -> None:
        if "qkv_w" in p:             # fused by fuse_self_qkv_params
            for j, n in enumerate("qkv"):
                linear(prefix + n, p["qkv_w"], i, j, 3)
            q_b, _, v_b = np.split(f32(p["qkv_b"][i]), 3, axis=-1)
        else:
            for n in "qkv":
                linear(prefix + n, p[f"{n}_w"], i)
            q_b, v_b = f32(p["q_b"][i]), f32(p["v_b"][i])
        state[prefix + "q.bias"], state[prefix + "v.bias"] = q_b, v_b
        linear(prefix + "out", p["o_w"], i)
        state[prefix + "out.bias"] = f32(p["o_b"][i])

    def rest(prefix: str, lp: Mapping[str, Any], i: int, lns) -> None:
        for ln in lns:
            state[f"{prefix}{ln}.weight"] = f32(lp[ln]["scale"][i])
            state[f"{prefix}{ln}.bias"] = f32(lp[ln]["bias"][i])
        for fc in ("fc1", "fc2"):
            linear(prefix + fc, lp["mlp"][f"{fc}_w"], i)
            state[f"{prefix}{fc}.bias"] = f32(lp["mlp"][f"{fc}_b"][i])

    for i in range(arch.encoder_layers if enc is not None else 0):
        lp, prefix = enc["layers"], f"encoder.layers.{i}."
        attn(prefix + "attn.", lp["attn"], i)
        rest(prefix, lp, i, ("ln1", "ln2"))
    for i in range(arch.decoder_layers):
        lp, prefix = dec["layers"], f"decoder.layers.{i}."
        attn(prefix + "self_attn.", lp["self"], i)
        attn(prefix + "cross_attn.", lp["cross"], i)
        rest(prefix, lp, i, ("ln1", "ln_cross", "ln2"))
    return model_from_state(
        {k: np.ascontiguousarray(v) for k, v in state.items()}, arch,
        dtype=dtype, device=device, quantized=quantized)


def _int8(x: Any) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype != np.int8:
        raise NotImplementedError(
            f"quantized leaf of type {x.dtype}: only int8 is ported "
            "(int4 \"S4\" waits, ROADMAP Queue 1 item 9)")
    return x


def _read_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    try:
        from safetensors.torch import load_file
    except ImportError as e:
        raise ImportError(
            "load_checkpoint reads model.safetensors and needs the "
            "safetensors package") from e
    index_path = os.path.join(path, "model.safetensors.index.json")
    single_path = os.path.join(path, "model.safetensors")
    if os.path.exists(index_path):
        with open(index_path) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        state: Dict[str, torch.Tensor] = {}
        for shard in shards:
            state.update(load_file(os.path.join(path, shard)))
        return state
    if os.path.exists(single_path):
        return load_file(single_path)
    raise FileNotFoundError(f"no model.safetensors[.index.json] in {path}")


def detect_flexible_checkpoint(path: str, cfg: Mapping[str, Any],
                               gen_cfg: Mapping[str, Any]) -> bool:
    """True if the checkpoint is a flexible-chunk fine-tune: a
    ``chunk_length`` marker in its configs or a ``<N>sec`` path component.
    Such models were trained on truncated positions."""
    for c in (cfg, gen_cfg):
        if any(k in c for k in ("chunk_length", "chunk_length_s", "flexible_chunks")):
            return True
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    return any(re.fullmatch(r"\d+sec", p) for p in parts)


def load_checkpoint(
    path: str,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    chunk_length_s: float = 30.0,
    position_mode: Optional[str] = None,
) -> Tuple[Whisper, WhisperArch]:
    """Load an HF Whisper checkpoint directory into (model, arch) on
    ``device`` (the card unless the caller names the CPU).

    ``position_mode`` defaults to "truncate" for flexible fine-tunes
    (:func:`detect_flexible_checkpoint`), else "interpolate"."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    gen_cfg: Dict[str, Any] = {}
    gen_cfg_path = os.path.join(path, "generation_config.json")
    if os.path.exists(gen_cfg_path):
        with open(gen_cfg_path) as f:
            gen_cfg = json.load(f)
    alignment_heads = tuple(tuple(h) for h in gen_cfg.get("alignment_heads", []))
    arch = arch_from_hf_config(cfg, alignment_heads)
    if position_mode is None:
        position_mode = ("truncate"
                         if detect_flexible_checkpoint(path, cfg, gen_cfg)
                         else "interpolate")
    model = params_from_hf_state_dict(
        _read_safetensors_dir(path), arch, dtype=dtype, device=device,
        chunk_length_s=chunk_length_s, position_mode=position_mode)
    return model, arch
