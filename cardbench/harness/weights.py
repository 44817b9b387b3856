"""Random Whisper weights from the run's seed, made on the device in the
type they are served in, in a few large draws.

The state is keyed by the port's state-dict names, written out here from
the architecture (``layout``), so the plain reference reads the same
dictionary without importing anything of the program. Making it twice
from one seed gives the same values, so the reference, which runs after
the program's state is freed, makes its own copy.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from harness.spec import Arch

# Standard deviations: N(0, 0.02) weights and tables (the port's and
# JAX's init_params), N(0, 0.1) biases and LayerNorm parameters about
# their 0 and 1 (a checkpoint has them; zero biases hide faults). Two
# groups are drawn wider, so that what the model serves depends on its
# audio as a trained model's does, and a row given another row's audio
# reads wrong: the conv stem (conv1 N(0, 0.1), conv2 N(0, 0.027)), whose
# output then spreads about as widely as the sinusoidal positions it is
# added to (at 0.02 the positions drown it), and the cross-attention's q
# and k (N(0, CROSS_SCORE_VAR / d)), whose scores then spread by about 6,
# so each query attends to a few frames, as alignment heads do (at 0.02 it
# averages all of them, and two windows of like audio read alike).
WEIGHT_STD = 0.02
BIAS_STD = 0.1
STEM_STD = (0.1, 0.027)
CROSS_SCORE_VAR = 6.0


def _attention(prefix: str, d: int) -> List[Tuple[str, tuple]]:
    out = []
    for p in ("q", "k", "v", "out"):
        out.append((f"{prefix}.{p}.weight", (d, d)))
        if p != "k":
            out.append((f"{prefix}.{p}.bias", (d,)))
    return out


def _ln(prefix: str, d: int) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.weight", (d,)), (f"{prefix}.bias", (d,))]


def _mlp(prefix: str, d: int, f: int) -> List[Tuple[str, tuple]]:
    return [(f"{prefix}.fc1.weight", (f, d)), (f"{prefix}.fc1.bias", (f,)),
            (f"{prefix}.fc2.weight", (d, f)), (f"{prefix}.fc2.bias", (d,))]


def layout(arch: Arch) -> List[Tuple[str, tuple]]:
    """(name, shape) of every leaf, in the port's naming (``nn.Linear``
    weights (out, in), conv kernels (out, in, 3))."""
    d, f = arch.d_model, arch.d_ff
    out = [("encoder.conv1.weight", (d, arch.n_mels, 3)),
           ("encoder.conv1.bias", (d,)),
           ("encoder.conv2.weight", (d, d, 3)), ("encoder.conv2.bias", (d,)),
           ("encoder.pos_emb", (arch.max_source_positions, d))]
    for i in range(arch.encoder_layers):
        p = f"encoder.layers.{i}"
        out += (_ln(f"{p}.ln1", d) + _attention(f"{p}.attn", d)
                + _ln(f"{p}.ln2", d) + _mlp(p, d, f))
    out += _ln("encoder.ln_post", d)
    out += [("decoder.token_emb", (arch.vocab_size, d)),
            ("decoder.pos_emb", (arch.max_target_positions, d))]
    for i in range(arch.decoder_layers):
        p = f"decoder.layers.{i}"
        out += (_ln(f"{p}.ln1", d) + _attention(f"{p}.self_attn", d)
                + _ln(f"{p}.ln_cross", d) + _attention(f"{p}.cross_attn", d)
                + _ln(f"{p}.ln2", d) + _mlp(p, d, f))
    out += _ln("decoder.ln_post", d)
    return out


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _small(name: str) -> bool:
    return name.endswith("bias") or ".ln" in name


def _std(name: str, arch: Arch) -> float:
    if name.startswith("encoder.conv"):
        return STEM_STD[int(name[len("encoder.conv")]) - 1]
    if ".cross_attn." in name and name.endswith((".q.weight", ".k.weight")):
        return (CROSS_SCORE_VAR / arch.d_model) ** 0.5
    return WEIGHT_STD


def make_state(arch: Arch, seed: int, device, dtype=torch.bfloat16
               ) -> Dict[str, torch.Tensor]:
    """The state of a random model for ``seed``: two draws from one
    generator on ``device`` (the weights, then the biases and LayerNorm
    parameters), each leaf a copy of its slice, scaled."""
    leaves = layout(arch)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    big = [(n, s) for n, s in leaves if not _small(n) and n != "encoder.pos_emb"]
    small = [(n, s) for n, s in leaves if _small(n)]
    state: Dict[str, torch.Tensor] = {}
    for group in (big, small):
        sizes = [int(np.prod(s)) for _, s in group]
        flat = torch.randn(sum(sizes), generator=g, device=device, dtype=dtype)
        for (name, shape), part in zip(group, torch.split(flat, sizes)):
            if _small(name):
                leaf = part.view(shape) * BIAS_STD
                if name.endswith("weight"):
                    leaf.add_(1.0)
            else:
                leaf = part.view(shape) * _std(name, arch)
            state[name] = leaf
        del flat
    state["encoder.pos_emb"] = torch.from_numpy(
        sinusoids(arch.max_source_positions, arch.d_model)).to(device, dtype)
    return state
