"""Analytic FLOP and byte counts for MFU and HBM-share reporting, and the
card's peaks they are divided by.

MFU = achieved FLOP/s over the card's peak for the operands' type. Counts
are the standard 2 x MACs convention over the matmuls and convolutions;
LayerNorm, softmax and other elementwise work are left out (sub-percent
at these shapes).

The decode step is bound by memory bandwidth, not by FLOPs: its "MFU" is
reported for normalization, not as an optimization target, and the
companion ``decode_step_bytes`` gives the bandwidth side (bytes over
``HBM_BYTES_PER_S``).

The peaks are one NVIDIA H100 SXM's published dense rates (NVIDIA's data
sheet, without sparsity, at the full 700 W power limit). A card set below
700 W runs slower under load, so a share is stated beside the card's
power limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # bytes/s
BF16_FLOPS = 989e12           # FLOP/s, bf16 and fp16 on the tensor cores
TF32_FLOPS = 494.7e12         # FLOP/s, TF32 on the tensor cores
F32_FLOPS = 67e12             # FLOP/s, f32 outside the tensor cores


def encoder_flops(arch, t_mel: int, batch: int = 1) -> float:
    """Forward FLOPs of the conv stem + encoder stack at ``t_mel`` input
    frames (output length is ``t_mel // 2``)."""
    d, dff = arch.d_model, arch.d_ff
    t = t_mel // 2
    conv1 = 2 * t_mel * 3 * arch.n_mels * d
    conv2 = 2 * t * 3 * d * d
    per_layer = (
        8 * t * d * d          # q/k/v/o projections (2*MACs each)
        + 4 * t * t * d        # scores + values
        + 4 * t * d * dff      # fc1 + fc2
    )
    return batch * (conv1 + conv2 + arch.encoder_layers * per_layer)


def decode_step_flops(arch, cache_len: int, t_enc: int,
                      batch: int = 1) -> float:
    """FLOPs of ONE incremental decoder step (single query position)."""
    d, dff, v = arch.d_model, arch.d_ff, arch.vocab_size
    per_layer = (
        8 * d * d                   # self q/k/v/o
        + 4 * cache_len * d         # self scores + values over the cache
        + 4 * d * d                 # cross q + o
        + 4 * t_enc * d             # cross scores + values
        + 4 * d * dff               # mlp
    )
    logits = 2 * d * v              # tied-embedding readout
    return batch * (arch.decoder_layers * per_layer + logits)


def decode_step_bytes(arch, cache_len: int, t_enc: int,
                      batch: int = 1, weight_bytes: float = 1,
                      cache_bytes: float = 2, cross_bytes: float = 1) -> float:
    """HBM bytes read by ONE decoder step (weights + caches; activations
    are negligible at step shapes). The defaults describe the "S" engine:
    int8 weights and embedding, a bf16 self-cache and int8 cross K/V. The
    bf16 engine is ``weight_bytes=2, cross_bytes=2``; "S4"'s int4 decoder
    linears are ``weight_bytes=0.5`` (its table stays int8, which this
    count does not split out)."""
    d, dff, v = arch.d_model, arch.d_ff, arch.vocab_size
    weights_per_layer = (4 * d * d) + (2 * d * d) + (2 * d * dff)
    weights = arch.decoder_layers * weights_per_layer * weight_bytes
    emb = v * d * weight_bytes      # tied readout reads the full table
    self_cache = (arch.decoder_layers * 2 * batch * cache_len * d
                  * cache_bytes)
    cross = arch.decoder_layers * 2 * batch * t_enc * d * cross_bytes
    return weights + emb + self_cache + cross
