"""The benchmark's frozen yardsticks: FLOP counts, the card's peaks, the
roofline bound and the trace arithmetic.

These are copies, so that a change to the program cannot move the ruler
it is measured with:

- ``encoder_flops``, ``decode_step_flops``, ``decode_step_bytes`` and the
  peaks: ``thewhisper_tpu_torch/utils/flops.py`` at commit ``ac90407``,
  plus ``INT8_OPS`` (one H100 SXM's dense int8 rate), which it lacks;
  ``encoder_flops`` is split here into its linear and attention parts so
  that each can be held to the peak of its own type.
- ``device_idle`` and ``kernel_times``: ``thewhisper_tpu_torch/utils/
  profiling.py`` at ``ac90407``.
- ``bound``: ``chip_smoke.py::bound`` at ``ac90407``, in seconds.

Counts follow the 2 x MACs convention over matmuls and convolutions;
LayerNorm, softmax and other elementwise work are left out.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12     # bytes/s
BF16_FLOPS = 989e12           # FLOP/s, bf16 and fp16 on the tensor cores
INT8_OPS = 1979e12            # OP/s, int8 on the tensor cores
TF32_FLOPS = 494.7e12         # FLOP/s, TF32 on the tensor cores
F32_FLOPS = 67e12             # FLOP/s, f32 outside the tensor cores

# Chrome-trace categories of the work a card does: kernels and copies.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def encoder_parts(arch, t_mel: int, batch: int = 1) -> Dict[str, float]:
    """Forward FLOPs of the conv stem and encoder stack at ``t_mel`` input
    frames, by part: ``linear`` (q/k/v/o and the MLP), ``attention``
    (scores and values) and ``conv`` (the stem)."""
    d, dff = arch.d_model, arch.d_ff
    t = t_mel // 2
    conv = 2 * t_mel * 3 * arch.n_mels * d + 2 * t * 3 * d * d
    linear = arch.encoder_layers * (8 * t * d * d + 4 * t * d * dff)
    attention = arch.encoder_layers * 4 * t * t * d
    return {"linear": batch * linear, "attention": batch * attention,
            "conv": batch * conv}


def encoder_flops(arch, t_mel: int, batch: int = 1) -> float:
    """Forward FLOPs of the conv stem + encoder stack."""
    return sum(encoder_parts(arch, t_mel, batch).values())


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
    """HBM bytes read by ONE decoder step (weights + caches)."""
    d, dff, v = arch.d_model, arch.d_ff, arch.vocab_size
    weights_per_layer = (4 * d * d) + (2 * d * d) + (2 * d * dff)
    weights = arch.decoder_layers * weights_per_layer * weight_bytes
    emb = v * d * weight_bytes
    self_cache = (arch.decoder_layers * 2 * batch * cache_len * d
                  * cache_bytes)
    cross = arch.decoder_layers * 2 * batch * t_enc * d * cross_bytes
    return weights + emb + self_cache + cross


def bound(bytes_moved: float, ops: float, ops_per_s: float) -> Tuple[float, str]:
    """The least time in seconds the card could take for a call, and what
    bounds it: the larger of its bytes (each input read once, each output
    written once) over the memory rate and its operations over the peak
    rate for their type."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / ops_per_s
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_times(events: List[dict]) -> Dict[str, Tuple[int, float]]:
    """Name -> (launches, summed us) of the device kernels among ``events``."""
    out: Dict[str, Tuple[int, float]] = {}
    for e in events:
        if e.get("cat") == "kernel":
            cnt, us = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (cnt + 1, us + e["dur"])
    return out


def device_idle(events: List[dict], start: float,
                end: float) -> Tuple[float, List[Tuple[float, float]]]:
    """(busy us, idle gaps) of the device over ``[start, end)`` us: the
    union of its kernel, copy and set intervals clipped to the window, and
    the window's stretches that none of them covers, longest first."""
    spans = sorted((max(e["ts"], start), min(e["ts"] + e["dur"], end))
                   for e in events if e.get("cat") in DEVICE_CATEGORIES
                   and e["ts"] < end and e["ts"] + e["dur"] > start)
    busy, gaps, at = 0.0, [], start
    for lo, hi in spans:
        if lo > at:
            gaps.append((at, lo))
        if hi > at:
            busy += hi - max(lo, at)
            at = hi
    if at < end:
        gaps.append((at, end))
    return busy, sorted(gaps, key=lambda g: g[0] - g[1])
