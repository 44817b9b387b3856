"""Encoder self-attention: the K2 kernel's wrapper and its plain version.

``encoder_attention`` computes softmax(q k^T / sqrt(dh)) v over keys below
``valid_len``, non-causal, on (B, S, H, dh) tensors: the attention every
encoder layer runs, which thewhisper_tpu sends to the Pallas TPU flash
attention (``models/whisper.py::_flash_attention``). On a CUDA tensor it
launches ``csrc/encoder_attention.cu`` (dh = 64, f32 or bf16, any S, no
padded copies): bf16 on the tensor cores (TMA and wgmma, which need
16-byte-aligned base pointers and strides), f32 on the CUDA cores. On a CPU
tensor it runs :func:`encoder_attention_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from thewhisper_tpu_torch.ops import _build

# Launches of the CUDA kernel (not of the plain version) since import.
ATTN_LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def encoder_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            valid_len: Optional[int] = None) -> torch.Tensor:
    """Plain torch version, the math of thewhisper_tpu's ``_attention``:
    f32 scores and softmax, probabilities cast to v's type for the value
    product. Returns (B, S, H, dh) in q's type."""
    dh = q.shape[-1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))     # (B, H, S, dh)
    logits = torch.matmul((qt * dh ** -0.5).float(),
                          kt.float().transpose(-1, -2))
    if valid_len is not None and valid_len < k.shape[1]:
        logits[..., valid_len:] = -1e9
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype), vt)
    return out.transpose(1, 2).to(q.dtype)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid_len: Optional[int] = None) -> torch.Tensor:
    """(B, S, H, dh) q, k, v -> (B, S, H, dh); keys >= valid_len masked.

    CPU tensors take :func:`encoder_attention_plain`; CUDA tensors launch
    the kernel or raise.
    """
    global ATTN_LAUNCHES
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention: unsupported device {q.device}")
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError("encoder_attention: q, k, v must share one "
                         "(B, S, H, dh) shape")
    if not (q.device == k.device == v.device):
        raise ValueError("encoder_attention: q, k, v must share one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"encoder_attention: dtype {q.dtype} not supported")
    b, s, h, dh = q.shape
    if dh != 64:
        raise ValueError(f"encoder_attention: head dim {dh} not supported "
                         "(the kernel takes 64)")
    valid = s if valid_len is None else int(valid_len)
    if not 1 <= valid <= s:
        raise ValueError(f"encoder_attention: valid_len {valid} outside "
                         f"[1, {s}]")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("encoder_attention: head dim must be contiguous")
    if q.dtype == torch.bfloat16 and not all(
            x.data_ptr() % 16 == 0 and all(st * 2 % 16 == 0 for st in x.stride()[:3])
            for x in (q, k, v)):
        raise ValueError("encoder_attention: bf16 operands need 16-byte-aligned "
                         "base pointers and strides (TMA)")
    out = torch.empty(b, s, h, dh, device=q.device, dtype=q.dtype)
    code = _build.lib().twt_encoder_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODES[q.dtype], b, s, h, dh,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        valid, q.device.index or 0, _build.stream_handle(q.device))
    _build.check(code, "twt_encoder_attention")
    ATTN_LAUNCHES += 1
    return out
