"""The "no-exp" attention control: the P1 kernel's wrapper and its plain
version.

``attention_control`` is the timing control of thewhisper_tpu's encoder
attention probe (``tools/attention_probe.py:112``, body ``control_kernel``):
flash attention over 512-key tiles with the exponential taken out, wrong
math on purpose, so that its time is the floor of the two products and the
online bookkeeping. Per (batch, head, query row), over the key tiles in
order: ``s = q k^T`` in f32 (no 1/sqrt(dh) scale, no mask); ``m_new =
max(m, rowmax(s))`` from ``m = -1e9``; ``p = s - m_new`` (no exp, no
rescale of ``acc`` by the old ``m``); ``l += rowsum(p)`` in f32;
``acc += p.to(v.dtype) @ v`` summed in f32; the output is ``acc /
max(l, 1)`` in q's type. The answer depends on the 512-key tiling, because
``m`` moves between tiles and earlier tiles are never corrected.

Every p <= 0, so l <= 0 and the division is by 1: ``l`` never reaches the
output. A caller that wants it (a test of the bookkeeping) passes
``row_sums``, a (B, H, S) f32 tensor that receives each row's ``l``.

Tensors are (B, H, S, dh) with dh = 64 and S a multiple of 512, as the
probe's. On a CUDA tensor it launches ``csrc/attention_control.cu`` (bf16 on
the tensor cores through TMA and wgmma, which need 16-byte-aligned base
pointers; f32 on the CUDA cores); on a CPU tensor it runs
:func:`attention_control_plain`.
"""

from __future__ import annotations

from typing import Optional

import torch

from thewhisper_tpu_torch.ops import _build

# Launches of the CUDA kernel (not of the plain version) since import.
CONTROL_LAUNCHES = 0

TILE = 512      # the probe's block_q = block_k
_DH = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_control_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            row_sums: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The probe's ``control_kernel`` in plain torch, one 512-key tile at a
    time. Returns (B, H, S, dh) in q's type; fills ``row_sums`` with l if
    given."""
    qf = q.float()
    shape = q.shape[:-1] + (1,)
    m = torch.full(shape, -1e9, device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    for t0 in range(0, k.shape[-2], TILE):
        s = torch.matmul(qf, k[..., t0:t0 + TILE, :].float().transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = s - m_new
        l = l + p.sum(-1, keepdim=True)
        acc = acc + torch.matmul(p.to(v.dtype).float(),
                                 v[..., t0:t0 + TILE, :].float())
        m = m_new
    if row_sums is not None:
        row_sums.copy_(l[..., 0])
    return (acc / l.clamp_min(1.0)).to(q.dtype)


def attention_control(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      row_sums: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, S, 64) q, k, v -> (B, H, S, 64), the contract of
    :func:`attention_control_plain`. CPU tensors take the plain version;
    CUDA tensors launch the kernel, which raises on what it does not take:
    one shape and one type (f32 or bf16) for all three, contiguous, dh = 64,
    S a multiple of 512, bf16 base pointers 16-byte aligned; ``row_sums`` a
    contiguous (B, H, S) f32 tensor on the same device."""
    global CONTROL_LAUNCHES
    if q.device.type == "cpu":
        return attention_control_plain(q, k, v, row_sums)
    if q.device.type != "cuda":
        raise ValueError(f"attention_control: unsupported device {q.device}")
    if q.ndim != 4 or not (q.shape == k.shape == v.shape):
        raise ValueError("attention_control: q, k, v must share one "
                         "(B, H, S, dh) shape")
    if not (q.device == k.device == v.device):
        raise ValueError("attention_control: q, k, v must share one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"attention_control: dtype {q.dtype} not supported")
    b, h, s, dh = q.shape
    if dh != _DH:
        raise ValueError(f"attention_control: head dim {dh} (takes {_DH})")
    if s < TILE or s % TILE:
        raise ValueError(f"attention_control: S = {s} is not a multiple of "
                         f"the {TILE}-key tile")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("attention_control: q, k, v must be contiguous")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("attention_control: bf16 operands need 16-byte-aligned "
                         "base pointers (TMA)")
    if row_sums is not None and not (
            row_sums.shape == q.shape[:-1] and row_sums.dtype == torch.float32
            and row_sums.device == q.device and row_sums.is_contiguous()):
        raise ValueError("attention_control: row_sums must be a contiguous "
                         "(B, H, S) float32 tensor on q's device")
    out = torch.empty_like(q)
    code = _build.lib().twt_attention_control(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if row_sums is None else row_sums.data_ptr(),
        _DTYPE_CODES[q.dtype], b, h, s, dh, q.device.index or 0,
        _build.stream_handle(q.device))
    _build.check(code, "twt_attention_control")
    CONTROL_LAUNCHES += 1
    return out
