"""Encoder self-attention: the K2 kernels' wrappers and their plain versions.

``encoder_attention`` computes softmax(q k^T / sqrt(dh)) v over keys below
``valid_len``, non-causal, on (B, S, H, dh) tensors (q may have another
row count than k and v: the sequence-parallel encoder's local queries over
the keys gathered from every rank): the attention every encoder layer
runs, which thewhisper_tpu sends to the Pallas TPU flash attention
(``models/whisper.py::_flash_attention``). On a CUDA tensor it launches ``csrc/encoder_attention.cu`` (dh = 64, f32 or bf16, any S, no
padded copies), on the tensor cores in both types: bf16 by TMA and wgmma,
f32 by TMA and mma.sync in 3xTF32 (each operand split into a TF32 high
part and rest, so the result keeps f32's precision). TMA needs
16-byte-aligned base pointers and strides. On a CPU tensor it runs
:func:`encoder_attention_plain`. The gradient path is square: S_q != S_k
under autograd raises ``ValueError``.

Its gradient is the library kernel's custom VJP ported: when grad mode is
on and an input requires grad, ``encoder_attention`` goes through
:class:`EncoderAttention`, whose forward launches K2 with the rows'
log-sum-exp (:func:`encoder_attention_residuals`, the library's
``save_residuals`` forward) and whose backward launches
``csrc/encoder_attention_bwd.cu``'s dK/dV and dQ kernels
(:func:`encoder_attention_backward`): bf16 on the tensor cores (TMA and
wgmma), f32 on them too (TMA and mma.sync in 3xTF32), each type one kernel
template for dK/dV and dQ; the same alignment rule holds for q, k, v and
``dout`` in both types. CPU tensors take the plain versions of all three.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from thewhisper_tpu_torch.ops import _build

# Launches of the CUDA kernels (not of the plain versions) since import:
# K2 without residuals (inference), K2 writing lse (the training forward),
# and the two backward kernels.
ATTN_LAUNCHES = 0
ATTN_RES_LAUNCHES = 0
ATTN_BWD_DKV_LAUNCHES = 0
ATTN_BWD_DQ_LAUNCHES = 0
# Output gradients EncoderAttention.backward had to copy (a unit stride
# missing on the head dim, or TMA's 16-byte rule broken), on any device:
# the layers' views are meant to keep the rule themselves.
DOUT_COPIES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _scores(q: torch.Tensor, k: torch.Tensor,
            valid_len: Optional[int]) -> torch.Tensor:
    """f32 (B, H, S_q, S_k) scores q k^T / sqrt(dh) of q (B, S_q, H, dh)
    over k (B, S_k, H, dh), keys >= valid_len at -1e9."""
    dh = q.shape[-1]
    logits = torch.matmul((q.transpose(1, 2) * dh ** -0.5).float(),
                          k.transpose(1, 2).float().transpose(-1, -2))
    if valid_len is not None and valid_len < k.shape[1]:
        logits[..., valid_len:] = -1e9
    return logits


def encoder_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            valid_len: Optional[int] = None) -> torch.Tensor:
    """Plain torch version, the math of thewhisper_tpu's ``_attention``:
    f32 scores and softmax, probabilities cast to v's type for the value
    product. Returns (B, S_q, H, dh) in q's type (q's row count; k and v
    share theirs)."""
    probs = torch.softmax(_scores(q, k, valid_len), dim=-1)
    out = torch.matmul(probs.to(v.dtype), v.transpose(1, 2))
    return out.transpose(1, 2).to(q.dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor,
                        valid_len: Optional[int] = None) -> torch.Tensor:
    """f32 (B, H, S_q): the natural-log log-sum-exp of each row's scaled
    scores over keys < valid_len, the residual K2 writes for the backward."""
    return torch.logsumexp(_scores(q, k, valid_len), dim=-1)


def encoder_attention_backward_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, dout: torch.Tensor, valid_len: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of both backward kernels, the library's flash formula:
    P = exp(s - lse), di = rowsum(O dO), dS = P (dO v^T - di); in the
    operand type's precision P and dS are rounded before their products
    (dV = P^T dO, dK = dS^T q / sqrt(dh), dQ = dS k / sqrt(dh)), the
    sums are f32. Returns (dq, dk, dv), (B, S, H, dh) in q's type."""
    dtype, scale = q.dtype, q.shape[-1] ** -0.5
    rnd = lambda x: x.to(dtype).float()                      # noqa: E731
    qt, kt, vt, ot, dt = (x.transpose(1, 2).float() for x in (q, k, v, out, dout))
    p = torch.exp(_scores(q, k, valid_len) - lse[..., None])
    dv = torch.matmul(rnd(p).transpose(-1, -2), dt)
    dp = torch.matmul(dt, vt.transpose(-1, -2))
    ds = rnd(p * (dp - (ot * dt).sum(-1, keepdim=True)))
    dq = torch.matmul(ds, kt) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qt) * scale
    return tuple(x.transpose(1, 2).to(dtype) for x in (dq, dk, dv))


def _checked(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             valid_len: Optional[int]) -> int:
    """Refuse what the kernels do not take: q (B, S_q, H, dh) and k, v of
    one (B, S_k, H, dh) shape, S_q >= 1. Returns valid_len as an int."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if (q.ndim != 4 or k.shape != v.shape or k.ndim != 4 or q.shape[1] < 1
            or (q.shape[0], q.shape[2], q.shape[3]) != (k.shape[0], k.shape[2],
                                                        k.shape[3])):
        raise ValueError(f"{name}: q must be (B, S_q, H, dh) and k, v share "
                         "one (B, S_k, H, dh) shape")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v must share one device")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported")
    s_k, dh = k.shape[1], q.shape[3]
    if dh != 64:
        raise ValueError(f"{name}: head dim {dh} not supported "
                         "(the kernel takes 64)")
    valid = s_k if valid_len is None else int(valid_len)
    if not 1 <= valid <= s_k:
        raise ValueError(f"{name}: valid_len {valid} outside [1, {s_k}]")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError(f"{name}: head dim must be contiguous")
    return valid


def _tma_aligned(x: torch.Tensor) -> bool:
    """Whether TMA takes a (B, S, H, dh) operand: a 16-byte-aligned base
    pointer and batch, sequence and head strides."""
    return x.data_ptr() % 16 == 0 and all(
        st * x.element_size() % 16 == 0 for st in x.stride()[:3])


def _check_tma(name: str, *xs: torch.Tensor) -> None:
    if not all(_tma_aligned(x) for x in xs):
        raise ValueError(f"{name}: {xs[0].dtype} operands need 16-byte-aligned "
                         "base pointers and strides (TMA)")


def _forward(q, k, v, valid_len, with_lse: bool):
    """One K2 launch: (out, lse or None)."""
    valid = _checked("encoder_attention", q, k, v, valid_len)
    _check_tma("encoder_attention", q, k, v)
    b, s, h, dh = q.shape
    out = torch.empty(b, s, h, dh, device=q.device, dtype=q.dtype)
    lse = (torch.empty(b, h, s, device=q.device, dtype=torch.float32)
           if with_lse else None)
    code = _build.lib().twt_encoder_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), _DTYPE_CODES[q.dtype],
        b, s, k.shape[1], h, dh, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3],
        valid, q.device.index or 0, _build.stream_handle(q.device))
    _build.check(code, "twt_encoder_attention")
    return out, lse


def encoder_attention_residuals(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, valid_len: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 with residuals: (out (B, S_q, H, dh), lse (B, H, S_q) f32).

    CPU tensors take the plain versions; CUDA tensors launch the kernel
    (one launch writes both) or raise."""
    global ATTN_RES_LAUNCHES
    if q.device.type == "cpu":
        return (encoder_attention_plain(q, k, v, valid_len),
                attention_lse_plain(q, k, valid_len))
    out, lse = _forward(q, k, v, valid_len, with_lse=True)
    ATTN_RES_LAUNCHES += 1
    return out, lse


def encoder_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
        lse: torch.Tensor, dout: torch.Tensor, valid_len: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`encoder_attention` from the forward's q, k, v,
    out and lse and the output's gradient ``dout``.

    CPU tensors take :func:`encoder_attention_backward_plain`; CUDA tensors
    launch the dK/dV kernel and the dQ kernel or raise (q, k, v and dout
    must meet TMA's alignment, ``ValueError`` otherwise). ``di`` =
    rowsum(out dout) is one torch reduction here, as it is plain JAX in the
    library. The kernels are square: S_q != S_k raises ``ValueError`` on
    every device."""
    name = "encoder_attention_backward"
    _check_square(name, q, k)
    if q.device.type == "cpu":
        return encoder_attention_backward_plain(q, k, v, out, lse, dout, valid_len)
    valid = _checked(name, q, k, v, valid_len)
    b, s, h, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, h, s):
        raise ValueError(f"{name}: out and dout must be (B, S, H, dh), "
                         "lse (B, H, S)")
    if out.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(f"{name}: out and dout must take q's type, lse f32")
    if any(x.device != q.device for x in (out, lse, dout)):
        raise ValueError(f"{name}: every operand must be on q's device")
    if dout.stride(-1) != 1:
        raise ValueError(f"{name}: head dim must be contiguous")
    _check_tma(name, q, k, v, dout)
    lse = lse.contiguous()
    di = (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = launch_backward_dkv(q, k, v, dout, lse, di, valid)
    return launch_backward_dq(q, k, v, dout, lse, di, valid), dk, dv


def _backward_args(q, k, v, dout, valid: int):
    """The arguments both backward entry points share after the outputs."""
    b, s, h, dh = q.shape
    return (_DTYPE_CODES[q.dtype], b, s, h, dh, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *dout.stride()[:3], valid, q.device.index or 0,
            _build.stream_handle(q.device))


def launch_backward_dkv(q, k, v, dout, lse, di, valid: int):
    """One launch of the dK/dV kernel on operands
    :func:`encoder_attention_backward` has checked (lse and di contiguous
    f32 (B, H, S)): returns (dk, dv)."""
    global ATTN_BWD_DKV_LAUNCHES
    dk, dv = (torch.empty(q.shape, device=q.device, dtype=q.dtype)
              for _ in range(2))
    code = _build.lib().twt_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_backward_args(q, k, v, dout, valid))
    _build.check(code, "twt_attention_bwd_dkv")
    ATTN_BWD_DKV_LAUNCHES += 1
    return dk, dv


def launch_backward_dq(q, k, v, dout, lse, di, valid: int):
    """One launch of the dQ kernel on checked operands: returns dq."""
    global ATTN_BWD_DQ_LAUNCHES
    dq = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    code = _build.lib().twt_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        *_backward_args(q, k, v, dout, valid))
    _build.check(code, "twt_attention_bwd_dq")
    ATTN_BWD_DQ_LAUNCHES += 1
    return dq


def _check_square(name: str, q: torch.Tensor, k: torch.Tensor) -> None:
    if q.shape[1] != k.shape[1]:
        raise ValueError(f"{name}: the gradient kernels take S_q = S_k, not "
                         f"{q.shape[1]} queries over {k.shape[1]} keys (the "
                         "sequence-parallel encoder has no backward)")


class EncoderAttention(torch.autograd.Function):
    """``encoder_attention`` with its gradient: the forward saves q, k, v,
    the output and lse; the backward runs :func:`encoder_attention_backward`.
    Square only: S_q != S_k raises ``ValueError``."""

    @staticmethod
    def forward(ctx, q, k, v, valid_len):
        _check_square("EncoderAttention", q, k)
        out, lse = encoder_attention_residuals(q, k, v, valid_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.valid_len = valid_len
        return out

    @staticmethod
    def backward(ctx, dout):
        global DOUT_COPIES
        q, k, v, out, lse = ctx.saved_tensors
        # Autograd may hand over an expanded or a misaligned gradient: a copy.
        if dout.stride(-1) != 1 or not _tma_aligned(dout):
            DOUT_COPIES += 1
            dout = dout.clone(memory_format=torch.contiguous_format)
        return (*encoder_attention_backward(q, k, v, out, lse, dout,
                                            ctx.valid_len), None)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid_len: Optional[int] = None) -> torch.Tensor:
    """(B, S_q, H, dh) q over (B, S_k, H, dh) k, v -> (B, S_q, H, dh); keys
    >= valid_len masked (S_q = S_k but for the sequence-parallel encoder).

    With grad mode on and an input that requires grad, the call goes
    through :class:`EncoderAttention`. Otherwise CPU tensors take
    :func:`encoder_attention_plain`, and CUDA tensors launch the kernel
    (without residuals) or raise.
    """
    global ATTN_LAUNCHES
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return EncoderAttention.apply(q, k, v, valid_len)
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, valid_len)
    out, _ = _forward(q, k, v, valid_len, with_lse=False)
    ATTN_LAUNCHES += 1
    return out
