"""The batch-1 int8 MLP chain: the P2 and P3 kernels' wrappers and their
plain version.

thewhisper_tpu's GEMV-chain probe (``tools/gemv_chain_probe.py``) asks how
close the decode step's MLP sub-chain can get to its memory floor when it
runs as one kernel (P2, ``build_mlp_chain_kernel``) or as one kernel a
layer (P3, ``build_mlp_layer_kernel``). For each layer l:

    q_in = bf16(LayerNorm(x) * ln_s[l] + ln_b[l])    f32 statistics, eps 1e-5
    h = gelu_tanh(bf16(q_in @ W1[l] * s1[l] + b1[l]))  stored in bf16
    y = h @ W2[l] * s2[l] + b2[l]
    x = x + bf16(y)                                     in bf16

with the int8 weights widened to bf16, f32 sums, and the scale and bias
applied after the sum. The operands keep the probe's (L, in, out) layout:
``w1`` (L, D, F), ``w2`` (L, F, D) int8; ``ln_s``, ``ln_b``, ``s2``, ``b2``
(L, D) and ``s1``, ``b1`` (L, F) f32; ``x`` (1, D) bf16.

``mlp_chain`` runs every layer; on a CUDA tensor it is one cooperative
launch of ``csrc/mlp_chain.cu`` (the decode engine's TMA weight ring, two
grid barriers a layer). ``mlp_layer`` runs layer ``l``; on a CUDA tensor it
is one launch of the same kernel over that layer, so L launches of it give
the chain's bits exactly. The kernel streams the weights in (L, out, in)
layout: on a CUDA tensor both take ``packed=pack_mlp_weights(w1, w2)``,
made once before the calls. CPU tensors take the plain versions and
ignore ``packed``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from thewhisper_tpu_torch.ops import _build
from thewhisper_tpu_torch.ops.mega_step import STAMPS

# Launches of the CUDA kernel (not of the plain versions) since import: P2
# (the whole chain) and P3 (one layer).
MLP_CHAIN_LAUNCHES = 0
MLP_LAYER_LAUNCHES = 0

_MULTIPLE = 128    # d_model and d_ff the kernel takes


class MlpPacked(NamedTuple):
    """The chain's int8 weights in the kernel's (L, out, in) layout, made
    once by :func:`pack_mlp_weights` from the (L, in, out) operands, and
    the storage they were made from."""

    w1t: torch.Tensor      # (L, F, D) int8
    w2t: torch.Tensor      # (L, D, F) int8
    source: tuple          # (w1.data_ptr(), w2.data_ptr())


def pack_mlp_weights(w1: torch.Tensor, w2: torch.Tensor) -> MlpPacked:
    """``w1`` (L, D, F) and ``w2`` (L, F, D) int8, transposed once into
    contiguous (L, F, D) and (L, D, F) copies: each of the kernel's blocks
    then owns whole output rows, read as stored. The wrappers refuse a
    pack made from other tensors (other shapes or other storage); an
    in-place change of ``w1`` or ``w2`` after packing is not seen."""
    return MlpPacked(w1.transpose(1, 2).contiguous(), w2.transpose(1, 2).contiguous(),
                     (w1.data_ptr(), w2.data_ptr()))


def stamps_tensor(n_layers: int, device) -> torch.Tensor:
    """A zeroed int64 (2, 2 L, 6) tensor for a launch's ``stamps`` over L
    layers, for block 0 (row 0) and the grid's last block (row 1), phase
    2 i being the fc1 phase (LayerNorm, fc1 and GELU) of the launch's i-th
    layer and 2 i + 1 its fc2: ``STAMPS``, as for
    ``ops.mega_step.stamps_tensor``."""
    return torch.zeros(2, 2 * n_layers, len(STAMPS), dtype=torch.int64,
                       device=device)


def mlp_layer_plain(x: torch.Tensor, l: int, ln_s: torch.Tensor,
                    ln_b: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                    s2: torch.Tensor, b2: torch.Tensor, w1: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """Layer ``l`` of the chain in plain torch. Returns the new (1, D) x."""
    dt = x.dtype
    q = F.layer_norm(x.float(), x.shape[-1:], ln_s[l], ln_b[l], 1e-5).to(dt)
    h = torch.matmul(q.float(), w1[l].float()) * s1[l] + b1[l]
    h = F.gelu(h.to(dt), approximate="tanh")
    y = torch.matmul(h.float(), w2[l].float()) * s2[l] + b2[l]
    return x + y.to(dt)


def mlp_chain_plain(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor,
                    s1: torch.Tensor, b1: torch.Tensor, s2: torch.Tensor,
                    b2: torch.Tensor, w1: torch.Tensor,
                    w2: torch.Tensor) -> torch.Tensor:
    """Every layer of the chain in plain torch."""
    for l in range(w1.shape[0]):
        x = mlp_layer_plain(x, l, ln_s, ln_b, s1, b1, s2, b2, w1, w2)
    return x


_scratch = {}


def _work(device: torch.device, f: int) -> torch.Tensor:
    """The kernel's scratch, kept for each (device, size): the grid
    barrier's counter (16 bytes, zeroed by each launch), then h (f bf16).
    Launches on one stream do not overlap, so they can share it."""
    key = (device.index or 0, f)
    if key not in _scratch:
        _scratch[key] = torch.empty(16 + 2 * f, dtype=torch.uint8, device=device)
    return _scratch[key]


def _launch(x, l0, l1, ln_s, ln_b, s1, b1, s2, b2, w1, w2,
            packed: Optional[MlpPacked], stamps: Optional[torch.Tensor]
            ) -> torch.Tensor:
    """Check the operands, then one launch over layers [l0, l1)."""
    def check(cond, what):
        if not cond:
            raise ValueError(f"mlp_chain: {what}")

    check(x.device.type == "cuda", f"unsupported device {x.device}")
    check(w1.ndim == 3 and w2.ndim == 3, "w1, w2 must be (L, in, out)")
    n_layers, d, f = w1.shape
    check(w2.shape == (n_layers, f, d), f"w2 of shape {tuple(w2.shape)}")
    check(packed is not None, "a CUDA call takes packed=pack_mlp_weights(w1, w2), "
          "made once before the calls")
    check(isinstance(packed, MlpPacked), "packed must come from pack_mlp_weights")
    check(packed.w1t.shape == (n_layers, f, d) and packed.w2t.shape == (n_layers, d, f)
          and packed.source == (w1.data_ptr(), w2.data_ptr()),
          f"a stale pack: shapes {tuple(packed.w1t.shape)}, {tuple(packed.w2t.shape)} "
          f"not made by pack_mlp_weights from these w1 {tuple(w1.shape)}, "
          f"w2 {tuple(w2.shape)}")
    check(x.shape == (1, d) and x.dtype == torch.bfloat16,
          f"x must be (1, {d}) bf16, got {tuple(x.shape)} {x.dtype}")
    check(d % _MULTIPLE == 0 and f % _MULTIPLE == 0,
          f"d_model {d} / d_ff {f} not multiples of {_MULTIPLE}")
    check(w1.dtype == w2.dtype == packed.w1t.dtype == packed.w2t.dtype == torch.int8,
          "weights must be int8")
    for name, t, width in (("ln_s", ln_s, d), ("ln_b", ln_b, d), ("s1", s1, f),
                           ("b1", b1, f), ("s2", s2, d), ("b2", b2, d)):
        check(t.shape == (n_layers, width) and t.dtype == torch.float32,
              f"{name} must be ({n_layers}, {width}) float32")
    check(0 <= l0 < l1 <= n_layers, f"layers {l0}..{l1 - 1} outside 0..{n_layers - 1}")
    tensors = (x, ln_s, ln_b, s1, b1, s2, b2, packed.w1t, packed.w2t)
    check(all(t.device == x.device for t in tensors), "one device for all")
    check(all(t.is_contiguous() for t in tensors), "contiguous operands")
    if stamps is not None:
        check(stamps.dtype == torch.int64 and stamps.is_contiguous()
              and stamps.device == x.device
              and stamps.shape == (2, 2 * (l1 - l0), len(STAMPS)),
              f"stamps {tuple(stamps.shape)} (takes stamps_tensor({l1 - l0}))")
    out = x.clone()
    code = _build.lib().twt_mlp_chain(
        out.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), s1.data_ptr(),
        b1.data_ptr(), s2.data_ptr(), b2.data_ptr(), packed.w1t.data_ptr(),
        packed.w2t.data_ptr(), _work(x.device, f).data_ptr(),
        0 if stamps is None else stamps.data_ptr(), n_layers, d, f, l0, l1,
        x.device.index or 0, _build.stream_handle(x.device))
    _build.check(code, "twt_mlp_chain")
    return out


def mlp_chain(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor,
              s1: torch.Tensor, b1: torch.Tensor, s2: torch.Tensor,
              b2: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
              packed: Optional[MlpPacked] = None,
              stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P2: every layer of the chain, the contract of :func:`mlp_chain_plain`.
    CPU tensors take the plain version; CUDA tensors one cooperative launch
    over ``packed`` (:func:`pack_mlp_weights` of ``w1``, ``w2``), which
    raises on what the kernel does not take. ``stamps`` (from
    :func:`stamps_tensor` for every layer, CUDA only) records where the
    launch's time goes."""
    global MLP_CHAIN_LAUNCHES
    if x.device.type == "cpu":
        return mlp_chain_plain(x, ln_s, ln_b, s1, b1, s2, b2, w1, w2)
    out = _launch(x, 0, w1.shape[0], ln_s, ln_b, s1, b1, s2, b2, w1, w2,
                  packed, stamps)
    MLP_CHAIN_LAUNCHES += 1
    return out


def mlp_layer(x: torch.Tensor, l: int, ln_s: torch.Tensor, ln_b: torch.Tensor,
              s1: torch.Tensor, b1: torch.Tensor, s2: torch.Tensor,
              b2: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
              packed: Optional[MlpPacked] = None,
              stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """P3: layer ``l`` of the chain, the contract of :func:`mlp_layer_plain`.
    CPU tensors take the plain version; CUDA tensors one launch of P2's
    kernel over that layer (the layer index is a kernel argument), over
    ``packed`` as for :func:`mlp_chain`; ``stamps`` from
    ``stamps_tensor(1)``."""
    global MLP_LAYER_LAUNCHES
    if x.device.type == "cpu":
        return mlp_layer_plain(x, l, ln_s, ln_b, s1, b1, s2, b2, w1, w2)
    out = _launch(x, int(l), int(l) + 1, ln_s, ln_b, s1, b1, s2, b2, w1, w2,
                  packed, stamps)
    MLP_LAYER_LAUNCHES += 1
    return out
