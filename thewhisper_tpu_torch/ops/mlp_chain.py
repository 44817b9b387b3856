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
applied after the sum. The weights keep the probe's (L, in, out) layout:
``w1`` (L, D, F), ``w2`` (L, F, D) int8; ``ln_s``, ``ln_b``, ``s2``, ``b2``
(L, D) and ``s1``, ``b1`` (L, F) f32; ``x`` (1, D) bf16.

``mlp_chain`` runs every layer; on a CUDA tensor it is one cooperative
launch of ``csrc/mlp_chain.cu``. ``mlp_layer`` runs layer ``l``; on a CUDA
tensor it is one launch of the same kernel over that layer, so L launches
of it give the chain's bits exactly. CPU tensors take the plain versions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from thewhisper_tpu_torch.ops import _build

# Launches of the CUDA kernel (not of the plain versions) since import: P2
# (the whole chain) and P3 (one layer).
MLP_CHAIN_LAUNCHES = 0
MLP_LAYER_LAUNCHES = 0

_CHUNK = 128    # contraction rows a partial sum covers (csrc/mlp_chain.cu)


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


def _launch(x, l0, l1, ln_s, ln_b, s1, b1, s2, b2, w1, w2) -> torch.Tensor:
    """Check the operands, then one launch over layers [l0, l1)."""
    def check(cond, what):
        if not cond:
            raise ValueError(f"mlp_chain: {what}")

    check(x.device.type == "cuda", f"unsupported device {x.device}")
    check(w1.ndim == 3 and w2.ndim == 3, "w1, w2 must be (L, in, out)")
    n_layers, d, f = w1.shape
    check(w2.shape == (n_layers, f, d), f"w2 of shape {tuple(w2.shape)}")
    check(x.shape == (1, d) and x.dtype == torch.bfloat16,
          f"x must be (1, {d}) bf16, got {tuple(x.shape)} {x.dtype}")
    check(d % _CHUNK == 0 and f % _CHUNK == 0,
          f"d_model {d} / d_ff {f} not multiples of {_CHUNK}")
    check(w1.dtype == w2.dtype == torch.int8, "weights must be int8")
    for name, t, width in (("ln_s", ln_s, d), ("ln_b", ln_b, d), ("s1", s1, f),
                           ("b1", b1, f), ("s2", s2, d), ("b2", b2, d)):
        check(t.shape == (n_layers, width) and t.dtype == torch.float32,
              f"{name} must be ({n_layers}, {width}) float32")
    check(0 <= l0 < l1 <= n_layers, f"layers {l0}..{l1 - 1} outside 0..{n_layers - 1}")
    tensors = (x, ln_s, ln_b, s1, b1, s2, b2, w1, w2)
    check(all(t.device == x.device for t in tensors), "one device for all")
    check(all(t.is_contiguous() for t in tensors), "contiguous operands")
    out = x.clone()
    h = torch.empty(f, dtype=torch.bfloat16, device=x.device)
    part = torch.empty(d * f // _CHUNK, dtype=torch.float32, device=x.device)
    code = _build.lib().twt_mlp_chain(
        out.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), s1.data_ptr(),
        b1.data_ptr(), s2.data_ptr(), b2.data_ptr(), w1.data_ptr(),
        w2.data_ptr(), h.data_ptr(), part.data_ptr(),
        _build.grid_barrier(x.device).data_ptr(), n_layers, d, f, l0, l1,
        x.device.index or 0, _build.stream_handle(x.device))
    _build.check(code, "twt_mlp_chain")
    return out


def mlp_chain(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor,
              s1: torch.Tensor, b1: torch.Tensor, s2: torch.Tensor,
              b2: torch.Tensor, w1: torch.Tensor,
              w2: torch.Tensor) -> torch.Tensor:
    """P2: every layer of the chain, the contract of :func:`mlp_chain_plain`.
    CPU tensors take the plain version; CUDA tensors one cooperative launch,
    which raises on what the kernel does not take."""
    global MLP_CHAIN_LAUNCHES
    if x.device.type == "cpu":
        return mlp_chain_plain(x, ln_s, ln_b, s1, b1, s2, b2, w1, w2)
    out = _launch(x, 0, w1.shape[0], ln_s, ln_b, s1, b1, s2, b2, w1, w2)
    MLP_CHAIN_LAUNCHES += 1
    return out


def mlp_layer(x: torch.Tensor, l: int, ln_s: torch.Tensor, ln_b: torch.Tensor,
              s1: torch.Tensor, b1: torch.Tensor, s2: torch.Tensor,
              b2: torch.Tensor, w1: torch.Tensor,
              w2: torch.Tensor) -> torch.Tensor:
    """P3: layer ``l`` of the chain, the contract of :func:`mlp_layer_plain`.
    CPU tensors take the plain version; CUDA tensors one launch of P2's
    kernel over that layer (the layer index is a kernel argument)."""
    global MLP_LAYER_LAUNCHES
    if x.device.type == "cpu":
        return mlp_layer_plain(x, l, ln_s, ln_b, s1, b1, s2, b2, w1, w2)
    out = _launch(x, int(l), int(l) + 1, ln_s, ln_b, s1, b1, s2, b2, w1, w2)
    MLP_LAYER_LAUNCHES += 1
    return out
