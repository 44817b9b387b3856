"""Weight-only int8 and int4, W8A8 and int8 KV: the "S" and "S4" engine
modes (port of thewhisper_tpu's ``models/quant.py``).

The JAX package keeps a quantized linear as a ``{"q": int8 or int4 (in,
out), "s": f32 (out,)}`` leaf. The port keeps it as a module in place of the
``nn.Linear``, with the weight in PyTorch's (out, in) layout:

- :class:`Int8Linear`: weight-only int8 with an f32 per-out-channel
  scale. The forward dequantizes into the compute type before the product,
  as JAX's ``_linear`` does, so each weight rounds to that type.
- :class:`Int4Linear` ("S4"): weight-only int4, the nibbles packed two a
  byte (``ops.int4_linear.pack_int4``), with the same scales and JAX's
  same roundings; its forward is the Q4 kernel on the card.
- :class:`W8A8Linear`: the same storage as ``Int8Linear``; the forward
  quantizes each activation row to int8, multiplies int8 x int8 into int32
  (``torch._int_mm``) and applies both scales in f32 (JAX's
  ``_linear_int8``). Exact in the integer part, so an f32 W8A8 encoder
  matches JAX's to float rounding.
- :class:`Int8Embedding`: the tied token table, int8 with f32 row scales;
  the logits are ``(x @ q^T) * s`` in f32. An S4 decoder keeps it int8, as
  JAX's ``quantize_params`` does.

Every quantizer reduces max|w| over the input axis (axis -2 of JAX's
(in, out), -1 here) and rounds half to even, so both packages give the same
int8 and int4 values bit for bit.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Mapping, NamedTuple, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from thewhisper_tpu_torch.ops.int4_linear import (  # noqa: F401
    int4_linear,
    pack_int4,
    unpack_int4,
)

if TYPE_CHECKING:
    from thewhisper_tpu_torch.models.whisper import Whisper

QMAX = 127


def _qmax(bits: int) -> int:
    if bits not in (8, 4):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return QMAX if bits == 8 else 7


def quantize_weight(w: torch.Tensor, bits: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 (``bits=8``) or int4 (``bits=4``,
    qmax 7) of an (..., out, in) weight: w ~= q * s[..., None]. Returns
    (q int8, holding [-7, 7] for int4; s f32 (..., out))."""
    qmax = _qmax(bits)
    wf = w.float()
    s = wf.abs().amax(dim=-1).clamp_min(1e-8) / qmax
    q = torch.round(wf / s[..., None]).clamp(-qmax, qmax).to(torch.int8)
    return q, s


def quantize_weight_w8a8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The values of :func:`quantize_weight`. What makes them W8A8 is the
    module that holds them (:class:`W8A8Linear`), as ``{"q8", "s8"}`` keys
    do in the JAX package."""
    return quantize_weight(w)


def dequantize_weight(q: torch.Tensor, s: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return q.to(dtype) * s.to(dtype)[..., None]


def quantize_embedding(w: torch.Tensor, bits: int = 8
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 (or int4, ``bits=4``) of the (V, d) token table:
    w ~= q * s[:, None]."""
    return quantize_weight(w, bits)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8: x ~= q * s[..., None]."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(x32 / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


class QuantizedKV(NamedTuple):
    """int8 K or V of a (L, B, H, T, dh) cache and its f32 scale per
    (layer, batch, head, channel), (L, B, H, dh)."""

    q: torch.Tensor
    s: torch.Tensor


def quantize_kv(x: torch.Tensor) -> QuantizedKV:
    """int8 of a (..., T, dh) K or V, the scale reduced over T only, so it
    folds out of the attention products: the K scale into the query, the V
    scale into the output (``models.whisper._cross_and_mlp``)."""
    x32 = x.float()
    s = x32.abs().amax(dim=-2).clamp_min(1e-8) / 127.0
    q = torch.round(x32 / s[..., None, :]).clamp(-127, 127).to(torch.int8)
    return QuantizedKV(q, s)


class _QuantizedLinear(nn.Module):
    """What the weight-only linears share: ``weight`` (out, in / (8 /
    BITS)) of ``WEIGHT_DTYPE`` (int4 packs two inputs a byte), ``scale``
    f32 (out,), ``bias`` in the compute type or None."""

    WEIGHT_DTYPE = torch.int8
    BITS = 8

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=None, device=None):
        super().__init__()
        pack = 8 // self.BITS
        if in_features % pack:
            raise ValueError(f"{type(self).__name__}: {in_features} inputs "
                             f"(takes a multiple of {pack})")
        self.in_features, self.out_features = in_features, out_features
        self.register_buffer("weight", torch.empty(
            out_features, in_features // pack, dtype=self.WEIGHT_DTYPE,
            device=device))
        self.register_buffer("scale", torch.empty(
            out_features, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.empty(
            out_features, dtype=dtype, device=device) if bias else None)

    @classmethod
    def like(cls, lin: nn.Module) -> "_QuantizedLinear":
        """An empty module of this class with ``lin``'s shape and types."""
        dtype = lin.bias.dtype if lin.bias is not None else None
        return cls(lin.in_features, lin.out_features, lin.bias is not None,
                   dtype=dtype, device=lin.weight.device)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "_QuantizedLinear":
        m = cls.like(lin)
        q, m.scale = quantize_weight(lin.weight.detach(), cls.BITS)
        m.weight = q if cls.BITS == 8 else pack_int4(q)
        if lin.bias is not None:
            m.bias = lin.bias.detach()
        return m


class Int8Linear(_QuantizedLinear):
    """Weight-only int8 linear: ``weight`` int8 (out, in), ``scale`` f32
    (out,), ``bias`` in the compute type or None."""

    def _bias(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.bias is None else y + self.bias.to(y.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype) * self.scale.to(x.dtype)[:, None]
        return self._bias(F.linear(x, w))


class W8A8Linear(Int8Linear):
    """int8 weights and int8 activations (the "S" encoder)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, xs = quantize_rows(x)
        # On CUDA, torch._int_mm raises for shapes it does not take (rows
        # <= 16, widths not multiples of 8); nothing falls back.
        acc = torch._int_mm(xq.reshape(-1, self.in_features), self.weight.t())
        y = acc.float() * xs.reshape(-1, 1) * self.scale
        return self._bias(y.to(x.dtype).reshape(*x.shape[:-1], -1))


class Int4Linear(_QuantizedLinear):
    """Weight-only int4 linear ("S4"): ``weight`` the packed nibbles, uint8
    (out, in / 2) (``pack_int4``), ``scale`` f32 (out,), ``bias`` in the
    compute type or None. Not an :class:`Int8Linear`: K3 and K4 take int8
    linears only. The forward is Q4 (``ops.int4_linear``) on CUDA tensors,
    its plain version on CPU ones."""

    WEIGHT_DTYPE = torch.uint8
    BITS = 4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int4_linear(x, self.weight, self.scale, self.bias)


class Int8Embedding(nn.Module):
    """The tied token table as int8 ``q`` (V, d) with f32 row scales ``s``."""

    def __init__(self, num_embeddings: int, dim: int, device=None):
        super().__init__()
        self.register_buffer("q", torch.empty(
            num_embeddings, dim, dtype=torch.int8, device=device))
        self.register_buffer("s", torch.empty(
            num_embeddings, dtype=torch.float32, device=device))

    @classmethod
    def from_weight(cls, w: torch.Tensor) -> "Int8Embedding":
        m = cls(*w.shape, device=w.device)
        m.q, m.s = quantize_embedding(w)
        return m

    def lookup(self, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, S) ids -> (B, S, d) rows dequantized in ``dtype``."""
        return self.q[tokens].to(dtype) * self.s[tokens].to(dtype)[..., None]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Row scales commute with the product: (x @ q^T) * s, in f32."""
        return torch.matmul(x.float(), self.q.float().t()) * self.s


def is_quantized(m: nn.Module) -> bool:
    """Weight-only int8 or int4 linear, or int8 table."""
    return (isinstance(m, (Int8Linear, Int4Linear, Int8Embedding))
            and not isinstance(m, W8A8Linear))


def is_quantized_w8a8(m: nn.Module) -> bool:
    return isinstance(m, W8A8Linear)


def set_module(root: nn.Module, path: str, module: nn.Module) -> None:
    """Put ``module`` at the dotted ``path`` below ``root``."""
    parent, _, name = path.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, name, module)


def swap_in_quantized(model: nn.Module, layout: Mapping[str, type]) -> None:
    """Replace the float linear or table at each path of ``layout`` by an
    empty module of the mapped class (a skeleton for ``load_state_dict``)."""
    for path, cls in layout.items():
        if cls is Int8Embedding:
            parent, _, name = path.rpartition(".")
            owner = model.get_submodule(parent)
            v, d = getattr(owner, name).shape
            delattr(owner, name)
            setattr(owner, name, Int8Embedding(v, d))
        else:
            set_module(model, path, cls.like(model.get_submodule(path)))


def quantize_params(model: "Whisper",
                    components: Sequence[str] = ("decoder",),
                    quantize_embedding_table: bool = True,
                    activation_int8: bool = False,
                    bits: int = 8) -> "Whisper":
    """Quantize every float linear of the given components in place
    (convs, norms and position tables stay); the decoder's tied table
    too unless ``quantize_embedding_table`` is false. ``activation_int8``
    makes them :class:`W8A8Linear` (the encoder of ``"int8-all"``);
    ``bits=4`` makes them :class:`Int4Linear` ("S4"), the table staying
    int8, as in JAX. Modules already quantized are left as they are.
    Returns ``model``."""
    _qmax(bits)
    cls = (W8A8Linear if activation_int8
           else Int4Linear if bits == 4 else Int8Linear)
    for comp in components:
        root = getattr(model, comp)
        for name, mod in list(root.named_modules()):
            if type(mod) is nn.Linear:
                set_module(root, name, cls.from_linear(mod))
        if (comp == "decoder" and quantize_embedding_table
                and not isinstance(root.token_emb, Int8Embedding)):
            emb = Int8Embedding.from_weight(root.token_emb.detach())
            del root.token_emb
            root.token_emb = emb
    return model


def quantized_bytes(model: nn.Module) -> int:
    """Bytes of every parameter and buffer of the model (a packed int4
    weight is half a byte a value, as JAX counts ``jnp.int4``)."""
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))
