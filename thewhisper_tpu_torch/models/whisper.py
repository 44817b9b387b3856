"""Whisper encoder/decoder as torch modules (port of thewhisper_tpu's
``models/whisper.py``).

The module tree holds the weights in PyTorch's layout (``nn.Linear`` keeps
(out, in)); the functions below mirror the JAX package's entry points:

- :func:`encoder_forward`: conv stem, 32 pre-LN layers whose attention is
  the K2 kernel (``ops.attention.encoder_attention``) on CUDA tensors, and
  the final LayerNorm. S = 1500 runs unpadded: the kernel masks the ragged
  tile, so the TPU's pad-to-512 and segment ids have no counterpart.
- :func:`decoder_train_forward`: the teacher-forced decoder over a whole
  token sequence (training), causal self-attention and cross-attention in
  plain torch, as in JAX (neither takes K2: one is masked, the other has
  Sq != Sk).
- :func:`compute_cross_kv`, :func:`decoder_prefill`, :func:`decoder_step`,
  :func:`decoder_verify`: the decoder over a (L, B, H, S, dh) cache
  written in place (the GPU's layout; the TPU's feature-major
  (L, B, H, dh, S) and its where-iota and one-hot writes do not carry
  over). The step takes its position on the device, so its shapes are
  fixed and a CUDA graph of it replays at any position. Every decoder
  pass returns cross-attention probabilities reduced to the checkpoint's
  alignment heads, the DTW input.

Numerics follow JAX: LayerNorm in f32, attention scores and softmax in f32
with probabilities cast to the value type, f32 logits from the tied
embedding (a bf16 matmul would round them before argmax), GELU exact in
f32 and tanh-approximate in bf16.

A model quantized by ``models.quant.quantize_params`` (the "S" and "S4"
modes) runs through the same functions: its linears are ``Int8Linear``,
``W8A8Linear`` or ``Int4Linear`` (Q4 on the card) modules, its tied table
an ``Int8Embedding``, and the cross K/V may be ``QuantizedKV`` (int8
with the scales folded out of the products, as JAX's ``_cross_and_mlp``
does). :func:`fuse_self_qkv` turns each decoder layer's self q/k/v into
one projection.

Training (``training/``): :func:`encoder_forward` and
:func:`decoder_train_forward` take a ``compute_dtype`` apart from the
weights' type, as JAX's do: f32 master weights under a bf16 compute type
are cast to it by every linear, conv and embedding (:func:`_linear`),
while LayerNorm and the logits stay f32; and ``remat=True`` recomputes
each layer in the backward (``torch.utils.checkpoint``, JAX's
``jax.checkpoint``).

On a model sharded by ``parallel.mesh.shard_params`` the training
forward carries Megatron's conjugates: each LayerNorm output that enters
column-parallel linears goes through *f* (``copy_to_tp``), the encoder
states once before the decoder, and the row-parallel ``out``/``fc2`` sum
through *g*. ``encoder_forward(..., seq=mesh)`` is the sequence-parallel
encoder (whole weights, inference only).
"""

from __future__ import annotations

from typing import (Callable, Dict, Iterator, Mapping, NamedTuple, Optional,
                    Tuple)

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from thewhisper_tpu_torch.config import WhisperArch
from thewhisper_tpu_torch.models.quant import (
    Int4Linear,
    Int8Embedding,
    Int8Linear,
    QuantizedKV,
    swap_in_quantized,
)
from thewhisper_tpu_torch.ops.attention import encoder_attention
from thewhisper_tpu_torch.parallel.mesh import (
    Mesh,
    RowParallelLinear,
    copy_to_tp,
    gather_kv,
    seq_block,
    seq_rows,
)

AttentionFn = Callable[..., torch.Tensor]


class DecodeCache(NamedTuple):
    """Self K/V (L, B, H, S_max, dh), updated in place slot by slot, and
    cross K/V (L, B, H, T_enc, dh), computed once per audio window (a
    :class:`~thewhisper_tpu_torch.models.quant.QuantizedKV` on int8 cross-KV
    engines)."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in f32 and cast back to the input type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in f32, tanh approximation in lower precision (the
    JAX package's rule, ``models/whisper.py::_gelu``)."""
    return F.gelu(x, approximate="none" if x.dtype == torch.float32 else "tanh")


def _linear(mod: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``mod(x)``; a float ``nn.Linear`` whose weight has another type than
    x is cast to x's type first (JAX's ``_linear``: f32 master weights under
    a bf16 compute type). Quantized linears run as they are."""
    if type(mod) is nn.Linear and mod.weight.dtype != x.dtype:
        bias = None if mod.bias is None else mod.bias.to(x.dtype)
        return F.linear(x, mod.weight.to(x.dtype), bias)
    return mod(x)


def _conv(mod: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """``mod(x)`` with the weight and bias cast to x's type."""
    if mod.weight.dtype != x.dtype:
        return F.conv1d(x, mod.weight.to(x.dtype), mod.bias.to(x.dtype),
                        mod.stride, mod.padding)
    return mod(x)


class Attention(nn.Module):
    """Whisper attention projections; k has no bias. ``n_heads`` is the
    heads this module holds: all of them, or a tp rank's share of a model
    sharded by ``parallel.mesh.shard_params``."""

    def __init__(self, d: int, n_heads: int, **kw):
        super().__init__()
        self.n_heads = n_heads
        self.head_dim = d // n_heads
        self.q = nn.Linear(d, d, **kw)
        self.k = nn.Linear(d, d, bias=False, **kw)
        self.v = nn.Linear(d, d, **kw)
        self.out = nn.Linear(d, d, **kw)

    def heads(self, proj: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        """(B, S, d) -> (B, S, H, dh) view of a projection."""
        b, s, _ = x.shape
        return _linear(proj, x).view(b, s, self.n_heads, self.head_dim)


class EncoderLayer(nn.Module):
    def __init__(self, d: int, n_heads: int, d_ff: int, **kw):
        super().__init__()
        self.ln1 = LayerNorm(d, **kw)
        self.attn = Attention(d, n_heads, **kw)
        self.ln2 = LayerNorm(d, **kw)
        self.fc1 = nn.Linear(d, d_ff, **kw)
        self.fc2 = nn.Linear(d_ff, d, **kw)

    def forward(self, x: torch.Tensor, attention: AttentionFn,
                seq: Optional[Tuple[Mesh, int]] = None) -> torch.Tensor:
        """One pre-LN layer. On a tp-sharded layer (its ``fc2`` a
        ``RowParallelLinear``) the LayerNorm outputs enter the
        column-parallel q/k/v and fc1 through *f* (``copy_to_tp``) and
        ``out``/``fc2`` sum over tp through *g*. ``seq`` = (mesh, T): x is
        this rank's padded block of time rows (the sequence-parallel
        encoder); K and V are gathered over tp and the local queries
        attend every key below T."""
        tp = self.fc2.tp if isinstance(self.fc2, RowParallelLinear) else None
        a_in = copy_to_tp(self.ln1(x), tp)
        at = self.attn
        q, k, v = (at.heads(p, a_in) for p in (at.q, at.k, at.v))
        if seq is None:
            a = attention(q, k, v)
        else:
            k, v = gather_kv(seq[0], k, v)
            a = attention(q, k, v, seq[1])
        x = x + _linear(at.out, a.reshape(*x.shape[:-1], -1))
        m_in = copy_to_tp(self.ln2(x), tp)
        return x + _linear(self.fc2, _gelu(_linear(self.fc1, m_in)))


class AudioEncoder(nn.Module):
    def __init__(self, arch: WhisperArch, n_source_positions: int, **kw):
        super().__init__()
        d = arch.d_model
        self.conv1 = nn.Conv1d(arch.n_mels, d, 3, padding=1, **kw)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1, **kw)
        self.pos_emb = nn.Parameter(torch.empty(n_source_positions, d, **kw))
        self.layers = nn.ModuleList(
            EncoderLayer(d, arch.encoder_heads, arch.d_ff, **kw)
            for _ in range(arch.encoder_layers))
        self.ln_post = LayerNorm(d, **kw)

    def forward(self, mel: torch.Tensor,
                attention: AttentionFn = encoder_attention,
                compute_dtype: Optional[torch.dtype] = None,
                remat: bool = False,
                seq: Optional[Mesh] = None) -> torch.Tensor:
        if seq is not None:
            self._check_sequence_parallel(seq)
        x = mel.to(compute_dtype or self.conv1.weight.dtype)
        x = _gelu(_conv(self.conv1, x))
        x = _gelu(_conv(self.conv2, x)).transpose(1, 2)       # (B, T, d)
        t, n_pos = x.shape[1], self.pos_emb.shape[0]
        if t > n_pos:
            raise ValueError(
                f"mel input produces {t} encoder positions but the loaded "
                f"position table has {n_pos}")
        x = x + self.pos_emb[:t].to(x.dtype)
        time = None
        if seq is not None:
            # This rank's time rows, padded to the block every rank holds:
            # pad rows sit past T in the gathered keys, where K2's
            # valid_len masks them.
            rows = seq_rows(seq, t)
            n = rows.stop - rows.start
            x = F.pad(x[:, rows], (0, 0, 0, seq_block(seq, t) - n))
            time = (seq, t)
        for layer in self.layers:
            x = (checkpoint(layer, x, attention, time, use_reentrant=False)
                 if remat else layer(x, attention, time))
        if seq is not None:
            x = x[:, :n]
        return self.ln_post(x)

    def _check_sequence_parallel(self, mesh: Mesh) -> None:
        """Refuse what the sequence-parallel encoder does not run, before
        any collective: a layout without a process group, tp-sharded
        weights and autograd."""
        if not mesh.live:
            raise RuntimeError("the sequence-parallel encoder needs a live "
                               "process group (parallel.launch.init, then "
                               "make_mesh)")
        if any(isinstance(layer.fc2, RowParallelLinear) for layer in self.layers):
            raise ValueError("the sequence-parallel encoder runs on whole "
                             "weights: this encoder is tp-sharded")
        if torch.is_grad_enabled() and any(p.requires_grad
                                           for p in self.parameters()):
            raise ValueError("the sequence-parallel encoder has no backward: "
                             "run it under torch.no_grad or inference_mode")


class DecoderLayer(nn.Module):
    def __init__(self, d: int, n_heads: int, d_ff: int, **kw):
        super().__init__()
        self.ln1 = LayerNorm(d, **kw)
        self.self_attn = Attention(d, n_heads, **kw)
        self.ln_cross = LayerNorm(d, **kw)
        self.cross_attn = Attention(d, n_heads, **kw)
        self.ln2 = LayerNorm(d, **kw)
        self.fc1 = nn.Linear(d, d_ff, **kw)
        self.fc2 = nn.Linear(d_ff, d, **kw)


class TextDecoder(nn.Module):
    def __init__(self, arch: WhisperArch, **kw):
        super().__init__()
        d = arch.d_model
        self.token_emb = nn.Parameter(torch.empty(arch.vocab_size, d, **kw))
        self.pos_emb = nn.Parameter(
            torch.empty(arch.max_target_positions, d, **kw))
        self.layers = nn.ModuleList(
            DecoderLayer(d, arch.decoder_heads, arch.d_ff, **kw)
            for _ in range(arch.decoder_layers))
        self.ln_post = LayerNorm(d, **kw)


class Whisper(nn.Module):
    """The model: ``encoder`` and ``decoder`` sub-modules plus its arch.

    ``n_source_positions`` is the encoder position table's length (shorter
    than ``arch.max_source_positions`` for flexible chunks)."""

    def __init__(self, arch: WhisperArch,
                 n_source_positions: Optional[int] = None,
                 device=None, dtype=None):
        super().__init__()
        kw = {"device": device, "dtype": dtype}
        self.arch = arch
        self.encoder = AudioEncoder(
            arch, n_source_positions or arch.max_source_positions, **kw)
        self.decoder = TextDecoder(arch, **kw)
        # The K3 operands (ops.mega_step.pack_mega_params), or None.
        self.mega = None
        # The tp group of a model sharded by parallel.mesh.shard_params
        # (a parallel.mesh.TensorParallel), or None.
        self.tp = None

    @property
    def dtype(self) -> torch.dtype:
        """The compute type (the position table's: the token table may be
        int8)."""
        return self.decoder.pos_emb.dtype

    @property
    def device(self) -> torch.device:
        return self.decoder.pos_emb.device


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    v = np.asarray(v)
    return torch.from_numpy(np.array(
        v, dtype=v.dtype if v.dtype in (np.int8, np.uint8) else np.float32))


def model_from_state(state: Mapping[str, object], arch: WhisperArch,
                     dtype: torch.dtype = torch.float32, device=None,
                     quantized: Optional[Mapping[str, type]] = None) -> Whisper:
    """Build a :class:`Whisper` on ``device`` from a state dict in the
    port's naming (values: tensors or numpy arrays). ``quantized`` maps the
    path of each quantized linear or table to its ``models.quant`` class;
    each value takes the type the module declares (int8 weights, packed
    int4 weights as uint8, f32 scales, ``dtype`` for the rest). A state without ``encoder.*`` keys
    gives a decoder-only model (``encoder`` None), as a draft is. Every
    parameter is frozen (``training.train.init_train_state`` unfreezes a
    model to fine-tune)."""
    enc_pos = state.get("encoder.pos_emb")
    with torch.device("meta"):
        model = Whisper(arch, dtype=dtype, n_source_positions=(
            None if enc_pos is None else enc_pos.shape[0]))
        if enc_pos is None:
            model.encoder = None
        swap_in_quantized(model, quantized or {})
    types = {k: v.dtype for k, v in model.state_dict().items()}
    model.load_state_dict(
        {k: _as_tensor(v).to(device=device, dtype=types[k])
         for k, v in state.items()}, assign=True)
    return model.requires_grad_(False).eval()


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encoder_forward(model: Whisper, mel: torch.Tensor,
                    attention: AttentionFn = encoder_attention,
                    compute_dtype: Optional[torch.dtype] = None,
                    remat: bool = False,
                    seq: Optional[Mesh] = None) -> torch.Tensor:
    """(B, n_mels, T_mel) features -> (B, T_mel // 2, d) encoder states.

    ``attention`` is the encoder's attention function: the kernel wrapper by
    default; ``ops.attention.encoder_attention_plain`` gives the plain
    version on any device (to hold the kernel path against it).
    ``compute_dtype`` (default: the weights' type) is the activations'
    type; ``remat`` recomputes each layer in the backward pass instead of
    keeping its internals (JAX's ``jax.checkpoint`` on the layer body).

    ``seq``: a live ``parallel.mesh.Mesh`` for the sequence-parallel
    encoder (JAX's ``act_sharding=seq_sharding(mesh)``): ``mel`` holds
    this rank's dp rows, each tp rank keeps its block of the T time rows
    after the stem (``parallel.mesh.seq_rows``), every layer runs on those
    rows with K and V gathered over tp, and the result is this rank's
    (B, rows, d) block (``parallel.mesh.gather_seq`` assembles it). Whole
    (unsharded) weights and no autograd, or ``ValueError``."""
    return model.encoder(mel, attention, compute_dtype, remat, seq)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _alignment_selector(arch: WhisperArch) -> np.ndarray:
    """(L, H, A) one-hot selecting each alignment head's (layer, head) of
    all H heads."""
    heads = arch.alignment_heads
    sel = np.zeros((arch.decoder_layers, arch.decoder_heads, max(1, len(heads))),
                   dtype=np.float32)
    for i, (layer, head) in enumerate(heads):
        sel[layer, head, i] = 1.0
    return sel


def cross_kv_layers(model: Whisper, enc_out: torch.Tensor
                    ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Each decoder layer's cross-attention K/V in turn: (B, H, T, dh) each."""
    for layer in model.decoder.layers:
        ca = layer.cross_attn
        yield (ca.heads(ca.k, enc_out).transpose(1, 2),
               ca.heads(ca.v, enc_out).transpose(1, 2))


def compute_cross_kv(model: Whisper, enc_out: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of every decoder layer: (L, B, H, T, dh) each."""
    ks, vs = zip(*cross_kv_layers(model, enc_out))
    return torch.stack(ks), torch.stack(vs)


def make_cache(arch: WhisperArch, batch: int, max_len: int,
               cross_k, cross_v,
               dtype: Optional[torch.dtype] = None) -> DecodeCache:
    """Zeroed self K/V of ``max_len`` slots beside the cross K/V (tensors
    or ``QuantizedKV``; the self cache takes ``dtype``, else the cross
    K/V's type, and the cross K/V's head count: a tp rank's share of a
    sharded model's)."""
    like = cross_k.s if isinstance(cross_k, QuantizedKV) else cross_k
    shape = (arch.decoder_layers, batch, like.shape[2], max_len,
             arch.head_dim)
    kw = {"device": like.device, "dtype": dtype or like.dtype}
    return DecodeCache(torch.zeros(shape, **kw), torch.zeros(shape, **kw),
                       cross_k, cross_v)


def _attend(q, k, v, mask=None, extra_logit=None, extra_v=None):
    """q (B, H, Sq, dh) against k/v (B, H, Skv, dh): f32 scores and softmax,
    probabilities cast to v's type for the value product. ``extra_logit``
    (B, H, Sq, 1) / ``extra_v`` (B, H, Sq, dh) append one key that is not in
    the cache (the token being decoded). Returns (out, f32 probs)."""
    dh = q.shape[-1]
    logits = torch.matmul((q * dh ** -0.5).float(),
                          k.float().transpose(-1, -2))
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e9)
    if extra_logit is None:
        probs = torch.softmax(logits, dim=-1)
        return torch.matmul(probs.to(v.dtype), v), probs
    probs = torch.softmax(torch.cat([logits, extra_logit], dim=-1), dim=-1)
    out = (torch.matmul(probs[..., :-1].to(v.dtype), v)
           + probs[..., -1:].to(v.dtype) * extra_v)
    return out, probs


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, dh) -> (B, S, H * dh)."""
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def fuse_self_qkv(model: Whisper) -> Whisper:
    """Concatenate each decoder layer's self q/k/v into one (3d, d)
    projection ``qkv`` with a zero k bias, in place (JAX's
    ``fuse_self_qkv_params``). Works on float and weight-only int8 and int4
    linears (the per-out-channel scales concatenate along; int4 packs along
    the input axis, so packed rows concatenate as they are); anything else
    is left alone. Returns ``model``."""
    for layer in model.decoder.layers:
        sa = layer.self_attn
        parts = [getattr(sa, n, None) for n in ("q", "k", "v")]
        kinds = {type(p) for p in parts}
        if len(kinds) != 1 or kinds.pop() not in (nn.Linear, Int8Linear,
                                                   Int4Linear):
            continue
        q, k, v = parts
        with torch.device("meta"):
            fused = (nn.Linear(q.in_features, 3 * q.out_features,
                               dtype=q.weight.dtype)
                     if type(q) is nn.Linear else
                     type(q)(q.in_features, 3 * q.out_features,
                             dtype=q.bias.dtype))
        weight = torch.cat([p.weight for p in parts])
        bias = torch.cat([q.bias, torch.zeros_like(q.bias), v.bias])
        if type(fused) is not nn.Linear:
            fused.weight, fused.bias = weight, bias
            fused.scale = torch.cat([p.scale for p in parts])
        else:
            fused.weight = nn.Parameter(weight, requires_grad=False)
            fused.bias = nn.Parameter(bias, requires_grad=False)
        del sa.q, sa.k, sa.v
        sa.qkv = fused
    return model


def _self_qkv(layer: DecoderLayer, x: torch.Tensor, tp=None):
    """LN1 then self-attention q, k, v as (B, H, S, dh); one projection
    when the layer is fused (:func:`fuse_self_qkv`). ``tp``: the training
    forward's tp group, whose *f* the LN1 output enters through."""
    sa = layer.self_attn
    q_in = copy_to_tp(layer.ln1(x), tp)
    qkv = getattr(sa, "qkv", None)
    if qkv is not None:
        b, s, _ = q_in.shape
        out = _linear(qkv, q_in).view(b, s, 3, sa.n_heads, -1)
        return tuple(out[:, :, i].transpose(1, 2) for i in range(3))
    return tuple(sa.heads(p, q_in).transpose(1, 2) for p in (sa.q, sa.k, sa.v))


def _cross_and_mlp(x, layer: DecoderLayer, cross_k, cross_v, sel):
    """Cross-attention (capturing the alignment heads through the (H, A)
    one-hot ``sel``) and the MLP: returns (x, align (B, Sq, A, T)).

    int8 cross K/V (``QuantizedKV`` of one layer) folds its scales out of
    the products: the K scale into the query, the V scale into the output."""
    ca = layer.cross_attn
    cq = ca.heads(ca.q, layer.ln_cross(x)).transpose(1, 2)
    if isinstance(cross_k, QuantizedKV):
        cq = cq * cross_k.s[:, :, None, :].to(cq.dtype)
        c, probs = _attend(cq, cross_k.q.to(cq.dtype), cross_v.q.to(cq.dtype))
        c = c * cross_v.s[:, :, None, :].to(c.dtype)
    else:
        c, probs = _attend(cq, cross_k.to(cq.dtype), cross_v.to(cq.dtype))
    align = torch.einsum("bhqk,ha->bqak", probs, sel)
    x = x + ca.out(_merge_heads(c))
    x = x + layer.fc2(_gelu(layer.fc1(layer.ln2(x))))
    return x, align


def _logits(model: Whisper, x: torch.Tensor) -> torch.Tensor:
    """Tied-embedding logits in f32: exact products of x's type (an f32
    master table under a bf16 compute type is rounded to bf16 first, as
    JAX's ``_logits`` casts it)."""
    emb = model.decoder.token_emb
    if isinstance(emb, Int8Embedding):
        return emb.logits(x)
    return torch.matmul(x.float(), emb.to(x.dtype).float().t())


def _lookup(model: Whisper, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) ids -> (B, S, d) token rows in the compute type (an int8
    table's rows dequantize into it)."""
    emb = model.decoder.token_emb
    if isinstance(emb, Int8Embedding):
        return emb.lookup(tokens, model.dtype)
    return emb[tokens]


def embed_tokens(model: Whisper, tokens: torch.Tensor,
                 offset: int) -> torch.Tensor:
    """(B, S) ids at positions [offset, offset + S) -> (B, S, d) in the
    compute type. The start is clamped so that the S rows fit the position
    table, as JAX's ``dynamic_slice_in_dim`` does."""
    pos = model.decoder.pos_emb
    s = tokens.shape[1]
    start = min(max(int(offset), 0), pos.shape[0] - s)
    return _lookup(model, tokens) + pos[start:start + s]


def embed_tokens_at(model: Whisper, tokens: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """(B, W) window ids whose first token sits at ``positions`` (B,) ->
    (B, W, d); each row's position is clipped to the table's last
    (JAX's ``_embed_tokens_at``)."""
    pos = model.decoder.pos_emb
    rows = positions[:, None] + torch.arange(tokens.shape[1],
                                             device=tokens.device)
    return _lookup(model, tokens) + pos[rows.clamp(0, pos.shape[0] - 1)]


def _layer(kv, l: int):
    """Layer ``l`` of a cross K or V, float or ``QuantizedKV``."""
    if isinstance(kv, QuantizedKV):
        return QuantizedKV(kv.q[l], kv.s[l])
    return kv[l]


def _selector(model: Whisper) -> torch.Tensor:
    """:func:`_alignment_selector` on the model's device, made once: a
    host-to-device copy per decode step would synchronize the stream. A
    sharded model's rows are its tp rank's heads (the others' alignment
    heads select nothing here: :func:`_tp_sum` adds them)."""
    sel = getattr(model, "_align_sel", None)
    if sel is None or sel.device != model.device:
        sel = _alignment_selector(model.arch)
        if model.tp is not None:
            h = sel.shape[1] // model.tp.size
            sel = sel[:, model.tp.rank * h:(model.tp.rank + 1) * h]
        sel = torch.from_numpy(np.ascontiguousarray(sel)).to(model.device)
        model._align_sel = sel
    return sel


def _tp_sum(model: Whisper, align: torch.Tensor) -> torch.Tensor:
    """A sharded model's alignment, summed over its tp ranks' heads."""
    return align if model.tp is None else model.tp.all_reduce(align)


def decoder_prefill(model: Whisper, tokens: torch.Tensor, cache: DecodeCache
                    ) -> Tuple[torch.Tensor, DecodeCache, torch.Tensor]:
    """Run the forced prompt (B, P) in one pass, filling cache slots [0, P).

    Returns (logits (B, P, V) f32, cache, align (B, P, A, T_enc))."""
    dec = model.decoder
    p = tokens.shape[1]
    x = embed_tokens(model, tokens, 0)
    causal = torch.ones(p, p, dtype=torch.bool, device=x.device).tril()
    sel = _selector(model)
    align = 0.0
    for l, layer in enumerate(dec.layers):
        q, k, v = _self_qkv(layer, x)
        cache.self_k[l, :, :, :p] = k
        cache.self_v[l, :, :, :p] = v
        a, _ = _attend(q, cache.self_k[l, :, :, :p].to(q.dtype),
                       cache.self_v[l, :, :, :p].to(q.dtype), causal)
        x = x + layer.self_attn.out(_merge_heads(a))
        x, al = _cross_and_mlp(x, layer, _layer(cache.cross_k, l),
                               _layer(cache.cross_v, l), sel[l])
        align = align + al
    x = dec.ln_post(x)
    return _logits(model, x), cache, _tp_sum(model, align)


def step_position(position, device) -> torch.Tensor:
    """A decode step's cache slot as a (1,) int64 tensor on ``device``: a
    host int is filled in (no synchronisation), a one-element integer
    tensor is taken as it is."""
    if isinstance(position, torch.Tensor):
        return position.reshape(1).to(device=device, dtype=torch.long)
    return torch.full((1,), int(position), dtype=torch.long, device=device)


def decoder_step(model: Whisper, token: torch.Tensor, position,
                 cache: DecodeCache
                 ) -> Tuple[torch.Tensor, DecodeCache, torch.Tensor]:
    """One decode step for ``token`` (B, 1) at cache slot ``position``, a
    host int or a one-element integer tensor on the model's device (JAX's
    device scalar): the step's shapes do not depend on it, so one CUDA
    graph of the step serves every position.

    The token is embedded at that row of the position table (clamped to its
    last, as JAX's ``dynamic_slice`` clamps). The step attends all S_max
    cache slots under the mask ``slot < position`` plus the token's own
    fresh k/v as one extra logit, then writes that k/v into slot
    ``position`` (``index_copy_`` at the device index, JAX's where-iota
    write). Returns (logits (B, V) f32, cache, align (B, A, T_enc))."""
    dec = model.decoder
    b = token.shape[0]
    s_max = cache.self_k.shape[3]
    pos = step_position(position, token.device)
    x = embed_tokens_at(model, token, pos.expand(b))
    mask = (torch.arange(s_max, device=token.device) < pos)[None, None, None, :]
    sel = _selector(model)
    align = 0.0
    for l, layer in enumerate(dec.layers):
        q, k, v = _self_qkv(layer, x)                         # (B, H, 1, dh)
        dh = q.shape[-1]
        self_logit = ((q * dh ** -0.5).float() * k.float()).sum(-1, keepdim=True)
        a, _ = _attend(q, cache.self_k[l].to(q.dtype),
                       cache.self_v[l].to(q.dtype), mask,
                       extra_logit=self_logit, extra_v=v)
        cache.self_k[l].index_copy_(2, pos, k.to(cache.self_k.dtype))
        cache.self_v[l].index_copy_(2, pos, v.to(cache.self_v.dtype))
        x = x + layer.self_attn.out(_merge_heads(a))
        x, al = _cross_and_mlp(x, layer, _layer(cache.cross_k, l),
                               _layer(cache.cross_v, l), sel[l])
        align = align + al
    x = dec.ln_post(x)
    return _logits(model, x)[:, 0], cache, _tp_sum(model, align)[:, 0]


def decoder_verify(model: Whisper, tokens: torch.Tensor,
                   positions: torch.Tensor, cache: DecodeCache
                   ) -> Tuple[torch.Tensor, DecodeCache, torch.Tensor]:
    """A window of W tokens (B, W) whose first token sits at cache slot
    ``positions[b]`` (B,) of sample b: the speculative verify, and the
    draft's stepper at W = 1.

    Each query attends the cache slots below its sample's window start plus
    the window's own keys causally (no slot at or past the start is read).
    The window's k/v are then written in place at ``positions[b] + j``;
    writes at or past the cache's end are dropped, as JAX's one-hot write
    drops them. The write's shapes do not depend on the positions (nothing
    is read back to the host, so a CUDA graph of it replays at any
    position): each row rewrites the W slots from ``min(positions[b],
    S - W)``, each with the window's k/v that belongs there or with what
    it held. Returns (logits (B, W, V) f32, cache, align (B, W, A,
    T_enc))."""
    dec = model.decoder
    b, w = tokens.shape
    s_max = cache.self_k.shape[3]
    dev = tokens.device
    x = embed_tokens_at(model, tokens, positions)
    cache_mask = (torch.arange(s_max, device=dev)[None, :]
                  < positions[:, None])[:, None, None, :]      # (B, 1, 1, S)
    win_causal = torch.ones(w, w, dtype=torch.bool, device=dev).tril()
    mask = torch.cat([cache_mask.expand(b, 1, w, s_max),
                      win_causal.expand(b, 1, w, w)], dim=-1)
    start = positions.clamp(max=s_max - w)
    shift = (positions - start)[:, None]                       # (B, 1)
    ji = torch.arange(w, device=dev)[None, :]
    fresh = (ji >= shift)[:, None, :, None]                    # (B, 1, W, 1)
    heads, dh = cache.self_k.shape[2], cache.self_k.shape[4]
    slot_idx = (start[:, None] + ji)[:, None, :, None].expand(b, heads, w, dh)
    row_idx = (ji - shift).clamp(min=0)[:, None, :, None].expand(b, heads, w, dh)
    sel = _selector(model)
    align = 0.0
    for l, layer in enumerate(dec.layers):
        q, k, v = _self_qkv(layer, x)                          # (B, H, W, dh)
        keys = torch.cat([cache.self_k[l].to(q.dtype), k], dim=2)
        vals = torch.cat([cache.self_v[l].to(q.dtype), v], dim=2)
        a, _ = _attend(q, keys, vals, mask)
        for buf, new in ((cache.self_k[l], k), (cache.self_v[l], v)):
            new = new.to(buf.dtype).gather(2, row_idx)
            buf.scatter_(2, slot_idx,
                         torch.where(fresh, new, buf.gather(2, slot_idx)))
        x = x + layer.self_attn.out(_merge_heads(a))
        x, al = _cross_and_mlp(x, layer, _layer(cache.cross_k, l),
                               _layer(cache.cross_v, l), sel[l])
        align = align + al
    x = dec.ln_post(x)
    return _logits(model, x), cache, _tp_sum(model, align)


def _decoder_train_layer(layer: DecoderLayer, x: torch.Tensor,
                         enc_out: torch.Tensor, causal: torch.Tensor,
                         tp=None) -> torch.Tensor:
    """One decoder layer over a whole sequence: causal self-attention,
    cross-attention to ``enc_out``, the MLP. On a tp-sharded model the
    LayerNorm outputs enter the column-parallel linears through *f*
    (``enc_out`` has been through it once, in
    :func:`decoder_train_forward`)."""
    q, k, v = _self_qkv(layer, x, tp)
    a, _ = _attend(q, k, v, causal)
    x = x + _linear(layer.self_attn.out, _merge_heads(a))
    ca = layer.cross_attn
    cq = ca.heads(ca.q, copy_to_tp(layer.ln_cross(x), tp)).transpose(1, 2)
    ck, cv = (ca.heads(p, enc_out).transpose(1, 2) for p in (ca.k, ca.v))
    c, _ = _attend(cq, ck, cv)
    x = x + _linear(ca.out, _merge_heads(c))
    m_in = copy_to_tp(layer.ln2(x), tp)
    return x + _linear(layer.fc2, _gelu(_linear(layer.fc1, m_in)))


def decoder_train_forward(model: Whisper, tokens: torch.Tensor,
                          enc_out: torch.Tensor,
                          compute_dtype: Optional[torch.dtype] = None,
                          remat: bool = False) -> torch.Tensor:
    """Teacher-forced decoder over (B, S) tokens at positions [0, S)
    against (B, T, d) encoder states (JAX's ``decoder_train_forward``):
    returns f32 logits (B, S, V). ``compute_dtype`` and ``remat`` as in
    :func:`encoder_forward`. On a tp-sharded model the encoder states enter
    every layer's column-parallel cross k/v through one *f*, so their
    gradient is summed over tp once, not once a layer."""
    dec = model.decoder
    dtype = compute_dtype or model.dtype
    s = tokens.shape[1]
    x = _lookup(model, tokens).to(dtype) + dec.pos_emb[:s].to(dtype)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    enc_out = copy_to_tp(enc_out.to(dtype), model.tp)
    for layer in dec.layers:
        x = (checkpoint(_decoder_train_layer, layer, x, enc_out, causal,
                        model.tp, use_reentrant=False) if remat
             else _decoder_train_layer(layer, x, enc_out, causal, model.tp))
    return _logits(model, dec.ln_post(x))


# ---------------------------------------------------------------------------
# Random init (tests, benchmarks; real weights come from models/load.py)
# ---------------------------------------------------------------------------


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal encoder positions."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def init_params(arch: WhisperArch, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device=None,
                bias_std: float = 0.0) -> Whisper:
    """Random model with thewhisper_tpu's ``init_params`` distributions:
    N(0, 0.02) weights, embeddings and conv kernels, zero biases, unit
    LayerNorm scales, sinusoidal encoder positions. Draws on ``device``
    from ``generator`` (which must live there). A ``bias_std`` > 0 draws
    every bias and LayerNorm shift from N(0, bias_std) and every LayerNorm
    scale from 1 + N(0, bias_std) instead, as a checkpoint has them (the
    k projections have no bias, so a fused k bias stays 0)."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in Whisper(arch).state_dict().items()}
    state: Dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        if name == "encoder.pos_emb":
            state[name] = torch.from_numpy(
                _sinusoids(arch.max_source_positions, arch.d_model))
        elif name.endswith("bias") or ".ln" in name:
            # Biases and LayerNorm shifts 0, LayerNorm scales 1.
            state[name] = torch.full(shape, float(not name.endswith("bias")),
                                     device=device)
            if bias_std:
                state[name] += bias_std * torch.randn(
                    shape, generator=generator, device=device)
        else:
            state[name] = 0.02 * torch.randn(
                shape, generator=generator, device=device)
    return model_from_state(state, arch, dtype=dtype, device=device)
