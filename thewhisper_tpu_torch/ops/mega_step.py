"""The bs=1 decode step and speculative-verify window in one launch each:
the wrappers of K3 and K4, their packed operands and their plain version
(port of thewhisper_tpu's ``ops/mega_step.py``).

``mega_decoder_step`` is ``models.whisper.decoder_step`` for one sequence
of an "S" engine (weight-only int8 decoder with fused self q/k/v, per-row
int8 tied table, int8 cross K/V) at bf16: for each layer LN1, the fused
qkv GEMV, self-attention over cache slots below ``pos`` plus the fresh
token as one extra logit, the out-projection, LN, the cross-query GEMV,
cross-attention over the int8 K/V with the scales folded (summing the
alignment heads' probabilities), the cross out-projection, LN2, fc1, tanh
GELU and fc2; then the final LN and the tied-table logits. On a CUDA
tensor it is one launch of ``csrc/mega_step.cu``, which also writes the
fresh k/v into cache slot ``pos``; on a CPU tensor it runs
:func:`mega_decoder_step_plain`, the same function in plain torch on the
same operands.

``mega_decoder_verify`` is K3 over a window of W <= 16 tokens at slots
``pos .. pos + W - 1`` (``models.whisper.decoder_verify`` at batch 1,
without alignment): row r attends the cache below ``pos`` plus the
window's rows up to r, and every row gets its logits. On a CUDA tensor it
is one launch of ``csrc/mega_verify.cu`` (K4), which writes the window's
k/v into the cache itself; on a CPU tensor :func:`mega_verify_plain`.
K3's and K4's plain versions are one function: the step is the window of
one row.

Numerics, kernel and plain version alike: LayerNorm in f32; every int8
product accumulates in f32 and takes its scale and bias after the sum;
projections round to the compute type; attention scores and softmax in
f32; the residual stream in the compute type; f32 logits.

The TPU kernels' Mosaic workarounds have no counterpart: the head padding
to 128 and the head-selector products (``sel``/``selt``), the ``smalls8``
replication and ``ensure_verify_smalls``, the window pad to 8 and
``row1``'s one-hot row extraction, the slot pad to 8 and cross pad to 256,
the transposed 512-padded table copy and the caller's where-iota or
one-hot cache write. The weights are read as the
model stores them ((out, in), each layer's matrices stacked once at
engine init and the layers' modules rebound to views of the stack).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from thewhisper_tpu_torch.config import WhisperArch
from thewhisper_tpu_torch.models.quant import (
    Int8Embedding,
    Int8Linear,
    QuantizedKV,
)
from thewhisper_tpu_torch.models.whisper import (
    DecodeCache,
    Whisper,
    _gelu,
    embed_tokens,
    embed_tokens_at,
)
from thewhisper_tpu_torch.ops import _build

# Launches of the CUDA kernels (not of the plain versions) since import:
# K3 (the step) and K4 (the verify window).
MEGA_LAUNCHES = 0
MEGA_VERIFY_LAUNCHES = 0
# K4's widest window (its per-row accumulators live in registers).
MAX_WINDOW = 16

_DH = 64
# The per-layer f32 vectors in one (L, NS) row, in this order; widths in
# units of (D, F). The kernel (csrc/mega_step.cu) reads the same offsets.
_SMALLS = (("ln1_g", 1, 0), ("ln1_b", 1, 0), ("qkv_s", 3, 0), ("qkv_b", 3, 0),
           ("o_s", 1, 0), ("o_b", 1, 0), ("lnc_g", 1, 0), ("lnc_b", 1, 0),
           ("cq_s", 1, 0), ("cq_b", 1, 0), ("co_s", 1, 0), ("co_b", 1, 0),
           ("ln2_g", 1, 0), ("ln2_b", 1, 0), ("fc1_s", 0, 1), ("fc1_b", 0, 1),
           ("fc2_s", 1, 0), ("fc2_b", 1, 0))


def mega_pays(arch: WhisperArch, batch: int = 1) -> bool:
    """The JAX package's gate on its accelerator: the one-launch step pays
    at batch 1 on decoders deeper than 4 layers (large-v3 yes, turbo no).
    To be re-derived from this card's own times: ``chip_smoke.py`` prints
    the kernel and the plain step at L = 32 and at L = 4."""
    return batch == 1 and arch.decoder_layers > 4


class MegaParams(NamedTuple):
    """K3's operands, made once by :func:`pack_mega_params`."""

    qkv_w: torch.Tensor     # (L, 3D, D) int8
    o_w: torch.Tensor       # (L, D, D) int8
    cq_w: torch.Tensor      # (L, D, D) int8
    co_w: torch.Tensor      # (L, D, D) int8
    fc1_w: torch.Tensor     # (L, F, D) int8
    fc2_w: torch.Tensor     # (L, D, F) int8
    smalls: torch.Tensor    # (L, 20 D + 2 F) f32, the _SMALLS vectors
    lnp: torch.Tensor       # (2, D) f32 final LayerNorm weight, bias
    emb_q: torch.Tensor     # (V, D) int8 tied table (the model's own)
    emb_s: torch.Tensor     # (V,) f32 row scales
    heads: torch.Tensor     # (A, 2) int32 (layer, head) of each alignment head


def _smalls_offsets(d: int, f: int):
    offs, o = {}, 0
    for name, nd, nf in _SMALLS:
        offs[name] = (o, nd * d + nf * f)
        o += nd * d + nf * f
    return offs


def pack_mega_params(model: Whisper) -> Optional[MegaParams]:
    """Stack the decoder's int8 matrices into (L, out, in) tensors, rebind
    every layer's weight to a view of its stack (so the model and the
    kernel share one copy), pack the small f32 vectors and set
    ``model.mega``. Returns the operands, or None (leaving the model as it
    was) when the decoder is not weight-only int8 with fused self q/k/v and
    an int8 tied table."""
    dec = model.decoder
    linears = {"qkv": [], "o": [], "cq": [], "co": [], "fc1": [], "fc2": []}
    for layer in dec.layers:
        sa, ca = layer.self_attn, layer.cross_attn
        for key, mod in (("qkv", getattr(sa, "qkv", None)), ("o", sa.out),
                         ("cq", ca.q), ("co", ca.out), ("fc1", layer.fc1),
                         ("fc2", layer.fc2)):
            if type(mod) is not Int8Linear or mod.bias is None:
                return None
            linears[key].append(mod)
    if not isinstance(dec.token_emb, Int8Embedding):
        return None

    stacks = {}
    for key, mods in linears.items():
        stack = torch.stack([m.weight for m in mods])
        for l, m in enumerate(mods):
            m.weight = stack[l]
        stacks[key] = stack

    per_layer = []
    for layer, qkv, o, cq, co, fc1, fc2 in zip(dec.layers, *linears.values()):
        per_layer.append(torch.cat([t.float() for t in (
            layer.ln1.weight, layer.ln1.bias, qkv.scale, qkv.bias,
            o.scale, o.bias, layer.ln_cross.weight, layer.ln_cross.bias,
            cq.scale, cq.bias, co.scale, co.bias,
            layer.ln2.weight, layer.ln2.bias, fc1.scale, fc1.bias,
            fc2.scale, fc2.bias)]))
    heads = torch.tensor(model.arch.alignment_heads or [], dtype=torch.int32,
                         device=model.device).reshape(-1, 2)
    model.mega = MegaParams(
        qkv_w=stacks["qkv"], o_w=stacks["o"], cq_w=stacks["cq"],
        co_w=stacks["co"], fc1_w=stacks["fc1"], fc2_w=stacks["fc2"],
        smalls=torch.stack(per_layer),
        lnp=torch.stack([dec.ln_post.weight, dec.ln_post.bias]).float(),
        emb_q=dec.token_emb.q, emb_s=dec.token_emb.s, heads=heads)
    return model.mega


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], g, b, 1e-5).to(x.dtype)


def _gemv(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """(W, in) x int8 (out, in): f32 products and sum, then scale and bias."""
    return torch.matmul(x.float(), w.float().t()) * s + b


def _rows_plain(mp: MegaParams, x: torch.Tensor, pos: int,
                cache: DecodeCache, arch: WhisperArch, capture_align: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 and K4 in plain torch: the W rows of ``x`` (W, D) are the tokens
    at slots ``pos .. pos + W - 1`` of the batch-1 self cache, written here;
    row r attends slots ``[0, pos + r]``. Returns (logits (W, V) f32,
    align (W, max(A, 1), T) f32, zeros unless ``capture_align``)."""
    dt = x.dtype
    w = x.shape[0]
    n_layers, d = mp.o_w.shape[:2]
    f = mp.fc1_w.shape[1]
    h, dh = arch.decoder_heads, d // arch.decoder_heads
    scale = dh ** -0.5
    offs = _smalls_offsets(d, f)
    ck, cv = cache.cross_k, cache.cross_v
    t = ck.q.shape[3]
    n = pos + w
    causal = (torch.arange(n, device=x.device)[None, :]
              <= pos + torch.arange(w, device=x.device)[:, None])  # (W, n)
    align = torch.zeros(w, max(1, mp.heads.shape[0]), t, device=x.device)
    for l in range(n_layers):
        def sm(name):
            o, width = offs[name]
            return mp.smalls[l, o:o + width]

        # Self-attention over slots < pos plus the window causally.
        qkv = _gemv(_ln(x, sm("ln1_g"), sm("ln1_b")), mp.qkv_w[l],
                    sm("qkv_s"), sm("qkv_b")).to(dt)
        q, k, v = (qkv[:, i * d:(i + 1) * d].view(w, h, dh) for i in range(3))
        cache.self_k[l, 0, :, pos:n] = k.transpose(0, 1)
        cache.self_v[l, 0, :, pos:n] = v.transpose(0, 1)
        logits = torch.einsum("whd,hsd->hws", q.float() * scale,
                              cache.self_k[l, 0, :, :n].float())
        p = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
        att = torch.einsum("hws,hsd->whd", p, cache.self_v[l, 0, :, :n].float())
        x = x + _gemv(att.reshape(w, d).to(dt), mp.o_w[l], sm("o_s"),
                      sm("o_b")).to(dt)

        # Cross-attention over the int8 K/V, scales folded.
        cq = _gemv(_ln(x, sm("lnc_g"), sm("lnc_b")), mp.cq_w[l], sm("cq_s"),
                   sm("cq_b")).to(dt)
        cqs = cq.float().view(w, h, dh) * ck.s[l, 0] * scale
        p = torch.softmax(torch.einsum("whd,htd->wht", cqs, ck.q[l, 0].float()),
                          dim=-1)
        if capture_align:
            for a, (la, ha) in enumerate(arch.alignment_heads):
                if la == l:
                    align[:, a] += p[:, ha]
        c = torch.einsum("wht,htd->whd", p, cv.q[l, 0].float()) * cv.s[l, 0]
        x = x + _gemv(c.reshape(w, d).to(dt), mp.co_w[l], sm("co_s"),
                      sm("co_b")).to(dt)

        # MLP.
        hid = _gemv(_ln(x, sm("ln2_g"), sm("ln2_b")), mp.fc1_w[l],
                    sm("fc1_s"), sm("fc1_b")).to(dt)
        hid = _gelu(hid)
        x = x + _gemv(hid, mp.fc2_w[l], sm("fc2_s"), sm("fc2_b")).to(dt)
    x = _ln(x, mp.lnp[0], mp.lnp[1])
    return torch.matmul(x.float(), mp.emb_q.float().t()) * mp.emb_s, align


def mega_step_plain(mp: MegaParams, x: torch.Tensor, pos: int,
                    cache: DecodeCache, arch: WhisperArch,
                    capture_align: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K3 function in plain torch, on the packed operands of ``arch``'s
    first ``mp.o_w.shape[0]`` layers. ``x`` (1, D) is the embedded token;
    writes slot ``pos`` of the batch-1 self cache. Returns (logits (1, V)
    f32, align (max(A, 1), T) f32, zeros unless ``capture_align``)."""
    logits, align = _rows_plain(mp, x, pos, cache, arch, capture_align)
    return logits, align[0]


def mega_verify_plain(mp: MegaParams, x: torch.Tensor, pos: int,
                      cache: DecodeCache, arch: WhisperArch) -> torch.Tensor:
    """The K4 function in plain torch: K3 over a window. ``x`` (W, D) is
    the embedded window whose first token sits at slot ``pos``; writes
    slots ``pos .. pos + W - 1`` of the batch-1 self cache. Returns logits
    (W, V) f32."""
    return _rows_plain(mp, x, pos, cache, arch, capture_align=False)[0]


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"mega_step: {what}")


def _operands(mp: MegaParams, x: torch.Tensor, cache: DecodeCache,
              arch: WhisperArch) -> Tuple[int, ...]:
    """Check what K3 and K4 share: a CUDA bf16 residual of width D, the
    packed operands, a batch-1 bf16 self cache and int8 cross K/V, one
    device, contiguous. Returns (L, D, F, H, V, S, T)."""
    _check(x.device.type == "cuda", f"unsupported device {x.device}")
    n_heads = arch.decoder_heads
    n_layers, d = mp.o_w.shape[:2]
    f = mp.fc1_w.shape[1]
    ck, cv = cache.cross_k, cache.cross_v
    sk, sv = cache.self_k, cache.self_v
    _check(x.dtype == torch.bfloat16, f"compute type {x.dtype} (takes bf16)")
    _check(x.ndim == 2 and x.shape[1] == d, f"x of shape {tuple(x.shape)}")
    _check(d % 128 == 0 and f % 128 == 0,
           f"d_model {d} / d_ff {f} not multiples of 128")
    _check(d == n_heads * _DH, f"head dim {d // n_heads} (takes {_DH})")
    _check(sk.dtype == sv.dtype == torch.bfloat16, "self cache must be bf16")
    _check(sk.shape[:3] == (n_layers, 1, n_heads) and sk.shape[4] == _DH
           and sk.shape == sv.shape, f"self cache shape {tuple(sk.shape)}")
    _check(isinstance(ck, QuantizedKV) and isinstance(cv, QuantizedKV),
           "cross K/V must be int8 (QuantizedKV)")
    t = ck.q.shape[3]
    for kv in (ck, cv):
        _check(kv.q.dtype == torch.int8 and kv.q.shape == (
            n_layers, 1, n_heads, t, _DH), f"cross K/V {tuple(kv.q.shape)}")
        _check(kv.s.dtype == torch.float32 and kv.s.shape == (
            n_layers, 1, n_heads, _DH), "cross K/V scales")
    tensors = (x, sk, sv, ck.q, cv.q, ck.s, cv.s, *mp)
    _check(all(a.device == x.device for a in tensors), "one device for all")
    _check(all(a.is_contiguous() for a in tensors), "contiguous operands")
    return n_layers, d, f, n_heads, mp.emb_q.shape[0], sk.shape[3], t


def _pointers(mp: MegaParams, cache: DecodeCache):
    """The operands both C entry points take first, in their order."""
    ck, cv = cache.cross_k, cache.cross_v
    return (mp.qkv_w.data_ptr(), mp.o_w.data_ptr(), mp.cq_w.data_ptr(),
            mp.co_w.data_ptr(), mp.fc1_w.data_ptr(), mp.fc2_w.data_ptr(),
            mp.smalls.data_ptr(), mp.lnp.data_ptr(), mp.emb_q.data_ptr(),
            mp.emb_s.data_ptr(), cache.self_k.data_ptr(),
            cache.self_v.data_ptr(), ck.q.data_ptr(), cv.q.data_ptr(),
            ck.s.data_ptr(), cv.s.data_ptr())


def mega_step(mp: MegaParams, x: torch.Tensor, pos: int, cache: DecodeCache,
              arch: WhisperArch, capture_align: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's wrapper, the contract of :func:`mega_step_plain`. CPU tensors
    take the plain version; CUDA tensors one launch of csrc/mega_step.cu,
    which raises on anything the kernel does not take."""
    global MEGA_LAUNCHES
    if x.device.type == "cpu":
        return mega_step_plain(mp, x, pos, cache, arch, capture_align)
    n_layers, d, f, n_heads, v, s_max, t = _operands(mp, x, cache, arch)
    _check(x.shape[0] == 1, f"x of shape {tuple(x.shape)} (takes batch 1)")
    _check(0 <= pos < s_max, f"position {pos} outside the {s_max}-slot cache")
    n_align = mp.heads.shape[0]
    logits = torch.empty(1, v, device=x.device)
    align = torch.empty(max(1, n_align), t, device=x.device)
    # Scratch: qkv (3D) | att (D) | hidden (F) in bf16, then cq (D) f32.
    work = torch.empty(4 * d + f + 2 * d, dtype=torch.bfloat16,
                       device=x.device)
    x = x.clone()                       # the residual stream, in place
    code = _build.lib().twt_mega_step(
        *_pointers(mp, cache), mp.heads.data_ptr(), x.data_ptr(),
        work.data_ptr(), logits.data_ptr(), align.data_ptr(),
        _build.grid_barrier(x.device).data_ptr(),
        n_layers, d, f, n_heads, v, s_max, t, n_align, int(pos),
        int(capture_align), x.device.index or 0,
        _build.stream_handle(x.device))
    _build.check(code, "twt_mega_step")
    MEGA_LAUNCHES += 1
    return logits, align


def mega_verify(mp: MegaParams, x: torch.Tensor, pos: int, cache: DecodeCache,
                arch: WhisperArch) -> torch.Tensor:
    """K4's wrapper, the contract of :func:`mega_verify_plain`. CPU tensors
    take the plain version; CUDA tensors one launch of csrc/mega_verify.cu,
    which raises on anything the kernel does not take (a window of 1 to
    16 rows that fits the cache)."""
    global MEGA_VERIFY_LAUNCHES
    if x.device.type == "cpu":
        return mega_verify_plain(mp, x, pos, cache, arch)
    n_layers, d, f, n_heads, v, s_max, t = _operands(mp, x, cache, arch)
    w = x.shape[0]
    _check(1 <= w <= MAX_WINDOW, f"window of {w} rows (takes 1..{MAX_WINDOW})")
    _check(0 <= pos and pos + w <= s_max,
           f"window at {pos}..{pos + w - 1} outside the {s_max}-slot cache")
    logits = torch.empty(w, v, device=x.device)
    # Scratch: qkv (W, 3D) | att (W, D) | hidden (W, F) in bf16, then cq
    # (W, D) f32.
    work = torch.empty(w * (6 * d + f), dtype=torch.bfloat16, device=x.device)
    x = x.clone()                       # the residual stream, in place
    code = _build.lib().twt_mega_verify(
        *_pointers(mp, cache), x.data_ptr(), work.data_ptr(),
        logits.data_ptr(), _build.grid_barrier(x.device).data_ptr(),
        n_layers, d, f, n_heads, v, s_max, t, w, int(pos),
        x.device.index or 0, _build.stream_handle(x.device))
    _build.check(code, "twt_mega_verify")
    MEGA_VERIFY_LAUNCHES += 1
    return logits


def _packed(model: Whisper) -> MegaParams:
    if model.mega is None:
        raise ValueError("mega_step: the model is not packed "
                         "(ops.mega_step.pack_mega_params)")
    return model.mega


def _run(model: Whisper, token: torch.Tensor, position: int,
         cache: DecodeCache, capture_align: bool, plain: bool):
    x = embed_tokens(model, token, position)[:, 0]              # (1, D)
    step = mega_step_plain if plain else mega_step
    logits, align = step(_packed(model), x, int(position), cache,
                         model.arch, capture_align)
    return logits, cache, align[None]


def mega_decoder_step(model: Whisper, token: torch.Tensor, position: int,
                      cache: DecodeCache, capture_align: bool = True
                      ) -> Tuple[torch.Tensor, DecodeCache, torch.Tensor]:
    """One decode step of a packed model at batch 1: ``token`` (1, 1) at
    cache slot ``position``. The contract of ``models.whisper
    .decoder_step``: returns (logits (1, V) f32, cache with slot
    ``position`` written, align (1, A, T_enc) f32, zeros unless
    ``capture_align``). CPU tensors take :func:`mega_decoder_step_plain`;
    CUDA tensors launch K3 or raise."""
    return _run(model, token, position, cache, capture_align, plain=False)


def mega_decoder_step_plain(model: Whisper, token: torch.Tensor,
                            position: int, cache: DecodeCache,
                            capture_align: bool = True
                            ) -> Tuple[torch.Tensor, DecodeCache, torch.Tensor]:
    """:func:`mega_decoder_step` in plain torch, on any device."""
    return _run(model, token, position, cache, capture_align, plain=True)


def mega_decoder_verify(model: Whisper, tokens: torch.Tensor, position: int,
                        cache: DecodeCache, plain: bool = False
                        ) -> Tuple[torch.Tensor, DecodeCache, torch.Tensor]:
    """One speculative-verify window of a packed model at batch 1:
    ``tokens`` (1, W) whose first token sits at cache slot ``position``
    (a host int). The contract of ``models.whisper.decoder_verify`` at
    batch 1: returns (logits (1, W, V) f32, cache with slots ``position ..
    position + W - 1`` written, align (1, W, A, T_enc) of zeros: K4 keeps
    no alignment, so decodes that need it take ``decoder_verify``). CPU
    tensors (or ``plain``) take :func:`mega_verify_plain`; CUDA tensors
    launch K4 or raise."""
    pos = torch.full((1,), int(position), device=tokens.device)
    x = embed_tokens_at(model, tokens, pos)[0]                  # (W, D)
    verify = mega_verify_plain if plain else mega_verify
    logits = verify(_packed(model), x, int(position), cache, model.arch)
    t = cache.cross_k.q.shape[3]
    align = torch.zeros(1, tokens.shape[1], max(1, len(model.arch.alignment_heads)),
                        t, device=tokens.device)
    return logits[None], cache, align
