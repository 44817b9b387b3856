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
same operands. The engine packs the operands at batch 1 for any decoder
depth (:func:`mega_pays`).

The cache slot is a Python ``int`` or, as the TPU kernel takes ``pos``
from SMEM, a one-element integer tensor on the card, which the kernel
reads when it runs: a CUDA graph of a step replays it at whatever slot the
device holds then. The host plans the self-attention chunks and the
scratch for a bound on ``pos + W``: ``pos + W`` itself for an ``int``, the
cache's length for a tensor. A tensor slot outside ``[0, S - W]`` makes
the launch do nothing but set an error word, which the wrapper reads after an eager launch (a caller that passes
``check=False``, as the decode loop does, reads it with
:func:`raise_position_errors` at its own host checks; a captured launch
leaves it to whoever replays the graph).

``mega_decoder_verify`` is K3 over a window of W <= 16 tokens at slots
``pos .. pos + W - 1`` (``models.whisper.decoder_verify`` at batch 1,
without alignment): row r attends the cache below ``pos`` plus the
window's rows up to r, and every row gets its logits. On a CUDA tensor it
is one launch of ``csrc/mega_verify.cu`` (K4), which writes the window's
k/v into the cache itself; on a CPU tensor :func:`mega_verify_plain`.
K3's and K4's plain versions are one function: the step is the window of
one row, and the two kernels are one engine (``csrc/mega_common.cuh``):
every block streams its share of the weights through a TMA ring, the
products run on the tensor cores, attention runs over (head, chunk) items
on every SM. The wrapper picks the attention chunks for the card's SM count
(:func:`attention_chunks`) and keeps the scratch for each (device, size).

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

from typing import Dict, NamedTuple, Optional, Tuple, Union

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
    embed_tokens_at,
    step_position,
)
from thewhisper_tpu_torch.ops import _build

# Launches of the CUDA kernels (not of the plain versions) since import:
# K3 (the step) and K4 (the verify window). A launch captured into a CUDA
# graph counts when the graph replays (engine.graphs.StepGraph adds what
# its capture recorded), not when it is captured.
MEGA_LAUNCHES = 0
MEGA_VERIFY_LAUNCHES = 0

# A cache slot: a host int, or a one-element integer tensor on the device.
Position = Union[int, torch.Tensor]

# K4's widest window (its per-row accumulators live in registers).
MAX_WINDOW = 16

_DH = 64
# The per-layer f32 vectors in one (L, NS) row, in this order; widths in
# units of (D, F). The kernels (csrc/mega_common.cuh) read the same offsets.
_SMALLS = (("ln1_g", 1, 0), ("ln1_b", 1, 0), ("qkv_s", 3, 0), ("qkv_b", 3, 0),
           ("o_s", 1, 0), ("o_b", 1, 0), ("lnc_g", 1, 0), ("lnc_b", 1, 0),
           ("cq_s", 1, 0), ("cq_b", 1, 0), ("co_s", 1, 0), ("co_b", 1, 0),
           ("ln2_g", 1, 0), ("ln2_b", 1, 0), ("fc1_s", 0, 1), ("fc1_b", 0, 1),
           ("fc2_s", 1, 0), ("fc2_b", 1, 0))


def mega_pays(arch: WhisperArch, batch: int = 1) -> bool:
    """Whether the one-launch step (K3) pays: at batch 1, for any decoder
    depth. The JAX package gates on depth too (its TPU compile policy);
    on the H100 K3 beats the plain step at every depth ``chip_smoke.py``
    [K3] times: 0.2706 against 5.4394 ms a step at L = 4 (turbo's depth)
    and 1.8175 against 31.5258 ms at L = 32 (large-v3) with the first,
    CUDA-core kernel; 0.2562 against 5.7542 ms and 1.6901 against 46.7695
    ms with the redesigned engine (NVIDIA H100 80GB HBM3, 700.00 W)."""
    del arch
    return batch == 1


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


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _rows_plain(mp: MegaParams, x: torch.Tensor, pos: Position,
                cache: DecodeCache, arch: WhisperArch, capture_align: bool,
                gelu=_gelu) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 and K4 in plain torch: the W rows of ``x`` (W, D) are the tokens
    at slots ``pos .. pos + W - 1`` of the batch-1 self cache, written here;
    row r attends slots ``[0, pos + r]``. A tensor ``pos`` is read on the
    host. Returns (logits (W, V) f32, align (W, max(A, 1), T) f32, zeros
    unless ``capture_align``)."""
    pos = int(pos)
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
        hid = gelu(hid)
        x = x + _gemv(hid, mp.fc2_w[l], sm("fc2_s"), sm("fc2_b")).to(dt)
    x = _ln(x, mp.lnp[0], mp.lnp[1])
    return torch.matmul(x.float(), mp.emb_q.float().t()) * mp.emb_s, align


def mega_step_plain(mp: MegaParams, x: torch.Tensor, pos: Position,
                    cache: DecodeCache, arch: WhisperArch,
                    capture_align: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K3 function in plain torch, on the packed operands of ``arch``'s
    first ``mp.o_w.shape[0]`` layers. ``x`` (1, D) is the embedded token;
    writes slot ``pos`` of the batch-1 self cache. Returns (logits (1, V)
    f32, align (max(A, 1), T) f32, zeros unless ``capture_align``)."""
    logits, align = _rows_plain(mp, x, pos, cache, arch, capture_align)
    return logits, align[0]


def mega_reference(mp: MegaParams, x: torch.Tensor, pos: Position,
                   cache: DecodeCache, arch: WhisperArch
                   ) -> Tuple[torch.Tensor, torch.Tensor, DecodeCache]:
    """K3's and K4's function with every rounding point in f32: the int8
    weights as stored, the rows ``x`` (W, D), the residual and f32 copies
    of the self cache, the kernels' tanh GELU. The yardstick that a kernel
    and the plain version in bf16 are both measured against at depth,
    where each drifts from it by its own bf16 rounding cascade. Returns
    (logits (W, V), align (W, max(A, 1), T), the f32 cache it wrote)."""
    ref = DecodeCache(cache.self_k.float(), cache.self_v.float(),
                      cache.cross_k, cache.cross_v)
    logits, align = _rows_plain(mp, x.float(), pos, ref, arch, True,
                                gelu=_gelu_tanh)
    return logits, align, ref


def mega_verify_plain(mp: MegaParams, x: torch.Tensor, pos: Position,
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


# The engine's partition (csrc/mega_common.cuh): rows of a matrix by block,
# attention items by (head, chunk). MAX_CHUNK is the cross K/V rows that
# fit one ring stage (16 rows of 1280 + 64 bytes, 64 bytes a row).
MAX_CHUNK = 16 * (1280 + 64) // 64
_PART = 68                  # floats of a chunk's partial: m, l, 2 unused, o
# The self-attention's chunks hold at least this many slots: below it a
# head's slots are one item, which writes its output without the combine
# (at S = 68 the split over 132 blocks cost more in its combine than it
# saved; H100 80GB HBM3, 700 W).
SELF_MIN_CHUNK = 128


def row_range(block: int, blocks: int, rows: int) -> Tuple[int, int]:
    """Block ``block``'s rows of a ``rows``-row matrix, as the kernel splits
    them (``row_lo``): contiguous, every row once, block sizes at most one
    apart."""
    return block * rows // blocks, (block + 1) * rows // blocks


def attention_chunks(n: int, heads: int, blocks: int,
                     min_len: int = 1) -> Tuple[int, int]:
    """(chunk length, chunks a head) of the attention items over ``n``
    keys: ``heads`` x chunks items, as many as ``blocks`` (one wave of
    about equal items) where the keys allow, a chunk at least ``min_len``
    and at most MAX_CHUNK keys."""
    per_head = max(1, blocks // heads)
    length = min(MAX_CHUNK, max(min_len, -(-n // per_head)))
    return length, -(-n // length)


def work_bytes(n_layers: int, w: int, d: int, f: int, h: int, sn: int,
               cn: int, a: int, t: int) -> int:
    """The kernels' scratch (``work_bytes`` of csrc/mega_common.cuh): the
    counters each launch zeroes (the grid barrier's and the attention items
    done of each layer and head), the qkv, attention and hidden rows in
    bf16, the cross query, the self and cross chunks' partials and the
    alignment heads' raw scores in f32."""
    counters = -(-4 * (1 + 2 * n_layers * h) // 16) * 16
    return (counters + 2 * w * (4 * d + f) + 4 * w * d
            + 4 * _PART * w * h * (sn + cn) + 4 * max(a, 1) * t)


_scratch = {}
_sms = {}
_slots: Dict[int, torch.Tensor] = {}
_errors: Dict[int, torch.Tensor] = {}


def _work(device: torch.device, n: int) -> torch.Tensor:
    """``n`` bytes of the kernels' scratch, kept for each (device, size):
    launches on one stream do not overlap, so they can share it."""
    key = (device.index or 0, n)
    if key not in _scratch:
        _scratch[key] = torch.empty(n, dtype=torch.uint8, device=device)
    return _scratch[key]


def _device_buffer(cache: Dict[int, torch.Tensor],
                   device: torch.device) -> torch.Tensor:
    """A zeroed one-element int32 tensor on ``device``, made once a device
    (before any capture: a decode's warm-up launch makes it)."""
    key = device.index or 0
    if key not in cache:
        cache[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return cache[key]


def _slot(pos: Position, w: int, s_max: int,
          device: torch.device) -> Tuple[torch.Tensor, int, bool]:
    """(int32 slot tensor, bound on pos + w, whether the kernel's error word
    must be read): a host slot is checked here and filled into the device's
    slot tensor (a fill launch, no synchronisation); a tensor slot is the
    kernel's to check, against the cache's length."""
    if isinstance(pos, torch.Tensor):
        _check(pos.numel() == 1 and pos.device == device
               and not pos.is_floating_point(),
               f"slot tensor of {pos.numel()} elements on {pos.device} "
               f"(takes one integer on {device})")
        if pos.dtype != torch.int32:
            pos = pos.to(torch.int32)
        return pos.reshape(1), s_max, True
    pos = int(pos)
    _check(0 <= pos and pos + w <= s_max,
           f"position {pos} (window {pos}..{pos + w - 1}) outside the "
           f"{s_max}-slot cache")
    return _device_buffer(_slots, device).fill_(pos), pos + w, False


def raise_position_errors(device: torch.device) -> None:
    """Read (synchronising) and clear the error word that K3 and K4 set
    when a device slot fell outside its bound; raise if it was set."""
    err = _device_buffer(_errors, device)
    if int(err.item()):
        err.zero_()
        raise ValueError("mega_step: a device slot fell outside the bound "
                         "its launch was planned for (no launch since the "
                         "last check wrote anything)")


def _launch_plan(x: torch.Tensor, n_layers: int, w: int, bound: int,
                 s_max: int, d: int, f: int, h: int, t: int, a: int):
    """(chunks, scratch) of one launch: the self and cross chunking for the
    card's SM count (one block an SM) and the scratch they need. The self
    chunks' length depends on the cache's length alone and their count on
    ``bound``, so launches planned for pos + W and for the cache's length
    split a head's slots at the same places (the chunks past pos + W are
    neutral, and a head of one chunk that it combines gives the bits it
    writes directly)."""
    key = x.device.index or 0
    if key not in _sms:
        _sms[key] = torch.cuda.get_device_properties(x.device).multi_processor_count
    sc = attention_chunks(s_max, h, _sms[key], SELF_MIN_CHUNK)[0]
    sn = -(-bound // sc)
    cc, cn = attention_chunks(t, h, _sms[key])
    work = _work(x.device, work_bytes(n_layers, w, d, f, h, sn, cn, a, t))
    return (sc, sn, cc, cn), work


STAMPS = ("start", "arrive", "leave", "product", "ring_wait", "mma")


def stamps_tensor(n_layers: int, device) -> torch.Tensor:
    """A zeroed int64 (2, 8 L + 1, 6) tensor for a kernel's ``stamps``, for
    block 0 (row 0) and the grid's last block (row 1), phase 8 l + i being
    phase i of layer l and the last the final LayerNorm and the logits:
    %globaltimer in ns at the phase's start, at its arrival at the grid
    barrier that ends it, at its leaving and at the start of its matrix
    product (0 where it has none), then the ns it waited for the ring's
    weight stages and the ns warp 0 spent in the product's loops
    (``STAMPS``)."""
    return torch.zeros(2, 8 * n_layers + 1, len(STAMPS), dtype=torch.int64,
                       device=device)


def mega_step(mp: MegaParams, x: torch.Tensor, pos: Position,
              cache: DecodeCache, arch: WhisperArch, capture_align: bool = True,
              stamps: Optional[torch.Tensor] = None,
              check: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's wrapper, the contract of :func:`mega_step_plain`. CPU tensors
    take the plain version; CUDA tensors one launch of csrc/mega_step.cu,
    which raises on anything the kernel does not take. ``pos`` is a host
    int or a device slot tensor; with a tensor and ``check``, an eager launch reads
    the kernel's error word (a synchronisation) and raises if it is set.
    ``stamps`` (from :func:`stamps_tensor`, CUDA only) records where the
    launch's time goes."""
    global MEGA_LAUNCHES
    if x.device.type == "cpu":
        return mega_step_plain(mp, x, pos, cache, arch, capture_align)
    n_layers, d, f, n_heads, v, s_max, t = _operands(mp, x, cache, arch)
    _check(x.shape[0] == 1, f"x of shape {tuple(x.shape)} (takes batch 1)")
    slot, bound, device_slot = _slot(pos, 1, s_max, x.device)
    n_align = mp.heads.shape[0]
    chunks, work = _launch_plan(x, n_layers, 1, bound, s_max, d, f, n_heads,
                                t, n_align)
    err = _device_buffer(_errors, x.device)
    logits = torch.empty(1, v, device=x.device)
    align = torch.empty(max(1, n_align), t, device=x.device)
    x = x.clone()                       # the residual stream, in place
    code = _build.lib().twt_mega_step(
        *_pointers(mp, cache), mp.heads.data_ptr(), x.data_ptr(),
        work.data_ptr(), work.numel(), logits.data_ptr(), align.data_ptr(),
        _stamps_ptr(stamps, n_layers, x), slot.data_ptr(), err.data_ptr(),
        n_layers, d, f, n_heads, v, s_max, t, n_align, bound,
        int(capture_align), *chunks, x.device.index or 0,
        _build.stream_handle(x.device))
    _build.check(code, "twt_mega_step")
    MEGA_LAUNCHES += 1
    if device_slot and check and not torch.cuda.is_current_stream_capturing():
        raise_position_errors(x.device)
    return logits, align


def _stamps_ptr(stamps: Optional[torch.Tensor], n_layers: int,
                x: torch.Tensor) -> int:
    if stamps is None:
        return 0
    _check(stamps.dtype == torch.int64 and stamps.is_contiguous()
           and stamps.device == x.device
           and stamps.shape == (2, 8 * n_layers + 1, len(STAMPS)),
           f"stamps {tuple(stamps.shape)} (takes stamps_tensor({n_layers}))")
    return stamps.data_ptr()


def mega_verify(mp: MegaParams, x: torch.Tensor, pos: Position,
                cache: DecodeCache, arch: WhisperArch,
                stamps: Optional[torch.Tensor] = None, check: bool = True
                ) -> torch.Tensor:
    """K4's wrapper, the contract of :func:`mega_verify_plain`. CPU tensors
    take the plain version; CUDA tensors one launch of csrc/mega_verify.cu,
    which raises on anything the kernel does not take (a window of 1 to
    16 rows that fits the cache). ``pos`` and ``check`` as for
    :func:`mega_step`: a host int is filled into a device slot without a
    synchronisation. ``stamps`` as for :func:`mega_step`."""
    global MEGA_VERIFY_LAUNCHES
    if x.device.type == "cpu":
        return mega_verify_plain(mp, x, pos, cache, arch)
    n_layers, d, f, n_heads, v, s_max, t = _operands(mp, x, cache, arch)
    w = x.shape[0]
    _check(1 <= w <= MAX_WINDOW, f"window of {w} rows (takes 1..{MAX_WINDOW})")
    slot, bound, device_slot = _slot(pos, w, s_max, x.device)
    chunks, work = _launch_plan(x, n_layers, w, bound, s_max, d, f, n_heads,
                                t, 0)
    err = _device_buffer(_errors, x.device)
    logits = torch.empty(w, v, device=x.device)
    x = x.clone()                       # the residual stream, in place
    code = _build.lib().twt_mega_verify(
        *_pointers(mp, cache), x.data_ptr(), work.data_ptr(), work.numel(),
        logits.data_ptr(), _stamps_ptr(stamps, n_layers, x), slot.data_ptr(),
        err.data_ptr(), n_layers, d, f, n_heads, v, s_max, t, w, bound,
        *chunks, x.device.index or 0, _build.stream_handle(x.device))
    _build.check(code, "twt_mega_verify")
    MEGA_VERIFY_LAUNCHES += 1
    if device_slot and check and not torch.cuda.is_current_stream_capturing():
        raise_position_errors(x.device)
    return logits


def _packed(model: Whisper) -> MegaParams:
    if model.mega is None:
        raise ValueError("mega_step: the model is not packed "
                         "(ops.mega_step.pack_mega_params)")
    return model.mega


def _run(model: Whisper, token: torch.Tensor, position: Position,
         cache: DecodeCache, capture_align: bool, plain: bool,
         check: bool = True):
    x = embed_tokens_at(model, token,
                        step_position(position, token.device))[:, 0]  # (1, D)
    mp = _packed(model)
    if plain:
        logits, align = mega_step_plain(mp, x, position, cache, model.arch,
                                        capture_align)
    else:
        logits, align = mega_step(mp, x, position, cache, model.arch,
                                  capture_align, check=check)
    return logits, cache, align[None]


def mega_decoder_step(model: Whisper, token: torch.Tensor, position: Position,
                      cache: DecodeCache, capture_align: bool = True,
                      check: bool = True
                      ) -> Tuple[torch.Tensor, DecodeCache, torch.Tensor]:
    """One decode step of a packed model at batch 1: ``token`` (1, 1) at
    cache slot ``position`` (a host int or a device slot tensor, embedded
    at that row of the position table, clamped to its last). The contract
    of ``models.whisper.decoder_step``: returns (logits (1, V) f32, cache
    with slot ``position`` written, align (1, A, T_enc) f32, zeros unless
    ``capture_align``). CPU tensors take :func:`mega_decoder_step_plain`;
    CUDA tensors launch K3 or raise. ``check`` as for :func:`mega_step`."""
    return _run(model, token, position, cache, capture_align, plain=False,
                check=check)


def mega_decoder_step_plain(model: Whisper, token: torch.Tensor,
                            position: Position, cache: DecodeCache,
                            capture_align: bool = True
                            ) -> Tuple[torch.Tensor, DecodeCache, torch.Tensor]:
    """:func:`mega_decoder_step` in plain torch, on any device."""
    return _run(model, token, position, cache, capture_align, plain=True)


def mega_decoder_verify(model: Whisper, tokens: torch.Tensor,
                        position: Position, cache: DecodeCache,
                        plain: bool = False, check: bool = True
                        ) -> Tuple[torch.Tensor, DecodeCache, torch.Tensor]:
    """One speculative-verify window of a packed model at batch 1:
    ``tokens`` (1, W) whose first token sits at cache slot ``position``
    (a host int or a device slot tensor, as for
    :func:`mega_decoder_step`: a tensor is read by K4 when it runs, the
    self-attention planned for the cache's length). The contract of
    ``models.whisper.decoder_verify`` at batch 1: returns (logits (1, W, V)
    f32, cache with slots ``position .. position + W - 1`` written, align
    (1, W, A, T_enc) of zeros: K4 keeps no alignment, so decodes that need
    it take ``decoder_verify``). CPU tensors (or ``plain``) take
    :func:`mega_verify_plain`; CUDA tensors launch K4 or raise. ``check``
    as for :func:`mega_step`."""
    x = embed_tokens_at(model, tokens,
                        step_position(position, tokens.device))[0]  # (W, D)
    if plain:
        logits = mega_verify_plain(_packed(model), x, position, cache,
                                   model.arch)
    else:
        logits = mega_verify(_packed(model), x, position, cache, model.arch,
                             check=check)
    t = cache.cross_k.q.shape[3]
    align = torch.zeros(1, tokens.shape[1], max(1, len(model.arch.alignment_heads)),
                        t, device=tokens.device)
    return logits[None], cache, align
