"""Speculative greedy decoding: draft W tokens cheaply, verify them in one
pass (port of thewhisper_tpu's ``engine/speculative.py``).

Each round the draft proposes ``spec_window`` (W) tokens, the target scores
the window ``[newest accepted, d_1 .. d_W]`` in one
``models.whisper.decoder_verify`` pass, accepts the longest prefix that
matches its own greedy picks and adds its own pick at the first mismatch.
Every round advances 1 .. W + 1 tokens and every emitted token is the
target's greedy choice: the output equals ``engine.decode.greedy_decode``
for any draft (exactly at f32; at bf16 the window pass rounds other shapes
than the step, so a near-tied argmax may resolve differently).

Drafts: a model (a separate checkpoint sharing the encoder width, or
:func:`make_layer_skip_draft`, the target's first N decoder layers),
prompt lookup (``ngram_draft``, the JAX package's two-tier rule) or
caller-supplied proposal tokens. The bookkeeping (accept count, bonus
token, the first EOT in the accepted run, the in-budget logprob sum, the
final EOT fill) is the JAX loop's, so the round count matches it too.

The loop runs on the host, one round per iteration, and reads back one
small tensor a round: the all-done flag and, on the K4 route, the batch-1
window position. A batch-1 bf16 decode of a model packed for K3/K4 (an "S"
engine with int8 cross K/V) without alignment capture and with W + 1 <= 16
sends each verify round to ``ops.mega_step.mega_decoder_verify`` (K4), as
the JAX loop sends it to its verify megakernel.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from thewhisper_tpu_torch.config import WhisperArch
from thewhisper_tpu_torch.engine.decode import GreedyResult
from thewhisper_tpu_torch.models.quant import (
    Int8Embedding,
    QuantizedKV,
    W8A8Linear,
)
from thewhisper_tpu_torch.models.whisper import (
    DecodeCache,
    Whisper,
    decoder_prefill,
    decoder_verify,
)
from thewhisper_tpu_torch.ops.mega_step import MAX_WINDOW, mega_decoder_verify


def make_layer_skip_draft(model: Whisper, n_layers: int) -> Whisper:
    """A decoder-only draft made of the target's first ``n_layers`` decoder
    layers, its final LayerNorm and its tables: the same modules, no copy.
    Alignment heads beyond the kept layers are dropped."""
    arch = dataclasses.replace(
        model.arch, decoder_layers=n_layers,
        alignment_heads=tuple((l, h) for l, h in model.arch.alignment_heads
                              if l < n_layers))
    with torch.device("meta"):
        draft = Whisper(dataclasses.replace(arch, decoder_layers=0))
    draft.arch = arch
    draft.encoder = None
    dec, src = draft.decoder, model.decoder
    dec.layers = nn.ModuleList(src.layers[:n_layers])
    for name in ("token_emb", "pos_emb", "ln_post"):
        delattr(dec, name)
        setattr(dec, name, getattr(src, name))
    return draft


# ---------------------------------------------------------------------------
# JAX's draft format: the decoder tree as one .npz (keys "decoder/...",
# stacked (L, in, out) linears) plus the arch as .json.
# ---------------------------------------------------------------------------


def _stem(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def _linear_leaf(mods):
    """The layers' linears as one JAX leaf: (L, in, out) float, or
    {"q": (L, in, out) int8, "s": (L, out)} (``q8``/``s8`` for W8A8)."""
    w = torch.stack([m.weight.detach() for m in mods]).transpose(1, 2).cpu()
    if type(mods[0]) is nn.Linear:
        return w.float().numpy()
    q, s = ("q8", "s8") if isinstance(mods[0], W8A8Linear) else ("q", "s")
    return {q: w.numpy(), s: torch.stack([m.scale for m in mods]).cpu().numpy()}


def _decoder_tree(model: Whisper) -> dict:
    """The decoder in JAX's parameter layout, as numpy (the inverse of
    ``models.load.params_from_jax`` for the decoder)."""
    dec = model.decoder
    layers = list(dec.layers)
    f32 = lambda t: t.detach().float().cpu().numpy()          # noqa: E731

    def stack(get):
        return np.stack([f32(get(l)) for l in layers])

    def attn(get):
        out = {"o_w": _linear_leaf([get(l).out for l in layers]),
               "o_b": stack(lambda l: get(l).out.bias)}
        if hasattr(get(layers[0]), "qkv"):
            out["qkv_w"] = _linear_leaf([get(l).qkv for l in layers])
            out["qkv_b"] = stack(lambda l: get(l).qkv.bias)
            return out
        for n in "qkv":
            out[f"{n}_w"] = _linear_leaf([getattr(get(l), n) for l in layers])
        out["q_b"] = stack(lambda l: get(l).q.bias)
        out["v_b"] = stack(lambda l: get(l).v.bias)
        return out

    tree = {
        "self": attn(lambda l: l.self_attn),
        "cross": attn(lambda l: l.cross_attn),
        "mlp": {"fc1_w": _linear_leaf([l.fc1 for l in layers]),
                "fc1_b": stack(lambda l: l.fc1.bias),
                "fc2_w": _linear_leaf([l.fc2 for l in layers]),
                "fc2_b": stack(lambda l: l.fc2.bias)},
    }
    for ln in ("ln1", "ln_cross", "ln2"):
        tree[ln] = {"scale": stack(lambda l: getattr(l, ln).weight),
                    "bias": stack(lambda l: getattr(l, ln).bias)}
    emb = dec.token_emb
    return {
        "token_emb": ({"q": emb.q.cpu().numpy(), "s": emb.s.cpu().numpy()}
                      if isinstance(emb, Int8Embedding) else f32(emb)),
        "pos_emb": f32(dec.pos_emb),
        "ln_post": {"scale": f32(dec.ln_post.weight),
                    "bias": f32(dec.ln_post.bias)},
        "layers": tree,
    }


def save_draft(path: str, draft: Whisper) -> None:
    """Write a draft's decoder as JAX's ``save_draft`` does: ``<path>.npz``
    (float, weight-only int8 or W8A8 linears, fused or not) and
    ``<path>.json`` (the arch), loadable by either package."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        else:
            flat[prefix] = node

    walk("decoder", _decoder_tree(draft))
    np.savez(_stem(path) + ".npz", **flat)
    with open(_stem(path) + ".json", "w") as f:
        json.dump(dataclasses.asdict(draft.arch), f)


def load_draft(path: str, dtype: torch.dtype = torch.float32,
               device="cuda") -> Whisper:
    """A draft written by either package's ``save_draft``, as a
    decoder-only model in ``dtype`` (float leaves) on ``device`` (the card
    unless the caller names the CPU)."""
    from thewhisper_tpu_torch.models.load import params_from_jax

    tree: dict = {}
    with np.load(_stem(path) + ".npz") as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    with open(_stem(path) + ".json") as f:
        meta = json.load(f)
    meta["alignment_heads"] = tuple(
        tuple(h) for h in meta.get("alignment_heads", ()))
    return params_from_jax(tree, WhisperArch(**meta), dtype=dtype,
                           device=device)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


def ngram_propose(tokens: torch.Tensor, feed_pos: torch.Tensor,
                  w0: torch.Tensor, w: int) -> torch.Tensor:
    """Prompt-lookup draft (B, W): the continuation of an earlier occurrence
    of the (previous, current) bigram in the token buffer. Two tiers: the
    most recent hit whose W-token continuation lies wholly below the write
    frontier, else the most recent hit; without a hit, the tokens from the
    frontier on (JAX's ``ngram_propose``)."""
    b, s_buf = tokens.shape
    prev = tokens.gather(1, (feed_pos - 1).clamp(min=0)[:, None])
    nxt = torch.cat([tokens[:, 1:], tokens.new_zeros(b, 1)], dim=1)
    j = torch.arange(s_buf, device=tokens.device)[None, :]
    hit = ((tokens == prev) & (nxt == w0)
           & (j + 1 < feed_pos[:, None]) & (j > 0))
    full = hit & (j + w + 1 <= feed_pos[:, None])
    j_any = torch.where(hit, j, -1).argmax(dim=1)
    j_full = torch.where(full, j, -1).argmax(dim=1)
    j_sel = torch.where(full.any(dim=1), j_full, j_any)
    start = torch.where(hit.any(dim=1), j_sel + 2, feed_pos)
    rows = (start[:, None] + torch.arange(w, device=tokens.device)
            ).clamp(0, s_buf - 1)
    return tokens.gather(1, rows)


def speculative_decode(
    model: Whisper,
    draft_model: Optional[Whisper],
    prompt: torch.Tensor,                  # (B, P) int
    cache: DecodeCache,                    # >= P + max_new + W + 1 slots
    draft_cache: Optional[DecodeCache],    # the same, draft geometry
    max_new_tokens: int,
    eot: int,
    spec_window: int = 4,
    suppress: Optional[torch.Tensor] = None,        # (V,) additive
    begin_suppress: Optional[torch.Tensor] = None,  # (V,) additive
    capture_alignment: bool = False,
    no_speech_id: Optional[int] = None,
    ngram_draft: bool = False,
    proposal_tokens: Optional[torch.Tensor] = None,  # (B, >= max_new) int
) -> GreedyResult:
    """Greedy decode by draft and verify; the output is
    ``greedy_decode``'s, with ``rounds`` the verify rounds run.

    ``proposal_tokens`` (row i: the guessed i-th generated token) take
    precedence over ``ngram_draft``; both need no draft model or cache
    (``draft_model`` and ``draft_cache`` may be None)."""
    w = spec_window
    b, p = prompt.shape
    dev = prompt.device
    s_buf = cache.self_k.shape[3]
    if s_buf < p + max_new_tokens + w + 1:
        raise ValueError(f"cache has {s_buf} slots; speculative decoding "
                         f"needs {p + max_new_tokens + w + 1}")
    ck = cache.cross_k
    t_enc = (ck.q if isinstance(ck, QuantizedKV) else ck).shape[3]
    n_align = max(1, len(model.arch.alignment_heads))
    lp_buf = max_new_tokens + w + 1
    model_free = ngram_draft or proposal_tokens is not None
    if proposal_tokens is not None:
        # Indexed by generated position; padded so that every read is in range.
        proposal_tokens = torch.nn.functional.pad(
            proposal_tokens.long(),
            (0, max(0, max_new_tokens + w - proposal_tokens.shape[1])))
    # The JAX loop's verify-megakernel conditions; the engine packs the
    # model (model.mega) only where mega_pays, so packed means it pays.
    use_mega = (b == 1 and model.dtype == torch.bfloat16
                and not capture_alignment and w + 1 <= MAX_WINDOW
                and model.mega is not None and isinstance(ck, QuantizedKV))

    logits_p, cache, align_p = decoder_prefill(model, prompt, cache)
    if not model_free:
        decoder_prefill(draft_model, prompt, draft_cache)
    if capture_alignment:
        align = torch.zeros(b, n_align, s_buf, t_enc, device=dev)
        align[:, :, :p] = align_p.transpose(1, 2)
    else:
        align = torch.zeros(b, 1, 1, 1, device=dev)

    def masked(x, first: bool):
        if suppress is not None:
            x = x + suppress
        if first and begin_suppress is not None:
            x = x + begin_suppress
        return x

    x0 = masked(logits_p[:, -1], True)
    first_tok = x0.argmax(dim=-1)
    first_lp = torch.log_softmax(x0, dim=-1).gather(1, first_tok[:, None])[:, 0]
    if no_speech_id is not None:
        no_speech_prob = torch.softmax(logits_p[:, 0], dim=-1)[:, no_speech_id]
    else:
        no_speech_prob = torch.zeros(b, device=dev)

    tokens = torch.zeros(b, s_buf, dtype=torch.long, device=dev)
    tokens[:, :p] = prompt
    tokens[:, p] = first_tok
    done = (first_tok == eot) | (max_new_tokens <= 1)
    token_lp = torch.zeros(b, lp_buf, device=dev)
    token_lp[:, 0] = first_lp
    sum_lp = torch.where(first_tok == eot, 0.0, first_lp)
    n_acc = torch.ones(b, dtype=torch.long, device=dev)
    rows_b = torch.arange(b, device=dev)
    jidx = torch.arange(w + 1, device=dev)[None, :]
    rounds = 0

    while True:
        # One read-back a round: all done, and row 0's accepted count.
        all_done, n0 = torch.stack([done.all().long(), n_acc[0]]).tolist()
        if all_done:
            break
        feed_pos = p + n_acc - 1                             # (B,)
        w0 = tokens.gather(1, feed_pos[:, None])

        # Draft W tokens.
        if proposal_tokens is not None:
            rows = (n_acc[:, None] + jidx[:, :w]).clamp(
                0, proposal_tokens.shape[1] - 1)
            drafts = proposal_tokens.gather(1, rows)
        elif ngram_draft:
            drafts = ngram_propose(tokens, feed_pos, w0, w)
        else:
            # W + 1 steps, not W: the last only writes d_W's k/v into the
            # draft cache. Without it a round that accepts the whole window
            # leaves a hole below every later window start.
            cur, outs = w0, []
            for j in range(w + 1):
                dl, _, _ = decoder_verify(draft_model, cur, feed_pos + j,
                                          draft_cache)
                cur = masked(dl[:, 0], False).argmax(dim=-1, keepdim=True)
                outs.append(cur)
            drafts = torch.cat(outs[:w], dim=1)

        # Verify the window in one target pass.
        window = torch.cat([w0, drafts], dim=1)              # (B, W + 1)
        if use_mega:
            vlogits, _, valign = mega_decoder_verify(
                model, window, p + n0 - 1, cache)
        else:
            vlogits, _, valign = decoder_verify(model, window, feed_pos, cache)
        sl = masked(vlogits, False)
        pred = sl.argmax(dim=-1)                             # (B, W + 1)
        logp = torch.log_softmax(sl, dim=-1)

        match = pred[:, :w] == drafts
        m = match.long().cumprod(dim=1).sum(dim=1)           # accepted drafts
        bonus = pred.gather(1, m[:, None])
        drafts_pad = torch.cat([drafts, drafts.new_zeros(b, 1)], dim=1)
        new_tok = torch.where(jidx < m[:, None], drafts_pad, bonus)
        lp_tok = logp.gather(2, new_tok[:, :, None])[:, :, 0]

        # Stop at the first EOT of the accepted run: written, not counted.
        is_eot = (new_tok == eot) & (jidx <= m[:, None])
        has_eot = is_eot.any(dim=1)
        first_e = is_eot.long().argmax(dim=1)
        n_new = torch.where(has_eot, first_e + 1, m + 1)     # tokens to write
        live = ~done
        wsel = (jidx < n_new[:, None]) & live[:, None]       # (B, W + 1)

        # New tokens at feed_pos + 1 + j, logprobs at generated index
        # n_acc + j, alignment rows j <= m at slot feed_pos + j; one column
        # of the window at a time, each row writing one slot.
        for j in range(w + 1):
            ok = wsel[:, j]
            slot = (feed_pos + 1 + j).clamp(max=s_buf - 1)
            tokens[rows_b, slot] = torch.where(ok, new_tok[:, j],
                                               tokens[rows_b, slot])
            g = (n_acc + j).clamp(max=lp_buf - 1)
            token_lp[rows_b, g] = torch.where(ok, lp_tok[:, j],
                                              token_lp[rows_b, g])
            if capture_alignment:
                fed = ((j <= m) & live)[:, None, None]
                slot = (feed_pos + j).clamp(max=s_buf - 1)
                align[rows_b, :, slot] = torch.where(
                    fed, valign[:, j], align[rows_b, :, slot])

        # Greedy sums the non-EOT logprobs and never past max_new tokens
        # (the last round may overshoot).
        in_budget = n_acc[:, None] + jidx < max_new_tokens
        inc = torch.where(wsel & in_budget & (new_tok != eot), lp_tok,
                          0.0).sum(dim=1)
        sum_lp = torch.where(live, sum_lp + inc, sum_lp)
        n_acc = n_acc + torch.where(live, n_new, 0)
        done = done | (has_eot & live) | (n_acc >= max_new_tokens)
        rounds += 1

    s_out = p + max_new_tokens
    gen = tokens[:, p:s_out]
    is_eot = gen == eot
    any_eot = is_eot.any(dim=1)
    stop = torch.where(any_eot, is_eot.long().argmax(dim=1), max_new_tokens)
    # Past the first EOT everything is EOT, as greedy keeps feeding it.
    past = torch.arange(max_new_tokens, device=dev)[None, :] > stop[:, None]
    gen = torch.where(past, eot, gen)
    toks = torch.cat([tokens[:, :p], gen], dim=1)
    if capture_alignment:
        align = align[:, :, :s_out]
    return GreedyResult(toks.int(), stop.int(), sum_lp, align,
                        token_lp[:, :max_new_tokens], no_speech_prob,
                        rounds=rounds)
