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

JAX runs the loop as one ``lax.while_loop``. Here :class:`SpecLoop` keeps
its state in device tensors, as ``engine.decode``'s loops do, and a round
is the same function on fixed shapes that reads nothing back to the host
(``decoder_verify``'s cache write and K4's window position live on the
device): the engine captures rounds into a CUDA graph and replays them,
the host reading the stop flag between replays. A batch-1 bf16 decode of a
model packed for K3/K4 (an "S" engine with int8 cross K/V) without
alignment capture and with W + 1 <= 16 sends each verify round to
``ops.mega_step.mega_decoder_verify`` (K4), as the JAX loop sends it to
its verify megakernel.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from thewhisper_tpu_torch.config import WhisperArch
from thewhisper_tpu_torch.engine.decode import GreedyResult, _Loop, _masked
from thewhisper_tpu_torch.models.quant import (
    Int4Linear,
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

# Rounds between two host reads of the loop's stop flag. A round is a
# verify pass of the whole decoder (and, with a model draft, W + 1 draft
# passes): more than the read it would save (about 0.035 ms, PERF.md §6),
# so the host reads the flag after every round and no round runs past
# the stop (K4's launches are then the verify rounds).
ROUNDS_PER_CHECK = 1


def make_layer_skip_draft(model: Whisper, n_layers: int) -> Whisper:
    """A decoder-only draft made of the target's first ``n_layers`` decoder
    layers, its final LayerNorm and its tables: the same modules, no copy.
    Alignment heads beyond the kept layers are dropped. The draft of a
    target sharded by ``parallel.mesh.shard_params`` is sharded as its
    layers are: it takes the target's tp group (``tp``), so its alignment
    capture and checks count the heads of every tp rank."""
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
    draft.tp = model.tp
    return draft


# ---------------------------------------------------------------------------
# JAX's draft format: the decoder tree as one .npz (keys "decoder/...",
# stacked (L, in, out) linears) plus the arch as .json.
# ---------------------------------------------------------------------------


def _stem(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def _linear_leaf(mods):
    """The layers' linears as one JAX leaf: (L, in, out) float, or
    {"q": (L, in, out) int8, "s": (L, out)} (``q8``/``s8`` for W8A8).
    int4 linears raise ``ValueError``: JAX's ``save_draft`` writes a
    ``jnp.int4`` leaf as raw one-byte voids that its ``load_draft`` cannot
    read, so the format has no int4 leaf."""
    if isinstance(mods[0], Int4Linear):
        raise ValueError(
            "save_draft: int4 (\"S4\") linears have no form in the draft "
            "format (JAX writes them as raw bytes its load_draft cannot "
            "read); save the float draft, or an int8 one")
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
    ``<path>.json`` (the arch), loadable by either package. A draft with
    int4 linears (sliced from an "S4" target) raises ``ValueError``."""
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


class SpecLoop(_Loop):
    """The speculative loop over ``cache`` (B rows of at least
    P + max_new + W + 1 slots, the cross K/V in place) and, for a model
    draft, ``draft_cache`` (the same slots, the draft's cross K/V in
    place): :meth:`start` prefills and picks the first token, :meth:`run`
    runs rounds to the stop, :meth:`result` reads the outputs. The state
    lives in device tensors: the token buffer, accepted counts, done
    flags, logprob sums, per-token logprobs, alignment and the round
    counter. A round gates every write of the state on its row being
    live, so with every row done it changes nothing (the self caches of
    finished rows aside, which no output reads), and the host reads the
    stop flag once every ``steps_per_check`` rounds without changing an
    output; ``steps(n)``, n rounds, is what the engine captures into a
    CUDA graph. As JAX's ``while_loop`` tests its condition first, a loop
    whose rows are all done after the prefill runs no round.

    ``ngram_draft`` drafts by prompt lookup; ``proposals`` takes the
    drafts from a (B, max_new + W) buffer that :meth:`start` fills (model
    free, either way: ``draft_model`` and ``draft_cache`` may be None).
    A batch-1 bf16 loop of a model packed for K3/K4 (an "S" engine with
    int8 cross K/V) without alignment capture and with W + 1 <= 16 sends
    each verify to ``ops.mega_step.mega_decoder_verify`` (K4), its window
    position the device tensor ``P + n_acc - 1``, clamped into the cache
    (a round past the stop verifies somewhere, and writes nothing that is
    read), as the JAX loop sends it to its verify megakernel."""

    def __init__(self, model: Whisper, draft_model: Optional[Whisper],
                 cache: DecodeCache, draft_cache: Optional[DecodeCache],
                 prompt_len: int, max_new_tokens: int, eot: int,
                 spec_window: int = 4, suppress=None, begin_suppress=None,
                 capture_alignment: bool = False,
                 no_speech_id: Optional[int] = None,
                 ngram_draft: bool = False, proposals: bool = False):
        super().__init__(model, cache, prompt_len, max_new_tokens, eot,
                         suppress, begin_suppress, capture_alignment,
                         no_speech_id)
        w = self.w = spec_window
        b = cache.self_k.shape[1]
        s_buf = self.s_buf = cache.self_k.shape[3]
        if s_buf < prompt_len + max_new_tokens + w + 1:
            raise ValueError(
                f"cache has {s_buf} slots; speculative decoding needs "
                f"{prompt_len + max_new_tokens + w + 1}")
        dev = self.device
        self.draft_model, self.draft_cache = draft_model, draft_cache
        self.proposals = (torch.zeros(b, max_new_tokens + w, dtype=torch.long,
                                      device=dev) if proposals else None)
        self.ngram = ngram_draft and not proposals
        self.model_free = ngram_draft or proposals
        # The JAX loop's verify-megakernel conditions; the engine packs the
        # model (model.mega) only where mega_pays, so packed means it pays.
        self.mega = (b == 1 and model.dtype == torch.bfloat16
                     and not capture_alignment and w + 1 <= MAX_WINDOW
                     and model.mega is not None
                     and isinstance(cache.cross_k, QuantizedKV))
        self.lp_buf = max_new_tokens + w + 1
        self.tokens = torch.zeros(b, s_buf, dtype=torch.long, device=dev)
        self.n_acc = torch.ones(b, dtype=torch.long, device=dev)
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.sum_lp = torch.zeros(b, device=dev)
        self.token_lp = torch.zeros(b, self.lp_buf, device=dev)
        self.no_speech_prob = torch.zeros(b, device=dev)
        self._j = torch.arange(w + 1, device=dev)[None, :]

    def _active(self, done: torch.Tensor) -> torch.Tensor:
        """(1,) bool: the JAX loop's condition, on the device."""
        return ~done.all().reshape(1)

    def park(self) -> None:
        """Make every round a no-op (every row done)."""
        self.done.fill_(True)

    def start(self, prompt: torch.Tensor,
              proposals: Optional[torch.Tensor] = None) -> None:
        """Prefill ``prompt`` (B, P) into the target's cache and a model
        draft's, pick the first token and set the state to round 0.
        ``proposals`` (B, >= max_new; row i the guessed i-th generated
        token) fill the loop's proposal buffer, zero-padded or cut."""
        p = self.p
        logits_p, _, align_p = decoder_prefill(self.model, prompt, self.cache)
        if not self.model_free:
            decoder_prefill(self.draft_model, prompt, self.draft_cache)
        self._start_align(align_p)
        if self.proposals is not None:
            n = min(proposals.shape[1], self.proposals.shape[1])
            self.proposals.zero_()
            self.proposals[:, :n] = proposals[:, :n]
        x0 = _masked(logits_p[:, -1], self.suppress, self.begin_suppress, True)
        first = x0.argmax(dim=-1)
        first_lp = torch.log_softmax(x0, dim=-1).gather(1, first[:, None])[:, 0]
        if self.no_speech_id is not None:
            self.no_speech_prob.copy_(
                torch.softmax(logits_p[:, 0], dim=-1)[:, self.no_speech_id])
        self.tokens.zero_()
        self.tokens[:, :p] = prompt
        self.tokens[:, p] = first
        self.done.copy_((first == self.eot) | (self.max_new <= 1))
        self.token_lp.zero_()
        self.token_lp[:, 0] = first_lp
        self.sum_lp.copy_(torch.where(first == self.eot, 0.0, first_lp))
        self.n_acc.fill_(1)
        self.step.zero_()
        self.calls = 0

    def run(self, steps_per_check: int = ROUNDS_PER_CHECK, replay=None,
            **kw) -> int:
        """Rounds to the stop (``_Loop.run``), none if every row is done
        after the prefill: one host read of the flag before the first."""
        if not bool(self._active(self.done)):
            return self.calls
        return super().run(steps_per_check, replay, **kw)

    def _draft(self, feed_pos: torch.Tensor, w0: torch.Tensor) -> torch.Tensor:
        """The round's W drafted tokens (B, W)."""
        w = self.w
        if self.proposals is not None:
            rows = (self.n_acc[:, None] + self._j[:, :w]).clamp(
                max=self.proposals.shape[1] - 1)
            return self.proposals.gather(1, rows)
        if self.ngram:
            return ngram_propose(self.tokens, feed_pos, w0, w)
        # W + 1 steps, not W: the last only writes d_W's k/v into the draft
        # cache. Without it a round that accepts the whole window leaves a
        # hole below every later window start.
        cur, outs = w0, []
        for j in range(w + 1):
            dl, _, _ = decoder_verify(self.draft_model, cur, feed_pos + j,
                                      self.draft_cache)
            cur = _masked(dl[:, 0], self.suppress, None, False).argmax(
                dim=-1, keepdim=True)
            outs.append(cur)
        return torch.cat(outs[:w], dim=1)

    def _step(self) -> None:
        """One round: draft, verify, accept (the JAX loop's body)."""
        w, eot, jidx = self.w, self.eot, self._j
        live = ~self.done
        n_acc = self.n_acc
        feed_pos = self.p + n_acc - 1                        # (B,)
        w0 = self.tokens.gather(1, feed_pos[:, None])
        drafts = self._draft(feed_pos, w0)

        # Verify the window in one target pass.
        window = torch.cat([w0, drafts], dim=1)              # (B, W + 1)
        if self.mega:
            pos = feed_pos[:1].clamp(0, self.s_buf - w - 1)
            vlogits, _, valign = mega_decoder_verify(
                self.model, window, pos, self.cache, check=False)
        else:
            vlogits, _, valign = decoder_verify(self.model, window, feed_pos,
                                                self.cache)
        sl = _masked(vlogits, self.suppress, None, False)
        pred = sl.argmax(dim=-1)                             # (B, W + 1)
        logp = torch.log_softmax(sl, dim=-1)

        match = pred[:, :w] == drafts
        m = match.long().cumprod(dim=1).sum(dim=1)           # accepted drafts
        bonus = pred.gather(1, m[:, None])
        drafts_pad = torch.cat([drafts, drafts.new_zeros(drafts.shape[0], 1)],
                               dim=1)
        new_tok = torch.where(jidx < m[:, None], drafts_pad, bonus)
        lp_tok = logp.gather(2, new_tok[:, :, None])[:, :, 0]

        # Stop at the first EOT of the accepted run: written, not counted.
        is_eot = (new_tok == eot) & (jidx <= m[:, None])
        has_eot = is_eot.any(dim=1)
        first_e = is_eot.long().argmax(dim=1)
        n_new = torch.where(has_eot, first_e + 1, m + 1)     # tokens to write
        wsel = (jidx < n_new[:, None]) & live[:, None]       # (B, W + 1)

        # New tokens at feed_pos + 1 + j and logprobs at generated index
        # n_acc + j: a live row's slots lie inside the buffers; a finished
        # row's may clamp onto one slot, which each of them rewrites with
        # what it held.
        for buf, col, val in ((self.tokens, feed_pos[:, None] + 1 + jidx,
                               new_tok),
                              (self.token_lp, n_acc[:, None] + jidx, lp_tok)):
            col = col.clamp(max=buf.shape[1] - 1)
            buf.scatter_(1, col, torch.where(wsel, val, buf.gather(1, col)))
        # Alignment rows j <= m at slot feed_pos + j, one column at a time.
        fed = (jidx <= m[:, None]) & live[:, None]
        for j in range(w + 1):
            self._put_align(feed_pos + j, valign[:, j], fed[:, j])

        # Greedy sums the non-EOT logprobs and never past max_new tokens
        # (the last round may overshoot).
        in_budget = n_acc[:, None] + jidx < self.max_new
        inc = torch.where(wsel & in_budget & (new_tok != eot), lp_tok,
                          0.0).sum(dim=1)
        self.sum_lp.copy_(torch.where(live, self.sum_lp + inc, self.sum_lp))
        self.step.add_(live.any().long())
        n_acc.add_(torch.where(live, n_new, 0))
        self.done.copy_(self.done | (has_eot & live)
                        | (n_acc >= self.max_new))

    def result(self) -> GreedyResult:
        """The outputs (``rounds`` read from the device's round counter)."""
        p, max_new = self.p, self.max_new
        gen = self.tokens[:, p:p + max_new]
        is_eot = gen == self.eot
        stop = torch.where(is_eot.any(dim=1), is_eot.long().argmax(dim=1),
                           max_new)
        # Past the first EOT everything is EOT, as greedy keeps feeding it.
        past = torch.arange(max_new, device=self.device)[None, :] > stop[:, None]
        gen = torch.where(past, self.eot, gen)
        toks = torch.cat([self.tokens[:, :p], gen], dim=1)
        return GreedyResult(toks.int(), stop.int(), self.sum_lp, self.align,
                            self.token_lp[:, :max_new], self.no_speech_prob,
                            rounds=int(self.step))


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
    """Greedy decode by draft and verify, eagerly (a :class:`SpecLoop`
    whose host reads the stop flag every ``ROUNDS_PER_CHECK`` rounds); the
    output is ``greedy_decode``'s, with ``rounds`` the verify rounds run.

    ``proposal_tokens`` (row i: the guessed i-th generated token) take
    precedence over ``ngram_draft``; both need no draft model or cache
    (``draft_model`` and ``draft_cache`` may be None)."""
    loop = SpecLoop(model, draft_model, cache, draft_cache, prompt.shape[1],
                    max_new_tokens, eot, spec_window, suppress, begin_suppress,
                    capture_alignment, no_speech_id, ngram_draft=ngram_draft,
                    proposals=proposal_tokens is not None)
    loop.start(prompt, proposal_tokens)
    loop.run(ROUNDS_PER_CHECK)
    return loop.result()
