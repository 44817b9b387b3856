"""Greedy, sampled and beam decode loops with alignment capture (port of
thewhisper_tpu's ``engine/decode.py``).

Semantics are the JAX loops': ``suppress`` masked at every step,
``begin_suppress`` at the first sampled position only, ``no_speech_prob``
read at the sot position, per-token logprobs, and a stop once every row
has emitted EOT or ``max_new_tokens`` are out.

JAX runs each loop as one ``lax.while_loop`` on the device. Here the loop
state lives in tensors on the device (step counter, tokens, done, sums,
per-token logprobs, alignment) and every step is one call of the same
step function on fixed shapes: the model's ``decoder_step`` takes its
position as a device tensor. Each step tests "step < max_new and not all
done" on the device and gates every write on it, so a step run after the
loop stopped changes nothing, and the host reads the flag only once every
``steps_per_check`` steps: the outputs are those of the loop that stops at
once, tails included. The same run of steps is what the engine captures
into a CUDA graph and replays on the card (``engine.graphs``); on the CPU,
and on the card with graphs off, it runs eagerly.

A batch-1 bf16 greedy step of a model packed for K3 (an "S" engine with
int8 cross K/V, where ``ops.mega_step.mega_pays``) goes to
``mega_decoder_step``, as the JAX loop sends it to its decode megakernel,
with the position as K3's device operand. Beam search uses
``decoder_step`` only, as JAX's does. Sampling (``temperature > 0``)
draws from a ``torch.Generator`` on the device by the exponential race
(``torch.multinomial``'s one-sample draw, without its host check of the
probabilities), so a sampled step is captured and replayed like a greedy
one: a graph registers the generator and replays its draws from the
generator's seed and offset at each replay, the eager draws' sequence.
The temperature may be a 0-dim device tensor, which a graph reads at
each replay: the engine's one sampled program serves every temperature.
Speculative decoding is ``engine.speculative``'s ``SpecLoop``, a loop of
the same pattern.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from thewhisper_tpu_torch.models.quant import QuantizedKV
from thewhisper_tpu_torch.models.whisper import (
    DecodeCache,
    Whisper,
    decoder_prefill,
    decoder_step,
)
from thewhisper_tpu_torch.ops.mega_step import (
    mega_decoder_step,
    raise_position_errors,
)

# Steps between two host reads of the loop's flag. A read costs about
# 0.035 ms (the synchronisation and the next replay's launch); a loop that
# stopped runs up to this many steps less one, 0.37-1.1 ms each, that
# change nothing. Two is near the least expected cost of both for a call
# that stops after 30 tokens (PERF.md §6; NVIDIA H100 80GB HBM3, 700 W).
STEPS_PER_CHECK = 2


def suppress_mask(vocab_size: int, token_ids: Sequence[int]) -> np.ndarray:
    """(V,) additive mask: -1e9 at suppressed ids, 0 elsewhere."""
    mask = np.zeros((vocab_size,), dtype=np.float32)
    ids = [t for t in token_ids if 0 <= t < vocab_size]
    mask[ids] = -1e9
    return mask


class GreedyResult(NamedTuple):
    tokens: torch.Tensor          # (B, P + max_new) int32; prompt + generated
    num_generated: torch.Tensor   # (B,) int32, count before/including EOT
    sum_logprob: torch.Tensor     # (B,) f32 over generated tokens
    align: torch.Tensor           # (B, A, P + max_new, T_enc) f32 (dummy if off)
    token_logprobs: torch.Tensor  # (B, max_new) f32 per generated token
    no_speech_prob: torch.Tensor  # (B,) f32 P(no_speech | sot) if id given
    # Verify rounds a speculative decode ran (engine.speculative); None
    # for plain greedy.
    rounds: Optional[int] = None
    # Step calls the loop ran (each one K3 launch on the K3 route): the
    # steps to the stop, rounded up to the host checks; None when
    # speculative.
    steps: Optional[int] = None


class BeamResult(NamedTuple):
    tokens: torch.Tensor          # (B, P + max_new) int32: best beam a sample
    num_generated: torch.Tensor   # (B,) int32
    sum_logprob: torch.Tensor     # (B,) f32 of the selected beam
    all_tokens: torch.Tensor      # (B, K, P + max_new) int32, every beam
    align: torch.Tensor           # (B, A, P + max_new, T_enc) best beam; dummy if off
    token_logprobs: torch.Tensor  # (B, max_new) f32 per token of the best beam
    no_speech_prob: torch.Tensor  # (B,) f32 P(no_speech | sot) if id given
    steps: Optional[int] = None   # step calls the loop ran


def _t_enc(cache: DecodeCache) -> int:
    ck = cache.cross_k
    return (ck.q if isinstance(ck, QuantizedKV) else ck).shape[3]


def _masked(x: torch.Tensor, suppress, begin_suppress, first: bool):
    if suppress is not None:
        x = x + suppress
    if first and begin_suppress is not None:
        x = x + begin_suppress
    return x


def _set_column(buf: torch.Tensor, col: torch.Tensor, value: torch.Tensor,
                active: torch.Tensor) -> None:
    """``buf[..., col] = value`` where ``active``, else unchanged; ``col``
    a (1,) int64 device index into the last axis of ``buf`` (..., N)."""
    idx = col.expand(*buf.shape[:-1], 1)
    old = buf.gather(-1, idx)[..., 0]
    buf.scatter_(-1, idx, torch.where(active, value, old)[..., None])


class _Loop:
    """What the greedy and beam loops share: the static state on the
    device, the host's count of step calls, and the run with its host
    checks. ``rows`` cache rows, tokens (rows, P + max_new)."""

    def __init__(self, model: Whisper, cache: DecodeCache, prompt_len: int,
                 max_new_tokens: int, eot: int, suppress, begin_suppress,
                 capture_alignment: bool, no_speech_id: Optional[int]):
        self.model = model
        self.cache = cache
        self.p = prompt_len
        self.max_new = max_new_tokens
        self.eot = eot
        self.suppress = suppress
        self.begin_suppress = begin_suppress
        self.capture = capture_alignment
        self.no_speech_id = no_speech_id
        rows = cache.self_k.shape[1]
        self.s_tok = prompt_len + max_new_tokens
        if cache.self_k.shape[3] < self.s_tok:
            raise ValueError(f"cache of {cache.self_k.shape[3]} slots for "
                             f"{self.s_tok} tokens")
        dev = cache.self_k.device
        self.device = dev
        n_align = max(1, len(model.arch.alignment_heads))
        self.align = (torch.zeros(rows, n_align, self.s_tok, _t_enc(cache),
                                  device=dev) if capture_alignment
                      else torch.zeros(rows, 1, 1, 1, device=dev))
        self.step = torch.zeros(1, dtype=torch.long, device=dev)
        self.calls = 0
        self.mega = False

    def _start_align(self, align_p: torch.Tensor) -> None:
        if self.capture:
            self.align.zero_()
            self.align[:, :, :self.p] = align_p.transpose(1, 2)

    def _put_align(self, slot: torch.Tensor, rows: torch.Tensor,
                   ok: torch.Tensor) -> None:
        """Alignment ``rows`` (rows, A, T) into slot ``slot`` ((1,) or
        (rows,) device index) of each row where ``ok`` ((1,) or (rows,)),
        else unchanged; a slot past the buffer is dropped."""
        if not self.capture:
            return
        n, a, _, t = self.align.shape
        idx = slot.clamp(max=self.s_tok - 1).view(-1, 1, 1, 1).expand(n, a, 1, t)
        keep = (ok & (slot < self.s_tok)).view(-1, 1, 1)
        old = self.align.gather(2, idx)[:, :, 0]
        self.align.scatter_(2, idx, torch.where(keep, rows, old)[:, :, None])

    def _active(self, done: torch.Tensor) -> torch.Tensor:
        """(1,) bool: the JAX loop's condition, on the device."""
        return (self.step < self.max_new) & ~done.all()

    def park(self) -> None:
        """Make every step a no-op (the step counter at max_new): the state
        in which the engine warms up and captures the step."""
        self.step.fill_(self.max_new)

    def steps(self, n: int, **kw) -> None:
        """``n`` step calls (what a graph of the loop captures)."""
        for _ in range(n):
            self._step(**kw)

    def run(self, steps_per_check: int = STEPS_PER_CHECK, replay=None,
            **kw) -> int:
        """Step until the loop stops, reading its flag on the host once
        every ``steps_per_check`` calls: eagerly, or ``replay()`` of a
        graph of ``steps_per_check`` calls. Returns the step calls made."""
        if steps_per_check < 1:
            raise ValueError(f"steps_per_check {steps_per_check} < 1")
        limit = self.max_new - 1
        while self.calls < limit:
            if replay is None:
                n = min(steps_per_check, limit - self.calls)
                self.steps(n, **kw)
            else:
                n = steps_per_check
                replay()
            self.calls += n
            if self.calls >= limit or not bool(self._active(self.done)):
                break
        if self.mega and self.device.type == "cuda":
            raise_position_errors(self.device)
        return self.calls


class GreedyLoop(_Loop):
    """The greedy (or sampled) loop over ``cache`` (B rows of at least
    P + max_new slots, the cross K/V in place): :meth:`start` prefills and
    picks the first token, :meth:`run` steps to the stop,
    :meth:`result` reads the outputs.

    ``noise_rows`` = (start, total): the rows are rows [start, start + B)
    of a batch of ``total`` (a dp rank's share of a meshed engine's
    bucket), and each sampled step draws the whole batch's noise and keeps
    theirs, so that they sample what the unsplit batch samples."""

    def __init__(self, model: Whisper, cache: DecodeCache, prompt_len: int,
                 max_new_tokens: int, eot: int, suppress=None,
                 begin_suppress=None, capture_alignment: bool = False,
                 no_speech_id: Optional[int] = None,
                 noise_rows: Optional[Tuple[int, int]] = None):
        super().__init__(model, cache, prompt_len, max_new_tokens, eot,
                         suppress, begin_suppress, capture_alignment,
                         no_speech_id)
        b = cache.self_k.shape[1]
        dev = self.device
        # The JAX loop's megakernel conditions; the engine packs the model
        # (model.mega) only where mega_pays, so packed means it pays.
        self.mega = (b == 1 and model.dtype == torch.bfloat16
                     and model.mega is not None
                     and isinstance(cache.cross_k, QuantizedKV))
        self.tokens = torch.zeros(b, self.s_tok, dtype=torch.long, device=dev)
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.sum_lp = torch.zeros(b, device=dev)
        self.token_lp = torch.zeros(b, max_new_tokens, device=dev)
        self.no_speech_prob = torch.zeros(b, device=dev)
        self.noise_rows = noise_rows or (0, b)

    def _pick(self, logits: torch.Tensor, first: bool,
              temperature: Union[float, torch.Tensor],
              generator: Optional[torch.Generator]):
        """The next tokens and their logprobs: the argmax, or a draw at
        ``temperature`` (a float > 0, or a 0-dim device tensor, which a
        graph reads at each replay)."""
        x = _masked(logits, self.suppress, self.begin_suppress, first)
        logprobs = torch.log_softmax(x, dim=-1)
        if torch.is_tensor(temperature) or temperature:
            # torch.multinomial's one-sample draw (p / q, q ~ Exp(1), its
            # argmax) without its host read of the probabilities' range.
            probs = torch.softmax(x / temperature, dim=-1)
            start, total = self.noise_rows
            q = probs.new_empty((total, probs.shape[1])).exponential_(
                1, generator=generator)[start:start + probs.shape[0]]
            nxt = torch.argmax(probs / q, dim=-1)
        else:
            nxt = torch.argmax(x, dim=-1)
        return nxt, logprobs.gather(-1, nxt[:, None])[:, 0]

    def start(self, prompt: torch.Tensor,
              temperature: Union[float, torch.Tensor] = 0.0,
              generator: Optional[torch.Generator] = None) -> None:
        """Prefill ``prompt`` (B, P) and set the state to step 1."""
        p = self.p
        logits_p, _, align_p = decoder_prefill(self.model, prompt, self.cache)
        self._start_align(align_p)
        nxt, lp = self._pick(logits_p[:, -1], True, temperature, generator)
        if self.no_speech_id is not None:
            self.no_speech_prob.copy_(
                torch.softmax(logits_p[:, 0], dim=-1)[:, self.no_speech_id])
        self.tokens.zero_()
        self.tokens[:, :p] = prompt
        self.tokens[:, p] = nxt
        self.token_lp.zero_()
        self.token_lp[:, 0] = lp
        self.done.copy_(nxt == self.eot)
        self.sum_lp.copy_(torch.where(self.done, 0.0, lp))
        self.step.fill_(1)
        self.calls = 0

    def _step(self, temperature: Union[float, torch.Tensor] = 0.0,
              generator: Optional[torch.Generator] = None) -> None:
        b = self.tokens.shape[0]
        active = self._active(self.done)
        pos = self.p + self.step - 1           # cache slot of the token fed
        tok = self.tokens.gather(1, pos.expand(b, 1))
        if self.mega:
            logits, _, align_step = mega_decoder_step(
                self.model, tok, pos, self.cache, self.capture, check=False)
        else:
            logits, _, align_step = decoder_step(self.model, tok, pos,
                                                 self.cache)
        nxt, lp = self._pick(logits, False, temperature, generator)
        nxt = torch.where(self.done, self.eot, nxt)
        finished = self.done | (nxt == self.eot)
        _set_column(self.tokens, (pos + 1).clamp(max=self.s_tok - 1), nxt,
                    active)
        self.sum_lp.copy_(torch.where(
            active, self.sum_lp + torch.where(finished, 0.0, lp), self.sum_lp))
        _set_column(self.token_lp, self.step.clamp(max=self.max_new - 1),
                    torch.where(self.done, 0.0, lp), active)
        self._put_align(pos, align_step, active)
        self.done.copy_(torch.where(active, finished, self.done))
        self.step.add_(active.long())

    def result(self) -> GreedyResult:
        is_eot = self.tokens[:, self.p:] == self.eot
        first_eot = torch.argmax(is_eot.int(), dim=1)
        num_generated = torch.where(is_eot.any(dim=1), first_eot, self.max_new)
        return GreedyResult(self.tokens.int(), num_generated.int(),
                            self.sum_lp, self.align, self.token_lp,
                            self.no_speech_prob, steps=self.calls)


def greedy_decode(
    model: Whisper,
    prompt: torch.Tensor,                  # (B, P) int
    cache: DecodeCache,
    max_new_tokens: int,
    eot: int,
    suppress: Optional[torch.Tensor] = None,        # (V,) additive
    begin_suppress: Optional[torch.Tensor] = None,  # (V,) additive
    capture_alignment: bool = False,
    no_speech_id: Optional[int] = None,
    temperature: float = 0.0,
    generator: Optional[torch.Generator] = None,
    steps_per_check: int = STEPS_PER_CHECK,
) -> GreedyResult:
    """Greedy (``temperature == 0``) or sampled decode, eagerly, the host
    reading the loop's flag once every ``steps_per_check`` steps (the
    outputs do not depend on it, sampled tokens included: a step past the
    stop draws, and changes nothing). Sampling draws from ``generator`` (a
    ``torch.Generator`` on the model's device)."""
    loop = GreedyLoop(model, cache, prompt.shape[1], max_new_tokens, eot,
                      suppress, begin_suppress, capture_alignment,
                      no_speech_id)
    loop.start(prompt, temperature, generator)
    loop.run(steps_per_check, temperature=temperature, generator=generator)
    return loop.result()


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: the k largest, ties in index
    order (``torch.topk`` promises no order among ties; a stable
    descending sort keeps the lower index first)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


class BeamLoop(_Loop):
    """Batched beam search (JAX's ``beam_decode``, HF's length penalty) over
    ``cache`` of B K rows (the cross K/V tiled per beam). Each step gathers
    the self cache, tokens, done flags, per-token logprobs and alignment by
    parent row into the same buffers."""

    def __init__(self, model: Whisper, cache: DecodeCache, prompt_len: int,
                 num_beams: int, max_new_tokens: int, eot: int,
                 suppress=None, begin_suppress=None,
                 length_penalty: float = 1.0, capture_alignment: bool = False,
                 no_speech_id: Optional[int] = None):
        super().__init__(model, cache, prompt_len, max_new_tokens, eot,
                         suppress, begin_suppress, capture_alignment,
                         no_speech_id)
        rows = cache.self_k.shape[1]
        if rows % num_beams:
            raise ValueError(f"{rows} cache rows for {num_beams} beams")
        self.k = num_beams
        self.b = b = rows // num_beams
        self.v = model.arch.vocab_size
        self.length_penalty = length_penalty
        dev = self.device
        self.tokens = torch.zeros(b, num_beams, self.s_tok, dtype=torch.long,
                                  device=dev)
        self.done = torch.zeros(b, num_beams, dtype=torch.bool, device=dev)
        self.sum_lp = torch.zeros(b, num_beams, device=dev)
        self.token_lp = torch.zeros(b, num_beams, max_new_tokens, device=dev)
        self.no_speech_prob = torch.zeros(b, device=dev)
        self._base = torch.arange(b, device=dev)[:, None] * num_beams
        self._identity = torch.arange(rows, device=dev)
        eot_only = torch.full((self.v,), -1e9, device=dev)
        eot_only[eot] = 0.0
        self._eot_only = eot_only

    def _logprobs(self, logits: torch.Tensor, first: bool,
                  done: torch.Tensor) -> torch.Tensor:
        """(B K, V) -> (B, K, V): finished beams may only extend with EOT,
        at zero cost."""
        x = _masked(logits, self.suppress, self.begin_suppress, first)
        logp = torch.log_softmax(x, dim=-1).view(self.b, self.k, self.v)
        return torch.where(done[:, :, None], self._eot_only, logp)

    def _select(self, sum_lp: torch.Tensor, logp: torch.Tensor):
        """(new sums, parent beams, tokens, parent rows), each (B, K) but
        the rows (B K,)."""
        cand = (sum_lp[:, :, None] + logp).reshape(self.b, self.k * self.v)
        new_sum, idx = _top_k(cand, self.k)
        parent = idx // self.v
        return new_sum, parent, idx % self.v, (self._base + parent).reshape(-1)

    def _gather(self, rows: torch.Tensor) -> None:
        """The self cache and the alignment by parent row, in place."""
        for buf in (self.cache.self_k, self.cache.self_v):
            buf.copy_(buf.index_select(1, rows))
        if self.capture:
            self.align.copy_(self.align.index_select(0, rows))

    def start(self, prompt: torch.Tensor) -> None:
        """Prefill every beam's copy of ``prompt`` (B, P), take the first K
        continuations from beam 0 (which carries the mass at the start)
        and set the state to step 1."""
        b, k, p = self.b, self.k, self.p
        flat = prompt[:, None, :].expand(b, k, p).reshape(b * k, p)
        logits_p, _, align_p = decoder_prefill(self.model, flat, self.cache)
        self._start_align(align_p)
        if self.no_speech_id is not None:
            self.no_speech_prob.copy_(torch.softmax(
                logits_p.view(b, k, p, self.v)[:, 0, 0], dim=-1
            )[:, self.no_speech_id])
        sum0 = (torch.where(torch.arange(k, device=self.device)[None, :] == 0,
                            0.0, -1e9) * torch.ones(b, 1, device=self.device))
        self.done.zero_()
        logp = self._logprobs(logits_p[:, -1], True, self.done)
        new_sum, parent, tok, rows = self._select(sum0, logp)
        self.tokens.zero_()
        self.tokens[:, :, :p] = prompt[:, None, :]
        self.tokens.copy_(self.tokens.view(b * k, -1).index_select(0, rows)
                          .view(b, k, -1))
        self.tokens[:, :, p] = tok
        self._gather(rows)
        self.done.copy_(tok == self.eot)
        self.token_lp.zero_()
        self.token_lp[:, :, 0] = new_sum - sum0.gather(1, parent)
        self.sum_lp.copy_(new_sum)
        self.step.fill_(1)
        self.calls = 0

    def _step(self) -> None:
        b, k = self.b, self.k
        active = self._active(self.done)
        pos = self.p + self.step - 1
        last = self.tokens.view(b * k, -1).gather(1, pos.expand(b * k, 1))
        logits, _, align_step = decoder_step(self.model, last, pos, self.cache)
        self._put_align(pos, align_step, active)
        logp = self._logprobs(logits, False, self.done)
        new_sum, parent, tok, rows = self._select(self.sum_lp, logp)
        rows = torch.where(active, rows, self._identity)
        toks = self.tokens.view(b * k, -1).index_select(0, rows).view(b, k, -1)
        _set_column(toks, (pos + 1).clamp(max=self.s_tok - 1), tok, active)
        new_done = (self.done.view(-1).index_select(0, rows).view(b, k)
                    | (tok == self.eot))
        # Token logprobs follow their beam's parent chain, then record
        # this step's increment (0 for finished beams).
        tlp = self.token_lp.view(b * k, -1).index_select(0, rows).view(
            b, k, -1)
        _set_column(tlp, self.step.clamp(max=self.max_new - 1),
                    new_sum - self.sum_lp.gather(1, parent), active)
        self._gather(rows)
        self.tokens.copy_(toks)
        self.token_lp.copy_(tlp)
        self.done.copy_(torch.where(active, new_done, self.done))
        self.sum_lp.copy_(torch.where(active, new_sum, self.sum_lp))
        self.step.add_(active.long())

    def result(self) -> BeamResult:
        b, k, p = self.b, self.k, self.p
        is_eot = self.tokens[:, :, p:] == self.eot
        first_eot = torch.argmax(is_eot.int(), dim=-1)
        lengths = torch.where(is_eot.any(dim=-1), first_eot, self.max_new)
        # HF's BeamHypotheses: the score divides by the whole hypothesis'
        # length, the forced prompt included.
        score = self.sum_lp / (p + lengths).float() ** self.length_penalty
        best = torch.argmax(score, dim=-1)
        bidx = torch.arange(b, device=self.device)
        align = (self.align.index_select(0, bidx * k + best) if self.capture
                 else torch.zeros(b, 1, 1, 1, device=self.device))
        return BeamResult(
            tokens=self.tokens[bidx, best].int(),
            num_generated=lengths[bidx, best].int(),
            sum_logprob=self.sum_lp[bidx, best],
            all_tokens=self.tokens.int(),
            align=align,
            token_logprobs=self.token_lp[bidx, best],
            no_speech_prob=self.no_speech_prob,
            steps=self.calls)


def beam_decode(
    model: Whisper,
    prompt: torch.Tensor,                  # (B, P) int
    cache: DecodeCache,                    # B K rows, cross K/V tiled
    num_beams: int,
    max_new_tokens: int,
    eot: int,
    suppress: Optional[torch.Tensor] = None,
    begin_suppress: Optional[torch.Tensor] = None,
    length_penalty: float = 1.0,
    capture_alignment: bool = False,
    no_speech_id: Optional[int] = None,
    steps_per_check: int = STEPS_PER_CHECK,
) -> BeamResult:
    """Beam search, eagerly, the host reading the loop's flag once every
    ``steps_per_check`` steps (JAX's ``beam_decode``: HF's defaults,
    length penalty 1.0)."""
    loop = BeamLoop(model, cache, prompt.shape[1], num_beams, max_new_tokens,
                    eot, suppress, begin_suppress, length_penalty,
                    capture_alignment, no_speech_id)
    loop.start(prompt)
    loop.run(steps_per_check)
    return loop.result()
