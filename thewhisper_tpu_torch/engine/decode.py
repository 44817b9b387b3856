"""Greedy (and temperature-sampled) decode loop with alignment capture
(port of thewhisper_tpu's ``engine/decode.py``).

Semantics are the JAX loop's: ``suppress`` masked at every step,
``begin_suppress`` at the first sampled position only, ``no_speech_prob``
read at the sot position, per-token logprobs, and a stop once every row has
emitted EOT or ``max_new_tokens`` are out. The loop runs on the host, one
:func:`decoder_step` per token; the all-done test reads one flag back per
step. A batch-1 bf16 step of a model packed for K3 (an "S" engine with
int8 cross K/V, where ``ops.mega_step.mega_pays``) goes to
``mega_decoder_step`` instead, as the JAX loop sends it to its decode
megakernel; the outputs are the same fields either way. Speculative
decoding is ``engine.speculative``; beam search is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from thewhisper_tpu_torch.models.quant import QuantizedKV
from thewhisper_tpu_torch.models.whisper import (
    DecodeCache,
    Whisper,
    decoder_prefill,
    decoder_step,
)
from thewhisper_tpu_torch.ops.mega_step import mega_decoder_step


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
) -> GreedyResult:
    """Greedy (``temperature == 0``) or sampled decode. Sampling draws from
    ``generator`` (a ``torch.Generator`` on the model's device)."""
    b, p = prompt.shape
    dev = prompt.device
    s_max = p + max_new_tokens
    ck = cache.cross_k
    t_enc = (ck.q if isinstance(ck, QuantizedKV) else ck).shape[3]
    # The JAX loop's megakernel conditions; the engine packs the model
    # (model.mega) only where mega_pays, so packed means it pays.
    use_mega = (b == 1 and model.dtype == torch.bfloat16
                and model.mega is not None and isinstance(ck, QuantizedKV))
    n_align = max(1, len(model.arch.alignment_heads))

    logits_p, cache, align_p = decoder_prefill(model, prompt, cache)
    if capture_alignment:
        align = torch.zeros(b, n_align, s_max, t_enc, device=dev)
        align[:, :, :p] = align_p.transpose(1, 2)
    else:
        align = torch.zeros(b, 1, 1, 1, device=dev)

    def pick(step_logits: torch.Tensor, first: bool):
        x = step_logits
        if suppress is not None:
            x = x + suppress
        if first and begin_suppress is not None:
            x = x + begin_suppress
        logprobs = torch.log_softmax(x, dim=-1)
        if temperature:
            probs = torch.softmax(x / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(x, dim=-1)
        return nxt, logprobs.gather(-1, nxt[:, None])[:, 0]

    nxt, lp = pick(logits_p[:, -1], True)
    if no_speech_id is not None:
        no_speech_prob = torch.softmax(logits_p[:, 0], dim=-1)[:, no_speech_id]
    else:
        no_speech_prob = torch.zeros(b, device=dev)

    tokens = torch.zeros(b, s_max, dtype=torch.int64, device=dev)
    tokens[:, :p] = prompt
    tokens[:, p] = nxt
    token_lp = torch.zeros(b, max_new_tokens, device=dev)
    token_lp[:, 0] = lp
    done = nxt == eot
    sum_lp = torch.where(done, 0.0, lp)

    for step in range(1, max_new_tokens):
        if bool(done.all()):
            break
        pos = p + step - 1                   # cache slot of the token fed
        if use_mega:
            logits, cache, align_step = mega_decoder_step(
                model, tokens[:, pos:pos + 1], pos, cache, capture_alignment)
        else:
            logits, cache, align_step = decoder_step(
                model, tokens[:, pos:pos + 1], pos, cache)
        nxt, lp = pick(logits, False)
        nxt = torch.where(done, eot, nxt)
        tokens[:, pos + 1] = nxt
        finished = done | (nxt == eot)
        sum_lp = sum_lp + torch.where(finished, 0.0, lp)
        token_lp[:, step] = torch.where(done, 0.0, lp)
        done = finished
        if capture_alignment:
            align[:, :, pos] = align_step

    is_eot = tokens[:, p:] == eot
    first_eot = torch.argmax(is_eot.int(), dim=1)
    num_generated = torch.where(is_eot.any(dim=1), first_eot, max_new_tokens)
    return GreedyResult(tokens.int(), num_generated.int(), sum_lp, align,
                        token_lp, no_speech_prob)
