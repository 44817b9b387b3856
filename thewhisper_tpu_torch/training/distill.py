"""Draft distillation: train a small decoder to imitate the target's (port
of thewhisper_tpu's ``training/distill.py``).

A layer-skip draft (``engine.speculative.make_layer_skip_draft``) is free
but unadapted; distilling it against the target decoder's logits raises
draft/target greedy agreement, the acceptance rate that decides the
speculative speedup (the distil-whisper recipe: frozen shared encoder,
shallow decoder trained on the teacher's distribution).

The teacher is frozen (its encoder and logits under ``torch.no_grad``, so
its attention takes K2's inference launch, no backward); the student is a
decoder-only model. Both read the same encoder states, as a draft does in
``WhisperEngine``. Distillation runs on one device: a model sharded by
``parallel.mesh.shard_params`` (student or teacher) raises ``ValueError``,
as JAX has no meshed distillation entry (``run_distill`` has no
``--dp``/``--tp``).
"""

from __future__ import annotations

import copy
from typing import Mapping, NamedTuple, Tuple

import torch

from thewhisper_tpu_torch.models.whisper import (
    Whisper,
    decoder_train_forward,
    encoder_forward,
)
from thewhisper_tpu_torch.training.train import init_train_state


class DistillState(NamedTuple):
    student: Whisper
    opt_state: torch.optim.AdamW
    step: int


def _unsharded(model: Whisper, role: str) -> None:
    if model.tp is not None:
        raise ValueError(f"distillation runs on one device: the {role} is "
                         "sharded over a mesh")


def _teacher_pass(teacher: Whisper, batch, compute_dtype):
    """(encoder states, teacher-forced logits, decoder input tokens)."""
    with torch.no_grad():
        enc = encoder_forward(teacher, batch["mel"], compute_dtype=compute_dtype)
        tokens_in = batch["tokens"][:, :-1]
        logits = decoder_train_forward(teacher, tokens_in, enc, compute_dtype)
    return enc, logits, tokens_in


def _masked_mean(x: torch.Tensor, batch) -> torch.Tensor:
    """Mean of (B, S - 1) ``x`` over ``batch["loss_mask"][:, 1:]`` if the
    batch has a mask, else over every position."""
    mask = batch.get("loss_mask")
    if mask is None:
        return x.mean()
    m = mask[:, 1:]
    return (x * m).sum() / m.sum().clamp_min(1.0)


def distill_loss_fn(student: Whisper, teacher: Whisper,
                    batch: Mapping[str, torch.Tensor],
                    compute_dtype: torch.dtype = torch.float32,
                    temperature: float = 2.0, remat: bool = False) -> torch.Tensor:
    """Temperature-scaled KL(teacher || student) over teacher-forced
    positions, mean per token (``batch["loss_mask"]``, optional, zeroes
    padding), times temperature squared."""
    enc, t_logits, tokens_in = _teacher_pass(teacher, batch, compute_dtype)
    s_logits = decoder_train_forward(student, tokens_in, enc, compute_dtype,
                                     remat=remat)
    t_lp = torch.log_softmax(t_logits / temperature, dim=-1)
    s_lp = torch.log_softmax(s_logits / temperature, dim=-1)
    kl = (t_lp.exp() * (t_lp - s_lp)).sum(-1)                 # (B, S - 1)
    return _masked_mean(kl, batch) * temperature ** 2


def greedy_agreement(student: Whisper, teacher: Whisper,
                     batch: Mapping[str, torch.Tensor],
                     compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Fraction of teacher-forced positions where the draft's argmax equals
    the target's: the statistic the speculative acceptance rate tracks.
    ``batch["loss_mask"]`` (optional) keeps padding runs, where both
    trivially agree, out of the mean."""
    enc, t_logits, tokens_in = _teacher_pass(teacher, batch, compute_dtype)
    with torch.no_grad():
        s_logits = decoder_train_forward(student, tokens_in, enc, compute_dtype)
    agree = (t_logits.argmax(-1) == s_logits.argmax(-1)).float()
    return _masked_mean(agree, batch)


def init_distill_state(student: Whisper, learning_rate: float = 1e-4,
                       weight_decay: float = 0.0
                       ) -> Tuple[DistillState, torch.optim.AdamW]:
    """(state, tx) on a copy of ``student``: a layer-skip student shares its
    modules (layers, tables, final LayerNorm) with the teacher, and
    training them in place would change the teacher. A sharded student
    raises ``ValueError``."""
    _unsharded(student, "student")
    state, tx = init_train_state(copy.deepcopy(student), learning_rate,
                                 weight_decay)
    return DistillState(state.params, tx, 0), tx


def make_distill_step(tx: torch.optim.Optimizer,
                      compute_dtype: torch.dtype = torch.float32,
                      temperature: float = 2.0, remat: bool = False):
    """One step: ``(state, teacher, batch) -> (state, loss)``; a sharded
    teacher raises ``ValueError``."""

    def step(state: DistillState, teacher: Whisper, batch):
        _unsharded(teacher, "teacher")
        tx.zero_grad(set_to_none=True)
        loss = distill_loss_fn(state.student, teacher, batch, compute_dtype,
                               temperature, remat)
        loss.backward()
        tx.step()
        return DistillState(state.student, tx, state.step + 1), loss.detach()

    return step
