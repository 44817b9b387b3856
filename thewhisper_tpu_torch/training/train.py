"""Fine-tuning: teacher-forced cross-entropy and an AdamW step (port of
thewhisper_tpu's ``training/train.py``).

The reference's flexible-chunk checkpoints are fine-tunes on shorter
windows; this module is that capability on one GPU. The encoder's
attention is K2 with its backward kernels (``ops.attention.EncoderAttention``
launches them whenever the weights require grad); the rest is plain torch
under autograd. There is no mesh: JAX's ``(dp, tp)`` sharding is not ported.

Recipe: load a checkpoint at the target chunk length (``load_checkpoint``
with ``chunk_length_s``), train on windows of that length, and export with
``models.checkpoint.save_hf_checkpoint(chunk_length_s=...)``.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from thewhisper_tpu_torch.models.whisper import (
    AttentionFn,
    Whisper,
    decoder_train_forward,
    encoder_forward,
)
from thewhisper_tpu_torch.ops.attention import encoder_attention


class TrainState(NamedTuple):
    """The model (its parameters, updated in place), the optimizer holding
    the AdamW moments, and the number of steps taken."""

    params: Whisper
    opt_state: torch.optim.AdamW
    step: int


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` (B, S) under f32
    ``logits`` (B, S, V) over the positions where ``mask`` (B, S) is 1."""
    logprobs = torch.log_softmax(logits, dim=-1)
    ll = logprobs.gather(-1, labels[..., None].long())[..., 0]
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def loss_fn(model: Whisper, batch: Mapping[str, torch.Tensor],
            compute_dtype: torch.dtype = torch.float32, remat: bool = False,
            attention: AttentionFn = encoder_attention) -> torch.Tensor:
    """Batch: mel (B, n_mels, T), tokens (B, S), loss_mask (B, S).

    ``tokens`` holds the decoder input (prompt + transcript); the loss
    predicts ``tokens[:, 1:]`` from positions ``[:-1]`` under the mask
    (which zeroes prompt and padding positions). ``remat`` recomputes each
    layer in the backward pass; ``attention`` is the encoder's (the plain
    version holds the kernels' gradients against autograd)."""
    enc = encoder_forward(model, batch["mel"], attention, compute_dtype, remat)
    logits = decoder_train_forward(model, batch["tokens"][:, :-1], enc,
                                   compute_dtype, remat)
    return cross_entropy_loss(logits, batch["tokens"][:, 1:],
                              batch["loss_mask"][:, 1:])


def decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Standard AdamW practice: decay matmul weights only (``ndim >= 2``:
    linears, convs, the embedding tables). LayerNorm scales and biases and
    every bias are not pulled toward zero.

    JAX's ``decay_mask`` applies the same ``ndim >= 2`` test to its stacked
    (L, ...) leaves, so there every per-layer LayerNorm parameter and bias
    is decayed too; the port's layers are not stacked, so the test gives
    what the docstring there means."""
    return {name: p.ndim >= 2 for name, p in model.named_parameters()}


def init_train_state(model: Whisper, learning_rate: float = 1e-5,
                     weight_decay: float = 0.01
                     ) -> Tuple[TrainState, torch.optim.AdamW]:
    """(state, tx): every parameter of ``model`` set to require grad, and
    ``torch.optim.AdamW`` with optax's ``adamw`` defaults (b1 0.9, b2 0.999,
    eps 1e-8 outside the square root, decay of the old weights decoupled
    from the moments) in two groups, decayed and not (:func:`decay_mask`)."""
    model.requires_grad_(True)
    mask = decay_mask(model)
    groups = [{"params": [p for n, p in model.named_parameters() if mask[n] == d],
               "weight_decay": weight_decay if d else 0.0} for d in (True, False)]
    tx = torch.optim.AdamW(groups, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, tx, 0), tx


def make_train_step(tx: torch.optim.Optimizer,
                    compute_dtype: torch.dtype = torch.float32,
                    remat: bool = False):
    """One optimizer step: ``(state, batch) -> (state, loss)``; the model's
    parameters and ``tx``'s moments are updated in place."""

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        tx.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, batch, compute_dtype, remat)
        loss.backward()
        tx.step()
        return TrainState(state.params, tx, state.step + 1), loss.detach()

    return step


def place_batch(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch onto ``device``: through pinned buffers and
    asynchronous copies on a CUDA device (there is no mesh)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out
