"""Fine-tuning: teacher-forced cross-entropy and an AdamW step (port of
thewhisper_tpu's ``training/train.py``).

The reference's flexible-chunk checkpoints are fine-tunes on shorter
windows; this module is that capability on one GPU or on a ``(dp, tp)``
mesh. The encoder's attention is K2 with its backward kernels
(``ops.attention.EncoderAttention`` launches them whenever the weights
require grad, at the local head count on a tp-sharded model); the rest is
plain torch under autograd.

On a mesh (JAX: ``shard_params`` before ``tx.init``, the batch on
``P("dp")``, GSPMD's psums): the model is sharded by
``parallel.mesh.shard_params`` (its tp conjugates *f* and *g* live in the
model graph), :func:`place_batch` gives each rank its dp rows,
:func:`loss_fn` divides each rank's numerator by the mask count summed
over dp (JAX's one global loss), and :func:`make_train_step` sums the
gradients over dp in flat buckets before ``AdamW`` steps each rank's
shards (AdamW is elementwise). The step returns the global loss on every
rank.

Recipe: load a checkpoint at the target chunk length (``load_checkpoint``
with ``chunk_length_s``), train on windows of that length, and export with
``models.checkpoint.save_hf_checkpoint(chunk_length_s=...)``.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from thewhisper_tpu_torch.models.whisper import (
    AttentionFn,
    Whisper,
    decoder_train_forward,
    encoder_forward,
)
from thewhisper_tpu_torch.ops.attention import encoder_attention
from thewhisper_tpu_torch.parallel.mesh import (
    Mesh,
    reduce_gradients,
    sum_over_dp,
)


class TrainState(NamedTuple):
    """The model (its parameters, updated in place), the optimizer holding
    the AdamW moments, and the number of steps taken."""

    params: Whisper
    opt_state: torch.optim.AdamW
    step: int


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor,
                       mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` (B, S) under f32
    ``logits`` (B, S, V) over the positions where ``mask`` (B, S) is 1.
    With ``mesh``, the rows are this rank's dp block and the denominator is
    the mask count summed over dp: the global mean's share of these rows,
    so the dp ranks' losses (and gradients) sum to the global ones (a
    per-rank mean would match only where every rank's mask had the same
    count)."""
    logprobs = torch.log_softmax(logits, dim=-1)
    ll = logprobs.gather(-1, labels[..., None].long())[..., 0]
    count = mask.sum()
    if mesh is not None:
        count = sum_over_dp(count, mesh)
    return -(ll * mask).sum() / count.clamp_min(1.0)


def loss_fn(model: Whisper, batch: Mapping[str, torch.Tensor],
            compute_dtype: torch.dtype = torch.float32, remat: bool = False,
            attention: AttentionFn = encoder_attention,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Batch: mel (B, n_mels, T), tokens (B, S), loss_mask (B, S).

    ``tokens`` holds the decoder input (prompt + transcript); the loss
    predicts ``tokens[:, 1:]`` from positions ``[:-1]`` under the mask
    (which zeroes prompt and padding positions). ``remat`` recomputes each
    layer in the backward pass; ``attention`` is the encoder's (the plain
    version holds the kernels' gradients against autograd). ``mesh``: the
    batch is this rank's dp rows and the loss its share of the global one
    (:func:`cross_entropy_loss`)."""
    enc = encoder_forward(model, batch["mel"], attention, compute_dtype, remat)
    logits = decoder_train_forward(model, batch["tokens"][:, :-1], enc,
                                   compute_dtype, remat)
    return cross_entropy_loss(logits, batch["tokens"][:, 1:],
                              batch["loss_mask"][:, 1:], mesh)


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
    from the moments) in two groups, decayed and not (:func:`decay_mask`).
    A model sharded by ``parallel.mesh.shard_params`` takes its moments at
    its shards' shapes (JAX shards before ``tx.init`` for the same
    reason); it trains through ``make_train_step(..., mesh=)``."""
    model.requires_grad_(True)
    mask = decay_mask(model)
    groups = [{"params": [p for n, p in model.named_parameters() if mask[n] == d],
               "weight_decay": weight_decay if d else 0.0} for d in (True, False)]
    tx = torch.optim.AdamW(groups, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, tx, 0), tx


def make_train_step(tx: torch.optim.Optimizer,
                    compute_dtype: torch.dtype = torch.float32,
                    remat: bool = False, mesh: Optional[Mesh] = None):
    """One optimizer step: ``(state, batch) -> (state, loss)``; the model's
    parameters and ``tx``'s moments are updated in place.

    ``mesh`` (a live ``parallel.mesh.Mesh``; a layout without a process
    group raises ``RuntimeError``): the model is sharded over it and the
    batch is this rank's dp rows (:func:`place_batch`). After the backward
    the gradients are summed over dp in flat buckets
    (``parallel.mesh.reduce_gradients``; no ``DistributedDataParallel``),
    then AdamW steps each rank's shards; the loss returned is the global
    one, the same on every rank. A sharded model without ``mesh`` raises
    ``ValueError``. A meshed step holds cuDNN to deterministic algorithms
    (``torch.backends.cudnn.deterministic``, restored after the step):
    the conv stem is replicated, and cuDNN's default weight-gradient
    algorithm sums in an order that changes from call to call, so its
    gradient would differ in the last bits across tp ranks and the
    replicated weights drift apart. With ``remat``, ``torch.utils.checkpoint`` re-runs each
    layer's forward, and with it *g*'s all-reduces, inside the backward:
    every rank re-runs them in the same order (one graph, one backward
    order), which is what keeps the collectives matched."""
    if mesh is not None and not mesh.live:
        raise RuntimeError("a meshed train step needs a live process group "
                           "(parallel.launch.init, then make_mesh)")

    def step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        model = state.params
        if model.tp is not None and mesh is None:
            raise ValueError("a sharded model trains through "
                             "make_train_step(..., mesh=)")
        tx.zero_grad(set_to_none=True)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = deterministic or mesh is not None
        try:
            loss = loss_fn(model, batch, compute_dtype, remat, mesh=mesh)
            loss.backward()
        finally:
            torch.backends.cudnn.deterministic = deterministic
        loss = loss.detach()
        if mesh is not None:
            reduce_gradients(model.parameters(), mesh)
            loss = sum_over_dp(loss, mesh)
        tx.step()
        return TrainState(model, tx, state.step + 1), loss

    return step


def local_rows(n: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a global batch of ``n`` (every row without a
    mesh): its dp block; ``ValueError`` where dp does not divide n (JAX's
    ``P("dp")`` placement refuses that batch too)."""
    if mesh is None:
        return slice(0, n)
    if n % mesh.dp:
        raise ValueError(f"dp={mesh.dp} does not divide the batch of {n}")
    m = n // mesh.dp
    return slice(mesh.dp_rank * m, (mesh.dp_rank + 1) * m)


def place_batch(batch: Mapping[str, np.ndarray], device,
                mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """A host batch onto ``device``: through pinned buffers and
    asynchronous copies on a CUDA device. With ``mesh``, this rank's dp
    rows of it (:func:`local_rows`; ``ValueError`` where dp does not
    divide the batch)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        t = torch.from_numpy(np.ascontiguousarray(v[local_rows(len(v), mesh)]))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out
