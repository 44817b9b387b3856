"""The port's training path (``thewhisper_tpu_torch.training``) against
thewhisper_tpu's, at the tiny ``ARCH`` of ``_torch_tiny`` in f32 on the CPU.

The same numpy weights and batch go through both packages: the
teacher-forced decoder and the loss to 1e-5 relative, every gradient leaf
(read back in JAX's layout through ``jax_tree_from_model``) to 1e-4
relative L2, three AdamW steps against optax leaf by leaf (updates, not
only the loss: Adam turns a small gradient into a full step), remat
against no remat, and distillation (its loss against JAX's; agreement
rises; the student shares no storage with its teacher).

The port decays ``ndim >= 2`` parameters of its unstacked layers. JAX's
``decay_mask`` applies the same test to stacked (L, ...) leaves, and so
also decays every per-layer LayerNorm parameter and bias; the optax arm
with decay builds the mask the docstring there means.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_tiny import ARCH, jax_params_numpy
from _torch_tiny import one_cpu_thread  # noqa: F401
from thewhisper_tpu.models import whisper as jw
from thewhisper_tpu.training import distill as jdistill
from thewhisper_tpu.training import train as jtrain
from thewhisper_tpu_torch.engine.speculative import make_layer_skip_draft
from thewhisper_tpu_torch.models import whisper as tw
from thewhisper_tpu_torch.models.load import jax_tree_from_model, params_from_jax
from thewhisper_tpu_torch.training import distill, train

B, S, T_MEL = 2, 12, 200       # 100 encoder positions of the table's 150


def _batch(seed=0, b=B, s=S, vocab=ARCH.vocab_size):
    rng = np.random.default_rng(seed)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    mask[:, :4] = 0.0                                         # the prompt
    return {"mel": rng.standard_normal((b, ARCH.n_mels, T_MEL)).astype(np.float32),
            "tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "loss_mask": mask}


def _torch_batch(batch):
    return train.place_batch(batch, "cpu")


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.fixture(scope="module")
def tree():
    return jax_params_numpy(seed=3)


def test_decoder_train_forward_matches_jax(tree):
    batch = _batch(1)
    with jax.default_matmul_precision("highest"):
        enc = jw.encoder_forward(tree, jnp.asarray(batch["mel"]), ARCH)
        ref = jw.decoder_train_forward(tree, jnp.asarray(batch["tokens"]), enc, ARCH)
    model = params_from_jax(tree, ARCH)
    got = tw.decoder_train_forward(model, torch.from_numpy(batch["tokens"]),
                                   torch.from_numpy(np.array(enc)))
    assert got.dtype == torch.float32 and got.shape == (B, S, ARCH.vocab_size)
    assert _rel(got.numpy(), ref) < 1e-5


def test_loss_and_every_gradient_leaf_match_jax(tree):
    batch = _batch(2)
    with jax.default_matmul_precision("highest"):
        loss_ref, grads_ref = jax.value_and_grad(jtrain.loss_fn)(
            tree, {k: jnp.asarray(v) for k, v in batch.items()}, ARCH)
    model = params_from_jax(tree, ARCH).requires_grad_(True)
    loss = train.loss_fn(model, _torch_batch(batch))
    loss.backward()
    assert abs(loss.item() - float(loss_ref)) <= 1e-5 * abs(float(loss_ref))
    got = _leaves(jax_tree_from_model(model, grads=True))
    want = _leaves(jax.tree.map(np.asarray, grads_ref))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, r) in zip(got, want):
        assert _rel(g, r) < 1e-4, jax.tree_util.keystr(path)


def _jax_decay_mask(params):
    """The decay the JAX docstring means: matmul weights only. A leaf under
    ``layers`` carries the layer axis first."""
    def keep(path, leaf):
        stacked = any(getattr(k, "key", None) == "layers" for k in path)
        return np.ndim(leaf) - int(stacked) >= 2
    return jax.tree_util.tree_map_with_path(keep, params)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_three_adamw_steps_match_optax(tree, weight_decay):
    lr = 1e-3
    batches = [_batch(10 + i) for i in range(3)]
    tx = optax.adamw(lr, weight_decay=weight_decay, mask=_jax_decay_mask)
    params = jax.tree.map(jnp.asarray, tree)
    opt = tx.init(params)
    grad = jax.jit(jax.value_and_grad(jtrain.loss_fn), static_argnums=(2,))
    with jax.default_matmul_precision("highest"):
        for batch in batches:
            _, g = grad(params, {k: jnp.asarray(v) for k, v in batch.items()}, ARCH)
            updates, opt = tx.update(g, opt, params)
            params = optax.apply_updates(params, updates)

    state, ttx = train.init_train_state(params_from_jax(tree, ARCH), lr, weight_decay)
    step = train.make_train_step(ttx)
    losses = []
    for batch in batches:
        state, loss = step(state, _torch_batch(batch))
        losses.append(loss.item())
    assert state.step == 3 and all(np.isfinite(losses))

    got = _leaves(jax_tree_from_model(state.params))
    want = _leaves(jax.tree.map(np.asarray, params))
    start = _leaves(tree)
    for (path, g), (_, r), (_, p0) in zip(got, want, start):
        name = jax.tree_util.keystr(path)
        if not np.any(r != p0):
            assert np.array_equal(g, p0), name
            continue
        # Adam divides each element by its own gradient's size, so the
        # elements with the smallest gradients carry their f32 rounding
        # (1e-6 relative on the leaf) into full-size steps: 2.6e-4 on the
        # decoder's cross-attention out-projection, under 4e-5 elsewhere.
        assert _rel(g - p0, r - p0) < 1e-3, name
    if weight_decay == 0.0:
        # Position rows no token or frame reaches get exactly zero
        # gradients in both, so Adam leaves them as they were.
        t_enc = T_MEL // 2
        for side, first in (("encoder", t_enc), ("decoder", S - 1)):
            g = state.params.get_parameter(f"{side}.pos_emb").detach().numpy()
            assert np.array_equal(g[first:], tree[side]["pos_emb"][first:]), side
            assert np.array_equal(np.asarray(params[side]["pos_emb"])[first:],
                                  tree[side]["pos_emb"][first:]), side


def test_decay_mask_spares_norms_and_biases():
    model = tw.init_params(ARCH, torch.Generator().manual_seed(0))
    mask = train.decay_mask(model)
    assert mask["encoder.layers.0.attn.q.weight"]
    assert mask["encoder.conv1.weight"] and mask["decoder.token_emb"]
    assert not mask["encoder.layers.0.ln1.weight"]
    assert not mask["encoder.layers.0.attn.q.bias"]
    assert not mask["decoder.ln_post.bias"]
    state, tx = train.init_train_state(model)
    decayed, spared = tx.param_groups
    assert decayed["weight_decay"] == 0.01 and spared["weight_decay"] == 0.0
    assert len(decayed["params"]) + len(spared["params"]) == len(mask)
    assert all(p.requires_grad for p in model.parameters())


def test_remat_gradients_match(tree):
    """``torch.utils.checkpoint`` changes memory, not math."""
    batch = _torch_batch(_batch(4))
    grads = []
    for remat in (False, True):
        model = params_from_jax(tree, ARCH).requires_grad_(True)
        loss = train.loss_fn(model, batch, remat=remat)
        loss.backward()
        grads.append((loss.item(), [p.grad.clone() for p in model.parameters()]))
    (l0, g0), (l1, g1) = grads
    assert l0 == pytest.approx(l1, rel=1e-6)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_bf16_compute_keeps_f32_master_weights(tree):
    """A bf16 compute type over f32 weights: the loss stays near the f32
    loss and every gradient is f32, as JAX's ``compute_dtype``."""
    batch = _torch_batch(_batch(5))
    model = params_from_jax(tree, ARCH).requires_grad_(True)
    l32 = train.loss_fn(model, batch).item()
    l16 = train.loss_fn(model, batch, compute_dtype=torch.bfloat16)
    l16.backward()
    assert abs(l16.item() - l32) < 2e-2 * abs(l32)
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               and torch.isfinite(p.grad).all() for p in model.parameters())


# ---------------------------------------------------------------------------
# Distillation
# ---------------------------------------------------------------------------

DISTILL_ARCH = dataclasses.replace(ARCH, decoder_layers=4, vocab_size=120,
                                   max_source_positions=50, max_target_positions=48,
                                   alignment_heads=((1, 0),))


def _distill_batch(seed, b=4, s=24):
    rng = np.random.default_rng(seed)
    return {"mel": torch.from_numpy(rng.standard_normal(
                (b, DISTILL_ARCH.n_mels, 100)).astype(np.float32)),
            "tokens": torch.from_numpy(rng.integers(0, DISTILL_ARCH.vocab_size, (b, s)))}


def test_distill_loss_matches_jax():
    from thewhisper_tpu.engine.speculative import make_layer_skip_draft as jax_draft

    teacher_tree = jax.tree.map(np.asarray, jw.init_params(DISTILL_ARCH, seed=21))
    draft_tree, draft_arch = jax_draft(teacher_tree, DISTILL_ARCH, 2)
    batch = _distill_batch(1)
    batch["loss_mask"] = torch.from_numpy(
        (np.random.default_rng(2).random((4, 24)) < 0.7).astype(np.float32))
    with jax.default_matmul_precision("highest"):
        ref = jdistill.distill_loss_fn(
            {"decoder": draft_tree["decoder"]}, teacher_tree,
            {k: jnp.asarray(v.numpy()) for k, v in batch.items()},
            draft_arch, DISTILL_ARCH, temperature=2.0)
    teacher = params_from_jax(teacher_tree, DISTILL_ARCH)
    student = make_layer_skip_draft(teacher, 2)
    got = distill.distill_loss_fn(student, teacher, batch, temperature=2.0)
    assert abs(got.item() - float(ref)) <= 1e-5 * abs(float(ref))


def test_distill_improves_agreement_and_leaves_the_teacher_alone():
    teacher = tw.init_params(DISTILL_ARCH, torch.Generator().manual_seed(21))
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    student = make_layer_skip_draft(teacher, 2)
    eval_b = _distill_batch(999)
    agree0 = distill.greedy_agreement(student, teacher, eval_b).item()

    state, tx = distill.init_distill_state(student, learning_rate=1e-3)
    teacher_ptrs = {p.data_ptr() for p in teacher.parameters()}
    assert not teacher_ptrs & {p.data_ptr() for p in state.student.parameters()}
    step = distill.make_distill_step(tx, temperature=1.0)
    losses = []
    for i in range(60):
        state, loss = step(state, teacher, _distill_batch(i))
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and state.step == 60
    assert losses[-1] < losses[0] * 0.9, losses[:3] + losses[-3:]
    agree1 = distill.greedy_agreement(state.student, teacher, eval_b).item()
    # The layer-skip init disagrees with the 4-layer teacher on a random
    # model; distillation must raise held-out greedy agreement.
    assert agree1 > agree0 + 0.1, (agree0, agree1)
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k
