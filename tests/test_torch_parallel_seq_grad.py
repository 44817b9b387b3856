"""The sequence-parallel encoder's backward on the port's (dp, tp) mesh
against ``jax.grad`` through JAX's ``encoder_forward(act_sharding=
seq_sharding(mesh))``.

Four gloo ranks on the CPU (``parallel.launch.spawn``), once per mesh
shape, run ``parallel.dryrun.seq_grad_checks`` at the JAX dry run's tiny
arch (d_model 128, 2 encoder layers, 4 heads, T = 50: blocks of 25 at
tp 2, 13/13/13/11 at tp 4, the last padded to 13) with JAX's
``init_params`` (seed 3, biases and LayerNorm parameters drawn from
N(0, 0.1)) carried across by ``params_from_jax``, whole on every rank.
The loss is ``(out * g).sum()`` for seeded numpy features (B = 4) and a
seeded numpy cotangent ``g`` (B, T, d), three ways: on each rank's block
of rows, on ``gather_seq``'s assembled output (the same on every tp
rank), and that with remat. After the backward every encoder leaf's
gradient and the mel's are summed over tp (``sum_over_tp``) and the
leaves' over dp. The reference is ``jax.grad`` of the same loss through
JAX's sequence-sharded encoder on ``shard_params`` over
``make_mesh(8)`` (dp 4 x tp 2), which JAX's one-device ``jax.grad``
must agree with. Tolerance (f32 on both sides): 1e-5 relative L2 for
every leaf and the mel.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thewhisper_tpu.config import ARCH_PRESETS as JAX_PRESETS
from thewhisper_tpu.models.whisper import encoder_forward as jax_encoder
from thewhisper_tpu.models.whisper import init_params as jax_init
from thewhisper_tpu.parallel import make_mesh as jax_mesh
from thewhisper_tpu.parallel import seq_sharding
from thewhisper_tpu.parallel import shard_params as jax_shard
from thewhisper_tpu_torch.models.load import jax_tree_from_model, params_from_jax
from thewhisper_tpu_torch.models.whisper import encoder_forward, model_from_state
from thewhisper_tpu_torch.parallel import dryrun, launch

from _torch_tiny import one_cpu_thread  # noqa: F401

ARCH = dryrun.TINY_ARCH
JAX_ARCH = dataclasses.replace(JAX_PRESETS["large-v3-turbo"],
                               **dataclasses.asdict(ARCH))
MESHES = [(2, 2), (1, 4)]
IDS = [f"dp{dp}xtp{tp}" for dp, tp in MESHES]
BATCH = 4
T = ARCH.max_source_positions


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def tree():
    """JAX's ``init_params`` (seed 3) with biases and LayerNorm parameters
    drawn from N(0, 0.1) (scales 1 + N)."""
    rng = np.random.default_rng(5)

    def draw(path, x):
        name = path[-1].key
        if name in ("b", "bias", "scale") or name.endswith("_b"):
            return (x + dryrun.BIAS_STD * rng.standard_normal(x.shape)
                    ).astype(np.float32)
        return np.asarray(x)

    return jax.tree_util.tree_map_with_path(draw, jax_init(JAX_ARCH, seed=3))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(17)
    return (rng.standard_normal((BATCH, ARCH.n_mels, 2 * T), dtype=np.float32),
            rng.standard_normal((BATCH, T, ARCH.d_model), dtype=np.float32))


@pytest.fixture(scope="module")
def weights(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree, ARCH).state_dict().items()}


@pytest.fixture(scope="module")
def runs(weights, inputs):
    mel, g = inputs
    return {(dp, tp): launch.spawn(dryrun.seq_grad_checks, dp * tp, dp, tp,
                                   weights, mel, g)
            for dp, tp in MESHES}


def _jax_grads(tree, mel, g, act_sharding=None):
    def loss(params, x):
        out = jax_encoder(params, x, JAX_ARCH, act_sharding=act_sharding)
        return (out * g).sum()

    params = jax.tree.map(jnp.asarray, tree)
    if act_sharding is not None:
        params = jax_shard(params, act_sharding.mesh)
    with jax.default_matmul_precision("highest"):
        grads, mel_grad = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(mel))
    return (jax.tree.map(np.asarray, grads["encoder"]), np.asarray(mel_grad))


@pytest.fixture(scope="module")
def jax_refs(tree, inputs):
    """``jax.grad`` through the sequence-sharded encoder (dp 4 x tp 2 of
    the 8 virtual CPU devices), and on one device."""
    mel, g = inputs
    return {"seq": _jax_grads(tree, mel, g, seq_sharding(jax_mesh(8))),
            "one": _jax_grads(tree, mel, g)}


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def test_jax_sequence_sharded_gradient_matches_one_device(jax_refs):
    (seq, seq_mel), (one, one_mel) = jax_refs["seq"], jax_refs["one"]
    for (path, a), (_, b) in zip(_leaves(seq), _leaves(one)):
        assert _rel(a, b) < 1e-5, jax.tree_util.keystr(path)
    assert _rel(seq_mel, one_mel) < 1e-5


def _as_jax_encoder(weights, grads):
    """The port's encoder gradients (state-dict names) in JAX's layout."""
    model = model_from_state(weights, ARCH)
    for name, p in model.named_parameters():
        if name in grads:
            p.grad = torch.from_numpy(grads[name])
    return jax_tree_from_model(model, grads=True)["encoder"]


@pytest.mark.parametrize("arm", dryrun.SEQ_GRAD_ARMS)
@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_sequence_parallel_gradients_match_jax(runs, jax_refs, weights, shape,
                                               arm):
    """Every encoder leaf's gradient (on every rank: whole weights, summed
    over tp and dp) and the mel's (each dp group's rows) against
    ``jax.grad`` through ``seq_sharding``."""
    want, want_mel = jax_refs["seq"]
    ranks = runs[shape]
    for r in ranks:
        got = _as_jax_encoder(weights, r[arm]["grads"])
        for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
            assert _rel(a, b) < 1e-5, (r["rank"], jax.tree_util.keystr(path))
    dp = shape[0]
    mel = np.concatenate([r[arm]["mel"] for r in ranks if r["tp_rank"] == 0])
    assert mel.shape[0] == BATCH and len(ranks) == dp * shape[1]
    assert _rel(mel, want_mel) < 1e-5


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_summed_gradients_are_bit_identical_across_ranks(runs, shape):
    """After ``sum_over_tp`` (and the dp sum) every leaf's gradient is the
    same bits on every rank, in every arm; the rows a rank held are its
    time block."""
    ranks = runs[shape]
    rows = {(2, 2): [25] * 4, (1, 4): [13, 13, 13, 11]}[shape]
    for arm in dryrun.SEQ_GRAD_ARMS:
        assert [r[arm]["rows"] for r in ranks] == rows
        assert all(r[arm]["digests"] == ranks[0][arm]["digests"] for r in ranks)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_backward_reduce_scatters_once_a_layer(runs, shape):
    """``gather_kv``'s conjugate: one reduce-scatter a layer in the
    backward; ``gather_seq``'s is a slice (no collective); remat re-runs
    each layer's all-gather inside the backward."""
    layers = ARCH.encoder_layers
    for r in runs[shape]:
        assert r["local"]["counts"] == {"all_gathers": 0,
                                        "reduce_scatters": layers}
        assert r["gathered"]["counts"] == {"all_gathers": 0,
                                           "reduce_scatters": layers}
        assert r["remat"]["counts"] == {"all_gathers": layers,
                                        "reduce_scatters": layers}


def test_sequence_parallel_gradient_arms_agree(runs):
    """The loss on each rank's block and the loss on the assembled output
    give the same gradients (a reduce-scatter in ``gather_seq``'s backward
    would have multiplied the second by tp); remat changes no bit."""
    for shape in MESHES:
        r = runs[shape][0]
        for name, g in r["local"]["grads"].items():
            np.testing.assert_allclose(r["gathered"]["grads"][name], g,
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            np.testing.assert_array_equal(r["remat"]["grads"][name],
                                          r["gathered"]["grads"][name])


def test_unsharded_encoder_gradient_is_jax_one_device(weights, inputs, jax_refs):
    """The port's unsharded encoder under autograd (the plain attention's
    gradient through ``EncoderAttention`` on the CPU) against JAX's
    one-device ``jax.grad``: the reference the meshed arms are held to
    from the port's side."""
    mel, g = inputs
    model = model_from_state(weights, ARCH).requires_grad_(True)
    x = torch.from_numpy(mel).requires_grad_(True)
    (encoder_forward(model, x) * torch.from_numpy(g)).sum().backward()
    want, want_mel = jax_refs["one"]
    got = jax_tree_from_model(model, grads=True)["encoder"]
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        assert _rel(a, b) < 1e-5, jax.tree_util.keystr(path)
    assert _rel(x.grad.numpy(), want_mel) < 1e-5
