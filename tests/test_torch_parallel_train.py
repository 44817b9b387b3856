"""The port's (dp, tp) mesh for training and its sequence-parallel encoder
against JAX's one-device training and encoder.

gloo ranks on the CPU (``parallel.launch.spawn``), once per mesh shape in
a module-scoped fixture (4 processes), run
``parallel.dryrun.train_checks`` at the JAX dry run's tiny arch
(``tests/test_parallel.py``: d_model 128, 2 + 2 layers, 4 heads, d_ff 256,
vocab 512, T = 50) with JAX's ``init_params`` (seed 3, biases and
LayerNorm parameters drawn from N(0, 0.1), as ``test_torch_parallel.py``
draws them) carried across by ``params_from_jax``. The batches are
``dryrun.train_batch``'s seeded numpy arrays, whose loss masks keep a
different count in every row, so a per-rank mean would miss JAX's global
one. Tolerances (f32 on both sides), those of
``test_torch_training.py``: the loss 1e-5 relative, every gradient leaf
1e-4 relative L2, three AdamW steps' updates 1e-3 relative L2 against
optax; remat against no remat 1e-5 relative, 1e-6 absolute; the
sequence-parallel encoder 1e-5 absolute (its backward:
``test_torch_parallel_seq_grad.py``).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from thewhisper_tpu.config import ARCH_PRESETS as JAX_PRESETS
from thewhisper_tpu.models.whisper import encoder_forward as jax_encoder
from thewhisper_tpu.models.whisper import init_params as jax_init
from thewhisper_tpu.training import train as jtrain
from thewhisper_tpu_torch.models import checkpoint as ck
from thewhisper_tpu_torch.models.load import (
    jax_tree_from_model,
    load_checkpoint,
    params_from_jax,
    read_safetensors,
)
from thewhisper_tpu_torch.models.whisper import model_from_state
from thewhisper_tpu_torch.ops import attention as attn
from thewhisper_tpu_torch.parallel import dryrun, launch, mesh
from thewhisper_tpu_torch.training import distill, train

from _torch_tiny import one_cpu_thread  # noqa: F401

ARCH = dryrun.TINY_ARCH
JAX_ARCH = dataclasses.replace(JAX_PRESETS["large-v3-turbo"],
                               **dataclasses.asdict(ARCH))
MESHES = [(2, 2), (1, 4), (4, 1)]
IDS = [f"dp{dp}xtp{tp}" for dp, tp in MESHES]
CHECKS = {(2, 2): ("grads", "adam", "falls", "bf16", "seq", "save"),
          (1, 4): ("grads", "adam", "falls", "seq"),
          (4, 1): ("grads", "adam", "falls")}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _jax_batch(batch):
    return {k: jnp.asarray(v.astype(np.int32) if k == "tokens" else v)
            for k, v in batch.items()}


def _as_jax_tree(state):
    """A whole state dict of the port (numpy) in JAX's layout."""
    return jax_tree_from_model(model_from_state(state, ARCH))


@pytest.fixture(scope="module")
def tree():
    """JAX's ``init_params`` (seed 3) with its biases and LayerNorm
    parameters drawn from N(0, 0.1) (scales 1 + N): with JAX's zero biases
    a bias added on every tp rank instead of once goes unseen."""
    rng = np.random.default_rng(5)

    def draw(path, x):
        name = path[-1].key
        if name in ("b", "bias", "scale") or name.endswith("_b"):
            return (x + dryrun.BIAS_STD * rng.standard_normal(x.shape)
                    ).astype(np.float32)
        return np.asarray(x)

    return jax.tree_util.tree_map_with_path(draw, jax_init(JAX_ARCH, seed=3))


@pytest.fixture(scope="module")
def weights(tree):
    return {k: v.numpy() for k, v in params_from_jax(tree, ARCH).state_dict().items()}


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("meshed"))


@pytest.fixture(scope="module")
def runs(weights, out_dir):
    """Every rank's ``train_checks`` for each mesh (dp 2 x tp 2 runs every
    check and saves into ``out_dir``)."""
    return {(dp, tp): launch.spawn(dryrun.train_checks, dp * tp, dp, tp,
                                   weights, CHECKS[(dp, tp)], out_dir)
            for dp, tp in MESHES}


@pytest.fixture(scope="module")
def jax_grads(tree):
    with jax.default_matmul_precision("highest"):
        loss, grads = jax.value_and_grad(jtrain.loss_fn)(
            tree, _jax_batch(dryrun.train_batch(seed=2)), JAX_ARCH)
    return float(loss), jax.tree.map(np.asarray, grads)


def _jax_decay_mask(params):
    """The decay the JAX docstring means (``test_torch_training.py``'s)."""
    def keep(path, leaf):
        stacked = any(getattr(k, "key", None) == "layers" for k in path)
        return np.ndim(leaf) - int(stacked) >= 2
    return jax.tree_util.tree_map_with_path(keep, params)


@pytest.fixture(scope="module")
def optax_params(tree):
    """JAX's params after three optax AdamW steps (batches of seeds 10-12),
    at weight decay 0 and 0.01."""
    out = {}
    grad = jax.jit(jax.value_and_grad(jtrain.loss_fn), static_argnums=(2,))
    for wd in (0.0, 0.01):
        tx = optax.adamw(dryrun.TRAIN_LR, weight_decay=wd, mask=_jax_decay_mask)
        params = jax.tree.map(jnp.asarray, tree)
        opt = tx.init(params)
        with jax.default_matmul_precision("highest"):
            for i in range(3):
                _, g = grad(params, _jax_batch(dryrun.train_batch(seed=10 + i)),
                            JAX_ARCH)
                updates, opt = tx.update(g, opt, params)
                params = optax.apply_updates(params, updates)
        out[wd] = jax.tree.map(np.asarray, params)
    return out


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_meshed_loss_and_every_gradient_leaf_match_jax(runs, jax_grads, shape):
    """The global loss on every rank, and each leaf's gradient gathered
    over tp and summed over dp, against ``jax.value_and_grad`` on one
    device."""
    loss_ref, grads_ref = jax_grads
    for r in runs[shape]:
        assert abs(r["grads"]["loss"] - loss_ref) <= 1e-5 * abs(loss_ref)
    got = _leaves(_as_jax_tree(runs[shape][0]["grads"]["grads"]))
    want = _leaves(grads_ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, r) in zip(got, want):
        assert _rel(g, r) < 1e-4, jax.tree_util.keystr(path)
    heads = ARCH.encoder_heads // shape[1]
    assert [r["local_heads"] for r in runs[shape]] == [heads] * 4


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_three_meshed_adamw_steps_match_optax(runs, tree, optax_params, shape,
                                              weight_decay):
    """``test_torch_training.py``'s optax check on a mesh: the updates of
    every leaf after three sharded steps, gathered."""
    got = _leaves(_as_jax_tree(runs[shape][0][f"adam{weight_decay}"]["params"]))
    want = _leaves(optax_params[weight_decay])
    start = _leaves(tree)
    for (path, g), (_, r), (_, p0) in zip(got, want, start):
        name = jax.tree_util.keystr(path)
        if not np.any(r != p0):
            assert np.array_equal(g, p0), name
            continue
        assert _rel(g - p0, r - p0) < 1e-3, name


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_replicated_leaves_stay_bit_identical(runs, shape):
    """Replicated leaves and their gradients are the same bits on every tp
    rank of a dp group (*f* sums their input gradients), and every leaf
    the same bits on every dp rank of a tp rank (the gradients summed over
    dp), after each of the AdamW steps."""
    ranks = runs[shape]
    for r in ranks:
        lead = next(x for x in ranks
                    if x["dp_rank"] == r["dp_rank"] and x["tp_rank"] == 0)
        assert r["grads"]["replicated"] == lead["grads"]["replicated"]
        names = lead["grads"]["replicated"]
        for wd in (0.0, 0.01):
            for mine, its in zip(r[f"adam{wd}"]["steps"],
                                 lead[f"adam{wd}"]["steps"]):
                for kind in ("params", "grads"):
                    assert all(mine[kind][n] == its[kind][n] for n in names)
                assert mine["loss"] == its["loss"]
        peer = next(x for x in ranks
                    if x["tp_rank"] == r["tp_rank"] and x["dp_rank"] == 0)
        for wd in (0.0, 0.01):
            for mine, its in zip(r[f"adam{wd}"]["steps"],
                                 peer[f"adam{wd}"]["steps"]):
                assert mine["params"] == its["params"]


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_meshed_loss_falls_over_five_steps(runs, shape):
    """``tests/test_parallel.py``'s sharded step: five steps on one batch."""
    falls = runs[shape][0]["falls"]
    assert all(np.isfinite(falls["losses"])) and falls["step"] == 5
    assert falls["losses"][-1] < falls["losses"][0], falls["losses"]


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_meshed_remat_gives_the_same_gradients(runs, shape):
    """Remat re-runs *g*'s all-reduces inside the backward; the math is
    the same."""
    r = runs[shape][0]
    assert r["remat"]["loss"] == pytest.approx(r["grads"]["loss"], rel=1e-6)
    for name, g in r["grads"]["grads"].items():
        np.testing.assert_allclose(r["remat"]["grads"][name], g, rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_meshed_bf16_compute_keeps_f32_master_weights(runs):
    """A bf16 compute type over f32 weights at dp 2 x tp 2: the loss near
    the f32 loss, every parameter and gradient f32 and finite."""
    for r in runs[(2, 2)]:
        b = r["bf16"]
        assert b["f32"] and b["finite"]
        assert abs(b["loss16"] - b["loss32"]) < 2e-2 * abs(b["loss32"])


@pytest.mark.parametrize("shape", MESHES[:2], ids=IDS[:2])
def test_sequence_parallel_encoder_matches_jax(runs, tree, shape):
    """JAX's ``act_sharding=seq_sharding(mesh)``: dp 2 x tp 2 keeps 25 of
    the 50 time rows a rank, dp 1 x tp 4 13/13/13/11 (the last block
    padded to 13, its pad rows masked as keys); each dp group's gathered
    output against JAX's one-device ``encoder_forward``."""
    mel = dryrun.train_batch(seed=7)["mel"]
    ref = np.asarray(jax_encoder(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(mel), JAX_ARCH))
    dp, tp = shape
    rows = [r["seq"]["rows"] for r in runs[shape]]
    assert rows == {(2, 2): [25] * 4, (1, 4): [13, 13, 13, 11]}[shape]
    per = mel.shape[0] // dp
    for r in runs[shape]:
        np.testing.assert_allclose(
            r["seq"]["out"], ref[r["dp_rank"] * per:(r["dp_rank"] + 1) * per],
            rtol=0, atol=1e-5)


def test_sequence_parallel_refuses_sharded_weights_and_autograd(runs):
    """tp-sharded weights still raise; autograd, refused until SP's
    backward was ported, now runs on every rank: no refusal, one
    reduce-scatter a layer, finite gradients on every encoder leaf
    (``tests/test_torch_parallel_seq_grad.py`` holds them to JAX)."""
    for r in runs[(2, 2)] + runs[(1, 4)]:
        refusals = r["seq"]["refusals"]
        assert "whole weights" in refusals["sharded"]
        assert "autograd" not in refusals
        assert r["seq"]["autograd"] == {"reduce_scatters": ARCH.encoder_layers,
                                        "finite": True}


def test_k2_plain_with_fewer_queries_equals_the_square_rows():
    """K2's plain version with S_q != S_k (a rank's queries over every key,
    pad keys past valid_len) gives the matching rows of the square call,
    and its lse; the gradient path takes S_q != S_k too: 13 queries over
    52 keys with valid_len 50, through ``EncoderAttention`` and through
    ``encoder_attention_backward``, equal autograd of
    ``encoder_attention_plain``, the pad keys' dK and dV zero."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 52, 3, 64)).astype(
        np.float32)) for _ in range(3))
    full = attn.encoder_attention_plain(q, k, v, 50)
    lse = attn.attention_lse_plain(q, k, 50)
    for rows in (slice(0, 13), slice(13, 26), slice(39, 52)):
        torch.testing.assert_close(
            attn.encoder_attention(q[:, rows], k, v, 50), full[:, rows],
            rtol=0, atol=0)
        torch.testing.assert_close(attn.attention_lse_plain(q[:, rows], k, 50),
                                   lse[:, :, rows], rtol=0, atol=0)
    dout = torch.from_numpy(rng.standard_normal((2, 13, 3, 64)).astype(np.float32))
    grads = []
    for fn in (attn.encoder_attention, attn.encoder_attention_plain):
        leaves = [x.clone().requires_grad_(True) for x in (q[:, :13], k, v)]
        (fn(*leaves, 50) * dout).sum().backward()
        grads.append([x.grad for x in leaves])
    got = attn.encoder_attention_backward(q[:, :13], k, v, full[:, :13],
                                          lse[:, :, :13], dout, 50)
    for a, b, c in zip(grads[0], grads[1], got):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(c, b, rtol=1e-5, atol=1e-6)
    assert got[0].shape == (2, 13, 3, 64) and got[1].shape == (2, 52, 3, 64)
    assert not got[1][:, 50:].any() and not got[2][:, 50:].any()


def test_gather_params_after_shard_params_returns_the_original(runs):
    assert all(r["gather_equal"] for r in runs[(2, 2)])


def test_meshed_output_gradients_keep_the_tma_rule(runs):
    """No output gradient reached K2's backward misaligned or strided on
    any rank: the (B, S, H / tp, 64) views keep the 16-byte rule
    themselves (``ops.attention.DOUT_COPIES``)."""
    assert all(r["dout_copies"] == 0 for rs in runs.values() for r in rs)


def test_meshed_save_hf_checkpoint_equals_the_unsharded_one(runs, weights,
                                                           out_dir, tmp_path):
    """dp 2 x tp 2: rank 0 writes the files an unsharded model writes, the
    same tensors bit for bit."""
    assert runs[(2, 2)][0]["gather_equal"]
    ref = ck.save_hf_checkpoint(model_from_state(weights, ARCH), ARCH,
                                str(tmp_path / "ref"))
    got, want = (read_safetensors(f"{d}/model.safetensors")
                 for d in (f"{out_dir}/hf", ref))
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    for f in ("config.json", "generation_config.json"):
        with open(f"{out_dir}/hf/{f}") as a, open(f"{ref}/{f}") as b:
            assert json.load(a) == json.load(b), f


def test_meshed_train_state_resumes_on_one_device(runs, weights, out_dir):
    """A dp 2 x tp 2 ``save_train_state`` after one step loads into an
    unsharded model and optimizer, whose next step gives the meshed run's
    loss and updates (the file holds whole tensors, moments included)."""
    state, tx = train.init_train_state(model_from_state(weights, ARCH),
                                       dryrun.TRAIN_LR)
    resumed = ck.load_train_state(f"{out_dir}/state.pt", state)
    assert resumed.step == 1
    saved = torch.load(f"{out_dir}/state.pt", weights_only=True)
    assert all(v.shape == torch.Size(weights[k].shape)
               for k, v in saved["params"].items())
    p1 = {k: v.numpy().copy() for k, v in saved["params"].items()}
    resumed, loss = train.make_train_step(tx)(
        resumed, train.place_batch(dryrun.train_batch(seed=21), "cpu"))
    meshed = runs[(2, 2)][0]["resume"]
    assert resumed.step == meshed["step"] == 2
    assert abs(loss.item() - meshed["loss"]) <= 1e-5 * abs(meshed["loss"])
    for name, p in resumed.params.named_parameters():
        got, p0 = meshed["params"][name], p1[name]
        want = p.detach().numpy()
        assert _rel(got - p0, want - p0) < 1e-3, name


def test_place_batch_refuses_a_batch_dp_does_not_divide():
    layout = mesh.Mesh(2, 2, rank=3)
    rows = train.place_batch({"x": np.arange(8)}, "cpu", layout)["x"]
    assert rows.tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="dp=2 does not divide the batch of 3"):
        train.place_batch({"x": np.arange(3)}, "cpu", layout)


def test_sharded_models_refuse_what_has_no_meshed_entry(weights):
    """A sharded model trains only through ``make_train_step(mesh=)``;
    distillation refuses a sharded student or teacher (JAX has no meshed
    distillation entry)."""
    layout = mesh.make_mesh(1)
    model = mesh.shard_params(model_from_state(weights, ARCH), layout)
    state, tx = train.init_train_state(model)
    with pytest.raises(ValueError, match="mesh="):
        train.make_train_step(tx)(state, {})
    with pytest.raises(ValueError, match="student is sharded"):
        distill.init_distill_state(model)
    student, _ = distill.init_distill_state(model_from_state(weights, ARCH))
    step = distill.make_distill_step(tx)
    with pytest.raises(ValueError, match="teacher is sharded"):
        step(student, model, {})


def test_dryrun_training_part_on_four_ranks():
    """``dryrun_multichip``'s training part at dp 2 x tp 2: sharded steps
    and remat steps whose loss falls, then the sequence-parallel encoder
    on the trained weights gathered back, against the unsharded one."""
    for r in launch.spawn(dryrun.train_dryrun, 4, 2, 2):
        assert r["step"][-1] < r["step"][0] and r["remat"][-1] < r["remat"][0]
        assert r["seq_err"] <= 1e-5


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    pytest.importorskip("transformers")
    pytest.importorskip("tokenizers")
    import sys

    sys.path.insert(0, "tools")
    from make_tiny_checkpoint import make_checkpoint

    return make_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "tiny"), seed=0)


def _manifest(tmp_path, n=4):
    import wave

    from _torch_tiny import audio

    lines = []
    for i in range(n):
        wav = tmp_path / f"a{i}.wav"
        with wave.open(str(wav), "wb") as wf:
            wf.setnchannels(1)
            wf.setsampwidth(2)
            wf.setframerate(16000)
            wf.writeframes((audio(1.0 + i / 2, seed=i) * 32767).astype("<i2").tobytes())
        lines.append(json.dumps({"audio": str(wav), "text": f"hello world {i}"}))
    path = tmp_path / "train.jsonl"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_run_finetune_on_a_mesh_matches_one_device(tiny_ckpt, tmp_path, capfd):
    """``run_finetune --dp 2 --tp 2 --backend gloo --cpu``: four spawned
    ranks print the losses of ``--dp 1 --tp 1`` (1e-5) and save a
    checkpoint that loads, with the unsharded run's tensor names and
    shapes."""
    from thewhisper_tpu_torch import run_finetune

    manifest = _manifest(tmp_path)
    common = ["--model", tiny_ckpt, "--manifest", manifest, "--steps", "2",
              "--batch-size", "4", "--max-tokens", "16", "--cpu"]
    one = run_finetune.main(common + ["--out", str(tmp_path / "one"),
                                      "--dp", "1", "--tp", "1"])
    four = run_finetune.main(common + ["--out", str(tmp_path / "four"),
                                       "--dp", "2", "--tp", "2",
                                       "--backend", "gloo"])
    text = capfd.readouterr().out
    assert "mesh: dp=1 tp=1" in text and "mesh: dp=2 tp=2" in text
    assert four["mesh"] == (2, 2) and len(four["losses"]) == 2
    np.testing.assert_allclose(four["losses"], one["losses"], rtol=1e-5)
    a, b = (read_safetensors(str(tmp_path / d / "model.safetensors"))
            for d in ("one", "four"))
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    model, _ = load_checkpoint(str(tmp_path / "four"), device="cpu",
                               chunk_length_s=10)
    assert model.encoder.pos_emb.shape[0] == 500
    assert (tmp_path / "four" / "tokenizer.json").exists()


def test_run_finetune_refuses_nccl_without_a_card_a_rank():
    from thewhisper_tpu_torch import run_finetune

    with pytest.raises(ValueError, match="--backend gloo"):
        run_finetune.main(["--model", "m", "--manifest", "x", "--out", "o",
                           "--dp", "2", "--cpu"])


def test_mesh_train_card_children_rehearse_on_the_cpu(tmp_path):
    """``chip_smoke.py`` [MESH_TRAIN]'s children at a small width (the real
    vocab, 2 + 2 layers, 1 s of audio) over gloo on the CPU: the
    parent's unsharded references, the one-rank mesh bit for bit against
    them, then the two-rank arms (tp 2, dp 2, remat, bf16) and the
    sequence-parallel encoder, each of which raises on a miss, and the
    parent's checks across ranks."""
    arch = dataclasses.replace(
        dryrun.CARD_ARCH, d_model=128, encoder_layers=2, encoder_heads=4,
        decoder_layers=2, decoder_heads=4, d_ff=256, max_source_positions=50,
        alignment_heads=((1, 0), (1, 3)))
    path = str(tmp_path / "grads.pt")
    ref = dryrun.mesh_train_reference(path, arch, 0, arch, 1.0, 1.0, "cpu")
    (a,) = launch.spawn(dryrun.card_train_nccl, 1, ref["a"], arch, 0, 1.0)
    pair = launch.spawn(dryrun.card_train_gloo_pair, 2, path, ref, arch, arch,
                        0, 1.0, 1.0)
    dryrun.check_mesh_train(a, pair, arch)
    assert a["differ"] == [] and a["leaves"] == len(ref["a"][0]["grads"])
    arms = pair[0]["arms"]
    assert sorted(arms) == ["dp1xtp2 bf16", "dp1xtp2 f32", "dp1xtp2 f32 remat",
                            "dp2xtp1 f32"]
    assert arms["dp1xtp2 f32"]["worst_leaf"][0] <= dryrun.CARD_GRAD_REL
    assert [p["sp"]["f32"]["rows"] for p in pair] == [25, 25]
    sp_grad = pair[0]["sp_grad"]
    assert sp_grad["f32"]["worst_leaf"][0] <= dryrun.CARD_GRAD_REL
    assert sp_grad["bf16"]["vs_f32"] <= sp_grad["bf16"]["bound"]
    assert sp_grad["f32"]["counts"]["reduce_scatters"] == arch.encoder_layers
