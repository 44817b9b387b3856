"""The port's (dp, tp) mesh for serving against JAX's one-device engine.

Four gloo ranks on the CPU (``parallel.launch.spawn``), once per mesh
shape, run ``parallel.dryrun.mesh_checks`` at the JAX dry run's tiny arch
(``tests/test_parallel.py``: d_model 128, 2 + 2 layers, 4 heads, d_ff 256,
vocab 512) with JAX's ``init_params`` (seed 3, random biases: see
``tree``) carried across by ``params_from_jax``; the inputs are
``dryrun.make_inputs``' seeded numpy arrays, which JAX's engine gets too.
Tolerances (f32 on both sides): the encoder's states 1e-5; tokens and
``num_generated`` exact; ``sum_logprob`` 1e-4; the alignment 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import thewhisper_tpu.pipeline as jax_pl
from thewhisper_tpu.config import ARCH_PRESETS as JAX_PRESETS
from thewhisper_tpu.config import GenerationOptions as JaxOptions
from thewhisper_tpu.config import SpecialTokens as JaxSpecial
from thewhisper_tpu.engine import WhisperEngine as JaxEngine
from thewhisper_tpu.models.whisper import encoder_forward as jax_encoder
from thewhisper_tpu.models.whisper import init_params as jax_init
from thewhisper_tpu.parallel import param_pspecs as jax_pspecs
from thewhisper_tpu_torch.engine.engine import WhisperEngine
from thewhisper_tpu_torch.models.load import params_from_jax
from thewhisper_tpu_torch.models.whisper import Whisper
from thewhisper_tpu_torch.parallel import dryrun, launch, mesh
from thewhisper_tpu_torch.streaming.pipeline import DEFAULTS
from thewhisper_tpu_torch.training.train import init_train_state

from _torch_tiny import one_cpu_thread  # noqa: F401

ARCH = dryrun.TINY_ARCH
JAX_ARCH = dataclasses.replace(JAX_PRESETS["large-v3-turbo"],
                               **dataclasses.asdict(ARCH))
JAX_SPECIAL = JaxSpecial(**dataclasses.asdict(dryrun.TINY_SPECIAL))
MESHES = [(4, 1), (2, 2), (1, 4)]
IDS = [f"dp{dp}xtp{tp}" for dp, tp in MESHES]


@pytest.fixture(scope="module")
def tree():
    """JAX's ``init_params`` (seed 3) with its biases and LayerNorm
    parameters drawn from N(0, 0.1) (scales 1 + N) by a seeded numpy
    generator, as ``dryrun.BIAS_STD`` draws the port's: with JAX's zero
    biases a bias added on every tp rank instead of once goes unseen."""
    rng = np.random.default_rng(5)

    def draw(path, x):
        name = path[-1].key
        if name in ("b", "bias", "scale") or name.endswith("_b"):
            return (x + dryrun.BIAS_STD * rng.standard_normal(x.shape)
                    ).astype(np.float32)
        return np.asarray(x)

    return jax.tree_util.tree_map_with_path(draw, jax_init(JAX_ARCH, seed=3))


@pytest.fixture(scope="module")
def jax_refs(tree):
    """JAX's one-device results on the dry run's inputs."""
    inputs = dryrun.make_inputs()
    eng = JaxEngine(tree, JAX_ARCH, special=JAX_SPECIAL,
                    batch_buckets=(dryrun.BATCH,),
                    suppress_tokens=list(dryrun.SUPPRESS),
                    begin_suppress_tokens=list(dryrun.BEGIN_SUPPRESS))
    g = dryrun.GENERATE
    gen = eng.transcribe_features(inputs["mel"], JaxOptions(
        max_new_tokens=g.max_new_tokens, language=g.language,
        return_timestamps=True))
    w = dryrun.WINDOWS
    win = eng.transcribe_windows_async(
        jax.device_put(jnp.asarray(inputs["file"])), inputs["offsets"],
        inputs["win"], inputs["bucket"],
        JaxOptions(max_new_tokens=w.max_new_tokens, language=w.language),
        use_pallas=False).result()
    pipe = jax_pl.ASRPipeline(eng, tokenizer=None,
                              chunk_length_s=ARCH.max_source_positions / 50)
    words = pipe.transcribe_batch(
        inputs["requests"], return_timestamps="word",
        languages=inputs["languages"],
        generate_kwargs={"language": DEFAULTS.language,
                         "max_new_tokens": dryrun.COALESCED_TOKENS,
                         "num_beams": 1})
    enc = np.asarray(jax_encoder(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(inputs["mel"]), JAX_ARCH))
    return {"generate": gen, "windows": win, "encoder": enc,
            "coalescer": [x["text"] for x in words]}


@pytest.fixture(scope="module")
def runs(tree):
    """Every rank's ``mesh_checks`` result for each mesh (dp2 x tp2 also
    serves the one-device port engine)."""
    weights = {k: v.numpy() for k, v in
               params_from_jax(tree, ARCH).state_dict().items()}
    return {(dp, tp): launch.spawn(dryrun.mesh_checks, dp * tp, dp, tp,
                                   weights, 3, "cpu", (dp, tp) == (2, 2))
            for dp, tp in MESHES}


def test_make_mesh_shapes_and_errors():
    assert mesh.make_mesh(8).shape == (4, 2)
    assert mesh.make_mesh(8, dp=2, tp=4).shape == (2, 4)
    # dp alone derives tp, as JAX's does.
    assert mesh.make_mesh(8, dp=8).shape == (8, 1)
    assert mesh.make_mesh(3).shape == (3, 1)
    with pytest.raises(ValueError, match=r"dp\(3\) \* tp\(3\)"):
        mesh.make_mesh(8, dp=3, tp=3)
    with pytest.raises(ValueError, match="heads=4"):
        mesh.make_mesh(8, dp=1, tp=8, arch=ARCH)
    with pytest.raises(ValueError, match="d_ff"):
        mesh.make_mesh(4, dp=1, tp=4,
                       arch=dataclasses.replace(ARCH, d_ff=250))
    layout = mesh.make_mesh(4, dp=2, tp=2)
    assert not layout.live and (layout.dp_rank, layout.tp_rank) == (0, 0)
    layout.rank = 3
    assert (layout.dp_rank, layout.tp_rank) == (1, 1)
    assert mesh.batch_rows(layout, 8) == slice(4, 8)
    assert mesh.batch_rows(layout, 1) == slice(0, 1)


def _jax_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _jax_leaves(v, path + (k,))
    else:
        yield path, tree


def _port_name(path) -> str:
    """A JAX param path -> the port's state-dict name, layer index ``*``."""
    side, rest = path[0], path[1:]
    if rest[0] != "layers":
        if rest[0] in ("conv1", "conv2", "ln_post"):
            kind = "weight" if rest[1] in ("w", "scale") else "bias"
            return f"{side}.{rest[0]}.{kind}"
        return f"{side}.{rest[0]}"
    group, leaf = rest[1], rest[2]
    if group in ("attn", "self", "cross"):
        mod = {"attn": "attn", "self": "self_attn", "cross": "cross_attn"}[group]
        name, kind = leaf.split("_")
        return (f"{side}.layers.*.{mod}.{'out' if name == 'o' else name}."
                f"{'weight' if kind == 'w' else 'bias'}")
    if group == "mlp":
        name, kind = leaf.split("_")
        return f"{side}.layers.*.{name}.{'weight' if kind == 'w' else 'bias'}"
    return f"{side}.layers.*.{group}.{'weight' if leaf == 'scale' else 'bias'}"


def test_param_pspecs_match_jax_leaf_by_leaf():
    """Each JAX leaf's spec, its layer axis dropped and its (in, out) axes
    transposed to torch's (out, in), is the port's placement."""
    from torch.distributed.tensor import Replicate, Shard

    ours = mesh.param_pspecs()
    seen = set()
    for path, spec in _jax_leaves(jax_pspecs()):
        name = _port_name(path)
        seen.add(name)
        axes = tuple(spec)[1:] if "layers" in path else tuple(spec)
        if "tp" not in axes:
            assert ours[name] == Replicate(), name
            continue
        tp_axis = axes.index("tp")
        want = tp_axis if len(axes) == 1 else len(axes) - 1 - tp_axis
        assert ours[name] == Shard(want), name
    assert seen == set(ours)
    with torch.device("meta"):
        names = list(Whisper(ARCH).state_dict())
    for name in names:
        mesh.placement(name, ours)       # every leaf has a rule


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_pieces_reassemble_the_full_tensors(tree, tp):
    full = params_from_jax(tree, ARCH)
    state = full.state_dict()
    parts = []
    for r in range(tp):
        layout = mesh.Mesh(1, tp, rank=r)
        parts.append(mesh.shard_params(params_from_jax(tree, ARCH), layout))
    assert all(p.decoder.layers[0].self_attn.n_heads == 4 // tp for p in parts)
    specs = mesh.param_pspecs()
    for name, value in state.items():
        spec = mesh.placement(name, specs)
        pieces = [p.state_dict()[name] for p in parts]
        if spec.is_shard():
            assert all(x.shape[spec.dim] == value.shape[spec.dim] // tp
                       for x in pieces), name
            torch.testing.assert_close(torch.cat(pieces, spec.dim), value,
                                       rtol=0, atol=0)
        else:
            for x in pieces:
                torch.testing.assert_close(x, value, rtol=0, atol=0)
    row = parts[1].decoder.layers[0].fc2
    assert isinstance(row, mesh.RowParallelLinear) and row.tp.size == tp


def test_tp_sharded_encoder_matches_jax(runs, jax_refs):
    """dp 2 x tp 2: each dp group's encoder states (its rows, the tp
    all-reduces inside) against JAX's encoder_forward on one device."""
    ranks = runs[(2, 2)]
    got = np.concatenate([r["encoder"] for r in ranks if r["tp_rank"] == 0])
    np.testing.assert_allclose(got, jax_refs["encoder"], rtol=0, atol=1e-5)
    assert [r["local_heads"] for r in ranks] == [2, 2, 2, 2]


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_meshed_generate_matches_jax(runs, jax_refs, shape):
    """The full bucketed generate (suppress [5, 6], begin-suppress [7],
    timestamps and alignment capture) at batch 8."""
    got, ref = runs[shape][0]["mesh"]["generate"], jax_refs["generate"]
    np.testing.assert_array_equal(got["tokens"], ref.tokens)
    np.testing.assert_array_equal(got["num_generated"], ref.num_generated)
    np.testing.assert_allclose(got["sum_logprob"], ref.sum_logprob,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["align"], np.asarray(ref.align, np.float32),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_tp_ranks_pick_the_same_tokens(runs, shape):
    """Every rank's rows before the gather, bit for bit those of tp rank 0
    of its dp group, for each of the run's calls."""
    dryrun.check_tp_ranks(runs[shape])
    assert [r["local_heads"] for r in runs[shape]] == [4 // shape[1]] * 4


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_meshed_offset_windows_match_jax(runs, jax_refs, shape):
    got, ref = runs[shape][0]["mesh"]["windows"], jax_refs["windows"]
    np.testing.assert_array_equal(got["tokens"], ref.tokens)
    np.testing.assert_array_equal(got["num_generated"], ref.num_generated)


@pytest.mark.parametrize("shape", MESHES[:2], ids=IDS[:2])
def test_dp_coalescer_matches_jax_pipeline(runs, jax_refs, shape):
    """Three requests, one language each, coalesced over a dp-split
    bucket: the text of JAX's one-device pipeline."""
    assert runs[shape][0]["mesh"]["coalescer"] == jax_refs["coalescer"]


def test_beam_sampled_and_detect_match_one_device(runs):
    """dp 2 x tp 2 against the port's unsharded engine on the same
    weights: generate, 2 beams, a sampled call (each dp group draws the
    bucket's noise and keeps its rows), language detection, the windows,
    the coalescer, decode steps; and the refusals."""
    dryrun.check_against_one_device(runs[(2, 2)])


def test_meshed_engine_needs_a_process_group(tree):
    layout = mesh.make_mesh(1)
    model = mesh.shard_params(params_from_jax(tree, ARCH), layout)
    with pytest.raises(RuntimeError, match="process group"):
        WhisperEngine(model, mesh=layout)
    with pytest.raises(ValueError, match="sharded already"):
        mesh.shard_params(model, layout)
    with pytest.raises(ValueError, match="does not train"):
        init_train_state(model)


def test_spawn_reraises_a_child_failure():
    with pytest.raises(RuntimeError, match=r"rank \d exited with 1(.|\n)*"
                       r"dp\(3\) \* tp\(3\) != n_devices\(2\)"):
        launch.spawn(dryrun.mesh_checks, 2, 3, 3)


def test_card_children_rehearse_on_the_cpu():
    """``chip_smoke.py`` [MESH]'s children at a small width (the real
    vocab, 2 + 2 layers, 1 s of audio) over gloo on the CPU: the one-rank
    mesh against the unsharded engine, then the two-rank checks (gloo's
    collectives, tp 2 and dp 2 in f32, the dp-2 coalescer's text, bf16 at
    tp 2), each of which raises on a mismatch."""
    arch = dataclasses.replace(
        dryrun.CARD_ARCH, d_model=128, encoder_layers=2, encoder_heads=4,
        decoder_layers=2, decoder_heads=4, d_ff=256, max_source_positions=50,
        alignment_heads=((1, 0), (1, 3)))
    (one,) = launch.spawn(dryrun.card_nccl_graphs, 1, 0, 4, arch, 1.0)
    assert all(one["same"].values()), one["same"]
    pair = launch.spawn(dryrun.card_gloo_pair, 2, 0, 4, arch, 1.0)
    lead = pair[0]
    assert len(lead["text"]) == 3 and all(lead["text"])
    assert lead["bf16_prefix"]["of"] == 4
    for r in pair:
        assert r["heads"] == {"dp1xtp2 f32": 2, "dp2xtp1 f32": 4,
                              "dp2 coalescer": 4, "dp1xtp2 bf16": 2}

