"""Speculative decoding on the port's (dp, tp) mesh against JAX's
one-device speculative engine.

Four gloo ranks on the CPU (``parallel.launch.spawn``), once per mesh
shape, run ``parallel.dryrun.mesh_checks`` at the JAX dry run's tiny arch
(d_model 128, 2 + 2 layers, 4 heads, vocab 512) with JAX's
``init_params`` (seed 3, biases and LayerNorm parameters drawn from
N(0, 0.1), as ``test_torch_parallel.py`` draws them) carried across by
``params_from_jax``, and every speculative arm of
``dryrun.SPEC_TEST_ARMS``: ngram drafting, the one-layer layer-skip draft
of the sharded target (its layers tp-sharded, their all-reduces its own),
a whole draft on every rank (JAX's ``make_layer_skip_draft`` params
carried across), ``draft_int8`` on the whole draft and on the layer-skip
draft (its layers gathered whole first), and proposal tokens that only
rank 0 holds (``dryrun.proposals_from`` the greedy call's tokens, every
third one changed). The call is ``dryrun.GENERATE`` at batch 8 (suppress
masks, timestamps, alignment capture). Tolerances (f32 on both sides):
tokens, ``num_generated`` and ``spec_rounds`` exact; ``sum_logprob``
1e-4; the alignment 1e-3.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from thewhisper_tpu.config import ARCH_PRESETS as JAX_PRESETS
from thewhisper_tpu.config import GenerationOptions as JaxOptions
from thewhisper_tpu.config import SpecialTokens as JaxSpecial
from thewhisper_tpu.engine import WhisperEngine as JaxEngine
from thewhisper_tpu.engine.speculative import (
    make_layer_skip_draft as jax_layer_skip,
)
from thewhisper_tpu.models.whisper import init_params as jax_init
from thewhisper_tpu_torch.engine.speculative import make_layer_skip_draft
from thewhisper_tpu_torch.models import whisper as tw
from thewhisper_tpu_torch.models.load import params_from_jax
from thewhisper_tpu_torch.parallel import dryrun, launch, mesh

from _torch_tiny import one_cpu_thread  # noqa: F401

ARCH = dryrun.TINY_ARCH
JAX_ARCH = dataclasses.replace(JAX_PRESETS["large-v3-turbo"],
                               **dataclasses.asdict(ARCH))
JAX_SPECIAL = JaxSpecial(**dataclasses.asdict(dryrun.TINY_SPECIAL))
MESHES = [(4, 1), (2, 2), (1, 4)]
IDS = [f"dp{dp}xtp{tp}" for dp, tp in MESHES]
ARMS = dryrun.SPEC_TEST_ARMS


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
def jax_draft(tree):
    """JAX's layer-skip draft of the target: (params, arch)."""
    return jax_layer_skip(tree, JAX_ARCH, dryrun.SPEC_DRAFT_LAYERS)


@pytest.fixture(scope="module")
def runs(tree, jax_draft):
    """Every rank's ``mesh_checks`` result, every speculative arm, for each
    mesh; the whole drafts are JAX's draft params carried across."""
    weights = {k: v.numpy() for k, v in
               params_from_jax(tree, ARCH).state_dict().items()}
    d_tree, d_arch = jax_draft
    draft = params_from_jax({"decoder": d_tree["decoder"]},
                            dryrun.draft_arch(ARCH, dryrun.SPEC_DRAFT_LAYERS))
    draft_weights = {k: v.numpy() for k, v in draft.state_dict().items()}
    return {(dp, tp): launch.spawn(dryrun.mesh_checks, dp * tp, dp, tp,
                                   weights, 3, "cpu", False, ARMS,
                                   draft_weights)
            for dp, tp in MESHES}


@pytest.fixture(scope="module")
def jax_refs(tree, jax_draft):
    """JAX's one-device speculative engine on the dry run's features, one
    engine an arm (the int8 arms both quantize JAX's layer-skip draft)."""
    mel = dryrun.make_inputs()["mel"]
    g = dryrun.GENERATE
    opts = JaxOptions(max_new_tokens=g.max_new_tokens, language=g.language,
                      return_timestamps=True)
    d_tree, d_arch = jax_draft

    def engine(**kw):
        return JaxEngine(tree, JAX_ARCH, special=JAX_SPECIAL,
                         batch_buckets=(dryrun.BATCH,),
                         suppress_tokens=list(dryrun.SUPPRESS),
                         begin_suppress_tokens=list(dryrun.BEGIN_SUPPRESS), **kw)

    greedy = engine().transcribe_features(mel, opts)
    props = dryrun.proposals_from(np.asarray(greedy.tokens), greedy.prompt_len)
    out = {"greedy": greedy}
    for arm in ARMS:
        kw, tokens = {}, None
        if arm == "ngram":
            kw["spec_ngram"] = True
        elif arm == "proposals":
            tokens = props
        else:
            kw.update(draft_params=d_tree, draft_arch=d_arch,
                      draft_int8=arm.endswith("int8"))
        out[arm] = engine(**kw).transcribe_features(mel, opts,
                                                    draft_tokens=tokens)
    return out


@pytest.mark.parametrize("arm", ARMS)
@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_meshed_speculation_matches_jax(runs, jax_refs, shape, arm):
    got, ref = runs[shape][0]["spec"][arm], jax_refs[arm]
    np.testing.assert_array_equal(got["tokens"], ref.tokens)
    np.testing.assert_array_equal(got["num_generated"], ref.num_generated)
    assert got["spec_rounds"] == ref.spec_rounds
    np.testing.assert_allclose(got["sum_logprob"], ref.sum_logprob,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["align"], np.asarray(ref.align, np.float32),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_speculative_tokens_equal_the_meshed_greedy_call(runs, jax_refs, shape):
    """Speculation changes no token: every arm's tokens are the meshed
    greedy call's, which are JAX's one-device greedy tokens."""
    lead = runs[shape][0]
    greedy = lead["mesh"]["generate"]
    np.testing.assert_array_equal(greedy["tokens"], jax_refs["greedy"].tokens)
    for arm in ARMS:
        np.testing.assert_array_equal(lead["spec"][arm]["tokens"],
                                      greedy["tokens"], err_msg=arm)
        assert lead["spec"][arm]["spec_rounds"] > 0, arm
        assert lead["spec"][arm]["decode_steps"] is None, arm


@pytest.mark.parametrize("shape", MESHES, ids=IDS)
def test_tp_ranks_accept_the_same_tokens_each_round(runs, shape):
    """Every rank's rows and round count before the gather, and its
    accepted counts after every round, bit for bit those of tp rank 0 of
    its dp group; each dp group ran at most the rounds rank 0 reports."""
    ranks = runs[shape]
    dryrun.check_tp_ranks(ranks)
    for arm in ARMS:
        rounds = ranks[0]["spec"][arm]["spec_rounds"]
        local = [r["spec_rows"][arm][0][-1][1] for r in ranks]
        assert max(local) == rounds, (arm, local)
        assert all(len(r["accepted"][arm]) == n for r, n in zip(ranks, local))


def test_meshed_engine_still_refuses_what_has_no_rule(runs):
    """int8 cross K/V, a quantized target, ngram drafting with a draft, a
    draft sharded for another tp and ``draft_int8`` on a draft sharded on
    its own raise ``ValueError`` before any collective; speculation itself
    no longer does."""
    for shape in MESHES:
        refusals = runs[shape][0]["refusals"]
        assert tuple(sorted(refusals)) == dryrun.REFUSALS
        assert "not ported" in refusals["cross_kv_int8"]
        assert "sharded for the mesh" in refusals["quantized"]
        assert "pick one" in refusals["ngram_and_draft"]
        assert "sharded for tp=" in refusals["draft_tp"]
        assert "no placement rule" in refusals["draft_int8_sharded"]


@pytest.mark.parametrize("tp", [2, 4])
def test_layer_skip_draft_of_a_sharded_target_is_sharded(tree, tp):
    """The draft of a tp-sharded target holds the target's sharded layers
    and reports its tp group, so its alignment selector takes this rank's
    heads."""
    layout = mesh.Mesh(1, tp, rank=tp - 1)
    target = mesh.shard_params(params_from_jax(tree, ARCH), layout)
    draft = make_layer_skip_draft(target, 1)
    assert draft.tp is target.tp and draft.tp.size == tp
    assert draft.decoder.layers[0] is target.decoder.layers[0]
    assert draft.decoder.layers[0].self_attn.n_heads == ARCH.decoder_heads // tp
    sel = tw._selector(draft)
    assert sel.shape == (1, ARCH.decoder_heads // tp, 1)
    whole = make_layer_skip_draft(params_from_jax(tree, ARCH), 1)
    assert whole.tp is None


def test_proposal_rows_are_host_data():
    """A call's proposals become (bucket, max_new) int64 host rows, which
    rank 0 sends with the decode message."""
    from thewhisper_tpu_torch.engine.engine import WhisperEngine

    eng = WhisperEngine.__new__(WhisperEngine)
    rows = eng._prep_proposals([[5, 6, 7]], dryrun.GENERATE, 4)
    assert isinstance(rows, np.ndarray) and rows.dtype == np.int64
    assert rows.shape == (4, dryrun.GENERATE.max_new_tokens)
    assert rows[0, :3].tolist() == [5, 6, 7] and not rows[1:].any()
    assert eng._prep_proposals(None, dryrun.GENERATE, 4) is None
    assert torch.equal(torch.from_numpy(
        eng._prep_proposals(rows, dryrun.GENERATE, 4)), torch.from_numpy(rows))


def test_card_children_rehearse_on_the_cpu():
    """``chip_smoke.py`` [MESH_SPEC]'s children at a small width (the real
    vocab, 2 + 2 layers, 1 s of audio) over gloo on the CPU: (a) the
    one-rank mesh's ngram, layer-skip and proposals calls against the
    unsharded engine's, then (b) the two-rank arms at tp 2 and dp 2, each
    of which raises on a mismatch, and the tp ranks' accepted counts."""
    arch = dataclasses.replace(
        dryrun.CARD_ARCH, d_model=128, encoder_layers=2, encoder_heads=4,
        decoder_layers=2, decoder_heads=4, d_ff=256, max_source_positions=50,
        alignment_heads=((1, 0), (1, 3)))
    (one,) = launch.spawn(dryrun.card_spec_nccl, 1, 0, 6, arch, 1.0)
    assert sorted(one["arms"]) == sorted(dryrun.CARD_SPEC_ARMS)
    for arm, r in one["arms"].items():
        assert r["same"]["tokens"] and r["same"]["spec_rounds"], arm
        assert r["rounds"] > 0 and r["heads"] == 4
    pair = launch.spawn(dryrun.card_spec_gloo_pair, 2, 0, 6, arch, 1.0)
    dryrun.check_spec_tp_ranks(pair)
    names = [f"dp{dp}xtp{tp} {arm}" for dp, tp in ((1, 2), (2, 1))
             for arm in dryrun.CARD_SPEC_ARMS]
    assert sorted(pair[0]["arms"]) == sorted(names)
    for r in pair:
        assert {n: r["heads"][n] for n in names} == {
            n: 2 if "tp2" in n else 4 for n in names}
        assert all(len(r["accepted"][n]) > 0 for n in names)
