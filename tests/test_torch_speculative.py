"""The port's speculative decoding against the JAX package's, at f32 on the CPU.

Both sides get the same weights (the JAX tree through ``params_from_jax``)
and the same cache, carried across from JAX's feature-major
(L, B, H, dh, S) layout. The arch is that of tests/test_speculative.py
(d 64, 4 decoder layers). Tokens, ``num_generated`` and ``rounds`` must be
identical to JAX's ``speculative_decode`` and the tokens to the port's own
greedy decode; the f32 numbers are held to the tolerances of
tests/test_speculative.py's ``_assert_exact``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thewhisper_tpu.config import ARCH_PRESETS, SpecialTokens
from thewhisper_tpu.engine import speculative as jspec
from thewhisper_tpu.engine.decode import greedy_decode as jax_greedy
from thewhisper_tpu.engine.decode import suppress_mask
from thewhisper_tpu.models import whisper as jw
from thewhisper_tpu_torch.engine import speculative as tspec
from thewhisper_tpu_torch.engine.decode import greedy_decode
from thewhisper_tpu_torch.models import whisper as tw
from thewhisper_tpu_torch.models.load import params_from_jax

from _torch_tiny import one_cpu_thread  # noqa: F401

ARCH = dataclasses.replace(
    ARCH_PRESETS["tiny"],
    d_model=64, encoder_layers=2, encoder_heads=4, decoder_layers=4,
    decoder_heads=4, d_ff=128, vocab_size=200, n_mels=80,
    max_source_positions=50, max_target_positions=64,
    alignment_heads=((1, 0), (2, 1)),
)
SP = SpecialTokens(eot=1, sot=2, first_language=10, n_languages=5,
                   translate=20, transcribe=21, no_speech=22,
                   no_timestamps=23, timestamp_begin=24)
PROMPT = np.tile(np.array([SP.sot, 10, 21, 23], np.int32), (3, 1))
MAX_NEW = 12
W = 3


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(arch, seed):
    """JAX's random parameters (``params_from_jax`` reads them as numpy)."""
    return jw.init_params(arch, seed=seed)


@pytest.fixture(scope="module")
def models():
    """(JAX tree, port model) for the target and an adversarial draft."""
    out = {}
    for name, seed in (("target", 11), ("bad", 99)):
        tree = _tree(ARCH, seed)
        out[name] = (tree, params_from_jax(tree, ARCH))
    return out


def _port_cache(jcache):
    """A float JAX cache in the port's (L, B, H, S, dh) layout."""
    return tw.DecodeCache(*(_t(x).transpose(-1, -2).contiguous()
                            for x in jcache))


def _enc(batch, seed=5):
    rng = np.random.default_rng(seed)
    mel = rng.standard_normal((batch, ARCH.n_mels, 100)).astype(np.float32)
    tree = _tree(ARCH, 11)
    return np.asarray(jw.encoder_forward(tree, jnp.asarray(mel), ARCH))


def _caches(tree, arch, enc, slots):
    """The same zeroed cache with ``tree``'s cross K/V on both sides."""
    ck, cv = jw.compute_cross_kv(tree, jnp.asarray(enc), arch)
    jcache = jw.make_cache(arch, enc.shape[0], slots, ck, cv)
    return jcache, _port_cache(jcache)


# ---------------------------------------------------------------------------
# The position repair and decoder_verify
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offset", [0, 60, 62, 63, 64, 70])
@pytest.mark.parametrize("s", [1, 3])
def test_embed_tokens_clamps_like_jax(models, offset, s):
    """JAX's dynamic_slice clamps the start so that S rows fit the table;
    the port clamps the same way (it used to return no rows past the end)."""
    tree, model = models["target"]
    tok = np.arange(5, 5 + 2 * s, dtype=np.int32).reshape(2, s)
    ref = jw._embed_tokens(tree["decoder"], jnp.asarray(tok), offset,
                           jnp.float32)
    got = tw.embed_tokens(model, _t(tok).long(), offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_embed_tokens_at_clips_each_row_like_jax(models):
    tree, model = models["target"]
    tok = np.arange(10, 20, dtype=np.int32).reshape(2, 5)
    pos = np.array([58, 62], np.int32)
    ref = jw._embed_tokens_at(tree["decoder"], jnp.asarray(tok),
                              jnp.asarray(pos), jnp.float32)
    got = tw.embed_tokens_at(model, _t(tok).long(), _t(pos).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_greedy_past_the_position_table_matches_jax():
    """P + max_new_tokens beyond max_target_positions + 1: JAX clamps the
    position rows and runs on; so does the port, with the same tokens."""
    arch = dataclasses.replace(ARCH, max_target_positions=16)
    tree = _tree(arch, 4)
    model = params_from_jax(tree, arch)
    enc = _enc(2, seed=6)
    jcache, cache = _caches(tree, arch, enc, 4 + 20)
    sup = suppress_mask(arch.vocab_size, (SP.eot,))
    ref = jax_greedy(tree, arch, jnp.asarray(PROMPT[:2]), jcache, 20, SP.eot,
                     suppress=jnp.asarray(sup))
    got = greedy_decode(model, _t(PROMPT[:2]).long(), cache, 20, SP.eot,
                        suppress=_t(sup))
    assert int(got.num_generated.min()) == 20
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))


@pytest.mark.parametrize("slots,positions,w", [
    (20, (4, 7), 4),          # per-sample positions inside the cache
    (72, (58, 62), 5),        # rows past max_target_positions (64): clipped
    (12, (8, 10), 4),         # slots past the cache's end: writes dropped
])
def test_decoder_verify_matches_jax(models, slots, positions, w):
    tree, model = models["target"]
    enc = _enc(2)
    jcache, cache = _caches(tree, ARCH, enc, slots)
    rng = np.random.default_rng(slots)
    shape = (ARCH.decoder_layers, 2, ARCH.decoder_heads, ARCH.head_dim, slots)
    sk, sv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    jcache = jcache._replace(self_k=jnp.asarray(sk), self_v=jnp.asarray(sv))
    cache = _port_cache(jcache)
    tok = rng.integers(5, 100, (2, w)).astype(np.int32)
    pos = np.asarray(positions, np.int32)
    jl, jc, ja = jw.decoder_verify(tree, jnp.asarray(tok), jnp.asarray(pos),
                                   jcache, ARCH)
    tl, tc, ta = tw.decoder_verify(model, _t(tok).long(), _t(pos).long(),
                                   cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=2e-4, atol=1e-5)
    for ref, got in ((jc.self_k, tc.self_k), (jc.self_v, tc.self_v)):
        np.testing.assert_allclose(got.numpy(),
                                   np.swapaxes(np.asarray(ref), -1, -2),
                                   rtol=2e-4, atol=2e-4)
    # Slots outside each window are untouched.
    for b, p in enumerate(positions):
        outside = np.ones(slots, bool)
        outside[p:p + w] = False
        for got, orig in ((tc.self_k, sk), (tc.self_v, sv)):
            np.testing.assert_array_equal(
                got.numpy()[:, b, :, outside],
                np.swapaxes(orig, -1, -2)[:, b, :, outside])


# ---------------------------------------------------------------------------
# speculative_decode
# ---------------------------------------------------------------------------


def _assert_exact(ref, got, capture):
    """tests/test_speculative.py's _assert_exact on either package's
    GreedyResult (converted to numpy)."""
    a = lambda x: np.asarray(x)                                # noqa: E731
    n_ref = a(ref.num_generated)
    np.testing.assert_array_equal(a(got.num_generated), n_ref)
    rt, gt = a(ref.tokens), a(got.tokens)
    p = rt.shape[1] - MAX_NEW
    for i, n in enumerate(n_ref):
        upto = min(n + 1, MAX_NEW)
        np.testing.assert_array_equal(gt[i, :p + upto], rt[i, :p + upto])
        np.testing.assert_allclose(a(got.token_logprobs)[i, :upto],
                                   a(ref.token_logprobs)[i, :upto],
                                   rtol=1e-4, atol=1e-5)
        if capture:
            rows = p + max(int(n) - 1, 0)
            np.testing.assert_allclose(a(got.align)[i, :, :rows],
                                       a(ref.align)[i, :, :rows],
                                       rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(a(got.sum_logprob), a(ref.sum_logprob),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(a(got.no_speech_prob), a(ref.no_speech_prob),
                               rtol=1e-5, atol=1e-6)


def _draft(models, kind):
    """(JAX tree, JAX arch, port model) of a model draft, else Nones."""
    tree, model = models["target"]
    if kind == "perfect":
        return tree, ARCH, model
    if kind == "layer-skip":
        jt, ja = jspec.make_layer_skip_draft(tree, ARCH, 2)
        return jt, ja, tspec.make_layer_skip_draft(model, 2)
    if kind == "adversarial":
        bad_tree, bad = models["bad"]
        return bad_tree, ARCH, bad
    return None, None, None


@pytest.mark.parametrize("kind,capture", [
    ("perfect", True), ("layer-skip", True), ("layer-skip", False),
    ("adversarial", True), ("ngram", True), ("ngram", False),
    ("proposals-half", False), ("proposals-garbage", False),
])
def test_speculative_matches_jax(models, kind, capture):
    tree, model = models["target"]
    enc = _enc(3)
    s_cap = 4 + MAX_NEW + W + 1
    sup = suppress_mask(ARCH.vocab_size, (0, 3))
    beg = suppress_mask(ARCH.vocab_size, (5,))
    kw = dict(capture_alignment=capture, no_speech_id=SP.no_speech)
    jcache, cache = _caches(tree, ARCH, enc, s_cap)
    greedy = greedy_decode(model, _t(PROMPT).long(), cache, MAX_NEW, SP.eot,
                           suppress=_t(sup), begin_suppress=_t(beg), **kw)

    d_tree, d_arch, d_model = _draft(models, kind)
    jd_cache = d_cache = None
    if d_tree is not None:
        jd_cache, d_cache = _caches(d_tree, d_arch, enc, s_cap)
    props = None
    if kind == "proposals-half":      # right for half the window, then wrong
        props = greedy.tokens.numpy()[:, 4:].copy()
        props[:, MAX_NEW // 2:] = 7
    elif kind == "proposals-garbage":
        props = np.random.default_rng(0).integers(
            5, 100, (3, MAX_NEW)).astype(np.int32)
    ref = jspec.speculative_decode(
        tree, ARCH, d_tree, d_arch, jnp.asarray(PROMPT), jcache, jd_cache,
        MAX_NEW, SP.eot, spec_window=W, suppress=jnp.asarray(sup),
        begin_suppress=jnp.asarray(beg), ngram_draft=kind == "ngram",
        proposal_tokens=None if props is None else jnp.asarray(props), **kw)
    _, cache = _caches(tree, ARCH, enc, s_cap)
    got = tspec.speculative_decode(
        model, d_model, _t(PROMPT).long(), cache, d_cache, MAX_NEW, SP.eot,
        spec_window=W, suppress=_t(sup), begin_suppress=_t(beg),
        ngram_draft=kind == "ngram",
        proposal_tokens=None if props is None else _t(props), **kw)

    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(ref.num_generated))
    assert got.rounds == int(ref.rounds) > 0
    _assert_exact(ref, got, capture)
    _assert_exact(greedy, got, capture)
    if kind == "perfect":
        # Every round accepts the whole window.
        assert got.rounds <= -(-(MAX_NEW - 1) // (W + 1)) + 1


def test_layer_skip_draft_shares_the_target(models):
    tree, model = models["target"]
    draft = tspec.make_layer_skip_draft(model, 2)
    assert draft.arch.decoder_layers == 2 and draft.encoder is None
    assert draft.arch.alignment_heads == ((1, 0),)
    assert draft.decoder.layers[1] is model.decoder.layers[1]
    assert draft.decoder.token_emb is model.decoder.token_emb
    assert draft.decoder.ln_post is model.decoder.ln_post


def test_draft_files_cross_between_packages(models, tmp_path):
    """A draft saved by JAX's save_draft loads in the port, and one saved by
    the port loads in JAX: the same decoder either way."""
    from thewhisper_tpu.models import quant as jq
    from thewhisper_tpu_torch.models import quant as tq

    tree, model = models["target"]
    jt, ja = jspec.make_layer_skip_draft(tree, ARCH, 2)
    jspec.save_draft(str(tmp_path / "jax_draft"), jt, ja)
    loaded = tspec.load_draft(str(tmp_path / "jax_draft.npz"), device="cpu")
    assert dataclasses.asdict(loaded.arch) == dataclasses.asdict(ja)
    assert loaded.encoder is None
    ref = tspec.make_layer_skip_draft(model, 2).state_dict()
    got = loaded.state_dict()
    assert got.keys() == ref.keys()
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], atol=0, rtol=0)

    # The port's int8, fused draft back into JAX.
    draft = tw.fuse_self_qkv(tq.quantize_params(
        params_from_jax(tree, ARCH).requires_grad_(False)))
    draft = tspec.make_layer_skip_draft(draft, 2)
    tspec.save_draft(str(tmp_path / "port_draft"), draft)
    jt2, ja2 = jspec.load_draft(str(tmp_path / "port_draft"))
    assert ja2 == ja
    assert set(jt2["decoder"]["layers"]["self"]) == {"qkv_w", "qkv_b",
                                                     "o_w", "o_b"}
    ref_q = jq.quantize_params(jt, components=("decoder",))
    np.testing.assert_array_equal(
        np.asarray(jt2["decoder"]["layers"]["mlp"]["fc1_w"]["q"]),
        np.asarray(ref_q["decoder"]["layers"]["mlp"]["fc1_w"]["q"]))
    back = tspec.load_draft(str(tmp_path / "port_draft"), device="cpu")
    for k, v in draft.state_dict().items():
        if "self_attn" not in k:
            torch.testing.assert_close(back.state_dict()[k], v, atol=0, rtol=0)
