"""The port's K3 step (its plain version, which CPU tensors take) against the
JAX package's decoder step, on the arch of tests/test_mega_step.py.

Both sides get the same JAX "S" weights (weight-only int8 decoder and table,
fused self q/k/v; random biases and LayerNorm parameters) and the same
prefilled cache, carried across from JAX's
feature-major (L, B, H, dh, S) layout. Bounds are those
tests/test_mega_step.py holds the TPU kernel to: logits 2e-2 relative to
their max, alignment 2e-3, the written k/v rows 5e-2 (one bf16 rounding
apart), every other cache slot bit-identical. At f32 the plain step is the
XLA step's math, to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thewhisper_tpu.config import ARCH_PRESETS, WhisperArch
from thewhisper_tpu.models import quant as jq
from thewhisper_tpu.models import whisper as jw
from thewhisper_tpu_torch.engine import decode as tdecode
from thewhisper_tpu_torch.engine import WhisperEngine
from thewhisper_tpu_torch.models import quant as tq
from thewhisper_tpu_torch.models import whisper as tw
from thewhisper_tpu_torch.models.load import params_from_jax
from thewhisper_tpu_torch.ops import mega_step as tm

ARCH = WhisperArch(
    d_model=384, encoder_layers=2, encoder_heads=6, decoder_layers=2,
    decoder_heads=6, d_ff=1536, n_mels=80, vocab_size=500,
    max_source_positions=96, max_target_positions=64,
    alignment_heads=((0, 1), (1, 3)))
PROMPT = np.array([[1, 2, 3, 4]], np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


def jax_tree(params):
    import jax

    return jax.tree.map(np.asarray, params)


def _with_biases(params, std=0.1, seed=5):
    """Every bias and LayerNorm shift drawn from N(0, std) and every
    LayerNorm scale from 1 + N(0, std), as a checkpoint has them (JAX's
    ``init_params`` makes them 0 and 1). The k projections have no bias,
    so the fused k bias stays 0."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = path[-1].key
        if name == "scale":
            base = 1.0
        elif name in ("b", "bias") or name.endswith("_b"):
            base = 0.0
        else:
            return x
        return jnp.asarray(base + std * rng.standard_normal(x.shape), x.dtype)

    return jax.tree_util.tree_map_with_path(draw, params)


def _jax_params(dtype):
    params = _with_biases(jw.init_params(ARCH, seed=3, dtype=dtype))
    params = jq.quantize_params(params, components=("decoder",))
    return jax_tree(jw.fuse_self_qkv_params(params))


def _port_model(params, dtype):
    model = tw.fuse_self_qkv(params_from_jax(params, ARCH, dtype=dtype))
    assert tm.pack_mega_params(model) is not None
    return model


def _port_cache(jcache):
    """JAX's cache in the port's layout (int8 cross K/V as QuantizedKV)."""
    def kv(d):
        return tq.QuantizedKV(_t(d["q"]).transpose(-1, -2), _t(d["s"]))
    return tw.DecodeCache(
        _t(np.asarray(jcache.self_k, np.float32)).transpose(-1, -2),
        _t(np.asarray(jcache.self_v, np.float32)).transpose(-1, -2),
        kv(jcache.cross_k), kv(jcache.cross_v))


def _setup(dtype, slots):
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    params = _jax_params(jdt)
    rng = np.random.default_rng(0)
    enc_out = jnp.asarray(rng.standard_normal((1, 96, 384)), jdt)
    ck, cv = jw.compute_cross_kv(params, enc_out, ARCH)
    jcache = jw.make_cache(ARCH, 1, slots, jq.quantize_kv(ck),
                           jq.quantize_kv(cv), dtype=jdt)
    _, jcache, _ = jw.decoder_prefill(params, jnp.asarray(PROMPT), jcache,
                                      ARCH, jdt)
    cache = _port_cache(jcache)
    cache = tw.DecodeCache(cache.self_k.to(tdt), cache.self_v.to(tdt),
                           cache.cross_k, cache.cross_v)
    return params, jcache, _port_model(params, tdt), cache, jdt


@pytest.fixture(scope="module")
def bf16_16():
    return _setup("bf16", 16)


def _compare(jout, out, pos, f32=False):
    (jl, jcache, ja), (tl, cache, ta) = jout, out
    lr, lm = np.asarray(jl, np.float32), tl.float().numpy()
    assert lm.shape == lr.shape == (1, ARCH.vocab_size)
    ar, am = np.asarray(ja, np.float32), ta.float().numpy()
    assert am.shape == ar.shape == (1, 2, 96)
    if f32:
        np.testing.assert_allclose(lm, lr, atol=1e-4)
        np.testing.assert_allclose(am, ar, atol=1e-5)
    else:
        rel = np.abs(lr - lm).max() / max(np.abs(lr).max(), 1e-6)
        assert rel < 2e-2, f"logits rel err {rel}"
        assert np.abs(ar - am).max() < 2e-3
    for ref, got in ((jcache.self_k, cache.self_k), (jcache.self_v, cache.self_v)):
        r = np.swapaxes(np.asarray(ref, np.float32), 3, 4)
        g = got.float().numpy()
        assert np.abs(r - g).max() < (1e-4 if f32 else 5e-2)
        keep = np.arange(r.shape[3]) != pos
        np.testing.assert_array_equal(g[:, :, :, keep], r[:, :, :, keep])


@pytest.mark.parametrize("pos", [4, 9, 15])
def test_plain_step_matches_jax_step(bf16_16, pos):
    params, jcache, model, cache, jdt = bf16_16
    tok = np.array([[7 + pos]], np.int32)
    jout = jw.decoder_step(params, jnp.asarray(tok), jnp.int32(pos), jcache,
                           ARCH, jdt)
    cache = tw.DecodeCache(cache.self_k.clone(), cache.self_v.clone(),
                           cache.cross_k, cache.cross_v)
    out = tm.mega_decoder_step(model, _t(tok).long(), pos, cache)
    _compare(jout, out, pos)


@pytest.mark.parametrize("slots,pos", [(5, 4), (13, 9)])
def test_plain_step_unaligned_cache(slots, pos):
    """Cache lengths that are no multiple of 8 (prompt + max_new): the port
    pads nothing, so only the bounds and the untouched slots are checked."""
    params, jcache, model, cache, jdt = _setup("bf16", slots)
    tok = np.array([[11]], np.int32)
    jout = jw.decoder_step(params, jnp.asarray(tok), jnp.int32(pos), jcache,
                           ARCH, jdt)
    out = tm.mega_decoder_step_plain(model, _t(tok).long(), pos, cache)
    _compare(jout, out, pos)


def test_plain_step_matches_jax_megakernel(bf16_16):
    """The JAX Pallas kernel itself, in interpret mode on the CPU."""
    from thewhisper_tpu.ops import mega_step as jm

    params, jcache, model, cache, jdt = bf16_16
    pos = 9
    sk, sv, cross = jm.prepare_mega_cache(jcache)
    tok = np.array([[16]], np.int32)
    jl, (sk1, sv1), ja = jm.mega_decoder_step(
        jm.pack_mega_params(params, ARCH), jnp.asarray(tok), jnp.int32(pos),
        sk, sv, cross, ARCH, True)
    jout_cache = jw.DecodeCache(
        jm.from_slot_major(sk1[:, :16], ARCH.decoder_heads),
        jm.from_slot_major(sv1[:, :16], ARCH.decoder_heads),
        jcache.cross_k, jcache.cross_v)
    cache = tw.DecodeCache(cache.self_k.clone(), cache.self_v.clone(),
                           cache.cross_k, cache.cross_v)
    out = tm.mega_decoder_step_plain(model, _t(tok).long(), pos, cache)
    _compare((jl, jout_cache, ja), out, pos)


@pytest.mark.parametrize("pos", [4, 12])
def test_f32_plain_step_matches_jax_step(pos):
    """At f32 every rounding point of the plain step is f32 and its GELU is
    the exact one, so it is the XLA step's math to summation order."""
    params, jcache, model, cache, jdt = _setup("f32", 16)
    tok = np.array([[30 + pos]], np.int32)
    jout = jw.decoder_step(params, jnp.asarray(tok), jnp.int32(pos), jcache,
                           ARCH, jdt)
    _compare(jout, tm.mega_decoder_step_plain(model, _t(tok).long(), pos,
                                              cache), pos, f32=True)


def test_greedy_through_k3_route_matches_jax(bf16_16, monkeypatch):
    """The port's greedy loop sends every step of the packed bs=1 bf16 model
    to mega_decoder_step and gives JAX's XLA-step tokens exactly."""
    from thewhisper_tpu.engine.decode import greedy_decode as jax_greedy

    params, jcache, model, cache, jdt = bf16_16
    monkeypatch.setenv("WHISPER_MEGAKERNEL", "0")
    kw = dict(max_new_tokens=6, eot=2, capture_alignment=True)
    import jax

    ref = jax_greedy(jax.tree.map(jnp.asarray, params), ARCH,
                     jnp.asarray(PROMPT), jcache, compute_dtype=jdt, **kw)
    calls = []

    def counting(*args, **kwargs):
        calls.append(args[2])
        return tm.mega_decoder_step(*args, **kwargs)

    monkeypatch.setattr(tdecode, "mega_decoder_step", counting)
    fresh = tw.make_cache(ARCH, 1, 4 + 6, cache.cross_k, cache.cross_v,
                          dtype=torch.bfloat16)
    got = tdecode.greedy_decode(model, _t(PROMPT).long(), fresh, **kw)
    n = int(got.num_generated[0])
    # The position is a device tensor; steps after the stop (up to the
    # next host check) stay at the stopped slot and change nothing.
    calls = [int(c) for c in calls]
    assert len(calls) == got.steps
    assert calls[:min(n, 5)] == list(range(4, 4 + min(n, 5)))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(ref.num_generated))
    a_r, a_g = np.asarray(ref.align, np.float32), got.align.numpy()
    assert a_r.shape == a_g.shape
    assert np.abs(a_r - a_g).max() < 5e-3


def test_pack_and_gate():
    """Packing needs a weight-only int8 decoder with fused self q/k/v; the
    engine packs wherever mega_pays: at batch 1, for any decoder depth
    (turbo's 4 layers and this 2-layer arch too; K3 beats the plain step
    on the card at every depth)."""
    assert tm.mega_pays(ARCH_PRESETS["large-v3"])
    assert tm.mega_pays(ARCH_PRESETS["large-v3-turbo"])
    assert tm.mega_pays(ARCH)
    assert not tm.mega_pays(ARCH_PRESETS["large-v3"], batch=4)
    assert not tm.mega_pays(ARCH_PRESETS["large-v3-turbo"], batch=4)
    params = _jax_params(jnp.float32)
    assert tm.pack_mega_params(params_from_jax(params, ARCH)) is None
    float_model = tw.fuse_self_qkv(params_from_jax(
        jax_tree(jw.init_params(ARCH, seed=3)), ARCH))
    assert tm.pack_mega_params(float_model) is None    # not int8
    plain_kv = params_from_jax(params, ARCH)
    WhisperEngine(plain_kv)
    assert plain_kv.mega is None                       # float cross K/V
    packed = params_from_jax(params, ARCH)
    WhisperEngine(packed, cross_kv_int8=True)
    assert packed.mega is not None                     # 2 layers: packed
    # The stacks and the layers' modules share one copy.
    layer = packed.decoder.layers[1]
    assert layer.self_attn.qkv.weight.data_ptr() == packed.mega.qkv_w[1].data_ptr()
    assert packed.mega.smalls.shape == (2, 20 * 384 + 2 * 1536)


def test_turbo_depth_s_engine_greedy_through_k3_route_matches_jax(monkeypatch):
    """A 4-layer "S" engine (turbo's decoder depth) at batch 1 packs K3's
    operands, sends every greedy step to mega_decoder_step and gives JAX's
    XLA-step tokens exactly."""
    import dataclasses

    import jax
    from thewhisper_tpu.engine.decode import greedy_decode as jax_greedy

    arch = dataclasses.replace(ARCH, decoder_layers=4,
                               alignment_heads=((2, 1), (3, 3)))
    params = _with_biases(jw.init_params(arch, seed=4, dtype=jnp.bfloat16))
    params = jax_tree(jq.quantize_params(params, components=("decoder",)))
    model = params_from_jax(params, arch, dtype=torch.bfloat16)
    engine = WhisperEngine(model, cross_kv_int8=True)
    assert model.mega is not None and model.mega.o_w.shape[0] == 4
    assert engine.model is model

    rng = np.random.default_rng(1)
    enc = jnp.asarray(rng.standard_normal((1, 96, 384)), jnp.bfloat16)
    jparams = jax.tree.map(jnp.asarray, params)
    ck, cv = jw.compute_cross_kv(jparams, enc, arch)
    max_new = 6
    jcache = jw.make_cache(arch, 1, 4 + max_new, jq.quantize_kv(ck),
                           jq.quantize_kv(cv), dtype=jnp.bfloat16)
    kw = dict(max_new_tokens=max_new, eot=2, capture_alignment=True)
    monkeypatch.setenv("WHISPER_MEGAKERNEL", "0")
    ref = jax_greedy(jparams, arch, jnp.asarray(PROMPT), jcache,
                     compute_dtype=jnp.bfloat16, **kw)
    calls = []

    def counting(*args, **kwargs):
        calls.append(args[2])
        return tm.mega_decoder_step(*args, **kwargs)

    monkeypatch.setattr(tdecode, "mega_decoder_step", counting)
    cache = _port_cache(jcache)
    fresh = tw.make_cache(arch, 1, 4 + max_new, cache.cross_k, cache.cross_v,
                          dtype=torch.bfloat16)
    got = tdecode.greedy_decode(model, _t(PROMPT).long(), fresh, **kw)
    n = int(got.num_generated[0])
    calls = [int(c) for c in calls]
    assert len(calls) == got.steps
    assert calls[:min(n, max_new - 1)] == list(range(4, 4 + min(n, max_new - 1)))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  np.asarray(ref.num_generated))


def test_wrapper_takes_cpu_or_cuda_only(bf16_16):
    """CPU tensors take the plain version, CUDA tensors the kernel; any
    other device raises."""
    params, jcache, model, cache, jdt = bf16_16
    x = torch.zeros(1, 384, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tm.mega_step(model.mega, x, 4, cache, ARCH)


def _verify_window(pos, w):
    return np.array([[5 + (i * 7 + pos) % 90 for i in range(w)]], np.int32)


def _compare_verify(lr, jsk, jsv, out, pos, w):
    """The bounds tests/test_mega_step.py::test_verify_parity holds the TPU
    kernel to: logits 2e-2 relative to their max, the window's k/v 5e-2,
    every other slot bit-identical. ``jsk``/``jsv`` feature-major."""
    tl, cache, ta = out
    lm = tl.float().numpy()
    assert lm.shape == lr.shape == (1, w, ARCH.vocab_size)
    rel = np.abs(lr - lm).max() / max(np.abs(lr).max(), 1e-6)
    assert rel < 2e-2, f"logits rel err {rel}"
    assert not ta.any()
    for ref, got in ((jsk, cache.self_k), (jsv, cache.self_v)):
        r = np.swapaxes(np.asarray(ref, np.float32), 3, 4)
        g = got.float().numpy()
        assert np.abs(r - g).max() < 5e-2
        keep = np.ones(r.shape[3], bool)
        keep[pos:pos + w] = False
        np.testing.assert_array_equal(g[:, :, :, keep], r[:, :, :, keep])


def _fresh(cache):
    return tw.DecodeCache(cache.self_k.clone(), cache.self_v.clone(),
                          cache.cross_k, cache.cross_v)


@pytest.mark.parametrize("pos,w", [(4, 5), (9, 5), (6, 3)])
def test_plain_verify_matches_jax_verify(bf16_16, pos, w):
    """K4's plain version against JAX's decoder_verify at bf16."""
    params, jcache, model, cache, jdt = bf16_16
    tok = _verify_window(pos, w)
    jl, jc, _ = jw.decoder_verify(params, jnp.asarray(tok),
                                  jnp.asarray([pos], jnp.int32), jcache,
                                  ARCH, jdt)
    out = tm.mega_decoder_verify(model, _t(tok).long(), pos, _fresh(cache))
    _compare_verify(np.asarray(jl, np.float32), jc.self_k, jc.self_v, out,
                    pos, w)


def test_plain_verify_matches_jax_verify_megakernel(bf16_16):
    """JAX's verify Pallas kernel itself, in interpret mode on the CPU."""
    from thewhisper_tpu.ops import mega_step as jm

    params, jcache, model, cache, jdt = bf16_16
    pos, w = 9, 5
    sk, sv, cross = jm.prepare_mega_cache(jcache)
    tok = _verify_window(pos, w)
    jl, (sk1, sv1), _ = jm.mega_decoder_verify(
        jm.pack_mega_params(params, ARCH), jnp.asarray(tok), jnp.int32(pos),
        sk, sv, cross, ARCH)
    out = tm.mega_decoder_verify(model, _t(tok).long(), pos, _fresh(cache),
                                 plain=True)
    _compare_verify(np.asarray(jl, np.float32),
                    jm.from_slot_major(sk1[:, :16], ARCH.decoder_heads),
                    jm.from_slot_major(sv1[:, :16], ARCH.decoder_heads),
                    out, pos, w)


def test_plain_verify_rows_are_plain_steps():
    """Row j of a window is the step at slot pos + j: the same function (at
    f32, where the window's products and the step's round alike)."""
    params, jcache, model, cache, jdt = _setup("f32", 16)
    pos, w = 5, 4
    tok = _verify_window(pos, w)
    vl, vcache, _ = tm.mega_decoder_verify(model, _t(tok).long(), pos,
                                           _fresh(cache))
    step_cache = _fresh(cache)
    for j in range(w):
        sl, step_cache, _ = tm.mega_decoder_step(
            model, _t(tok[:, j:j + 1]).long(), pos + j, step_cache)
        torch.testing.assert_close(vl[:, j], sl, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(vcache.self_k, step_cache.self_k)


@pytest.mark.parametrize("mode", ["ngram", "layer-skip"])
def test_speculation_through_k4_route_matches_k3_greedy(bf16_16, monkeypatch,
                                                        mode):
    """A bs=1 bf16 speculative decode of the packed model sends every
    verify round to mega_decoder_verify (K4's route) and gives the tokens
    of the port's greedy decode through K3's route."""
    from thewhisper_tpu_torch.engine import speculative as tspec

    params, jcache, model, cache, jdt = bf16_16
    max_new, w = 8, 3
    kw = dict(max_new_tokens=max_new, eot=2)
    fresh = tw.make_cache(ARCH, 1, 4 + max_new, cache.cross_k, cache.cross_v,
                          dtype=torch.bfloat16)
    ref = tdecode.greedy_decode(model, _t(PROMPT).long(), fresh, **kw)
    calls = []

    def counting(*args, **kwargs):
        calls.append(args[2])
        return tm.mega_decoder_verify(*args, **kwargs)

    monkeypatch.setattr(tspec, "mega_decoder_verify", counting)
    s_cap = 4 + max_new + w + 1
    draft = d_cache = None
    if mode == "layer-skip":
        draft = tspec.make_layer_skip_draft(model, 1)
        enc = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (1, 96, 384)).astype(np.float32)).to(torch.bfloat16)
        dk, dv = tw.compute_cross_kv(draft, enc)
        d_cache = tw.make_cache(draft.arch, 1, s_cap, dk, dv)
    got = tspec.speculative_decode(
        model, draft, _t(PROMPT).long(),
        tw.make_cache(ARCH, 1, s_cap, cache.cross_k, cache.cross_v,
                      dtype=torch.bfloat16),
        d_cache, spec_window=w, ngram_draft=mode == "ngram", **kw)
    assert len(calls) == got.rounds > 0
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_array_equal(got.num_generated.numpy(),
                                  ref.num_generated.numpy())
