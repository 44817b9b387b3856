"""The port's "S" quantization against the JAX package's, on the CPU.

The quantizers must give the same int8 values bit for bit and the same f32
scales: both reduce max|w| over the input axis (-2 of JAX's (in, out), -1
of the port's (out, in)) and round half to even. The quantized linears are
held to JAX's ``_linear``: weight-only int8 dequantizes into the compute
type before the product, W8A8 multiplies int8 x int8 exactly, so at f32
both agree to summation order (atol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thewhisper_tpu.models import quant as jq
from thewhisper_tpu.models import whisper as jw
from thewhisper_tpu_torch.models import quant as tq
from thewhisper_tpu_torch.models import whisper as tw
from thewhisper_tpu_torch.models.load import params_from_jax

from _torch_tiny import ARCH, jax_params_numpy
from _torch_tiny import one_cpu_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    w = (0.02 * rng.standard_normal((3, 64, 96))).astype(np.float32)
    # Row 0 of layer 0 hits exact halves: max|w| = 127 gives scale 1, so
    # w / s lands on .5 and half-to-even decides (0.5 -> 0, 1.5 -> 2, ...).
    w[0, :, 0] = 0.0
    w[0, :8, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    return w


def test_quantize_weight_matches_jax():
    w = _weights()                                         # (L, in, out)
    ref = jq.quantize_weight(w)
    q, s = tq.quantize_weight(_t(w).transpose(-1, -2))     # (L, out, in)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.transpose(-1, -2).numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref["s"]))
    assert q[0, 0, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
    ref8 = jq.quantize_weight_w8a8(w)
    q8, s8 = tq.quantize_weight_w8a8(_t(w).transpose(-1, -2))
    np.testing.assert_array_equal(q8.transpose(-1, -2).numpy(), np.asarray(ref8["q8"]))
    np.testing.assert_array_equal(s8.numpy(), np.asarray(ref8["s8"]))
    np.testing.assert_array_equal(
        tq.dequantize_weight(q, s).transpose(-1, -2).numpy(),
        np.asarray(jq.dequantize_weight(ref)))


def test_quantize_embedding_and_rows_match_jax():
    rng = np.random.default_rng(1)
    emb = (0.02 * rng.standard_normal((200, 64))).astype(np.float32)
    ref = jq.quantize_embedding(emb)
    q, s = tq.quantize_embedding(_t(emb))
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref["q"]))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref["s"]))
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    rq, rs = jw._quantize_rows(jnp.asarray(x))
    xq, xs = tq.quantize_rows(_t(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(rs))


def test_quantize_kv_matches_jax():
    """JAX's feature-major (L, B, H, dh, T) against the port's (L, B, H, T, dh)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 2, 4, 16, 30)).astype(np.float32)
    ref = jq.quantize_kv(jnp.asarray(x))
    got = tq.quantize_kv(_t(x).transpose(-1, -2))
    np.testing.assert_array_equal(got.q.transpose(-1, -2).numpy(),
                                  np.asarray(ref["q"]))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(ref["s"]))


def _s_tree(tree):
    """The JAX "S" ("int8-all") tree as an engine holds it."""
    params = jq.quantize_params(tree, components=("decoder",))
    params = jq.quantize_params(params, components=("encoder",),
                                activation_int8=True)
    return jax.tree.map(np.asarray, jw.fuse_self_qkv_params(params))


def _s_model(tree, dtype=torch.float32):
    model = params_from_jax(tree, ARCH, dtype=dtype)
    tq.quantize_params(model, components=("decoder",))
    return tq.quantize_params(model, components=("encoder",),
                              activation_int8=True)


def test_quantize_params_and_jax_s_tree_carry_across_exactly():
    """The port's quantize_params on the float model and params_from_jax of
    the JAX "S" tree (W8A8 encoder, fused int8 self q/k/v) give the same
    modules with equal int8 values and scales."""
    tree = jax_params_numpy()
    ours = _s_model(tree)
    theirs = params_from_jax(_s_tree(tree), ARCH)
    sd, ref = ours.state_dict(), theirs.state_dict()
    assert sd.keys() == ref.keys()
    for name in sd:
        assert sd[name].dtype == ref[name].dtype, name
        torch.testing.assert_close(sd[name], ref[name], atol=0, rtol=0,
                                   msg=name)
    for name, mod in ours.named_modules():
        other = theirs.get_submodule(name)
        assert type(mod) is type(other), name
    enc_fc1 = ours.encoder.layers[0].fc1
    dec_fc1 = ours.decoder.layers[0].fc1
    assert tq.is_quantized_w8a8(enc_fc1) and not tq.is_quantized(enc_fc1)
    assert tq.is_quantized(dec_fc1) and not tq.is_quantized_w8a8(dec_fc1)
    assert tq.is_quantized(ours.decoder.token_emb)
    assert isinstance(ours.decoder.layers[0].cross_attn.k, tq.Int8Linear)
    # Same leaves, same types: the byte counts agree.
    unfused = jq.quantize_params(
        jq.quantize_params(tree, components=("decoder",)),
        components=("encoder",), activation_int8=True)
    assert tq.quantized_bytes(ours) == jq.quantized_bytes(unfused)
    assert tq.quantized_bytes(ours) < tq.quantized_bytes(
        params_from_jax(tree, ARCH))


def test_bits_other_than_4_or_8_raise_as_in_jax():
    for fn in (tq.quantize_weight, tq.quantize_embedding):
        with pytest.raises(ValueError, match="4 or 8"):
            fn(torch.zeros(4, 4), bits=3)
    with pytest.raises(ValueError, match="4 or 8"):
        jq.quantize_weight(np.zeros((4, 4), np.float32), bits=3)
    with pytest.raises(ValueError, match="4 or 8"):
        tq.quantize_params(params_from_jax(jax_params_numpy(), ARCH), bits=3)


def _linear_case(dtype, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 20, 64)).astype(np.float32)
    w = (0.05 * rng.standard_normal((64, 48))).astype(np.float32)
    b = (0.1 * rng.standard_normal(48)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    lin = torch.nn.Linear(64, 48, dtype=dtype)
    lin.weight.data = _t(w.T).to(dtype)
    lin.bias.data = _t(b).to(dtype)
    return (jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt),
            _t(x).to(dtype), lin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w8a8", [False, True])
def test_quantized_linear_matches_jax(dtype, w8a8):
    """f32: atol 1e-5 (summation order). bf16: 2**-6, the bf16 bound of
    tests/test_torch_model.py (one bf16 ULP for |y| in [2, 4); the two
    frameworks round the bf16 products' sum at other places)."""
    jx, jw_, jb, x, lin = _linear_case(dtype)
    leaf = (jq.quantize_weight_w8a8 if w8a8 else jq.quantize_weight)(
        np.asarray(jw_, np.float32))
    ref = np.asarray(jw._linear(jx, leaf, jb), np.float32)
    mod = (tq.W8A8Linear if w8a8 else tq.Int8Linear).from_linear(lin)
    out = mod(x)
    assert out.dtype == dtype and out.shape == (2, 20, 48)
    np.testing.assert_allclose(out.float().numpy(), ref,
                               atol=1e-5 if dtype == torch.float32 else 2.0 ** -6)


def test_s_model_functions_match_jax():
    """The W8A8 encoder, the weight-only int8 cross K/V and decoder, the int8
    table and int8 cross K/V, at f32: encoder to float rounding (the int8
    products are exact), the decoder passes to the 1e-4 of
    tests/test_torch_model.py."""
    tree = jax_params_numpy()
    params, model = _s_tree(tree), _s_model(tree)
    tw.fuse_self_qkv(model)
    mel = np.random.default_rng(4).standard_normal(
        (1, ARCH.n_mels, 300)).astype(np.float32)
    j_enc = jw.encoder_forward(params, jnp.asarray(mel), ARCH, jnp.float32)
    enc = tw.encoder_forward(model, _t(mel))
    np.testing.assert_allclose(enc.numpy(), np.asarray(j_enc), atol=1e-5)

    jk, jv = jw.compute_cross_kv(params, j_enc, ARCH)
    jk, jv = jq.quantize_kv(jk), jq.quantize_kv(jv)
    jcache = jw.make_cache(ARCH, 1, 8, jk, jv, dtype=jnp.float32)
    # The same int8 cross K/V on both sides isolates the decoder.
    ck = tq.QuantizedKV(_t(jk["q"]).transpose(-1, -2), _t(jk["s"]))
    cv = tq.QuantizedKV(_t(jv["q"]).transpose(-1, -2), _t(jv["s"]))
    cache = tw.make_cache(ARCH, 1, 8, ck, cv, dtype=torch.float32)
    prompt = np.array([[102, 110, 121, 123]])
    jl, jcache, ja = jw.decoder_prefill(params, jnp.asarray(prompt), jcache,
                                        ARCH, jnp.float32)
    tl, cache, ta = tw.decoder_prefill(model, _t(prompt), cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    jl, jcache, ja = jw.decoder_step(params, jnp.asarray([[7]]), jnp.int32(4),
                                     jcache, ARCH, jnp.float32)
    tl, cache, ta = tw.decoder_step(model, _t([[7]]), 4, cache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(
        cache.self_k.numpy(), np.swapaxes(np.asarray(jcache.self_k), 3, 4),
        atol=1e-4)
