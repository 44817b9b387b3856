"""The port's model functions against the JAX package's, at f32 on the CPU.

Weights: the JAX pytree through ``params_from_jax`` (separate q/k/v leaves
and the fused ``qkv_w``/``qkv_b`` an engine leaves). Tolerance 1e-4
absolute: both sides compute in true f32 (JAX at Precision.HIGHEST), so
only summation order differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thewhisper_tpu.models import whisper as jw
from thewhisper_tpu_torch.models import whisper as tw
from thewhisper_tpu_torch.models.load import params_from_jax

from _torch_tiny import ARCH, jax_params_numpy
from _torch_tiny import one_cpu_thread  # noqa: F401

ATOL = 1e-4


@pytest.fixture(scope="module")
def both():
    tree = jax_params_numpy()
    return tree, params_from_jax(tree, ARCH, dtype=torch.float32)


def _mel(batch=2, frames=300, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, ARCH.n_mels, frames)).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_encoder_and_cross_kv(both):
    tree, model = both
    mel = _mel()
    ref = np.asarray(jw.encoder_forward(tree, jnp.asarray(mel), ARCH))
    out = tw.encoder_forward(model, _t(mel)).numpy()
    assert out.shape == ref.shape == (2, 150, ARCH.d_model)
    np.testing.assert_allclose(out, ref, atol=ATOL)

    ck, cv = jw.compute_cross_kv(tree, jnp.asarray(ref), ARCH)
    tk, tv = tw.compute_cross_kv(model, _t(ref))
    # JAX keeps the cross K/V feature-major (L, B, H, dh, T); the port
    # (L, B, H, T, dh).
    np.testing.assert_allclose(tk.numpy(), np.swapaxes(np.asarray(ck), 3, 4),
                               atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.swapaxes(np.asarray(cv), 3, 4),
                               atol=ATOL)


def test_encoder_plain_attention_argument(both):
    """On CPU tensors the kernel wrapper takes the plain version, so the
    explicit ``attention=`` argument gives the same encoder output."""
    from thewhisper_tpu_torch.ops.attention import encoder_attention_plain

    _, model = both
    mel = _t(_mel(batch=1, seed=1))
    torch.testing.assert_close(
        tw.encoder_forward(model, mel),
        tw.encoder_forward(model, mel, attention=encoder_attention_plain),
        atol=0, rtol=0)


def test_encoder_rejects_long_input(both):
    _, model = both
    with pytest.raises(ValueError, match="position table"):
        tw.encoder_forward(model, _t(_mel(batch=1, frames=400)))


@pytest.mark.parametrize("fused", [False, True])
def test_prefill_and_steps(both, fused):
    """Prefill logits, then three decode steps (logits, alignment and the
    cache slots they write) against the JAX decoder."""
    tree, model = both
    if fused:
        tree = jax.tree.map(np.asarray, jw.fuse_self_qkv_params(tree))
        model = params_from_jax(tree, ARCH, dtype=torch.float32)
    enc = np.asarray(jw.encoder_forward(tree, jnp.asarray(_mel(seed=2)), ARCH))
    ck, cv = jw.compute_cross_kv(tree, jnp.asarray(enc), ARCH)
    prompt = np.asarray([[102, 110, 121, 123], [102, 111, 121, 123]], np.int32)
    s_max = prompt.shape[1] + 4
    jcache = jw.make_cache(ARCH, 2, s_max, ck, cv)
    tk, tv = tw.compute_cross_kv(model, _t(enc))
    tcache = tw.make_cache(ARCH, 2, s_max, tk, tv)
    assert tcache.self_k.shape == (ARCH.decoder_layers, 2, ARCH.decoder_heads,
                                   s_max, ARCH.head_dim)

    jl, jcache, ja = jw.decoder_prefill(tree, jnp.asarray(prompt), jcache, ARCH)
    tl, tcache, ta = tw.decoder_prefill(model, _t(prompt).long(), tcache)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)

    tokens = np.asarray([[5, 7], [9, 11], [13, 15]], np.int32)
    for i, tok in enumerate(tokens):
        pos = prompt.shape[1] + i
        jl, jcache, ja = jw.decoder_step(
            tree, jnp.asarray(tok[:, None]), jnp.int32(pos), jcache, ARCH)
        tl, tcache, ta = tw.decoder_step(model, _t(tok[:, None]).long(), pos,
                                         tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    # The slots written so far hold the same K/V (JAX feature-major).
    n = prompt.shape[1] + len(tokens)
    np.testing.assert_allclose(
        tcache.self_k[:, :, :, :n].numpy(),
        np.swapaxes(np.asarray(jcache.self_k), 3, 4)[:, :, :, :n], atol=ATOL)
    np.testing.assert_allclose(
        tcache.self_v[:, :, :, :n].numpy(),
        np.swapaxes(np.asarray(jcache.self_v), 3, 4)[:, :, :, :n], atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gelu_form_follows_dtype(dtype):
    """Exact erf GELU in f32, the tanh approximation in bf16, as JAX."""
    x = np.linspace(-4, 4, 801, dtype=np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jw._gelu(jnp.asarray(x, jdt)).astype(jnp.float32))
    out = tw._gelu(torch.from_numpy(x).to(dtype)).float().numpy()
    # bf16: the two frameworks round the tanh form's intermediates at other
    # places; they agree to one bf16 ULP (2**-6 for |x| in [2, 4)).
    np.testing.assert_allclose(
        out, ref, atol=1e-6 if dtype == torch.float32 else 2.0 ** -6)
    approx = "none" if dtype == torch.float32 else "tanh"
    expect = torch.nn.functional.gelu(torch.from_numpy(x).to(dtype),
                                      approximate=approx)
    torch.testing.assert_close(tw._gelu(torch.from_numpy(x).to(dtype)), expect,
                               atol=0, rtol=0)


def test_bf16_logits_stay_f32(both):
    """A bf16 model still returns f32 logits (bf16 products, f32 sums)."""
    tree, _ = both
    model = params_from_jax(tree, ARCH, dtype=torch.bfloat16)
    enc = tw.encoder_forward(model, _t(_mel(batch=1, seed=3)))
    assert enc.dtype == torch.bfloat16
    k, v = tw.compute_cross_kv(model, enc)
    cache = tw.make_cache(ARCH, 1, 6, k, v)
    logits, _, _ = tw.decoder_prefill(model, torch.tensor([[102, 110, 121, 123]]),
                                      cache)
    assert logits.dtype == torch.float32
    x = torch.randn(1, 1, ARCH.d_model, generator=torch.Generator().manual_seed(0))
    ref = x.bfloat16().double() @ model.decoder.token_emb.double().t()
    torch.testing.assert_close(tw._logits(model, x.bfloat16()).double(), ref,
                               atol=1e-5, rtol=1e-5)


def test_alignment_selector_matches_jax():
    np.testing.assert_array_equal(tw._alignment_selector(ARCH),
                                  jw._alignment_selector(ARCH))


def test_init_params_distributions():
    arch = ARCH
    model = tw.init_params(arch, torch.Generator().manual_seed(0))
    ref = jax_params_numpy(seed=0)
    sd = model.state_dict()
    np.testing.assert_allclose(sd["encoder.pos_emb"].numpy(),
                               ref["encoder"]["pos_emb"], atol=1e-6)
    assert sd["encoder.conv1.weight"].shape == ref["encoder"]["conv1"]["w"].shape
    for name, t in sd.items():
        if name.endswith("bias"):
            assert not t.any(), name
        elif ".ln" in name:
            assert (t == 1).all(), name
        elif name != "encoder.pos_emb":
            assert abs(t.std().item() - 0.02) < 0.004, name
    bf = tw.init_params(arch, torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and bf.arch == arch
    torch.testing.assert_close(bf.decoder.token_emb,
                               model.decoder.token_emb.bfloat16())
