"""The gradient of the port's encoder attention against JAX's.

K2's backward on the card (``csrc/encoder_attention_bwd.cu``) is held to
``ops.attention.encoder_attention_backward_plain`` by the card tests and
``chip_smoke.py``; here that plain version, f32 on the CPU, is held to
``jax.vjp`` of thewhisper_tpu's ``_attention`` (the einsum path JAX runs
off the TPU) and to the TPU library's own ``mha_reference_bwd``, and
``EncoderAttention`` (the autograd function ``encoder_attention`` takes
under grad) to autograd of the plain forward. Inputs come from numpy
seeds. Tolerance: 1e-5 relative L2, f32 summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thewhisper_tpu.models.whisper import _attention
from thewhisper_tpu_torch.ops import attention as ta

from _torch_tiny import one_cpu_thread  # noqa: F401

B, S, H, DH = 2, 50, 3, 64


def _inputs(seed, valid_len=None):
    """q, k, v and dO as numpy (B, S, H, dh) f32; dO is zero on query rows
    >= valid_len, as the encoder that pads to valid_len and slices the rows
    off hands it back."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, S, H, DH)).astype(np.float32)
                   for _ in range(4))
    if valid_len is not None:
        do[:, valid_len:] = 0.0
    return q, k, v, do


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_grads(q, k, v, do, valid_len):
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = ta.encoder_attention_residuals(tq, tk, tv, valid_len)
    return [g.numpy() for g in ta.encoder_attention_backward_plain(
        tq, tk, tv, out, lse, tdo, valid_len)]


@pytest.mark.parametrize("valid_len", [None, 37])
def test_backward_plain_matches_jax_vjp_of_attention(valid_len):
    q, k, v, do = _inputs(0, valid_len)
    mask = None if valid_len is None else (
        jnp.arange(S) < valid_len)[None, None, None, :]
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda a, b, c: _attention(a, b, c, mask)[0], q, k, v)
        ref = vjp(jnp.asarray(do))
    for name, got, want in zip("qkv", _port_grads(q, k, v, do, valid_len), ref):
        assert _rel(got, want) < 1e-5, name


@pytest.mark.parametrize("valid_len", [None, 37])
def test_backward_plain_matches_the_library_reference(valid_len):
    """``mha_reference_bwd`` refuses ``sm_scale != 1``: it gets q scaled by
    1/sqrt(dh), so its dQ is the port's dQ times sqrt(dh). With valid_len
    it masks by segment ids (padded queries see padded keys), which agrees
    with the port's mask where dO is zero on the padded rows."""
    from jax.experimental.pallas.ops.tpu.flash_attention import (
        SegmentIds,
        mha_reference_bwd,
        mha_reference_no_custom_vjp,
    )

    q, k, v, do = _inputs(1, valid_len)
    scale = DH ** -0.5
    qt, kt, vt, dot = (jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))
                       for x in (q * scale, k, v, do))
    seg = None
    if valid_len is not None:
        ids = jnp.broadcast_to((jnp.arange(S) >= valid_len).astype(jnp.int32), (B, S))
        seg = SegmentIds(q=ids, kv=ids)
    with jax.default_matmul_precision("highest"):
        o, l, m = mha_reference_no_custom_vjp(qt, kt, vt, None, seg,
                                              save_residuals=True)
        dq, dk, dv, _ = mha_reference_bwd(qt, kt, vt, None, seg, o, l, m, dot)
    ref = [np.transpose(np.asarray(x), (0, 2, 1, 3)) for x in (dq * scale, dk, dv)]
    for name, got, want in zip("qkv", _port_grads(q, k, v, do, valid_len), ref):
        assert _rel(got, want) < 1e-5, name


def test_lse_plain_is_the_logsumexp_of_the_scaled_scores():
    q, k, _, _ = _inputs(2)
    tq, tk = torch.from_numpy(q), torch.from_numpy(k)
    scores = torch.einsum("bqhd,bkhd->bhqk", tq, tk) * DH ** -0.5
    torch.testing.assert_close(ta.attention_lse_plain(tq, tk),
                               torch.logsumexp(scores, dim=-1))
    torch.testing.assert_close(ta.attention_lse_plain(tq, tk, 20),
                               torch.logsumexp(scores[..., :20], dim=-1))


@pytest.mark.parametrize("valid_len", [None, 37])
def test_encoder_attention_gradient_matches_autograd_of_plain(valid_len):
    """Through strided (B, S, H, dh) views of one (B, S, 3 H dh) projection,
    as the encoder passes them."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((B, S, 3 * H * DH)).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((B, S, H, DH)).astype(np.float32))
    grads = []
    for fn in (ta.encoder_attention, ta.encoder_attention_plain):
        leaf = x.clone().requires_grad_(True)
        q, k, v = (t.view(B, S, H, DH) for t in leaf.chunk(3, dim=-1))
        out = fn(q, k, v, valid_len)
        out.backward(do)
        grads.append((out.detach(), leaf.grad))
    (out, g), (out_ref, g_ref) = grads
    torch.testing.assert_close(out, out_ref, rtol=0, atol=0)
    assert _rel(g.numpy(), g_ref.numpy()) < 1e-5


def test_encoder_attention_takes_the_autograd_function_only_under_grad():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(4))
    assert ta.encoder_attention(q, k, v).grad_fn is None
    q.requires_grad_(True)
    assert type(ta.encoder_attention(q, k, v).grad_fn).__name__ == "EncoderAttentionBackward"
    with torch.no_grad():
        assert ta.encoder_attention(q, k, v).grad_fn is None


def test_encoder_attention_backward_takes_an_expanded_gradient():
    """``out.sum()`` hands the backward a gradient whose strides are all 0."""
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _inputs(5)[:3])
    ta.encoder_attention(q, k, v).sum().backward()
    g = q.grad.clone()
    q.grad = None
    ta.encoder_attention_plain(q, k, v).sum().backward()
    assert _rel(g.numpy(), q.grad.numpy()) < 1e-5


def test_bf16_backward_plain_rounds_like_the_forward():
    """bf16 operands: P and dS rounded to bf16 before their products keep
    the gradients within bf16 rounding (2**-8 relative, times a few) of
    the f32 gradients of the same (bf16-valued) inputs."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(6))
    out, lse = ta.encoder_attention_residuals(q, k, v)
    got = ta.encoder_attention_backward_plain(q, k, v, out, lse, do)
    f = [x.float() for x in (q, k, v, do)]
    out32, lse32 = ta.encoder_attention_residuals(*f[:3])
    ref = ta.encoder_attention_backward_plain(*f[:3], out32, lse32, f[3])
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        rel = _rel(g.float().numpy(), r.numpy())
        assert 0 < rel < 3e-2, rel
