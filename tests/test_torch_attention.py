"""The port's encoder attention (K2's plain version) against the JAX
package: the repo's Pallas kernel in interpret mode and
``models/whisper.py::_attention``, the attention the encoder runs off the
TPU. f32 at ``atol 2e-5`` (the Pallas kernel's own test bound). The CUDA
kernel is held to this plain version in ``test_torch_kernels.py``.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from thewhisper_tpu.models import whisper as jw
from thewhisper_tpu_torch.ops import attention as ta

from _torch_tiny import one_cpu_thread  # noqa: F401


def _qkv(b, s, h, dh=64, seed=0):
    """Three (B, S, H, dh) f32 arrays, the port's layout."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, dh)).astype(np.float32)
            for _ in range(3)]


def _port(q, k, v, valid_len=None):
    out = ta.encoder_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                               valid_len=valid_len)
    return out.numpy()


def _pallas_interpret(q, k, v, valid_len):
    """``encoder_flash_attention`` in interpret mode, as
    tests/test_attention_pallas.py runs it; it takes (B, H, S, dh)."""
    from jax.experimental import pallas as pl

    from thewhisper_tpu.ops import attention_pallas as A

    real_call = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return real_call(*args, **kwargs)

    t = lambda x: jnp.asarray(np.swapaxes(x, 1, 2))          # noqa: E731
    with mock.patch.object(A.pl, "pallas_call", patched):
        out = A.encoder_flash_attention.__wrapped__(
            q=t(q), k=t(k), v=t(v), valid_len=valid_len, block_q=128,
            block_k=128, exp_dtype=jnp.float32)
    return np.swapaxes(np.asarray(out), 1, 2)


@pytest.mark.parametrize("valid_len", [None, 200])
def test_plain_matches_pallas_kernel(valid_len):
    q, k, v = _qkv(2, 256, 3)
    ref = _pallas_interpret(q, k, v, valid_len)
    out = _port(q, k, v, valid_len)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,valid_len", [(300, None), (300, 171), (150, 150)])
def test_plain_matches_jax_attention(s, valid_len):
    """S not a multiple of 128; keys at or past valid_len masked (the JAX
    function takes that as a boolean key mask)."""
    q, k, v = _qkv(2, s, 4, seed=1)
    mask = None
    if valid_len is not None:
        mask = jnp.asarray(np.arange(s) < valid_len)[None, None, None, :]
    ref, _ = jw._attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           mask, allow_flash=False)
    out = _port(q, k, v, valid_len)
    np.testing.assert_allclose(out, np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_plain_accepts_strided_views():
    """The encoder hands attention (B, S, H, dh) views of its projections."""
    q, k, v = _qkv(1, 130, 2, seed=2)
    big = torch.from_numpy(np.concatenate([q, k], axis=2))      # (1, S, 4, dh)
    out = ta.encoder_attention(big[:, :, :2], big[:, :, 2:], torch.from_numpy(v))
    np.testing.assert_array_equal(out.numpy(), _port(q, k, v))


def test_kernel_wrapper_rejects_other_devices():
    x = torch.zeros(1, 8, 1, 64, device="meta")
    with pytest.raises(ValueError, match="device"):
        ta.encoder_attention(x, x, x)
