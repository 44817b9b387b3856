"""Shared tiny configuration for the PyTorch-port parity tests.

The arch and special tokens are those of ``tests/test_pipeline.py``: d = 64,
2 + 2 layers, 4 heads, vocab 200, 80 mels, a 3 s model chunk (300 mel frames,
150 encoder positions). Inputs come from ``np.random.default_rng`` and go to
both packages as numpy arrays.
"""

import dataclasses

import numpy as np
import pytest

from thewhisper_tpu.config import ARCH_PRESETS, SpecialTokens

ARCH = dataclasses.replace(
    ARCH_PRESETS["tiny"],
    d_model=64, encoder_layers=2, encoder_heads=4, decoder_layers=2,
    decoder_heads=4, d_ff=128, vocab_size=200, n_mels=80,
    max_source_positions=150, max_target_positions=64,
    alignment_heads=((1, 0), (1, 2)),
)

SPECIAL = SpecialTokens(
    eot=101, sot=102, first_language=110, n_languages=5,
    translate=120, transcribe=121, no_speech=122, no_timestamps=123,
    timestamp_begin=124,
)

# Every id above EOT is suppressed, so the random model emits words (or
# stops) instead of ids the pipeline would drop as special tokens.
SUPPRESS = tuple(range(SPECIAL.eot + 1, ARCH.vocab_size))


class WordTokenizer:
    """Decodes every id below EOT; every third word ends a sentence."""

    def decode(self, ids, skip_special_tokens=True):
        return "".join(f" w{i}." if int(i) % 3 == 0 else f" w{i}"
                       for i in ids if int(i) < SPECIAL.eot)


def audio(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(int(seconds * 16000))).astype(np.float32)


def jax_params_numpy(seed: int = 3):
    """The JAX package's random parameters for :data:`ARCH`, as numpy."""
    import jax

    from thewhisper_tpu.models.whisper import init_params

    return jax.tree.map(np.asarray, init_params(ARCH, seed=seed))


@pytest.fixture
def cuda_device():
    """The first CUDA device, TF32 off; skips where there is no card (the
    CUDA kernels have no CPU mode)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The module's torch, BLAS and child processes on one CPU thread each.

    A test module that imports this fixture uses it for every test. The
    suite runs in several pytest-xdist workers at once, and each would
    otherwise keep a pool of as many threads as the machine has cores: on
    a loaded machine most of their time goes to waiting on one another
    (a tiny model's ``layer_norm`` took 10 ms a call, not microseconds).
    The computation and its results' checks stay as they are; the thread
    count is restored after the module."""
    import torch
    from threadpoolctl import threadpool_limits

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp, threadpool_limits(1):
            mp.setenv("OMP_NUM_THREADS", "1")
            mp.setenv("OPENBLAS_NUM_THREADS", "1")
            yield
    finally:
        torch.set_num_threads(threads)
