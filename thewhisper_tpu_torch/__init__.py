"""thewhisper_tpu_torch: the PyTorch/CUDA port of thewhisper_tpu.

The module layout mirrors the JAX package (``audio/``, ``models/``,
``engine/``, ``pipeline.py``) so each piece has an obvious counterpart; the
JAX package stays the reference the port is tested against. Every TPU
kernel on the ported path is a hand-written CUDA kernel for Hopper
(``csrc/``, built at first use by ``ops/_build.py``) with a plain PyTorch
version beside it; CPU tensors take the plain version, CUDA tensors the
kernel.

The port imports nothing of ``thewhisper_tpu``, not even its host-side
modules that never touched JAX: it keeps its own copies of ``config``,
``align`` (DTW word timestamps) and ``text`` (word grouping and the LCS
window merge), held equal to the JAX package's by ``tests/test_torch_host.py``.
"""

from thewhisper_tpu_torch.engine import EngineResult, WhisperEngine  # noqa: F401
from thewhisper_tpu_torch.pipeline import ASRPipeline  # noqa: F401

__all__ = ["ASRPipeline", "EngineResult", "WhisperEngine"]
