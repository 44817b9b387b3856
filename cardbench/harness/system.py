"""The system under test: ``thewhisper_tpu_torch`` built from a
configuration and the run's seed, and the benchmark's own spans around
the calls it makes into it.

This is the only module of the benchmark that imports the program. It
builds what ``WhisperEngine.from_checkpoint`` builds, from the weights the
benchmark made instead of a checkpoint on disk: the model, the "S"
quantization where the configuration asks for it, the engine (int8 cross
K/V and K3's packing with it), and an ``ASRPipeline`` over the engine.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from harness.spec import Arch, Cell
from harness.weights import make_state

# Kernel library and host runtime builds: one fixed directory of the
# checkout, so only the first run of a checkout compiles.
CACHE_DIR = Path(__file__).resolve().parent.parent.parent / ".cardbench-cache"


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE_DIR / sub)
    # A library that loads JAX by itself when present must not.
    os.environ["USE_FLAX"] = "0"


@dataclasses.dataclass
class EngineCall:
    """One engine call seen by the benchmark's span: its real rows, its
    mel frames, the long-form offsets it was given (None for a batch of
    buffers) and, once decoded, its token rows (prompt first), tokens
    generated, each generated token's log-probability and step calls."""

    rows: int
    mel_frames: int
    offsets: Optional[List[int]]
    tokens: Any = None
    num_generated: Any = None
    token_logprobs: Any = None
    prompt_len: int = 0
    steps: int = 0


class System:
    """The program for one configuration: ``engine`` and ``pipeline``, and
    ``calls``, the engine calls made since the last ``calls.clear()``."""

    def __init__(self, cell: Cell, seed: int, device, batch_size: int,
                 chunk_length_s: float = 30.0):
        from thewhisper_tpu_torch.config import WhisperArch
        from thewhisper_tpu_torch.engine import WhisperEngine
        from thewhisper_tpu_torch.models.quant import quantize_params
        from thewhisper_tpu_torch.models.whisper import model_from_state
        from thewhisper_tpu_torch.pipeline import ASRPipeline

        cfg = cell.config
        arch: Arch = cell.arch
        self.arch = arch
        self.mode = cfg["mode"]
        dtype = getattr(torch, cfg["dtype"])
        warch = WhisperArch(**dataclasses.asdict(arch))
        model = model_from_state(make_state(arch, seed, device, dtype), warch,
                                 dtype=dtype, device=device)
        if self.mode == "int8-all":
            quantize_params(model, components=("decoder",),
                            quantize_embedding_table=True, bits=8)
            quantize_params(model, components=("encoder",),
                            activation_int8=True)
        elif self.mode != "bf16":
            raise ValueError(f"unknown mode {self.mode!r}")
        eot = int(cfg["special_tokens"]["eot"])
        self.engine = WhisperEngine(
            model, suppress_tokens=range(eot, arch.vocab_size),
            cross_kv_int8=self.mode != "bf16")
        if self.engine.special.eot != eot:
            raise ValueError("the configuration's <|endoftext|> is not the "
                             "engine's")
        self.pipeline = ASRPipeline(self.engine, tokenizer=None,
                                    chunk_length_s=chunk_length_s,
                                    language="en", batch_size=batch_size)
        self.calls: List[EngineCall] = []
        self._wrap_engine()

    def _wrap_engine(self) -> None:
        """A span around each engine entry point the pipeline calls, which
        records the call and, from its ``result()``, what it decoded."""
        eng = self.engine

        def wrap(name: str, offsets_of):
            original = getattr(eng, name)

            def entry(*args, **kwargs):
                with span("cardbench.dispatch"):
                    handle = original(*args, **kwargs)
                rec = EngineCall(rows=handle.b, mel_frames=handle.mel_frames,
                                 offsets=offsets_of(args))
                self.calls.append(rec)
                fetch = handle.result

                def result(*a, **kw):
                    with span("cardbench.result"):
                        res = fetch(*a, **kw)
                    rec.tokens, rec.num_generated = res.tokens, res.num_generated
                    rec.token_logprobs = res.token_logprobs
                    rec.prompt_len = res.prompt_len
                    rec.steps = int(res.decode_steps or 0)
                    return res

                handle.result = result
                return handle

            setattr(eng, name, entry)

        wrap("transcribe_audio_async", lambda a: None)
        wrap("transcribe_windows_async", lambda a: [int(o) for o in a[1]])
        wrap("transcribe_window_async", lambda a: [int(a[1])])

    def warm(self, traffic: Dict, t_mel: int, batches) -> None:
        """Decode programs of ``batches`` at ``t_mel`` frames and the
        mix's tokens and timestamps (on the card: their CUDA graphs)."""
        self.engine.warmup(t_mel, batches=tuple(batches),
                           max_new_tokens=int(traffic["max_new_tokens"]),
                           timestamps=bool(traffic["return_timestamps"]))

    def close(self) -> None:
        del self.pipeline, self.engine
        self.calls.clear()


@contextlib.contextmanager
def span(name: str):
    """A named host span in the profiler's trace (a no-op when none
    records)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def encode_spans():
    """While it is open, each encoder the engine queues (featurizer and
    encoder, ``PendingResult.encode``) runs inside a ``cardbench.encode``
    span."""
    from thewhisper_tpu_torch.engine.engine import PendingResult

    original = PendingResult.encode

    def encode(self):
        with span("cardbench.encode"):
            return original(self)

    PendingResult.encode = encode
    try:
        yield
    finally:
        PendingResult.encode = original


def build_kernels(device) -> float:
    """Build (first run of a checkout) or load the program's compiled
    libraries into ``CACHE_DIR``; returns the seconds it took."""
    from thewhisper_tpu_torch import native_lib
    from thewhisper_tpu_torch.ops import _build
    from thewhisper_tpu_torch.utils.profiling import enable_compilation_cache

    t0 = time.perf_counter()
    enable_compilation_cache(str(CACHE_DIR / "build"))
    if torch.device(device).type == "cuda":
        _build.lib()
    native_lib.load()
    return time.perf_counter() - t0
