"""CUDA graphs of the decode loop's steps: the GPU's counterpart of the JAX
engine's compiled ``lax.while_loop``.

:class:`StepGraph` captures a run of decode steps (``engine.decode``'s
loops, whose state lives in device tensors and whose step takes its
position from the device) once, after a warm-up, and replays it. Nothing
in a captured step reads back to the host, so a replay is one launch of
the whole run; a capture that fails raises (no eager fallback).

K3's wrapper counts its launches in ``ops.mega_step.MEGA_LAUNCHES`` when
it launches; a replay launches what the capture recorded without passing
through the wrapper, so the graph adds that to the counter at each
replay, and the capture itself, which launches nothing, leaves it as it
was.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from thewhisper_tpu_torch.ops import mega_step


class StepGraph:
    """``run()`` captured as one CUDA graph on ``device``. ``warm()`` runs
    first, eagerly on a side stream, so that first-call caches (the K3
    scratch, the alignment selector, cuBLAS handles) exist before the
    capture; it must leave the state it works on as the caller wants it.
    ``capture_s`` is the capture's wall time, ``bytes`` the device memory
    the caching allocator reserved for the graph's private pool (the
    capture empties the allocator's cache first, as ``torch.cuda.graph``
    does, so that the difference is the pool's)."""

    def __init__(self, run: Callable[[], None], warm: Callable[[], None],
                 device: torch.device):
        self.device = device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warm()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        before = mega_step.MEGA_LAUNCHES
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                run()
        finally:
            # What one replay launches.
            self.launches = mega_step.MEGA_LAUNCHES - before
            mega_step.MEGA_LAUNCHES = before
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.bytes = torch.cuda.memory_reserved(device) - reserved

    def replay(self) -> None:
        self.graph.replay()
        mega_step.MEGA_LAUNCHES += self.launches
