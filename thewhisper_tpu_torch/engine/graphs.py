"""CUDA graphs of the decode loop's steps: the GPU's counterpart of the JAX
engine's compiled ``lax.while_loop``.

:class:`StepGraph` captures a run of decode steps (``engine.decode``'s
loops, whose state lives in device tensors and whose step takes its
position from the device) once, after a warm-up, and replays it. Nothing
in a captured step reads back to the host, so a replay is one launch of
the whole run; a capture that fails raises (no eager fallback).

K3's, K4's and Q4's wrappers count their launches in
``ops.mega_step.MEGA_LAUNCHES``, ``MEGA_VERIFY_LAUNCHES`` and
``ops.int4_linear.Q4_LAUNCHES`` when they launch; a replay launches what
the capture recorded without passing through the wrappers, so the graph
adds that to the counters at each replay, and the capture itself, which
launches nothing, leaves them as they were.

A meshed engine's steps hold the tp all-reduces (``parallel.mesh``): the
warm-up on the side stream runs them first, so the NCCL communicator
exists before the capture records them. Gloo's collectives cannot be
captured, so a gloo mesh's engine makes no graph: the engine's rule by
backend (``engine.WhisperEngine``).

A captured step that draws random numbers (a sampled step) draws from a
``torch.Generator`` that the graph registers (``generators``): each
replay then reads the generator's seed and offset when it runs and
advances the offset as the eager draws would, so a replay draws what the
same steps draw eagerly, for whatever seed the generator holds.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from thewhisper_tpu_torch.ops import int4_linear, mega_step

# The launch counters a replay adds to: (module, name, StepGraph attribute).
_COUNTERS = ((mega_step, "MEGA_LAUNCHES", "launches"),
             (mega_step, "MEGA_VERIFY_LAUNCHES", "verify_launches"),
             (int4_linear, "Q4_LAUNCHES", "q4_launches"))


class StepGraph:
    """``run()`` captured as one CUDA graph on ``device``. ``warm()`` runs
    first, eagerly on a side stream, so that first-call caches (the K3
    scratch, the alignment selector, cuBLAS handles) exist before the
    capture; it must leave the state it works on as the caller wants it.
    ``capture_s`` is the capture's wall time, ``bytes`` the device memory
    the caching allocator reserved for the graph's private pool (the
    capture empties the allocator's cache first, as ``torch.cuda.graph``
    does, so that the difference is the pool's). ``launches``,
    ``verify_launches`` and ``q4_launches`` are K3's, K4's and Q4's
    launches a replay makes."""

    def __init__(self, run: Callable[[], None], warm: Callable[[], None],
                 device: torch.device, *generators: torch.Generator):
        self.device = device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            warm()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        before = [getattr(mod, name) for mod, name, _ in _COUNTERS]
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        for g in generators:
            self.graph.register_generator_state(g)
        try:
            with torch.cuda.graph(self.graph):
                run()
        finally:
            # What one replay launches.
            for (mod, name, attr), was in zip(_COUNTERS, before):
                setattr(self, attr, getattr(mod, name) - was)
                setattr(mod, name, was)
        torch.cuda.synchronize(device)
        self.capture_s = time.perf_counter() - t0
        self.bytes = torch.cuda.memory_reserved(device) - reserved

    def replay(self) -> None:
        self.graph.replay()
        for mod, name, attr in _COUNTERS:
            setattr(mod, name, getattr(mod, name) + getattr(self, attr))
