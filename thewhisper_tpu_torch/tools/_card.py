"""What the probes and ``chip_smoke.py`` share: the device they run on, the
card's name and power limit, and CUDA-event timing, of eager calls (what a
caller pays, the host's launch cost included) and of calls replayed from a
CUDA graph (the card's own time: a wrapper's Python and ctypes work takes
15-80 us of host time a call, more than the smallest kernels take)."""

from __future__ import annotations

import subprocess
from typing import Callable

import torch

# One NVIDIA H100 SXM's published peaks (NVIDIA's data sheet, dense rates,
# at the full 700 W): memory bytes/s and operations/s by type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
TF32_FLOPS = 494.7e12


def device(name: str) -> torch.device:
    """The device a probe runs on: ``cuda`` (the default) needs a card and
    fails without one; ``cpu`` runs the plain versions."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run on an NVIDIA GPU, or pass "
                         "--device cpu for the numerics alone")
    # Every f32 product here is true f32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(name)


def card(dev: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, as
    ``--query-gpu=name,power.limit --format=csv,noheader`` prints them;
    "cpu" for the CPU."""
    if dev.type == "cpu":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "-i", str(dev.index or 0),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn: Callable[[], object], iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms over ``iters`` calls after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def capture(fn: Callable[[], object], calls: int = 1) -> torch.cuda.CUDAGraph:
    """``calls`` calls of ``fn`` captured in one CUDA graph, after a warm-up
    call on a side stream. Arguments ``fn`` reads when it is called (a slot,
    a layer) are fixed at capture; a tensor a kernel reads is read at
    replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def graph_ms(fn: Callable[[], object], calls: int = 16, iters: int = 10) -> float:
    """Device time of one call of ``fn`` in ms: ``calls`` calls captured in
    one CUDA graph (``capture``), the graph replayed ``iters`` times and
    timed with CUDA events."""
    return cuda_ms(capture(fn, calls).replay, iters) / calls
