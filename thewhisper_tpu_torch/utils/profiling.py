"""Profiling and compilation-cache helpers (the port's counterpart of the
JAX package's ``utils/profiling.py``).

- ``trace(log_dir)``: context manager around ``torch.profiler.profile``
  (CPU activity, and CUDA activity when the process has a card) that
  writes a TensorBoard-loadable trace of everything inside into
  ``log_dir`` and yields the profile; ``trace_events(log_dir)`` reads the
  newest such trace back as Chrome-trace events, and ``kernel_times``
  sums its device kernels by name.
- ``annotate(name)``: a named host span in that trace.
- ``device_idle(events, start, end)``: the device's busy time and its idle
  gaps over a window of a trace.
- ``enable_compilation_cache(dir)``: where the port's compiled programs
  (the CUDA kernel library and the C++ host runtime) persist across
  restarts.
- ``Stopwatch``: tiny named accumulator of wall-clock samples.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from thewhisper_tpu_torch import native_lib
from thewhisper_tpu_torch.ops import _build

# Chrome-trace categories of the work a card does: kernels and copies.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[torch.profiler.profile]:
    """Profile everything inside into ``log_dir`` (default: a
    ``thewhisper-torch-trace`` directory under the temporary directory) as
    a ``*.pt.trace.json`` file that TensorBoard's profiler plugin and
    ``chrome://tracing`` load. Yields the ``torch.profiler.profile``; the
    file is written when the block exits."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "thewhisper-torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def annotate(name: str):
    """Named span shown in the profiler timeline."""
    return torch.profiler.record_function(name)


def trace_events(log_dir: str) -> List[dict]:
    """The events of the newest trace ``trace`` wrote into ``log_dir``, as
    the Chrome trace format lists them (``ts`` and ``dur`` in us; host and
    device timestamps on one clock)."""
    files = sorted(Path(log_dir).glob("*.pt.trace.json"), key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json trace in {log_dir}")
    with open(files[-1]) as f:
        return json.load(f)["traceEvents"]


def kernel_times(events: List[dict]) -> Dict[str, Tuple[int, float]]:
    """Name -> (launches, summed us) of the device kernels among
    ``events``."""
    out: Dict[str, Tuple[int, float]] = {}
    for e in events:
        if e.get("cat") == "kernel":
            cnt, us = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (cnt + 1, us + e["dur"])
    return out


def device_idle(events: List[dict], start: float,
                end: float) -> Tuple[float, List[Tuple[float, float]]]:
    """(busy us, idle gaps) of the device over ``[start, end)`` us: the
    union of its kernel, copy and set intervals clipped to the window, and
    the window's stretches that none of them covers, longest first."""
    spans = sorted((max(e["ts"], start), min(e["ts"] + e["dur"], end))
                   for e in events if e.get("cat") in DEVICE_CATEGORIES
                   and e["ts"] < end and e["ts"] + e["dur"] > start)
    busy, gaps, at = 0.0, [], start
    for lo, hi in spans:
        if lo > at:
            gaps.append((at, lo))
        if hi > at:
            busy += hi - max(lo, at)
            at = hi
    if at < end:
        gaps.append((at, end))
    return busy, sorted(gaps, key=lambda g: g[0] - g[1])


def enable_compilation_cache(cache_dir: Optional[str] = None) -> str:
    """Build and load the port's compiled programs (the CUDA kernel library
    of ``ops/_build.py`` and the C++ host runtime of ``native_lib.py``) in
    ``cache_dir``, else ``$WHISPER_COMPILE_CACHE``, else the package's
    ``build/`` directory, where they persist by default. Both are named by
    a hash of their sources, so a restart loads a build of the same sources
    instead of compiling. Creates the directory and returns it. A library
    this process already loaded stays loaded."""
    cache_dir = cache_dir or os.environ.get("WHISPER_COMPILE_CACHE",
                                            str(_build.PACKAGE_DIR / "build"))
    os.makedirs(cache_dir, exist_ok=True)
    _build.BUILD_DIR = native_lib.BUILD_DIR = Path(cache_dir)
    return cache_dir


class Stopwatch:
    """Named wall-clock accumulators with context-manager sampling."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def measure(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1e3 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }
