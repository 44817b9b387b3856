"""The traced run: a bounded part of the window under ``torch.profiler``,
its trace written under ``TMPDIR``, read back and deleted, and the
context each per-layer metric reads.

Device work is attributed to the host the way ``chip_smoke.py``'s
``replay_split`` does: a kernel or copy carries the correlation id of the
runtime call that launched it (for a CUDA graph's kernels, the graph
launch), and that call sits inside the benchmark's spans on the host.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

import torch

from harness import yardsticks as Y

HOST_CATEGORIES = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "cardbench."


@contextlib.contextmanager
def profile(enabled: bool) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the block's host ops and, with a card, its device work."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof


def read_events(prof: torch.profiler.profile) -> List[dict]:
    """The profile's Chrome-trace events (``ts`` and ``dur`` in us, host
    and device on one clock); the file goes under ``TMPDIR`` and is
    deleted once read."""
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0].split("<")[0][:80]


class TraceContext:
    """What a per-layer metric reads: the traced span's events, the span
    on the trace's clock (``start_us``, ``end_us``: the benchmark's
    ``cardbench.window`` span, opened on the main thread around the
    traced part of the window), the engine calls made in it, the
    configuration's ``arch`` and ``mode``, and the mix."""

    def __init__(self, events: List[dict], arch, mode: str, traffic: Dict,
                 calls: List[Any]):
        self.events = events
        self.arch, self.mode, self.traffic = arch, mode, traffic
        self.calls = calls
        spans = self.spans("cardbench.window")
        if not spans:
            raise RuntimeError("the trace holds no cardbench.window span")
        self.start_us = min(e["ts"] for e in spans)
        self.end_us = max(e["ts"] + e["dur"] for e in spans)
        self.device = [e for e in events if e.get("cat") in Y.DEVICE_CATEGORIES
                       and e["ts"] < self.end_us
                       and e["ts"] + e["dur"] > self.start_us]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]

    @property
    def span_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def spans(self, name: str) -> List[dict]:
        """The benchmark's host spans called ``name``, in time order."""
        return sorted((e for e in self.events
                       if e.get("cat") == "user_annotation" and e["name"] == name),
                      key=lambda e: e["ts"])

    def busy_s(self) -> float:
        return Y.device_idle(self.device, self.start_us, self.end_us)[0] / 1e6

    def correlations(self, span_name: Optional[str] = None,
                     graph: Optional[bool] = None) -> Set[Any]:
        """Correlation ids of the runtime and driver calls inside the
        spans ``span_name`` (every call where None); ``graph``: only
        graph launches (True) or none of them (False)."""
        spans = ([(e["ts"], e["ts"] + e["dur"]) for e in self.spans(span_name)]
                 if span_name else [(self.start_us, self.end_us)])
        out: Set[Any] = set()
        for e in self.events:
            if e.get("cat") not in HOST_CATEGORIES:
                continue
            is_graph = "GraphLaunch" in e["name"]
            if graph is not None and is_graph != graph:
                continue
            if any(lo <= e["ts"] <= hi for lo, hi in spans):
                out.add(e.get("args", {}).get("correlation"))
        out.discard(None)
        return out

    def device_by(self, correlations: Set[Any], kernels_only: bool = True
                  ) -> List[dict]:
        pool = self.kernels if kernels_only else self.device
        return [e for e in pool
                if e.get("args", {}).get("correlation") in correlations]

    def windows(self) -> int:
        """Windows of audio (real rows) the traced engine calls encoded
        and decoded."""
        return sum(c.rows for c in self.calls)


def breakdown(ctx: TraceContext, top: int = 10) -> Dict[str, List]:
    """The contract's ``breakdown``: the device operations that took most
    time in the traced span, and its longest idle gaps, each named by the
    benchmark span and the innermost host op the host was in when the
    device went idle."""
    by_name: Dict[str, float] = {}
    for name, (_, us) in Y.kernel_times(ctx.kernels).items():
        by_name[short(name)] = by_name.get(short(name), 0.0) + us / 1e6
    for e in ctx.device:
        if e["cat"] != "kernel":
            by_name[e["cat"]] = by_name.get(e["cat"], 0.0) + e["dur"] / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    _, gaps = Y.device_idle(ctx.device, ctx.start_us, ctx.end_us)
    host = [e for e in ctx.events if e.get("cat") in ("user_annotation", "cpu_op")
            and "dur" in e]
    named: List[Tuple[str, float]] = []
    for lo, hi in gaps[:top]:
        inside = [e for e in host if e["ts"] <= lo < e["ts"] + e["dur"]]
        ours = [e for e in inside if e["name"].startswith(SPAN_PREFIX)]
        ops_in = [e for e in inside if e.get("cat") == "cpu_op"]
        name = (min(ours, key=lambda e: e["dur"])["name"] if ours
                else "outside the benchmark's spans")
        if ops_in:
            name += " / " + min(ops_in, key=lambda e: e["dur"])["name"]
        named.append((name, (hi - lo) / 1e6))
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in named]}
