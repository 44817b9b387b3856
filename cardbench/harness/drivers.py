"""Closed-loop drivers of the offline mixes: one caller, whole calls.

The window starts no call after ``seconds`` and ends when the last call
that started returns; with ``trace_calls`` it ends after that many calls
instead (the traced run traces a bounded part of the window). Each call
runs inside a ``cardbench.call`` span.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from harness.system import System, span
from harness.traffic import Request

_IDS = re.compile(r"<(\d+)>")


@dataclasses.dataclass
class CallRecord:
    """One call of the window: the pool entry it sent, its start and end
    on the host clock, whether it raised, its requests' seconds of audio,
    the engine calls it made and, for a batch of clips, each clip's
    served token ids as the pipeline's text gives them."""

    pool_index: int
    start: float
    end: float
    ok: bool
    seconds: float
    engine_calls: List[Any]
    served: Optional[List[List[int]]] = None
    error: str = ""


def served_ids(text: str) -> List[int]:
    """The ids in a pipeline text made without a tokenizer (" <id>" each)."""
    return [int(m) for m in _IDS.findall(text)]


def _call(system: System, mix: Dict, requests: List[Request]):
    kw = {"language": "en", "max_new_tokens": int(mix["max_new_tokens"])}
    ts = mix["return_timestamps"]
    if mix["kind"] == "clips":
        out = system.pipeline.transcribe_batch(
            [r.audio for r in requests], return_timestamps=ts,
            generate_kwargs=kw)
        return [served_ids(o["text"]) for o in out]
    system.pipeline(requests[0].audio, return_timestamps=ts,
                    generate_kwargs=kw, batch_size=int(mix["batch_size"]))
    return None


def warm_call(system: System, mix: Dict, requests: List[Request]) -> None:
    """One untimed call of the mix's shape."""
    _call(system, mix, requests)
    system.calls.clear()


def run_window(system: System, mix: Dict, pool: List[List[Request]],
               seconds: float, max_calls: Optional[int] = None
               ) -> List[CallRecord]:
    """Calls in a closed loop over the pool from its first entry, until
    ``seconds`` have passed (or ``max_calls`` are done)."""
    records: List[CallRecord] = []
    t_open = time.perf_counter()
    i = 0
    while time.perf_counter() - t_open < seconds:
        if max_calls is not None and len(records) >= max_calls:
            break
        reqs = pool[i % len(pool)]
        system.calls.clear()
        t0 = time.perf_counter()
        served, ok, err = None, True, ""
        try:
            with span("cardbench.call"):
                served = _call(system, mix, reqs)
        except Exception as e:  # a failed call counts its requests failed
            ok, err = False, f"{type(e).__name__}: {e}"
        t1 = time.perf_counter()
        records.append(CallRecord(i % len(pool), t0, t1, ok,
                                  sum(r.seconds for r in reqs),
                                  list(system.calls), served, err))
        i += 1
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return records


def rtfx(records: List[CallRecord]) -> float:
    """Seconds of real audio in the calls that completed over the seconds
    from the first call's start to the last call's return."""
    done = sum(r.seconds for r in records if r.ok)
    return done / (records[-1].end - records[0].start)


def long_form_offsets(n_samples: int, win: int) -> List[int]:
    """Window offsets of a long file as the pipeline windows it (a sixth
    of overlap on each side)."""
    step = win - 2 * (win // 6)
    if n_samples <= win:
        return [0]
    return [o for o in range(0, n_samples - win + step, step) if o < n_samples]


def needed_buckets(mix: Dict, pool: List[List[Request]], buckets) -> List[int]:
    """The batch buckets the mix's calls decode at."""
    if mix["kind"] == "clips":
        n = int(mix["batch"])
        return [min(b for b in buckets if b >= n)]
    bsz = int(mix["batch_size"])
    out = set()
    win = int(float(mix["chunk_length_s"]) * 16000)
    for (req,) in pool:
        left = len(long_form_offsets(len(req.audio), win))
        while left:
            if left >= bsz:
                take = bsz
            else:
                fit = [b for b in buckets if b <= left and b < bsz]
                take = max(fit) if fit else left
            out.add(min(b for b in buckets if b >= take))
            left -= take
    return sorted(out)


def pad_to(x: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros(n, np.float32)
    out[: min(n, len(x))] = x[:n]
    return out
