"""Whether what the timed path served is correct.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished, drawn from the seed with the longest
among them, goes through the plain reference once: its prompt and its
served tokens teacher-forced, float32 with TF32 off. Every id from
<|endoftext|> up is suppressed on both sides. The numbers read, over all
served tokens of the sample:

- ``logprob``: the largest difference between a served token's
  log-probability as the engine reported it and as the reference gives
  it: a token, or its log-probability, altered after it was scored;
- ``best``: the largest difference between a served token's
  log-probability as the engine reported it and the reference's best
  log-probability at that position: a token served that is not the best
  (greedy tokens), its own log-probability reported with it;
- ``gap``: the widest gap by which a served token's logit lies below the
  reference's best (printed; the control reads 0 in it, so no limit
  holds).

A cell's limits file says which it compares. Besides: rows served short
of ``max_new_tokens`` and calls that raised, each with the limit 0.

The limits are data: ``limits/<cell>.json`` beside this package.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from typing import Dict, List, Tuple

import numpy as np
import torch

from harness.drivers import CallRecord, pad_to
from harness.spec import BENCH_DIR, Cell
from harness.traffic import Request
from harness.weights import make_state

# What a control run reports: the program's readings and the control's.
READINGS = ("gap", "logprob", "best", "control_gap", "control_logprob",
            "control_best")


@dataclasses.dataclass
class Sample:
    """One served row to check: its 30 s window of audio, its token ids
    (prompt first), the engine's log-probability of each served token."""

    audio: np.ndarray
    tokens: List[int]
    logprobs: List[float]
    what: str


def reference(cell: Cell):
    """The configuration's plain reference module, by its name."""
    path = BENCH_DIR / "references" / f"{cell.config['reference']}.py"
    spec = importlib.util.spec_from_file_location(
        "cardbench_reference_" + cell.config["reference"], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def limits(cell: Cell) -> Dict[str, float]:
    with open(BENCH_DIR / "limits" / f"{cell.name}.json") as f:
        return json.load(f)


def sample(cell: Cell, records: List[CallRecord], pool: List[List[Request]],
           seed: int) -> Tuple[List[Sample], int]:
    """The rows to check, drawn from ``seed``, and the rows served short.

    ``clips``: ``check_rows`` clips of the calls that completed, the
    longest clip among them; their tokens are the pipeline's text, their
    log-probabilities the engine call's row.
    ``longform``: ``check_rows`` windows of the files that completed, half
    of them from the longest file; their tokens are the engine's rows."""
    mix = cell.traffic
    prompt = list(cell.config["special_tokens"]["prompt"])
    max_new = int(mix["max_new_tokens"])
    win_samples = int(float(mix["chunk_length_s"]) * 16000)
    rng = np.random.default_rng(int(seed))
    want = int(mix["check_rows"])
    done = [r for r in records if r.ok]
    short = 0
    cands: List[Tuple[float, Sample]] = []
    if mix["kind"] == "clips":
        for r in done:
            (call,) = r.engine_calls
            for j, ids in enumerate(r.served):
                short += len(ids) != max_new
                req = pool[r.pool_index][j]
                cands.append((req.seconds, Sample(
                    pad_to(req.audio, win_samples), prompt + ids,
                    [float(x) for x in call.token_logprobs[j, :len(ids)]],
                    f"call {r.pool_index} clip {j} ({req.seconds:.2f} s)")))
        longest = max(range(len(cands)), key=lambda i: cands[i][0])
        rest = [i for i in range(len(cands)) if i != longest]
        picks = [longest] + list(rng.choice(rest, size=min(want - 1, len(rest)),
                                            replace=False))
        return [cands[i][1] for i in picks], short
    # longform: every engine row of every finished file.
    by_file: Dict[int, List[Sample]] = {}
    for r in done:
        audio = pool[r.pool_index][0].audio
        padded = pad_to(audio, len(audio) + win_samples)
        for call in r.engine_calls:
            for j in range(call.rows):
                n = int(call.num_generated[j])
                short += n != max_new
                o = call.offsets[j]
                win = padded[o: o + win_samples].copy()
                ids = [int(t) for t in call.tokens[j, call.prompt_len:
                                                   call.prompt_len + n]]
                by_file.setdefault(r.pool_index, []).append(Sample(
                    win, prompt + ids,
                    [float(x) for x in call.token_logprobs[j, :n]],
                    f"file {r.pool_index} window at {o / 16000:.0f} s"))
    lengths = {i: len(pool[i][0].audio) for i in by_file}
    top = max(lengths, key=lengths.get)
    half = want // 2
    mine = by_file[top]
    others = [s for i, rows in by_file.items() if i != top for s in rows]
    if not others:
        half = want
    picks = [mine[i] for i in rng.choice(len(mine), size=min(half, len(mine)),
                                         replace=False)]
    picks += [others[i] for i in rng.choice(
        len(others), size=min(want - len(picks), len(others)), replace=False)]
    return picks, short


def readings(cell: Cell, samples: List[Sample], seed: int, device,
             control: bool = False) -> Dict[str, float]:
    """The numbers compared: ``gap``, ``logprob`` and ``best`` (see the
    module's docstring) over the samples, and each row's largest; with
    ``control``, ``control_gap``, ``control_logprob`` and
    ``control_best``, the same read of the reference at the precision
    below the configuration's in the program's place (its own first token
    and that token's log-probability for ``best``), at each position of
    the same prompts and served tokens. Rows served short are padded with
    <|endoftext|>, which reads as an infinite gap."""
    ref = reference(cell)
    if torch.device(device).type == "cuda":
        ref.exact_float32()
    arch = cell.arch
    special = cell.config["special_tokens"]
    p, allowed = len(special["prompt"]), int(special["eot"])
    width = p + int(cell.traffic["max_new_tokens"])
    state = make_state(arch, seed, device, getattr(torch, cell.config["dtype"]))
    audio = torch.from_numpy(np.stack([s.audio for s in samples])).to(device)
    rows = torch.tensor([s.tokens + [allowed] * (width - len(s.tokens))
                         for s in samples], device=device)
    lp = torch.tensor([s.logprobs + [0.0] * (width - p - len(s.logprobs))
                       for s in samples])
    mode = cell.config["mode"]
    with torch.inference_mode():
        got = ref.readings(state, arch, audio, rows, p, allowed,
                           ref.numerics_for(mode),
                           ref.numerics_for(mode, control=True) if control
                           else None)
    off = (lp - got["logprob"]).abs()
    from_best = (lp - got["best"]).abs()
    out = {"gap": float(got["gap"].max()), "logprob": float(off.max()),
           "best": float(from_best.max()),
           "row_gaps": got["gap"].amax(dim=1).tolist(),
           "row_logprobs": off.amax(dim=1).tolist(),
           "row_bests": from_best.amax(dim=1).tolist()}
    if control:
        out["control_gap"] = float(got["control_gap"].max())
        out["control_logprob"] = float(
            (got["control_logprob"] - got["logprob"]).abs().max())
        out["control_best"] = float(
            (got["control_best"] - got["best"]).abs().max())
    return out
