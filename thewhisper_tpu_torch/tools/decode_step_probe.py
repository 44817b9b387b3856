"""Where does a decode step's time go, and how often should the loop's host
read its stop flag? The greedy loop from its CUDA graph, profiled, and
timed with the host check every k steps for several k.

bf16 large-v3-turbo at full width (random weights from seed 0) at batch
1, a 30 s window of random features, 64 new tokens, word timestamps,
through ``WhisperEngine``; then the same model quantized as "S" (int8
decoder and cross K/V, W8A8 encoder), whose batch-1 step is one K3
launch. For each:

- the profile: ``torch.profiler`` (CUPTI) over four replays of the key's
  graph, the kernels summed by name: kernels a step, their summed device
  time a step and the largest six by share;
- the sweep: for each k the graph captured anew with k steps and the loop
  timed, the decode alone (after an eager prefill), host clock around
  ``torch.cuda.synchronize``, p50 of 5, in ms a step call. A check costs
  the host's synchronisation and the next replay's launch; a loop that
  stopped runs up to k - 1 steps more, which change nothing but take a
  step's time each. Random weights never emit EOT, so every run takes all
  its steps and the sweep measures the first cost.
  ``engine.decode.STEPS_PER_CHECK`` is the k the engine takes.

Prints the card's name and power limit and one JSON line.

    python -m thewhisper_tpu_torch.tools.decode_step_probe
    python -m thewhisper_tpu_torch.tools.decode_step_probe --ks 1,2,16
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import List, Optional

import numpy as np
import torch

from thewhisper_tpu_torch.config import ARCH_PRESETS, GenerationOptions
from thewhisper_tpu_torch.engine import WhisperEngine
from thewhisper_tpu_torch.engine.decode import STEPS_PER_CHECK
from thewhisper_tpu_torch.models.quant import quantize_params
from thewhisper_tpu_torch.models.whisper import init_params
from thewhisper_tpu_torch.tools import _card

MAX_NEW = 64
REPS = 5
PROFILED_REPLAYS = 4


def profile(prog) -> dict:
    """Kernels a step and their device time a step over
    ``PROFILED_REPLAYS`` replays of ``prog``'s graph (its loop's state as
    its last run left it: every step does a step's work and writes
    nothing), and the largest six kernels by device time."""
    n = PROFILED_REPLAYS * STEPS_PER_CHECK
    prog.graph.replay()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_REPLAYS):
            prog.graph.replay()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, getattr(e, "self_device_time_total", 0.0))
            for e in prof.key_averages()]
    rows = [r for r in rows if r[2] > 0]
    total = sum(r[2] for r in rows) / 1e3 / n
    top = sorted(rows, key=lambda r: -r[2])[:6]
    return {"kernels": sum(r[1] for r in rows) / n, "kernel_ms": total,
            "largest": [{"name": name[:60], "a_step": cnt // n,
                         "ms": t / 1e3 / n, "share": t / 1e3 / n / total}
                        for name, cnt, t in top]}


def loop_ms(engine: WhisperEngine, prog, k: int) -> float:
    """ms a step call of ``prog``, its graph captured anew with ``k``
    steps a host check (p50 of ``REPS`` runs)."""
    prompt = torch.tensor([engine.build_prompt("en")] * prog.key[0],
                          device=engine.device)
    times = []
    with torch.inference_mode():
        prog.graph = None
        prog.capture(k)
        for _ in range(REPS):
            prog.loop.start(prompt)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps = prog.loop.run(k, replay=prog.graph.replay)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / steps)
    return float(np.median(times))


def measure(model, ks: List[int], cross_kv_int8: bool) -> dict:
    engine = WhisperEngine(model, cross_kv_int8=cross_kv_int8)
    gen = torch.Generator(device=model.device).manual_seed(1)
    mel = torch.randn(1, model.arch.n_mels, 3000, generator=gen,
                      device=model.device)
    engine.transcribe_features(mel, GenerationOptions(
        language="en", max_new_tokens=MAX_NEW, return_timestamps=True))
    (prog,) = engine._programs.values()
    out = {"profile": profile(prog)}
    out["ms_by_k"] = {k: loop_ms(engine, prog, k) for k in ks}
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", default="1,2,3,4,8,16",
                    help="steps a host check, comma-separated")
    args = ap.parse_args(argv)
    ks = [int(k) for k in args.ks.split(",")]
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe measures the card")
    dev = _card.device("cuda")
    arch = dataclasses.replace(ARCH_PRESETS["large-v3-turbo"],
                               alignment_heads=((2, 4), (3, 3)))
    model = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                        dtype=torch.bfloat16, device=dev)
    out = {"card": _card.card(dev), "max_new_tokens": MAX_NEW}
    out["bf16"] = measure(model, ks, cross_kv_int8=False)
    quantize_params(model, components=("decoder",))
    quantize_params(model, components=("encoder",), activation_int8=True)
    out["S"] = measure(model, ks, cross_kv_int8=True)
    for route in ("bf16", "S"):
        prof = out[route]["profile"]
        print(f"{route}: {prof['kernels']:.0f} kernels a step, "
              f"{prof['kernel_ms']:.4f} ms of kernel time a step; largest: "
              + "; ".join(f"{r['name']} x{r['a_step']} {r['ms']:.4f} ms "
                          f"({r['share']:.0%})" for r in prof["largest"]),
              flush=True)
        print(f"{route}: ms a step call from the graph by steps a host check: "
              + ", ".join(f"k={k} {v:.4f}"
                          for k, v in out[route]["ms_by_k"].items())
              + f"; {out['card']}", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
