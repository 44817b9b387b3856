"""How much device memory do the engine's decode programs hold? Large-v3 at
full width (32 + 32 layers, random weights from seed 0) on 30 s windows of
random features, 128 new tokens, word timestamps: the programs a server
warms (``WhisperEngine.warmup``) for batch buckets 1 to 32.

A program (``engine/engine.py``) keeps, for its static shape, the self
cache, the cross K/V (computed into it a layer at a time), the tokens, the
alignment and the loop state, and on the card the CUDA graph of its steps
with the graph's private memory pool. For each bucket the probe prints the
bytes the program holds (``WhisperEngine.programs()``), the memory the
caching allocator holds after the call beyond what it held before (its
free blocks returned), and the most that live tensors reached during the
call beyond what they held before (the program, the encoder's
activations, one layer's cross K/V, the prefill); then the same at the largest bucket for an engine
without graphs, and the total held once every bucket is warm. First for
the bf16 model, then for the same model quantized in place as "S" (int8
decoder and cross K/V, W8A8 encoder). Then the proposal-token programs
(``warmup(proposals=True)``, the speculative programs a streaming server
with cross-tick reuse warms: a cache of W + 1 more slots and the
speculative loop's buffers) of that "S" model and of large-v3-turbo as
"S", each beside the greedy program of its bucket, for buckets 1 to 8.
Prints the card's name and power limit and one JSON line; sizes in bytes.

    python -m thewhisper_tpu_torch.tools.program_memory_probe
    python -m thewhisper_tpu_torch.tools.program_memory_probe --buckets 32
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
from typing import List, Optional, Sequence

import torch

from thewhisper_tpu_torch.config import ARCH_PRESETS
from thewhisper_tpu_torch.engine import WhisperEngine
from thewhisper_tpu_torch.models.quant import quantize_params
from thewhisper_tpu_torch.models.whisper import init_params
from thewhisper_tpu_torch.tools import _card

T_MEL = 3000
MAX_NEW = 128
# The buckets whose proposal-token programs the probe makes.
PROPOSAL_BUCKETS = (1, 2, 4, 8)


def reserved(dev) -> int:
    """What the caching allocator holds once its free blocks are returned:
    live tensors and the private pools of live CUDA graphs."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(dev)


def warm(engine: WhisperEngine, b: int) -> dict:
    """One warm-up call at bucket ``b``: what its program holds, what the
    allocator holds after it beyond before (``held``), and the most that
    live tensors reached during the call beyond before (``peak``)."""
    dev = engine.device
    before = reserved(dev)
    live = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    engine.warmup(T_MEL, (b,), MAX_NEW, timestamps=True)
    prog = [p for p in engine.programs() if p["key"][0] == b][-1]
    return {"program_bytes": prog["bytes"], "held_bytes": reserved(dev) - before,
            "peak_bytes": torch.cuda.max_memory_allocated(dev) - live,
            "seconds": prog["seconds"]}


def measure(model, buckets: List[int], cross_kv_int8: bool) -> dict:
    dev = model.device
    out = {}
    base = reserved(dev)
    engine = WhisperEngine(model, cross_kv_int8=cross_kv_int8)
    for b in buckets:
        out[b] = warm(engine, b)
    out["all_buckets_held_bytes"] = reserved(dev) - base
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    eager = WhisperEngine(model, cross_kv_int8=cross_kv_int8,
                          cuda_graphs=False)
    out[f"eager_{buckets[-1]}"] = warm(eager, buckets[-1])
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    return out


def proposals(model, buckets: Sequence[int] = PROPOSAL_BUCKETS) -> dict:
    """Each bucket's greedy and proposal-token programs of an "S" engine
    (int8 cross K/V), warmed together: their bytes, and what the
    allocator holds after both beyond before."""
    dev = model.device
    engine = WhisperEngine(model, cross_kv_int8=True)
    out = {}
    for b in buckets:
        before = reserved(dev)
        engine.warmup(T_MEL, (b,), MAX_NEW, timestamps=True, proposals=True)
        progs = {len(p["key"]): p for p in engine.programs() if p["key"][0] == b}
        out[b] = {"program_bytes": progs[6]["bytes"],
                  "proposals_bytes": progs[8]["bytes"],
                  "proposals_seconds": progs[8]["seconds"],
                  "held_bytes": reserved(dev) - before}
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--buckets", default="1,2,4,8,16,32",
                    help="batch buckets to warm, comma-separated, ascending")
    args = ap.parse_args(argv)
    buckets = [int(b) for b in args.buckets.split(",")]
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this probe measures the card")
    dev = _card.device("cuda")
    arch = dataclasses.replace(ARCH_PRESETS["large-v3"],
                               alignment_heads=((29, 4), (30, 11), (31, 3),
                                                (31, 17)))
    model = init_params(arch, torch.Generator(device=dev).manual_seed(0),
                        dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize(dev)
    out = {"card": _card.card(dev), "t_mel": T_MEL, "max_new_tokens": MAX_NEW,
           "weights_bytes": torch.cuda.memory_allocated(dev)}
    out["bf16"] = measure(model, buckets, cross_kv_int8=False)
    quantize_params(model, components=("decoder",))
    quantize_params(model, components=("encoder",), activation_int8=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["S"] = measure(model, buckets, cross_kv_int8=True)
    out["S proposals"] = proposals(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    turbo = init_params(dataclasses.replace(ARCH_PRESETS["large-v3-turbo"],
                                            alignment_heads=((2, 4), (3, 11))),
                        torch.Generator(device=dev).manual_seed(0),
                        dtype=torch.bfloat16, device=dev)
    quantize_params(turbo, components=("decoder",))
    quantize_params(turbo, components=("encoder",), activation_int8=True)
    out["turbo S proposals"] = proposals(turbo)
    gib = 2 ** 30
    for mode in ("bf16", "S"):
        m = out[mode]
        for b, r in m.items():
            if isinstance(r, dict):
                print(f"{mode} bucket {b}: program {r['program_bytes'] / gib:.3f}"
                      f" GiB, held after the call {r['held_bytes'] / gib:.3f}"
                      f" GiB, peak during it {r['peak_bytes'] / gib:.3f} GiB, "
                      f"made in {r['seconds']:.3f} s", flush=True)
        print(f"{mode}: every bucket warm holds "
              f"{m['all_buckets_held_bytes'] / gib:.3f} GiB beside the "
              f"weights; {out['card']}", flush=True)
    for mode in ("S proposals", "turbo S proposals"):
        for b, r in out[mode].items():
            print(f"{mode} bucket {b}: greedy program "
                  f"{r['program_bytes'] / gib:.3f} GiB, proposals program "
                  f"{r['proposals_bytes'] / gib:.3f} GiB (made in "
                  f"{r['proposals_seconds']:.3f} s), both held "
                  f"{r['held_bytes'] / gib:.3f} GiB; {out['card']}", flush=True)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
