"""Where does a one-rank NCCL mesh's call lose time against the unsharded
engine's? bf16 large-v3-turbo at full width (random weights and biases
from seed 0), one 30 s row of noise, 64 new tokens, word timestamps,
through ``WhisperEngine`` and then through the same model sharded over a
dp 1 x tp 1 mesh (``parallel``), whose row-parallel linears and alignment
all-reduce over NCCL: eagerly in the encoder, captured in the decode
loop's CUDA graph. For each engine:

- the call's wall (host clock, three calls after a warm one);
- the encoder alone on the call's features (CUDA events, five runs);
- one replay of the decode loop's graph (CUDA events, twenty replays);
- a ``utils.profiling.trace`` of one call: its kernels' launches and
  summed device time, and the largest ten by time.

The rank is a child process (``parallel.launch.spawn``, NCCL, world
size 1). Card only. Prints the card's name and power limit and one JSON
line.

    python -m thewhisper_tpu_torch.tools.mesh_probe
"""

from __future__ import annotations

import json
import tempfile
import time
from typing import List, Optional

MAX_NEW = 64
WALLS = 3


def _measure(engine, model, audio, mel, opts) -> dict:
    import torch

    from thewhisper_tpu_torch.models.whisper import encoder_forward
    from thewhisper_tpu_torch.tools import _card
    from thewhisper_tpu_torch.utils import profiling

    engine.transcribe_audio(audio, opts)
    walls = []
    for _ in range(WALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.transcribe_audio(audio, opts)
        walls.append((time.perf_counter() - t0) * 1e3)
    with torch.inference_mode():
        encoder_ms = _card.cuda_ms(lambda: encoder_forward(model, mel), 5)
    prog = next(iter(engine._programs.values()))
    replay_ms = _card.cuda_ms(prog.graph.replay, 20)
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d):
            engine.transcribe_audio(audio, opts)
            torch.cuda.synchronize()
        kernels = profiling.kernel_times(profiling.trace_events(d))
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {"wall_ms": walls, "encoder_ms": encoder_ms,
            "replay_ms": replay_ms, "steps_per_replay": prog.per_check,
            "kernels": sum(n for n, _ in kernels.values()),
            "kernel_ms": sum(us for _, us in kernels.values()) / 1e3,
            "top": [(name[:80], n, round(us / 1e3, 4))
                    for name, (n, us) in top]}


def child(seed: int = 0, max_new: int = MAX_NEW) -> dict:
    """The one rank: both engines measured in turn on the same model."""
    import torch

    from thewhisper_tpu_torch.audio.features import (
        hann_window,
        log_mel_spectrogram,
        mel_filter_bank,
    )
    from thewhisper_tpu_torch.config import GenerationOptions
    from thewhisper_tpu_torch.engine.engine import WhisperEngine
    from thewhisper_tpu_torch.parallel import dryrun
    from thewhisper_tpu_torch.parallel.mesh import make_mesh, shard_params

    dev = torch.device("cuda", torch.cuda.current_device())
    arch = dryrun.CARD_ARCH
    model = dryrun.card_model(arch, torch.bfloat16, seed, dev)
    audio = dryrun.card_audio(1, 30, seed + 1)
    opts = GenerationOptions(max_new_tokens=max_new, language="en",
                             return_timestamps=True)
    mel = log_mel_spectrogram(
        torch.from_numpy(audio).to(dev),
        torch.from_numpy(mel_filter_bank(num_mel_filters=arch.n_mels)).to(dev),
        torch.from_numpy(hann_window()).to(dev))
    out = {"unsharded": _measure(WhisperEngine(model), model, audio, mel,
                                 opts)}
    mesh = make_mesh(dp=1, tp=1, arch=arch, device=dev)
    engine = WhisperEngine(shard_params(model, mesh), mesh=mesh)
    try:
        out["meshed"] = _measure(engine, model, audio, mel, opts)
    finally:
        engine.close()
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    import argparse

    import torch

    from thewhisper_tpu_torch.parallel.launch import spawn
    from thewhisper_tpu_torch.tools import _card, mesh_probe

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-new", type=int, default=MAX_NEW)
    args = ap.parse_args(argv)
    dev = _card.device("cuda")
    smi = _card.card(dev)
    (out,) = spawn(mesh_probe.child, 1, 0, args.max_new, backend="nccl",
                   device="cuda", timeout_s=600)
    out["card"] = smi
    out["torch"] = torch.__version__
    print(smi)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
