"""The general traffic generator: a mix is a JSON file of parameters, and
this module turns it and the run's seed into inputs.

Every seed gets the same sizes. The lengths of a mix are fixed by it, or
drawn once from its own ``length_seed``; the run's seed only orders a
call's clips and voices the audio, so two seeds give the same work.

``synth_audio`` is ``chip_smoke.py::synth_audio`` at commit ``ac90407``
(amplitude-modulated harmonics of a gliding pitch plus noise), drawn on the
device from a generator: its phase is the pitch's integral in closed form
(float64), where the original sums it sample by sample.
``speech_and_silence`` is ``chip_smoke.py::speech_and_silence`` at the same
commit: speech alternating with near-silence, 5 s each there, both
lengths parameters here (no mix uses it yet: it is the live sessions'
audio).

The mixes voice their requests with ``babble``, not ``synth_audio``: each
quarter second has its own pitch, harmonic weights and level, or is a
pause, so that no two windows sound alike. ``synth_audio``'s one gliding
tone is the same in every 30 s window, and a model that cannot tell two
windows apart cannot show that a window was given another's audio.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

SAMPLE_RATE = 16000
HOP = 160


def synth_audio(lengths: List[int], gen: torch.Generator, device) -> torch.Tensor:
    """Voiced-speech-like signals of ``lengths`` samples each, one after
    another in one float32 tensor on ``device``, in [-1, 1]."""
    n = int(sum(lengths))
    starts = np.repeat(np.cumsum([0] + list(lengths[:-1])), lengths)
    t = (torch.arange(n, device=device, dtype=torch.float64)
         - torch.from_numpy(starts).to(device)) / SAMPLE_RATE
    k = 2 * math.pi * 0.3
    # f0 = 120 + 30 sin(k t); phase = 2 pi * integral of f0 from 0 to t.
    phase = 2 * math.pi * (120 * t + 30 / k * (1 - torch.cos(k * t)))
    voiced = sum(torch.sin(h * phase) / h for h in range(1, 8))
    u = torch.rand(len(lengths), generator=gen, device=device,
                   dtype=torch.float64) * 6
    offset = torch.repeat_interleave(u, torch.tensor(lengths, device=device))
    envelope = 0.5 * (1 + torch.sin(2 * math.pi * 3.0 * t + offset))
    noise = torch.randn(n, generator=gen, device=device, dtype=torch.float64)
    x = 0.2 * envelope * voiced + 0.02 * noise
    return x.clamp(-1, 1).float()


def babble(lengths: List[int], gen: torch.Generator, device,
           segment_s: float = 0.25, pause_share: float = 0.2) -> torch.Tensor:
    """Speech-like babble of ``lengths`` samples each, one after another
    in one float32 tensor on ``device``, in [-1, 1]: segments of
    ``segment_s``, each voiced at its own pitch (90-220 Hz) with its own
    weights of 7 harmonics and level, or (``pause_share`` of them) a
    pause; noise beneath."""
    n = int(sum(lengths))
    seg = int(segment_s * SAMPLE_RATE)
    k = -(-n // seg)
    f64 = dict(generator=gen, device=device, dtype=torch.float64)
    f0 = 90 + 130 * torch.rand(k, **f64)
    level = 0.05 + 0.25 * torch.rand(k, **f64)
    level = torch.where(torch.rand(k, **f64) < pause_share, 0.0, level)
    weights = torch.rand(k, 7, **f64)
    at = lambda v: torch.repeat_interleave(v, seg)[:n]
    phase = 2 * math.pi * torch.cumsum(at(f0), 0) / SAMPLE_RATE
    x = torch.zeros(n, device=device, dtype=torch.float64)
    for h in range(1, 8):
        x += at(weights[:, h - 1]) * torch.sin(h * phase) / h
    x = at(level) * x + 0.01 * torch.randn(n, **f64)
    return x.clamp(-1, 1).float()


def speech_and_silence(seconds: int, gen: torch.Generator, device,
                       speech_s: int = 5, silence_s: int = 5,
                       voice=synth_audio) -> torch.Tensor:
    """``seconds`` (a multiple of ``speech_s + silence_s``) of
    ``speech_s`` of ``voice`` speech alternating with ``silence_s`` of
    near-silence, float32 on ``device``."""
    period = speech_s + silence_s
    n = seconds // period
    speech = voice([speech_s * SAMPLE_RATE] * n, gen, device).view(n, -1)
    quiet = 0.0005 * torch.randn(n, silence_s * SAMPLE_RATE, generator=gen,
                                 device=device)
    return torch.cat([speech, quiet], dim=1).reshape(-1)


def fixed_lengths_s(mix: Dict, count: int) -> np.ndarray:
    """``count`` lengths in seconds, on whole hops: each ``length_s``
    where the mix gives one length; else drawn from the mix's own
    ``length_seed``, lognormal with ``length_sigma``, scaled so that
    their mean is ``length_mean_s``, clipped to [``length_min_s``,
    ``length_max_s``]."""
    if "length_s" in mix:
        s = np.full(count, float(mix["length_s"]))
    else:
        rng = np.random.default_rng(int(mix["length_seed"]))
        s = rng.lognormal(0.0, float(mix["length_sigma"]), size=count)
        s = np.clip(s * float(mix["length_mean_s"]) / s.mean(),
                    float(mix["length_min_s"]), float(mix["length_max_s"]))
    return np.round(s * SAMPLE_RATE / HOP) * HOP / SAMPLE_RATE


@dataclasses.dataclass
class Request:
    """One input: its audio on the host and its length in seconds."""

    audio: np.ndarray
    seconds: float


def make_requests(mix: Dict, seed: int, device) -> List[List[Request]]:
    """The mix's pool for ``seed``: a list of calls, each a list of
    requests (``clips``: ``pool_calls`` calls of ``batch`` clips, every
    call the same multiset of lengths in its own order; ``longform``: one
    file a call, ``files`` of them, each its own audio). Made on the
    device, copied to the host once."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    order = np.random.default_rng(int(seed))
    kind = mix["kind"]
    if kind == "clips":
        base = fixed_lengths_s(mix, int(mix["batch"]))
        calls = [order.permutation(base) for _ in range(int(mix["pool_calls"]))]
    elif kind == "longform":
        calls = [[s] for s in fixed_lengths_s(mix, int(mix["files"]))]
    else:
        raise ValueError(f"no generator for traffic kind {kind!r}")
    lengths = [int(round(s * SAMPLE_RATE)) for c in calls for s in c]
    host = babble(lengths, gen, device).cpu().numpy()
    out, at = [], 0
    for c in calls:
        reqs = []
        for s in c:
            n = int(round(s * SAMPLE_RATE))
            reqs.append(Request(host[at: at + n], n / SAMPLE_RATE))
            at += n
        out.append(reqs)
    return out
