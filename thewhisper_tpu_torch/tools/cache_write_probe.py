"""What does writing one slot of a feature-major self-KV cache cost, against
torch's ways of writing it? (The port's counterpart of thewhisper_tpu's
``tools/cache_write_probe.py``.)

The cache is the batch-32 decode step's self-KV, (L B, H DH, T) bf16 at
L = 4, B = 32, H = 20, DH = 64, T = 228 (74.7 MB); a write sets column
``pos`` from an (L B, H DH, 1) column, the slot moving each write. Arms,
each timed per write with CUDA events, with the card's name and power limit:

- ``kernel``: P5 (``ops/cache_write.py::write_column``), in place, the
  slot a one-element int32 tensor on the card, as ``pallas_write`` takes
  it (so the graph replay reads it from the device);
- ``where``: ``torch.where(iota == pos, col, cache)``, the full rewrite the
  TPU engine made;
- ``index_copy``: ``cache.index_copy_(2, pos, col)``, in place;
- ``slice``: ``cache[:, :, pos] = col[:, :, 0]``, in place.

Each arm is timed eager (``us_per_write``: the host's launch cost included)
and replayed from a CUDA graph (``graph_us_per_write``: the card's own
time). It checks first that a write lands in its column and nowhere else (the TPU
probe's own assertion). Prints one JSON line. ``--device cpu`` runs the
check alone with the plain version, on a (2, 16, 16) cache.

    python -m thewhisper_tpu_torch.tools.cache_write_probe
    python -m thewhisper_tpu_torch.tools.cache_write_probe --device cpu
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import torch

from thewhisper_tpu_torch.ops import cache_write as cw
from thewhisper_tpu_torch.tools import _card

L, B, H, DH, T = 4, 32, 20, 64, 228
CPU_SHAPE = (2, 16, 16)
ITERS = 50                 # writes timed an arm


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the check alone, small size")
    args = ap.parse_args(argv)
    dev = _card.device(args.device)
    r, f, t = CPU_SHAPE if dev.type == "cpu" else (L * B, H * DH, T)
    gen = torch.Generator(device=dev).manual_seed(0)
    cache = torch.randn(r, f, t, generator=gen, device=dev).to(torch.bfloat16)
    col = torch.randn(r, f, 1, generator=gen, device=dev).to(torch.bfloat16)

    got = cw.write_column(cache.clone(), col, 7)
    ref = cache.clone()
    ref[:, :, 7] = col[:, :, 0]
    ok = bool(torch.equal(got, ref))
    if not ok:
        raise RuntimeError("cache_write_probe: the column write missed")
    result = {"probe": "cache_write", "device": str(dev), "card": _card.card(dev),
              "shape": [r, f, t], "mbytes": cache.numel() * 2 / 1e6,
              "write_ok": ok}

    if dev.type == "cuda":
        iota = torch.arange(t, device=dev)[None, None, :]
        slots = 4 + torch.arange(128, device=dev)      # index_copy_'s, on the card
        slots32 = slots.int().split(1)                 # the kernel's
        step = {"i": 0}

        def next_pos():
            step["i"] += 1
            return 4 + step["i"] % 128

        def index_copy():
            i = next_pos() - 4
            cache.index_copy_(2, slots[i:i + 1], col)

        def slice_write():
            cache[:, :, next_pos()] = col[:, :, 0]

        arms = {"kernel": lambda: cw.write_column(cache, col, slots32[next_pos() - 4]),
                "where": lambda: torch.where(iota == next_pos(), col, cache),
                "index_copy": index_copy, "slice": slice_write}
        result["us_per_write"] = {k: _card.cuda_ms(fn, ITERS) * 1e3
                                  for k, fn in arms.items()}
        result["graph_us_per_write"] = {k: _card.graph_ms(fn) * 1e3
                                        for k, fn in arms.items()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
