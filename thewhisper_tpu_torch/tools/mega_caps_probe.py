"""What does writing one (1, D) row of a slot-major KV cache cost, against
torch's own in-place write and a full rewrite? (The port's counterpart of
thewhisper_tpu's ``tools/mega_caps_probe.py``.)

The TPU probe found Mosaic could not write one row at a dynamic slot and
measured two fallbacks; on the card the question is only what a launch of
P4 (``ops/cache_write.py::write_row``) costs. Arms, each timed per write with
CUDA events, with the card's name and power limit:

- ``write_row``: P4 into a (448, 1280) bf16 cache, the slot moving each
  write; ``write_row_big``: P4 into the (32 x 448, 1280) cache (36.7 MB) of
  32 layers; ``loop16``: 16 P4 writes into slots 0..15 of the small cache,
  write i reading its slot from element i of a device int32 tensor, as the
  TPU probe's ``fori_loop`` passes its device index (so the graph replay
  reads the slots from the device too).
- ``torch_row``: ``cache[:, pos] = rows``, one row in each of the 32
  layers of the (32, 448, 1280) cache (the TPU probe's XLA fallback A).
- ``torch_where``: the full ``torch.where(iota == pos, rows, cache)``
  rewrite of that cache, the yardstick.

Each arm is timed eager (``us_per_call``: the host's launch cost included,
which for a write this small is most of it) and replayed from a CUDA graph
(``graph_us_per_call``: the card's own time). It checks the TPU probe's two
results first: one write lands in its row and leaves every other row zero,
and so do 16 writes in a loop at device slots. Prints one JSON line. ``--device cpu`` runs the checks alone with the plain version, on a
(16, 128) cache.

    python -m thewhisper_tpu_torch.tools.mega_caps_probe
    python -m thewhisper_tpu_torch.tools.mega_caps_probe --device cpu
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import torch

from thewhisper_tpu_torch.ops import cache_write as cw
from thewhisper_tpu_torch.tools import _card

SIZE = (32, 448, 1280)     # layers, slots, d_model
CPU_SIZE = (2, 16, 128)
ITERS = 64                 # calls timed an arm


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the checks alone, small size")
    args = ap.parse_args(argv)
    dev = _card.device(args.device)
    n_layers, s, d = CPU_SIZE if dev.type == "cpu" else SIZE
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    row = rand(1, d)
    got = cw.write_row(torch.zeros(s, d, dtype=torch.bfloat16, device=dev), 13, row)
    others = torch.cat([got[:13], got[14:]])
    one_ok = bool(torch.equal(got[13], row[0]) and not others.any())
    rows = rand(16, d)
    # Slot i of the loop is element i of a device tensor, one view a write.
    index = torch.arange(16, dtype=torch.int32, device=dev).split(1)
    got = torch.zeros(s, d, dtype=torch.bfloat16, device=dev)
    for i in range(16):
        cw.write_row(got, index[i], rows[i])
    loop_ok = bool(torch.equal(got[:16], rows) and not got[16:].any())
    if not (one_ok and loop_ok):
        raise RuntimeError(f"mega_caps_probe: row write {one_ok}, loop of 16 "
                           f"{loop_ok}")
    result = {"probe": "mega_caps", "device": str(dev), "card": _card.card(dev),
              "layers": n_layers, "slots": s, "d_model": d,
              "row_write_ok": one_ok, "loop16_ok": loop_ok}

    if dev.type == "cuda":
        small = torch.zeros(s, d, dtype=torch.bfloat16, device=dev)
        big = torch.zeros(n_layers * s, d, dtype=torch.bfloat16, device=dev)
        cache3 = big.view(n_layers, s, d)
        big_rows = rand(n_layers, d)
        slot = torch.arange(s, device=dev)[None, :, None]
        step = {"i": 0}

        def next_pos(limit):
            step["i"] += 1
            return step["i"] % limit

        def loop16():
            for i in range(16):
                cw.write_row(small, index[i], rows[i])

        def torch_row():
            cache3[:, next_pos(s)] = big_rows

        def torch_where():
            return torch.where(slot == next_pos(s), big_rows[:, None], cache3)

        arms = {"write_row": lambda: cw.write_row(small, next_pos(s), row),
                "write_row_big": lambda: cw.write_row(big, next_pos(n_layers * s), row),
                "loop16": loop16, "torch_row": torch_row, "torch_where": torch_where}
        result["us_per_call"] = {k: _card.cuda_ms(fn, ITERS) * 1e3
                                 for k, fn in arms.items()}
        result["graph_us_per_call"] = {k: _card.graph_ms(fn) * 1e3
                                       for k, fn in arms.items()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
