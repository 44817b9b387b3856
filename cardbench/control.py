#!/usr/bin/env python3
"""The readings a cell's limits are set from, in one process: for each
seed a run of the cell (a short window at the cell's own load), the
program's readings against the reference (``gap``, ``logprob`` and
``best``, ``harness/check.py``), and the control's: the same read of the
reference at the precision below the configuration's (float8 e4m3 for
bfloat16, int4 for int8) in the program's place, at each position of the
same prompts and served tokens.

    python3 cardbench/control.py --workload turbo-s.clips-bs64 \\
        --seconds 3 --seeds 11 12 13

The benchmark's own runs do not take the control. Prints one JSON line a
seed, then the largest program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import run  # noqa: E402

NUMBERS = ("gap", "logprob", "best")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    program = []
    for seed in args.seeds:
        out = run.run(args.workload, seed, args.seconds, trace=False,
                      control=True)
        r = out["readings"]
        program.append(r)
        print(json.dumps({"seed": seed, **r}), flush=True)
    print(json.dumps({
        "workload": args.workload,
        "program_max": {k: max(r[k] for r in program) for k in NUMBERS},
        "control_min": {k: min(r["control_" + k] for r in program)
                        for k in NUMBERS}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
