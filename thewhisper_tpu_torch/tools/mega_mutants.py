"""Do the card checks of K3 and K4 see a fault in their engine? A mutation
check: each mutant is a copy of the package with one deliberate fault in
``csrc/mega_common.cuh``, built and put through the card tests of K3 and K4
(``tests/test_torch_kernels.py -k mega``, the default) or through
``chip_smoke.py``'s [K3] and [K4] phases at large-v3 width (``--check
smoke``: the "S" model and pipeline, then both phases); every mutant must
fail them and the unchanged copy must pass.

The copies go to ``thewhisper_tpu_torch/build/mutants/`` (git-ignored), one
directory a mutant, each with its own kernel build. Prints one JSON line:
the card's name and power limit and, for each copy, whether the tests
failed and the first failing test. Needs a card and takes a few minutes:

    python -m thewhisper_tpu_torch.tools.mega_mutants
    python -m thewhisper_tpu_torch.tools.mega_mutants --only parity,causal
    python -m thewhisper_tpu_torch.tools.mega_mutants --check smoke
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import List, Optional

from thewhisper_tpu_torch.tools import _card

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = ROOT / "thewhisper_tpu_torch"
SOURCE = "csrc/mega_common.cuh"
WORK = PACKAGE / "build" / "mutants"

# (name, what the fault is, the text replaced, its replacement): each text
# occurs once in the source.
MUTANTS = (
    ("rescale", "the combine does not rescale a chunk's partial by e^(m_c - M)",
     "const float e = expf(m[i] - bm);", "const float e = 1.0f;"),
    ("chunk-edge", "a cross-attention item drops the last row of its chunk",
     "const int t0 = c * p.cc, nt = min(p.cc, p.T - t0);",
     "const int t0 = c * p.cc, nt = min(p.cc, p.T - t0) - 1;"),
    ("parity", "a ring stage is read at the wrong mbarrier phase parity",
     "parity = (r.it / r.stages) & 1;", "parity = ((r.it / r.stages) + 1) & 1;"),
    ("row-shift", "block 1 writes its product rows one row down",
     "const int er = m0 + (threadIdx.x & 15), en",
     "const int er = m0 + (threadIdx.x & 15) + (blockIdx.x == 1), en"),
    ("align-sum", "the alignment is normalised by one chunk's own sum",
     "const float inv = 1.0f / Z;",
     "const float inv = 1.0f / __ldcg(part + static_cast<size_t>(h) * chunks * kPart + 1);"),
    ("causal", "window row w also sees slot pos + w + 1",
     "if (s <= pos + w) {", "if (s <= pos + w + 1) {"),
    ("unpack", "the int8 unpacking is 128 off for one byte of four",
     "0x7650)) - 8388736.0f;\n  const float f1", "0x7650)) - 8388608.0f;\n  const float f1"),
    ("fragment", "the A fragment's middle registers are swapped",
     "mma_bf16(c[jj & 1][nt], a0, a1, a2, a3,", "mma_bf16(c[jj & 1][nt], a0, a2, a1, a3,"),
    ("cache-slot", "every window row's k and v land in slot pos",
     "p.S + p.pos + n) * kDh", "p.S + p.pos) * kDh"),
    ("residual-round", "the residual adds y unrounded",
     "__float2bfloat16(xr + round_bf16(y))", "__float2bfloat16(xr + y)"),
)


def make_copy(name: str, old: Optional[str], new: Optional[str]) -> Path:
    """A copy of the package (without its builds) and the tests under
    WORK/name, with ``old`` replaced by ``new`` in SOURCE."""
    dst = WORK / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(PACKAGE, dst / PACKAGE.name,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copytree(ROOT / "tests", dst / "tests",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    if old is not None:
        src = dst / PACKAGE.name / SOURCE
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"mutant {name}: its text occurs {text.count(old)} "
                               f"times in {SOURCE}")
        src.write_text(text.replace(old, new))
    return dst


# chip_smoke.py's [K3] and [K4] phases and what they need, run in a copy.
SMOKE = ("import chip_smoke as c; c.phase_device(); c.phase_build(); "
         "model, enc, _ = c.phase_s_path(); c.phase_mega(model, enc); "
         "c.phase_verify(model, enc)")


def run_tests(copy: Path, timeout: int, check: str = "tests") -> dict:
    """The card tests of K3 and K4 (or the smoke run's [K3] and [K4]
    phases) on the copy's package (and the repo's other packages); a launch
    that traps or hangs counts as a failure."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    cmd = ([sys.executable, "-c", SMOKE] if check == "smoke" else
           [sys.executable, "-m", "pytest", "tests/test_torch_kernels.py",
            "--noconftest", "-q", "-x", "-k", "mega", "-p", "no:cacheprovider"])
    try:
        out = subprocess.run(cmd, cwd=copy, env=env, capture_output=True,
                             text=True, timeout=timeout)
        code, text = out.returncode, out.stdout + out.stderr
    except subprocess.TimeoutExpired:
        code, text = -1, "timeout"
    first = (re.search(r"FAILED (\S+)", text) or re.search(r"ERROR (\S+)", text)
             or re.search(r"Error: (chip_smoke: check failed: [^\n]*)", text)
             or re.search(r"(\w+Error: [^\n]*)", text))
    return {"failed": code != 0,
            "first_failure": first.group(1)[:160] if first else
            (text.strip().splitlines()[-1][:160] if code != 0 and text.strip() else None)}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="",
                    help="comma-separated mutant names (default: all)")
    ap.add_argument("--check", choices=("tests", "smoke"), default="tests",
                    help="the card tests, or chip_smoke.py's [K3] and [K4]")
    ap.add_argument("--timeout", type=int, default=300,
                    help="seconds for one copy's build and tests")
    args = ap.parse_args(argv)
    dev = _card.device("cuda")
    only = {n for n in args.only.split(",") if n}
    runs = [("unchanged", "no fault", None, None)] + [
        m for m in MUTANTS if not only or m[0] in only]
    results = []
    for name, what, old, new in runs:
        res = run_tests(make_copy(name, old, new), args.timeout, args.check)
        results.append({"name": name, "fault": what, **res})
        print(f"[mutants] {name}: {'failed' if res['failed'] else 'passed'}"
              f" ({res['first_failure']})", file=sys.stderr, flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"tool": "mega_mutants", "card": _card.card(dev),
                      "source": f"thewhisper_tpu_torch/{SOURCE}", "check": args.check,
                      "control_passed": not results[0]["failed"],
                      "mutants_failed": sum(r["failed"] for r in results[1:]),
                      "mutants": len(results) - 1, "runs": results}))


if __name__ == "__main__":
    main()
