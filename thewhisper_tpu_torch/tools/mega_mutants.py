"""Do the card checks of a kernel see a fault in it? A mutation check: each
mutant is a copy of the package with one deliberate fault in one kernel
source, built and put through that kernel's card tests
(``tests/test_torch_kernels.py -k <its selection>``, the default) or through
its ``chip_smoke.py`` phases (``--check smoke``); every mutant must fail
them and the unchanged copy must pass the tests of every kernel chosen.

Kernels (``--kernel``): ``mega``, the K3/K4 engine in
``csrc/mega_common.cuh`` (tests ``-k mega``; smoke: the "S" model and
pipeline at large-v3 width, then [K3] and [K4]); ``control``, P1's
tensor-core route in ``csrc/attention_control.cu`` (tests ``-k
attention_control``; smoke: [P1]); ``mlp``, P2/P3 in
``csrc/mlp_chain.cu`` (tests ``-k mlp_chain``; smoke: [P2]/[P3]), three of
whose mutants change the engine's product and epilogues in
``csrc/mega_common.cuh``, which P2/P3 run; and ``cache``, P4/P5 in
``csrc/cache_write.cu`` (tests ``-k "write_row or write_column"``; smoke:
[P4]/[P5]); and ``attn_bwd``, K2-dkv and K2-dq in
``csrc/encoder_attention_bwd.cu`` and K2's lse store in
``csrc/encoder_attention.cu`` (tests ``-k "attention_backward or
autograd_on_the_card"``; smoke: [TRAIN]'s kernel checks).

The copies go to ``thewhisper_tpu_torch/build/mutants/`` (git-ignored), one
directory a mutant, each with its own kernel build. Prints one JSON line:
the card's name and power limit and, for each copy, whether the tests
failed and the first failing test. Needs a card; the ten K3/K4 mutants take
about 5 minutes (15 with ``--check smoke``), the six P1 mutants about 2,
the seven P2/P3 mutants about 2, the five P4/P5 mutants about 5, the
eight K2 backward mutants about 3:

    python -m thewhisper_tpu_torch.tools.mega_mutants
    python -m thewhisper_tpu_torch.tools.mega_mutants --kernel control
    python -m thewhisper_tpu_torch.tools.mega_mutants --kernel mlp
    python -m thewhisper_tpu_torch.tools.mega_mutants --kernel cache
    python -m thewhisper_tpu_torch.tools.mega_mutants --kernel attn_bwd
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
WORK = PACKAGE / "build" / "mutants"

# chip_smoke.py's phases of each kernel and what they need, run in a copy.
SMOKE_MEGA = ("import chip_smoke as c; c.phase_device(); c.phase_build(); "
              "model, enc, _ = c.phase_s_path(); c.phase_mega(model, enc); "
              "c.phase_verify(model, enc)")
SMOKE_CONTROL = ("import chip_smoke as c; smi = c.phase_device(); c.phase_build(); "
                 "c.phase_control(smi)")
SMOKE_MLP = ("import chip_smoke as c; smi = c.phase_device(); c.phase_build(); "
             "c.phase_mlp(smi)")
SMOKE_CACHE = ("import chip_smoke as c; smi = c.phase_device(); c.phase_build(); "
               "c.phase_cache_writes(smi)")
SMOKE_ATTN_BWD = ("import chip_smoke as c; smi = c.phase_device(); c.phase_build(); "
                  "c.phase_attention_backward(smi)")
# kernel -> (its source, the -k selection of its card tests, its smoke run).
KERNELS = {
    "mega": ("csrc/mega_common.cuh", "mega", SMOKE_MEGA),
    "control": ("csrc/attention_control.cu", "attention_control", SMOKE_CONTROL),
    "mlp": ("csrc/mlp_chain.cu", "mlp_chain", SMOKE_MLP),
    "cache": ("csrc/cache_write.cu", "write_row or write_column", SMOKE_CACHE),
    "attn_bwd": ("csrc/encoder_attention_bwd.cu",
                 "attention_backward or autograd_on_the_card", SMOKE_ATTN_BWD),
}

# The K3/K4 engine's mutants: (name, what the fault is, the text replaced,
# its replacement); each text occurs once in the source.
MEGA_MUTANTS = (
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

# P1's tensor-core route.
CONTROL_MUTANTS = (
    ("m-reset", "m restarts from -1e9 at each 512-key tile",
     "mn[i] = fmaxf(m[i], tmax[i]);", "mn[i] = fmaxf(-1e9f, tmax[i]);"),
    ("max-128", "the tile's max is taken over its last 128 keys, not all 512",
     "row_max(s, tmax);", "tmax[0] = tmax[1] = -INFINITY;\n    row_max(s, tmax);"),
    ("l-round", "l sums p rounded to bf16",
     "l[(j >> 1) & 1] += s[j];",
     "l[(j >> 1) & 1] += __bfloat162float(__float2bfloat16(s[j]));"),
    ("p-trunc", "p goes to the P V product truncated to bf16, not rounded to nearest",
     "  to_bf16(s, p);\n",
     "  for (int e = 0; e < 64; e += 2)\n"
     "    p[e / 8][(e / 2) % 4] = (__float_as_uint(s[e]) >> 16) |\n"
     "                            (__float_as_uint(s[e + 1]) & 0xFFFF0000u);\n"),
    ("k-stage", "pass B reads each score product's K from the next stage",
     "const uint32_t kb = sm.k(i0);", "const uint32_t kb = sm.k(i0 + 1);"),
    ("row-down", "consumer 2 writes its rows one row down",
     "const int row = q0 + wg * 64 + r0 + 8 * i;",
     "const int row = q0 + wg * 64 + r0 + 8 * i + (wg == 2);"),
)

# P2/P3: (name, fault, old, new) in csrc/mlp_chain.cu, or (name, fault,
# old, new, source) elsewhere.
MLP_MUTANTS = (
    ("ln-layer0", "layer 0's LayerNorm parameters serve every layer",
     "ln_rows(p, c.ln_s + l * D, c.ln_b + l * D, act, stats, wred);",
     "ln_rows(p, c.ln_s, c.ln_b, act, stats, wred);"),
    ("gelu-round", "GELU's input is not rounded to bf16",
     "__float2bfloat16(gelu_tanh(round_bf16(y)))", "__float2bfloat16(gelu_tanh(y))",
     "csrc/mega_common.cuh"),
    ("no-barrier", "fc2 reads h without the grid barrier after fc1",
     "    grid_barrier(p, target, k, ring.clock);\n    load_rows(", "    load_rows("),
    ("residual-base", "fc2's residual adds y to h, its input row, instead of x",
     "{c.s2 + l * D, c.b2 + l * D, nullptr, p.x}",
     "{c.s2 + l * D, c.b2 + l * D, nullptr, p.hid}"),
    ("row-shift-mlp", "block 1 writes its product rows one row down",
     "const int er = m0 + (threadIdx.x & 15), en",
     "const int er = m0 + (threadIdx.x & 15) + (blockIdx.x == 1), en",
     "csrc/mega_common.cuh"),
    ("producer-short", "the producer skips each fc2 tile's last stage (the ring "
     "never fills: the launch must trap, not hang)",
     "pr.tiles(c.w2t + l * df, D, F);", "pr.tiles(c.w2t + l * df, D, F - kKc);"),
    ("residual-round-mlp", "the residual adds y unrounded",
     "__float2bfloat16(xr + round_bf16(y))", "__float2bfloat16(xr + y)",
     "csrc/mega_common.cuh"),
)


# P4/P5 (the relay test must see the row kernel reading before its wait;
# the trap test, a device slot outside the cache written).
CACHE_MUTANTS = (
    ("no-wait", "the row kernel reads its row and slot without griddepcontrol.wait",
     "  pdl_trigger();\n  pdl_wait();\n  // The row's load first",
     "  pdl_trigger();\n  // The row's load first"),
    ("last-chunk", "the row's last 16-byte chunk is not stored",
     "  dst[c] = v;", "  if (c + 1 < blockDim.x) dst[c] = v;"),
    ("slot-zero", "a device slot is ignored in favour of slot 0",
     "const int s = slot != nullptr ? *slot : pos;",
     "const int s = slot != nullptr ? 0 : pos;"),
    ("stride", "P5 steps T - 1 elements from one column value to the next",
     "const int stride = t;", "const int stride = t - 1;"),
    ("no-guard", "a slot outside the cache is not trapped",
     "  if (s < 0 || s >= limit) __trap();\n", ""),
)


# K2-dkv and K2-dq, and K2's lse store (in csrc/encoder_attention.cu).
ATTN_BWD_MUTANTS = (
    ("dv-scale", "dV is stored halved",
     "store_half(dv + out, dvr, 1.0f, half);", "store_half(dv + out, dvr, 0.5f, half);"),
    ("dq-ragged", "dQ skips the last, ragged key tile",
     "for (int t0 = 0; t0 < valid_len; t0 += kTile) {",
     "for (int t0 = 0; t0 + kTile <= valid_len; t0 += kTile) {"),
    ("dkv-no-di", "dS for dK leaves out di",
     "round_as(p * (dp - di_t[j]), q)", "round_as(p * dp, q)"),
    ("dkv-mask", "keys at or past valid_len get gradients",
     "const bool live = key < valid_len;", "const bool live = key < S;"),
    ("dq-scale", "dQ is not scaled by 1 / sqrt(dh)",
     "             dqr, scale, half);", "             dqr, 1.0f, half);"),
    ("dkv-last-query", "dK and dV leave out the last query of each tile",
     "const int rows = min(kTile, S - t0);", "const int rows = min(kTile, S - t0 - 1);"),
    ("lse-f32", "the f32 route's lse leaves out the row sum",
     "= (m + log2f(l)) * kLn2;", "= m * kLn2;", "csrc/encoder_attention.cu"),
    ("lse-tc", "the bf16 route's lse is 0.001 off in the log2 domain",
     "(m[i] * scale_log2 + log2f(l[i])) * kLn2;",
     "(m[i] * scale_log2 + log2f(l[i]) + 0.001f) * kLn2;", "csrc/encoder_attention.cu"),
)


def _with_source(kernel, mutants):
    """(kernel, source, name, fault, old, new) of each mutant, the source
    its own or its kernel's."""
    return tuple((kernel, m[4] if len(m) > 4 else KERNELS[kernel][0], *m[:4])
                 for m in mutants)


# (kernel, source, name, fault, old, new) for every mutant.
MUTANTS = (_with_source("mega", MEGA_MUTANTS) + _with_source("control", CONTROL_MUTANTS)
           + _with_source("mlp", MLP_MUTANTS) + _with_source("cache", CACHE_MUTANTS)
           + _with_source("attn_bwd", ATTN_BWD_MUTANTS))


def make_copy(name: str, source: Optional[str], old: Optional[str],
              new: Optional[str]) -> Path:
    """A copy of the package (without its builds) and the tests under
    WORK/name, with ``old`` replaced by ``new`` in ``source``."""
    dst = WORK / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(PACKAGE, dst / PACKAGE.name,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copytree(ROOT / "tests", dst / "tests",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    if old is not None:
        src = dst / PACKAGE.name / source
        text = src.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"mutant {name}: its text occurs {text.count(old)} "
                               f"times in {source}")
        src.write_text(text.replace(old, new))
    return dst


def run_check(copy: Path, timeout: int, check: str, kernels: List[str]) -> dict:
    """The card tests (or the smoke run's phases) of ``kernels`` on the
    copy's package (and the repo's other packages), one command after the
    other until one fails; a launch that traps or hangs counts as a
    failure."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]).rstrip(os.pathsep))
    code, text = 0, ""
    for kernel in kernels:
        _, select, smoke = KERNELS[kernel]
        cmd = ([sys.executable, "-c", smoke] if check == "smoke" else
               [sys.executable, "-m", "pytest", "tests/test_torch_kernels.py",
                "--noconftest", "-q", "-x", "-k", select, "-p", "no:cacheprovider"])
        try:
            out = subprocess.run(cmd, cwd=copy, env=env, capture_output=True,
                                 text=True, timeout=timeout)
            code, text = out.returncode, out.stdout + out.stderr
        except subprocess.TimeoutExpired:
            code, text = -1, "timeout"
        if code != 0:
            break
    first = (re.search(r"FAILED (\S+)", text) or re.search(r"ERROR (\S+)", text)
             or re.search(r"Error: (chip_smoke: check failed: [^\n]*)", text)
             or re.search(r"(\w+Error: [^\n]*)", text))
    return {"failed": code != 0,
            "first_failure": first.group(1)[:160] if first else
            (text.strip().splitlines()[-1][:160] if code != 0 and text.strip() else None)}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("all", *KERNELS), default="all",
                    help="whose mutants (default: all)")
    ap.add_argument("--only", default="",
                    help="comma-separated mutant names (default: all)")
    ap.add_argument("--check", choices=("tests", "smoke"), default="tests",
                    help="the card tests, or the kernel's chip_smoke.py phases")
    ap.add_argument("--timeout", type=int, default=300,
                    help="seconds for one copy's build and tests")
    args = ap.parse_args(argv)
    dev = _card.device("cuda")
    only = {n for n in args.only.split(",") if n}
    chosen = [m for m in MUTANTS if (args.kernel in ("all", m[0]))
              and (not only or m[2] in only)]
    kernels = sorted({m[0] for m in chosen}, key=list(KERNELS).index)
    results = []
    res = run_check(make_copy("unchanged", None, None, None), args.timeout,
                    args.check, kernels)
    results.append({"name": "unchanged", "fault": "no fault", **res})
    print(f"[mutants] unchanged: {'failed' if res['failed'] else 'passed'}",
          file=sys.stderr, flush=True)
    for kernel, source, name, what, old, new in chosen:
        res = run_check(make_copy(name, source, old, new), args.timeout,
                        args.check, [kernel])
        results.append({"name": name, "kernel": kernel, "fault": what, **res})
        print(f"[mutants] {name}: {'failed' if res['failed'] else 'passed'}"
              f" ({res['first_failure']})", file=sys.stderr, flush=True)
    shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"tool": "mega_mutants", "card": _card.card(dev),
                      "sources": sorted({f"thewhisper_tpu_torch/{m[1]}" for m in chosen}),
                      "check": args.check,
                      "control_passed": not results[0]["failed"],
                      "mutants_failed": sum(r["failed"] for r in results[1:]),
                      "mutants": len(results) - 1, "runs": results}))


if __name__ == "__main__":
    main()
