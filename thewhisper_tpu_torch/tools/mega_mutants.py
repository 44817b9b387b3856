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
``csrc/encoder_attention_bwd.cu`` (both routes; the bf16 one's register-A
product in ``csrc/tc_common.cuh``) and K2's f32 route and lse stores in
``csrc/encoder_attention.cu`` (tests ``-k "attention_kernel or
attention_backward or autograd_on_the_card"``; smoke: [TRAIN]'s kernel
checks); and ``int4``, Q4 in ``csrc/int4_linear.cu`` (both bf16 routes;
tests ``-k int4``; smoke: ``tools/q4_probe.py --check``).

The copies go to ``thewhisper_tpu_torch/build/mutants/`` (git-ignored), one
directory a mutant, each with its own kernel build. Prints one JSON line:
the card's name and power limit and, for each copy, whether the tests
failed and the first failing test. Needs a card; the eleven K3/K4 mutants take
about 5 minutes (15 with ``--check smoke``), the six P1 mutants about 2,
the seven P2/P3 mutants about 2, the five P4/P5 mutants about 5, the
twenty K2 and K2 backward mutants about 10, the five Q4 mutants about 5:

    python -m thewhisper_tpu_torch.tools.mega_mutants
    python -m thewhisper_tpu_torch.tools.mega_mutants --kernel control
    python -m thewhisper_tpu_torch.tools.mega_mutants --kernel mlp
    python -m thewhisper_tpu_torch.tools.mega_mutants --kernel cache
    python -m thewhisper_tpu_torch.tools.mega_mutants --kernel attn_bwd
    python -m thewhisper_tpu_torch.tools.mega_mutants --kernel int4
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
# Put at the head of each copy's csrc/tc_common.cuh: its ring waits trap
# after 2 s, so a mutant whose barriers fall out of step fails its launch
# instead of hanging the card. The package's own build waits without bound;
# here a copy runs alone on its card, where no wait of a sound launch comes
# near 2 s (the kernels it runs take milliseconds).
TRAP_DEFINE = "#define TWT_MBAR_TRAP_NS 2000000000ull\n"

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
SMOKE_INT4 = ("from thewhisper_tpu_torch.tools import q4_probe; "
              "q4_probe.main(['--check'])")
# kernel -> (its source, the -k selection of its card tests, its smoke run).
KERNELS = {
    "mega": ("csrc/mega_common.cuh", "mega", SMOKE_MEGA),
    "control": ("csrc/attention_control.cu", "attention_control", SMOKE_CONTROL),
    "mlp": ("csrc/mlp_chain.cu", "mlp_chain", SMOKE_MLP),
    "cache": ("csrc/cache_write.cu", "write_row or write_column", SMOKE_CACHE),
    "attn_bwd": ("csrc/encoder_attention_bwd.cu",
                 "attention_kernel or attention_backward or autograd_on_the_card",
                 SMOKE_ATTN_BWD),
    "int4": ("csrc/int4_linear.cu", "int4", SMOKE_INT4),
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
     "p.S + pos + n) * kDh", "p.S + pos) * kDh"),
    ("residual-round", "the residual adds y unrounded",
     "__float2bfloat16(xr + round_bf16(y))", "__float2bfloat16(xr + y)"),
    ("pos-bound", "the device slot's check lets pos + W reach bound + 1",
     "pos > p.bound - p.W", "pos > p.bound - p.W + 1"),
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


# K2-dkv and K2-dq, and K2's f32 route and lse stores (in
# csrc/encoder_attention.cu). The f32- ones change the f32 routes (K2's
# 3xTF32 kernel and the backward's, one template for dK/dV and dQ: the
# f32-dq- ones change only its dQ instance); the tc- ones the bf16 route
# (TMA + wgmma), one of them in csrc/tc_common.cuh.
ATTN_BWD_MUTANTS = (
    ("f32-dv-scale", "the f32 route's dV is stored halved",
     "make_float2(acc1[j][2 * i], acc1[j][2 * i + 1]);",
     "make_float2(0.5f * acc1[j][2 * i], 0.5f * acc1[j][2 * i + 1]);"),
    ("f32-dq-keys", "the f32 dQ kernel's last key tile keeps keys >= valid_len",
     "const bool live = kKeys ? key_live[e >> 1] : col < key_end;",
     "const bool live = kKeys ? key_live[e >> 1] : true;"),
    ("f32-dkv-no-di", "the f32 route's dS for dK leaves out di",
     "dp[j][e] = p * (dp[j][e] - (kKeys ? cl[kF32Tile + col] : row_di[e >> 1]));",
     "dp[j][e] = p * (dp[j][e] - (kKeys ? 0.0f : row_di[e >> 1]));"),
    ("f32-dkv-mask", "the f32 route gives keys at or past valid_len gradients",
     "const bool key_live[2] = {row0 + r0 < valid_len, row0 + r0 + 8 < valid_len};",
     "const bool key_live[2] = {row0 + r0 < S, row0 + r0 + 8 < S};"),
    ("f32-dq-scale", "the f32 dQ is stored unscaled (not times 1 / sqrt(dh))",
     "0.125f /* f32 dQ */", "1.0f /* f32 dQ */"),
    ("f32-dq-lo", "the f32 dQ product leaves out dS's lo term (a_lo b_hi)",
     "Frag da = acc_frag(dp[j]);\n",
     "Frag da = acc_frag(dp[j]);\n"
     "      if (!kKeys) for (int e = 0; e < 4; ++e) da.lo[e] = 0u;\n"),
    ("f32-dq-parity", "the f32 dQ kernel's MMA warps wait on a ring stage at the wrong parity",
     "mbar_wait(&full[st], (t / kF32Stages) & 1);",
     "mbar_wait(&full[st], ((t / kF32Stages) + !kKeys) & 1);"),
    ("f32-dkv-last-query", "the f32 route's dK and dV leave out the last query of "
     "each tile (its lse read as +inf)",
     "cl[c] = qi < S ? lse_bh[qi] * kLog2e : INFINITY;",
     "cl[c] = qi < S && c != kF32Tile - 1 ? lse_bh[qi] * kLog2e : INFINITY;"),
    ("lse-f32", "the f32 route's lse leaves out the row sum",
     "(log2f(l[i]) + m[i] * scale_log2) * kLn2;", "(m[i] * scale_log2) * kLn2;",
     "csrc/encoder_attention.cu"),
    ("f32-fwd-lo", "the f32 forward's score product leaves out q's lo term (a_lo b_hi)",
     "Frag qa = dims_frag<kF32BlockQ>(q_tile, r0, kk, lane % 4);\n",
     "Frag qa = dims_frag<kF32BlockQ>(q_tile, r0, kk, lane % 4);\n"
     "      for (int e = 0; e < 4; ++e) qa.lo[e] = 0u;\n", "csrc/encoder_attention.cu"),
    ("f32-dkv-lo", "the f32 route's dV product leaves out P^T's lo term (a_lo b_hi)",
     "Frag pa = acc_frag(s[j]);\n",
     "Frag pa = acc_frag(s[j]);\n      for (int e = 0; e < 4; ++e) pa.lo[e] = 0u;\n"),
    ("f32-fwd-ragged", "the f32 forward's last, ragged key tile is not masked "
     "(keys >= valid_len, and rows past S as zero scores, take part)",
     "if (key0 + kF32Tile > valid_len) {", "if (false) {", "csrc/encoder_attention.cu"),
    ("f32-parity", "the f32 forward's MMA warps wait on a ring stage at the wrong parity",
     "mbar_wait(&full[st], (t / kF32Stages) & 1);",
     "mbar_wait(&full[st], ((t / kF32Stages) + 1) & 1);", "csrc/encoder_attention.cu"),
    ("lse-tc", "the bf16 route's lse is 0.001 off in the log2 domain",
     "(m[i] * scale_log2 + log2f(l[i])) * kLn2;",
     "(m[i] * scale_log2 + log2f(l[i]) + 0.001f) * kLn2;", "csrc/encoder_attention.cu"),
    ("tc-kmajor", "the register-A product reads its B tile K-major, where it is "
     "MN-major (dO for dV, q for dK, k for dQ; and K2's V)",
     "{%32, %33, %34, %35}, %36, p, 1, 1, 1;", "{%32, %33, %34, %35}, %36, p, 1, 1, 0;",
     "csrc/tc_common.cuh"),
    ("tc-past-s", "queries past S keep their P: their lse is read past the row",
     "cl[c] = q < S ? lse_bh[q] * kLog2e : INFINITY;", "cl[c] = lse_bh[q] * kLog2e;"),
    ("tc-dq-keys", "the dQ kernel's last key tile keeps keys >= valid_len",
     "s[j] = frag_col(j, cq) < key_end ? ex2(fmaf(s[j], scale_log2, -row_lse[i])) : 0.0f;",
     "s[j] = ex2(fmaf(s[j], scale_log2, -row_lse[i]));"),
    ("tc-parity", "the consumers wait on a ring stage at the wrong parity",
     "mbar_wait(&full[st], (t / kTcStages) & 1);",
     "mbar_wait(&full[st], ((t / kTcStages) + 1) & 1);"),
    ("tc-dk-scale", "dK is not scaled by 1 / sqrt(dh)", "0.125f /* dK */", "1.0f /* dK */"),
    ("tc-dkv-mask", "keys at or past valid_len get dK and dV",
     "key_live[i] = r < valid_len;", "key_live[i] = r < S;"),
)


# Q4's two bf16 routes.
INT4_MUTANTS = (
    ("split-drop", "the split-K sum drops the partial of cluster rank 0",
     "float sum = v[0];", "float sum = 0.0f;"),
    ("x-offset", "the tiled route stages x's second 64-column box at the first's k",
     "tma_load_2d(stage + kBox, &x_map, kt * kStageK + 64, n0, &full[st]);",
     "tma_load_2d(stage + kBox, &x_map, kt * kStageK, n0, &full[st]);"),
    ("unsigned", "a nibble is read as unsigned (0 .. 15, not -8 .. 7)",
     "(v & 0x000F000Fu) ^ 0x43084308u;\n  const uint32_t q = fma_bf16x2(m, 0x3F803F80u, 0xC308C308u);",
     "(v & 0x000F000Fu) | 0x43004300u;\n  const uint32_t q = fma_bf16x2(m, 0x3F803F80u, 0xC300C300u);"),
    ("byte-order", "the tiled route's A fragment takes a byte's nibbles high first",
     "static_cast<uint32_t>(t | ((4 + t) << 8))", "static_cast<uint32_t>((4 + t) | (t << 8))"),
    ("warp-blocks", "a decode warp stops one k-block early at the end of its block's range",
     "if (kb >= kb1) break;", "if (kb >= kb1 - 1) break;"),
)


def _with_source(kernel, mutants):
    """(kernel, source, name, fault, old, new) of each mutant, the source
    its own or its kernel's."""
    return tuple((kernel, m[4] if len(m) > 4 else KERNELS[kernel][0], *m[:4])
                 for m in mutants)


# (kernel, source, name, fault, old, new) for every mutant.
MUTANTS = (_with_source("mega", MEGA_MUTANTS) + _with_source("control", CONTROL_MUTANTS)
           + _with_source("mlp", MLP_MUTANTS) + _with_source("cache", CACHE_MUTANTS)
           + _with_source("attn_bwd", ATTN_BWD_MUTANTS)
           + _with_source("int4", INT4_MUTANTS))


def make_copy(name: str, source: Optional[str], old: Optional[str],
              new: Optional[str]) -> Path:
    """A copy of the package (without its builds) and the tests under
    WORK/name, with ``old`` replaced by ``new`` in ``source`` and the ring
    waits of ``csrc/tc_common.cuh`` trapping (``TRAP_DEFINE``)."""
    dst = WORK / name
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(PACKAGE, dst / PACKAGE.name,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copytree(ROOT / "tests", dst / "tests",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "chip_smoke.py", dst / "chip_smoke.py")
    header = dst / PACKAGE.name / "csrc" / "tc_common.cuh"
    header.write_text(TRAP_DEFINE + header.read_text())
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
