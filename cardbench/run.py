#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 cardbench/run.py --workload turbo-s.clips-bs64 --seed 7 \\
        --seconds 10 --trace 0

From the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up builds the system under test (``thewhisper_tpu_torch``) from
the cell's configuration with weights drawn from ``--seed``, makes the
mix's inputs from the seed, and warms every shape the mix uses; then the
window runs the mix for ``--seconds`` (with ``--trace 1``, a bounded part
of it under the profiler). Afterwards the served tokens of a sample are
checked against the plain reference. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit. It exits non-zero without a result when
there is no card, too few of them, or when JAX or the JAX package was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

from harness.system import cache_env  # noqa: E402

cache_env()

import torch  # noqa: E402

from harness import check, drivers, tracing  # noqa: E402
from harness.spec import load_cell, metric_reader  # noqa: E402
from harness.system import System, build_kernels, encode_spans, span  # noqa: E402
from harness.traffic import make_requests  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "thewhisper_tpu")


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", root: Path = Path("."), control: bool = False,
        cell=None) -> dict:
    """One run; returns the result line's object (``control``: also the
    control's readings under ``readings``, which the benchmark's own runs
    do not take)."""
    cell = cell or load_cell(workload, root)
    mix = cell.traffic
    build_s = build_kernels(device)
    log(f"[setup] kernel libraries ready in {build_s:.2f} s")
    chunk = float(mix["chunk_length_s"])
    system = System(cell, seed, device, batch_size=int(mix.get("batch_size", 1)),
                    chunk_length_s=chunk)
    pool = make_requests(mix, seed, device)
    buckets = drivers.needed_buckets(mix, pool, system.engine.batch_buckets)
    system.warm(mix, int(chunk * 100), buckets)
    shortest = min(range(len(pool)),
                   key=lambda i: sum(len(r.audio) for r in pool[i]))
    drivers.warm_call(system, mix, pool[shortest])
    programs = len(system.engine.programs())
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    log(f"[setup] {setup_s:.3f} s; {programs} decode programs")

    with (encode_spans() if trace else contextlib.nullcontext()), \
            tracing.profile(trace) as prof, span("cardbench.window"):
        # Every entry of the pool is the same work, so every seed's
        # window, and its traced part, runs the same work from entry 0.
        records = drivers.run_window(
            system, mix, pool, seconds,
            max_calls=int(mix["trace_calls"]) if trace else None)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    info = device_info(device, cell.chips)
    if len(system.engine.programs()) != programs:
        log(f"[window] WARNING: {len(system.engine.programs()) - programs} "
            "decode programs were made inside the window")
    found = forbidden_modules()
    if found:
        log(f"[window] the process loaded {', '.join(found)}: refused")
        raise SystemExit(3)

    calls = [c for r in records for c in r.engine_calls]
    attempted = sum(len(pool[r.pool_index]) for r in records)
    failed = sum(len(pool[r.pool_index]) for r in records if not r.ok)
    for r in records:
        if not r.ok:
            log(f"[window] call on pool entry {r.pool_index} raised: {r.error}")
    done = [r for r in records if r.ok]
    wall = records[-1].end - records[0].start
    log(f"[rtfx] samples: {len(records)} calls, {len(done)} completed, "
        f"{attempted} requests, {sum(r.seconds for r in done):.2f} s of "
        f"audio over {wall:.4f} s")
    walls = [r.end - r.start for r in records]
    log(f"[window] call walls: median {statistics.median(walls):.4f} s, "
        f"min {min(walls):.4f}, max {max(walls):.4f}")
    values = {"rtfx": drivers.rtfx(records)} if done else {}
    values["setup_s"] = setup_s

    metrics, breakdown = {}, None
    if trace:
        events = tracing.read_events(prof)
        del prof
        ctx = tracing.TraceContext(events, cell.arch, system.mode, mix, calls)
        info["busy_s"] = ctx.busy_s()
        info["window_s"] = ctx.span_s
        log(f"[trace] {len(calls)} engine calls, {ctx.windows()} windows, "
            f"{len(ctx.kernels)} kernels over {ctx.span_s:.4f} s, busy "
            f"{info['busy_s']:.4f} s")
        for m in cell.per_layer:
            value = metric_reader(m["name"])(ctx)
            if value is None:
                log(f"[trace] {m['name']}: nothing to read")
            else:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        breakdown = tracing.breakdown(ctx)
        del events, ctx
    else:
        # A metric reads the quantity its name starts with: "rtfx.longform"
        # is the rtfx of the cell that reports it.
        for m in cell.end_to_end:
            quantity = m["name"].split(".")[0]
            if quantity in values:
                metrics[m["name"]] = {"value": values[quantity], "unit": m["unit"]}

    # The program's state goes before the reference runs.
    samples, short = check.sample(cell, records, pool, seed)
    del pool
    system.close()
    del system, calls
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    read = check.readings(cell, samples, seed, device, control=control)
    log(f"[check] {len(samples)} rows, {len(samples) * int(mix['max_new_tokens'])}"
        f" served tokens against the reference in {time.perf_counter() - t0:.2f} s")
    for s, g, lp, b in zip(samples, read["row_gaps"], read["row_logprobs"],
                           read["row_bests"]):
        log(f"[check]   {s.what}: widest gap {g:.6f}, log-probability off by "
            f"{lp:.6f}, from the best by {b:.6f}")
    checks = {name: {"value": read[name], "limit": float(limit)}
              for name, limit in check.limits(cell).items()}
    checks["short_rows"] = {"value": int(short), "limit": 0}
    checks["failed"] = {"value": int(failed), "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if control:
        out["readings"] = {k: read[k] for k in check.READINGS}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        log("cardbench: no CUDA device; the benchmark runs only on the card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"cardbench: {args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} found")
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace),
              cell=cell)
    for name, c in out["checks"].items():
        log(f"[checks] {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
