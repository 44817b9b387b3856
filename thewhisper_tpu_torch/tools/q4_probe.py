"""Q4 on the card: device ms of large-v3's six decoder linears (qkv 3840 x
1280; self out, cross q and cross out 1280 x 1280; fc1 5120 x 1280; fc2
1280 x 5120) over 32 layers, 192 launches in one CUDA graph (367 MB of
packed weights, more than the L2 holds, as a decode step reads them), for
each M of ``--rows``, beside the plain version, ``F.linear`` on the dense
bf16 weights (a yardstick) and ``torch._weight_int4pack_mm`` (the library's
int4 weight-only product) on the same weights, with the bound (bytes over
3.35 TB/s or operations over the bf16 peak). Prints one JSON line with the
card's name and power limit.

It only calls ``int4_linear`` and ``int4_linear_plain``, so it also times an
older copy of the package: put that copy first on ``PYTHONPATH`` and run
this file by its path (it then skips what that copy lacks: the routes,
PDL, the sweeps). ``--sweep`` also times each route forced at each M (the
crossover), with and without PDL; ``--explore`` times every launch of
both routes a shape at the given M; ``--per-shape`` times each distinct shape alone; ``--check`` holds both routes against the plain version
(relative L2 below 1e-2, the identity-row exactness, determinism and a
graph replay) instead of timing, and exits non-zero if one fails. Needs a card; about a minute:

    python -m thewhisper_tpu_torch.tools.q4_probe --rows 1,4,32,160,1500
    python -m thewhisper_tpu_torch.tools.q4_probe --check
    python -m thewhisper_tpu_torch.tools.q4_probe --f32 --rows 1,32 --cross-kv ""
    PYTHONPATH=<older copy> python thewhisper_tpu_torch/tools/q4_probe.py
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

import torch
import torch.nn.functional as F

from thewhisper_tpu_torch.ops import int4_linear as q4
from thewhisper_tpu_torch.tools import _card

# (out, in) of a large-v3 decoder layer's six linears, in the step's order.
SHAPES = ((3840, 1280), (1280, 1280), (1280, 1280), (1280, 1280), (5120, 1280),
          (1280, 5120))
CROSS_KV = (1280, 1280)  # one of the cross K/V's two linears a layer


def make_layers(n_layers: int, shapes, dev, seed: int = 0) -> List[list]:
    """Random packed weights (every nibble value), scales of a k ** -0.5
    weight's range and bf16 biases: [(packed, scale, bias), ...] a layer."""
    g = torch.Generator(device=dev).manual_seed(seed)
    layers = []
    for _ in range(n_layers):
        row = []
        for n, k in shapes:
            packed = torch.randint(0, 256, (n, k // 2), generator=g, device=dev,
                                   dtype=torch.int32).to(torch.uint8)
            scale = (torch.rand(n, generator=g, device=dev) + 0.5) * k ** -0.5 / 7
            bias = (0.1 * torch.randn(n, generator=g, device=dev)).to(torch.bfloat16)
            row.append((packed, scale, bias))
        layers.append(row)
    return layers


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def library_weights(packed: torch.Tensor, scale: torch.Tensor):
    """The same weights for ``torch._weight_int4pack_mm``: nibbles as
    unsigned q + 8, the even input in the high nibble, repacked by
    ``_convert_weight_to_int4pack``; group size 128 with each row's scale
    repeated along K and zero points of 0, so (u - 8) * s + 0 = q * s."""
    u = q4.unpack_int4(packed).to(torch.int16) + 8
    tg = ((u[:, 0::2] << 4) | u[:, 1::2]).to(torch.uint8).contiguous()
    w = torch._convert_weight_to_int4pack(tg, 8)
    groups = packed.shape[1] * 2 // 128
    sz = torch.stack([scale.to(torch.bfloat16).expand(groups, -1),
                      torch.zeros(groups, scale.shape[0], dtype=torch.bfloat16,
                                  device=scale.device)], dim=2).contiguous()
    return w, sz


def library_mm(x: torch.Tensor, w: torch.Tensor, sz: torch.Tensor) -> torch.Tensor:
    return torch._weight_int4pack_mm(x, w, 128, sz)


def bound(rows: int, shapes, dtype=torch.bfloat16) -> dict:
    """The least time for one layer's linears: packed weights, scales,
    biases, x and y moved once over 3.35 TB/s, or 2 M N K over the peak of
    x's type (bf16 tensor cores, f32 CUDA cores), whichever is more."""
    size = torch.finfo(dtype).bits // 8
    peak = _card.F32_FLOPS if dtype == torch.float32 else _card.BF16_FLOPS
    moved = sum(n * k // 2 + 4 * n + size * n + size * rows * (n + k) for n, k in shapes)
    flops = sum(2 * rows * n * k for n, k in shapes)
    by_bytes, by_ops = moved / _card.HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def layer_ms(layers, xs: Dict[int, torch.Tensor], fn, iters: int = 3) -> float:
    """Device ms a layer: every layer's linears through ``fn(x, packed,
    scale, bias)`` in one CUDA graph."""
    def run():
        return [fn(xs[p.shape[1] * 2], p, s, b) for row in layers for p, s, b in row]
    return _card.graph_ms(run, calls=1, iters=iters) / len(layers)


def time_rows(rows: int, layers, shapes, dev, sweep: bool, library: bool,
              per_shape: bool = False, dtype=torch.bfloat16) -> dict:
    g = torch.Generator(device=dev).manual_seed(rows)
    xs = {k: torch.randn(rows, k, generator=g, device=dev).to(dtype)
          for k in {k for _, k in shapes}}
    out = {"rows": rows, **bound(rows, shapes, dtype)}
    if hasattr(q4, "plan") and hasattr(q4, "Plan"):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        out["plans"] = [q4.plan(rows, n, k, sms, dtype == torch.float32)._asdict()
                        for n, k in shapes]
    out["l2_rel"] = max(rel_l2(q4.int4_linear(xs[p.shape[1] * 2], p, s, b),
                               q4.int4_linear_plain(xs[p.shape[1] * 2], p, s, b))
                        for p, s, b in layers[0])
    out["ms"] = layer_ms(layers, xs, q4.int4_linear)
    if per_shape:
        firsts = {}
        for i, (n, k) in enumerate(shapes):
            firsts.setdefault((n, k), i)
        out["per_shape_ms"] = {f"{n}x{k}": layer_ms([[row[i]] for row in layers], xs,
                                                    q4.int4_linear)
                               for (n, k), i in firsts.items()}
    out["plain_ms"] = layer_ms(layers, xs, q4.int4_linear_plain)
    dense = [[(q4.unpack_int4(p).to(dtype) * s.to(dtype)[:, None], b)
              for p, s, b in row] for row in layers]
    out["dense_ms"] = _card.graph_ms(lambda: [F.linear(xs[w.shape[1]], w, b)
                                              for row in dense for w, b in row],
                                     calls=1, iters=3) / len(layers)
    del dense
    if library:
        try:
            lib = [[library_weights(p, s) for p, s, _ in row] for row in layers]
            out["library_l2_rel"] = max(
                rel_l2(library_mm(xs[p.shape[1] * 2], w, sz) + b,
                       q4.int4_linear_plain(xs[p.shape[1] * 2], p, s, b))
                for (p, s, b), (w, sz) in zip(layers[0], lib[0]))
            out["library_ms"] = _card.graph_ms(
                lambda: [library_mm(xs[p.shape[1] * 2], w, sz)
                         for row, lrow in zip(layers, lib) for (p, _, _), (w, sz)
                         in zip(row, lrow)], calls=1, iters=3) / len(layers)
            del lib
        except (RuntimeError, AttributeError, NotImplementedError) as exc:
            out["library_ms"] = None
            out["library_error"] = f"{type(exc).__name__}: {str(exc)[:200]}"
    if sweep:
        out["sweep"] = sweep_rows(rows, layers, xs, shapes, dev)
    return out


def sweep_rows(rows: int, layers, xs, shapes, dev) -> dict:
    """Each bf16 route forced (the decode route only up to 64 rows), with
    and without PDL."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    res = {}
    saved = q4.DECODE_MAX_ROWS, q4.PDL
    try:
        for route, limit in (("decode", 64), ("tiled", 0)):
            q4.DECODE_MAX_ROWS = limit
            if any(q4.plan(rows, n, k, sms).route != route for n, k in shapes):
                continue
            for pdl in (True, False):
                q4.PDL = pdl
                res[f"{route} pdl={int(pdl)}"] = layer_ms(layers, xs, q4.int4_linear)
    finally:
        q4.DECODE_MAX_ROWS, q4.PDL = saved
    return res


def decode_launches(m: int, n: int, k: int):
    """Every decode-route launch the kernel takes for one shape: split (1,
    2, 4, 8), k-blocks a warp (1-4, as few warps as hold a block's
    share)."""
    kblocks, groups = k // q4.BLOCK_K, n // q4.ROWS
    nt = 1 if m <= 8 else 4
    for split in (1, 2, 4, 8):
        if split > kblocks:
            continue
        per = -(-kblocks // split)
        for kpw in (1, 2, 3, 4):
            warps = -(-per // kpw)
            limit = q4.DECODE_WARPS if nt == 1 and kpw <= 2 else q4.MAX_WARPS
            if -(-per // warps) == kpw and warps <= limit:
                yield q4.Plan("decode", warps, nt, kpw, split, (split, groups), True)


def tiled_launches(m: int, n: int, k: int):
    """Every tiled-route launch: tiles of 32 or 128 x rows, split 1-8."""
    for bn in (32, 128):
        for split in (1, 2, 4, 8):
            if split <= k // q4.BLOCK_K:
                yield q4.Plan("tiled", q4.TILED_WARPS, bn // 8, 0, split,
                              (split * -(-n // q4.TILE), -(-m // bn)), True)


def explore(rows_list, dev) -> dict:
    """Device us a launch of every decode launch (``decode_launches``, up
    to 64 rows) and tiled launch (``tiled_launches``) of each distinct
    large-v3 shape, 32 layers of it in one graph, with PDL; the best six,
    the best of each route, and the plan's own with PDL on and off."""
    out = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, k in sorted(set(SHAPES)):
        layers = make_layers(32, ((n, k),), dev, seed=n + k)
        for rows in rows_list:
            g = torch.Generator(device=dev).manual_seed(rows)
            xs = {k: torch.randn(rows, k, generator=g, device=dev, dtype=torch.bfloat16)}
            times = []
            p0, s0, b0 = layers[0][0]
            ref = q4.int4_linear_plain(xs[k], p0, s0, b0)
            launches = list(decode_launches(rows, n, k)) if rows <= 64 else []
            for launch in launches + list(tiled_launches(rows, n, k)):
                def fn(x, p, s, b, launch=launch):
                    return q4.int4_linear(x, p, s, b, launch=launch)
                try:
                    err = rel_l2(fn(xs[k], p0, s0, b0), ref)
                    if not err < 1e-2:
                        raise RuntimeError(f"relative L2 {err:.3e} from plain")
                    us = 1e3 * layer_ms(layers, xs, fn)
                except RuntimeError as exc:
                    us = f"{type(exc).__name__}: {str(exc)[:60]}"
                times.append((us, launch))
            ok = sorted((t for t in times if isinstance(t[0], float)), key=lambda t: t[0])
            own = q4.plan(rows, n, k, sms)
            saved = q4.PDL
            mine = {}
            for pdl in (True, False):
                q4.PDL = pdl
                mine[f"pdl={int(pdl)}"] = 1e3 * layer_ms(layers, xs, q4.int4_linear)
            q4.PDL = saved
            out[f"{n}x{k} M={rows}"] = {
                "plan": own._asdict(), "plan_us": mine,
                "best": [[round(us, 3), list(l)] for us, l in ok[:6]],
                "best_by_route": {route: next(([round(us, 3), list(l)] for us, l in ok
                                               if l.route == route), None)
                                  for route in ("decode", "tiled")},
                "failed": [str(t[0]) for t in times if not isinstance(t[0], float)][:3],
                "all": [[round(us, 3), list(l)] for us, l in ok]}
        del layers
    return out


def check(dev) -> dict:
    """Both bf16 routes against the plain version at large-v3's shapes; the
    identity-row exactness (x rows e_k give W's dequantized columns bit for
    bit); the same output twice and from a graph replay."""
    if not hasattr(q4, "Plan"):
        return {"skipped": "this copy of the package has one bf16 route"}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"rel_l2": {}, "exact": {}, "replay": {}}
    (row,) = make_layers(1, SHAPES, dev, seed=1)
    g = torch.Generator(device=dev).manual_seed(2)
    for rows in (1, 3, 4, 32, 33, 64, 65, 160, 1500, 6000):
        worst = 0.0
        for p, s, b in row:
            x = torch.randn(rows, p.shape[1] * 2, generator=g, device=dev,
                            dtype=torch.bfloat16)
            worst = max(worst, rel_l2(q4.int4_linear(x, p, s, b),
                                      q4.int4_linear_plain(x, p, s, b)))
        out["rel_l2"][rows] = worst
    for rows in (32, 1280):
        for p, s, _ in row:
            n, k = p.shape[0], p.shape[1] * 2
            cols = torch.arange(rows, device=dev) * 7 % k
            x = torch.zeros(rows, k, device=dev, dtype=torch.bfloat16)
            x[torch.arange(rows, device=dev), cols] = 1
            got = q4.int4_linear(x, p, s)
            w = q4.unpack_int4(p).to(torch.bfloat16) * s.to(torch.bfloat16)[:, None]
            out["exact"][f"{rows} {n}x{k} {q4.plan(rows, n, k, sms).route}"] = bool(
                torch.equal(got, w[:, cols].t()))
    for rows in (1, 32, 1500):
        p, s, b = row[0]
        x = torch.randn(rows, 1280, generator=g, device=dev, dtype=torch.bfloat16)
        first = q4.int4_linear(x, p, s, b)
        y = torch.empty_like(first)
        graph = _card.capture(lambda: y.copy_(q4.int4_linear(x, p, s, b)))
        y.zero_()
        graph.replay()
        torch.cuda.synchronize()
        out["replay"][rows] = bool(torch.equal(q4.int4_linear(x, p, s, b), first)
                                   and torch.equal(y, first))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", default="1,4,32,160,1500",
                    help="comma-separated M of the six linears")
    ap.add_argument("--cross-kv", default="6000",
                    help="comma-separated M of the cross K/V's own shape (1280 x 1280,"
                         " two linears a layer), '' for none")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--no-library", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--f32", action="store_true",
                    help="f32 x and biases (Q4's f32 route; no library call, no sweep)")
    ap.add_argument("--explore", default="",
                    help="comma-separated M: time every decode launch of each shape")
    ap.add_argument("--per-shape", action="store_true",
                    help="also time each distinct shape alone (32 launches a graph)")
    args = ap.parse_args(argv)
    dev = _card.device("cuda")
    result = {"tool": "q4_probe", "card": _card.card(dev), "package": q4.__file__}
    if args.explore:
        result["explore"] = explore([int(r) for r in args.explore.split(",")], dev)
    elif args.check:
        result["check"] = got = check(dev)
        result["ok"] = "skipped" in got or (
            all(v < 1e-2 for v in got["rel_l2"].values())
            and all(got["exact"].values()) and all(got["replay"].values()))
    else:
        dtype = torch.float32 if args.f32 else torch.bfloat16
        sweep, library = args.sweep and not args.f32, not (args.no_library or args.f32)

        def cast(layers):
            return [[(p, s, b.to(dtype)) for p, s, b in row] for row in layers]

        layers = cast(make_layers(args.layers, SHAPES, dev))
        result["six"] = [time_rows(int(r), layers, SHAPES, dev, sweep, library,
                                   args.per_shape, dtype)
                         for r in args.rows.split(",") if r]
        del layers
        kv = cast(make_layers(args.layers, (CROSS_KV, CROSS_KV), dev, seed=5))
        result["cross_kv"] = [time_rows(int(r), kv, (CROSS_KV, CROSS_KV), dev,
                                        sweep, library, dtype=dtype)
                              for r in args.cross_kv.split(",") if r]
    print(json.dumps(result))
    if not result.get("ok", True):
        raise SystemExit("q4_probe: a check failed")


if __name__ == "__main__":
    main()
