"""How close does the batch-1 int8 decode MLP chain get to its memory floor
as one kernel, and what does a launch a layer cost against a grid barrier?
(The port's counterpart of thewhisper_tpu's ``tools/gemv_chain_probe.py``.)

The chain is large-v3's decoder MLP sub-chain at batch 1 (LN2, int8 fc1,
tanh GELU, int8 fc2, residual) over L stacked layers, d_model 1280 and d_ff
5120: 13.1 MB of int8 weights a layer, 419.4 MB over 32 layers, 0.125 ms at
the H100's 3.35 TB/s. Arms:

- ``plain``: the port's eager int8 sub-chain, the modules the decoder runs
  (``models/quant.py::Int8Linear``, ``models/whisper.py``'s LayerNorm and
  GELU), one layer after another; it takes the place of the TPU probe's
  ``xla`` arm.
- ``chain``: P2, the whole chain in one cooperative launch
  (``ops/mlp_chain.py::mlp_chain``).
- ``layer`` (``--hybrid``): P3, one launch a layer
  (``ops/mlp_chain.py::mlp_layer``), L launches a chain.

Times are CUDA events with the card's name and power limit, two ways:
``ms``, eager chains, the mean of ``--reps`` after a warm-up (what a
caller pays: L launches of ``layer`` wait on the host's wrapper); and
``graph_ms``, chains replayed from a CUDA graph (the card's own time, the
host left out), from which ``gb_per_s`` is computed. The TPU probe's N-vs-3N
differential loop and its DMA ``--tile`` have no counterpart. Prints one
JSON line. ``--device cpu`` runs the numerics alone with the plain versions, at
2 layers of d_model 256 and d_ff 1024.

    python -m thewhisper_tpu_torch.tools.gemv_chain_probe [--layers 32] [--reps 5] [--hybrid]
    python -m thewhisper_tpu_torch.tools.gemv_chain_probe --device cpu --hybrid
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import torch

from thewhisper_tpu_torch.models.quant import Int8Linear
from thewhisper_tpu_torch.models.whisper import LayerNorm, _gelu
from thewhisper_tpu_torch.ops import mlp_chain as mc
from thewhisper_tpu_torch.tools import _card

D_MODEL, D_FFN = 1280, 5120
CPU_SIZE = (2, 256, 1024)          # layers, d_model, d_ff with --device cpu
_ORDER = ("ln_s", "ln_b", "s1", "b1", "s2", "b2", "w1", "w2")


def make_inputs(n_layers: int, d: int, f: int, generator: torch.Generator,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """The TPU probe's operands, drawn on ``device``: int8 weights uniform
    in [-127, 127], scales uniform in [0.5, 1.5] x 0.02 / 127, biases
    0.02 N(0, 1), x 0.1 N(0, 1) in bf16. LayerNorm scales are
    1 + 0.1 N(0, 1) and shifts 0.1 N(0, 1), where the TPU probe has 1 and 0:
    the timing is the same, and a kernel that drops either one fails the
    checks."""
    def normal(*shape):
        return torch.randn(*shape, generator=generator, device=device)

    def uniform(*shape):
        return torch.rand(*shape, generator=generator, device=device)

    def weights(*shape):
        return torch.randint(-127, 128, shape, generator=generator,
                             device=device, dtype=torch.int8)

    return {
        "x": (0.1 * normal(1, d)).to(torch.bfloat16),
        "ln_s": 1.0 + 0.1 * normal(n_layers, d),
        "ln_b": 0.1 * normal(n_layers, d),
        "s1": (0.5 + uniform(n_layers, f)) * 0.02 / 127,
        "b1": 0.02 * normal(n_layers, f),
        "s2": (0.5 + uniform(n_layers, d)) * 0.02 / 127,
        "b2": 0.02 * normal(n_layers, d),
        "w1": weights(n_layers, d, f),
        "w2": weights(n_layers, f, d),
    }


def operands(p: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """The chain's operands after ``x``, in the kernels' order."""
    return [p[k] for k in _ORDER]


def weight_bytes(p: Dict[str, torch.Tensor]) -> int:
    return p["w1"].numel() + p["w2"].numel()


def plain_layers(p: Dict[str, torch.Tensor]) -> List[torch.nn.ModuleList]:
    """The decoder's own eager modules for each layer: LayerNorm, int8 fc1
    and fc2 in (out, in) layout (a transposed copy of the probe's weights)
    with biases in bf16."""
    n_layers, d, f = p["w1"].shape
    dev = p["w1"].device
    layers = []
    for l in range(n_layers):
        ln = LayerNorm(d, device=dev)
        with torch.no_grad():
            ln.weight.copy_(p["ln_s"][l])
            ln.bias.copy_(p["ln_b"][l])
        fcs = []
        for w, s, b, (n_in, n_out) in ((p["w1"], p["s1"], p["b1"], (d, f)),
                                       (p["w2"], p["s2"], p["b2"], (f, d))):
            fc = Int8Linear(n_in, n_out, dtype=torch.bfloat16, device=dev)
            fc.weight = w[l].t().contiguous()
            fc.scale = s[l].contiguous()
            fc.bias = b[l].to(torch.bfloat16)
            fcs.append(fc)
        layers.append(torch.nn.ModuleList([ln, *fcs]))
    return layers


def plain_chain(x: torch.Tensor, layers: List[torch.nn.ModuleList]) -> torch.Tensor:
    for ln, fc1, fc2 in layers:
        x = x + fc2(_gelu(fc1(ln(x))))
    return x


def _rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-6)).item()


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--hybrid", action="store_true",
                    help="also time P3, one launch a layer")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: numerics only, small size")
    args = ap.parse_args(argv)
    dev = _card.device(args.device)
    n_layers, d, f = (CPU_SIZE if dev.type == "cpu"
                      else (args.layers, D_MODEL, D_FFN))
    gen = torch.Generator(device=dev).manual_seed(0)
    p = make_inputs(n_layers, d, f, gen, dev)
    ops = operands(p)
    layers = plain_layers(p)

    arms = {"plain": lambda: plain_chain(p["x"], layers),
            "chain": lambda: mc.mlp_chain(p["x"], *ops)}
    if args.hybrid:
        def by_layer():
            x = p["x"]
            for l in range(n_layers):
                x = mc.mlp_layer(x, l, *ops)
            return x
        arms["layer"] = by_layer

    with torch.inference_mode():
        outs = {name: fn() for name, fn in arms.items()}
        reference = mc.mlp_chain_plain(p["x"], *ops)
    gb = weight_bytes(p) / 1e9
    result = {
        "probe": "gemv_chain", "device": str(dev), "card": _card.card(dev),
        "layers": n_layers, "d_model": d, "d_ffn": f,
        "weight_gb": gb, "floor_ms": gb * 1e9 / _card.HBM_BYTES_PER_S * 1e3,
        # The TPU probe's own check: the one-kernel chain against the
        # eager chain, relative to the largest value, below 5e-2.
        "err_chain_vs_plain": _rel(outs["chain"], outs["plain"]),
        # The kernel against its plain version (ops.mlp_chain).
        "err_chain_vs_reference": _rel(outs["chain"], reference),
    }
    if args.hybrid:
        result["layer_equals_chain"] = bool(torch.equal(outs["layer"], outs["chain"]))
    if result["err_chain_vs_plain"] >= 5e-2:
        raise RuntimeError(f"gemv_chain_probe: chain diverged from the plain "
                           f"arm ({result['err_chain_vs_plain']:.3e})")
    if args.hybrid and not result["layer_equals_chain"]:
        raise RuntimeError("gemv_chain_probe: L launches of mlp_layer differ "
                           "from one mlp_chain")
    if dev.type == "cuda":
        with torch.inference_mode():
            ms = {name: _card.cuda_ms(fn, args.reps) for name, fn in arms.items()}
            graph = {name: _card.graph_ms(fn, calls=4) for name, fn in arms.items()}
        result["ms"] = ms
        result["graph_ms"] = graph
        result["gb_per_s"] = {name: gb / t * 1e3 for name, t in graph.items()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
