"""Encoder-attention core at (B = 32, H = 20, S = 1536, dh = 64), bf16, as a
chain of 32 layers whose output feeds the next layer's q. (The port's
counterpart of thewhisper_tpu's ``tools/attention_probe.py``.)

Arms:

- ``k2``: the port's encoder attention kernel (``ops/attention.py``, K2),
  keys past 1500 masked; it stands for both the TPU probe's generic
  and custom arms.
- ``plain``: K2's plain PyTorch version.
- ``library``: ``torch.nn.functional.scaled_dot_product_attention`` with the
  same mask, timed as a yardstick only (the port never calls it).
- ``control_noexp``: P1 (``ops/attention_control.py``), flash attention with
  the exponential taken out over 512-key tiles, no mask: wrong math on
  purpose, the floor of the two products and the bookkeeping.

Times are CUDA events around a chain, the mean of ``--reps`` after a
warm-up, with the card's name and power limit (the TPU probe's host clock
and remote-compile notes have no counterpart). Numerics, on one layer: K2
against the library call, and P1 against its plain version over the whole
batch, which raises beyond 2e-2 of the largest value. Prints one JSON line. ``--device cpu`` runs the numerics
alone with the plain versions at B = 1, H = 2, S = 1024 (two key tiles),
valid 1000, 2 layers.

    python -m thewhisper_tpu_torch.tools.attention_probe [--layers 32] [--reps 3]
    python -m thewhisper_tpu_torch.tools.attention_probe --device cpu
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from thewhisper_tpu_torch.ops import attention as k2
from thewhisper_tpu_torch.ops import attention_control as ac
from thewhisper_tpu_torch.tools import _card

SIZE = {"batch": 32, "heads": 20, "seq": 1536, "valid": 1500}
CPU_SIZE = {"batch": 1, "heads": 2, "seq": 1024, "valid": 1000, "layers": 2}
DH = 64


def arms(k: torch.Tensor, v: torch.Tensor,
         valid: int) -> Dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    """One layer of each arm, on (B, H, S, dh) tensors."""
    s = k.shape[2]
    mask = (torch.arange(s, device=k.device) < valid)[None, None, None, :]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)      # (B, S, H, dh) views

    def kernel(q):
        return k2.encoder_attention(q.transpose(1, 2), kt, vt, valid).transpose(1, 2)

    def plain(q):
        return k2.encoder_attention_plain(q.transpose(1, 2), kt, vt,
                                          valid).transpose(1, 2)

    return {"k2": kernel, "plain": plain,
            "library": lambda q: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
            "control_noexp": lambda q: ac.attention_control(q.contiguous(), k, v)}


def chain(layer: Callable[[torch.Tensor], torch.Tensor], q: torch.Tensor,
          n_layers: int) -> torch.Tensor:
    for _ in range(n_layers):
        q = layer(q)
    return q


def _max_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return (got.float() - ref.float()).abs().max().item()


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: numerics only, small size")
    args = ap.parse_args(argv)
    dev = _card.device(args.device)
    size = dict(CPU_SIZE) if dev.type == "cpu" else dict(SIZE, layers=args.layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(size["batch"], size["heads"], size["seq"], DH,
                           generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    layer = arms(k, v, size["valid"])

    with torch.inference_mode():
        k2_err = _max_err(layer["k2"](q), layer["library"](q))
        ref = ac.attention_control_plain(q, k, v)
        control_err = (_max_err(ac.attention_control(q, k, v), ref)
                       / ref.float().abs().max().item())
        del ref
        if control_err > 2e-2:
            raise RuntimeError(f"attention_probe: P1 differs from its plain "
                               f"version ({control_err:.3e} of the largest value)")
        outs = {name: chain(fn, q, size["layers"]) for name, fn in layer.items()}
    result = {"probe": "attention", "device": str(dev), "card": _card.card(dev),
              **size, "dh": DH,
              "k2_max_abs_err_vs_library": k2_err,
              "control_err_vs_plain_rel_to_max": control_err,
              "chain_finite": {name: bool(torch.isfinite(o).all())
                               for name, o in outs.items()}}
    if dev.type == "cuda":
        with torch.inference_mode():
            ms = {name: _card.cuda_ms(lambda fn=fn: chain(fn, q, size["layers"]),
                                      args.reps)
                  for name, fn in layer.items()}
        result["ms_per_chain"] = ms
        result["ms_per_layer"] = {name: t / size["layers"] for name, t in ms.items()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
