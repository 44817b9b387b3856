"""What a run is: ``BENCHMARK.json``'s cell, its configuration file, its
traffic file and the readers of its per-layer metrics, all found by name.

A cell ``<config>.<traffic>`` names ``configs/<config>.json`` and
``traffic/<traffic>.json`` under the benchmark's folder; a per-layer
metric ``<name>`` is ``metrics/<name>.py``, a module with a function
``read(ctx)`` that returns a number, or None where the trace holds
nothing for it to read. Adding a cell, a configuration, a mix or a metric
is adding files and entries: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclasses.dataclass(frozen=True)
class Arch:
    """A Whisper architecture by the fields both the program and the plain
    reference read."""

    d_model: int
    encoder_layers: int
    encoder_heads: int
    decoder_layers: int
    decoder_heads: int
    d_ff: int
    n_mels: int
    vocab_size: int
    max_source_positions: int
    max_target_positions: int
    alignment_heads: Tuple[Tuple[int, int], ...] = ()

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_heads


def arch_from_config(cfg: Dict[str, Any]) -> Arch:
    """The Arch of a configuration file (Hugging Face's key names)."""
    if cfg["encoder_ffn_dim"] != cfg["decoder_ffn_dim"]:
        raise ValueError("encoder and decoder MLP widths differ")
    return Arch(
        d_model=cfg["d_model"], encoder_layers=cfg["encoder_layers"],
        encoder_heads=cfg["encoder_attention_heads"],
        decoder_layers=cfg["decoder_layers"],
        decoder_heads=cfg["decoder_attention_heads"],
        d_ff=cfg["encoder_ffn_dim"], n_mels=cfg["num_mel_bins"],
        vocab_size=cfg["vocab_size"],
        max_source_positions=cfg["max_source_positions"],
        max_target_positions=cfg["max_target_positions"],
        alignment_heads=tuple(tuple(h) for h in cfg.get("alignment_heads", ())))


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what it names loaded."""

    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def arch(self) -> Arch:
        return arch_from_config(self.config)


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path = Path(".")) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` (the checkout's
    root: the benchmark runs from there)."""
    path = root / "BENCHMARK.json"
    with open(path) as f:
        bench = json.load(f)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"{workload!r} is not a workload of {path}")
    w = by_name[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=workload, config_name=w["config"], traffic_name=w["traffic"],
        chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)])


def metric_reader(name: str) -> Callable[[Any], Optional[float]]:
    """``read`` of ``metrics/<name>.py`` (a dotted name is a file name, so
    the module is loaded by its path)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "cardbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
