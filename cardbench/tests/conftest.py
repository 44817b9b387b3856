"""Shared helpers of the benchmark's own tests: the benchmark's folder on
the path, and each cell cut to a tiny Whisper that the CPU runs in
seconds (the plain kernels' versions run the program there)."""

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(ROOT))

TINY = dict(d_model=64, encoder_layers=2, encoder_attention_heads=2,
            decoder_layers=2, decoder_attention_heads=2, encoder_ffn_dim=256,
            decoder_ffn_dim=256, alignment_heads=[[1, 0], [1, 1]])
TINY_MIX = {
    "clips": dict(batch=4, pool_calls=2, max_new_tokens=8, check_rows=4,
                  trace_calls=1),
    "longform": dict(files=2, length_s=80, batch_size=4, max_new_tokens=8,
                     check_rows=4),
}


def tiny_cell(workload: str):
    """The cell ``workload`` of the checkout's ``BENCHMARK.json`` at the
    tiny size."""
    from harness.spec import load_cell

    cell = load_cell(workload, ROOT)
    cell.config = dict(cell.config, **TINY)
    cell.traffic = dict(cell.traffic, **TINY_MIX[cell.traffic["kind"]])
    return cell


def workloads():
    with open(ROOT / "BENCHMARK.json") as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.fixture
def in_root(monkeypatch):
    """Run from the checkout's root."""
    monkeypatch.chdir(ROOT)
    return ROOT
