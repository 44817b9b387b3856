"""Runs of every cell at a tiny size on the CPU (the program's plain
kernels): the result line's keys, and ``correct`` coming out false when
the timed path is broken underneath."""

import json

import pytest
import torch

from conftest import tiny_cell, workloads

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_cell(name, trace=False, seed=2**31 + 7):
    """A run of the tiny cell, 1.5 s."""
    import run

    return run.run(name, seed, 1.5, trace, device="cpu", cell=tiny_cell(name))


@pytest.mark.parametrize("name", workloads())
def test_result_line_has_the_contracts_keys(name, in_root):
    out = run_cell(name)
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    cell = tiny_cell(name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in out["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("name", workloads())
def test_traced_run_reports_per_layer_metrics(name, in_root):
    out = run_cell(name, trace=True)
    cell = tiny_cell(name)
    names = {m["name"] for m in cell.per_layer}
    # The CPU runs no kernel: only readings of the host are there.
    assert set(out["metrics"]) <= names and out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["correct"] is True


def test_main_refuses_without_a_card(in_root, capsys):
    import run

    if torch.cuda.is_available():
        pytest.skip("a card is present: main runs")
    rc = run.main(["--workload", workloads()[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def alter_a_token(monkeypatch):
    """The greedy loop serves another token than the one it scored."""
    from thewhisper_tpu_torch.engine import decode

    pick = decode.GreedyLoop._pick

    def altered(self, logits, first, *a, **kw):
        nxt, lp = pick(self, logits, first, *a, **kw)
        return (nxt + 1) % self.eot, lp

    monkeypatch.setattr(decode.GreedyLoop, "_pick", altered)


def serve_another_token(monkeypatch):
    """The greedy loop serves another token than the best, and reports
    that token's own log-probability with it."""
    from thewhisper_tpu_torch.engine import decode

    def other(self, logits, first, *a, **kw):
        x = decode._masked(logits, self.suppress, self.begin_suppress, first)
        nxt = (torch.argmax(x, dim=-1) + 1) % self.eot
        return nxt, torch.log_softmax(x, dim=-1).gather(-1, nxt[:, None])[:, 0]

    monkeypatch.setattr(decode.GreedyLoop, "_pick", other)


def drop_half_the_batch(monkeypatch):
    """The encoder computes the first half of the batch; the other rows
    take those rows' states."""
    from thewhisper_tpu_torch.engine import engine

    forward = engine.encoder_forward

    def half(model, mel, *a, **kw):
        b = mel.shape[0]
        h = (b + 1) // 2
        enc = forward(model, mel[:h], *a, **kw)
        return torch.cat([enc, enc[: b - h]]) if b > 1 else enc

    monkeypatch.setattr(engine, "encoder_forward", half)


@pytest.mark.parametrize("name", workloads())
def test_an_altered_token_is_not_correct(name, in_root, monkeypatch):
    """The fault a tiny model shows; a batch half left out shows only at
    the cells' own widths (``test_cardbench_card.py``): at this size the
    random decoder all but ignores which audio a row holds."""
    alter_a_token(monkeypatch)
    out = run_cell(name)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["logprob"]["value"] > out["checks"]["logprob"]["limit"]


@pytest.mark.parametrize("name", workloads())
def test_another_token_served_is_not_correct(name, in_root, monkeypatch):
    """A token that is not the best, served with its own log-probability:
    teacher-forced, both sides agree on that token's log-probability, and
    only ``best`` sees it."""
    serve_another_token(monkeypatch)
    out = run_cell(name)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["best"]["value"] > out["checks"]["best"]["limit"]


def test_control_reads_above_the_program(in_root):
    import run

    name = workloads()[0]
    out = run.run(name, 11, 1.0, False, device="cpu", cell=tiny_cell(name),
                  control=True)
    r = out["readings"]
    assert r["control_logprob"] > r["logprob"]
    assert r["control_best"] > r["best"]
