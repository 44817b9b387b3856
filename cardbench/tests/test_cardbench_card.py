"""On the card, at each cell's own size (``pytest -m cuda
cardbench/tests``): the control, the reference at the precision below the
configuration's, fails the cell's limits where the program passes them,
on three seeds; and a run with the timed path broken underneath is not
correct: a token altered where it is produced, another token than the
best served with its own log-probability, half of the batch given the
other half's encoder states. Each test decides inside itself whether
there is a card."""

import json

import pytest
import torch

from conftest import workloads

pytestmark = pytest.mark.cuda
SEEDS = (2500000001, 2500000002, 2500000003)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def short_run(name, seed, control=False):
    import run
    from harness.spec import load_cell

    cell = load_cell(name)
    seconds = 3.0 if cell.traffic["kind"] == "clips" else 10.0
    return run.run(name, seed, seconds, False, control=control, cell=cell)


@pytest.mark.parametrize("name", workloads())
def test_the_control_fails_where_the_program_passes(name, in_root):
    card()
    from harness.check import limits
    from harness.spec import load_cell

    lim = limits(load_cell(name))
    for seed in SEEDS:
        out = short_run(name, seed, control=True)
        r = out["readings"]
        print(json.dumps({"cell": name, "seed": seed, **r}))
        assert out["correct"], out["checks"]
        assert any(r["control_" + k] > v for k, v in lim.items()), r


@pytest.mark.parametrize("name", workloads())
@pytest.mark.parametrize("fault", ["alter_a_token", "serve_another_token",
                                   "drop_half_the_batch"])
def test_a_broken_timed_path_is_not_correct_on_the_card(name, fault, in_root,
                                                        monkeypatch):
    card()
    import test_cardbench_run

    getattr(test_cardbench_run, fault)(monkeypatch)
    out = short_run(name, SEEDS[0])
    print(json.dumps({"cell": name, "fault": fault, "checks": out["checks"]}))
    assert out["correct"] is False
