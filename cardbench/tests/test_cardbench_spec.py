"""The benchmark finds every configuration, mix, limit and metric by
name, and a cell made of data alone runs."""

import json
import shutil

import torch

from conftest import BENCH, ROOT, TINY, tiny_cell, workloads


def test_every_cell_resolves_by_name():
    from harness.check import limits, reference
    from harness.spec import load_cell, metric_reader

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in workloads():
        cell = load_cell(name, ROOT)
        assert cell.config_name == name.split(".")[0]
        assert cell.traffic["kind"] in ("clips", "longform")
        assert limits(cell), name
        assert hasattr(reference(cell), "readings")
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer, name
        for m in cell.per_layer:
            assert callable(metric_reader(m["name"]))
            assert m["moves"] in reported, (name, m["name"])
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()


def test_weights_layout_is_the_ports_state():
    from harness.spec import arch_from_config
    from harness.weights import layout
    from thewhisper_tpu_torch.config import WhisperArch
    from thewhisper_tpu_torch.models.whisper import Whisper
    import dataclasses

    for f in sorted((BENCH / "configs").glob("*.json")):
        arch = arch_from_config(json.loads(f.read_text()))
        with torch.device("meta"):
            ours = Whisper(WhisperArch(**dataclasses.asdict(arch)))
        theirs = {k: tuple(v.shape) for k, v in ours.state_dict().items()}
        assert dict(layout(arch)) == theirs


def test_weights_repeat_per_seed_and_differ_across_seeds():
    from harness.spec import arch_from_config
    from harness.weights import make_state

    cell = tiny_cell(workloads()[0])
    arch = arch_from_config(cell.config)
    a, b = make_state(arch, 7, "cpu"), make_state(arch, 7, "cpu")
    c = make_state(arch, 2**31 + 11, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.token_emb"], c["decoder.token_emb"])
    assert a["decoder.token_emb"].dtype == torch.bfloat16
    assert float(a["encoder.layers.0.attn.q.bias"].float().std()) > 0.05


def test_a_new_cell_of_data_alone_runs(tmp_path, monkeypatch):
    """A cell added as a traffic file, a limits file and an entry in
    BENCHMARK.json, with no file of the benchmark edited."""
    import harness.check
    import harness.spec
    import run

    bench = tmp_path / "cardbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((BENCH / "traffic" / "clips-bs64.json").read_text())
    mix.update(batch=3, length_mean_s=4.0, max_new_tokens=5, pool_calls=2,
               check_rows=3)
    (bench / "traffic" / "clips-short.json").write_text(json.dumps(mix))
    (bench / "limits" / "turbo-s.clips-short.json").write_text(
        (BENCH / "limits" / "turbo-s.clips-bs64.json").read_text())
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "turbo-s.clips-short", "config": "turbo-s",
                              "traffic": "clips-short", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "turbo-s.clips-bs64" in m.get("workloads", ()):
            m["workloads"].append("turbo-s.clips-short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness.spec, "BENCH_DIR", bench)
    monkeypatch.setattr(harness.check, "BENCH_DIR", bench)
    monkeypatch.chdir(tmp_path)
    cell = harness.spec.load_cell("turbo-s.clips-short", tmp_path)
    assert cell.traffic["batch"] == 3
    cell.config = dict(cell.config, **TINY)
    out = run.run("turbo-s.clips-short", 3, 1.0, False, device="cpu", cell=cell)
    assert out["correct"] and out["attempted"] >= 3
    assert set(out["metrics"]) == {"rtfx", "setup_s"}
