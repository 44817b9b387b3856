"""The port runs where JAX is not installed (the GPU machine has none),
and imports nothing of the JAX package: not even its modules that do not
import JAX (the port keeps its own ``config``, ``align`` and ``text``).

Each check runs in a fresh interpreter with ``sys.modules["jax"] = None``,
``sys.modules["thewhisper_tpu"] = None`` and ``sys.modules["ml_dtypes"] =
None``, so any ``import jax``, any import of ``thewhisper_tpu`` or one of
its modules, and ``ml_dtypes`` (which carries JAX's int4 type to numpy, and
which the card machine may lack) raise ImportError.
"""

import os
import subprocess
import sys

import pytest
import torch

from _torch_tiny import one_cpu_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK_JAX = ('import sys; sys.modules["jax"] = None; '
              'sys.modules["thewhisper_tpu"] = None; '
              'sys.modules["ml_dtypes"] = None\n')


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", _BLOCK_JAX + code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=300)


def test_every_port_module_imports_without_jax():
    proc = _run(
        "import importlib, pkgutil\n"
        "import thewhisper_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'thewhisper_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "print(' '.join(names))\n")
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 49
    assert "thewhisper_tpu_torch.engine.speculative" in names
    assert "thewhisper_tpu_torch.ops.mega_step" in names
    # Importing the server's __main__ (walked like every other module)
    # must start nothing: its main() runs only under the __main__ check.
    for name in ("config", "align", "text", "ops.mlp_chain",
                 "ops.attention_control", "ops.cache_write",
                 "tools.gemv_chain_probe", "tools.attention_probe",
                 "tools.mega_caps_probe", "tools.cache_write_probe",
                 "streaming.pipeline", "streaming.vad", "streaming.ring",
                 "streaming.streams", "streaming.batching", "server.http",
                 "server.launch", "server.__main__", "run_streaming",
                 "training", "training.train", "training.distill",
                 "models.checkpoint", "run_finetune", "run_distill",
                 "native_lib", "run_asr", "utils", "utils.wer",
                 "utils.normalizers", "utils.subtitles",
                 "streaming.vad_corpus", "streaming.vad_holdout",
                 "ops.int4_linear", "utils.flops", "utils.profiling"):
        assert f"thewhisper_tpu_torch.{name}" in names


def test_the_block_catches_an_import_of_the_jax_package():
    """The guard of the check above: a module of ``thewhisper_tpu`` that
    imports no JAX still fails to import under it."""
    proc = _run("import thewhisper_tpu.config\n")
    assert proc.returncode != 0
    assert "ModuleNotFoundError" in proc.stderr or "ImportError" in proc.stderr


def test_chip_smoke_fails_without_a_gpu():
    """No card: a non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    proc = _run("import runpy\n"
                "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Alone in a directory, without the package beside it, it fails."""
    alone = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        alone.write_text(f.read())
    proc = subprocess.run([sys.executable, str(alone)], cwd=str(tmp_path),
                          env=dict(os.environ, PYTHONPATH=""),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_result_line_counts_one_card():
    """The result line reports the card the run used, not the machine's."""
    import json

    import chip_smoke

    line = json.loads(chip_smoke.result_line("NVIDIA H100 80GB HBM3"))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
