"""The port runs where JAX is not installed (the GPU machine has none).

Each check runs in a fresh interpreter with ``sys.modules["jax"] = None``,
so any ``import jax`` (direct or through a JAX-importing module of
``thewhisper_tpu``) raises ImportError.
"""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK_JAX = 'import sys; sys.modules["jax"] = None\n'


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
    assert len(names) >= 17
    assert "thewhisper_tpu_torch.engine.speculative" in names
    assert "thewhisper_tpu_torch.ops.mega_step" in names


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
