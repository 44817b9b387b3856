"""Nothing the benchmark runs loads JAX, jaxlib, flax or the JAX package,
compared by whole top-level names (the port's name begins with the JAX
package's)."""

import subprocess
import sys

from conftest import BENCH, ROOT


def test_whole_name_check():
    import run

    saved = dict(sys.modules)
    try:
        sys.modules["thewhisper_tpu_torch.fake"] = sys
        assert "thewhisper_tpu" not in run.forbidden_modules()
        sys.modules["thewhisper_tpu.fake"] = sys
        assert "thewhisper_tpu" in run.forbidden_modules()
        sys.modules["jax._src"] = sys
        assert "jax" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_nothing_of_jax():
    """Every cell's run, in a fresh interpreter, leaves no forbidden
    module in ``sys.modules``."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH.parent / 'cardbench' / 'tests')!r}]
import conftest, run
for name in conftest.workloads():
    out = run.run(name, 3, 1.0, False, device="cpu", cell=conftest.tiny_cell(name))
    assert out["correct"], name
found = run.forbidden_modules()
assert not found, found
top = sorted({{m.split('.')[0] for m in sys.modules}})
assert 'thewhisper_tpu_torch' in top
print('ok', len(top))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("ok")


def test_sources_name_no_jax_module():
    import ast

    for f in BENCH.rglob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax",
                                               "thewhisper_tpu"), (f, n)
